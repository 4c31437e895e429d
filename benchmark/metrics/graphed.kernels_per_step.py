"""Device kernel records in the traced slice over the steps (launches of
the frame graph) the slice ran: the kernels a frame's graph and the
bodies its IF nodes took replay."""


def read(ctx):
    s, steps = ctx.summary, ctx.layer.get("slice_steps")
    if s is None or not steps or s.count() == 0:
        return None
    return s.count() / steps
