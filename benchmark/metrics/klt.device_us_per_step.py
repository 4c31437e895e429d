"""Device µs a step in the fused KLT, ``klt_track_kernel`` (the whole of
``ops/klt.track`` in one launch a tracked frame, the batch's problems in
one launch): its kernel records in the traced slice summed, over the steps
the slice ran. None where the kernel did not run."""

KERNELS = ("klt_track_kernel",)


def read(ctx):
    s, steps = ctx.summary, ctx.layer.get("slice_steps")
    if s is None or not steps:
        return None
    t = s.device_s(KERNELS)
    if t <= 0:
        return None
    return 1e6 * t / steps
