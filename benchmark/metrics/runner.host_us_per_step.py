"""Host time inside the runner's calls (``run_frames``,
``run_frames_batched``) per step, a step being one launch of the frame
graph (a frame, or a batched frame), over the window's untraced pieces:
the benchmark's own clock around its calls."""


def read(ctx):
    steps = ctx.layer.get("runner_steps")
    if not steps:
        return None
    return ctx.layer["runner_s"] / steps * 1e6
