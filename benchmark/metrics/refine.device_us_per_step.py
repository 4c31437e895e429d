"""Device µs a step in the fused pose refinement, ``refine_pose_kernel``
(the whole of ``frontend/pose_refine.refine`` in one launch a tracked
frame, the batch's problems in one launch): its kernel records in the
traced slice summed, over the steps the slice ran. None where the kernel
did not run."""

KERNELS = ("refine_pose_kernel",)


def read(ctx):
    s, steps = ctx.summary, ctx.layer.get("slice_steps")
    if s is None or not steps:
        return None
    t = s.device_s(KERNELS)
    if t <= 0:
        return None
    return 1e6 * t / steps
