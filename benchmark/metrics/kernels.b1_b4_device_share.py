"""Share of all kernel time in the traced slice spent in the hand-written
kernels B1-B4: what any redesign of them can give at most."""

KERNELS = ("pyramid_levels_kernel", "gradients_levels_kernel",
           "sample_patch_kernel", "gn_accumulate_kernel")


def read(ctx):
    s = ctx.summary
    if s is None or s.device_s() <= 0:
        return None
    return s.device_s(KERNELS) / s.device_s()
