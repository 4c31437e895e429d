"""``klt.device_us_per_step`` on synthetic slices: the µs of
``klt_track_kernel`` records (a bare name or a whole signature, never a
longer identifier) over the slice's steps, and None where the kernel did
not run (the parent's chain of ops and B3 launches) or there is no
slice."""

import types

import pytest

from svobench import layers, trace

NAME = "klt.device_us_per_step"


def _ctx(ops, steps):
    host = [trace.Op("bench.slice", "user_annotation", 0, 1000)]
    summary = trace.Summary(0.0, 1000.0, ops, host) if ops is not None \
        else None
    return types.SimpleNamespace(summary=summary,
                                 layer={"slice_steps": steps})


def test_klt_kernel_records_over_the_steps():
    ops = [trace.Op("void (anonymous namespace)::klt_track_kernel<8>("
                    "(anonymous namespace)::KltArgs, int)", "kernel", 10, 9),
           trace.Op("klt_track_kernel", "kernel", 300, 11),
           trace.Op("klt_track_kernel_v2", "kernel", 400, 7),
           trace.Op("refine_pose_kernel", "kernel", 450, 30),
           trace.Op("void (anonymous namespace)::sample_patch_kernel<8>("
                    "float const*)", "kernel", 480, 2),
           trace.Op("Memcpy DtoD", "gpu_memcpy", 600, 5)]
    assert layers.reader(NAME).read(_ctx(ops, 2)) == pytest.approx(10.0)


@pytest.mark.parametrize("ops,steps", [
    # the parent: the chain's B3 launches and PyTorch kernels, no fused KLT
    ([trace.Op("void (anonymous namespace)::sample_patch_kernel<8>("
               "float const*)", "kernel", 10, 2),
      trace.Op("void at::native::reduce_kernel<512, 1>(float*)", "kernel",
               20, 3)], 2),
    ([], 2),
    (None, 2),
    ([trace.Op("klt_track_kernel", "kernel", 10, 5)], 0),
])
def test_nothing_to_read_is_none(ops, steps):
    assert layers.reader(NAME).read(_ctx(ops, steps)) is None
