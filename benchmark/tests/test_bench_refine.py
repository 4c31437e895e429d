"""``refine.device_us_per_step`` on synthetic slices: the µs of
``refine_pose_kernel`` records (a bare name or a whole signature, never a
longer identifier) over the slice's steps, and None where the kernel did
not run or there is no slice."""

import types

import pytest

from svobench import layers, trace

NAME = "refine.device_us_per_step"


def _ctx(ops, steps):
    host = [trace.Op("bench.slice", "user_annotation", 0, 1000)]
    summary = trace.Summary(0.0, 1000.0, ops, host) if ops is not None \
        else None
    return types.SimpleNamespace(summary=summary,
                                 layer={"slice_steps": steps})


def test_refine_kernel_records_over_the_steps():
    ops = [trace.Op("void (anonymous namespace)::refine_pose_kernel<256>("
                    "(anonymous namespace)::RefineArgs)", "kernel", 10, 20),
           trace.Op("refine_pose_kernel", "kernel", 300, 16),
           trace.Op("refine_pose_kernel_v2", "kernel", 400, 7),
           trace.Op("align_levels_kernel", "kernel", 450, 90),
           trace.Op("void at::native::reduce_kernel<512, 1>(float*)",
                    "kernel", 500, 3),
           trace.Op("Memcpy DtoD", "gpu_memcpy", 600, 5)]
    assert layers.reader(NAME).read(_ctx(ops, 2)) == pytest.approx(18.0)


@pytest.mark.parametrize("ops,steps", [
    ([trace.Op("align_levels_kernel", "kernel", 10, 90),
      trace.Op("void at::native::reduce_kernel<512, 1>(float*)", "kernel",
               20, 3)], 2),
    ([], 2),
    (None, 2),
    ([trace.Op("refine_pose_kernel", "kernel", 10, 5)], 0),
])
def test_nothing_to_read_is_none(ops, steps):
    assert layers.reader(NAME).read(_ctx(ops, steps)) is None
