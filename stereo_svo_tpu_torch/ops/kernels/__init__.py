"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions.

Each wrapper takes the plain version for CPU tensors and launches its
kernel for CUDA tensors — there is no fallback between the two. The
paths call them through functional custom ops (``svo::pyramid``,
``svo::gradients``, ``svo::sample_patches``, ``svo::gn_accumulate``,
``svo::align_levels``, ``svo::refine_pose``, ``svo::klt_track``) whose
``torch.func.vmap`` rules launch a kernel once for a whole batch, the batch
as its problem axis.

:data:`KERNELS` declares every hand-written kernel once, under the name of
its launch counter (the key of its wrapper module's ``LAUNCHES``): the CUDA
function its launches run, the file of ``csrc/`` that defines it, the
wrapper module, what of the JAX package it replaces and whether the shipped
paths launch it. The frame graph's launch accounting
(``engine/graphed``), the dry run's report (``entry``), ``bench_torch.py``
and ``chip_smoke.py`` all read it. Adding a kernel touches its ``.cu``
source, its wrapper module (with its counter in ``LAUNCHES``), one entry
here and its C signature in ``_build.py``.

This module imports no wrapper at import time (the wrappers import
``ops/interp``, and this package is imported before any of them):
:func:`counters` imports them when called.
"""

from __future__ import annotations

import importlib
from typing import Dict, NamedTuple, Tuple


class Kernel(NamedTuple):
    function: str        # the CUDA function (``__global__``) it launches
    source: str          # the file that defines it, under the package
    module: str          # its wrapper module in this package
    replaces: str        # the Pallas kernel or jnp chain it replaces
    on_path: bool = True  # launched by the shipped paths


KERNELS: Dict[str, Kernel] = {
    "halfsample": Kernel(
        "pyramid_levels_kernel", "csrc/pyramid.cu", "pyramid_kernel",
        "stereo_svo_tpu/ops/pallas/pyramid_kernel.py:37"),
    "gradients": Kernel(
        "gradients_levels_kernel", "csrc/pyramid.cu", "pyramid_kernel",
        "stereo_svo_tpu/ops/pallas/pyramid_kernel.py:70"),
    "sample_patches": Kernel(
        "sample_patch_kernel", "csrc/align.cu", "align_kernel",
        "stereo_svo_tpu/ops/pallas/align_kernel.py:110"),
    # off the paths since the alignment is one align_levels launch
    "gn_accumulate": Kernel(
        "gn_accumulate_kernel", "csrc/align.cu", "align_kernel",
        "stereo_svo_tpu/ops/pallas/align_kernel.py:217", on_path=False),
    "align_levels": Kernel(
        "align_levels_kernel", "csrc/align.cu", "align_kernel",
        "none (fuses stereo_svo_tpu/ops/align.py:align with "
        "ops/pallas/align_kernel.py:217)"),
    "refine_pose": Kernel(
        "refine_pose_kernel", "csrc/pose_refine.cu", "refine_kernel",
        "none (fuses stereo_svo_tpu/frontend/pose_refine.py:refine)"),
    "klt_track": Kernel(
        "klt_track_kernel", "csrc/klt.cu", "klt_kernel",
        "none (fuses stereo_svo_tpu/ops/klt.py:track with "
        "ops/pallas/align_kernel.py:110)"),
}


def counters() -> Tuple[Dict[str, int], ...]:
    """Each wrapper module's ``LAUNCHES`` (the live dicts the wrappers
    count in), once each, in the order of :data:`KERNELS`."""
    modules = dict.fromkeys(k.module for k in KERNELS.values())
    return tuple(importlib.import_module(f"{__name__}.{m}").LAUNCHES
                 for m in modules)


def launches() -> Dict[str, int]:
    """Every launch counter's count, by counter."""
    return {key: n for counts in counters() for key, n in counts.items()}
