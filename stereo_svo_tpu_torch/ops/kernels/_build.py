"""Build and load the port's CUDA kernels (``csrc/*.cu``, with the
headers they share, ``csrc/*.cuh``), and the checks
every wrapper runs before a launch.

``nvcc`` compiles every source into one shared library with a plain C
interface, loaded with ``ctypes`` — no PyTorch headers, so the build takes
seconds. The library goes to ``build/stereo_svo_tpu_torch/`` at the repo
root, named by a hash of the sources and flags, at the first CUDA call.
Nothing here runs at import time.

The wrappers sit on the host path of every launch (tens per frame), so
the per-call work is kept small: the C functions are bound once
(:func:`load_library`), the device rule and the tensor checks are a few
attribute reads each (:func:`plain`, :func:`check`), and the raw stream
handle comes from one call (:func:`stream`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from types import SimpleNamespace
from typing import Tuple

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "stereo_svo_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v"]

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_float
_SIGNATURES = {
    "svo_pyramid": [_P, _L, _P, _I, _I, _I, _I, _P],
    "svo_halfsample": [_P, _P, _I, _I, _P],
    "svo_pyramid_gradients": [_P, _I, _I, _I, _I, _P],
    "svo_gradients": [_P, _L, _P, _P, _L, _I, _I, _I, _P],
    "svo_sample_patch": [_P, _L, _I, _I, _I, _P, _L, _L, _I, _P, _I, _P],
    "svo_gn_blocks": [_I, _I],
    "svo_gn_scratch_floats": [],
    "svo_gn_accumulate": [_P, _L, _I, _I, _P, _L, _P, _L, _P, _L, _P, _L,
                          _I, _I, _P, _L, _P, _L, _F, _P, _P, _P, _I, _P],
    "svo_align_threads": [_I, _I],
    "svo_align_levels": [_P, _P, _P, _P, _P, _P, _I, _P, _L, _P, _L, _P, _L,
                         _P, _L, _P, _L, _I, _I, _F, _I, _P, _I, _I, _P],
    "svo_refine_threads": [_I],
    "svo_refine_pose": [_P, _L, _P, _L, _P, _L, _P, _L, _P, _L, _P, _L, _P,
                        _L, _P, _L, _P, _L, _I, _P, _P, _I, _I, _P, _P, _P,
                        _I, _P],
    "svo_klt_track": [_P, _P, _P, _I, _P, _L, _P, _L, _P, _L, _P, _L, _P, _L,
                      _P, _L, _I, _P, _L, _P, _L, _P, _L, _P, _L, _I, _I, _I,
                      _F, _F, _I, _P, _P, _P, _P, _P, _I, _P],
    # the frame graph's assembly (csrc/frame_graph.cu)
    "svo_graph_create": [_P],
    "svo_graph_destroy": [_P],
    "svo_graph_cond_handle": [_P, _P],
    "svo_graph_add_child": [_P, _P, _P],
    "svo_graph_add_if": [_P, _P, ctypes.c_ulonglong, _P, _P, _I, _I, _I,
                         _I],
    "svo_graph_add_stamp": [_P, _P, _P, _I, _I, _I, _I, _I],
    "svo_stamp": [_P, _I, _I, _I, _I, _I, _P, _P],
    "svo_graph_add_set": [_P, _P, _P, _P, _I],
    "svo_graph_instantiate": [_P, _P],
    "svo_graph_launch": [_P, _P],
    "svo_graph_exec_destroy": [_P],
}
MAX_PROBLEMS = 65535   # problems one launch takes (the grid's y or z size)
F32 = torch.float32

_lib = None  # the bound C functions, once built


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit to build")


def library_path() -> Path:
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsvo_kernels_{h.hexdigest()[:16]}.so"


def load_library() -> SimpleNamespace:
    """Build (if needed) and load the kernel library; return its C
    functions, bound with their argument types. Raise on failure."""
    global _lib
    if _lib is not None:
        return _lib
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *map(str, sorted(CSRC.glob("*.cu")))]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        out.with_suffix(".log").write_text(
            " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stderr[-4000:]}")
        os.replace(tmp, out)   # atomic: a concurrent build never sees half
    cdll = ctypes.CDLL(str(out))
    fns = {}
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(cdll, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    _lib = SimpleNamespace(**fns)
    return _lib


def stream(device: torch.device) -> int:
    """Raw handle of the current CUDA stream on ``device``."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def plain(*tensors: torch.Tensor | None) -> bool:
    """True if the kernel's plain version applies (all tensors on the CPU);
    False for tensors on one CUDA device. Any other device, or a mix,
    raises. ``None`` entries (an output not given) are skipped."""
    dev = tensors[0].device
    for t in tensors:
        if t is not None and t.device != dev:
            raise ValueError(
                f"kernel inputs must all be on one CPU or CUDA device, got "
                f"{sorted(str(t.device) for t in tensors if t is not None)}")
    if dev.type == "cpu":
        return True
    if dev.type == "cuda":
        return False
    raise ValueError(f"kernel inputs must be on the CPU or a CUDA device, "
                     f"got {dev}")


def check(t: torch.Tensor, name: str, shape: tuple) -> None:
    """Raise unless ``t`` is a contiguous float32 tensor of exactly
    ``shape``."""
    if t.dtype is F32 and t.shape == shape and t.is_contiguous():
        return
    if t.dtype != F32:
        raise TypeError(f"{name}: float32 required, got {t.dtype}")
    if t.shape != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)} does not match "
                         f"{tuple(shape)}")
    raise ValueError(f"{name}: contiguous tensor required")


def problems(t: torch.Tensor, core: int) -> Tuple[torch.Tensor, int]:
    """``t`` (*B, *core shape) as (n, *core shape), n = prod(B), with each
    problem's ``core`` trailing dims contiguous, and the element stride
    from one problem to the next (0 where every problem shares one array,
    as an ``expand`` leaves it). Copies only where no such view exists."""
    shape = t.shape[t.dim() - core:]
    t = t.reshape((-1,) + tuple(shape))
    expected = 1
    for size, stride in zip(reversed(t.shape[1:]), reversed(t.stride()[1:])):
        if size != 1 and stride != expected:
            t = t.contiguous()
            break
        expected *= size
    return t, (t.stride(0) if t.shape[0] > 1 else 0)


def raise_on_error(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: "
                           f"cudaError {rc}")
