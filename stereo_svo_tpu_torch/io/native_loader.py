"""ctypes binding for the native C++ prefetching frame loader.

Reference parity: the reference's ImageInput readers are C++ (SURVEY.md
§2.1); this wraps native/frameloader.cpp — a thread-pool decode+rectify
pipeline with an in-order bounded ring buffer — so host image decode
overlaps device compute.

The port's own binding: it loads the repository's
``native/libsvoframeloader.so`` (built with ``make -C native``; the
library links OpenCV) and copies nothing of it. Where the library cannot
be built or loaded, :func:`available` is false and the loaders raise: a
caller that asked for the native loader never gets the Python readers
instead.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Iterator, List, Optional, Tuple

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native",
    "libsvoframeloader.so")
_lib = None


def _load(build_if_missing: bool = True):
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH) and build_if_missing:
        try:
            subprocess.run(["make", "-C", os.path.dirname(_LIB_PATH)],
                           check=True, capture_output=True, timeout=120)
        except Exception:
            return None
    if not os.path.exists(_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:                    # e.g. OpenCV's libraries are missing
        return None
    lib.fl_create.restype = ctypes.c_void_p
    lib.fl_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.fl_set_rectify.argtypes = [ctypes.c_void_p] + [
        ctypes.POINTER(ctypes.c_float)] * 4
    lib.fl_next.restype = ctypes.c_int
    lib.fl_next.argtypes = [ctypes.c_void_p,
                            ctypes.POINTER(ctypes.c_float),
                            ctypes.POINTER(ctypes.c_float),
                            ctypes.POINTER(ctypes.c_double)]
    lib.fl_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _require():
    """The loaded library, or a RuntimeError: never a silent fallback."""
    lib = _load()
    if lib is None:
        raise RuntimeError(
            "native frame loader unavailable: native/libsvoframeloader.so "
            "is not built (`make -C native`) or cannot be loaded (it links "
            "OpenCV)")
    return lib


class NativeFrameLoader:
    """In-order prefetching stereo frame source over explicit path lists."""

    def __init__(self, left_paths: List[str], right_paths: List[str],
                 timestamps: List[float], width: int, height: int,
                 n_threads: int = 3, prefetch: int = 8,
                 rect_maps: Optional[Tuple[np.ndarray, ...]] = None):
        lib = _require()
        assert len(left_paths) == len(right_paths) == len(timestamps)
        self._lib = lib
        self.width, self.height = width, height
        n = len(left_paths)
        lp = (ctypes.c_char_p * n)(*[p.encode() for p in left_paths])
        rp = (ctypes.c_char_p * n)(*[p.encode() for p in right_paths])
        ts = (ctypes.c_double * n)(*timestamps)
        self._h = lib.fl_create(lp, rp, ts, n, width, height,
                                n_threads, prefetch)
        if rect_maps is not None:
            maps = [np.ascontiguousarray(m, np.float32) for m in rect_maps]
            ptrs = [m.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
                    for m in maps]
            lib.fl_set_rectify(self._h, *ptrs)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, float]]:
        while True:
            left = np.empty((self.height, self.width), np.float32)
            right = np.empty((self.height, self.width), np.float32)
            ts = ctypes.c_double()
            ok = self._lib.fl_next(
                self._h,
                left.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                right.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                ctypes.byref(ts))
            if not ok:
                return
            yield left, right, ts.value

    def close(self):
        if getattr(self, "_h", None):
            self._lib.fl_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()


def _probe_size(path: str) -> Tuple[int, int]:
    """(height, width) of the first image: the loader's buffer size."""
    _require()
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            "OpenCV (the 'cv2' package) is unavailable; cannot size the "
            "native loader's buffers") from e
    probe = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if probe is None:
        raise FileNotFoundError(path)
    return probe.shape


def euroc_native(root: str, rectifier=None, **kw):
    """Native-loader variant of datasets.euroc_frames."""
    import csv
    cam0 = os.path.join(root, "mav0", "cam0")
    cam1 = os.path.join(root, "mav0", "cam1")
    with open(os.path.join(cam0, "data.csv")) as f:
        rows = [r for r in csv.reader(f) if r and not r[0].startswith("#")]
    lefts, rights, stamps = [], [], []
    for ts, fname in rows:
        p0 = os.path.join(cam0, "data", fname.strip())
        p1 = os.path.join(cam1, "data", fname.strip())
        if os.path.exists(p0) and os.path.exists(p1):
            lefts.append(p0)
            rights.append(p1)
            stamps.append(float(ts) * 1e-9)
    h, w = _probe_size(lefts[0])
    rect_maps = None
    if rectifier is not None:
        rect_maps = (rectifier.map0[0], rectifier.map0[1],
                     rectifier.map1[0], rectifier.map1[1])
    return NativeFrameLoader(lefts, rights, stamps, w, h,
                             rect_maps=rect_maps, **kw)


def kitti_native(root: str, seq: str, **kw):
    """Native-loader variant of datasets.kitti_frames."""
    base = os.path.join(root, "sequences", seq)
    d0 = os.path.join(base, "image_0")
    d1 = os.path.join(base, "image_1")
    names = sorted(os.listdir(d0))
    times_path = os.path.join(base, "times.txt")
    times = ([float(x) for x in open(times_path)]
             if os.path.exists(times_path)
             else [i * 0.1 for i in range(len(names))])
    h, w = _probe_size(os.path.join(d0, names[0]))
    return NativeFrameLoader([os.path.join(d0, n) for n in names],
                             [os.path.join(d1, n) for n in names],
                             times[: len(names)], w, h, **kw)
