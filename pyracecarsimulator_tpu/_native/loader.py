"""ctypes loader for the native host library (csrc/racecar_native.cpp).

Mirrors the reference's native tier (SURVEY.md §2c) without a
Cython/pybind dependency: plain C ABI + ctypes. Every entry point has a
NumPy fallback in the package, so the library is an accelerator, never a
requirement. The library is not shipped: it is built from ``csrc/`` into
this directory (gitignored) on first use, or ahead of time with ``python
-m pyracecarsimulator_tpu._native.loader --build`` or ``make -C csrc``.
Hosts without ``g++`` use the NumPy fallbacks.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_DIR = os.path.dirname(__file__)
_SO = os.path.join(_DIR, "libracecar_native.so")
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def build(verbose: bool = False) -> bool:
    """Compile the shared library (requires g++). Returns success."""
    src_dir = os.path.join(os.path.dirname(_DIR), "..", "csrc")
    src_dir = os.path.abspath(src_dir)
    if not os.path.exists(os.path.join(src_dir, "Makefile")):
        return False
    try:
        subprocess.run(["make", "-C", src_dir],
                       check=True,
                       capture_output=not verbose)
        return os.path.exists(_SO)
    except Exception:
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    if not os.path.exists(_SO):
        if not build():
            _load_failed = True
            return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        _load_failed = True
        return None

    u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i, d = ctypes.c_int, ctypes.c_double

    lib.rc_edt.argtypes = [u8, i, i, f32]
    lib.rc_edt.restype = None
    lib.rc_trace_rays.argtypes = [f32, i, i, i, i, d, d, d,
                                  f64, f64, f64, f64, i, d, d, i, f64]
    lib.rc_trace_rays.restype = None
    lib.rc_raycast_segments.argtypes = [f64, i, f64, f64, f64, f64, i, d,
                                        f64]
    lib.rc_raycast_segments.restype = None
    lib.rc_extract_segments.argtypes = [u8, i, i, f64, i]
    lib.rc_extract_segments.restype = i
    lib.rc_sector_membership.argtypes = [f64, i, i, i, i, d, d, d, d,
                                         d, d, u8]
    lib.rc_sector_membership.restype = i
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def edt(occupied: np.ndarray) -> Optional[np.ndarray]:
    """Exact EDT in cell units, or None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    occ = np.ascontiguousarray(occupied, np.uint8)
    h, w = occ.shape
    out = np.empty((h, w), np.float32)
    lib.rc_edt(occ, h, w, out)
    return out


def trace_rays(edf: np.ndarray, bounds_hw, resolution, origin_xy,
               xs, ys, cts, sts, max_range=10.0, eps=1e-4,
               max_iters=2000) -> Optional[np.ndarray]:
    """Batch CPU oracle DT march (reference semantics)."""
    lib = _load()
    if lib is None:
        return None
    e = np.ascontiguousarray(edf, np.float32)
    h, w = e.shape
    bh, bw = bounds_hw
    xs = np.ascontiguousarray(xs, np.float64)
    n = len(xs)
    cvt = lambda a: np.ascontiguousarray(
        np.broadcast_to(np.asarray(a, np.float64), (n,)))
    out = np.empty(n, np.float64)
    lib.rc_trace_rays(e, h, w, bh, bw, float(resolution),
                      float(origin_xy[0]), float(origin_xy[1]),
                      xs, cvt(ys), cvt(cts), cvt(sts), n,
                      float(max_range), float(eps), int(max_iters), out)
    return out


def raycast_segments(segs: np.ndarray, xs, ys, cts, sts,
                     max_range=10.0) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    s = np.ascontiguousarray(segs, np.float64)
    xs = np.ascontiguousarray(xs, np.float64)
    n = len(xs)
    cvt = lambda a: np.ascontiguousarray(
        np.broadcast_to(np.asarray(a, np.float64), (n,)))
    out = np.empty(n, np.float64)
    lib.rc_raycast_segments(s, len(s), xs, cvt(ys), cvt(cts), cvt(sts), n,
                            float(max_range), out)
    return out


def sector_membership(segs: np.ndarray, nr: int, nc: int, ns: int,
                      tile_size: float, ox: float, oy: float, rt: float,
                      reach: float,
                      block_half: float) -> Optional[np.ndarray]:
    """(nr*nc*ns, K) bool cull membership (maps/sectors._membership,
    native tier: ~10x the NumPy broadcast on berlin-class builds), or
    None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    s = np.ascontiguousarray(segs, np.float64)
    k = len(s)
    out = np.empty((nr * nc * ns, k), np.uint8)
    rc = lib.rc_sector_membership(s, k, nr, nc, ns, float(tile_size),
                                  float(ox), float(oy), float(rt),
                                  float(reach), float(block_half), out)
    if rc != 0:
        return None
    return out.view(bool)


def extract_segments(occ: np.ndarray) -> Optional[np.ndarray]:
    """Boundary segments in grid units, or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    o = np.ascontiguousarray(occ, np.uint8)
    h, w = o.shape
    cap = 16 + 4 * (h * w // 2 + h + w)
    out = np.empty((cap, 4), np.float64)
    n = lib.rc_extract_segments(o, h, w, out, cap)
    if n < 0:
        return None
    return out[:n].copy()


if __name__ == "__main__":
    import sys
    if "--build" in sys.argv:
        ok = build(verbose=True)
        print("build:", "ok" if ok else "FAILED")
        sys.exit(0 if ok else 1)
    print("available:", available())
