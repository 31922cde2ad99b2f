"""ctypes bindings for the native C++ builders (``native/*.cpp``).

The reference's builders are native Rust with rayon parallelism
(``/root/reference/src/data_structures/hlbvh.rs``); ours are native C++
(OpenMP for the LBVH), loaded via ctypes. Each library is built from the
tracked source on first use, into ``build/native/<hash>/`` where the hash
covers the source bytes and the compile command, so a library built from
other sources or flags is never loaded. ``available()`` is False when the
library cannot be built, and ``tracer.accel.lbvh.build`` remains the NumPy
reference path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

import numpy as np

from tracer.accel.lbvh import BvhBuffers
from tracer.util import StageTimer

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
_NATIVE_DIR = os.path.join(_ROOT, "native")
_BUILD_DIR = os.path.join(_ROOT, "build", "native")

_LBVH_FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC")
# -ffp-contract=off: NumPy never fuses mul+add, and the BSP builders are
# contractually bit-identical.
_BSP_FLAGS = ("-O3", "-ffp-contract=off", "-shared", "-fPIC")


def _build(name: str, flags: tuple) -> str | None:
    """Path of ``lib<name>.so`` built from ``native/<name>.cpp`` with
    ``flags``, compiling it if this (source, flags) pair has no build yet.
    None when the compiler fails."""
    src = os.path.join(_NATIVE_DIR, f"{name}.cpp")
    with open(src, "rb") as f:
        code = f.read()
    key = hashlib.sha256(code + " ".join(("g++",) + flags).encode())
    out_dir = os.path.join(_BUILD_DIR, key.hexdigest()[:16])
    so = os.path.join(out_dir, f"lib{name}.so")
    if os.path.exists(so):
        return so
    os.makedirs(out_dir, exist_ok=True)
    # Build under a temporary name and rename into place, so concurrent
    # processes never load a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    try:
        subprocess.run(
            ["g++", *flags, "-o", tmp, src],
            check=True, capture_output=True, timeout=300,
        )
        os.replace(tmp, so)
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    so = _build("lbvh", _LBVH_FLAGS)
    if so is None:
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.lbvh_build.restype = ctypes.c_int64
    lib.lbvh_build.argtypes = [
        f32p, f32p, ctypes.c_int64, ctypes.c_int32,
        f32p, f32p, i32p, i32p, i32p, i32p, i32p, f64p,
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def build(
    prim_lo: np.ndarray,
    prim_hi: np.ndarray,
    max_prims: int = 4,
    timer: StageTimer | None = None,
) -> BvhBuffers:
    """Native LBVH build; same output layout as ``lbvh.build``."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native LBVH library unavailable")
    n = prim_lo.shape[0]
    cap = max(2 * n, 1)
    lo = np.ascontiguousarray(prim_lo, np.float32)
    hi = np.ascontiguousarray(prim_hi, np.float32)
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    left = np.empty(cap, np.int32)
    right = np.empty(cap, np.int32)
    first = np.empty(cap, np.int32)
    count = np.empty(cap, np.int32)
    prim_ids = np.empty(n, np.int32)
    stage_ms = np.zeros(5, np.float64)
    m = lib.lbvh_build(
        lo, hi, n, max_prims, node_min, node_max, left, right, first,
        count, prim_ids, stage_ms,
    )
    if m < 0:
        raise RuntimeError("native LBVH build failed")
    if timer is not None:
        for name, ms in zip(
            ("morton", "sort", "radix_tree", "collapse", "bbox"), stage_ms
        ):
            timer.stages[name] = timer.stages.get(name, 0.0) + ms / 1e3
    m = int(m)
    return BvhBuffers(
        node_min=node_min[:m].copy(),
        node_max=node_max[:m].copy(),
        left=left[:m].copy(),
        right=right[:m].copy(),
        first=first[:m].copy(),
        count=count[:m].copy(),
        prim_ids=prim_ids,
    )


# ---------------------------------------------------------------------------
# Native BSP builder (native/bsp.cpp) — same two-phase pattern, separate .so.
# ---------------------------------------------------------------------------

_bsp_lib = None
_bsp_tried = False


def _bsp_load():
    global _bsp_lib, _bsp_tried
    if _bsp_lib is not None or _bsp_tried:
        return _bsp_lib
    _bsp_tried = True
    so = _build("bsp", _BSP_FLAGS)
    if so is None:
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64 = ctypes.c_int64
    lib.bsp_build.restype = i64
    lib.bsp_build.argtypes = [f32p, f32p, i64, ctypes.c_int32,
                              ctypes.c_int32]
    lib.bsp_counts.restype = None
    lib.bsp_counts.argtypes = [i64, ctypes.POINTER(i64), ctypes.POINTER(i64)]
    lib.bsp_copy.restype = None
    lib.bsp_copy.argtypes = [i64, i32p, f32p, i32p, i32p, i32p, i32p, i32p,
                             f32p, f32p]
    lib.bsp_release.restype = None
    lib.bsp_release.argtypes = [i64]
    _bsp_lib = lib
    return lib


def bsp_available() -> bool:
    return _bsp_load() is not None


def bsp_build(prim_lo, prim_hi, max_depth: int, max_objects: int,
              timer: StageTimer | None = None):
    """Native BSP build; returns the field dict for BspBuffers."""
    import time as _time

    lib = _bsp_load()
    if lib is None:
        raise RuntimeError("native BSP library unavailable")
    lo = np.ascontiguousarray(prim_lo, np.float32)
    hi = np.ascontiguousarray(prim_hi, np.float32)
    n = lo.shape[0]
    t0 = _time.perf_counter()
    h = lib.bsp_build(lo, hi, n, max_depth, max_objects)
    if h < 0:
        raise RuntimeError("native BSP build failed")
    try:
        nodes = ctypes.c_int64()
        prims = ctypes.c_int64()
        lib.bsp_counts(h, ctypes.byref(nodes), ctypes.byref(prims))
        m, p = int(nodes.value), int(prims.value)
        axis = np.empty(m, np.int32)
        plane = np.empty(m, np.float32)
        left = np.empty(m, np.int32)
        right = np.empty(m, np.int32)
        first = np.empty(m, np.int32)
        count = np.empty(m, np.int32)
        prim_ids = np.empty(max(p, 1), np.int32)
        bbox_lo = np.empty(3, np.float32)
        bbox_hi = np.empty(3, np.float32)
        lib.bsp_copy(h, axis, plane, left, right, first, count, prim_ids,
                     bbox_lo, bbox_hi)
    finally:
        lib.bsp_release(h)
    if timer is not None:
        timer.stages["subdivide"] = (
            timer.stages.get("subdivide", 0.0)
            + (_time.perf_counter() - t0)
        )
    return dict(
        axis=axis, plane=plane, left=left, right=right, first=first,
        count=count, prim_ids=prim_ids[:p], bbox_lo=bbox_lo, bbox_hi=bbox_hi,
    )
