"""ctypes bindings for the native SAH BVH builder (``native/bvh_build.cpp``).

Same threaded output format as :mod:`raytpu.accel.bvh`; ~100× faster on
armadillo-class meshes (the build-time analog of the driver-side
acceleration-structure build, ``src/main.cpp:495-498``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from raytpu.accel.bvh import Bvh
from raytpu.utils import native_lib

_lib: Optional[ctypes.CDLL] = None


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    lib = native_lib.load()
    if lib is None:
        return None
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.bvh_build_sah.restype = ctypes.c_int64
    lib.bvh_build_sah.argtypes = [
        f32p, f32p, f32p, ctypes.c_int64, ctypes.c_int32,
        f32p, f32p, i32p, i32p, i32p, i32p,
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def build_bvh(
    v0: np.ndarray, e1: np.ndarray, e2: np.ndarray, leaf_size: int = 4
) -> Bvh:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not built (make -C native)")
    t = int(v0.shape[0])
    if t == 0:
        from raytpu.accel.bvh import build_bvh as py_build

        return py_build(v0, e1, e2, leaf_size=leaf_size)

    max_nodes = 2 * t
    aabb_min = np.empty((max_nodes, 3), np.float32)
    aabb_max = np.empty((max_nodes, 3), np.float32)
    tri_first = np.empty(max_nodes, np.int32)
    tri_count = np.empty(max_nodes, np.int32)
    miss = np.empty(max_nodes, np.int32)
    tri_order = np.empty(t, np.int32)

    n = lib.bvh_build_sah(
        np.ascontiguousarray(v0, np.float32),
        np.ascontiguousarray(e1, np.float32),
        np.ascontiguousarray(e2, np.float32),
        t,
        leaf_size,
        aabb_min,
        aabb_max,
        tri_first,
        tri_count,
        miss,
        tri_order,
    )
    if n < 0:
        raise RuntimeError("native BVH build failed")
    n = int(n)
    # miss links are relative to n (the real node count), not max_nodes
    return Bvh(
        aabb_min=aabb_min[:n].copy(),
        aabb_max=aabb_max[:n].copy(),
        tri_first=tri_first[:n].copy(),
        tri_count=tri_count[:n].copy(),
        miss=miss[:n].copy(),
        tri_order=tri_order,
    )
