"""ctypes bindings for the native OBJ parser (``native/objparse.cpp``).

Loads ``native/libraytpu_native.so``, building it on first use
(``raytpu/utils/native_lib.py``); ``available()`` gates all callers so the
pure-Python path remains where no compiler exists.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from raytpu.utils import native_lib

_lib: Optional[ctypes.CDLL] = None


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    lib = native_lib.load()
    if lib is None:
        return None
    lib.obj_parse_file.restype = ctypes.c_void_p
    lib.obj_parse_file.argtypes = [ctypes.c_char_p]
    lib.obj_error.restype = ctypes.c_char_p
    lib.obj_error.argtypes = [ctypes.c_void_p]
    for name in ("obj_num_vertices", "obj_num_normals", "obj_num_triangles"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p]
    for name, ty in (
        ("obj_positions", ctypes.c_float),
        ("obj_normals", ctypes.c_float),
        ("obj_tri_v", ctypes.c_int32),
        ("obj_tri_vn", ctypes.c_int32),
    ):
        fn = getattr(lib, name)
        fn.restype = ctypes.POINTER(ty)
        fn.argtypes = [ctypes.c_void_p]
    lib.obj_free.argtypes = [ctypes.c_void_p]
    lib.obj_free.restype = None
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def load_obj(path: str):
    """Parse via the native library → :class:`raytpu.io.obj.Mesh`.

    Applies the same normal-resolution policy as the Python parser
    (position-aligned vn list → direct; else vn-index scatter; else
    computed smooth normals).
    """
    from raytpu.io.obj import Mesh, compute_smooth_normals

    lib = _load()
    if lib is None:
        raise RuntimeError("native library not built (make -C native)")
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    handle = lib.obj_parse_file(path.encode())
    if not handle:
        raise IOError(f"native OBJ parse failed to open {path}")
    try:
        err = lib.obj_error(handle)
        if err:
            raise ValueError(f"{path}: {err.decode()}")
        nv = lib.obj_num_vertices(handle)
        nn = lib.obj_num_normals(handle)
        nt = lib.obj_num_triangles(handle)
        pos = np.ctypeslib.as_array(
            lib.obj_positions(handle), shape=(nv, 3)
        ).copy()
        vns = np.ctypeslib.as_array(
            lib.obj_normals(handle), shape=(nn, 3)
        ).copy() if nn else np.zeros((0, 3), np.float32)
        tris = np.ctypeslib.as_array(
            lib.obj_tri_v(handle), shape=(nt, 3)
        ).copy() if nt else np.zeros((0, 3), np.int32)
        tri_vn = np.ctypeslib.as_array(
            lib.obj_tri_vn(handle), shape=(nt, 3)
        ).copy() if nt else np.zeros((0, 3), np.int32)
    finally:
        lib.obj_free(handle)

    if len(vns) == len(pos):
        normals = vns
    elif len(vns) > 0 and nt and tri_vn.min() >= 0:
        if tri_vn.max() >= len(vns):
            raise ValueError(
                f"{path}: face references normal index "
                f"{int(tri_vn.max()) + 1} but file declares only "
                f"{len(vns)} normals"
            )
        normals = np.zeros_like(pos)
        normals[tris.reshape(-1).astype(np.int64)] = vns[
            tri_vn.reshape(-1).astype(np.int64)
        ]
    else:
        normals = compute_smooth_normals(pos, tris)

    mesh = Mesh(
        positions=pos.astype(np.float32),
        normals=normals.astype(np.float32),
        triangles=tris.astype(np.int32),
        name=os.path.basename(path),
    )
    mesh.validate()
    return mesh


def read_jpeg(path: str):
    """Decode a baseline JPEG via the native decoder → (H, W, 3) uint8.

    Supports baseline sequential Huffman JPEGs (the skybox assets);
    raises ValueError for unsupported variants so callers can fall back
    to PIL (``raytpu.io.image.read_image`` does).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not built (make -C native)")
    lib.jpeg_decode_file.restype = ctypes.c_void_p
    lib.jpeg_decode_file.argtypes = [ctypes.c_char_p]
    lib.jpeg_error.restype = ctypes.c_char_p
    lib.jpeg_error.argtypes = [ctypes.c_void_p]
    for name in ("jpeg_width", "jpeg_height"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int32
        fn.argtypes = [ctypes.c_void_p]
    lib.jpeg_rgb.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.jpeg_rgb.argtypes = [ctypes.c_void_p]
    lib.jpeg_free.argtypes = [ctypes.c_void_p]
    lib.jpeg_free.restype = None

    handle = lib.jpeg_decode_file(path.encode())
    try:
        err = lib.jpeg_error(handle)
        if err:
            raise ValueError(f"{path}: {err.decode()}")
        w = lib.jpeg_width(handle)
        h = lib.jpeg_height(handle)
        rgb = np.ctypeslib.as_array(lib.jpeg_rgb(handle), shape=(h, w, 3)).copy()
    finally:
        lib.jpeg_free(handle)
    return rgb
