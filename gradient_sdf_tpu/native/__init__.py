"""ctypes bindings for the native runtime library (libgradsdf_native.so).

Gracefully degrades: if the shared library is missing it is built on first
use when a toolchain is available, else `available()` returns False and
callers (data.loaders, utils.ply, ops.marching_cubes) fall back to the
pure-Python paths.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "libgradsdf_native.so")
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.isfile(_SO):
        try:
            subprocess.run(
                ["make", "-C", _DIR], check=True, capture_output=True, timeout=120
            )
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None

    lib.png_decode_file.restype = ctypes.c_int
    lib.png_decode_file.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.write_ply_mesh.restype = ctypes.c_int
    lib.write_ply_mesh.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
    ]
    lib.write_ply_points.restype = ctypes.c_int
    lib.write_ply_points.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.dedup_vertices.restype = ctypes.c_int64
    lib.dedup_vertices.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_double,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.prefetcher_create.restype = ctypes.c_void_p
    lib.prefetcher_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
    ]
    lib.prefetcher_meta.restype = ctypes.c_int
    lib.prefetcher_meta.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    ]
    lib.prefetcher_get.restype = ctypes.c_int
    lib.prefetcher_get.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_size_t
    ]
    lib.prefetcher_destroy.restype = None
    lib.prefetcher_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def decode_png(path: str) -> Optional[np.ndarray]:
    """Decode a PNG file. Returns [H,W] or [H,W,3] uint8/uint16 array, or
    None (unsupported format -> caller falls back to utils.png)."""
    lib = _load()
    if lib is None:
        return None
    w = ctypes.c_int()
    h = ctypes.c_int()
    d = ctypes.c_int()
    c = ctypes.c_int()
    # first call with a large buffer; retry not needed since header tells size
    # after rc==-9 we cannot know size; instead decode twice: header via a
    # small probe decode. Simpler: allocate generously based on file size*64
    # is unsafe -> do a two-step: call with zero capacity to read header.
    rc = lib.png_decode_file(path.encode(), None, 0, ctypes.byref(w),
                             ctypes.byref(h), ctypes.byref(d), ctypes.byref(c))
    if rc != -9 and rc != 0:
        return None
    dtype = np.uint16 if d.value == 16 else np.uint8
    shape = (h.value, w.value) if c.value == 1 else (h.value, w.value, c.value)
    out = np.empty(shape, dtype=dtype)
    rc = lib.png_decode_file(
        path.encode(), out.ctypes.data_as(ctypes.c_void_p), out.nbytes,
        ctypes.byref(w), ctypes.byref(h), ctypes.byref(d), ctypes.byref(c),
    )
    if rc != 0:
        return None
    return out


def write_ply_mesh(path, verts, faces, colors=None) -> bool:
    lib = _load()
    if lib is None:
        return False
    verts = np.ascontiguousarray(verts, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    cptr = None
    if colors is not None:
        colors = np.ascontiguousarray(colors, np.uint8)
        cptr = colors.ctypes.data_as(ctypes.c_void_p)
    rc = lib.write_ply_mesh(
        path.encode(), verts.ctypes.data_as(ctypes.c_void_p), len(verts),
        faces.ctypes.data_as(ctypes.c_void_p), len(faces), cptr,
    )
    return rc == 0


def write_ply_points(path, pts, normals=None, colors=None) -> bool:
    lib = _load()
    if lib is None:
        return False
    pts = np.ascontiguousarray(pts, np.float32)
    nptr = cptr = None
    if normals is not None:
        normals = np.ascontiguousarray(normals, np.float32)
        nptr = normals.ctypes.data_as(ctypes.c_void_p)
    if colors is not None:
        colors = np.ascontiguousarray(colors, np.uint8)
        cptr = colors.ctypes.data_as(ctypes.c_void_p)
    rc = lib.write_ply_points(
        path.encode(), pts.ctypes.data_as(ctypes.c_void_p), nptr, cptr,
        len(pts),
    )
    return rc == 0


def dedup_vertices(verts: np.ndarray, quantum: float):
    """Returns (unique_verts [M,3], index_map [N]) or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    verts = np.ascontiguousarray(verts, np.float32)
    n = len(verts)
    index_map = np.empty(n, np.int32)
    unique = np.empty_like(verts)
    m = lib.dedup_vertices(
        verts.ctypes.data_as(ctypes.c_void_p), n, quantum,
        index_map.ctypes.data_as(ctypes.c_void_p),
        unique.ctypes.data_as(ctypes.c_void_p),
    )
    return unique[:m].copy(), index_map


class Prefetcher:
    """Threaded PNG prefetcher over an ordered file list.

    `window` bounds the decode-ahead: at most that many decoded-but-
    unconsumed frames are resident at once (memory O(window), not
    O(sequence)); 0 = unbounded."""

    def __init__(self, paths, n_threads: int = 2, window: int = 16):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._paths = [p.encode() for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        self._handle = lib.prefetcher_create(arr, len(self._paths),
                                             n_threads, window)
        self._n = len(paths)

    def get(self, i: int) -> Optional[np.ndarray]:
        meta = (ctypes.c_int * 4)()
        st = self._lib.prefetcher_meta(self._handle, i, meta)
        if st != 1:
            return None
        w, h, d, c = meta[0], meta[1], meta[2], meta[3]
        dtype = np.uint16 if d == 16 else np.uint8
        shape = (h, w) if c == 1 else (h, w, c)
        out = np.empty(shape, dtype=dtype)
        st = self._lib.prefetcher_get(
            self._handle, i, out.ctypes.data_as(ctypes.c_void_p), out.nbytes
        )
        return out if st == 1 else None

    def close(self):
        if self._handle:
            self._lib.prefetcher_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
