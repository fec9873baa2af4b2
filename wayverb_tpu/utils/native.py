"""ctypes bindings for the native setup runtime (native/wayverb_native.cpp).

Built on demand with g++ into ``native/libwayverb_native.<hash>.so``, keyed
on a hash of the source, so an edit to the source always rebuilds and a
stale library is never loaded.  Everything degrades gracefully to the
pure-Python setup paths when no compiler is available; ``status()`` says
which path this process uses.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_SRC = os.path.join(_NATIVE_DIR, "wayverb_native.cpp")

_lib: Optional[ctypes.CDLL] = None
_tried = False
_status = {"path": "python", "library": None, "built": False,
           "error": None}


def library_path() -> Optional[str]:
    """Where the library for the current source lives (None: no source)."""
    if not os.path.exists(_SRC):
        return None
    with open(_SRC, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    return os.path.join(_NATIVE_DIR, f"libwayverb_native.{digest}.so")


def _build(lib_path: str) -> None:
    # build under a private name, then rename: concurrent test workers
    # never load a half-written library
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O3", "-fopenmp", "-shared", "-fPIC", "-o", tmp, _SRC],
            check=True, capture_output=True, timeout=300)
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    lib_path = library_path()
    if lib_path is None:
        _status["error"] = "no native source"
        return None
    try:
        if not os.path.exists(lib_path):
            _build(lib_path)
            _status["built"] = True
        lib = ctypes.CDLL(lib_path)
    except (OSError, subprocess.SubprocessError) as exc:
        _status["error"] = f"{type(exc).__name__}: {exc}"
        return None
    lib.wv_classify_inside.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8)]
    lib.wv_closest_triangle_surface.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32)]
    lib.wv_version.restype = ctypes.c_int
    _status.update(path="native", library=lib_path)
    _lib = lib
    return _lib


def status() -> dict:
    """Which setup path this process uses: ``path`` is "native" or
    "python"; ``built`` is True when this process compiled the library;
    ``error`` says why the native path is off."""
    get_lib()
    return dict(_status)


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def classify_inside(points: np.ndarray, vertices: np.ndarray,
                    triangles: np.ndarray,
                    grid_side: int = 16) -> Optional[np.ndarray]:
    """(P,) bool inside flags via the native voxel-DDA parity vote, or None
    if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    points = np.ascontiguousarray(points, dtype=np.float64)
    vertices = np.ascontiguousarray(vertices, dtype=np.float64)
    triangles = np.ascontiguousarray(triangles, dtype=np.int32)
    out = np.zeros(points.shape[0], dtype=np.uint8)
    lib.wv_classify_inside(
        _ptr(points, ctypes.c_double), points.shape[0],
        _ptr(vertices, ctypes.c_double), _ptr(triangles, ctypes.c_int32),
        triangles.shape[0], grid_side, _ptr(out, ctypes.c_uint8))
    return out.astype(bool)


def closest_triangle_surface(points: np.ndarray, vertices: np.ndarray,
                             triangles: np.ndarray,
                             tri_surfaces: np.ndarray
                             ) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None:
        return None
    points = np.ascontiguousarray(points, dtype=np.float64)
    vertices = np.ascontiguousarray(vertices, dtype=np.float64)
    triangles = np.ascontiguousarray(triangles, dtype=np.int32)
    tri_surfaces = np.ascontiguousarray(tri_surfaces, dtype=np.int32)
    out = np.zeros(points.shape[0], dtype=np.int32)
    lib.wv_closest_triangle_surface(
        _ptr(points, ctypes.c_double), points.shape[0],
        _ptr(vertices, ctypes.c_double), _ptr(triangles, ctypes.c_int32),
        _ptr(tri_surfaces, ctypes.c_int32), triangles.shape[0],
        _ptr(out, ctypes.c_int32))
    return out
