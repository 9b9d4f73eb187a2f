"""Native (C++) host code of the port, built on demand with g++ and loaded
with ctypes (a plain C interface, no pybind11).

  * marching.cpp — marching-tetrahedra mesh extraction (a copy of
    ``dynhor_tpu/native/marching.cpp``; the unique-edge dedup dominates the
    numpy path on large SDF grids).

The library is built into ``<repo>/build/`` under a name that carries a
hash of the source and flags, so an edit rebuilds, and is written to a
temporary name and moved into place, so a concurrent build never loads
half a file.  Nothing is built when this module is imported.  A failed
build raises with g++'s message: callers that want the numpy path ask for
it (``neus.extract``'s ``use_native=False``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from ..kernels import BUILD_DIR

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "marching.cpp")
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _build() -> str:
    """Path of the built library, compiling it if it is missing."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_FLAGS).encode()).hexdigest()
    lib = os.path.join(BUILD_DIR, f"marching_{digest[:16]}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    try:
        out = subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp], capture_output=True,
                             text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"g++ could not build native/marching.cpp: {e}") from e
    if out.returncode != 0:
        raise RuntimeError(f"g++ failed on native/marching.cpp:\n{out.stderr}")
    os.replace(tmp, lib)
    return lib


def load_marching() -> ctypes.CDLL:
    """ctypes handle to the marching library, built at first use; raises
    RuntimeError with the compiler's message when it cannot be built."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_build())
            lib.mt_extract.restype = ctypes.c_int
            lib.mt_extract.argtypes = [
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
                ctypes.POINTER(ctypes.c_int64),
            ]
            lib.mt_free.restype = None
            lib.mt_free.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)]
            _lib = lib
        return _lib


def marching_tetrahedra_native(sdf_grid: np.ndarray, origin,
                               spacing) -> tuple[np.ndarray, np.ndarray]:
    """Native marching tetrahedra: (verts (V, 3) f32, faces (F, 3) int32).

    Same surface as ``neus.extract.marching_tetrahedra`` (vertex order may
    differ; it interpolates in f32)."""
    lib = load_marching()
    sdf = np.ascontiguousarray(sdf_grid, np.float32)
    nx, ny, nz = sdf.shape
    origin = np.ascontiguousarray(np.broadcast_to(np.asarray(origin, np.float32), (3,)))
    spacing = np.ascontiguousarray(np.broadcast_to(np.asarray(spacing, np.float32), (3,)))
    vp = ctypes.POINTER(ctypes.c_float)()
    fp = ctypes.POINTER(ctypes.c_int32)()
    nv = ctypes.c_int64()
    nf = ctypes.c_int64()
    rc = lib.mt_extract(
        sdf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), nx, ny, nz,
        origin.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        spacing.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.byref(vp), ctypes.byref(nv), ctypes.byref(fp), ctypes.byref(nf),
    )
    if rc != 0:
        raise RuntimeError(f"mt_extract failed with code {rc}")
    try:
        if nv.value == 0:
            return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
        verts = np.ctypeslib.as_array(vp, shape=(nv.value, 3)).copy()
        faces = np.ctypeslib.as_array(fp, shape=(nf.value, 3)).copy()
    finally:
        lib.mt_free(vp, fp)
    return verts, faces
