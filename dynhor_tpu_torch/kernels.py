"""Build and bind the port's CUDA kernels (csrc/*.cu).

The sources are compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface under ``<repo>/build/`` (named by
a hash of the source and flags, so an edit rebuilds), and loaded with
``ctypes``.  Nothing is built or loaded when this module is imported.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs, launches on ``torch.cuda.current_stream()``, raises if the launch
was refused (the C entry point returns ``cudaGetLastError()``), and adds one
to its ``launches`` count — a plain integer on the wrapper, so a run can show
that it went through the kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
_SOURCE = os.path.join(_HERE, "csrc", "raster_fused.cu")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # No FMA contraction: the kernels round like their plain versions, so
    # the hard raster decisions agree; the fused multiply-adds they need are
    # explicit (see csrc/raster_fused.cu).
    "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lib: ctypes.CDLL | None = None  # loaded at first use
_ptxas_log = ""


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def _build_one(src: str) -> tuple[str, str]:
    """Compile one source (if its library is missing); returns (library
    path, ptxas log)."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    stem = f"{os.path.splitext(os.path.basename(src))[0]}_{digest[:16]}"
    lib = os.path.join(BUILD_DIR, stem + ".so")
    log = os.path.join(BUILD_DIR, stem + ".log")
    if not os.path.exists(lib):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
        with open(log, "w") as f:
            f.write(proc.stderr)
        os.replace(tmp, lib)  # atomic: concurrent builders never see half a file
    with open(log) as f:
        return lib, f.read()


def build() -> str:
    """Build the kernel library (once per process) and load it; returns the
    ptxas report (registers, shared memory, spills) of each kernel."""
    global _lib, _ptxas_log
    if _lib is None:
        path, _ptxas_log = _build_one(_SOURCE)
        lib = ctypes.CDLL(path)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.dynhor_fused_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, f, f, p]
        lib.dynhor_fused_fwd.restype = i
        lib.dynhor_sil_bwd.argtypes = [p, p, p, p, i, i, i, i, i, f, p]
        lib.dynhor_sil_bwd.restype = i
        lib.dynhor_depth_fwd.argtypes = [p, p, p, p, i, i, i, i, i, f, p]
        lib.dynhor_depth_fwd.restype = i
        _lib = lib
    return _ptxas_log


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape: tuple, align: int = 4) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got device {x.device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
    if not x.is_contiguous() or x.data_ptr() % align:
        raise ValueError(f"{name} must be contiguous and {align}-byte aligned")


def _launch_args(rows: torch.Tensor, counts: torch.Tensor, tile: int):
    if rows.dim() != 4 or rows.shape[-1] != 16:
        raise ValueError(f"rows must be (B, T, M, 16), got {tuple(rows.shape)}")
    if not 1 <= tile * tile <= 1024:
        raise ValueError(f"tile {tile}: tile*tile must be in [1, 1024]")
    b, t, m, _ = rows.shape
    _check("rows", rows, torch.float32, (b, t, m, 16), align=16)  # float4 loads
    _check("counts", counts, torch.int32, (b, t))
    build()
    return b, t, m, torch.cuda.current_stream(rows.device).cuda_stream


def fused_fwd(rows, counts, tile, tiles_w, sigma, znear):
    """K1 on the card: see ops/raster_fused.tile_mass_depth_plain."""
    b, t, m, stream = _launch_args(rows, counts, tile)
    p = tile * tile
    mass = torch.empty((b, t, p), dtype=torch.float32, device=rows.device)
    zmin = torch.empty_like(mass)
    jbest = torch.empty((b, t, p), dtype=torch.int32, device=rows.device)
    if b * t == 0:
        return mass, zmin, jbest
    with torch.cuda.device(rows.device):
        err = _lib.dynhor_fused_fwd(
            rows.data_ptr(), counts.data_ptr(), mass.data_ptr(), zmin.data_ptr(),
            jbest.data_ptr(), b * t, t, m, tile, tiles_w, sigma, znear, stream,
        )
    if err:
        raise RuntimeError(f"fused_fwd kernel launch failed: CUDA error {err}")
    fused_fwd.launches += 1
    return mass, zmin, jbest


fused_fwd.launches = 0


def sil_bwd(rows, counts, g, tile, tiles_w, sigma):
    """K2 on the card: see ops/raster_fused.tile_mass_grad_plain."""
    b, t, m, stream = _launch_args(rows, counts, tile)
    _check("g", g, torch.float32, (b, t, tile * tile))
    dxy = torch.empty((b, t, m, 6), dtype=torch.float32, device=rows.device)
    if b * t == 0:
        return dxy
    with torch.cuda.device(rows.device):
        err = _lib.dynhor_sil_bwd(
            rows.data_ptr(), counts.data_ptr(), g.data_ptr(), dxy.data_ptr(),
            b * t, t, m, tile, tiles_w, sigma, stream,
        )
    if err:
        raise RuntimeError(f"sil_bwd kernel launch failed: CUDA error {err}")
    sil_bwd.launches += 1
    return dxy


sil_bwd.launches = 0


def depth_fwd(rows, counts, tile, tiles_w, znear):
    """K3 on the card: see ops/raster_fused.tile_depth_plain."""
    b, t, m, stream = _launch_args(rows, counts, tile)
    p = tile * tile
    zmin = torch.empty((b, t, p), dtype=torch.float32, device=rows.device)
    jbest = torch.empty((b, t, p), dtype=torch.int32, device=rows.device)
    if b * t == 0:
        return zmin, jbest
    with torch.cuda.device(rows.device):
        err = _lib.dynhor_depth_fwd(
            rows.data_ptr(), counts.data_ptr(), zmin.data_ptr(), jbest.data_ptr(),
            b * t, t, m, tile, tiles_w, znear, stream,
        )
    if err:
        raise RuntimeError(f"depth_fwd kernel launch failed: CUDA error {err}")
    depth_fwd.launches += 1
    return zmin, jbest


depth_fwd.launches = 0
