"""Build and bind the port's CUDA kernels (csrc/*.cu).

Each source is compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library of its own with a plain C interface under ``<repo>/build/``
(named by a hash of the source and its flags, so an edit rebuilds), and
loaded with ``ctypes``.  ``build()`` compiles every source at once, one
``nvcc`` each, started together.  Nothing is built or loaded when this
module is imported.

Each wrapper checks device, dtype, shape and layout, allocates its outputs,
launches on ``torch.cuda.current_stream()``, raises if the launch was
refused (the C entry point returns ``cudaGetLastError()``), and adds one to
its ``launches`` count — a plain integer on the wrapper, so a run can show
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
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build")
_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_STRIDES = ctypes.POINTER(ctypes.c_longlong)  # a host array
# Source name -> (its own nvcc flags, {C entry point: argtypes}); every entry
# returns an int, cudaGetLastError() after its launch.
SOURCES = {
    # No FMA contraction: the raster kernels round like their plain versions,
    # so the hard raster decisions agree; the fused multiply-adds they need
    # are explicit (see csrc/raster_fused.cu).
    "raster_fused": ([*_FLAGS, "-fmad=false"], {
        "dynhor_fused_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P],
        "dynhor_sil_bwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
        "dynhor_depth_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    }),
    # The attention kernels make no hard decision and keep nvcc's default.
    "flash_attention": (list(_FLAGS), {
        "dynhor_flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _STRIDES, _P],
        "dynhor_flash_delta": [_P, _P, _P, _I, _I, _I, _STRIDES, _P],
        "dynhor_flash_bwd_dkv": [_P] * 8 + [_I, _I, _I, _F, _STRIDES, _P],
        "dynhor_flash_bwd_dq": [_P] * 7 + [_I, _I, _I, _F, _STRIDES, _P],
    }),
}

_libs: dict[str, ctypes.CDLL] = {}  # loaded at first use
_ptxas_logs: dict[str, str] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def _start_build(name: str):
    """Start compiling one source if its library is missing; returns
    (library path, log path, temporary path, the running nvcc or None)."""
    src = os.path.join(_HERE, "csrc", name + ".cu")
    flags = SOURCES[name][0]
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode()).hexdigest()
    stem = f"{name}_{digest[:16]}"
    lib = os.path.join(BUILD_DIR, stem + ".so")
    log = os.path.join(BUILD_DIR, stem + ".log")
    if os.path.exists(lib):
        return lib, log, None, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.Popen(
        [_nvcc(), *flags, "-o", tmp, src],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    return lib, log, tmp, proc


def _finish_build(name: str, lib: str, log: str, tmp, proc) -> None:
    """Wait for one source's nvcc, load its library and bind its entries."""
    if proc is not None:
        _, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{stderr}")
        with open(log, "w") as f:
            f.write(stderr)
        os.replace(tmp, lib)  # atomic: concurrent builders never see half a file
    with open(log) as f:
        _ptxas_logs[name] = f.read()
    cdll = ctypes.CDLL(lib)
    for entry, argtypes in SOURCES[name][1].items():
        fn = getattr(cdll, entry)
        fn.argtypes, fn.restype = argtypes, _I
    _libs[name] = cdll


def _lib(name: str) -> ctypes.CDLL:
    """One source's library, built and loaded at first use."""
    if name not in _libs:
        _finish_build(name, *_start_build(name))
    return _libs[name]


def build() -> str:
    """Build every kernel library not yet loaded (all compilers started
    together) and load them; returns ptxas's report (registers, shared
    memory, spills) of each kernel."""
    started = {name: _start_build(name) for name in SOURCES if name not in _libs}
    errors = []
    for name, job in started.items():  # wait for every compiler before raising
        try:
            _finish_build(name, *job)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return "".join(_ptxas_logs[name] for name in SOURCES)


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
        err = _lib("raster_fused").dynhor_fused_fwd(
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
        err = _lib("raster_fused").dynhor_sil_bwd(
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
        err = _lib("raster_fused").dynhor_depth_fwd(
            rows.data_ptr(), counts.data_ptr(), zmin.data_ptr(), jbest.data_ptr(),
            b * t, t, m, tile, tiles_w, znear, stream,
        )
    if err:
        raise RuntimeError(f"depth_fwd kernel launch failed: CUDA error {err}")
    depth_fwd.launches += 1
    return zmin, jbest


depth_fwd.launches = 0


# --------------------------------------------------------------------------
# K5: flash attention (csrc/flash_attention.cu), bf16 at head dim 64.
# --------------------------------------------------------------------------

_FLASH_HD = 64


def _check_heads(name: str, x: torch.Tensor, shape: tuple | None = None) -> None:
    """A (B, H, N, 64) bf16 CUDA view whose innermost values are contiguous
    and whose rows are 16-byte aligned; any batch, head and token strides."""
    if not x.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got device {x.device}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{name} must be torch.bfloat16, got {x.dtype}")
    if x.dim() != 4 or x.shape[-1] != _FLASH_HD or (shape is not None and tuple(x.shape) != shape):
        want = shape if shape is not None else f"(B, H, N, {_FLASH_HD})"
        raise ValueError(f"{name} must have shape {want}, got {tuple(x.shape)}")
    if x.shape[0] > 65535 or x.shape[1] > 65535:
        raise ValueError(f"{name}: batch and heads must be at most 65535 each")
    if x.numel() and (
        x.stride(3) != 1 or x.data_ptr() % 16 or any(x.stride(d) % 8 for d in range(3))
    ):
        raise ValueError(
            f"{name}: the head dim must be contiguous and every row 16-byte aligned "
            f"(strides {x.stride()})"
        )


def _strides(*tensors: torch.Tensor):
    flat = [s for x in tensors for s in x.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _heads_out(like: torch.Tensor) -> torch.Tensor:
    """An uninitialized (B, H, N, 64) output laid out in memory as
    (B, N, H, 64), so that the caller's ``transpose(1, 2).reshape(B, N, H * 64)``
    is a view."""
    b, h, n, d = like.shape
    return torch.empty((b, n, h, d), dtype=like.dtype, device=like.device).transpose(1, 2)


def flash_fwd(q, k, v, sm_scale: float):
    """K5 forward on the card: see ops/flash_attention.flash_fwd_plain.
    Returns (o (B, H, N, 64) bf16 stored as (B, N, H, 64), lse (B, H, N) f32)."""
    _check_heads("q", q)
    b, h, n, _ = q.shape
    _check_heads("k", k, (b, h, n, _FLASH_HD))
    _check_heads("v", v, (b, h, n, _FLASH_HD))
    o = _heads_out(q)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return o, lse
    lib = _lib("flash_attention")
    with torch.cuda.device(q.device):
        err = lib.dynhor_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            b, h, n, sm_scale, _strides(q, k, v, o),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {err}")
    flash_fwd.launches += 1
    return o, lse


flash_fwd.launches = 0


def _check_bwd(q, k, v, d_o, lse, delta):
    _check_heads("q", q)
    shape = tuple(q.shape)
    _check_heads("k", k, shape)
    _check_heads("v", v, shape)
    _check_heads("d_o", d_o, shape)
    _check("lse", lse, torch.float32, shape[:3])
    _check("delta", delta, torch.float32, shape[:3])
    return shape[:3]


def flash_bwd_delta(o, d_o):
    """K5 backward, delta = rowsum(dO * O): (B, H, N) f32."""
    _check_heads("o", o)
    b, h, n, _ = o.shape
    _check_heads("d_o", d_o, tuple(o.shape))
    delta = torch.empty((b, h, n), dtype=torch.float32, device=o.device)
    if o.numel() == 0:
        return delta
    lib = _lib("flash_attention")
    with torch.cuda.device(o.device):
        err = lib.dynhor_flash_delta(
            o.data_ptr(), d_o.data_ptr(), delta.data_ptr(), b, h, n, _strides(o, d_o),
            torch.cuda.current_stream(o.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"flash_bwd_delta kernel launch failed: CUDA error {err}")
    flash_bwd_delta.launches += 1
    return delta


flash_bwd_delta.launches = 0


def flash_bwd_dkv(q, k, v, d_o, lse, delta, sm_scale: float):
    """K5 backward on the card, (dk, dv): see
    ops/flash_attention.flash_bwd_plain."""
    b, h, n = _check_bwd(q, k, v, d_o, lse, delta)
    dk, dv = _heads_out(k), _heads_out(v)
    if q.numel() == 0:
        return dk, dv
    lib = _lib("flash_attention")
    with torch.cuda.device(q.device):
        err = lib.dynhor_flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), d_o.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, n, sm_scale,
            _strides(q, k, v, d_o, dk, dv), torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"flash_bwd_dkv kernel launch failed: CUDA error {err}")
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


def flash_bwd_dq(q, k, v, d_o, lse, delta, sm_scale: float):
    """K5 backward on the card, dq: see ops/flash_attention.flash_bwd_plain."""
    b, h, n = _check_bwd(q, k, v, d_o, lse, delta)
    dq = _heads_out(q)
    if q.numel() == 0:
        return dq
    lib = _lib("flash_attention")
    with torch.cuda.device(q.device):
        err = lib.dynhor_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), d_o.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), b, h, n, sm_scale,
            _strides(q, k, v, d_o, dq), torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"flash_bwd_dq kernel launch failed: CUDA error {err}")
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0
