"""Build and bind the port's CUDA kernels (csrc/*.cu).

Each source is compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library of its own with a plain C interface under ``<repo>/build/``
(named by a hash of the source and its flags, so an edit rebuilds), and
loaded with ``ctypes``.  ``build()`` compiles every source at once, one
``nvcc`` each, started together.  Nothing is built or loaded when this
module is imported.

Each wrapper checks device, dtype, shape and layout, allocates its outputs
and scratch, launches on ``torch.cuda.current_stream()``, raises if the
launch was refused (the C entry point returns ``cudaGetLastError()``), and
adds one to its ``launches`` count — a plain integer on the wrapper, so a
run can show that it went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
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
_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_STRIDES = ctypes.POINTER(ctypes.c_longlong)  # a host array
# Source name -> (its own nvcc flags, {C entry point: argtypes}); every entry
# returns an int, cudaGetLastError() after its launch.
SOURCES = {
    # No FMA contraction: the raster kernels round like their plain versions,
    # so the hard raster decisions agree; the fused multiply-adds they need
    # are explicit (see csrc/raster_fused.cu).
    "raster_fused": ([*_FLAGS, "-fmad=false"], {
        "dynhor_fused_fwd": [_P] * 7 + [_I] * 7 + [_F, _F, _P],
        "dynhor_sil_bwd": [_P] * 5 + [_I] * 5 + [_F, _P],
        "dynhor_depth_fwd": [_P] * 7 + [_I] * 8 + [_F, _P],
        "dynhor_sil_mass_fwd": [_P] * 5 + [_I] * 7 + [_F, _P],
    }),
    # The attention kernels make no hard decision and keep nvcc's default.
    "flash_attention": (list(_FLAGS), {
        "dynhor_flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _STRIDES, _P],
        "dynhor_flash_delta": [_P, _P, _P, _I, _I, _I, _STRIDES, _P],
        "dynhor_flash_bwd_dkv": [_P] * 8 + [_I, _I, _I, _F, _STRIDES, _P],
        "dynhor_flash_bwd_dq": [_P] * 7 + [_I, _I, _I, _F, _STRIDES, _P],
    }),
    # The f32 attention: the same C signatures, a library of its own.
    "flash_attention_f32": (list(_FLAGS), {
        "dynhor_flash_fwd_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _STRIDES, _P],
        "dynhor_flash_delta_f32": [_P, _P, _P, _I, _I, _I, _STRIDES, _P],
        "dynhor_flash_bwd_dkv_f32": [_P] * 8 + [_I, _I, _I, _F, _STRIDES, _P],
        "dynhor_flash_bwd_dq_f32": [_P] * 7 + [_I, _I, _I, _F, _STRIDES, _P],
    }),
    # Loads, adds and shuffles: nvcc's default.
    "gather_probe": (list(_FLAGS), {
        "dynhor_take_along_axis": [_P, _P, _P, _I, _I, _L, _L, _L, _L, _I, _I, _P],
        "dynhor_scatter_add_axis0": [_P, _P, _P, _I, _I, _I, _L, _L, _I, _I, _P],
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


def _start_build(name: str, build_dir: str | None = None):
    """Start compiling one source if its library is missing from
    ``build_dir`` (default ``BUILD_DIR``); returns (library path, log path,
    temporary path, the running nvcc or None)."""
    build_dir = build_dir or BUILD_DIR
    src = os.path.join(_HERE, "csrc", name + ".cu")
    flags = SOURCES[name][0]
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode()).hexdigest()
    stem = f"{name}_{digest[:16]}"
    lib = os.path.join(build_dir, stem + ".so")
    log = os.path.join(build_dir, stem + ".log")
    if os.path.exists(lib):
        return lib, log, None, None
    os.makedirs(build_dir, exist_ok=True)
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


def build(build_dir: str | None = None) -> str:
    """Build every kernel library not yet loaded (all compilers started
    together) and load them; returns ptxas's report (registers, shared
    memory, spills) of each kernel.  With ``build_dir``, every library is
    built there (where missing) and loaded from there, in place of any
    loaded before."""
    names = SOURCES if build_dir else [name for name in SOURCES if name not in _libs]
    started = {name: _start_build(name, build_dir) for name in names}
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


# K1-K4 run on a work list cut by the counts (csrc/raster_fused.cu): an item
# is (tile row, chunk of slots), MASS_CHUNK slots for K1, K3 and K4a,
# GRAD_CHUNK (one a lane of a warp, fixed in the source) for K2 and K4b.
MASS_CHUNK = 64
GRAD_CHUNK = 32


@functools.lru_cache(maxsize=None)
def _part_blocks(device: torch.device, n_pix: int) -> int:
    """The most blocks of ``n_pix`` threads the card can hold at once: the
    number of partial-result pairs K1's, K3's and K4a's scratch must hold."""
    props = torch.cuda.get_device_properties(device)
    per_sm = getattr(props, "max_threads_per_multi_processor", 2048) // n_pix
    return props.multi_processor_count * max(1, per_sm)


def _mass_launch(wrapper, entry, rows, counts, tile, tiles_w, sigma, outs, extra):
    """K1's or K4a's three launches (pre-pass, forward, merge) with their
    scratch; ``outs`` are the output tensors, ``extra`` the arguments after
    sigma."""
    b, t, m, _ = rows.shape
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    n_pix = tile * tile
    blocks = _part_blocks(rows.device, n_pix)
    start = torch.empty((b * t + 1,), dtype=torch.int32, device=rows.device)
    parts = torch.empty((len(outs), 2 * blocks, n_pix), dtype=torch.float32, device=rows.device)
    with torch.cuda.device(rows.device):
        err = entry(
            rows.data_ptr(), counts.data_ptr(), *(x.data_ptr() for x in outs), start.data_ptr(),
            parts.data_ptr(), blocks, b * t, t, m, MASS_CHUNK, tile, tiles_w, sigma, *extra,
            stream,
        )
    if err:
        raise RuntimeError(f"{wrapper.__name__} kernel launch failed: CUDA error {err}")
    wrapper.launches += 1


def fused_fwd(rows, counts, tile, tiles_w, sigma, znear):
    """K1 on the card: see ops/raster_fused.tile_mass_depth_plain."""
    b, t, m, _ = _launch_args(rows, counts, tile)
    p = tile * tile
    mass = torch.empty((b, t, p), dtype=torch.float32, device=rows.device)
    zmin = torch.empty_like(mass)
    jbest = torch.empty((b, t, p), dtype=torch.int32, device=rows.device)
    if b * t == 0:
        return mass, zmin, jbest
    _mass_launch(fused_fwd, _lib("raster_fused").dynhor_fused_fwd, rows, counts, tile, tiles_w,
                 sigma, (mass, zmin, jbest), (znear,))
    return mass, zmin, jbest


fused_fwd.launches = 0


def _sil_bwd(wrapper, rows, counts, g, tile, tiles_w, sigma):
    """K2's kernel, counted on ``wrapper``: (B, T, M, 6) d(mass)/d(slot xy)."""
    b, t, m, stream = _launch_args(rows, counts, tile)
    _check("g", g, torch.float32, (b, t, tile * tile))
    dxy = torch.empty((b, t, m, 6), dtype=torch.float32, device=rows.device)
    if b * t == 0:
        return dxy
    start = torch.empty((b * t + 1,), dtype=torch.int32, device=rows.device)
    with torch.cuda.device(rows.device):
        err = _lib("raster_fused").dynhor_sil_bwd(
            rows.data_ptr(), counts.data_ptr(), g.data_ptr(), dxy.data_ptr(), start.data_ptr(),
            b * t, t, m, tile, tiles_w, sigma, stream,
        )
    if err:
        raise RuntimeError(f"{wrapper.__name__} kernel launch failed: CUDA error {err}")
    wrapper.launches += 1
    return dxy


def sil_bwd(rows, counts, g, tile, tiles_w, sigma):
    """K2 on the card: see ops/raster_fused.tile_mass_grad_plain."""
    return _sil_bwd(sil_bwd, rows, counts, g, tile, tiles_w, sigma)


sil_bwd.launches = 0


def sil_mass_fwd(rows, counts, tile, tiles_w, sigma):
    """K4a on the card: see ops/silhouette_kernel.tile_mass_plain.
    Returns mass (B, T, tile * tile) f32."""
    b, t, _, _ = _launch_args(rows, counts, tile)
    mass = torch.empty((b, t, tile * tile), dtype=torch.float32, device=rows.device)
    if b * t == 0:
        return mass
    _mass_launch(sil_mass_fwd, _lib("raster_fused").dynhor_sil_mass_fwd, rows, counts, tile,
                 tiles_w, sigma, (mass,), ())
    return mass


sil_mass_fwd.launches = 0


def sil_mass_bwd(rows, counts, g, tile, tiles_w, sigma):
    """K4b on the card: K2's kernel on K4a's rows (the same function, see
    csrc/raster_fused.cu), with a launch count of its own."""
    return _sil_bwd(sil_mass_bwd, rows, counts, g, tile, tiles_w, sigma)


sil_mass_bwd.launches = 0


def depth_fwd(rows_all, indices, counts, tile, tiles_w, znear):
    """K3 on the card: see ops/raster_fused.tile_depth_plain.  rows_all
    (B, F, 16) f32 per-face records, indices (B, T, M) int32 face ids per
    tile slot (each in [0, F); not checked, so that no sync enters the
    wrapper), counts (B, T) int32.  Returns zmin (B, T, tile * tile) f32 and
    the winning slot (B, T, tile * tile) int32."""
    if rows_all.dim() != 3 or rows_all.shape[-1] != 16:
        raise ValueError(f"rows_all must be (B, F, 16), got {tuple(rows_all.shape)}")
    if indices.dim() != 3:
        raise ValueError(f"indices must be (B, T, M), got {tuple(indices.shape)}")
    if not 1 <= tile * tile <= 1024:
        raise ValueError(f"tile {tile}: tile*tile must be in [1, 1024]")
    b, t, m = indices.shape
    f = rows_all.shape[1]
    _check("rows_all", rows_all, torch.float32, (b, f, 16), align=16)  # float4 loads
    _check("indices", indices, torch.int32, (b, t, m))
    _check("counts", counts, torch.int32, (b, t))
    p = tile * tile
    zmin = torch.empty((b, t, p), dtype=torch.float32, device=rows_all.device)
    jbest = torch.empty((b, t, p), dtype=torch.int32, device=rows_all.device)
    if b * t == 0:
        return zmin, jbest
    blocks = _part_blocks(rows_all.device, p)
    start = torch.empty((b * t + 1,), dtype=torch.int32, device=rows_all.device)
    parts = torch.empty((2, 2 * blocks, p), dtype=torch.float32, device=rows_all.device)
    with torch.cuda.device(rows_all.device):
        err = _lib("raster_fused").dynhor_depth_fwd(
            rows_all.data_ptr(), indices.data_ptr(), counts.data_ptr(), zmin.data_ptr(),
            jbest.data_ptr(), start.data_ptr(), parts.data_ptr(), blocks, b * t, t, m, f,
            MASS_CHUNK, tile, tiles_w, znear,
            torch.cuda.current_stream(rows_all.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"depth_fwd kernel launch failed: CUDA error {err}")
    depth_fwd.launches += 1
    return zmin, jbest


depth_fwd.launches = 0


# --------------------------------------------------------------------------
# K5: flash attention at head dim 64, bf16 (csrc/flash_attention.cu) or f32
# (csrc/flash_attention_f32.cu).  Each public wrapper takes both and sends
# f32 on to its ``*_f32`` twin, which keeps a launch count of its own.
# --------------------------------------------------------------------------

_FLASH_HD = 64
# dtype -> (source, suffix of its C entry points)
_FLASH_KERNELS = {
    torch.bfloat16: ("flash_attention", ""),
    torch.float32: ("flash_attention_f32", "_f32"),
}


def flash_dtype(dtype: torch.dtype, name: str = "q") -> torch.dtype:
    """The dtype rule of the K5 dispatch: bf16 goes to the bf16 kernels, f32
    to the f32 ones, and any other dtype raises ``ValueError`` (no cast, and
    no plain version on the card)."""
    if dtype not in _FLASH_KERNELS:
        raise ValueError(f"{name} must be torch.bfloat16 or torch.float32, got {dtype}")
    return dtype


def _check_heads(name: str, x: torch.Tensor, shape: tuple | None = None,
                 dtype: torch.dtype | None = None) -> None:
    """A (B, H, N, 64) CUDA tensor of a dtype the kernels take (``dtype``
    where given); ``tma_layout`` checks its layout."""
    if not x.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got device {x.device}")
    flash_dtype(x.dtype, name)
    if dtype is not None and x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
    if x.dim() != 4 or x.shape[-1] != _FLASH_HD or (shape is not None and tuple(x.shape) != shape):
        want = shape if shape is not None else f"(B, H, N, {_FLASH_HD})"
        raise ValueError(f"{name} must have shape {want}, got {tuple(x.shape)}")
    if x.shape[0] > 65535 or x.shape[1] > 65535:
        raise ValueError(f"{name}: batch and heads must be at most 65535 each")


def tma_layout(x: torch.Tensor, name: str = "x") -> tuple[tuple[int, ...], tuple[int, ...]]:
    """The layout through which the K5 kernels read a (B, H, N, 64) view of
    2-byte (bf16: a TMA tensor map) or 4-byte values (f32: 16-byte loads):
    its dims innermost first, (64, N, H, B), and the byte strides of the
    token, head and batch dims.  The stride of a dim of extent 1 is never
    used; it is replaced by the span of the dims inside it.

    Raises ``ValueError`` for a layout neither can read: a head dim that is
    not contiguous, a base that is not 16-byte aligned, or a stride that is
    not a positive multiple of 16 bytes (a broadcast's zero stride included)."""
    shape, stride, size = x.shape, x.stride(), x.element_size()
    if len(shape) != 4 or shape[3] != _FLASH_HD or size not in (2, 4):
        raise ValueError(
            f"{name} must be a (B, H, N, {_FLASH_HD}) tensor of 2- or 4-byte values, "
            f"got {x.dtype} {tuple(shape)}"
        )
    if stride[3] != 1:
        raise ValueError(f"{name}: the head dim must be contiguous (strides {stride})")
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: the base must be 16-byte aligned (address {x.data_ptr():#x})")
    b, h, n, d = shape
    row = size * d
    sn = size * stride[2] if n > 1 else row
    sh = size * stride[1] if h > 1 else max(row, sn * n)
    sb = size * stride[0] if b > 1 else max(row, sn * n, sh * h)
    if min(sn, sh, sb) <= 0 or (sn | sh | sb) % 16:
        raise ValueError(
            f"{name}: every stride must be a positive multiple of 16 bytes "
            f"(strides {stride}, in elements of {size} bytes)"
        )
    return (d, n, h, b), (sn, sh, sb)


def _strides(*tensors: torch.Tensor):
    flat = [s for x in tensors for s in x.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _map_strides(inputs: dict, *outputs: torch.Tensor):
    """The strides array of a K5 launch, (batch, head, token) in elements per
    tensor: the inputs' as ``tma_layout`` gives them (which checks each),
    then the outputs'."""
    flat = []
    for name, x in inputs.items():
        _, (sn, sh, sb) = tma_layout(x, name)
        size = x.element_size()
        flat += (sb // size, sh // size, sn // size)
    for x in outputs:
        flat += x.stride()[:3]
    return (ctypes.c_longlong * len(flat))(*flat)


# The K5 entry points' codes above CUDA's errors (csrc/flash_attention.cu).
_ERR_ENCODE, _ERR_NO_ENCODER, _ERR_REGISTERS = 10000, 20000, 20001


def _flash_error(name: str, err: int) -> RuntimeError:
    if err == _ERR_NO_ENCODER:
        return RuntimeError(f"{name}: the CUDA driver has no cuTensorMapEncodeTiled")
    if err == _ERR_REGISTERS:
        return RuntimeError(f"{name}: the kernel was built with fewer registers than it hands out")
    if err >= _ERR_ENCODE:
        return RuntimeError(f"{name}: cuTensorMapEncodeTiled failed: CUresult {err - _ERR_ENCODE}")
    return RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _heads_out(like: torch.Tensor) -> torch.Tensor:
    """An uninitialized (B, H, N, 64) output laid out in memory as
    (B, N, H, 64), so that the caller's ``transpose(1, 2).reshape(B, N, H * 64)``
    is a view."""
    b, h, n, d = like.shape
    return torch.empty((b, n, h, d), dtype=like.dtype, device=like.device).transpose(1, 2)


def _flash_entry(wrapper, dtype: torch.dtype, entry: str):
    """The C entry point ``entry`` of ``dtype``'s kernels, and the wrapper's
    name for errors."""
    source, suffix = _FLASH_KERNELS[dtype]
    return getattr(_lib(source), entry + suffix), wrapper.__name__


def _fwd(wrapper, q, k, v, sm_scale):
    _check_heads("q", q)
    b, h, n, _ = q.shape
    _check_heads("k", k, (b, h, n, _FLASH_HD), q.dtype)
    _check_heads("v", v, (b, h, n, _FLASH_HD), q.dtype)
    o = _heads_out(q)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return o, lse
    strides = _map_strides({"q": q, "k": k, "v": v}, o)
    fn, name = _flash_entry(wrapper, q.dtype, "dynhor_flash_fwd")
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            b, h, n, sm_scale, strides, torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err:
        raise _flash_error(name, err)
    wrapper.launches += 1
    return o, lse


def flash_fwd(q, k, v, sm_scale: float):
    """K5 forward on the card: see ops/flash_attention.flash_fwd_plain.
    Returns (o (B, H, N, 64) in q's dtype stored as (B, N, H, 64), lse
    (B, H, N) f32).  f32 inputs go to ``flash_fwd_f32``."""
    _check_heads("q", q)
    if q.dtype == torch.float32:
        return flash_fwd_f32(q, k, v, sm_scale)
    return _fwd(flash_fwd, q, k, v, sm_scale)


def flash_fwd_f32(q, k, v, sm_scale: float):
    """The f32 K5 forward (csrc/flash_attention_f32.cu)."""
    _check_heads("q", q, dtype=torch.float32)
    return _fwd(flash_fwd_f32, q, k, v, sm_scale)


flash_fwd.launches = flash_fwd_f32.launches = 0


def _check_bwd(q, k, v, d_o, lse, delta, dtype):
    _check_heads("q", q, dtype=dtype)
    shape = tuple(q.shape)
    _check_heads("k", k, shape, dtype)
    _check_heads("v", v, shape, dtype)
    _check_heads("d_o", d_o, shape, dtype)
    _check("lse", lse, torch.float32, shape[:3])
    _check("delta", delta, torch.float32, shape[:3])
    return shape[:3]


def _delta(wrapper, dtype, o, d_o):
    _check_heads("o", o, dtype=dtype)
    b, h, n, _ = o.shape
    _check_heads("d_o", d_o, tuple(o.shape), dtype)
    delta = torch.empty((b, h, n), dtype=torch.float32, device=o.device)
    if o.numel() == 0:
        return delta
    tma_layout(o, "o")  # the kernels read 16-byte pieces of rows, as TMA does
    tma_layout(d_o, "d_o")
    fn, name = _flash_entry(wrapper, dtype, "dynhor_flash_delta")
    with torch.cuda.device(o.device):
        err = fn(
            o.data_ptr(), d_o.data_ptr(), delta.data_ptr(), b, h, n, _strides(o, d_o),
            torch.cuda.current_stream(o.device).cuda_stream,
        )
    if err:
        raise _flash_error(name, err)
    wrapper.launches += 1
    return delta


def flash_bwd_delta(o, d_o):
    """K5 backward, delta = rowsum(dO * O): (B, H, N) f32.  f32 inputs go to
    ``flash_bwd_delta_f32``."""
    _check_heads("o", o)
    if o.dtype == torch.float32:
        return flash_bwd_delta_f32(o, d_o)
    return _delta(flash_bwd_delta, torch.bfloat16, o, d_o)


def flash_bwd_delta_f32(o, d_o):
    """The f32 K5 delta (csrc/flash_attention_f32.cu)."""
    return _delta(flash_bwd_delta_f32, torch.float32, o, d_o)


flash_bwd_delta.launches = flash_bwd_delta_f32.launches = 0


def _dkv(wrapper, dtype, q, k, v, d_o, lse, delta, sm_scale):
    b, h, n = _check_bwd(q, k, v, d_o, lse, delta, dtype)
    dk, dv = _heads_out(k), _heads_out(v)
    if q.numel() == 0:
        return dk, dv
    strides = _map_strides({"q": q, "k": k, "v": v, "d_o": d_o}, dk, dv)
    fn, name = _flash_entry(wrapper, dtype, "dynhor_flash_bwd_dkv")
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), d_o.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, n, sm_scale, strides,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err:
        raise _flash_error(name, err)
    wrapper.launches += 1
    return dk, dv


def flash_bwd_dkv(q, k, v, d_o, lse, delta, sm_scale: float):
    """K5 backward on the card, (dk, dv): see
    ops/flash_attention.flash_bwd_plain.  f32 inputs go to
    ``flash_bwd_dkv_f32``."""
    _check_heads("q", q)
    if q.dtype == torch.float32:
        return flash_bwd_dkv_f32(q, k, v, d_o, lse, delta, sm_scale)
    return _dkv(flash_bwd_dkv, torch.bfloat16, q, k, v, d_o, lse, delta, sm_scale)


def flash_bwd_dkv_f32(q, k, v, d_o, lse, delta, sm_scale: float):
    """The f32 K5 dK/dV pass (csrc/flash_attention_f32.cu)."""
    return _dkv(flash_bwd_dkv_f32, torch.float32, q, k, v, d_o, lse, delta, sm_scale)


flash_bwd_dkv.launches = flash_bwd_dkv_f32.launches = 0


def _dq(wrapper, dtype, q, k, v, d_o, lse, delta, sm_scale):
    b, h, n = _check_bwd(q, k, v, d_o, lse, delta, dtype)
    dq = _heads_out(q)
    if q.numel() == 0:
        return dq
    strides = _map_strides({"q": q, "k": k, "v": v, "d_o": d_o}, dq)
    fn, name = _flash_entry(wrapper, dtype, "dynhor_flash_bwd_dq")
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), d_o.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), b, h, n, sm_scale, strides,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err:
        raise _flash_error(name, err)
    wrapper.launches += 1
    return dq


def flash_bwd_dq(q, k, v, d_o, lse, delta, sm_scale: float):
    """K5 backward on the card, dq: see ops/flash_attention.flash_bwd_plain.
    f32 inputs go to ``flash_bwd_dq_f32``."""
    _check_heads("q", q)
    if q.dtype == torch.float32:
        return flash_bwd_dq_f32(q, k, v, d_o, lse, delta, sm_scale)
    return _dq(flash_bwd_dq, torch.bfloat16, q, k, v, d_o, lse, delta, sm_scale)


def flash_bwd_dq_f32(q, k, v, d_o, lse, delta, sm_scale: float):
    """The f32 K5 dQ pass (csrc/flash_attention_f32.cu)."""
    return _dq(flash_bwd_dq_f32, torch.float32, q, k, v, d_o, lse, delta, sm_scale)


flash_bwd_dq.launches = flash_bwd_dq_f32.launches = 0


# --------------------------------------------------------------------------
# K6: the probe's gathers and scatter-add (csrc/gather_probe.cu), f32 values
# and int32 indices.  Indices must lie in range; they are not checked, so
# that no device sync enters the wrappers.  The wrappers are the probe's
# timed calls, so they keep their host work small: the C entry bound once,
# the stream read raw, the device switched in C only when the tensor is not
# on the current one, and the kernel form (axis, index form, vector width)
# chosen in C.
# --------------------------------------------------------------------------

_I32_MAX = 2**31 - 1
_F32, _I32 = torch.float32, torch.int32
# The scatter-add's paths (csrc/gather_probe.cu): "columns" when g has at
# most SCATTER_COLUMN_N rows and the table at most SCATTER_COLUMN_ROWS rows
# (a warp per column, its column in shared memory, terms in row order);
# "atomic" otherwise (one f32 atomicAdd per element).
SCATTER_COLUMN_N = 2048
SCATTER_COLUMN_ROWS = 4096
_k6: dict[str, object] = {}  # the bound C entries


def _k6_entry(name: str):
    fn = _k6.get(name)
    if fn is None:
        fn = _k6[name] = getattr(_lib("gather_probe"), name)
    return fn


def _check_index(idx: torch.Tensor, device: torch.device) -> tuple[int, int]:
    """An (N, L) int32 view on ``device`` (any strides: torch's are never
    negative; 0 is an expanded index); returns (N, L)."""
    if idx.dtype is not _I32 or idx.dim() != 2 or idx.device != device:
        raise ValueError(
            f"idx must be a 2-D torch.int32 tensor on {device}, got {idx.dtype} "
            f"{tuple(idx.shape)} on {idx.device}"
        )
    n, l = idx.shape
    if n > _I32_MAX or l > _I32_MAX:
        raise ValueError(f"idx {tuple(idx.shape)}: each side must be below 2^31")
    return n, l


def take_along_axis(src: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """K6 gather on the card: see ops/gather.take_along_axis_plain.
    src (R, C) f32 with any strides; idx (N, L) int32, any strides.
    Returns a contiguous (N, L) f32 tensor."""
    if src.dtype is not _F32 or src.dim() != 2 or not src.is_cuda:
        raise ValueError(
            f"src must be a 2-D float32 CUDA tensor, got {src.dtype} "
            f"{tuple(src.shape)} on {src.device}"
        )
    if axis != 0 and axis != 1:
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    dev = src.device
    n, l = _check_index(idx, dev)
    if (l if axis == 0 else n) > src.shape[1 - axis]:
        raise ValueError(
            f"idx {tuple(idx.shape)} does not fit src {tuple(src.shape)} along axis {1 - axis}"
        )
    out = torch.empty((n, l), dtype=_F32, device=dev)
    if n == 0 or l == 0:
        return out
    s0, s1 = src.stride()
    i0, i1 = idx.stride()
    d = dev.index
    err = _k6_entry("dynhor_take_along_axis")(
        src.data_ptr(), idx.data_ptr(), out.data_ptr(), n, l, s0, s1, i0, i1, axis, d,
        torch._C._cuda_getCurrentRawStream(d),
    )
    if err:
        raise RuntimeError(f"take_along_axis kernel launch failed: CUDA error {err}")
    take_along_axis.launches += 1
    return out


take_along_axis.launches = 0


def scatter_plan(n: int, n_rows: int) -> int:
    """The scatter-add's path for g with n rows into a table of n_rows rows:
    0 "columns", 1 "atomic"."""
    return 0 if n <= SCATTER_COLUMN_N and n_rows <= SCATTER_COLUMN_ROWS else 1


def scatter_add_axis0(g: torch.Tensor, idx: torch.Tensor, n_rows: int) -> torch.Tensor:
    """K6 scatter-add on the card: see ops/gather.scatter_add_axis0_plain.
    g (N, L) f32 contiguous, N * L < 2^31; idx (N, L) int32, any strides.
    Returns (n_rows, L) f32 with dst[idx[i, l], l] += g[i, l]: on the
    "columns" path each entry summed in row order (the CPU plain version's
    bits), on the "atomic" path in an order that changes from run to run."""
    if not g.is_cuda:
        raise ValueError(f"g must be a CUDA tensor, got device {g.device}")
    dev = g.device
    n, l = _check_index(idx, dev)
    _check("g", g, _F32, (n, l))
    if n * l > _I32_MAX or not 0 <= n_rows * l <= _I32_MAX:
        raise ValueError(f"g {tuple(g.shape)} and the table ({n_rows}, {l}) must hold < 2^31 values")
    if n == 0 or n_rows == 0 or l == 0:
        return torch.zeros((n_rows, l), dtype=_F32, device=dev)
    path = scatter_plan(n, n_rows)
    dst = (torch.empty if path == 0 else torch.zeros)((n_rows, l), dtype=_F32, device=dev)
    i0, i1 = idx.stride()
    d = dev.index
    err = _k6_entry("dynhor_scatter_add_axis0")(
        g.data_ptr(), idx.data_ptr(), dst.data_ptr(), n, l, n_rows, i0, i1, path, d,
        torch._C._cuda_getCurrentRawStream(d),
    )
    if err:
        raise RuntimeError(f"scatter_add_axis0 kernel launch failed: CUDA error {err}")
    scatter_add_axis0.launches += 1
    return dst


scatter_add_axis0.launches = 0
