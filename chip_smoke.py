#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; any failure exits non-zero.

1. Device and build: the card's name and power limit (nvidia-smi), the
   kernel build (nvcc for sm_90a) and ptxas's register / shared-memory
   report.
2. Kernel parity at the main path's shapes: the shoes mesh, 8 frames, a
   256² crop and caps counted as ``bench.py`` counts them.  Each kernel is
   held against its plain PyTorch version on the same inputs and both are
   timed with CUDA events; the whole fused raster (forward and d(verts))
   is also held against the plain versions on the CPU.  The tile counts'
   distribution and the work items they make (K1/K2 run on a work list cut
   by the counts) are printed.  Then K1 and K2 on rows with adversarial
   counts (one row at the cap and the rest empty, counts at the work list's
   chunk edges, none, equal depths in two chunks of one row, 64 frames x 80
   rows): hard outputs exactly the plain version's, two runs bit-identical.
2b. K3 (the prior views' depth raster) against its plain version at the
   prior path's shapes: a chunk of 25 views at window 176 and a prescreen
   chunk of 50 views at window 112, caps counted for them.
2c. K5 (flash attention: forward, delta, dK/dV, dQ) against its plain
   versions in bf16 at the fine step's shape (8, 12, 1370, 64) and the
   prescreen's (50, 12, 65, 64), and at token counts across the kernels'
   tile edges (1, 63, 64, 65, 127, 128, 129, 1370 at B 2, H 3), on strided
   views as the ViT block makes them; two backward runs must agree bit for
   bit.  ``scaled_dot_product_attention``, forward and backward, is timed
   beside them (the port never calls it).  A "K5 bwd" row holds the whole
   backward (its three kernels) against the function's bound; each kernel
   prints its share of its bound.  The same in f32 (the f32 kernels, within
   1e-5; bounds at the f32 peak), at the fine step's shape and the tile
   edges.
2d. K4 (the separate soft silhouette) at the fine step's shapes: K4a and
   K4b (K2's kernel on K4a's rows) against their plain versions, timed
   beside their bounds; ``soft_silhouette_kernel`` forward and d(verts)
   against the CPU's plain path and against ``soft_silhouette_tiled`` on
   the card, which computes the same function.
2e. K6: the gather probe's forms A-H (``tools/probe_gather``), each kernel
   against its plain version, with kernel, plain and library times.
3. The fine refine: ``refine_poses`` in fine mode, random-weight ViT-B/14
   at 518², bf16, 8 frames, 10 steps, once with the written-out attention
   (``attn_impl="xla"``: no K5 launch) and once with ``attn_impl="flash"``
   (each K5 kernel once per layer and step); K1 and K2 must launch exactly
   once per step.  Then ``dino_dtype="float32"`` with ``"flash"`` for 2
   steps: the f32 K5 kernels once per layer and step, the bf16 ones never.
   Then the same entry point on a small scene, on the card and on the CPU
   (plain versions), must agree, for both attentions and for f32 "flash".
3b. Joint optimization at full width: ``joint_optimize`` at the pipeline's
   defaults (200 steps, lr 1e-4, smoothness weight 10, sigma 0.25) on the
   phase-2 scene from jittered inits, ``silhouette_impl="pallas"``: K1 and
   K2 once per step, no overflow, a falling loss, ms/step and peak memory.
   Then a small scene on the card and on the CPU for "pallas", "tiled" and
   "dense".
3c. The fine-step profiler (``tools/profile_fine_step.run``, 5 calls per
   piece): its lines, and K4a and K4b launched by its "OLD separate" piece.
4. The prior path at full width, chained as the tracking pipeline chains
   it, once for each attention: 8 rendered frames, their DINO features,
   6,000 prior views scored in two stages (K3 once per view chunk; with
   ``attn_impl="flash"`` K5's forward once per layer and ViT call, with
   ``"xla"`` no K5 launch), temporal gating, the translation init by
   autodepth, and a 2-step fine refine from those inits.  A chunk of each
   stage is then timed and profiled alone.
4b. The prior path on a small scene, card against CPU, for both attentions
   and for f32 "flash".
5. Every kernel of the ``kernels`` line launched on its path: K1-K3 and K5
   in phases 3 and 4 (the f32 K5 in phase 3's f32 run), K4a and K4b in 3c,
   K6 in 2e.

Prints a ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device":
{...}}``.  Without a CUDA device it exits 1 and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

CROP = 256
FRAMES = 8
STEPS = 10  # bench.py:29
REFINE_STEPS_FULL = 100
TILE = 16
SIGMA = 0.25
SHOES = "assets/shoes/1229a2e6e97e_A_basketball_shoes_.obj"
# Published peaks of one H100 SXM at 700 W (NVIDIA data sheet): f32 outside
# the tensor cores (an FMA counts as 2), and HBM3.  Both kernels work in f32.
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# Floating-point operations per (pixel, slot) pair that the function needs,
# counted from csrc/raster_fused.cu: an FMA as 2; add, sub, mul, div,
# min/max, compare, select, sqrt, exp, log1p each as 1.  Terms of the face
# alone (area, its guards, edge vectors, segment denominators, visibility)
# are left out: they could be computed once per slot.  Shared geometry 71
# (three barycentrics 3 x 6, inside test 5, sign 1, three point-segment
# distances 3 x 15, their min 2); K1 adds 19 (logit 4, softplus and its sum
# 6, depth 5, depth test 4); K2 adds 29 (logit 4, dfac 4, sigmoid 3,
# coefficient 3, segment choice 2, endpoint sums 13).
# K3 does 23 per pair of a visible face (barycentrics 18, inside test 5)
# and K3_OPS_INSIDE = 9 more where the pixel lies inside it (depth 5, depth
# test 4); the kernel skips the rest.  K4a computes K1's mass without the
# depth (81), K4b the same backward as K2 (100).
OPS_PER_PAIR = {"K1": 90, "K2": 100, "K3": 23, "K4a": 81, "K4b": 100}
K3_OPS_INSIDE = 9
PEAK_BF16 = 989e12  # tensor cores, dense
PRIOR_VIEWS = 6000  # io/config.py prior.num_views
JOINT_STEPS = 200  # io/config.py system.joint_num_iterations
CPU_FRAMES = 2  # frames of phase 2d's card-vs-CPU check


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean device time of fn() over reps launches, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


K5_KEYS = ("K5 fwd", "K5 delta", "K5 dkv", "K5 dq")
# The K5 kernels of each dtype the ViT computes in: their launch-count keys.
K5_DTYPE_KEYS = {"bfloat16": K5_KEYS, "float32": tuple(k + " f32" for k in K5_KEYS)}


def _counted(kernels) -> dict:
    """Every kernel wrapper that keeps a launch count, by its key."""
    return {
        "K1": kernels.fused_fwd, "K2": kernels.sil_bwd, "K3": kernels.depth_fwd,
        "K5 fwd": kernels.flash_fwd, "K5 delta": kernels.flash_bwd_delta,
        "K5 dkv": kernels.flash_bwd_dkv, "K5 dq": kernels.flash_bwd_dq,
        "K5 fwd f32": kernels.flash_fwd_f32, "K5 delta f32": kernels.flash_bwd_delta_f32,
        "K5 dkv f32": kernels.flash_bwd_dkv_f32, "K5 dq f32": kernels.flash_bwd_dq_f32,
        "K4a": kernels.sil_mass_fwd, "K4b": kernels.sil_mass_bwd,
        "K6 take_along_axis": kernels.take_along_axis,
        "K6 scatter_add_axis0": kernels.scatter_add_axis0,
    }


def check_k5_launches(launches: dict, fwd: int, bwd: int, where: str,
                      dtype: str = "bfloat16") -> None:
    """fwd and bwd launches of each K5 kernel of ``dtype``, none of the
    other dtype's."""
    want = {}
    for name, keys in K5_DTYPE_KEYS.items():
        f, b = (fwd, bwd) if name == dtype else (0, 0)
        want.update({keys[0]: f, keys[1]: b, keys[2]: b, keys[3]: b})
    got = {k: launches[k] for k in want}
    check(got == want, f"{where}: K5 launches {got}, expected {want}")


def reset_launches() -> None:
    from dynhor_tpu_torch import kernels

    for fn in _counted(kernels).values():
        fn.launches = 0


def read_launches() -> dict:
    from dynhor_tpu_torch import kernels

    return {key: fn.launches for key, fn in _counted(kernels).items()}


def host_us(fn, reps: int = 100) -> float:
    """Host time per call of fn() to enqueue its work (no synchronization
    inside the loop), in microseconds, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def wall(fn):
    """(result, seconds) of fn() between two device synchronizations."""
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0


def counted_refine_caps(vp, faces):
    """(per-tile face cap, active-tile cap or None) of a fine refine at the
    CROP² crop, counted on projected vertices vp as the pipeline counts
    them (_counted_refine_cap: margin 6 sigma + 1, headroom 1.5)."""
    from dynhor_tpu_torch.ops.rasterize_tiled import max_active_tiles_load, max_tile_load

    margin = 6.0 * SIGMA + 1.0
    worst = int(max_tile_load(vp, faces, (CROP, CROP), margin=margin).max())
    n_act = int(max_active_tiles_load(vp, faces, (CROP, CROP), margin=margin).max())
    cap = max(256, min(-(-int(worst * 1.5) // 128) * 128, int(faces.shape[0])))
    t_total = (-(-CROP // TILE)) ** 2
    act = max(8, min(-(-int(n_act * 1.5) // 8) * 8, t_total))
    return cap, (act if act < t_total else None)


def scene(device):
    """The bench.py scene: mesh, rotations from a numpy seed, targets
    rendered by the dense raster, random unit gt features, counted caps."""
    from dynhor_tpu_torch.ops import rasterize as RZ
    from dynhor_tpu_torch.tracker import refine as RF
    from dynhor_tpu_torch.utils import geometry as G
    from dynhor_tpu_torch.utils.objio import load_obj

    md = load_obj(SHOES)
    verts = G.center_and_normalize_verts(torch.as_tensor(md.verts, device=device))
    mesh = RF.MeshArrays(
        verts, torch.as_tensor(md.faces, device=device).long(),
        torch.as_tensor(md.face_uvs, device=device),
        torch.as_tensor(md.texture, device=device),
    )
    rng = np.random.default_rng(0)
    rot = G.rotations_from_uniforms(
        torch.as_tensor(rng.random((3, FRAMES), dtype=np.float32), device=device)
    )
    trans = torch.tensor([[0.0, 0.0, 1.75]], device=device).repeat(FRAMES, 1)
    K = torch.tensor(
        [[CROP * 1.2, 0, CROP / 2], [0, CROP * 1.2, CROP / 2], [0, 0, 1.0]],
        device=device,
    )
    vp = RZ.project_perspective(verts @ rot + trans[:, None], K)
    masks = (RZ.rasterize(vp, mesh.faces, (CROP, CROP), face_chunk=64).pix_to_face >= 0).float()
    cap, act_cap = counted_refine_caps(vp, mesh.faces)
    return mesh, rot, trans, K, vp, masks, cap, act_cap


def phase_build() -> str:
    from dynhor_tpu_torch import kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.time()
    log = kernels.build()
    print(f"[build] nvcc sm_90a, {len(kernels.SOURCES)} sources at once: "
          f"{time.time() - t0:.1f} s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            print(f"[build] {line.strip()}", flush=True)
    return smi


def kernel_row(name, source, replaces, err, ms, plain_ms, ops, nbytes, peak=PEAK_FLOPS,
               library_ms=None) -> dict:
    """One row of the ``kernels`` line; its launches are filled in by the
    phase that drives the kernel's path."""
    t_ops, t_bytes = ops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
    }


def phase_kernels(dev, sc, card: str) -> list[dict]:
    from dynhor_tpu_torch import kernels
    from dynhor_tpu_torch.ops import raster_fused as RFU

    mesh, _, _, _, vp, _, cap, act_cap = sc
    rows, counts, tw = RFU.kernel_inputs(
        vp, mesh.faces, (CROP, CROP), SIGMA, TILE, cap, max_active_tiles=act_cap
    )
    pairs = int(counts.sum())
    b, t_rows, m, _ = rows.shape
    print(
        f"[kernels] rows {tuple(rows.shape)} (frames, tile rows, cap {cap}, 16); "
        f"active-tile cap {act_cap}; sum(counts) = {pairs} face-tile pairs "
        f"({pairs * TILE * TILE} pixel-slot pairs); {count_line(counts)}",
        flush=True,
    )
    args = (TILE, tw, SIGMA)

    # K1 against its plain version.
    mass, zmin, jbest = kernels.fused_fwd(rows, counts, *args, 1e-2)
    mass_p, zmin_p, jbest_p = RFU.tile_mass_depth_plain(rows, counts, *args, 1e-2)
    torch.cuda.synchronize()
    sil_err = float((torch.exp(-mass) - torch.exp(-mass_p)).abs().max())
    mass_err = float(((mass - mass_p).abs() / mass_p.abs().clamp_min(1.0)).max())
    hit = zmin_p < 1.5e38
    check(bool((hit == (zmin < 1.5e38)).all()), "K1 hit masks differ")
    z_err = float((zmin - zmin_p)[hit].abs().max()) if bool(hit.any()) else 0.0
    mism = hit & (jbest != jbest_p)
    n_mism = int(mism.sum())
    print(
        f"[kernels] K1 vs plain: sil max abs err {sil_err:.3g}, mass max rel err "
        f"{mass_err:.3g}, zbuf max abs err {z_err:.3g} over {int(hit.sum())} hit "
        f"pixels, pix_to_face mismatches {n_mism}", flush=True,
    )
    check(sil_err <= 1e-5, f"K1 silhouette error {sil_err} > 1e-5")
    check(mass_err <= 1e-4, f"K1 mass relative error {mass_err} > 1e-4")
    check(z_err <= 1e-5, f"K1 zbuf error {z_err} > 1e-5")
    check(n_mism == 0, f"K1 pix_to_face differs at {n_mism} pixels")
    k1_ms = cuda_ms(lambda: kernels.fused_fwd(rows, counts, *args, 1e-2))
    k1_host = host_us(lambda: kernels.fused_fwd(rows, counts, *args, 1e-2))
    k1_plain_ms = cuda_ms(lambda: RFU.tile_mass_depth_plain(rows, counts, *args, 1e-2), reps=3)

    # K2 against its plain version, on a fixed random cotangent.
    gen = torch.Generator(device="cpu").manual_seed(1)
    g = torch.randn((b, t_rows, TILE * TILE), generator=gen).to(dev)
    dxy = kernels.sil_bwd(rows, counts, g, *args)
    dxy_p = RFU.tile_mass_grad_plain(rows, counts, g, *args)
    torch.cuda.synchronize()
    scale = float(dxy_p.abs().max())
    k2_err = float((dxy - dxy_p).abs().max())
    k2_ok = bool(((dxy - dxy_p).abs() <= 1e-5 * scale + 1e-4 * dxy_p.abs()).all())
    print(f"[kernels] K2 vs plain: d(xy) max abs err {k2_err:.3g} (max |d(xy)| {scale:.3g})", flush=True)
    check(k2_ok, "K2 d(xy) outside rtol 1e-4, atol 1e-5 x max")
    k2_ms = cuda_ms(lambda: kernels.sil_bwd(rows, counts, g, *args))
    k2_host = host_us(lambda: kernels.sil_bwd(rows, counts, g, *args))
    k2_plain_ms = cuda_ms(lambda: RFU.tile_mass_grad_plain(rows, counts, g, *args), reps=3)

    # The whole fused raster, kernels on the card vs plain versions on the
    # CPU: silhouette, pix_to_face, zbuf and d(verts) of sum(sil * w).
    w = torch.randn((FRAMES, CROP, CROP), generator=gen)

    def raster(v):
        v = v.clone().requires_grad_(True)
        frag, sil, ov = RFU.rasterize_silhouette(
            v, mesh.faces.to(v.device), (CROP, CROP), SIGMA, TILE, cap,
            max_active_tiles=act_cap,
        )
        (sil * w.to(v.device)).sum().backward()
        return frag, sil.detach(), ov, v.grad

    frag_k, sil_k, ov_k, gv_k = raster(vp)
    frag_c, sil_c, ov_c, gv_c = raster(vp.cpu())
    check(int(ov_k.max()) == 0 and int(ov_c.max()) == 0, "raster overflow at counted caps")
    s_err = float((sil_k.cpu() - sil_c).abs().max())
    p2f_same = float((frag_k.pix_to_face.cpu() == frag_c.pix_to_face).float().mean())
    zb_err = float((frag_k.zbuf.cpu() - frag_c.zbuf).abs().max())
    gscale = float(gv_c.abs().max())
    gv_err = float((gv_k.cpu() - gv_c).abs().max())
    gv_ok = bool(((gv_k.cpu() - gv_c).abs() <= 1e-5 * gscale + 1e-4 * gv_c.abs()).all())
    print(
        f"[kernels] fused raster, card vs CPU plain: sil max abs err {s_err:.3g}, "
        f"pix_to_face agreement {p2f_same:.6f}, zbuf max abs err {zb_err:.3g}, "
        f"d(verts) max abs err {gv_err:.3g} (max |d(verts)| {gscale:.3g})", flush=True,
    )
    check(s_err <= 1e-5 and zb_err <= 1e-5, "fused raster forward differs from the CPU")
    check(p2f_same == 1.0, "fused raster pix_to_face differs from the CPU")
    check(gv_ok, "d(verts) outside rtol 1e-4, atol 1e-5 x max")

    n_pix = pairs * TILE * TILE
    out_bytes_k1 = b * t_rows * TILE * TILE * 12
    in_bytes = pairs * 64 + b * t_rows * 4
    rows_out = []
    for key, name, ms, host, plain_ms, err, nbytes, replaces in (
        ("K1", "K1 tile_mass_depth", k1_ms, k1_host, k1_plain_ms, max(sil_err, z_err),
         in_bytes + out_bytes_k1, "dynhor_tpu/ops/raster_pallas.py:243 _fused_fwd_kernel"),
        ("K2", "K2 tile_mass_grad", k2_ms, k2_host, k2_plain_ms, k2_err,
         in_bytes + b * t_rows * TILE * TILE * 4 + b * t_rows * m * 24,
         "dynhor_tpu/ops/raster_pallas.py:262 _sil_bwd_kernel"),
    ):
        ops = n_pix * OPS_PER_PAIR[key]
        row = kernel_row(name, "dynhor_tpu_torch/csrc/raster_fused.cu", replaces, err, ms,
                         plain_ms, ops, nbytes)
        rows_out.append(row)
        print(
            f"[kernels] {name}: {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
            f"{row['bound_ms']:.5f} ms ({ops:.3e} ops at {PEAK_FLOPS:.3g}/s, "
            f"{nbytes} bytes); the host enqueues a call in {host:.1f} us — {card}",
            flush=True,
        )
    return rows_out


def count_line(counts) -> str:
    """The tile counts' distribution and the work items K1/K4a and K2/K4b
    make of them: sum over rows of ceil(count / chunk)."""
    from dynhor_tpu_torch import kernels

    busy = counts[counts > 0].float()
    mean = float(busy.mean()) if busy.numel() else 0.0
    top = int(counts.max()) if counts.numel() else 0
    items = {s: int(((counts.long() + s - 1) // s).sum())
             for s in (kernels.MASS_CHUNK, kernels.GRAD_CHUNK)}
    return (
        f"tile counts: max {top}, mean over the {busy.numel()} non-empty of {counts.numel()} "
        f"rows {mean:.1f} (max / mean {top / max(mean, 1e-9):.2f}); work items: K1/K4a "
        f"{items[kernels.MASS_CHUNK]} of {kernels.MASS_CHUNK} slots, K2/K4b "
        f"{items[kernels.GRAD_CHUNK]} of {kernels.GRAD_CHUNK}"
    )


def crafted_rows(dev, b, t, m, counts, seed, tie=None):
    """Tile rows of random faces around each row's tile (16 px, a grid 16
    tiles wide), laid out as ops/raster_fused._pack_tile_rows lays them out:
    vis 1 for most faces below the count, 0 past it.  ``tie`` = (row,
    slots): the first slot's face, covering the tile in front of every
    other, is copied to the other slots, so their depths tie exactly and
    the first slot must win."""
    rng = np.random.default_rng(seed)
    rec = np.zeros((b, t, m, 16), np.float32)
    rid = np.arange(t)
    origin = np.stack([(rid % 16) * 16, (rid // 16) * 16], -1)[None, :, None, None, :]
    corner = rng.uniform(-4.0, 20.0, (b, t, m, 1, 2))
    tri = (corner + rng.uniform(-7.0, 7.0, (b, t, m, 3, 2)) + origin).astype(np.float32)
    rec[..., 0:6] = tri.reshape(b, t, m, 6)
    rec[..., 6] = rng.random((b, t, m)) > 0.1
    rec[..., 8:11] = rng.uniform(0.5, 3.0, (b, t, m, 3))
    counts = np.asarray(counts, np.int32)
    rec[np.arange(m)[None, None, :] >= counts[..., None], 6] = 0.0
    if tie is not None:
        (fb, ft), slots = tie
        ox, oy = origin[0, ft, 0, 0]
        rec[fb, ft, slots[0], 0:6] = [ox - 20, oy - 20, ox + 60, oy - 20, ox - 20, oy + 60]
        rec[fb, ft, slots[0], 6] = 1.0
        rec[fb, ft, slots[0], 8:11] = 0.1
        rec[fb, ft, slots[1:]] = rec[fb, ft, slots[0]]
    return torch.as_tensor(rec).to(dev), torch.as_tensor(counts).to(dev)


def phase_adversarial_counts(dev, card: str) -> None:
    """K1 and K2 against their plain versions on rows whose counts the work
    list finds hardest; hard outputs exactly equal, mass within 1e-4
    relative, d(xy) within rtol 1e-4 and atol 1e-5 x max, and two runs
    bit-identical.  These launches are not the main path's."""
    from dynhor_tpu_torch import kernels
    from dynhor_tpu_torch.ops import raster_fused as RFU

    rng = np.random.default_rng(17)
    s1, s2 = kernels.MASS_CHUNK, kernels.GRAD_CHUNK
    full = np.zeros((FRAMES, 80), np.int32)
    full[3, 17] = 1408
    edges = rng.integers(0, 200, (FRAMES, 80)).astype(np.int32)
    at_edges = [c + d for c in (s2, s1, 128) for d in (-1, 0, 1)] + [640]
    edges.reshape(-1)[: len(at_edges)] = at_edges
    edges[0, 20] = 199
    wide = np.minimum(rng.pareto(1.5, (64, 80)) * 40, 256).astype(np.int32)
    cases = {
        "one row at the cap 1408, the rest 0": (1408, full, ((3, 17), [5, 5 + s1, 700, 1407])),
        f"counts at {at_edges}": (640, edges, ((0, 20), [3, s1 + 3, 131])),
        "all zero": (256, np.zeros((FRAMES, 80), np.int32), None),
        "64 frames x 80 rows": (256, wide, None),
    }
    args = (TILE, 16, SIGMA)
    for name, (m, c, tie) in cases.items():
        b, t = c.shape
        rows, counts = crafted_rows(dev, b, t, m, c, 23, tie)
        g = torch.randn((b, t, TILE * TILE), generator=torch.Generator().manual_seed(2)).to(dev)
        chunk = 32 if b * t > 1000 else 128  # the plain version's memory knob
        mass_p, zmin_p, jbest_p = RFU.tile_mass_depth_plain(rows, counts, *args, 1e-2, chunk=chunk)
        dxy_p = RFU.tile_mass_grad_plain(rows, counts, g, *args, chunk=chunk)
        runs = [(*kernels.fused_fwd(rows, counts, *args, 1e-2),
                 kernels.sil_bwd(rows, counts, g, *args)) for _ in range(2)]
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(*runs)),
              f"K1/K2 differ between two runs on the same inputs ({name})")
        mass, zmin, jbest, dxy = runs[0]
        check(torch.equal(zmin, zmin_p) and torch.equal(jbest, jbest_p),
              f"K1 zbuf or pix_to_face differ from the plain version ({name})")
        mass_err = float(((mass - mass_p).abs() / mass_p.abs().clamp_min(1.0)).max())
        check(mass_err <= 1e-4, f"K1 mass relative error {mass_err} > 1e-4 ({name})")
        scale = float(dxy_p.abs().max())
        check(bool(((dxy - dxy_p).abs() <= 1e-5 * scale + 1e-4 * dxy_p.abs()).all()),
              f"K2 d(xy) outside rtol 1e-4, atol 1e-5 x max ({name})")
        if tie is not None:
            (fb, ft), slots = tie
            won = jbest[fb, ft]
            check(int((won == slots[0]).sum()) > 0 and not bool(
                torch.isin(won, torch.tensor(slots[1:], device=dev)).any()),
                f"equal depths in two chunks: the first slot did not win ({name})")
        ms = (cuda_ms(lambda: kernels.fused_fwd(rows, counts, *args, 1e-2)),
              cuda_ms(lambda: kernels.sil_bwd(rows, counts, g, *args)))
        print(
            f"[adversarial] {name}: rows {tuple(rows.shape)}; {count_line(counts)}; hard outputs "
            f"equal, two runs bit-identical, mass max rel err {mass_err:.3g}, d(xy) max abs err "
            f"{float((dxy - dxy_p).abs().max()):.3g} (max {scale:.3g})"
            + (f", slot {tie[1][0]} wins the tie over {tie[1][1:]}" if tie else "")
            + f"; K1 {ms[0]:.4f} ms, K2 {ms[1]:.4f} ms — {card}", flush=True,
        )


def block_views(b, h, n, d, seed, dev, dtype=torch.bfloat16):
    """q, k, v and a cotangent as models/dino._block hands them to the
    attention: strided (B, H, N, d) views of one (B, N, 3, H, d) projection
    and of a (B, N, H * d) gradient, in ``dtype``, from a seed."""
    gen = torch.Generator().manual_seed(seed)
    qkv = torch.randn((b, n, 3, h, d), generator=gen).to(dev, dtype)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    g = torch.randn((b, n, h * d), generator=gen).to(dev, dtype)
    return q, k, v, g.reshape(b, n, h, d).transpose(1, 2)


# Token counts that cross the K5 kernels' tile edges (64 query rows a dK/dV
# step, 128 rows or keys a forward and dQ block or step), and the fine step's.
K5_EDGE_N = (1, 63, 64, 65, 127, 128, 129, 1370)


def k5_parity(q, k, v, g, scale, where: str):
    """Each K5 kernel against its plain version on the same inputs; fails
    beyond the tolerances of ``phase_flash_kernels`` (those of q's dtype).
    Returns the plain results and the errors as {name: (max abs err,
    max |ref|)}."""
    from dynhor_tpu_torch import kernels
    from dynhor_tpu_torch.ops import flash_attention as FA

    o_p, lse_p = FA.flash_fwd_plain(q, k, v, scale)
    delta_p = FA.flash_delta_plain(o_p, g)
    dq_p, dk_p, dv_p = FA.flash_bwd_plain(q, k, v, g, lse_p, delta_p, scale)
    # The backward kernels get the plain forward's o and log-sum-exp, so
    # each kernel is held against its plain version on the same inputs.
    o, lse = kernels.flash_fwd(q, k, v, scale)
    delta = kernels.flash_bwd_delta(o_p, g)
    dk, dv = kernels.flash_bwd_dkv(q, k, v, g, lse_p, delta_p, scale)
    dq = kernels.flash_bwd_dq(q, k, v, g, lse_p, delta_p, scale)
    torch.cuda.synchronize()
    check(o.transpose(1, 2).is_contiguous(), "K5 forward must write o as (B, N, H, d)")
    # No atomics: a second backward gives the same bits.
    again = (*kernels.flash_bwd_dkv(q, k, v, g, lse_p, delta_p, scale),
             kernels.flash_bwd_dq(q, k, v, g, lse_p, delta_p, scale))
    check(all(torch.equal(a, b) for a, b in zip((dk, dv, dq), again)),
          f"K5 backward differs between two runs on the same inputs at {where}")

    def rel(a, ref):
        a, ref = a.float(), ref.float()
        check(bool(torch.isfinite(a).all()), f"K5 output not finite at {where}")
        return float((a - ref).abs().max()), float(ref.abs().max())

    errs = {
        "o": rel(o, o_p), "lse": rel(lse, lse_p), "delta": rel(delta, delta_p),
        "dq": rel(dq, dq_p), "dk": rel(dk, dk_p), "dv": rel(dv, dv_p),
    }
    for name, (e, m) in errs.items():
        if q.shape[2] == 1 and name in ("dq", "dk"):
            # One key: P = 1, so dS = dP - delta and with it dq and dk are 0
            # in exact arithmetic; both sides return only the f32 rounding of
            # that difference, held to 1e-5 of zero.
            check(e <= 1e-5 and m <= 1e-5, f"K5 {name} at {where}: {e}, {m} not 0 within 1e-5")
            continue
        tol = 1e-5 if name in ("lse", "delta") or q.dtype == torch.float32 else 2.0**-7
        check(e <= tol * m, f"K5 {name}: error {e} > {tol} x max |ref| {m} at {where}")
    return (o_p, lse_p, delta_p), errs


def phase_flash_kernels(dev, card: str, dtype: torch.dtype = torch.bfloat16) -> list[dict]:
    """Each K5 kernel of ``dtype`` against its plain version on the card, at
    the fine step's shape (bf16: and at the prescreen's), and at token counts
    across the tile edges (``K5_EDGE_N``, B 2, H 3); two backward runs must
    agree bit for bit.  Returns the rows of the fine step's shape.

    Tolerances, relative to the largest magnitude of the compared tensor.
    bf16: 2^-7 for o, dq, dk, dv (the kernel and the plain version round P
    and dS to bf16 and accumulate in f32 alike, but sum in another order and
    take exp2 where the other takes exp, so a value near a rounding boundary
    may land one bf16 step apart: 2^-8 relative, 2^-7 at a binade's lower
    edge); 1e-5 for the f32 log-sum-exp and delta.  f32: 1e-5 for all (f32
    sums in another order).  Bounds: bf16 products at the tensor cores'
    peak, f32 ones (and delta) at the f32 peak."""
    from dynhor_tpu_torch import kernels
    from dynhor_tpu_torch.ops import flash_attention as FA

    f32 = dtype == torch.float32
    tname = "f32" if f32 else "bf16"
    sfx = " f32" if f32 else ""
    for n in K5_EDGE_N:
        q, k, v, g = block_views(2, 3, n, 64, 100 + n, dev, dtype)
        _, errs = k5_parity(q, k, v, g, 0.125, f"(2, 3, {n}, 64) {tname}")
        print(f"[k5] {tname} tile edge N={n} (B=2, H=3): within tolerance, backward bit-identical "
              "over two runs; max abs err (max |ref|) "
              + ", ".join(f"{name} {e:.3g} ({m:.3g})" for name, (e, m) in errs.items()),
              flush=True)
    rows_out = None
    shapes = ((FRAMES, 12, 1370, 64, 41),) + (() if f32 else ((50, 12, 65, 64, 42),))
    for b, h, n, d, seed in shapes:
        q, k, v, g = block_views(b, h, n, d, seed, dev, dtype)
        check(not q.is_contiguous() and not g.is_contiguous(), "K5 inputs must be strided views")
        scale = 1.0 / d**0.5
        (o_p, lse_p, delta_p), errs = k5_parity(q, k, v, g, scale, f"({b}, {h}, {n}, {d}) {tname}")
        print(
            f"[k5] (B={b}, H={h}, N={n}, d={d}) {tname}, kernel vs plain, max abs err (max |ref|): "
            + ", ".join(f"{name} {e:.3g} ({m:.3g})" for name, (e, m) in errs.items()), flush=True,
        )

        ms = {
            "K5 fwd": cuda_ms(lambda: kernels.flash_fwd(q, k, v, scale)),
            "K5 delta": cuda_ms(lambda: kernels.flash_bwd_delta(o_p, g)),
            "K5 dkv": cuda_ms(lambda: kernels.flash_bwd_dkv(q, k, v, g, lse_p, delta_p, scale)),
            "K5 dq": cuda_ms(lambda: kernels.flash_bwd_dq(q, k, v, g, lse_p, delta_p, scale)),
        }
        plain_fwd = cuda_ms(lambda: FA.flash_fwd_plain(q, k, v, scale), reps=3)
        plain_delta = cuda_ms(lambda: FA.flash_delta_plain(o_p, g), reps=3)
        # The plain backward computes dq, dk and dv in one loop: its time
        # stands beside both backward kernels.
        plain_bwd = cuda_ms(
            lambda: FA.flash_bwd_plain(q, k, v, g, lse_p, delta_p, scale), reps=3
        )
        plain = {"K5 fwd": plain_fwd, "K5 delta": plain_delta, "K5 dkv": plain_bwd,
                 "K5 dq": plain_bwd}

        # The library call, timed here and used nowhere in the port.
        ql, kl, vl = (x.detach().contiguous().requires_grad_(True) for x in (q, k, v))
        gl = g.contiguous()
        sdpa = torch.nn.functional.scaled_dot_product_attention
        with torch.no_grad():
            lib_fwd = cuda_ms(lambda: sdpa(ql, kl, vl), 10)
        lib_both = cuda_ms(lambda: sdpa(ql, kl, vl).backward(gl), 10)
        out_l = sdpa(ql, kl, vl)
        lib_bwd = cuda_ms(
            lambda: torch.autograd.grad(out_l, (ql, kl, vl), gl, retain_graph=True), 10
        )

        # Bounds: operations in the inputs' type (a product of an (N, d) by
        # a (d, N) or (N, N) by (N, d) matrix is 2 N^2 d), bytes with each
        # input read once and each output written once.  The
        # backward as a function needs five products (S, dP, dV, dK, dQ) and
        # each of its two passes recomputes S and dP: the rows share the
        # function's five without counting any twice, S with dK and dV on the
        # dK/dV pass, dP with dQ on the dQ pass; the "K5 bwd" row carries the
        # whole backward (delta, then both passes) against the whole bound
        # and the library's backward.
        prod = 2 * b * h * n * n * d
        tensor = b * h * n * d * q.element_size()  # bytes of one (B, H, N, d) tensor
        peak_products = PEAK_FLOPS if f32 else PEAK_BF16
        vec = b * h * n * 4  # bytes of one f32 (B, H, N) tensor
        work = {
            "K5 fwd": (2 * prod, 4 * tensor + vec),  # S, P V; q k v -> o, lse
            "K5 delta": (2 * b * h * n * d, 2 * tensor + vec),
            "K5 dkv": (3 * prod, 6 * tensor + 2 * vec),  # S, dV, dK (dP recomputed)
            "K5 dq": (2 * prod, 5 * tensor + 2 * vec),  # dP, dQ (S recomputed)
            # q, k, v, o, dO -> dq, dk, dv, with the log-sum-exp
            "K5 bwd": (5 * prod, 8 * tensor + vec),
        }
        bwd_keys = ("K5 delta", "K5 dkv", "K5 dq")
        ms["K5 bwd"] = sum(ms[key] for key in bwd_keys)
        plain["K5 bwd"] = plain_delta + plain_bwd
        library = {"K5 fwd": lib_fwd, "K5 bwd": lib_bwd}
        rows = []
        for key in (*K5_KEYS, "K5 bwd"):
            ops, nbytes = work[key]
            peak = PEAK_FLOPS if key == "K5 delta" else peak_products
            t_ops, t_bytes = ops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
            err = {"K5 fwd": errs["o"][0], "K5 delta": errs["delta"][0],
                   "K5 dkv": max(errs["dk"][0], errs["dv"][0]), "K5 dq": errs["dq"][0],
                   "K5 bwd": max(errs[name][0] for name in ("delta", "dq", "dk", "dv"))}[key]
            rows.append(kernel_row(
                key + sfx + " flash_attention",
                f"dynhor_tpu_torch/csrc/flash_attention{'_f32' if f32 else ''}.cu",
                "dynhor_tpu/models/dino.py:202 _flash_attention and "
                "dynhor_tpu/models/dino.py:243 _splash_attention",
                err, ms[key], plain[key], ops, nbytes, peak, library.get(key),
            ))
            bound = max(t_ops, t_bytes)
            lib = library.get(key)
            lib_txt = (f"scaled_dot_product_attention {lib:.4f} ms" if lib is not None
                       else "no single library call")
            print(
                f"[k5] {tname} N={n} {key}{sfx}: {ms[key]:.4f} ms, "
                f"{100 * bound / ms[key]:.1f} % of its bound "
                f"{bound:.5f} ms ({ops:.4e} ops = {t_ops:.5f} ms, {nbytes} bytes = "
                f"{t_bytes:.5f} ms); plain {plain[key]:.3f} ms; {lib_txt} — {card}", flush=True,
            )
        print(
            f"[k5] {tname} N={n} forward {ms['K5 fwd']:.4f} ms (scaled_dot_product_attention "
            f"{lib_fwd:.4f} ms); backward {ms['K5 bwd']:.4f} ms (its backward alone "
            f"{lib_bwd:.4f} ms); forward + backward {ms['K5 fwd'] + ms['K5 bwd']:.4f} ms "
            f"(scaled_dot_product_attention {lib_both:.4f} ms, bound "
            f"{max(7 * prod / peak_products, 12 * tensor / PEAK_BYTES) * 1e3:.5f} ms for the "
            f"function's 14 B H N^2 d operations and 12 tensors of bytes; the two backward "
            f"passes run 7 products where the function needs 5) — {card}",
            flush=True,
        )
        if rows_out is None:
            rows_out = rows
    return rows_out


def phase_silhouette_kernels(dev, sc, card: str) -> list[dict]:
    """K4a and K4b against their plain versions on the rows
    ``soft_silhouette_kernel`` packs for the phase-2 scene (8 frames, 256²,
    the counted cap, all 256 tiles), then the whole function against the
    CPU's plain path and against ``soft_silhouette_tiled`` on the card.

    Tolerances: K4a as K1 (silhouette 1e-5, mass 1e-4 relative), K4b as K2
    (rtol 1e-4, atol 1e-5 x max); the function card vs CPU the same; card
    kernel vs card tiled path as tests/test_rasterize_tiled.py holds the
    Pallas kernel to the tiled path: silhouette 1e-5, d(verts) 99.9 % of
    values within 2e-4 x max and all within 1e-2 x max (the tiled path
    rounds the point-segment products apart where the kernel fuses them,
    so near a corner another segment may win)."""
    from dynhor_tpu_torch import kernels
    from dynhor_tpu_torch.ops import raster_fused as RFU
    from dynhor_tpu_torch.ops import silhouette_kernel as SK
    from dynhor_tpu_torch.ops.rasterize_tiled import soft_silhouette_tiled

    mesh, _, _, _, vp, _, cap, _ = sc
    rows, counts, tw = SK.kernel_inputs(vp, mesh.faces, (CROP, CROP), SIGMA, TILE, cap)
    b, t_rows, m, _ = rows.shape
    pairs = int(counts.sum())
    args = (TILE, tw, SIGMA)
    mass = kernels.sil_mass_fwd(rows, counts, *args)
    mass_p = SK.tile_mass_plain(rows, counts, *args)
    gen = torch.Generator(device="cpu").manual_seed(7)
    g = torch.randn((b, t_rows, TILE * TILE), generator=gen).to(dev)
    dxy = kernels.sil_mass_bwd(rows, counts, g, *args)
    dxy_p = RFU.tile_mass_grad_plain(rows, counts, g, *args)
    torch.cuda.synchronize()
    sil_err = float((torch.exp(-mass) - torch.exp(-mass_p)).abs().max())
    mass_err = float(((mass - mass_p).abs() / mass_p.abs().clamp_min(1.0)).max())
    scale = float(dxy_p.abs().max())
    k4b_err = float((dxy - dxy_p).abs().max())
    k4b_ok = bool(((dxy - dxy_p).abs() <= 1e-5 * scale + 1e-4 * dxy_p.abs()).all())
    print(
        f"[k4] rows {tuple(rows.shape)} (frames, tiles, cap {cap}, 16), sum(counts) {pairs} "
        f"face-tile pairs, max count {int(counts.max())}; K4a vs plain: sil max abs err "
        f"{sil_err:.3g}, mass max rel err {mass_err:.3g}; K4b vs plain: d(xy) max abs err "
        f"{k4b_err:.3g} (max |d(xy)| {scale:.3g})", flush=True,
    )
    check(sil_err <= 1e-5 and mass_err <= 1e-4, "K4a differs from its plain version")
    check(k4b_ok, "K4b d(xy) outside rtol 1e-4, atol 1e-5 x max")
    ms = {"K4a": cuda_ms(lambda: kernels.sil_mass_fwd(rows, counts, *args)),
          "K4b": cuda_ms(lambda: kernels.sil_mass_bwd(rows, counts, g, *args))}
    plain = {"K4a": cuda_ms(lambda: SK.tile_mass_plain(rows, counts, *args), reps=3),
             "K4b": cuda_ms(lambda: RFU.tile_mass_grad_plain(rows, counts, g, *args), reps=3)}
    # Bytes: each slot's 8 floats of geometry and visibility and the counts
    # in; K4a writes the mass, K4b reads the cotangent and writes 6 floats
    # per slot.
    n_pix = pairs * TILE * TILE
    in_bytes = pairs * 32 + b * t_rows * 4
    out = []
    for key, name, err, nbytes, replaces in (
        ("K4a", "K4a tile_masses", max(sil_err, mass_err), in_bytes + b * t_rows * TILE * TILE * 4,
         "dynhor_tpu/ops/silhouette_pallas.py:183 _fwd_kernel"),
        ("K4b", "K4b tile_mass_grads", k4b_err,
         in_bytes + b * t_rows * TILE * TILE * 4 + b * t_rows * m * 24,
         "dynhor_tpu/ops/silhouette_pallas.py:193 _bwd_kernel"),
    ):
        row = kernel_row(name, "dynhor_tpu_torch/csrc/raster_fused.cu", replaces, err, ms[key],
                         plain[key], n_pix * OPS_PER_PAIR[key], nbytes)
        out.append(row)
        print(
            f"[k4] {name}: {ms[key]:.4f} ms, plain {plain[key]:.3f} ms, bound "
            f"{row['bound_ms']:.5f} ms ({n_pix} pixel-slot pairs x {OPS_PER_PAIR[key]} ops, "
            f"{nbytes} bytes) — {card}", flush=True,
        )

    # The whole function: card (K4a/K4b) vs CPU (plain) vs card tiled path.
    w = torch.randn((FRAMES, CROP, CROP), generator=gen)

    def f_and_b(fn, v):
        v = v.detach().clone().requires_grad_(True)
        sil = fn(v, mesh.faces.to(v.device), (CROP, CROP), SIGMA, TILE, cap)
        (sil * w[: len(v)].to(v.device)).sum().backward()
        return sil.detach(), v.grad

    def sil_and_grad(fn, v):
        return tuple(x.cpu() for x in f_and_b(fn, v))

    torch.cuda.reset_peak_memory_stats()
    sil_k, gv_k = sil_and_grad(SK.soft_silhouette_kernel, vp)
    peak_k = torch.cuda.max_memory_allocated()
    # The CPU's plain path on the first CPU_FRAMES frames (each frame's
    # silhouette is independent of the others).
    sil_c, gv_c = sil_and_grad(SK.soft_silhouette_kernel, vp[:CPU_FRAMES].cpu())
    torch.cuda.reset_peak_memory_stats()
    sil_t, gv_t = sil_and_grad(soft_silhouette_tiled, vp)
    peak_t = torch.cuda.max_memory_allocated()
    gscale = float(gv_c.abs().max())
    s_err = float((sil_k[:CPU_FRAMES] - sil_c).abs().max())
    gd = (gv_k[:CPU_FRAMES] - gv_c).abs()
    gv_err, gv_ok = float(gd.max()), bool((gd <= 1e-5 * gscale + 1e-4 * gv_c.abs()).all())
    t_err = float((sil_k - sil_t).abs().max())
    dt = (gv_k - gv_t).abs()
    q999, dt_max = float(torch.quantile(dt.flatten(), 0.999)), float(dt.max())
    f_ms = {
        "kernel": cuda_ms(lambda: f_and_b(SK.soft_silhouette_kernel, vp), reps=5),
        "tiled": cuda_ms(lambda: f_and_b(soft_silhouette_tiled, vp), reps=3),
    }
    print(
        f"[k4] soft_silhouette_kernel, card vs CPU plain ({CPU_FRAMES} frames): sil max abs err {s_err:.3g}, d(verts) "
        f"max abs err {gv_err:.3g} (max |d(verts)| {gscale:.3g}); vs soft_silhouette_tiled on the "
        f"card: sil max abs err {t_err:.3g}, d(verts) 99.9 % quantile {q999:.3g}, max {dt_max:.3g}; "
        f"forward + backward {f_ms['kernel']:.3f} ms (peak {peak_k / 2**30:.2f} GiB) against the "
        f"tiled path's {f_ms['tiled']:.3f} ms (peak {peak_t / 2**30:.2f} GiB) — {card}", flush=True,
    )
    check(s_err <= 1e-5 and gv_ok, "soft_silhouette_kernel differs between the card and the CPU")
    check(t_err <= 1e-5 and q999 <= 2e-4 * gscale and dt_max <= 1e-2 * gscale,
          "soft_silhouette_kernel differs from soft_silhouette_tiled on the card")
    return out


def phase_gather_kernels(dev, card: str) -> list[dict]:
    """K6: every form of the gather probe, kernel against plain version
    (the probe's own checks), and its timed shapes; returns the two rows,
    each timed at the shape of the TPU kernel it replaces (the timed
    gather :210, form H :249), their launches those of this probe run.  The
    probe's lines at the hash backward's shape, where the JAX tool times
    only XLA, are printed and kept out of the rows."""
    from dynhor_tpu_torch.tools import probe_gather as PG

    reset_launches()
    res = PG.run(dev, reps=20, out=lambda line: print(f"[k6] {line}", flush=True))
    launches = read_launches()
    failed = [k for k, ok in res["forms"].items() if not ok]
    check(not failed, f"K6 forms that differ from their plain versions: {failed}")
    timed = res["timed"]
    out = []
    for name, key, err, shape, replaces in (
        ("K6 take_along_axis", "E per-lane gather 2048x128 of 8192x128", res["max_abs_err"]["take"],
         "per-lane gather 2048x128 of 8192x128",
         "tools/probe_pallas_gather.py:43 form A (and the pallas_calls of B :62, C :82, D :102, "
         "E :127, F :147, G :168 and the timed gather :210)"),
        ("K6 scatter_add_axis0", "H scatter-add (512,128) += (256,128)", res["max_abs_err"]["scatter"],
         "form H scatter-add (512, 128) += (256, 128)", "tools/probe_pallas_gather.py:249 form H"),
    ):
        t = timed[key]
        row = kernel_row(name, "dynhor_tpu_torch/csrc/gather_probe.cu", replaces, err, t["ms"],
                         t["plain_ms"], 0, t["bytes"], library_ms=t["library_ms"])
        row["launches"] = launches[name]
        out.append(row)
        print(f"[k6] {name} at the {shape}: {t['ms']:.5f} ms, plain {t['plain_ms']:.5f} ms, library "
              f"{t['library_ms']:.5f} ms, bound {row['bound_ms']:.6f} ms (bytes); launches in the "
              f"probe {launches[name]} — {card}", flush=True)
    return out


def phase_main(dev, sc, card: str, kernel_rows: list[dict], dcfg, dtype: str = "bfloat16",
               steps: int = STEPS) -> dict:
    """The fine refine at full width under dcfg.attn_impl with the ViT in
    ``dtype``, ``steps`` steps; returns its ms/step, peak memory and final
    losses.  The bf16 runs set the launches of the kernel rows other than
    the f32 K5 ones, the f32 run those, and only the bf16 runs are broken
    down by parts."""
    from dynhor_tpu_torch.models import dino as D
    from dynhor_tpu_torch.tracker import refine as RF

    mesh, rot, trans, K, _, masks, cap, act_cap = sc
    dparams = D.map_params(
        D.init_params(dcfg, torch.Generator().manual_seed(0)), lambda a: a.to(dev)
    )
    gen = torch.Generator().manual_seed(1)
    gt = torch.randn((FRAMES, dcfg.feat_size**2, dcfg.embed_dim), generator=gen)
    gt = (gt / torch.linalg.norm(gt, dim=-1, keepdim=True)).to(dev)
    targets = RF.FrameTargets(masks, gt, K.expand(FRAMES, 3, 3))
    cfg = RF.RefineConfig(
        num_iterations=steps, crop_size=CROP, mode="fine",
        max_faces_per_tile=cap, max_active_tiles=act_cap, dino_dtype=dtype,
    )
    f32 = dtype == "float32"
    tag = f"[main {dcfg.attn_impl}{' f32' if f32 else ''}]"
    print(f"{tag} per-tile face cap {cap}, active-tile cap {act_cap} (counted)", flush=True)
    warm = RF.refine_poses(
        mesh, targets, rot, trans, dparams, dcfg,
        dataclasses.replace(cfg, num_iterations=1), device=dev,
    )
    check(bool(torch.isfinite(warm.final_loss).all()), "warm-up loss not finite")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.time()
    res = RF.refine_poses(mesh, targets, rot, trans * 1.0001, dparams, dcfg, cfg, device=dev)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()

    check(res.rot6d.shape == (FRAMES, 3, 2), "rot6d shape")
    check(bool(torch.isfinite(res.final_loss).all()), "final loss not finite")
    check(bool(torch.isfinite(res.rot6d).all() and torch.isfinite(res.translations).all()),
          "poses not finite")
    check(res.max_overflow == 0, f"overflow {res.max_overflow} at counted caps")
    for k in ("K1", "K2"):
        check(launches[k] == steps, f"{k} launched {launches[k]} times in {steps} steps")
    check(launches["K3"] == 0, "the fine refine launched K3")
    # Counted after the warm-up step: under "xla" no K5 launch at all, else
    # each K5 kernel of the ViT's dtype once per layer and step.
    per_kernel = 0 if dcfg.attn_impl == "xla" else dcfg.depth * steps
    check_k5_launches(launches, per_kernel, per_kernel, f"refine_poses {dcfg.attn_impl} {dtype}",
                      dtype)
    ms_step = wall / steps * 1e3
    fps = FRAMES / (wall * (REFINE_STEPS_FULL / steps))
    print(
        f"{tag} refine_poses fine, ViT-B/14 518² {dtype}, {FRAMES} frames, {steps} steps: "
        f"{ms_step:.2f} ms/step, {fps:.4f} frames/s at 100 steps/frame, peak "
        f"{peak / 2**30:.2f} GiB allocated, launches {launches} — {card}", flush=True,
    )
    print(
        f"{tag} final loss {res.final_loss.tolist()}, final IoU {res.final_iou.tolist()}",
        flush=True,
    )
    for row in kernel_rows:
        key = row["name"].rsplit(" ", 1)[0]
        # One whole backward is one launch of each of its three kernels.
        n = launches.get(key.replace("K5 bwd", "K5 delta"), 0)
        if n > 0 and key.endswith(" f32") == f32:
            row["launches"] = n
    if not f32:
        step_breakdown(dev, mesh, targets, rot, trans, dparams, dcfg, cfg, ms_step, card)
    return {"ms_step": ms_step, "peak_gib": peak / 2**30, "loss": res.final_loss.tolist(),
            "rot6d": res.rot6d, "trans": res.translations}


def step_breakdown(dev, mesh, targets, rot, trans, dparams, dcfg, cfg, ms_step, card):
    """Where the fine step's time goes: forward+backward of its three
    parts timed alone with CUDA events, and the device's busy time per step
    from a profiler window (kernel time only; idle share against the
    unprofiled ms/step)."""
    from torch.profiler import ProfilerActivity, profile

    from dynhor_tpu_torch.models import dino as D
    from dynhor_tpu_torch.ops import rasterize as RZ
    from dynhor_tpu_torch.ops.raster_fused import rasterize_silhouette
    from dynhor_tpu_torch.ops.shading import fine_lights, phong_shade, phong_shade_tiles
    from dynhor_tpu_torch.tracker import refine as RF

    v0 = (mesh.verts @ rot + trans[:, None]).detach()
    K = targets.K_rois

    def raster(return_compact=False):
        v = v0.clone().requires_grad_(True)
        out = rasterize_silhouette(
            RZ.project_perspective(v, K), mesh.faces, (CROP, CROP), SIGMA, TILE,
            cfg.max_faces_per_tile, max_active_tiles=cfg.max_active_tiles,
            return_compact=return_compact,
        )
        out[1].sum().backward()
        return out

    frag, _, _, compact = raster(return_compact=True)

    def shade():
        v = v0.clone().requires_grad_(True)
        args = (
            mesh.faces, v, RZ.compute_vertex_normals(v, mesh.faces), mesh.face_uvs,
            mesh.texture, fine_lights(device=dev),
        )
        if compact is None:  # no compaction at this size: the dense shading
            rgba = phong_shade(frag._replace(bary=frag.bary.detach().requires_grad_(True)), *args)
        else:
            bary = compact.bary.detach().requires_grad_(True)
            rgba = phong_shade_tiles(compact._replace(bary=bary), (CROP, CROP), TILE, *args)
        rgba.sum().backward()

    params = D.map_params(dparams, lambda a: a.to(torch.bfloat16))
    rgb = torch.rand((FRAMES, 3, CROP, CROP), generator=torch.Generator().manual_seed(3)).to(dev)

    def vit():
        x = rgb.clone().requires_grad_(True)
        D.forward_tokens_from_crop(params, x, dcfg).float().sum().backward()

    parts = {"ViT f+b": cuda_ms(vit, 5), "raster f+b": cuda_ms(raster, 5),
             "shading f+b": cuda_ms(shade, 5)}
    rest = ms_step - sum(parts.values())
    tag = f"[breakdown {dcfg.attn_impl}]"
    print(
        f"{tag} " + ", ".join(f"{k} {v:.2f} ms" for k, v in parts.items())
        + f", rest of the step {rest:.2f} ms, of {ms_step:.2f} ms/step — {card}",
        flush=True,
    )
    steps = 3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        RF.refine_poses(
            mesh, targets, rot, trans, dparams, dcfg,
            dataclasses.replace(cfg, num_iterations=steps), device=dev,
        )
    kernels_ = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
    ]
    busy = sum(e.self_device_time_total for e in kernels_) / steps / 1e3
    if busy == 0.0:
        print(f"{tag} device busy time: not measured (the profiler saw no kernels)")
        return
    groups = {"matmul": 0.0, "K1+K2": 0.0, "K5": 0.0, "other kernels": 0.0}
    for e in kernels_:
        name = e.key.lower()
        if "flash_" in name and "_kernel" in name:
            key = "K5"
        elif any(k in name for k in ("gemm", "xmma", "cutlass", "nvjet")):
            key = "matmul"
        elif any(k in name for k in ("mass_fwd_kernel", "mass_merge_kernel", "chunk_prefix_kernel",
                                     "sil_bwd_kernel")):
            key = "K1+K2"  # with their work list's pre-pass and K1's merge pass
        else:
            key = "other kernels"
        groups[key] += e.self_device_time_total / steps / 1e3
    print(
        f"{tag} device busy {busy:.2f} ms/step (profiler, kernels only): "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in groups.items())
        + f"; idle share {max(0.0, 1.0 - busy / ms_step):.3f} of the unprofiled "
        f"{ms_step:.2f} ms/step — {card}", flush=True,
    )
    for e in sorted(kernels_, key=lambda e: -e.self_device_time_total)[:8]:
        print(
            f"{tag}   {e.self_device_time_total / steps / 1e3:8.3f} ms/step "
            f"{e.count // steps:5d} launches/step  {e.key[:90]}", flush=True,
        )


def small_vit(attn_impl: str, dtype: str = "bfloat16"):
    """The small scenes' ViT: (config, parameters, dtype name, width).  With
    the written-out attention a tiny f32 one (head dim 16).  K5 takes head
    dim 64 only, so the flash variant is two heads of 64, in ``dtype``, with
    the attention's layer scale raised from the random init's 1e-5 to 1 so
    that what K5 computes reaches the tokens."""
    from dynhor_tpu_torch.models import dino as D

    width = 32 if attn_impl == "xla" else 128
    dcfg = D.DinoConfig(patch_size=8, embed_dim=width, depth=2, num_heads=2, pos_grid=4,
                        smaller_edge_size=32, attn_impl=attn_impl)
    params = D.init_params(dcfg, torch.Generator().manual_seed(3))
    if attn_impl != "xla":
        params["blocks"]["ls1"] = torch.ones_like(params["blocks"]["ls1"])
    return dcfg, params, "float32" if attn_impl == "xla" else dtype, width


def phase_small_reference(dev, attn_impl: str = "xla", dtype: str = "bfloat16") -> None:
    """refine_poses on a small scene: the card (kernels) against the CPU
    (plain versions), over 3 steps.  With the written-out attention, and
    with "flash" in f32 (the f32 K5 kernels), the ViT is f32 without TF32
    and the trajectories agree within 1e-4.  With bf16 "flash" the ViT is
    bf16 on both sides.  Both accumulate bf16 products
    in f32, so most values round to the same bf16 number and the run that
    set these limits differed by 4e-6; a value that lands on the other side
    of a rounding boundary moves by 2^-8 of itself, so the limit is 1e-3 for
    the poses and the loss (a tenth of an Adam step at lr 0.01) and 1e-2 for
    the IoU of the hard mask."""
    from dynhor_tpu_torch.ops import rasterize as RZ
    from dynhor_tpu_torch.tracker import refine as RF
    from dynhor_tpu_torch.utils import geometry as G

    s = 64
    v = torch.tensor(
        [[-0.3, -0.2, -0.1], [0.3, -0.2, -0.1], [0.3, 0.2, -0.1], [-0.3, 0.2, -0.1],
         [-0.3, -0.2, 0.1], [0.3, -0.2, 0.1], [0.3, 0.2, 0.1], [-0.3, 0.2, 0.1]]
    )
    f = torch.tensor(
        [[0, 1, 2], [0, 2, 3], [4, 6, 5], [4, 7, 6], [0, 4, 5], [0, 5, 1],
         [3, 2, 6], [3, 6, 7], [1, 5, 6], [1, 6, 2], [0, 3, 7], [0, 7, 4]]
    )
    texture = torch.rand((4, 4, 3), generator=torch.Generator().manual_seed(2))
    mesh = RF.MeshArrays(v, f, torch.full((12, 3, 2), 0.5), texture)
    R = G.rotations_from_uniforms(torch.tensor([[0.1, 0.7], [0.4, 0.2], [0.8, 0.5]]))
    t = torch.tensor([[0.0, 0.0, 2.0], [0.05, -0.03, 2.1]])
    K = torch.tensor([[float(s), 0, s / 2], [0, float(s), s / 2], [0, 0, 1.0]])
    vp = RZ.project_perspective(v @ R + t[:, None], K)
    masks = (RZ.rasterize(vp, f, (s, s), face_chunk=12).pix_to_face >= 0).float()
    dcfg, params, dtype, width = small_vit(attn_impl, dtype)
    gt = torch.randn((2, 16, width), generator=torch.Generator().manual_seed(4))
    targets = RF.FrameTargets(masks, gt, K.expand(2, 3, 3))
    cfg = RF.RefineConfig(num_iterations=3, crop_size=s, mode="fine", dino_dtype=dtype,
                          max_active_tiles=8)
    noise = 0.05 * torch.randn((2, 3, 2), generator=torch.Generator().manual_seed(5))
    R0 = G.rot6d_to_matrix(G.matrix_to_rot6d(R) + noise)
    reset_launches()
    r_dev = RF.refine_poses(mesh, targets, R0, t + 0.03, params, dcfg, cfg, device=dev)
    per_kernel = 0 if attn_impl == "xla" else dcfg.depth * 3
    check_k5_launches(read_launches(), per_kernel, per_kernel, f"small refine {attn_impl}", dtype)
    r_cpu = RF.refine_poses(mesh, targets, R0, t + 0.03, params, dcfg, cfg, device="cpu")
    errs = {
        k: float((a.cpu() - b).abs().max())
        for k, a, b in zip(("rot6d", "trans", "loss", "iou"), r_dev[:4], r_cpu[:4])
    }
    print(f"[small {attn_impl}] refine_poses 3 steps, {dtype} ViT, card vs CPU max abs err: "
          f"{errs}", flush=True)
    if dtype == "float32":
        tols = dict.fromkeys(errs, 1e-4)
    else:
        tols = {"rot6d": 1e-3, "trans": 1e-3, "loss": 1e-3, "iou": 1e-2}
    check(all(errs[k] <= tols[k] for k in errs),
          f"card and CPU trajectories differ by more than {tols}")


def phase_joint(dev, sc, card: str) -> dict:
    """joint_optimize at full width: the phase-2 scene's 8 frames at 256²,
    its counted caps, the pipeline's defaults, from inits jittered off the
    scene's poses by a numpy seed, ``silhouette_impl="pallas"``."""
    from dynhor_tpu_torch.tracker import jointopt as TJ
    from dynhor_tpu_torch.utils import geometry as G

    mesh, rot, trans, K, _, masks, cap, act_cap = sc
    rng = np.random.default_rng(6)
    r6 = G.matrix_to_rot6d(rot)
    R0 = G.rot6d_to_matrix(r6 + torch.as_tensor(0.05 * rng.standard_normal(r6.shape),
                                                dtype=torch.float32, device=dev))
    t0 = trans + torch.as_tensor(0.02 * rng.standard_normal((FRAMES, 3)), dtype=torch.float32,
                                 device=dev)
    cfg = TJ.JointConfig(
        num_iterations=JOINT_STEPS, lr=1e-4, lw_sil_obj=1.0, lw_smooth_obj=10.0, crop_size=CROP,
        sigma=SIGMA, max_faces_per_tile=cap, max_active_tiles=act_cap, silhouette_impl="pallas",
    )
    args = (mesh.verts, mesh.faces, R0, t0, K.expand(FRAMES, 3, 3), masks)
    TJ.joint_optimize(*args, dataclasses.replace(cfg, num_iterations=2), device=dev)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res, sec = wall(lambda: TJ.joint_optimize(*args, cfg, device=dev))
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    h = {k: v.numpy() for k, v in res.history.items()}
    check(set(h) == set(TJ.HISTORY_KEYS), f"history keys {sorted(h)}")
    check(all(len(v) == JOINT_STEPS and np.isfinite(v).all() for v in h.values()),
          "joint history not finite or of the wrong length")
    check(launches["K1"] == JOINT_STEPS and launches["K2"] == JOINT_STEPS,
          f"joint opt launched K1 {launches['K1']} and K2 {launches['K2']} times in {JOINT_STEPS} steps")
    check(float(h["bin_overflow"].max()) == 0.0, "joint opt overflowed its counted caps")
    check(float(h["loss"][-1]) < float(h["loss"][0]), "joint opt loss did not fall")
    check(float(res.scale) == 1.0, "the frozen scale moved")
    ms_step = sec / JOINT_STEPS * 1e3
    print(
        f"[joint] joint_optimize \"pallas\", {FRAMES} frames at {CROP}², caps {cap}/{act_cap}, "
        f"{JOINT_STEPS} steps in chunks of 50: {ms_step:.3f} ms/step ({sec:.3f} s), peak "
        f"{peak / 2**30:.2f} GiB allocated; loss {h['loss'][0]:.6g} -> {h['loss'][-1]:.6g}, "
        f"IoU {h['iou_object'][0]:.4f} -> {h['iou_object'][-1]:.4f}; launches K1 "
        f"{launches['K1']}, K2 {launches['K2']} — {card}", flush=True,
    )
    return {"ms_step": ms_step, "peak_gib": peak / 2**30}


def phase_joint_small(dev) -> None:
    """joint_optimize on a small scene (the box mesh at 64², 3 frames, 6
    steps in chunks of 4), on the card and on the CPU, for each silhouette
    implementation; poses and every history value agree within 1e-4 (f32
    on both sides: K1/K2 round as their plain versions, the plain paths sum
    in another order)."""
    from dynhor_tpu_torch.ops import rasterize as RZ
    from dynhor_tpu_torch.tracker import jointopt as TJ
    from dynhor_tpu_torch.utils import geometry as G

    s = 64
    v = torch.tensor(
        [[-0.3, -0.2, -0.1], [0.3, -0.2, -0.1], [0.3, 0.2, -0.1], [-0.3, 0.2, -0.1],
         [-0.3, -0.2, 0.1], [0.3, -0.2, 0.1], [0.3, 0.2, 0.1], [-0.3, 0.2, 0.1]]
    )
    f = torch.tensor(
        [[0, 1, 2], [0, 2, 3], [4, 6, 5], [4, 7, 6], [0, 4, 5], [0, 5, 1],
         [3, 2, 6], [3, 6, 7], [1, 5, 6], [1, 6, 2], [0, 3, 7], [0, 7, 4]]
    )
    R = uniform_rotations(3, 8, "cpu")
    t = torch.tensor([[0.0, 0.0, 2.0], [0.03, -0.02, 2.05], [0.05, -0.03, 2.1]])
    K = torch.tensor([[float(s), 0, s / 2], [0, float(s), s / 2], [0, 0, 1.0]]).expand(3, 3, 3)
    masks = (RZ.rasterize(RZ.project_perspective(v @ R + t[:, None], K), f, (s, s),
                          face_chunk=12).pix_to_face >= 0).float()
    noise = torch.as_tensor(0.05 * np.random.default_rng(9).standard_normal((3, 3, 2)),
                            dtype=torch.float32)
    R0 = G.rot6d_to_matrix(G.matrix_to_rot6d(R) + noise)
    for impl in ("pallas", "tiled", "dense"):
        cfg = TJ.JointConfig(num_iterations=6, lr=1e-3, crop_size=s, face_chunk=12,
                             silhouette_impl=impl)
        reset_launches()
        r_dev = TJ.joint_optimize(v, f, R0, t + 0.02, K, masks, cfg, iters_per_launch=4, device=dev)
        launches = read_launches()
        r_cpu = TJ.joint_optimize(v, f, R0, t + 0.02, K, masks, cfg, iters_per_launch=4, device="cpu")
        errs = {"rot6d": float((r_dev.rot6d.cpu() - r_cpu.rot6d).abs().max()),
                "trans": float((r_dev.translations.cpu() - r_cpu.translations).abs().max())}
        errs.update({k: float((r_dev.history[k] - r_cpu.history[k]).abs().max())
                     for k in TJ.HISTORY_KEYS})
        print(f"[joint-small {impl}] 6 steps, card vs CPU max abs err: {errs}; launches K1 "
              f"{launches['K1']}, K2 {launches['K2']}", flush=True)
        want = 6 if impl == "pallas" else 0
        check(launches["K1"] == want and launches["K2"] == want,
              f"joint opt {impl} launched K1/K2 {launches['K1']}/{launches['K2']} times")
        check(all(e <= 1e-4 for e in errs.values()),
              f"joint opt {impl}: card and CPU differ by more than 1e-4: {errs}")


def phase_profiler(dev, sc, card: str, kernel_rows: list[dict]) -> None:
    """The fine-step profiler at full width, 5 calls per piece after 3
    warm-ups; K4a and K4b must launch in its "OLD separate" piece, and
    their rows take the launches of this run.  Their times stay those of
    phase 2d, on the phase-2 scene's rows: the profiler's scene (its own
    seed, camera and counted cap) is another load."""
    from dynhor_tpu_torch.tools import profile_fine_step as PF

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res, sec = wall(lambda: PF.run(dev, n=5, out=lambda line: print(f"[profile] {line}", flush=True)))
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    old = res["old_separate_launches"]
    print(f"[profile] {sec:.1f} s, peak {peak / 2**30:.2f} GiB allocated; launches in the OLD "
          f"separate piece {old}, in the whole run {launches} (the K4a/K4b rows take these "
          f"launches at the profiler's cap {res['caps'][0]} and keep phase 2d's times at cap "
          f"{sc[6]}) — {card}", flush=True)
    check(old["K4a"] > 0 and old["K4b"] > 0, f"the OLD separate piece launched {old}")
    check(launches["K4a"] == old["K4a"] and launches["K4b"] == old["K4b"],
          "K4 launched outside the OLD separate piece")
    for row in kernel_rows:
        key = row["name"].split(" ", 1)[0]
        if key in ("K4a", "K4b"):
            row["launches"] = launches[key]


def prior_mesh(device):
    """The shoes mesh normalized as the tracking pipeline's ``load_mesh``
    normalizes it (numpy: centroid at 0, max vertex norm 0.5)."""
    from dynhor_tpu_torch.utils.objio import load_obj

    md = load_obj(SHOES)
    verts = np.asarray(md.verts, np.float32)
    verts = verts - verts.mean(axis=0, keepdims=True)
    verts = (verts / np.linalg.norm(verts, axis=1).max() * 0.5).astype(np.float32)
    return (
        torch.as_tensor(verts, device=device),
        torch.as_tensor(md.faces, device=device).long(),
        torch.as_tensor(md.face_uvs, device=device),
        torch.as_tensor(md.texture, device=device),
    )


def uniform_rotations(n: int, seed: int, device):
    from dynhor_tpu_torch.utils import geometry as G

    x = np.random.default_rng(seed).random((3, n), dtype=np.float32)
    return G.rotations_from_uniforms(torch.as_tensor(x, device=device))


def depth_pair_work(rows, counts, tiles_w) -> tuple[int, int]:
    """(visible, inside) pixel-slot pairs of K3's input: pairs of a pixel
    and a slot below the tile's count whose face is visible, and those of
    them whose face covers the pixel (the plain version's inside test)."""
    from dynhor_tpu_torch.ops import raster_fused as RFU

    b, t_rows, m, _ = rows.shape
    px, py = RFU._tile_pixels(t_rows, TILE, tiles_w, rows.device)
    slot = torch.arange(m, device=rows.device)
    visible = inside = 0
    for s in range(0, int(counts.max()), 128):
        r = rows[:, :, None, s : s + 128]
        live = (slot[s : s + 128] < counts[..., None])[:, :, None, :] & (r[..., 6] > 0.5)
        _, ins, _ = RFU._barycentric(r, px, py)
        visible += int(live.sum()) * TILE * TILE
        inside += int((ins & live).sum())
    return visible, inside


def phase_depth_kernel(dev, card: str) -> dict:
    """K3 against its plain version on one chunk of prior views at each
    stage's shapes; returns the K3 row (full-resolution chunk)."""
    from dynhor_tpu_torch import kernels
    from dynhor_tpu_torch.ops import raster_fused as RFU
    from dynhor_tpu_torch.ops import rasterize as RZ
    from dynhor_tpu_torch.tracker import priors as TP

    verts, faces, _, _ = prior_mesh(dev)
    row = None
    for stage, render, n_views, seed in (("full", 384, 25, 11), ("prescreen", 192, 50, 12)):
        cfg = TP.PriorConfig(render_h=render, render_w=render)
        radius, center = TP.mesh_radius_center(verts)
        dist = cfg.distance_scale * radius
        window = TP.compute_window(cfg, float(TP.mesh_norm_radius(verts)), float(dist))
        R = uniform_rotations(n_views, seed, dev)
        t = TP._view_translations(R, dist, center)
        vp = RZ.project_perspective(
            verts @ R.transpose(1, 2) + t[:, None], TP._window_camera(cfg, window, dev)
        )
        cap = TP.required_prior_cap(verts, faces, R, cfg, window, float(dist), center)
        rows, counts, tw, _, _ = RFU.depth_inputs(vp, faces, (window, window), TILE, cap)
        args = (rows, counts, TILE, tw, 1e-2)
        zmin, jbest = kernels.depth_fwd(*args)
        zmin_p, jbest_p = RFU.tile_depth_plain(*args)
        torch.cuda.synchronize()
        hit = zmin_p < 1.5e38
        same_hit = bool((hit == (zmin < 1.5e38)).all())
        z_err = float((zmin - zmin_p)[hit].abs().max()) if bool(hit.any()) else 0.0
        n_mism = int((hit & (jbest != jbest_p)).sum())
        pairs = int(counts.sum())
        b, t_rows = counts.shape
        ms = cuda_ms(lambda: kernels.depth_fwd(*args))
        plain_ms = cuda_ms(lambda: RFU.tile_depth_plain(*args), reps=3)
        vis_pairs, in_pairs = depth_pair_work(rows, counts, tw)
        ops = vis_pairs * OPS_PER_PAIR["K3"] + in_pairs * K3_OPS_INSIDE
        nbytes = pairs * 64 + b * t_rows * 4 + b * t_rows * TILE * TILE * 8
        t_ops, t_bytes = ops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        print(
            f"[k3] {stage}: {n_views} views, window {window} ({t_rows} tiles), counted cap "
            f"{cap}, rows {tuple(rows.shape)}; sum(counts) {pairs} face-tile pairs, max "
            f"count {int(counts.max())}, mean {pairs / (b * t_rows):.1f} per tile; hit "
            f"masks equal {same_hit}, pix_to_face mismatches {n_mism} over {int(hit.sum())} "
            f"hit pixels, zbuf max abs err {z_err:.3g}", flush=True,
        )
        print(
            f"[k3] {stage}: K3 {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
            f"{max(t_ops, t_bytes):.5f} ms ({vis_pairs} visible pixel-slot pairs x "
            f"{OPS_PER_PAIR['K3']} + {in_pairs} inside x {K3_OPS_INSIDE} = {ops:.4e} ops at "
            f"{PEAK_FLOPS:.3g}/s = {t_ops:.5f} ms; {nbytes} bytes at {PEAK_BYTES:.3g}/s = "
            f"{t_bytes:.5f} ms) — {card}", flush=True,
        )
        check(same_hit, f"K3 hit masks differ ({stage})")
        check(n_mism == 0, f"K3 pix_to_face differs at {n_mism} pixels ({stage})")
        check(z_err <= 1e-5, f"K3 zbuf error {z_err} > 1e-5 ({stage})")
        if row is None:
            row = kernel_row(
                "K3 tile_depth", "dynhor_tpu_torch/csrc/raster_fused.cu",
                "dynhor_tpu/ops/raster_pallas.py:205 _depth_fwd_kernel", z_err, ms, plain_ms, ops,
                nbytes,
            )
    return row


class _Stages:
    """Wraps prior_scores_batched to time each call (a stage of the
    two-stage scoring) between device synchronizations.  It is installed
    as the module's global, so it sees the calls only because
    prior_scores_two_stage looks that name up at call time; phase_priors
    checks that it recorded exactly the two stages."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *args, **kw):
        out, sec = wall(lambda: self.fn(*args, **kw))
        self.calls.append((int(args[6].shape[0]), sec))
        return out


def render_frames(verts, faces, face_uvs, texture, n: int, size: int, seed: int):
    """n frames of the mesh at size², as the targets of phase 3 are made:
    rotations from numpy uniforms at distance 1.75, dense raster, Phong
    shading.  Returns (crop_images, target_masks, K)."""
    from dynhor_tpu_torch.ops import rasterize as RZ
    from dynhor_tpu_torch.ops.shading import default_lights, phong_shade
    from dynhor_tpu_torch.utils import camera as TC

    dev = verts.device
    R = uniform_rotations(n, seed, dev)
    K = TC.intrinsics_from_image(size, size, device=dev)
    vc = verts @ R + torch.tensor([0.0, 0.0, 1.75], device=dev)
    vp = RZ.project_perspective(vc, K)
    frag = RZ.rasterize(vp, faces, (size, size), face_chunk=64)
    rgba = phong_shade(
        frag, faces, vc, RZ.compute_vertex_normals(vc, faces), face_uvs, texture,
        default_lights(dev),
    )
    return rgba[..., :3].permute(0, 3, 1, 2).contiguous(), rgba[..., 3].contiguous(), K


def phase_priors(dev, card: str, kernel_rows: list[dict], dcfg) -> dict:
    """The prior path at full width, chained as the tracking pipeline
    chains it (parallel refine, one initialization)."""
    from dynhor_tpu_torch.models import dino as D
    from dynhor_tpu_torch.ops import rasterize as RZ
    from dynhor_tpu_torch.tracker import priors as TP
    from dynhor_tpu_torch.tracker import refine as RF
    from dynhor_tpu_torch.tracker import selection as TS
    from dynhor_tpu_torch.utils import bbox as TB
    from dynhor_tpu_torch.utils import camera as TC

    verts, faces, face_uvs, texture = prior_mesh(dev)
    times = {}
    (crops, masks, K_full), times["frames"] = wall(
        lambda: render_frames(verts, faces, face_uvs, texture, FRAMES, CROP, 21)
    )
    bbox_xywh = TB.bbox_xy_to_wh(TB.mask_tight_bbox_xyxy(masks, pad=5.0))
    dparams = D.init_params(dcfg, torch.Generator().manual_seed(0))
    (gt_feats, cos_masks), times["frame features"] = wall(
        lambda: TP.frame_gt_features(dparams, dcfg, crops, masks, "bfloat16", dev)
    )
    view_rots, times["view rotations"] = wall(lambda: uniform_rotations(PRIOR_VIEWS, 22, dev))

    cfg = TP.PriorConfig(num_views=PRIOR_VIEWS)
    # The prescreen halves the render and the crop, doubles the chunk and
    # runs the ViT at an edge of 112 (prior_scores_two_stage's defaults).
    cfg_lo = dataclasses.replace(cfg, render_h=192, render_w=192, crop_size=128,
                                 view_chunk=2 * cfg.view_chunk)
    radius, _ = TP.mesh_radius_center(verts)
    norm_r, dist = float(TP.mesh_norm_radius(verts)), float(cfg.distance_scale * radius)
    window = TP.compute_window(cfg, norm_r, dist)
    window_lo = TP.compute_window(cfg_lo, norm_r, dist)
    stages = _Stages(TP.prior_scores_batched)
    printed = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    TP.prior_scores_batched = stages
    try:
        with contextlib.redirect_stdout(printed):
            scores, times["scoring"] = wall(lambda: TP.prior_scores_two_stage(
                dparams, dcfg, verts, faces, face_uvs, texture, view_rots, crops, masks,
                gt_feats, cos_masks, cfg, window, host_batch=1000, prescreen_edge=112,
                prescreen_scale=2, topk=24, device=dev,
            ))
    finally:
        TP.prior_scores_batched = stages.fn
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    for line in printed.getvalue().splitlines():
        print(f"[priors] {line}", flush=True)
    caps = [int(c) for c in re.findall(r"per-tile face cap (\d+)", printed.getvalue())]
    check("overflow" not in printed.getvalue(), "prior rendering overflowed its counted cap")
    check(len(stages.calls) == 2, f"two-stage scoring made {len(stages.calls)} scoring calls")
    (n_lo, t_lo), (n_hi, t_hi) = stages.calls
    chunks = -(-n_lo // cfg_lo.view_chunk) + -(-n_hi // cfg.view_chunk)
    check(launches["K3"] == chunks, f"K3 launched {launches['K3']} times for {chunks} view chunks")
    # One ViT call per view chunk and one for the prescreen's frame features,
    # all under inference mode: K5's forward once per layer and call, no
    # backward.
    vit_calls = chunks + 1
    check_k5_launches(
        launches, 0 if dcfg.attn_impl == "xla" else dcfg.depth * vit_calls, 0,
        f"prior scoring {dcfg.attn_impl}",
    )
    check(tuple(scores.shape) == (FRAMES, PRIOR_VIEWS), f"scores shape {tuple(scores.shape)}")
    check(bool(torch.isfinite(scores).all()), "prior scores not finite")
    print(
        f"[priors] scoring {PRIOR_VIEWS} views: prescreen {n_lo} views at window "
        f"{window_lo} in {t_lo:.3f} s ({n_lo / t_lo:.1f} views/s), rescore {n_hi} views at window "
        f"{window} in {t_hi:.3f} s; counted caps {caps} (prescreen, rescore); K3 launches "
        f"{launches['K3']} = view chunks {chunks}; attn_impl {dcfg.attn_impl}: K5 forward "
        f"launches {launches['K5 fwd']} = depth {dcfg.depth} x {vit_calls} ViT calls; peak "
        f"{peak / 2**30:.2f} GiB allocated — {card}", flush=True,
    )

    def gate_and_init():
        gate = TS.gate_all_frames(scores, view_rots.transpose(-1, -2))
        sq = torch.tensor([0.0, 0.0, CROP, CROP], device=dev).expand(FRAMES, 4)
        K_rois = TC.get_K_crop_resize(K_full.expand(FRAMES, 3, 3), sq, CROP)
        trans = TC.tco_init_from_boxes_autodepth(
            bbox_xywh, verts @ gate.rotation_init, K_full.expand(FRAMES, 3, 3)
        )
        return gate, K_rois, trans

    (gate, K_rois, trans_init), times["gating+autodepth"] = wall(gate_and_init)
    check(bool(torch.isfinite(trans_init).all()), "translation init not finite")
    print(
        f"[priors] selected views {gate.selected_idx.tolist()}, translation z "
        f"{[round(float(z), 4) for z in trans_init[:, 2]]}", flush=True,
    )

    # Caps counted at the init poses.
    vp = RZ.project_perspective(verts @ gate.rotation_init + trans_init[:, None], K_rois)
    cap, act_cap = counted_refine_caps(vp, faces)
    rcfg = RF.RefineConfig(
        num_iterations=2, crop_size=CROP, mode="fine", max_faces_per_tile=cap,
        max_active_tiles=act_cap,
    )
    reset_launches()
    res, times["refine 2 steps"] = wall(lambda: RF.refine_poses(
        RF.MeshArrays(verts, faces, face_uvs, texture),
        RF.FrameTargets(masks, gt_feats, K_rois), gate.rotation_init, trans_init,
        dparams, dcfg, rcfg, device=dev,
    ))
    rl = read_launches()
    check(bool(torch.isfinite(res.final_loss).all()), "chained refine losses not finite")
    check(rl["K1"] == 2 and rl["K2"] == 2, f"chained refine launches {rl}")
    per_kernel = 0 if dcfg.attn_impl == "xla" else dcfg.depth * 2
    check_k5_launches(rl, per_kernel, per_kernel, "chained refine")
    print(
        f"[priors] chained refine: caps {cap}/{rcfg.max_active_tiles}, final loss "
        f"{res.final_loss.tolist()}, IoU {res.final_iou.tolist()}", flush=True,
    )
    print(
        "[priors] wall time per step (s): "
        + ", ".join(f"{k} {v:.3f}" for k, v in times.items()) + f" — {card}", flush=True,
    )
    for row in kernel_rows:
        if row["name"].startswith("K3"):
            row["launches"] = launches["K3"]
    print(f"[priors] launches in the scoring {launches}, in the chained refine {rl}", flush=True)
    prior_breakdown(
        dev, card, dparams, dcfg, (verts, faces, face_uvs, texture), view_rots, crops,
        masks, gt_feats, cos_masks, dataclasses.replace(cfg_lo, max_faces_per_tile=caps[0]),
        window_lo, dataclasses.replace(cfg, max_faces_per_tile=caps[1]), window,
    )
    return {"scoring": times["scoring"], "prescreen": t_lo, "rescore": t_hi,
            "peak_gib": peak / 2**30, "selected": gate.selected_idx.tolist()}


def prior_breakdown(dev, card, dparams, dcfg, mesh, view_rots, crops, masks, gt_feats,
                    cos_masks, cfg_lo, window_lo, cfg, window) -> None:
    """Where a scoring chunk's time goes, for each stage: wall ms per chunk
    unprofiled, then a profiler window's kernel time grouped by kind."""
    from torch.profiler import ProfilerActivity, profile

    from dynhor_tpu_torch.tracker import priors as TP

    dcfg_lo = dataclasses.replace(dcfg, smaller_edge_size=112)
    gt_lo, cm_lo = TP.frame_gt_features(dparams, dcfg_lo, crops, masks, "bfloat16", dev)
    params = TP._place_params(dparams, "bfloat16", dev)
    for stage, c, dc, win, gt, cm, n in (
        ("prescreen", cfg_lo, dcfg_lo, window_lo, gt_lo, cm_lo, 250),
        ("rescore", cfg, dcfg, window, gt_feats, cos_masks, 50),
    ):
        def run():
            return TP.prior_scores_and_rotations(
                params, dc, *mesh, view_rots[:n], gt, cm, c, win
            )

        run()
        _, sec = wall(run)
        chunks = n // c.view_chunk
        per_chunk = sec / chunks * 1e3
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        evs = [
            e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
        ]
        busy = sum(e.self_device_time_total for e in evs) / chunks / 1e3
        if busy == 0.0:
            print(f"[priors-breakdown] {stage}: device busy time not measured", flush=True)
            continue
        groups = {"K3": 0.0, "K5": 0.0, "sort/top-k": 0.0, "matmul": 0.0, "gather/copy": 0.0,
                  "other": 0.0}
        for e in evs:
            name = e.key.lower()
            if "depth_fwd_kernel" in name:
                key = "K3"
            elif "flash_" in name and "_kernel" in name:
                key = "K5"
            elif "sort" in name or "topk" in name or "radix" in name or "select" in name:
                key = "sort/top-k"
            elif any(k in name for k in ("gemm", "xmma", "cutlass", "nvjet")):
                key = "matmul"
            elif any(k in name for k in ("gather", "index", "copy", "cat", "scatter")):
                key = "gather/copy"
            else:
                key = "other"
            groups[key] += e.self_device_time_total / chunks / 1e3
        print(
            f"[priors-breakdown] {stage} attn_impl={dc.attn_impl} ({c.view_chunk} views/chunk, "
            f"window {win}, cap {c.max_faces_per_tile}): {per_chunk:.2f} ms/chunk unprofiled; "
            f"device busy {busy:.2f} ms/chunk: " + ", ".join(f"{k} {v:.2f} ms" for k, v in groups.items())
            + f"; idle share {max(0.0, 1.0 - busy / per_chunk):.3f} — {card}", flush=True,
        )
        for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:6]:
            print(
                f"[priors-breakdown]   {e.self_device_time_total / chunks / 1e3:8.3f} ms/chunk "
                f"{e.count // chunks:5d} launches/chunk  {e.key[:90]}", flush=True,
            )


def phase_priors_small(dev, attn_impl: str = "xla", dtype: str = "bfloat16") -> None:
    """The prior path on a small scene (24 views, crop 64, render 192, 2
    frames, topk 4), on the card and on the CPU.  With an f32 ViT (the
    written-out attention's tiny one, or "flash" in f32 through the f32 K5
    kernels) the scores agree within 1e-5 and the gate selects the same
    views.  With bf16 "flash" (see small_vit) the
    scores, masked means of cosines of bf16 features, agree within 1e-3 (the
    run that set the limit differed by 2e-5), and the selection is printed,
    not required: views whose scores lie closer than that may swap."""
    from dynhor_tpu_torch.tracker import priors as TP
    from dynhor_tpu_torch.tracker import selection as TS

    mesh = prior_mesh("cpu")
    crops, masks, _ = render_frames(*mesh, 2, 64, 31)
    dcfg, params, dtype, _ = small_vit(attn_impl, dtype)
    rots = uniform_rotations(24, 32, "cpu")
    cfg = TP.PriorConfig(num_views=24, view_chunk=8, crop_size=64, render_h=192,
                         render_w=192, dino_dtype=dtype)
    radius, _ = TP.mesh_radius_center(mesh[0])
    window = TP.compute_window(cfg, float(TP.mesh_norm_radius(mesh[0])),
                               float(cfg.distance_scale * radius))
    out = {}
    for where in (dev, "cpu"):
        reset_launches()
        with contextlib.redirect_stdout(io.StringIO()):
            gt, cm = TP.frame_gt_features(params, dcfg, crops, masks, dtype, where)
            scores = TP.prior_scores_two_stage(
                params, dcfg, *mesh, rots, crops, masks, gt, cm, cfg, window,
                prescreen_edge=16, prescreen_scale=2, topk=4, device=where,
            )
        gate = TS.gate_all_frames(scores, rots.transpose(-1, -2).to(scores.device))
        out[str(where)] = (scores.cpu(), gate.selected_idx.cpu())
        if where == dev and attn_impl != "xla":
            k5 = read_launches()[K5_DTYPE_KEYS[dtype][0]]
            check(k5 > 0, f"the small prior path under {attn_impl} {dtype} launched no K5 forward")
    (s_dev, i_dev), (s_cpu, i_cpu) = out[str(dev)], out["cpu"]
    err = float((s_dev - s_cpu).abs().max())
    print(
        f"[priors-small {attn_impl}] two-stage scores, {dtype} ViT, card vs CPU max abs err "
        f"{err:.3g}; selected {i_dev.tolist()} vs {i_cpu.tolist()}", flush=True,
    )
    check(bool(torch.isfinite(s_dev).all()), "small prior scores not finite")
    tol = 1e-5 if dtype == "float32" else 1e-3
    check(err <= tol, f"prior scores differ by {err} > {tol} between card and CPU")
    if dtype == "float32":
        check(torch.equal(i_dev, i_cpu), "gating selected other views on the card")


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device (this script measures the card; it never runs the CPU path)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = phase_build()
    sc = scene(dev)
    kernel_rows = phase_kernels(dev, sc, smi)
    phase_adversarial_counts(dev, smi)
    kernel_rows.append(phase_depth_kernel(dev, smi))
    kernel_rows.extend(phase_flash_kernels(dev, smi))
    kernel_rows.extend(phase_flash_kernels(dev, smi, torch.float32))
    kernel_rows.extend(phase_silhouette_kernels(dev, sc, smi))
    kernel_rows.extend(phase_gather_kernels(dev, smi))
    from dynhor_tpu_torch.models.dino import DinoConfig

    flash = DinoConfig(attn_impl="flash")
    written = phase_main(dev, sc, smi, kernel_rows, DinoConfig())
    fused = phase_main(dev, sc, smi, kernel_rows, flash)
    print(
        f"[main] attn_impl xla vs flash: {written['ms_step']:.2f} vs {fused['ms_step']:.2f} "
        f"ms/step, peak {written['peak_gib']:.2f} vs {fused['peak_gib']:.2f} GiB; final losses "
        f"{written['loss']} vs {fused['loss']}; max abs difference of the final rot6d "
        f"{float((written['rot6d'] - fused['rot6d']).abs().max()):.3g}, of the translations "
        f"{float((written['trans'] - fused['trans']).abs().max()):.3g} — {smi}", flush=True,
    )
    f32 = phase_main(dev, sc, smi, kernel_rows, flash, "float32", steps=2)
    print(
        f"[main] flash, ViT in f32 against bf16: {f32['ms_step']:.2f} vs {fused['ms_step']:.2f} "
        f"ms/step, peak {f32['peak_gib']:.2f} vs {fused['peak_gib']:.2f} GiB — {smi}", flush=True,
    )
    for impl, dtype in (("xla", "float32"), ("flash", "bfloat16"), ("flash", "float32")):
        phase_small_reference(dev, impl, dtype)
    phase_joint(dev, sc, smi)
    phase_joint_small(dev)
    phase_profiler(dev, sc, smi, kernel_rows)
    pw = phase_priors(dev, smi, kernel_rows, DinoConfig())
    pf = phase_priors(dev, smi, kernel_rows, flash)
    print(
        f"[priors] attn_impl xla vs flash, {PRIOR_VIEWS} views: scoring {pw['scoring']:.3f} vs "
        f"{pf['scoring']:.3f} s (prescreen {pw['prescreen']:.3f} vs {pf['prescreen']:.3f} s, "
        f"rescore {pw['rescore']:.3f} vs {pf['rescore']:.3f} s), peak {pw['peak_gib']:.2f} vs "
        f"{pf['peak_gib']:.2f} GiB; selected views {pw['selected']} vs {pf['selected']} — {smi}",
        flush=True,
    )
    for impl, dtype in (("xla", "float32"), ("flash", "bfloat16"), ("flash", "float32")):
        phase_priors_small(dev, impl, dtype)
    missing = [row["name"] for row in kernel_rows if row["launches"] <= 0]
    check(not missing, f"kernels of the path that the main path never launched: {missing}")
    print(json.dumps({"kernels": kernel_rows}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)


if __name__ == "__main__":
    main()
