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
   is also held against the plain versions on the CPU.
2b. K3 (the prior views' depth raster) against its plain version at the
   prior path's shapes: a chunk of 25 views at window 176 and a prescreen
   chunk of 50 views at window 112, caps counted for them.
3. The fine refine: ``refine_poses`` in fine mode, random-weight ViT-B/14
   at 518², bf16, 8 frames, 10 steps; the kernels' launch counts must grow
   by exactly one per step each.  Then the same entry point on a small
   scene, on the card and on the CPU (plain versions), must agree.
4. The prior path at full width, chained as the tracking pipeline chains
   it: 8 rendered frames, their DINO features, 6,000 prior views scored in
   two stages (K3 once per view chunk), temporal gating, the translation
   init by autodepth, and a 2-step fine refine from those inits.
4b. The prior path on a small scene, card against CPU.
5. Yardsticks: the bounds of the TPU kernels not yet ported, and one
   PyTorch attention call timed beside K5's bound.

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
# test 4); the kernel skips the rest.  The unported K4a computes K1's mass
# without the depth (81), K4b the same backward as K2 (100).
OPS_PER_PAIR = {"K1": 90, "K2": 100, "K3": 23, "K4a": 81, "K4b": 100}
K3_OPS_INSIDE = 9
PEAK_BF16 = 989e12  # tensor cores, dense
PRIOR_VIEWS = 6000  # io/config.py prior.num_views


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


def reset_launches() -> None:
    from dynhor_tpu_torch import kernels

    for fn in (kernels.fused_fwd, kernels.sil_bwd, kernels.depth_fwd):
        fn.launches = 0


def read_launches() -> dict:
    from dynhor_tpu_torch import kernels

    return {
        "K1": kernels.fused_fwd.launches, "K2": kernels.sil_bwd.launches,
        "K3": kernels.depth_fwd.launches,
    }


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
    print(f"[build] nvcc sm_90a: {time.time() - t0:.1f} s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            print(f"[build] {line.strip()}", flush=True)
    return smi


def phase_kernels(dev, sc, card: str) -> tuple[list[dict], int]:
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
        f"({pairs * TILE * TILE} pixel-slot pairs), max count {int(counts.max())}",
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
    for key, name, ms, plain_ms, err, nbytes, replaces in (
        ("K1", "K1 tile_mass_depth", k1_ms, k1_plain_ms, max(sil_err, z_err),
         in_bytes + out_bytes_k1, "dynhor_tpu/ops/raster_pallas.py:243 _fused_fwd_kernel"),
        ("K2", "K2 tile_mass_grad", k2_ms, k2_plain_ms, k2_err,
         in_bytes + b * t_rows * TILE * TILE * 4 + b * t_rows * m * 24,
         "dynhor_tpu/ops/raster_pallas.py:262 _sil_bwd_kernel"),
    ):
        ops = n_pix * OPS_PER_PAIR[key]
        t_ops = ops / PEAK_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        rows_out.append({
            "name": name, "route": "cuda",
            "source": "dynhor_tpu_torch/csrc/raster_fused.cu", "replaces": replaces,
            "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None,
        })
        print(
            f"[kernels] {name}: {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
            f"{max(t_ops, t_bytes):.5f} ms ({ops:.3e} ops at {PEAK_FLOPS:.3g}/s, "
            f"{nbytes} bytes) — {card}",
            flush=True,
        )
    return rows_out, pairs


def phase_main(dev, sc, card: str, kernel_rows: list[dict], dcfg) -> None:
    from dynhor_tpu_torch import kernels
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
        num_iterations=STEPS, crop_size=CROP, mode="fine",
        max_faces_per_tile=cap, max_active_tiles=act_cap,
    )
    print(f"[main] per-tile face cap {cap}, active-tile cap {act_cap} (counted)", flush=True)
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
        check(launches[k] == STEPS, f"{k} launched {launches[k]} times in {STEPS} steps")
    check(launches["K3"] == 0, "the fine refine launched K3")
    ms_step = wall / STEPS * 1e3
    fps = FRAMES / (wall * (REFINE_STEPS_FULL / STEPS))
    print(
        f"[main] refine_poses fine, ViT-B/14 518² bf16, {FRAMES} frames, {STEPS} steps: "
        f"{ms_step:.2f} ms/step, {fps:.4f} frames/s at 100 steps/frame, peak "
        f"{peak / 2**30:.2f} GiB allocated, launches {launches} — {card}", flush=True,
    )
    print(
        f"[main] final loss {res.final_loss.tolist()}, final IoU {res.final_iou.tolist()}",
        flush=True,
    )
    for row in kernel_rows:
        if row["name"].split()[0] in ("K1", "K2"):
            row["launches"] = launches[row["name"].split()[0]]
    step_breakdown(dev, mesh, targets, rot, trans, dparams, dcfg, cfg, ms_step, card)


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
    print(
        "[breakdown] " + ", ".join(f"{k} {v:.2f} ms" for k, v in parts.items())
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
        print("[breakdown] device busy time: not measured (the profiler saw no kernels)")
        return
    groups = {"matmul": 0.0, "K1+K2": 0.0, "other kernels": 0.0}
    for e in kernels_:
        name = e.key.lower()
        if any(k in name for k in ("gemm", "xmma", "cutlass", "nvjet")):
            key = "matmul"
        elif "fused_fwd_kernel" in name or "sil_bwd_kernel" in name:
            key = "K1+K2"
        else:
            key = "other kernels"
        groups[key] += e.self_device_time_total / steps / 1e3
    print(
        f"[breakdown] device busy {busy:.2f} ms/step (profiler, kernels only): "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in groups.items())
        + f"; idle share {max(0.0, 1.0 - busy / ms_step):.3f} of the unprofiled "
        f"{ms_step:.2f} ms/step — {card}", flush=True,
    )
    for e in sorted(kernels_, key=lambda e: -e.self_device_time_total)[:8]:
        print(
            f"[breakdown]   {e.self_device_time_total / steps / 1e3:8.3f} ms/step "
            f"{e.count // steps:5d} launches/step  {e.key[:90]}", flush=True,
        )


def phase_small_reference(dev) -> None:
    """refine_poses on a small scene: the card (kernels, f32 ViT without
    TF32) against the CPU (plain versions), over 3 steps."""
    from dynhor_tpu_torch.models import dino as D
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
    dcfg = D.DinoConfig(patch_size=8, embed_dim=32, depth=2, num_heads=2, pos_grid=4,
                        smaller_edge_size=32)
    params = D.init_params(dcfg, torch.Generator().manual_seed(3))
    gt = torch.randn((2, 16, 32), generator=torch.Generator().manual_seed(4))
    targets = RF.FrameTargets(masks, gt, K.expand(2, 3, 3))
    cfg = RF.RefineConfig(num_iterations=3, crop_size=s, mode="fine", dino_dtype="float32",
                          max_active_tiles=8)
    noise = 0.05 * torch.randn((2, 3, 2), generator=torch.Generator().manual_seed(5))
    R0 = G.rot6d_to_matrix(G.matrix_to_rot6d(R) + noise)
    r_dev = RF.refine_poses(mesh, targets, R0, t + 0.03, params, dcfg, cfg, device=dev)
    r_cpu = RF.refine_poses(mesh, targets, R0, t + 0.03, params, dcfg, cfg, device="cpu")
    errs = {
        k: float((a.cpu() - b).abs().max())
        for k, a, b in zip(("rot6d", "trans", "loss", "iou"), r_dev[:4], r_cpu[:4])
    }
    print(f"[small] refine_poses 3 steps, card vs CPU max abs err: {errs}", flush=True)
    check(all(e <= 1e-4 for e in errs.values()), "card and CPU trajectories differ by > 1e-4")


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
            row = {
                "name": "K3 tile_depth", "route": "cuda",
                "source": "dynhor_tpu_torch/csrc/raster_fused.cu",
                "replaces": "dynhor_tpu/ops/raster_pallas.py:205 _depth_fwd_kernel",
                "launches": 0, "max_abs_err": z_err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_ms": None,
            }
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


def phase_priors(dev, card: str, kernel_rows: list[dict], dcfg) -> None:
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
    check(tuple(scores.shape) == (FRAMES, PRIOR_VIEWS), f"scores shape {tuple(scores.shape)}")
    check(bool(torch.isfinite(scores).all()), "prior scores not finite")
    print(
        f"[priors] scoring {PRIOR_VIEWS} views: prescreen {n_lo} views at window "
        f"{window_lo} in {t_lo:.3f} s ({n_lo / t_lo:.1f} views/s), rescore {n_hi} views at window "
        f"{window} in {t_hi:.3f} s; counted caps {caps} (prescreen, rescore); K3 launches "
        f"{launches['K3']} = view chunks {chunks}; peak {peak / 2**30:.2f} GiB allocated "
        f"— {card}", flush=True,
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
    prior_breakdown(
        dev, card, dparams, dcfg, (verts, faces, face_uvs, texture), view_rots, crops,
        masks, gt_feats, cos_masks, dataclasses.replace(cfg_lo, max_faces_per_tile=caps[0]),
        window_lo, dataclasses.replace(cfg, max_faces_per_tile=caps[1]), window,
    )


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
        groups = {"K3": 0.0, "sort/top-k": 0.0, "matmul": 0.0, "gather/copy": 0.0, "other": 0.0}
        for e in evs:
            name = e.key.lower()
            if "depth_fwd_kernel" in name:
                key = "K3"
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
            f"[priors-breakdown] {stage} ({c.view_chunk} views/chunk, window {win}, cap "
            f"{c.max_faces_per_tile}): {per_chunk:.2f} ms/chunk unprofiled; device busy "
            f"{busy:.2f} ms/chunk: " + ", ".join(f"{k} {v:.2f} ms" for k, v in groups.items())
            + f"; idle share {max(0.0, 1.0 - busy / per_chunk):.3f} — {card}", flush=True,
        )
        for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:6]:
            print(
                f"[priors-breakdown]   {e.self_device_time_total / chunks / 1e3:8.3f} ms/chunk "
                f"{e.count // chunks:5d} launches/chunk  {e.key[:90]}", flush=True,
            )


def phase_priors_small(dev) -> None:
    """The prior path on a small scene (tiny f32 ViT, 24 views, crop 64,
    render 192, 2 frames, topk 4), on the card and on the CPU."""
    from dynhor_tpu_torch.models import dino as D
    from dynhor_tpu_torch.tracker import priors as TP
    from dynhor_tpu_torch.tracker import selection as TS

    mesh = prior_mesh("cpu")
    crops, masks, _ = render_frames(*mesh, 2, 64, 31)
    dcfg = D.DinoConfig(patch_size=8, embed_dim=32, depth=2, num_heads=2, pos_grid=4,
                        smaller_edge_size=32)
    params = D.init_params(dcfg, torch.Generator().manual_seed(3))
    rots = uniform_rotations(24, 32, "cpu")
    cfg = TP.PriorConfig(num_views=24, view_chunk=8, crop_size=64, render_h=192,
                         render_w=192, dino_dtype="float32")
    radius, _ = TP.mesh_radius_center(mesh[0])
    window = TP.compute_window(cfg, float(TP.mesh_norm_radius(mesh[0])),
                               float(cfg.distance_scale * radius))
    out = {}
    for where in (dev, "cpu"):
        with contextlib.redirect_stdout(io.StringIO()):
            gt, cm = TP.frame_gt_features(params, dcfg, crops, masks, "float32", where)
            scores = TP.prior_scores_two_stage(
                params, dcfg, *mesh, rots, crops, masks, gt, cm, cfg, window,
                prescreen_edge=16, prescreen_scale=2, topk=4, device=where,
            )
        gate = TS.gate_all_frames(scores, rots.transpose(-1, -2).to(scores.device))
        out[str(where)] = (scores.cpu(), gate.selected_idx.cpu())
    (s_dev, i_dev), (s_cpu, i_cpu) = out[str(dev)], out["cpu"]
    err = float((s_dev - s_cpu).abs().max())
    print(
        f"[priors-small] two-stage scores card vs CPU max abs err {err:.3g}; selected "
        f"{i_dev.tolist()} vs {i_cpu.tolist()}", flush=True,
    )
    check(err <= 1e-5, f"prior scores differ by {err} > 1e-5 between card and CPU")
    check(torch.equal(i_dev, i_cpu), "gating selected other views on the card")


def phase_yardsticks(dev, card: str, fine_pairs: int) -> None:
    """Bounds of the TPU kernels still to port, from their shapes, and one
    PyTorch attention call at K5's shape as its yardstick (the port never
    calls it)."""
    # K4a/K4b at the fine step's load (its sum(counts) from phase 2): K4a
    # reads 8-float records and writes one float per pixel, K4b reads them
    # with the cotangent and writes 8 floats per slot.
    b, t_rows = FRAMES, (-(-CROP // TILE)) ** 2
    for key, nbytes in (
        ("K4a", fine_pairs * 32 + b * t_rows * (4 + TILE * TILE * 4)),
        ("K4b", fine_pairs * 32 * 2 + b * t_rows * (4 + TILE * TILE * 4)),
    ):
        ops = fine_pairs * TILE * TILE * OPS_PER_PAIR[key]
        print(
            f"[bounds] {key}: {ops:.4e} f32 ops = {ops / PEAK_FLOPS * 1e3:.5f} ms; "
            f"{nbytes} bytes = {nbytes / PEAK_BYTES * 1e3:.5f} ms", flush=True,
        )
    # K5: attention forward (QK^T and PV: 4 B H N^2 d) and backward (five
    # products: 10 B H N^2 d) in bf16; q, k, v, o read or written once
    # forward, q, k, v, o, dO read and dQ, dK, dV written backward.
    bb, hh, nn, dd = FRAMES, 12, 1370, 64
    flops = 14 * bb * hh * nn * nn * dd
    nbytes = 12 * bb * hh * nn * dd * 2
    print(
        f"[bounds] K5 fwd+bwd (B={bb}, H={hh}, N={nn}, d={dd}, bf16): {flops:.4e} ops = "
        f"{flops / PEAK_BF16 * 1e3:.5f} ms at {PEAK_BF16:.3g}/s; {nbytes} bytes = "
        f"{nbytes / PEAK_BYTES * 1e3:.5f} ms", flush=True,
    )
    # K6 form A: 1024 rows of 8 f32 gathered from an (8192, 8) table.
    nbytes = 1024 * 4 + 2 * 1024 * 8 * 4
    print(f"[bounds] K6 row gather: {nbytes} bytes = {nbytes / PEAK_BYTES * 1e3:.7f} ms",
          flush=True)
    gen = torch.Generator(device=dev).manual_seed(4)
    q, k, v, g = (
        torch.randn((bb, hh, nn, dd), generator=gen, device=dev, dtype=torch.bfloat16)
        for _ in range(4)
    )
    q, k, v = (x.requires_grad_(True) for x in (q, k, v))

    def sdpa():
        torch.nn.functional.scaled_dot_product_attention(q, k, v).backward(g)

    ms = cuda_ms(sdpa, 10)
    print(
        f"[yardstick] scaled_dot_product_attention fwd+bwd at K5's shape: {ms:.4f} ms "
        f"(bound {flops / PEAK_BF16 * 1e3:.5f} ms) — {card}", flush=True,
    )


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device (this script measures the card; it never runs the CPU path)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = phase_build()
    sc = scene(dev)
    kernel_rows, fine_pairs = phase_kernels(dev, sc, smi)
    kernel_rows.append(phase_depth_kernel(dev, smi))
    from dynhor_tpu_torch.models.dino import DinoConfig

    phase_main(dev, sc, smi, kernel_rows, DinoConfig())
    phase_small_reference(dev)
    phase_priors(dev, smi, kernel_rows, DinoConfig())
    phase_priors_small(dev)
    phase_yardsticks(dev, smi, fine_pairs)
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
