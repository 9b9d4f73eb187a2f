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
   by the counts) are printed.  Then K1, K2 and K3 on rows with adversarial
   counts (one row at the cap and the rest empty, counts at the work list's
   chunk edges, none, equal depths in two chunks of one row, 64 frames x 80
   rows; K3 reads the same slots' records through shuffled face ids): hard
   outputs exactly the plain version's, two runs bit-identical.
2b. K3 (the prior views' depth raster, on the work list, reading each
   slot's record through the bins' face ids) against its plain version at
   the prior path's shapes: a chunk of 25 views at window 176 and a
   prescreen chunk of 50 views at window 112, caps counted for them; hit
   masks equal, pix_to_face and zbuf exactly equal.
2c. K5 (flash attention: forward, delta, dK/dV, dQ) against its plain
   versions in bf16 at the fine step's shape (8, 12, 1370, 64) and the
   prescreen's (50, 12, 65, 64), and at token counts across the kernels'
   tile edges (1, 63, 64, 65, 127, 128, 129, 1370 at B 2, H 3), on strided
   views as the ViT block makes them; two backward runs must agree bit for
   bit.  ``scaled_dot_product_attention``, forward and backward, is timed
   beside them (the port never calls it).  A "K5 bwd" row holds the whole
   backward (its three kernels) against the function's bound; each kernel
   prints its share of its bound.  The same in f32 (the f32 kernels, within
   1e-5), at the fine step's shape and the tile edges; their bound counts
   each product as the 3xTF32 route does it (three TF32 products, 165
   TFLOP/s), and the rows also carry the bound on the CUDA cores (f32 FMAs,
   67 TFLOP/s) under ``bound_f32_simt_ms``.  Every row with a library time
   (forward and whole backward, both dtypes) times kernel and library in
   turns (kernel, library, library, kernel, twice) and reports the medians.
   Then K5c, the fused backward (``splash_fused_bwd``), in bf16 and f32
   against ``flash_bwd_fused_plain`` at the same shapes: its dQ partials,
   their sum, dk and dv within the same tolerances, two runs bit for bit;
   timed in turns, the whole fused backward (delta, K5c, the partials' sum)
   against ``scaled_dot_product_attention``'s backward and against the
   two-pass backward; its bound counts the five products and the
   partials' bytes.
2d. K4 (the separate soft silhouette) at the fine step's shapes: K4a and
   K4b (K2's kernel on K4a's rows) against their plain versions, timed
   beside their bounds; ``soft_silhouette_kernel`` forward and d(verts)
   against the CPU's plain path and against ``soft_silhouette_tiled`` on
   the card, which computes the same function.
2e. K6: the gather probe's forms A-H (``tools/probe_gather``), each kernel
   against its plain version (form H also bit for bit against the CPU's),
   and its four timed shapes against their library calls in turns: device
   time per call (a CUDA graph of 20 calls), host time to enqueue, wall
   time per call, beside the byte bound.
3. The fine refine: ``refine_poses`` in fine mode, random-weight ViT-B/14
   at 518², bf16, 8 frames, 10 steps, once with the written-out attention
   (``attn_impl="xla"``: no K5 launch) and once with ``attn_impl="flash"``
   (each K5 kernel once per layer and step, the forward twice under the
   default ``dino_remat="frozen"``, which keeps each block's input, qkv,
   mid residual and fc1 output and recomputes the layer norms and the
   attention core in the backward); K1 and K2 must launch exactly once per
   step.  Then ``dino_dtype="float32"`` with ``"flash"`` for 2 steps: the
   f32 K5 kernels as many times, the bf16 ones never.  Then the
   recomputation sweep, for ``"xla"`` and for ``"flash"``: ``dino_remat``
   False, True (block inputs only), "dots" (every matmul output) and
   "frozen" in turns: ms/step, peak memory, K5 launches, a profiler
   window's device busy time and idle share, the final poses' difference,
   and one step's loss and gradients held to False's (no further apart than
   two runs of one setting).
   Then ``attn_impl="splash"`` with ``splash_fused_bwd`` (K5c), bf16 for
   10 steps and f32 for 2: each K5c of the dtype once per layer and step, no
   dK/dV or dQ kernel, and the final poses within twice the card's own
   spread (two runs of the two-pass setting) of the "flash" run's, and
   never held tighter than 2.9e-3 (bf16) or 1e-4 (f32).
   Then the same entry point on a small scene, on the card and on the CPU
   (plain versions), must agree, for both attentions, for f32 "flash" and
   for the fused backward in both dtypes.
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
   in phases 3 and 4 (the f32 K5 in phase 3's f32 run, K5c in its fused-bwd
   runs), K1-K3 again in
   phase 6, K4a and K4b in 3c, K6 in 2e.
6. ``run.py`` at full width on the card, through the port's entry point
   ``python -m dynhor_tpu_torch.run`` (its ``main``, in this process, from a
   YAML file): a 12-frame
   480x640 shoes sequence from the port's demo-data twin (seed 0,
   correspondences on), the ``io/config.py`` defaults (6,000 random prior
   views in two stages, a random-weight ViT-B/14 at 518², 100 refine and
   200 joint steps, outlier voting).  The phases' seconds, the peak memory
   (the voting's own too), the artifacts (12 pose files with orthonormal
   R, board/, config.yaml, the closing line), no overflow, K3 once per view
   chunk of both stages, K1 and K2 once per refine, joint and re-joint step,
   K5's backward kernels once a layer and refine step and its forward in
   every ViT call (the default attention).  K1-K3's ``launches`` in the
   ``kernels`` line are this run's.
   Then the run's poses with frame 5 moved far off through
   ``maybe_vote_outliers``: the frame found, K1 and K2 once per re-joint
   step (100), the repaired poses orthonormal, the re-joint's overflow at
   JointConfig's default caps printed.
   Then the e2e test's box (4 frames at 120x160, crop 64, a tiny ViT, 24
   prior views) through ``track_sequence`` and, with frame 2 moved far off,
   ``maybe_vote_outliers`` (the repair and a 5-step re-joint) on the card
   and on the CPU: the same selected views, the same outliers, poses within
   1e-4.
7. Multi-hypothesis init at full width: phase 6's sequence through
   ``python -m dynhor_tpu_torch.run`` with ``system.num_initializations:
   4`` and the default ``hypotheses`` block (the gate pick, its two flips,
   one view by silhouette IoU; 25 tournament steps, one propagation round,
   Viterbi).  The phases' seconds, the peak memory, the (12, 6000) sil
   matrix in [0, 1], the hypotheses' provenance, the winners, the
   ``[hypotheses]`` line, the artifacts, no overflow; K3 once per view
   chunk (phase 6's count: the sil channel adds no launch), K1 and K2 once
   per tournament, propagation, continuation, joint and re-joint step.
   Then the box (grid of 24 views, K 4, 3 tournament steps) on the card and
   on the CPU: the same sil matrix, hypotheses and winners, poses within
   1e-4.
7b. ``python -m dynhor_tpu_torch.vis`` on phase 6's experiment: 12
   overlays at 480x640, timed, each with a non-empty overlay mask, no
   kernel launched.  Then ``Visualizer.draw_mesh`` of the box's tracked
   poses on the card and on the CPU: the overlay masks agree except on
   silhouette-boundary pixels (counted), the colours within 1e-4.

8. Multi-sequence pooling at full width: ``python -m
   dynhor_tpu_torch.run_multi`` (its ``main``, in this process) on phase
   6's shoes sequence and a 12-frame 480x640 kettle sequence from the
   demo-data twin, at the ``io/config.py`` defaults (but 2,000 random views
   a sequence in one stage and 50 refine steps, cut from 6,000 and 100 for
   the script's time; a random-weight ViT-B/14 at 518² in bf16, the
   refine steps of the 24 pooled frames in two groups of 16, the second
   padded by 8, and 200 joint steps a sequence): both sequences' artifacts,
   the counted caps and no overflow, K1/K2 once per group step and joint
   step (500), K3 once per view chunk of each scoring call; the seconds per
   phase, the peak memory, each sequence's caps in the pooled batch and
   K1/K2's times at the pooled cap.  Then tests/test_multiseq.py's two
   boxes pooled, on the card and on the CPU, poses within 1e-4.

9. The NeuS reconstruction stage, which reaches no kernel of the
   ``kernels`` line (the JAX package's NeuS has no Pallas kernel): (a)
   ``python -m dynhor_tpu_torch.recon`` (its ``main``, in this process) at
   configs/neus_shoes_fast.yaml's recon block (the 8x256 PE field, the
   occgrid sampler, 1024 rays a step, ``n_shade`` 16, a 192^3 mesh) on phase
   6's sequence (12 frames, 240x320 after ``downscale: 2``) with its
   ground-truth poses, ``num_steps`` cut 4000 -> 1000: rays/s over steps
   501-749 between two synchronizations, the seconds per phase, the peak
   memory, the final PSNR and loss, the mesh from the native marching
   library and its Chamfer distance to the shoes mesh (under 0.1), a falling
   loss, no kernel launched; (b) the bench twin (``tools.bench_neus``) for
   (pe, neus) and (hash, occgrid) at 1024 rays and (pe, occgrid) at 1024
   and 4096, a profiler window of the (pe, occgrid, 1024) step (device busy
   time by kernel group, launches, idle share), and the hash encoder alone
   at 65,536 points; (c) the small
   field on the card and on the CPU with the same draws: dense, compacted
   and occgrid renders and three train steps of each sampler, at the CPU
   tests' tolerances.
10. Sharding over ``torch.distributed``: (a) a one-rank NCCL group through
   ``parallel.multihost.init_distributed``, every collective of
   ``parallel/mesh.py`` on CUDA tensors against its one-rank values; (b)
   two ranks sharing the card over gloo (NCCL refuses two ranks on one
   device), spawned as ``chip_smoke.py --shard-rank R RENDEZVOUS INPUTS
   OUT``, at full width against the same work in this process: the
   frame-sharded refine of phase 3's scene (4 + 4 frames, 10 steps), the
   frame-sharded joint (4 + 4, 200 steps, the smoothness halo),
   view-sharded two-stage prior scoring of 6,000 views, the ray-sharded
   NeuS step of neus_shoes_fast (512 + 512 rays, 50 steps; also against
   this process taking the two ranks' halves in their order), and the two
   entry points with ``system.devices: 2``: ``python -m
   dynhor_tpu_torch.run`` on phase 6's sequence and ``python -m
   dynhor_tpu_torch.run_multi`` on phase 8's two (their mains; views,
   refine and joint steps cut, the pooled frames sharded), rank 0 alone
   writing; each rank's K1/K2/K3 launches and wall seconds per case ("two
   ranks sharing one card", not a scaling figure); a failed rank fails the
   phase.
11. The tools (``python -m dynhor_tpu_torch.tools.<name>``, each through its
   ``main`` or ``run``) at full width: ``ablate_oracle_init`` and
   ``ablate_multihyp`` on phase 8's kettle at BASELINE.md's matched
   settings (50 refine and 100 joint steps, 500 views; K 4, tournament 25,
   one propagation round), the oracle arm's selected views the GT-nearest
   prior views, its joint IoU at least 0.90 and its mean joint rotation
   error at most 5 degrees; ``eval_poses`` on phase 6's artifacts, equal to
   phase 6's own angles within 1e-4 degrees; ``ab_prescreen`` at 1000
   views and ``ablate_fine_edge`` at edges 518 and 252 on the shoes (depth
   cut); each probe at its own default shapes (the ViT probe under both
   attentions; ``probe_vit_attention``'s four variants, which launch K5c
   and the dQ kernel); ``warm_cache`` into a fresh
   build directory; ``weak_scaling`` at one NCCL rank.  Every tool returns
   finite numbers; the quality numbers (joint IoU, rotation errors against
   GT) are printed.

Each phase group prints ``[time]``, the script's seconds so far.  Prints a
``{"kernels": [...]}`` line and, last, ``{"ok": true, "device": {...}}``.
Without a CUDA device it exits 1 and prints no result.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
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
# The cheapest f32-accurate route for an f32 matrix product on this card:
# three TF32 tensor-core products (495 TFLOP/s dense) per product, so 165.
PEAK_TF32_3X = 495e12 / 3
PRIOR_VIEWS = 6000  # io/config.py prior.num_views
JOINT_STEPS = 200  # io/config.py system.joint_num_iterations
CPU_FRAMES = 2  # frames of phase 2d's card-vs-CPU check
RUN_FRAMES = 12  # tools/make_demo_data.py's defaults: 12 frames at 480x640
RUN_HW = (480, 640)
# The e2e test's box (tests/test_pipeline_e2e.py), 12 faces.
BOX_V = [[-0.3, -0.2, -0.1], [0.3, -0.2, -0.1], [0.3, 0.2, -0.1], [-0.3, 0.2, -0.1],
         [-0.3, -0.2, 0.1], [0.3, -0.2, 0.1], [0.3, 0.2, 0.1], [-0.3, 0.2, 0.1]]
BOX_F = [[0, 1, 2], [0, 2, 3], [4, 6, 5], [4, 7, 6], [0, 4, 5], [0, 5, 1],
         [3, 2, 6], [3, 6, 7], [1, 5, 6], [1, 6, 2], [0, 3, 7], [0, 7, 4]]
# The card against the CPU on the box, the same torch pipeline: poses after
# the refine and after the joint and re-joint within this (measured 4.41e-6
# and 7.57e-6 on an H100 80GB HBM3 at 700 W).
RUN_CARD_TOL = 1e-4
# The frame that phase 6 moves far off so that the voting repairs it and the
# re-joint runs at full width (inside the sequence: it has both neighbours).
RUN_MOVED = 5
# Hypotheses per frame of phase 7: the gate pick, its two flips and one view
# by silhouette IoU, so every part of build_hypotheses runs.
MULTIHYP_K = 4
# One fine step's loss and gradients under each dino_remat policy and under
# False (the same computation, part of it recomputed) differ by no more than
# two runs of one setting do, or than this share of their largest value.  In bf16 on an H100
# 80GB HBM3 the recomputed step differed by 6.07e-5 of 1.13 (repeats of one
# setting by 1.99e-5: atomics), far below one bf16 rounding (2^-8).  The
# card's step is not bit-reproducible, and 10 chaotic bf16 steps spread that
# to 1.2e-3 - 2.9e-3 in the poses between runs of ONE setting, so the poses
# after the timed runs are printed, not held.
REMAT_TOL = 1e-4
# Phase 7's box, card against CPU.  The bf16 refine of this scene is
# ill-conditioned: a relative 1e-6 nudge of the tiny ViT's weights moves the
# CPU's own poses by 5.7e-3 (2.0e-3 with one hypothesis), and the card's bf16
# arithmetic differs from the CPU's by far more than 1e-6 (card vs CPU
# 1.16e-2, tournament losses 1.29e-3, on an H100 80GB HBM3).  The losses are
# held as tests/test_torch_pipeline.py holds bf16 refine losses; the poses
# to BOX_SPREAD x the CPU's own spread, measured in the same run.
BOX_LOSS_RTOL = 1e-2
BOX_SPREAD = 4.0


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


def turns(fns: dict, rounds: int = 4, reps: int = 10) -> dict:
    """Each callable of ``fns`` timed in turns, in their order and then
    reversed, ``rounds`` times (a, b, c, c, b, a, ...), each sample a
    ``cuda_ms`` over ``reps`` launches; returns {name: (median, samples)}."""
    got = {name: [] for name in fns}
    for _ in range(rounds):
        for order in (list(fns), list(fns)[::-1]):
            for name in order:
                got[name].append(cuda_ms(fns[name], reps))
    return {name: (float(np.median(v)), v) for name, v in got.items()}


def in_turns(kernel, library, rounds: int = 2, reps: int = 10) -> tuple[float, float, list, list]:
    """Kernel and library timed in turns (kernel, library, library, kernel)
    ``rounds`` times; returns (kernel median, library median, kernel
    samples, library samples)."""
    res = turns({"kernel": kernel, "library": library}, rounds, reps)
    return res["kernel"][0], res["library"][0], res["kernel"][1], res["library"][1]


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
        "K5c": kernels.flash_bwd_fused, "K5c f32": kernels.flash_bwd_fused_f32,
        "K4a": kernels.sil_mass_fwd, "K4b": kernels.sil_mass_bwd,
        "K6 take_along_axis": kernels.take_along_axis,
        "K6 scatter_add_axis0": kernels.scatter_add_axis0,
    }


# The fused backward (K5c) of each dtype: its launch-count key.
K5C_KEYS = {"bfloat16": "K5c", "float32": "K5c f32"}


def check_k5_launches(launches: dict, fwd: int, bwd: int, where: str,
                      dtype: str = "bfloat16", fused: bool = False) -> None:
    """fwd and bwd launches of each K5 kernel of ``dtype``, none of the
    other dtype's; with ``fused`` the backward's are delta's and the fused
    kernel's (K5c), and the dK/dV and dQ kernels never launch."""
    want = {}
    for name, keys in K5_DTYPE_KEYS.items():
        f, b = (fwd, bwd) if name == dtype else (0, 0)
        want.update({keys[0]: f, keys[1]: b, keys[2]: 0 if fused else b,
                     keys[3]: 0 if fused else b, K5C_KEYS[name]: b if fused else 0})
    got = {k: launches[k] for k in want}
    check(got == want, f"{where}: K5 launches {got}, expected {want}")


def k5_per_step(dcfg, cfg) -> tuple[int, int]:
    """(forward, backward) launches of each K5 kernel in one fine refine step
    under a kernel attention: once per layer, and the forward once more per
    layer under every ``dino_remat`` policy but False: True reruns each
    block, "frozen" the attention core, and "dots" everything but the
    matmuls, which K5 is not."""
    if dcfg.attn_impl == "xla":
        return 0, 0
    return dcfg.depth * (2 if cfg.dino_remat else 1), dcfg.depth


def check_default_vit_k5(launches: dict, refine_steps: int | None, where: str,
                         depth: int = 12) -> None:
    """The port's default ViT ("flash", bf16, "frozen") on a tracking path:
    K5's delta, dK/dV and dQ kernels once a layer and refine step (of
    ``refine_steps``, where given), its forward more than twice that (the
    recomputed backward, and every forward-only ViT call besides)."""
    bwd = {k: launches[k] for k in K5_KEYS[1:]}
    n = launches[K5_KEYS[1]]
    want = n if refine_steps is None else depth * refine_steps
    check(n > 0 and n % depth == 0 and bwd == dict.fromkeys(bwd, want)
          and launches[K5_KEYS[0]] > 2 * n,
          f"{where}: K5 launches {bwd}, forward {launches[K5_KEYS[0]]}, expected "
          f"{want} each and the forward above twice that")


def reset_launches() -> None:
    from dynhor_tpu_torch import kernels

    for fn in _counted(kernels).values():
        fn.launches = 0


def read_launches() -> dict:
    from dynhor_tpu_torch import kernels

    return {key: fn.launches for key, fn in _counted(kernels).items()}


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


def check_k1_k2(rows, counts, tw, g, where: str) -> dict:
    """K1 and K2 on (rows, counts) against their plain versions on the same
    inputs (K2 on the cotangent ``g``); fails the run through ``check``:
    silhouette 1e-5, mass 1e-4 relative, zbuf 1e-5, pix_to_face exact,
    d(xy) rtol 1e-4 and atol 1e-5 x max.  Returns the errors."""
    from dynhor_tpu_torch import kernels
    from dynhor_tpu_torch.ops import raster_fused as RFU

    args = (TILE, tw, SIGMA)
    mass, zmin, jbest = kernels.fused_fwd(rows, counts, *args, 1e-2)
    mass_p, zmin_p, jbest_p = RFU.tile_mass_depth_plain(rows, counts, *args, 1e-2)
    torch.cuda.synchronize()
    sil_err = float((torch.exp(-mass) - torch.exp(-mass_p)).abs().max())
    mass_err = float(((mass - mass_p).abs() / mass_p.abs().clamp_min(1.0)).max())
    hit = zmin_p < 1.5e38
    check(bool((hit == (zmin < 1.5e38)).all()), f"{where}: K1 hit masks differ")
    z_err = float((zmin - zmin_p)[hit].abs().max()) if bool(hit.any()) else 0.0
    n_mism = int((hit & (jbest != jbest_p)).sum())
    del mass, zmin, jbest, mass_p, zmin_p, jbest_p
    dxy = kernels.sil_bwd(rows, counts, g, *args)
    dxy_p = RFU.tile_mass_grad_plain(rows, counts, g, *args)
    torch.cuda.synchronize()
    scale = float(dxy_p.abs().max())
    k2_err = float((dxy - dxy_p).abs().max())
    k2_ok = bool(((dxy - dxy_p).abs() <= 1e-5 * scale + 1e-4 * dxy_p.abs()).all())
    print(
        f"[{where}] K1 vs plain on rows {tuple(rows.shape)}: sil max abs err {sil_err:.3g}, "
        f"mass max rel err {mass_err:.3g}, zbuf max abs err {z_err:.3g} over {int(hit.sum())} "
        f"hit pixels, pix_to_face mismatches {n_mism}; K2 vs plain: d(xy) max abs err "
        f"{k2_err:.3g} (max |d(xy)| {scale:.3g})", flush=True,
    )
    check(sil_err <= 1e-5, f"{where}: K1 silhouette error {sil_err} > 1e-5")
    check(mass_err <= 1e-4, f"{where}: K1 mass relative error {mass_err} > 1e-4")
    check(z_err <= 1e-5, f"{where}: K1 zbuf error {z_err} > 1e-5")
    check(n_mism == 0, f"{where}: K1 pix_to_face differs at {n_mism} pixels")
    check(k2_ok, f"{where}: K2 d(xy) outside rtol 1e-4, atol 1e-5 x max")
    return {"sil": sil_err, "mass": mass_err, "zbuf": z_err, "p2f": n_mism, "dxy": k2_err,
            "dxy_max": scale}


def phase_kernels(dev, sc, card: str) -> list[dict]:
    from dynhor_tpu_torch import kernels
    from dynhor_tpu_torch.ops import raster_fused as RFU
    from dynhor_tpu_torch.tools._timing import host_us

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

    # K1 and K2 against their plain versions, K2 on a fixed random cotangent.
    gen = torch.Generator(device="cpu").manual_seed(1)
    g = torch.randn((b, t_rows, TILE * TILE), generator=gen).to(dev)
    errs = check_k1_k2(rows, counts, tw, g, "kernels")
    sil_err, z_err, k2_err = errs["sil"], errs["zbuf"], errs["dxy"]
    k1_ms = cuda_ms(lambda: kernels.fused_fwd(rows, counts, *args, 1e-2))
    k1_host = host_us(lambda: kernels.fused_fwd(rows, counts, *args, 1e-2), dev)
    k1_plain_ms = cuda_ms(lambda: RFU.tile_mass_depth_plain(rows, counts, *args, 1e-2), reps=3)
    k2_ms = cuda_ms(lambda: kernels.sil_bwd(rows, counts, g, *args))
    k2_host = host_us(lambda: kernels.sil_bwd(rows, counts, g, *args), dev)
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


def as_records(rows, seed):
    """K3's inputs holding the same slots as packed tile rows (b, t, m, 16):
    every slot's record at a shuffled place of a (b, t * m, 16) face pool,
    and indices (b, t, m) int32 pointing at it."""
    b, t, m, _ = rows.shape
    perm = torch.as_tensor(np.random.default_rng(seed).permutation(t * m)).to(rows.device)
    rows_all = torch.empty((b, t * m, 16), dtype=rows.dtype, device=rows.device)
    rows_all[:, perm] = rows.reshape(b, t * m, 16)
    return rows_all, perm.to(torch.int32).reshape(1, t, m).expand(b, t, m).contiguous()


def phase_adversarial_counts(dev, card: str) -> None:
    """K1, K2 and K3 against their plain versions on rows whose counts the
    work list finds hardest; hard outputs exactly equal, mass within 1e-4
    relative, d(xy) within rtol 1e-4 and atol 1e-5 x max, and two runs
    bit-identical.  K3 reads the same slots through shuffled face ids
    (``as_records``) and must give K1's plain zbuf and slots.  These
    launches are not the main path's."""
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
        rows_all, indices = as_records(rows, 3)
        k3_args = (rows_all, indices, counts, TILE, 16, 1e-2)
        k3_runs = [kernels.depth_fwd(*k3_args) for _ in range(2)]
        zmin3_p, jbest3_p = RFU.tile_depth_plain(*k3_args, chunk=chunk)
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(*k3_runs)),
              f"K3 differs between two runs on the same inputs ({name})")
        check(torch.equal(zmin3_p, zmin_p) and torch.equal(jbest3_p, jbest_p),
              f"K3's plain version differs from K1's hard outputs ({name})")
        check(torch.equal(k3_runs[0][0], zmin_p) and torch.equal(k3_runs[0][1], jbest_p),
              f"K3 zbuf or pix_to_face differ from the plain version ({name})")
        ms = (cuda_ms(lambda: kernels.fused_fwd(rows, counts, *args, 1e-2)),
              cuda_ms(lambda: kernels.sil_bwd(rows, counts, g, *args)),
              cuda_ms(lambda: kernels.depth_fwd(*k3_args)))
        print(
            f"[adversarial] {name}: rows {tuple(rows.shape)}; {count_line(counts)}; hard outputs "
            f"equal, two runs bit-identical, mass max rel err {mass_err:.3g}, d(xy) max abs err "
            f"{float((dxy - dxy_p).abs().max()):.3g} (max {scale:.3g})"
            + (f", slot {tie[1][0]} wins the tie over {tie[1][1:]}" if tie else "")
            + f"; K3 through shuffled face ids equal too; K1 {ms[0]:.4f} ms, K2 {ms[1]:.4f} ms, "
            f"K3 {ms[2]:.4f} ms — {card}", flush=True,
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
    sums in another order; the kernels' 3xTF32 products drop lo x lo, below
    2^-21 of each product).  Bounds: bf16 products at the tensor cores'
    peak, f32 ones at the 3xTF32 rate (and on the CUDA cores beside it),
    delta at the f32 peak."""
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

        def kernel_bwd():
            delta = kernels.flash_bwd_delta(o_p, g)
            kernels.flash_bwd_dkv(q, k, v, g, lse_p, delta, scale)
            kernels.flash_bwd_dq(q, k, v, g, lse_p, delta, scale)

        # The library call, timed here and used nowhere in the port.
        ql, kl, vl = (x.detach().contiguous().requires_grad_(True) for x in (q, k, v))
        gl = g.contiguous()
        sdpa = torch.nn.functional.scaled_dot_product_attention

        def library_fwd():
            with torch.no_grad():
                return sdpa(ql, kl, vl)

        out_l = sdpa(ql, kl, vl)
        # Forward and whole backward in turns with the library's calls.
        fwd_ms, lib_fwd, fwd_k, fwd_l = in_turns(lambda: kernels.flash_fwd(q, k, v, scale),
                                                 library_fwd)
        bwd_ms, lib_bwd, bwd_k, bwd_l = in_turns(
            kernel_bwd,
            lambda: torch.autograd.grad(out_l, (ql, kl, vl), gl, retain_graph=True),
        )
        lib_both = cuda_ms(lambda: sdpa(ql, kl, vl).backward(gl), 10)
        print(
            f"[k5] {tname} N={n} in turns (kernel, library, library, kernel, twice), ms: forward "
            f"kernel {[round(x, 4) for x in fwd_k]}, library {[round(x, 4) for x in fwd_l]}; "
            f"backward kernel {[round(x, 4) for x in bwd_k]}, library "
            f"{[round(x, 4) for x in bwd_l]} — {card}", flush=True,
        )
        ms = {
            "K5 fwd": fwd_ms,
            "K5 delta": cuda_ms(lambda: kernels.flash_bwd_delta(o_p, g)),
            "K5 dkv": cuda_ms(lambda: kernels.flash_bwd_dkv(q, k, v, g, lse_p, delta_p, scale)),
            "K5 dq": cuda_ms(lambda: kernels.flash_bwd_dq(q, k, v, g, lse_p, delta_p, scale)),
            "K5 bwd": bwd_ms,
        }
        plain_fwd = cuda_ms(lambda: FA.flash_fwd_plain(q, k, v, scale), reps=3)
        plain_delta = cuda_ms(lambda: FA.flash_delta_plain(o_p, g), reps=3)
        # The plain backward computes dq, dk and dv in one loop: its time
        # stands beside both backward kernels.
        plain_bwd = cuda_ms(
            lambda: FA.flash_bwd_plain(q, k, v, g, lse_p, delta_p, scale), reps=3
        )
        plain = {"K5 fwd": plain_fwd, "K5 delta": plain_delta, "K5 dkv": plain_bwd,
                 "K5 dq": plain_bwd, "K5 bwd": plain_delta + plain_bwd}

        # Bounds: operations in the inputs' type (a product of an (N, d) by
        # a (d, N) or (N, N) by (N, d) matrix is 2 N^2 d), bytes with each
        # input read once and each output written once.  The
        # backward as a function needs five products (S, dP, dV, dK, dQ) and
        # each of its two passes recomputes S and dP: the rows share the
        # function's five without counting any twice, S with dK and dV on the
        # dK/dV pass, dP with dQ on the dQ pass; the "K5 bwd" row carries the
        # whole backward (delta, then both passes) against the whole bound
        # and the library's backward.  f32 products count as the 3xTF32
        # route does them (PEAK_TF32_3X); the bound on the CUDA cores (f32
        # FMAs at PEAK_FLOPS) rides beside it.
        prod = 2 * b * h * n * n * d
        tensor = b * h * n * d * q.element_size()  # bytes of one (B, H, N, d) tensor
        peak_products = PEAK_TF32_3X if f32 else PEAK_BF16
        vec = b * h * n * 4  # bytes of one f32 (B, H, N) tensor
        work = {
            "K5 fwd": (2 * prod, 4 * tensor + vec),  # S, P V; q k v -> o, lse
            "K5 delta": (2 * b * h * n * d, 2 * tensor + vec),
            "K5 dkv": (3 * prod, 6 * tensor + 2 * vec),  # S, dV, dK (dP recomputed)
            "K5 dq": (2 * prod, 5 * tensor + 2 * vec),  # dP, dQ (S recomputed)
            # q, k, v, o, dO -> dq, dk, dv, with the log-sum-exp
            "K5 bwd": (5 * prod, 8 * tensor + vec),
        }
        library = {"K5 fwd": lib_fwd, "K5 bwd": lib_bwd}
        rows = []
        for key in (*K5_KEYS, "K5 bwd"):
            ops, nbytes = work[key]
            peak = PEAK_FLOPS if key == "K5 delta" else peak_products
            t_ops, t_bytes = ops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
            err = {"K5 fwd": errs["o"][0], "K5 delta": errs["delta"][0],
                   "K5 dkv": max(errs["dk"][0], errs["dv"][0]), "K5 dq": errs["dq"][0],
                   "K5 bwd": max(errs[name][0] for name in ("delta", "dq", "dk", "dv"))}[key]
            row = kernel_row(
                key + sfx + " flash_attention",
                f"dynhor_tpu_torch/csrc/flash_attention{'_f32' if f32 else ''}.cu",
                "dynhor_tpu/models/dino.py:202 _flash_attention and "
                "dynhor_tpu/models/dino.py:243 _splash_attention",
                err, ms[key], plain[key], ops, nbytes, peak, library.get(key),
            )
            simt = ""
            if f32:
                row["bound_f32_simt_ms"] = max(ops / PEAK_FLOPS * 1e3, t_bytes)
                simt = (f"; on the CUDA cores {row['bound_f32_simt_ms']:.5f} ms "
                        f"({100 * row['bound_f32_simt_ms'] / ms[key]:.1f} %)")
            rows.append(row)
            bound = max(t_ops, t_bytes)
            lib = library.get(key)
            lib_txt = (f"scaled_dot_product_attention {lib:.4f} ms" if lib is not None
                       else "no single library call")
            print(
                f"[k5] {tname} N={n} {key}{sfx}: {ms[key]:.4f} ms, "
                f"{100 * bound / ms[key]:.1f} % of its bound "
                f"{bound:.5f} ms ({ops:.4e} ops = {t_ops:.5f} ms, {nbytes} bytes = "
                f"{t_bytes:.5f} ms){simt}; plain {plain[key]:.3f} ms; {lib_txt} — {card}",
                flush=True,
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


def fused_parity(q, k, v, g, scale, where: str):
    """K5c (the fused backward) against ``flash_bwd_fused_plain`` on the same
    inputs, the plain forward's log-sum-exp and delta; its partials, their
    sum and dk, dv within ``k5_parity``'s tolerances; two runs bit for bit.
    Returns the plain forward's (o, lse, delta) and the errors as {name:
    (max abs err, max |ref|)}."""
    from dynhor_tpu_torch import kernels
    from dynhor_tpu_torch.ops import flash_attention as FA

    o_p, lse_p = FA.flash_fwd_plain(q, k, v, scale)
    delta_p = FA.flash_delta_plain(o_p, g)
    part_p, dk_p, dv_p = FA.flash_bwd_fused_plain(q, k, v, g, lse_p, delta_p, scale)
    part, dk, dv = kernels.flash_bwd_fused(q, k, v, g, lse_p, delta_p, scale)
    torch.cuda.synchronize()
    check(part.shape == part_p.shape, f"K5c partials {tuple(part.shape)} at {where}, plain "
          f"{tuple(part_p.shape)}")
    # No atomics: a second run gives the same bits.
    again = kernels.flash_bwd_fused(q, k, v, g, lse_p, delta_p, scale)
    check(all(torch.equal(a, b) for a, b in zip((part, dk, dv), again)),
          f"K5c differs between two runs on the same inputs at {where}")

    def rel(a, ref):
        a, ref = a.float(), ref.float()
        check(bool(torch.isfinite(a).all()), f"K5c output not finite at {where}")
        return float((a - ref).abs().max()), float(ref.abs().max())

    errs = {"dq_part": rel(part, part_p), "dq": rel(FA.sum_dq_part(part), FA.sum_dq_part(part_p)),
            "dk": rel(dk, dk_p), "dv": rel(dv, dv_p)}
    tol = 1e-5 if q.dtype == torch.float32 else 2.0**-7
    for name, (e, m) in errs.items():
        if q.shape[2] == 1 and name != "dv":
            # One key: dS = dP - delta is 0 in exact arithmetic (see k5_parity).
            check(e <= 1e-5 and m <= 1e-5, f"K5c {name} at {where}: {e}, {m} not 0 within 1e-5")
            continue
        check(e <= tol * m, f"K5c {name}: error {e} > {tol} x max |ref| {m} at {where}")
    return (o_p, lse_p, delta_p), errs


# K5c's token counts: K5's tile edges, three key blocks with a ragged last
# one (300) and the fine-edge ablation's 252 crop (325).
K5C_EDGE_N = K5_EDGE_N + (300, 325)


def phase_fused_kernels(dev, card: str, dtype: torch.dtype = torch.bfloat16) -> list[dict]:
    """K5c of ``dtype`` against its plain version on the card at the fine
    step's shape, the prescreen's (50, 12, 65, 64) and the tile edges
    (``K5C_EDGE_N``, B 2, H 3), two runs bit for bit; then the kernel alone,
    the whole fused backward, the two-pass backward and
    ``scaled_dot_product_attention``'s backward timed in turns.  Returns the
    row of the fine step's shape.

    Tolerances as ``k5_parity``'s.  The bound counts the five products of
    the backward (S, dP, dV, dK, dQ) and the bytes of q, k, v, dO, the rows'
    log-sum-exp and delta read, dk, dv and the partials written."""
    from dynhor_tpu_torch import kernels
    from dynhor_tpu_torch.ops import flash_attention as FA

    f32 = dtype == torch.float32
    tname, sfx = ("f32", " f32") if f32 else ("bf16", "")
    for n in K5C_EDGE_N:
        q, k, v, g = block_views(2, 3, n, 64, 200 + n, dev, dtype)
        _, errs = fused_parity(q, k, v, g, 0.125, f"(2, 3, {n}, 64) {tname}")
        print(f"[k5c] {tname} tile edge N={n} (B=2, H=3): within tolerance, bit-identical over "
              "two runs; max abs err (max |ref|) "
              + ", ".join(f"{name} {e:.3g} ({m:.3g})" for name, (e, m) in errs.items()),
              flush=True)
    row = None
    for b, h, n, d, seed in ((FRAMES, 12, 1370, 64, 43), (50, 12, 65, 64, 44)):
        q, k, v, g = block_views(b, h, n, d, seed, dev, dtype)
        scale = 1.0 / d**0.5
        (o_p, lse_p, delta_p), errs = fused_parity(q, k, v, g, scale,
                                                   f"({b}, {h}, {n}, {d}) {tname}")
        print(f"[k5c] (B={b}, H={h}, N={n}, d={d}) {tname}, kernel vs plain, max abs err "
              "(max |ref|): " + ", ".join(f"{name} {e:.3g} ({m:.3g})"
                                          for name, (e, m) in errs.items()), flush=True)
        if n != 1370:
            continue

        def fused_bwd():
            delta = kernels.flash_bwd_delta(o_p, g)
            part, _, _ = kernels.flash_bwd_fused(q, k, v, g, lse_p, delta, scale)
            FA.sum_dq_part(part)

        def two_pass_bwd():
            delta = kernels.flash_bwd_delta(o_p, g)
            kernels.flash_bwd_dkv(q, k, v, g, lse_p, delta, scale)
            kernels.flash_bwd_dq(q, k, v, g, lse_p, delta, scale)

        # The library call, timed here and used nowhere in the port.
        ql, kl, vl = (x.detach().contiguous().requires_grad_(True) for x in (q, k, v))
        gl = g.contiguous()
        out_l = torch.nn.functional.scaled_dot_product_attention(ql, kl, vl)
        res = turns({
            "K5c": lambda: kernels.flash_bwd_fused(q, k, v, g, lse_p, delta_p, scale),
            "fused": fused_bwd, "two-pass": two_pass_bwd,
            "library": lambda: torch.autograd.grad(out_l, (ql, kl, vl), gl, retain_graph=True),
        })
        ms = res["K5c"][0]
        plain = cuda_ms(lambda: FA.flash_bwd_fused_plain(q, k, v, g, lse_p, delta_p, scale), 3)
        prod = 2 * b * h * n * n * d
        tensor = b * h * n * d * q.element_size()
        parts = -(-n // kernels.FUSED_KEYS)
        ops, nbytes = 5 * prod, (6 + parts) * tensor + 2 * b * h * n * 4
        peak = PEAK_TF32_3X if f32 else PEAK_BF16
        row = kernel_row(
            "K5c" + sfx + " flash_attention",
            f"dynhor_tpu_torch/csrc/flash_attention{'_f32' if f32 else ''}.cu",
            "dynhor_tpu/models/dino.py:288 _splash_attention, use_fused_bwd_kernel: "
            "splash_attention_kernel.py:1857 _splash_attention_bwd_dkv",
            max(errs["dq"][0], errs["dk"][0], errs["dv"][0]), ms, plain, ops, nbytes, peak,
            res["library"][0],
        )
        row["whole_bwd_ms"], row["two_pass_bwd_ms"] = res["fused"][0], res["two-pass"][0]
        simt = ""
        if f32:
            row["bound_f32_simt_ms"] = max(ops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3)
            simt = f"; on the CUDA cores {row['bound_f32_simt_ms']:.5f} ms"
        print(
            f"[k5c] {tname} N={n}: the fused kernel {ms:.4f} ms, "
            f"{100 * row['bound_ms'] / ms:.1f} % of its bound {row['bound_ms']:.5f} ms "
            f"({row['bound_by']}: {ops:.4e} ops, {nbytes} bytes with {parts} partials of "
            f"{kernels.FUSED_KEYS} keys, {parts * tensor} bytes{simt}); plain {plain:.3f} ms "
            f"— {card}", flush=True)
        print(
            f"[k5c] {tname} N={n} in turns ({len(res['fused'][1])} samples each), medians, ms: "
            + "; ".join(f"{name} {med:.4f} {[round(x, 4) for x in v]}"
                        for name, (med, v) in res.items())
            + f"; fused / two-pass {res['fused'][0] / res['two-pass'][0]:.3f}, fused / library "
            f"{res['fused'][0] / res['library'][0]:.3f} (fused: delta + K5c + the partials' "
            f"sum; two-pass: delta + dK/dV + dQ; library: scaled_dot_product_attention's "
            f"backward) — {card}", flush=True)
    return [row]


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
    (the probe's own checks; form H also bit for bit against the CPU), and
    its four timed shapes, each against its library call in turns: device
    time (a CUDA graph), enqueue time and wall time.  Returns the two rows,
    each timed at the shape of the TPU kernel it replaces (the timed gather
    :210, form H :249): ``ms`` and ``library_ms`` wall time per call, as in
    every other row, ``device_ms`` and ``library_device_ms`` device time,
    ``host_us`` and ``library_host_us`` enqueue time, their launches those
    of this probe run.  The hash backward's shapes, where
    the JAX tool times only XLA, are printed and kept out of the rows."""
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
        row = kernel_row(name, "dynhor_tpu_torch/csrc/gather_probe.cu", replaces, err,
                         t["wall_ms"], t["plain_ms"], 0, t["bytes"],
                         library_ms=t["library_wall_ms"])
        row.update(device_ms=t["device_ms"], library_device_ms=t["library_device_ms"],
                   host_us=t["host_us"], library_host_us=t["library_host_us"])
        row["launches"] = launches[name]
        out.append(row)
    for key, t in timed.items():
        print(f"[k6] {key}: device {t['device_ms'] * 1e3:.3f} us against the library's "
              f"{t['library_device_ms'] * 1e3:.3f} us, enqueue {t['host_us']:.2f} against "
              f"{t['library_host_us']:.2f} us, wall {t['wall_ms']:.5f} against "
              f"{t['library_wall_ms']:.5f} ms (in turns); bound {t['bound_ms']:.6f} ms (bytes), "
              f"{t['bound_ms'] / t['device_ms'] * 100:.1f} % of it by device time — {card}", flush=True)
    print(f"[k6] launches in the probe: take_along_axis {launches['K6 take_along_axis']}, "
          f"scatter_add_axis0 {launches['K6 scatter_add_axis0']}", flush=True)
    return out


def phase_main(dev, sc, card: str, kernel_rows: list[dict], dcfg, dtype: str = "bfloat16",
               steps: int = STEPS, again: bool = False) -> dict:
    """The fine refine at full width under dcfg.attn_impl with the ViT in
    ``dtype``, ``steps`` steps; returns its ms/step, peak memory, final
    losses and poses, and with ``again`` the poses of a second run on the
    same inputs (the card's own spread).  The bf16 runs set the launches of
    the kernel rows other than the f32 K5 ones, the f32 run those, and only
    the bf16 runs of the two-pass backward are broken down by parts."""
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
    fused = dcfg.attn_impl == "splash" and dcfg.splash_fused_bwd
    tag = f"[main {dcfg.attn_impl}{' fused-bwd' if fused else ''}{' f32' if f32 else ''}]"
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
    # each K5 kernel of the ViT's dtype once per layer and step (the forward
    # twice under dino_remat).
    fwd, bwd = k5_per_step(dcfg, cfg)
    check_k5_launches(launches, fwd * steps, bwd * steps,
                      f"refine_poses {dcfg.attn_impl} {dtype}", dtype, fused)
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
        # One whole two-pass backward is one launch of each of its three
        # kernels, the last the dQ kernel's.
        n = launches.get(key.replace("K5 bwd", "K5 dq"), 0)
        if n > 0 and key.endswith(" f32") == f32:
            row["launches"] = n
    if not f32 and not fused:
        step_breakdown(dev, mesh, targets, rot, trans, dparams, dcfg, cfg, ms_step, card)
    out = {"ms_step": ms_step, "peak_gib": peak / 2**30, "loss": res.final_loss.tolist(),
           "rot6d": res.rot6d, "trans": res.translations}
    if again:
        res = RF.refine_poses(mesh, targets, rot, trans * 1.0001, dparams, dcfg, cfg, device=dev)
        out["again"] = (res.rot6d, res.translations)
    return out


# The card's own spread of the bf16 fine refine's poses after 10 steps
# between two runs of one setting (1.2e-3 to 2.9e-3, PERF.md): the floor of
# what the fused backward's run may differ from the two-pass one's.
BF16_POSE_SPREAD = 2.9e-3
# The same floor in f32 after 2 steps: RUN_CARD_TOL, the port's f32 limit.
F32_POSE_SPREAD = 1e-4


def pose_diff(a: dict, b) -> float:
    """Max abs difference of the final rot6d and translations of run a and
    b (a run's dict, or a (rot6d, translations) pair)."""
    rb, tb = (b["rot6d"], b["trans"]) if isinstance(b, dict) else b
    return max(float((a["rot6d"] - rb).abs().max()), float((a["trans"] - tb).abs().max()))


def phase_fused_refine(dev, sc, card: str, kernel_rows: list[dict], two_pass: dict,
                       two_pass_f32: dict) -> None:
    """The fine refine under ``attn_impl="splash"`` with ``splash_fused_bwd``
    (the fused backward, K5c), bf16 for 10 steps and f32 for 2, as the
    two-pass runs of ``"flash"`` before it: every K5c of the ViT's dtype
    once per layer and step, no dK/dV or dQ kernel; the final poses within
    twice the card's own spread of the two-pass run's (two runs of the
    two-pass setting measure it), and never below the floors above."""
    from dynhor_tpu_torch.models.dino import DinoConfig

    splash = DinoConfig(attn_impl="splash", splash_fused_bwd=True)
    for dtype, steps, ref, floor in (("bfloat16", STEPS, two_pass, BF16_POSE_SPREAD),
                                     ("float32", 2, two_pass_f32, F32_POSE_SPREAD)):
        run = phase_main(dev, sc, card, kernel_rows, splash, dtype, steps)
        spread = pose_diff(ref, ref["again"])
        diff = pose_diff(run, ref)
        tol = max(2 * spread, floor)
        print(f"[main splash fused-bwd] {dtype}, {steps} steps: {run['ms_step']:.2f} ms/step "
              f"against the two-pass {ref['ms_step']:.2f}, peak {run['peak_gib']:.2f} against "
              f"{ref['peak_gib']:.2f} GiB; final poses differ from the two-pass run's by "
              f"{diff:.3g}, two two-pass runs by {spread:.3g} (limit {tol:.3g}) — {card}",
              flush=True)
        check(diff <= tol, f"fused-bwd refine ({dtype}) poses {diff} from the two-pass run's, "
              f"more than {tol}")


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


def small_vit(attn_impl: str, dtype: str = "bfloat16", fused: bool = False):
    """The small scenes' ViT: (config, parameters, dtype name, width).  With
    the written-out attention a tiny f32 one (head dim 16).  K5 takes head
    dim 64 only, so the flash variant is two heads of 64, in ``dtype``, with
    the attention's layer scale raised from the random init's 1e-5 to 1 so
    that what K5 computes reaches the tokens; ``fused`` sets
    ``splash_fused_bwd``."""
    from dynhor_tpu_torch.models import dino as D

    width = 32 if attn_impl == "xla" else 128
    dcfg = D.DinoConfig(patch_size=8, embed_dim=width, depth=2, num_heads=2, pos_grid=4,
                        smaller_edge_size=32, attn_impl=attn_impl, splash_fused_bwd=fused)
    params = D.init_params(dcfg, torch.Generator().manual_seed(3))
    if attn_impl != "xla":
        params["blocks"]["ls1"] = torch.ones_like(params["blocks"]["ls1"])
    return dcfg, params, "float32" if attn_impl == "xla" else dtype, width


def phase_small_reference(dev, attn_impl: str = "xla", dtype: str = "bfloat16",
                          fused: bool = False) -> None:
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
    v, f = torch.tensor(BOX_V), torch.tensor(BOX_F)
    texture = torch.rand((4, 4, 3), generator=torch.Generator().manual_seed(2))
    mesh = RF.MeshArrays(v, f, torch.full((12, 3, 2), 0.5), texture)
    R = G.rotations_from_uniforms(torch.tensor([[0.1, 0.7], [0.4, 0.2], [0.8, 0.5]]))
    t = torch.tensor([[0.0, 0.0, 2.0], [0.05, -0.03, 2.1]])
    K = torch.tensor([[float(s), 0, s / 2], [0, float(s), s / 2], [0, 0, 1.0]])
    vp = RZ.project_perspective(v @ R + t[:, None], K)
    masks = (RZ.rasterize(vp, f, (s, s), face_chunk=12).pix_to_face >= 0).float()
    dcfg, params, dtype, width = small_vit(attn_impl, dtype, fused)
    gt = torch.randn((2, 16, width), generator=torch.Generator().manual_seed(4))
    targets = RF.FrameTargets(masks, gt, K.expand(2, 3, 3))
    cfg = RF.RefineConfig(num_iterations=3, crop_size=s, mode="fine", dino_dtype=dtype,
                          max_active_tiles=8)
    noise = 0.05 * torch.randn((2, 3, 2), generator=torch.Generator().manual_seed(5))
    R0 = G.rot6d_to_matrix(G.matrix_to_rot6d(R) + noise)
    reset_launches()
    r_dev = RF.refine_poses(mesh, targets, R0, t + 0.03, params, dcfg, cfg, device=dev)
    fwd, bwd = k5_per_step(dcfg, cfg)
    check_k5_launches(read_launches(), fwd * 3, bwd * 3, f"small refine {attn_impl}", dtype,
                      fused)
    r_cpu = RF.refine_poses(mesh, targets, R0, t + 0.03, params, dcfg, cfg, device="cpu")
    errs = {
        k: float((a.cpu() - b).abs().max())
        for k, a, b in zip(("rot6d", "trans", "loss", "iou"), r_dev[:4], r_cpu[:4])
    }
    print(f"[small {attn_impl}{' fused-bwd' if fused else ''}] refine_poses 3 steps, {dtype} "
          f"ViT, card vs CPU max abs err: "
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
    v, f = torch.tensor(BOX_V), torch.tensor(BOX_F)
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


def depth_pair_work(rows_all, indices, counts, tiles_w) -> tuple[int, int]:
    """(visible, inside) pixel-slot pairs of K3's input: pairs of a pixel
    and a slot below the tile's count whose face is visible, and those of
    them whose face covers the pixel (the plain version's inside test)."""
    from dynhor_tpu_torch.ops import raster_fused as RFU

    b, t_rows, m = indices.shape
    px, py = RFU._tile_pixels(t_rows, TILE, tiles_w, rows_all.device)
    slot = torch.arange(m, device=rows_all.device)
    visible = inside = 0
    for s in range(0, int(counts.max()), 128):
        idx = indices[:, :, s : s + 128].long()
        c = idx.shape[2]
        r = torch.gather(rows_all, 1, idx.reshape(b, -1, 1).expand(-1, -1, 16))
        r = r.reshape(b, t_rows, 1, c, 16)
        live = (slot[s : s + c] < counts[..., None])[:, :, None, :] & (r[..., 6] > 0.5)
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
        rows_all, indices, counts, tw, _ = RFU.depth_inputs(vp, faces, (window, window), TILE, cap)
        args = (rows_all, indices, counts, TILE, tw, 1e-2)
        zmin, jbest = kernels.depth_fwd(*args)
        zmin_p, jbest_p = RFU.tile_depth_plain(*args)
        torch.cuda.synchronize()
        hit = zmin_p < 1.5e38
        same_hit = bool((hit == (zmin < 1.5e38)).all())
        z_err = float((zmin - zmin_p)[hit].abs().max()) if bool(hit.any()) else 0.0
        n_mism = int((hit & (jbest != jbest_p)).sum())
        pairs = int(counts.sum())
        b, t_rows, m = indices.shape
        ms = cuda_ms(lambda: kernels.depth_fwd(*args))
        plain_ms = cuda_ms(lambda: RFU.tile_depth_plain(*args), reps=3)
        vis_pairs, in_pairs = depth_pair_work(rows_all, indices, counts, tw)
        ops = vis_pairs * OPS_PER_PAIR["K3"] + in_pairs * K3_OPS_INSIDE
        # Read once: the per-face records, the face ids below each count and
        # the counts; written: depth and slot per pixel.
        nbytes = rows_all.numel() * 4 + pairs * 4 + b * t_rows * 4 + b * t_rows * TILE * TILE * 8
        t_ops, t_bytes = ops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        busy = counts[counts > 0].float()
        print(
            f"[k3] {stage}: {n_views} views, window {window} ({t_rows} tiles), counted cap "
            f"{cap}, indices {tuple(indices.shape)} into records {tuple(rows_all.shape)}; "
            f"sum(counts) {pairs} face-tile pairs, max count {int(counts.max())}, mean "
            f"{pairs / (b * t_rows):.1f} per tile ({float(busy.mean()) if busy.numel() else 0.0:.1f} "
            f"over the {busy.numel()} non-empty), "
            f"{int(((counts.long() + kernels.MASS_CHUNK - 1) // kernels.MASS_CHUNK).sum())} work "
            f"items of {kernels.MASS_CHUNK} slots; hit masks equal {same_hit}, pix_to_face "
            f"mismatches {n_mism} over {int(hit.sum())} hit pixels, zbuf max abs err {z_err:.3g}",
            flush=True,
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
        check(z_err == 0.0, f"K3 zbuf error {z_err} != 0 ({stage})")
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
        self.fn, self.calls, self.peaks = fn, [], []

    def __call__(self, *args, **kw):
        out, sec = wall(lambda: self.fn(*args, **kw))
        self.calls.append((int(args[6].shape[0]), sec))
        # The peak since phase_priors reset it: after the first stage, the
        # prescreen's own.
        self.peaks.append(torch.cuda.max_memory_allocated())
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
        f"{peak / 2**30:.2f} GiB allocated (prescreen {stages.peaks[0] / 2**30:.3f} GiB) — {card}",
        flush=True,
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
    fwd, bwd = k5_per_step(dcfg, rcfg)
    check_k5_launches(rl, fwd * 2, bwd * 2, "chained refine")
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
            if any(k in name for k in ("depth_fwd_kernel", "depth_merge_kernel",
                                       "chunk_prefix_kernel")):
                key = "K3"  # with its work list's pre-pass and merge pass
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


class _Tee(io.TextIOBase):
    """Writes to the real stdout and keeps a copy to parse."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, text):
        self.out.write(text)
        self.buf.write(text)
        return len(text)

    def flush(self):
        self.out.flush()


class _Peak:
    """Wraps a function to record the device's peak memory during each call
    (installed as its module's global, which the caller looks up at call
    time); ``before`` keeps the peak reached before the first call."""

    def __init__(self, fn):
        self.fn, self.peaks, self.before = fn, [], 0

    def __call__(self, *args, **kw):
        torch.cuda.synchronize()
        self.before = max(self.before, torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        out = self.fn(*args, **kw)
        torch.cuda.synchronize()
        self.peaks.append(torch.cuda.max_memory_allocated())
        return out


def view_chunks(n: int, chunk: int, host_batch: int = 1000) -> int:
    """K3 launches of one scoring call: a chunk at a time within each host
    batch (tracker/priors.prior_scores_batched)."""
    return sum(-(-min(host_batch, n - i) // chunk) for i in range(0, n, host_batch))


def check_run_output(text: str, exp: str) -> tuple[dict, list]:
    """What one ``python -m dynhor_tpu_torch.run`` printed and wrote: every
    phase's seconds, no overflow, the closing line, the voting's line, and
    the experiment's artifacts (RUN_FRAMES pose files with orthonormal R,
    board/ with an events file, config.yaml).  Returns (phase seconds,
    outliers)."""
    secs = {k: float(v) for k, v in re.findall(r"\[profile\] ([^:\n]+): ([\d.]+)s", text)}
    want = {"host preprocessing", "frame-features", "prior-scoring", "gating+autodepth",
            "refine", "joint-opt", "outlier-voting"}
    check(want <= set(secs), f"phase seconds missing: {sorted(want - set(secs))}")
    check("overflow" not in text, "a raster overflowed its counted cap in the run")
    lines = text.strip().splitlines()
    check(lines[-1].startswith(f"tracked {RUN_FRAMES} frames; final joint loss"),
          f"closing line {lines[-1]!r}")
    found = re.search(r"outlier voting: .* outliers=\[([\d, ]*)\]", text)
    check(found is not None, "outlier voting did not run")
    outliers = [int(x) for x in found.group(1).split(",") if x.strip()]

    npzs = sorted(os.listdir(os.path.join(exp, "obj_infos")))
    check(npzs == [f"{i:04d}.npz" for i in range(RUN_FRAMES)], f"pose files {npzs}")
    for name in npzs:
        d = np.load(os.path.join(exp, "obj_infos", name))
        check(set(d.files) == {"R", "T", "K"}, f"{name} keys {d.files}")
        R, T, K = d["R"], d["T"], d["K"]
        check(R.shape == (3, 3) and T.shape == (3,) and K.shape == (3, 3), f"{name} shapes")
        check(all(np.isfinite(x).all() for x in (R, T, K)), f"{name} not finite")
        check(np.abs(R @ R.T - np.eye(3)).max() <= 1e-4, f"{name}: R not orthonormal")
    board = os.listdir(os.path.join(exp, "board"))
    check(any(n.startswith("events.out.tfevents") for n in board), f"board/ holds {board}")
    check(os.path.exists(os.path.join(exp, "config.yaml")), "no config.yaml")
    return secs, outliers


def phase_run(dev, card: str, kernel_rows: list[dict], tmp: str) -> dict:
    """Phase 6: ``python -m dynhor_tpu_torch.run`` at full width on the card,
    then the voting and re-joint on the run's poses with one frame moved off.
    The sequence and the experiment stay in ``tmp`` for phases 7 and 7b;
    returns their paths and the run's K3 launches."""
    import yaml

    from dynhor_tpu_torch import run as RUN
    from dynhor_tpu_torch.io.config import DEFAULTS
    from dynhor_tpu_torch.tools import make_demo_data as MD
    from dynhor_tpu_torch.tracker import outliers as OV
    from dynhor_tpu_torch.tracker import priors as TP

    seq_dir, exps = os.path.join(tmp, "custom_shoes"), os.path.join(tmp, "exps")
    _, t_data = wall(lambda: MD.write_sequence(
        seq_dir, SHOES, frames=RUN_FRAMES, height=RUN_HW[0], width=RUN_HW[1], seed=0,
        device=dev, verbose=False,
    ))
    user = {"seq_name": "custom_shoes",
            "data_info": {"dataroot": seq_dir, "obj_path": os.path.abspath(SHOES)}}
    cfg_path = os.path.join(tmp, "custom_shoes.yaml")
    with open(cfg_path, "w") as fh:
        yaml.safe_dump(user, fh)
    route = "python -m dynhor_tpu_torch.run (its main, from a YAML file)"

    def run():
        return RUN.main(["--config_path", cfg_path, "--exps_root", exps])
    print(f"[run] {RUN_FRAMES} frames at {RUN_HW[0]}x{RUN_HW[1]} written by the demo-data "
          f"twin in {t_data:.3f} s; running {route}", flush=True)
    stages, voting = _Stages(TP.prior_scores_batched), _Peak(OV.vote_outliers)
    tee = _Tee(sys.stdout)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    TP.prior_scores_batched, OV.vote_outliers = stages, voting
    try:
        with contextlib.redirect_stdout(tee):
            result, t_run = wall(run)
    finally:
        TP.prior_scores_batched, OV.vote_outliers = stages.fn, voting.fn
    launches = read_launches()
    peak = max([voting.before, torch.cuda.max_memory_allocated()] + voting.peaks)
    text = tee.buf.getvalue()

    exp = os.path.join(exps, "custom_shoes", "pred")
    secs, outliers = check_run_output(text, exp)

    check(len(stages.calls) == 2, f"two-stage scoring made {len(stages.calls)} scoring calls")
    (n_lo, t_lo), (n_hi, t_hi) = stages.calls
    pc = DEFAULTS["system"]["prior"]
    chunks = view_chunks(n_lo, pc["view_chunk"] * pc["prescreen"]["scale"], pc["host_batch"])
    chunks += view_chunks(n_hi, pc["view_chunk"], pc["host_batch"])
    check(launches["K3"] == chunks, f"K3 launched {launches['K3']} times for {chunks} view chunks")
    sysc = DEFAULTS["system"]
    steps = sysc["init_num_iterations"] + sysc["joint_num_iterations"]
    steps += sysc["joint_num_iterations"] // 2 if outliers else 0
    check(launches["K1"] == launches["K2"] == steps,
          f"K1/K2 launched {launches['K1']}/{launches['K2']} times for {steps} steps")
    check_default_vit_k5(launches, sysc["init_num_iterations"], "run.py")
    others = {k: n for k, n in launches.items() if k not in ("K1", "K2", "K3", *K5_KEYS) and n}
    check(not others, f"kernels off this path launched: {others}")
    gt = np.load(os.path.join(seq_dir, "gt_poses.npz"))
    from dynhor_tpu_torch.utils import geometry as G

    # Object-to-camera (column) rotations against GT's, a frame at a time, as
    # eval_poses reads the saved artifacts.
    ang = torch.cat([G.rotation_angle_difference(
        torch.as_tensor(np.ascontiguousarray(r.T))[None], torch.as_tensor(g)[None])
        for r, g in zip(result.rotations_row, gt["R"])])
    print(
        f"[run] {route}: {t_run:.3f} s wall; phase seconds {secs}; scoring stages "
        f"{n_lo} views in {t_lo:.3f} s, {n_hi} in {t_hi:.3f} s; selected views "
        f"{result.selected_idx.tolist()}; outliers {outliers}; launches K1 {launches['K1']}, "
        f"K2 {launches['K2']}, K3 {launches['K3']} (view chunks {chunks}), K5 forward "
        f"{launches['K5 fwd']}, backward {launches['K5 dq']}; peak "
        f"{peak / 2**30:.2f} GiB allocated, the voting's own "
        f"{max(voting.peaks) / 2**30:.3f} GiB; rotation error against gt_poses.npz "
        f"(random ViT weights) mean {float(ang.mean()):.1f} deg — {card}", flush=True,
    )
    for row in kernel_rows:
        key = row["name"].split()[0]
        if key in ("K1", "K2", "K3"):
            row["launches"] = launches[key]
    phase_rejoint(dev, cfg_path, seq_dir, result)
    return {"seq_dir": seq_dir, "exps": exps, "user": user, "k3": launches["K3"],
            "exp": exp, "rot_deg": ang.cpu().numpy()}


def phase_rejoint(dev, cfg_path: str, seq_dir: str, result) -> None:
    """The voting and its re-joint at full width on the card: phase 6's
    poses with frame RUN_MOVED moved far off, through
    ``maybe_vote_outliers`` with the run's config.  The moved frame is found,
    K1 and K2 launch once per re-joint step and K3 never, and the repaired
    poses are finite and orthonormal.  The re-joint takes JointConfig's
    default caps, as the JAX package does; its overflow, if any, is printed
    (the reference drops those faces too)."""
    from dynhor_tpu_torch.io.config import load_config
    from dynhor_tpu_torch.tracker import pipeline as PL

    config = load_config(cfg_path)
    sysc = config["system"]
    seq = PL.load_sequence(seq_dir)
    ann = PL.process_frames(seq, crop_size=int(sysc["crop_size"]),
                            bbox_expansion=float(sysc["bbox_expansion"]))
    mesh = PL.load_mesh(config["data_info"]["obj_path"],
                        bool(config["data_info"].get("normalize_mesh", True)))
    R, T = result.rotations_row.copy(), result.translations.copy()
    R[RUN_MOVED] = uniform_rotations(1, 9, "cpu")[0].numpy()
    T[RUN_MOVED] = T[RUN_MOVED] + np.array([0.1, -0.05, 0.2], np.float32)
    moved = result._replace(rotations_row=R, translations=T)
    tee = _Tee(sys.stdout)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with contextlib.redirect_stdout(tee):
        fixed, t_fix = wall(lambda: PL.maybe_vote_outliers(config, seq, ann, mesh, moved,
                                                           device=dev))
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    text = tee.buf.getvalue()
    found = re.search(r"outlier voting: .* outliers=\[([\d, ]*)\]", text)
    check(found is not None, "the voting did not run on the moved poses")
    outliers = [int(x) for x in found.group(1).split(",") if x.strip()]
    check(RUN_MOVED in outliers, f"the voting found {outliers}, not the moved frame {RUN_MOVED}")
    steps = sysc["joint_num_iterations"] // 2
    check(launches["K1"] == launches["K2"] == steps and launches["K3"] == 0,
          f"the re-joint launched {launches} for {steps} steps")
    others = {k: n for k, n in launches.items() if k not in ("K1", "K2") and n}
    check(not others, f"kernels off the re-joint's path launched: {others}")
    Rf, Tf = fixed.rotations_row, fixed.translations
    check(np.isfinite(Rf).all() and np.isfinite(Tf).all(), "repaired poses not finite")
    orth = float(np.abs(Rf @ Rf.transpose(0, 2, 1) - np.eye(3)).max())
    check(orth <= 1e-4, f"repaired R not orthonormal ({orth:.3g})")
    check(np.abs(Rf[RUN_MOVED] - R[RUN_MOVED]).max() > 1e-2, "the moved frame was not repaired")
    ov = re.search(r"tile-bin overflow DURING joint optimization \(max (\d+)", text)
    print(f"[run-rejoint] frame {RUN_MOVED} moved off: outliers {outliers}, voting and a "
          f"{steps}-step re-joint in {t_fix:.3f} s, K1/K2 {launches['K1']}/{launches['K2']}, "
          f"K3 {launches['K3']}; peak {peak / 2**30:.2f} GiB; max |R R^T - I| {orth:.3g}; the "
          f"re-joint's most face-tile pairs dropped in a step at the default 640 cap: "
          f"{ov.group(1) if ov else 0}", flush=True)


def phase_run_small(dev) -> None:
    """The e2e test's box through ``track_sequence`` and, with frame 2
    moved far off, ``maybe_vote_outliers``, on the card and on the CPU: the
    same selected views and outliers, poses within RUN_CARD_TOL."""
    from dynhor_tpu_torch.tracker import pipeline as PL

    tmp = tempfile.mkdtemp(prefix="chip_smoke_box_")
    try:
        cfg, seq, ann, mesh, dcfg, params = box_sequence(tmp)
        rots = uniform_rotations(24, 33, "cpu")
        bad = uniform_rotations(1, 9, "cpu")[0].numpy()
        out = {}
        for where in (dev, "cpu"):
            reset_launches()
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                res = PL.track_sequence(cfg, seq, ann, mesh, params, dcfg,
                                        view_rotations=rots, device=where)
                # Frame 2 moved far off, so that the voting repairs it and
                # the re-joint runs.
                R, T = res.rotations_row.copy(), res.translations.copy()
                R[2], T[2] = bad, T[2] + np.array([0.1, -0.05, 0.2], np.float32)
                voted = PL.maybe_vote_outliers(
                    cfg, seq, ann, mesh, res._replace(rotations_row=R, translations=T),
                    device=where,
                )
            found = re.search(r"outliers=\[([\d, ]*)\]", printed.getvalue())
            check(found is not None and "2" in found.group(1).split(", "),
                  f"the small run's voting found outliers {found and found.group(1)}")
            if where == dev:
                rl = read_launches()
                check(rl["K1"] == rl["K2"] == 8 + 10 + 5 and rl["K3"] > 0,
                      f"the small run on the card launched {rl} (8 refine, 10 joint, 5 "
                      "re-joint steps)")
            out[str(where)] = (res, voted, found.group(1))
        (r_dev, v_dev, o_dev), (r_cpu, v_cpu, o_cpu) = out[str(dev)], out["cpu"]
        errs = {
            "init": max(float(np.abs(r_dev.init_rotations_row - r_cpu.init_rotations_row).max()),
                        float(np.abs(r_dev.init_translations - r_cpu.init_translations).max())),
            "final": max(float(np.abs(v_dev.rotations_row - v_cpu.rotations_row).max()),
                         float(np.abs(v_dev.translations - v_cpu.translations).max())),
        }
        print(f"[run-small] box, 4 frames: card vs CPU selected {r_dev.selected_idx.tolist()} vs "
              f"{r_cpu.selected_idx.tolist()}, outliers [{o_dev}] vs [{o_cpu}], max abs pose "
              f"difference after the refine {errs['init']:.3g}, after the joint and voting "
              f"{errs['final']:.3g}", flush=True)
        check(np.array_equal(r_dev.selected_idx, r_cpu.selected_idx),
              "the card and the CPU selected other views")
        check(o_dev == o_cpu, "the card and the CPU found other outliers")
        check(errs["init"] <= RUN_CARD_TOL and errs["final"] <= RUN_CARD_TOL,
              f"card and CPU poses differ by {errs}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


class _Spy:
    """Installs itself as ``module.name`` (which the caller looks up at call
    time) and keeps each call's arguments and result; ``restore`` puts the
    function back."""

    def __init__(self, module, name: str):
        self.module, self.name, self.fn, self.calls = module, name, getattr(module, name), []
        setattr(module, name, self)

    def __call__(self, *args, **kw):
        out = self.fn(*args, **kw)
        self.calls.append((args, kw, out))
        return out

    def restore(self) -> None:
        setattr(self.module, self.name, self.fn)


def multihyp_steps(sysc: dict, outliers: list) -> int:
    """K1/K2 launches of one multi-hypothesis run: K x tournament steps per
    tournament (the first and each propagation round), the winners'
    continuation, the joint and, after a repair, the re-joint."""
    hypc = sysc["hypotheses"]
    k, total = sysc["num_initializations"], sysc["init_num_iterations"]
    t = min(max(int(hypc["tournament_iters"] or total), 1), total)
    steps = k * t * (1 + hypc["propagate_rounds"]) + (total - t) + sysc["joint_num_iterations"]
    return steps + (sysc["joint_num_iterations"] // 2 if outliers else 0)


def phase_multihyp(dev, card: str, tmp: str, run: dict) -> None:
    """Phase 7: ``python -m dynhor_tpu_torch.run`` with
    ``system.num_initializations: MULTIHYP_K`` on phase 6's sequence, the
    default ``hypotheses`` block: the silhouette-IoU matrix, the hypotheses'
    provenance, the winners, K3 once per view chunk (phase 6's count: the
    channel adds no launch), K1 and K2 once per tournament, propagation,
    continuation, joint and re-joint step."""
    import yaml

    from dynhor_tpu_torch import run as RUN
    from dynhor_tpu_torch.io.config import DEFAULTS
    from dynhor_tpu_torch.tracker import priors as TP
    from dynhor_tpu_torch.tracker import refine as RF
    from dynhor_tpu_torch.tracker import selection as SEL

    user = copy.deepcopy(run["user"])
    user["exp_name"] = "multihyp"
    user["system"] = {"num_initializations": MULTIHYP_K}
    cfg_path = os.path.join(tmp, "multihyp.yaml")
    with open(cfg_path, "w") as fh:
        yaml.safe_dump(user, fh)
    stages = _Stages(TP.prior_scores_batched)
    tee = _Tee(sys.stdout)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    TP.prior_scores_batched = stages
    hyps, mh = _Spy(SEL, "build_hypotheses"), _Spy(RF, "refine_poses_multihyp")
    try:
        with contextlib.redirect_stdout(tee):
            result, t_run = wall(lambda: RUN.main(
                ["--config_path", cfg_path, "--exps_root", run["exps"]]))
    finally:
        TP.prior_scores_batched = stages.fn
        hyps.restore()
        mh.restore()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    text = tee.buf.getvalue()
    secs, outliers = check_run_output(text, os.path.join(run["exps"], "custom_shoes", "multihyp"))

    sysc = copy.deepcopy(DEFAULTS["system"])
    sysc["num_initializations"] = MULTIHYP_K
    hypc = sysc["hypotheses"]
    check(len(hyps.calls) == 1 and len(mh.calls) == 1,
          f"build_hypotheses / refine_poses_multihyp called {len(hyps.calls)} / {len(mh.calls)} times")
    sil = hyps.calls[0][1]["sil_scores"]
    check(tuple(sil.shape) == (RUN_FRAMES, PRIOR_VIEWS), f"sil matrix shape {tuple(sil.shape)}")
    check(bool(torch.isfinite(sil).all()) and 0.0 <= float(sil.min()) and float(sil.max()) <= 1.0,
          f"sil matrix out of [0, 1]: {float(sil.min())}..{float(sil.max())}")
    idx = hyps.calls[0][2].indices.numpy()
    check(idx.shape == (RUN_FRAMES, MULTIHYP_K), f"hypotheses {idx.shape}")
    check((idx[:, 1:3] == -1).all() and (idx[:, 3:] >= 0).all() and (idx[:, 0] >= -2).all(),
          f"hypothesis provenance {idx.tolist()}")
    mres = mh.calls[0][2]
    check(bool(torch.isfinite(mres.tournament_loss).all()), "tournament losses not finite")
    line = [ln for ln in text.splitlines() if ln.startswith("[hypotheses]")]
    check(len(line) == 1 and f"{MULTIHYP_K} inits/frame + {hypc['propagate_rounds']} "
          "propagation round(s)" in line[0], f"the [hypotheses] line: {line}")
    (n_lo, _), (n_hi, _) = stages.calls
    pc = sysc["prior"]
    chunks = view_chunks(n_lo, pc["view_chunk"] * pc["prescreen"]["scale"], pc["host_batch"])
    chunks += view_chunks(n_hi, pc["view_chunk"], pc["host_batch"])
    check(launches["K3"] == chunks == run["k3"],
          f"K3 launched {launches['K3']} times for {chunks} view chunks (phase 6: {run['k3']})")
    steps = multihyp_steps(sysc, outliers)
    check(launches["K1"] == launches["K2"] == steps,
          f"K1/K2 launched {launches['K1']}/{launches['K2']} times for {steps} steps")
    check_default_vit_k5(launches, None, "multi-hypothesis run.py")
    others = {k: n for k, n in launches.items() if k not in ("K1", "K2", "K3", *K5_KEYS) and n}
    check(not others, f"kernels off this path launched: {others}")
    sil_np = sil.cpu().numpy()
    print(
        f"[multihyp] num_initializations {MULTIHYP_K}, {RUN_FRAMES} frames at "
        f"{RUN_HW[0]}x{RUN_HW[1]}: {t_run:.3f} s wall; phase seconds {secs}; peak "
        f"{peak / 2**30:.2f} GiB allocated; sil matrix {sil_np.shape} in "
        f"[{sil_np.min():.4f}, {sil_np.max():.4f}], mean {sil_np.mean():.4f}; provenance "
        f"{idx.tolist()}; winners {mres.winner.tolist()}; {line[0]}; outliers {outliers}; "
        f"launches K1 {launches['K1']}, K2 {launches['K2']} ({steps} steps), K3 "
        f"{launches['K3']} (view chunks {chunks}, phase 6 {run['k3']}), K5 forward "
        f"{launches['K5 fwd']}, backward {launches['K5 dq']} — {card}",
        flush=True,
    )


def box_sequence(tmp: str):
    """The e2e test's box (tests/test_pipeline_e2e.py) written by the
    demo-data twin on the CPU: (config, seq, ann, mesh, tiny ViT config,
    params) at its small sizes."""
    from dynhor_tpu_torch.io.config import DEFAULTS
    from dynhor_tpu_torch.models import dino as D
    from dynhor_tpu_torch.tools import make_demo_data as MD
    from dynhor_tpu_torch.tracker import pipeline as PL

    obj = os.path.join(tmp, "box.obj")
    with open(obj, "w") as fh:
        fh.writelines(f"v {x} {y} {z}\n" for x, y, z in BOX_V)
        fh.writelines(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in BOX_F)
    seq_dir = os.path.join(tmp, "seq")
    MD.write_sequence(seq_dir, obj, frames=4, height=120, width=160, device="cpu",
                      verbose=False)
    cfg = copy.deepcopy(DEFAULTS)
    cfg["data_info"].update(dataroot=seq_dir, obj_path=obj, normalize_mesh=False)
    cfg["system"].update(init_num_iterations=8, joint_num_iterations=10, joint_lr=1e-3,
                         crop_size=64, face_chunk=12)
    cfg["system"]["prior"].update(num_views=24, view_chunk=6, render_hw=[96, 96])
    seq = PL.load_sequence(seq_dir)
    ann = PL.process_frames(seq, crop_size=64)
    mesh = PL.load_mesh(obj, normalize=False)
    # Head dim 16, which K5 does not take: the attention written out.
    dcfg = D.DinoConfig(patch_size=8, embed_dim=32, depth=2, num_heads=2, pos_grid=4,
                        smaller_edge_size=32, attn_impl="xla")
    return cfg, seq, ann, mesh, dcfg, D.init_params(dcfg, torch.Generator().manual_seed(3))


def boundary(mask: np.ndarray) -> np.ndarray:
    """Pixels of a (H, W) bool mask with a 4-neighbour of the other value."""
    p = np.pad(mask, 1, mode="edge")
    nb = [p[:-2, 1:-1], p[2:, 1:-1], p[1:-1, :-2], p[1:-1, 2:]]
    return np.any([n != mask for n in nb], axis=0)


def phase_multihyp_small(dev, card: str) -> None:
    """Phase 7's box: ``track_sequence`` with ``num_initializations``
    MULTIHYP_K in grid mode (24 views, 3 tournament steps of 8), on the card
    and on the CPU: the same sil matrix and hypotheses, the tournament
    losses within BOX_LOSS_RTOL, the same winners wherever the best loss
    beats the runner-up by more, and poses within RUN_CARD_TOL or
    BOX_SPREAD x the CPU's own spread, whichever is larger: the CPU run
    again with the ViT's weights perturbed by a relative 1e-6 (the bf16
    refine of this scene moves its poses by ~1e-3 under that).  Then phase
    7b's ``Visualizer.draw_mesh`` of the tracked poses over the box's
    frames, card against CPU: the overlay masks agree except on
    silhouette-boundary pixels, whose count is printed."""
    from dynhor_tpu_torch.models import dino as D
    from dynhor_tpu_torch.tracker import pipeline as PL
    from dynhor_tpu_torch.tracker import refine as RF
    from dynhor_tpu_torch.tracker import selection as SEL
    from dynhor_tpu_torch.visualizer import Visualizer

    tmp = tempfile.mkdtemp(prefix="chip_smoke_box_multihyp_")
    try:
        cfg, seq, ann, mesh, dcfg, params = box_sequence(tmp)
        cfg["random_render"] = False
        cfg["system"]["prior"]["grid"] = [11, 2, 1]  # (11 * 2 + 2) * 1 = 24 views
        cfg["system"]["num_initializations"] = MULTIHYP_K
        cfg["system"]["hypotheses"]["tournament_iters"] = 3
        gen = torch.Generator().manual_seed(7)
        nudged = D.map_params(params, lambda a: a * (1 + 1e-6 * torch.randn(a.shape, generator=gen)))
        out = {}
        for tag, where, p in ((str(dev), dev, params), ("cpu", "cpu", params),
                              ("cpu nudged", "cpu", nudged)):
            reset_launches()
            hyps, mh = _Spy(SEL, "build_hypotheses"), _Spy(RF, "refine_poses_multihyp")
            try:
                with contextlib.redirect_stdout(io.StringIO()):
                    res = PL.track_sequence(cfg, seq, ann, mesh, p, dcfg, device=where)
            finally:
                hyps.restore()
                mh.restore()
            if where == dev:
                rl = read_launches()
                steps = multihyp_steps(cfg["system"], [])
                check(rl["K1"] == rl["K2"] == steps and rl["K3"] > 0,
                      f"the box's multi-hypothesis run launched {rl} for {steps} steps")
            out[tag] = (res, hyps.calls[0][1]["sil_scores"].cpu(), hyps.calls[0][2],
                        mh.calls[0][2])

        def pose_diff(a, b):
            return max(float(np.abs(getattr(a, k) - getattr(b, k)).max()) for k in (
                "rotations_row", "translations", "init_rotations_row", "init_translations"))

        (r_d, sil_d, h_d, m_d), (r_c, sil_c, h_c, m_c) = out[str(dev)], out["cpu"]
        err, spread = pose_diff(r_d, r_c), pose_diff(r_c, out["cpu nudged"][0])
        l_d, l_c = m_d.tournament_loss.cpu(), m_c.tournament_loss
        loss_rel = float(((l_d - l_c).abs() / l_c.abs()).max())
        top2 = torch.sort(l_c, dim=1).values[:, :2]
        decided = (top2[:, 1] - top2[:, 0]) > BOX_LOSS_RTOL * top2[:, 0].abs()
        tol = max(RUN_CARD_TOL, BOX_SPREAD * spread)
        print(f"[multihyp-small] box, 4 frames, K {MULTIHYP_K}, grid of 24: card vs CPU "
              f"provenance {h_d.indices.tolist()} vs {h_c.indices.tolist()}, winners "
              f"{m_d.winner.tolist()} vs {m_c.winner.tolist()} (near-tie frames "
              f"{torch.nonzero(~decided).flatten().tolist()}), sil matrices equal "
              f"{torch.equal(sil_d, sil_c)}, largest relative tournament-loss difference "
              f"{loss_rel:.3g}; max abs pose difference {err:.3g}, the CPU's own under a 1e-6 "
              f"weight nudge {spread:.3g} (bound {tol:.3g})", flush=True)
        check(torch.equal(sil_d, sil_c), "the sil matrices differ between card and CPU")
        check(torch.equal(h_d.indices, h_c.indices) and torch.equal(h_d.rotations, h_c.rotations),
              "the hypotheses differ between card and CPU")
        check(loss_rel <= BOX_LOSS_RTOL, f"tournament losses differ by {loss_rel} relative")
        check(torch.equal(m_d.winner[decided], m_c.winner[decided]),
              "the decided winners differ between card and CPU")
        check(err <= tol, f"card and CPU poses differ by {err} > {tol}")

        # Phase 7b's overlay, card against CPU, on the tracked poses.
        h, w = seq.obj_masks.shape[1:]
        K = r_d.K
        cam = (float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2]))
        vis = Visualizer((h, w))
        n_diff, n_hit, col_err = 0, 0, 0.0
        for i in range(len(seq.frame_ids)):
            verts_cam = mesh.verts @ r_d.rotations_row[i] + r_d.translations[i]
            img = seq.images[i].astype(np.float32) / 255.0
            o_d, m_d_ = vis.draw_mesh(img, verts_cam, mesh.faces, cam, True, device=dev)
            o_c, m_c_ = vis.draw_mesh(img, verts_cam, mesh.faces, cam, True, device="cpu")
            diff = m_d_[..., 0] != m_c_[..., 0]
            check(not (diff & ~boundary(m_c_[..., 0])).any(),
                  f"frame {i}: overlay masks differ inside the silhouette")
            both = m_d_[..., 0] & m_c_[..., 0]
            n_diff, n_hit = n_diff + int(diff.sum()), n_hit + int(m_c_.sum())
            col_err = max(col_err, float(np.abs(o_d - o_c)[both].max()))
        print(f"[vis-small] Visualizer.draw_mesh of the box's 4 tracked frames, card vs CPU: "
              f"{n_diff} of {n_hit} overlay pixels differ (all on the silhouette's boundary); "
              f"max abs colour difference where both hit {col_err:.3g}", flush=True)
        check(n_hit > 0 and col_err <= 1e-4, f"overlay colours differ by {col_err}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_vis(dev, card: str, run: dict) -> None:
    """Phase 7b: ``python -m dynhor_tpu_torch.vis`` (its main, in this
    process) on phase 6's experiment: RUN_FRAMES overlays at RUN_HW, each
    with a non-empty overlay mask (read through a wrapper of
    ``Visualizer.draw_mesh``), no kernel launched (the dense plain
    raster)."""
    from PIL import Image

    from dynhor_tpu_torch import vis as VIS
    from dynhor_tpu_torch import visualizer as VZ

    real = VZ.Visualizer.draw_mesh
    hits = []

    def draw_mesh(self, *args, **kw):
        out, mask = real(self, *args, return_mask=True, **kw)
        hits.append(int(mask.sum()))
        return out

    reset_launches()
    VZ.Visualizer.draw_mesh = draw_mesh
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            written, t_vis = wall(lambda: VIS.main([
                "--config_path", os.path.join(run["exp"], "config.yaml"),
                "--exps_root", run["exps"]]))
    finally:
        VZ.Visualizer.draw_mesh = real
    launches = {k: n for k, n in read_launches().items() if n}
    names = sorted(os.path.basename(p) for p in written)
    check(names == [f"{i:04d}.jpg" for i in range(RUN_FRAMES)], f"overlays {names}")
    for p in written:
        shape = np.asarray(Image.open(p)).shape
        check(shape == (*RUN_HW, 3), f"{p}: shape {shape}")
    check(len(hits) == RUN_FRAMES and min(hits) > 0, f"overlay mask pixels {hits}")
    check(not launches, f"vis launched kernels: {launches}")
    print(f"[vis] python -m dynhor_tpu_torch.vis on phase 6's experiment: {len(written)} "
          f"overlays at {RUN_HW[0]}x{RUN_HW[1]} in {t_vis:.3f} s ({t_vis / len(written) * 1e3:.1f} "
          f"ms each); overlay mask pixels {hits} — {card}", flush=True)


KETTLE = "assets/kettle/kettle.obj"
# Phase 8's small scene, card against CPU: tests/test_multiseq.py's two
# boxes pooled, coarse mode on the fused raster (K1/K2 on the card, their
# plain versions on the CPU), 5 steps; poses within RUN_CARD_TOL.
MULTI_BOX_STEPS = 5
# Phase 8's depth, cut from the defaults to fit the script's time: prior
# views a sequence (6,000; the one-stage scoring took 86 of the phase's
# 167 s) and refine steps of each pooled group (100; 69 s).
MULTI_VIEWS = 2000
MULTI_REFINE_STEPS = 50


def phase_multi(dev, card: str, tmp: str, run: dict) -> None:
    """Phase 8: ``python -m dynhor_tpu_torch.run_multi`` (its main, in this
    process) at full width: phase 6's 12-frame shoes sequence and a 12-frame
    kettle sequence from the demo-data twin, the ``io/config.py`` defaults
    but MULTI_VIEWS prior views a sequence and MULTI_REFINE_STEPS refine
    steps (depth cut from 6,000 and 100), the frames pooled (24 frames,
    groups of 16, the second padded by 8).
    Checks both sequences' artifacts, the counted caps and overflow it
    prints, K1/K2 once per step of each refine group and of each joint, K3
    once per view chunk of each scoring call; prints the seconds per phase,
    the peak memory, the caps of each sequence's frames in the pooled batch,
    and K1/K2's times at the pooled cap.  Returns the sequences ({name:
    (directory, mesh)}) for phase 10."""
    import yaml

    from dynhor_tpu_torch import kernels
    from dynhor_tpu_torch import run_multi as RM
    from dynhor_tpu_torch.io.config import DEFAULTS
    from dynhor_tpu_torch.ops import raster_fused as RFU
    from dynhor_tpu_torch.ops.rasterize import project_perspective
    from dynhor_tpu_torch.parallel import multiseq as MS
    from dynhor_tpu_torch.tools import make_demo_data as MD
    from dynhor_tpu_torch.tracker import priors as TP

    kettle_dir = os.path.join(tmp, "custom_kettle")
    _, t_data = wall(lambda: MD.write_sequence(
        kettle_dir, KETTLE, frames=RUN_FRAMES, height=RUN_HW[0], width=RUN_HW[1], seed=0,
        device=dev, verbose=False,
    ))
    seqs = {"custom_shoes": (run["seq_dir"], SHOES), "custom_kettle": (kettle_dir, KETTLE)}
    paths = []
    for name, (root, obj) in seqs.items():
        path = os.path.join(tmp, f"{name}_multi.yaml")
        with open(path, "w") as fh:
            yaml.safe_dump({"seq_name": name, "exp_name": "multi",
                            "data_info": {"dataroot": root, "obj_path": os.path.abspath(obj)},
                            "system": {"init_num_iterations": MULTI_REFINE_STEPS,
                                       "prior": {"num_views": MULTI_VIEWS}}}, fh)
        paths.append(path)
    print(f"[multi] kettle sequence ({RUN_FRAMES} frames at {RUN_HW[0]}x{RUN_HW[1]}) written by "
          f"the demo-data twin in {t_data:.3f} s; running python -m dynhor_tpu_torch.run_multi "
          f"(its main) on shoes and kettle", flush=True)
    stages, pooled = _Stages(TP.prior_scores_batched), _Spy(MS, "refine_poses_multi")
    tee = _Tee(sys.stdout)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    TP.prior_scores_batched = stages
    try:
        with contextlib.redirect_stdout(tee):
            res, t_run = wall(lambda: RM.main(["--config_paths", *paths, "--exps_root",
                                               run["exps"]]))
    finally:
        TP.prior_scores_batched = stages.fn
        pooled.restore()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    text = tee.buf.getvalue()

    sysc = dict(DEFAULTS["system"], init_num_iterations=MULTI_REFINE_STEPS)
    n_pool = len(seqs) * RUN_FRAMES
    groups = -(-n_pool // MS.FRAMES_PER_CARD)
    for name in seqs:
        exp = os.path.join(run["exps"], name, "multi")
        npzs = sorted(os.listdir(os.path.join(exp, "obj_infos")))
        check(npzs == [f"{i:04d}.npz" for i in range(RUN_FRAMES)], f"{name}: pose files {npzs}")
        for fname in npzs:
            d = np.load(os.path.join(exp, "obj_infos", fname))
            R, T = d["R"], d["T"]
            check(np.isfinite(R).all() and np.isfinite(T).all(), f"{name} {fname} not finite")
            check(np.abs(R @ R.T - np.eye(3)).max() <= 1e-4, f"{name} {fname}: R not orthonormal")
        board = os.listdir(os.path.join(exp, "board"))
        check(any(n.startswith("events.out.tfevents") for n in board), f"{name} board/ {board}")
        check(os.path.exists(os.path.join(exp, "config.yaml")), f"{name}: no config.yaml")
        check(re.search(rf"{name}: joint iou [\d.]+ -> ", text) is not None,
              f"{name}: no joint line")
    found = re.search(r"per-tile face cap (\d+), active-tile cap (\w+) \(counted; worst tile "
                      r"(\d+) faces", text)
    check(found is not None and int(found.group(1)) == res.cap,
          f"the printed pooled cap {found and found.groups()} is not the run's {res.cap}")
    check(res.refine.max_overflow == 0 and "WARNING" not in text,
          f"the pooled run overflowed (max {res.refine.max_overflow})")
    check(len(stages.calls) == len(seqs), f"{len(stages.calls)} scoring calls for {len(seqs)}")
    pc = sysc["prior"]
    chunks = sum(view_chunks(n, pc["view_chunk"], pc["host_batch"]) for n, _ in stages.calls)
    check(launches["K3"] == chunks, f"K3 launched {launches['K3']} times for {chunks} view chunks")
    steps = groups * sysc["init_num_iterations"] + len(seqs) * sysc["joint_num_iterations"]
    check(launches["K1"] == launches["K2"] == steps,
          f"K1/K2 launched {launches['K1']}/{launches['K2']} times for {steps} steps")
    check_default_vit_k5(launches, groups * sysc["init_num_iterations"], "run_multi")
    others = {k: n for k, n in launches.items() if k not in ("K1", "K2", "K3", *K5_KEYS) and n}
    check(not others, f"kernels off this path launched: {others}")

    # The caps of each sequence's frames in the pooled batch, and K1/K2 on
    # the first group's rows at the pooled cap: held against their plain
    # versions, then timed.
    (batch, rot, trans, *_), _, _ = pooled.calls[-1]  # the outer call ends last
    per_seq = {}
    for s, name in enumerate(seqs):
        sel = torch.as_tensor(np.nonzero(batch.seq_id == s)[0])
        per_seq[name] = MS.pooled_caps(MS._frames(batch, sel), rot[sel.to(dev)],
                                       trans[sel.to(dev)], CROP, SIGMA)[:3]
    g = MS.FRAMES_PER_CARD
    vp = project_perspective(
        batch.mesh_verts[:g] @ rot[:g] + trans[:g].reshape(-1, 1, 3), batch.targets.K_rois[:g])
    rows, counts, tw = RFU.kernel_inputs(vp, batch.mesh_faces[:g], (CROP, CROP), SIGMA, TILE,
                                         res.cap, max_active_tiles=res.act_cap)
    gen = torch.Generator(device="cpu").manual_seed(1)
    cot = torch.randn((rows.shape[0], rows.shape[1], TILE * TILE), generator=gen).to(dev)
    errs = check_k1_k2(rows, counts, tw, cot, "multi")
    k1_ms = cuda_ms(lambda: kernels.fused_fwd(rows, counts, TILE, tw, SIGMA, 1e-2))
    k2_ms = cuda_ms(lambda: kernels.sil_bwd(rows, counts, cot, TILE, tw, SIGMA))
    print(
        f"[multi] python -m dynhor_tpu_torch.run_multi, {len(seqs)} sequences, {n_pool} pooled "
        f"frames in {groups} groups of {g}: {t_run:.3f} s wall; phase seconds {res.seconds}; "
        f"scoring calls {[(n, round(t, 3)) for n, t in stages.calls]} (views, s); pooled cap "
        f"{res.cap} (worst tile {res.worst_load} faces before the 1.5 headroom), active-tile "
        f"cap {res.act_cap}; caps of each sequence's frames in the pooled batch (cap, "
        f"active-tile cap, worst tile) {per_seq}; K1/K2 at the pooled cap on the first group's "
        f"rows {tuple(rows.shape)}: {k1_ms:.4f} / {k2_ms:.4f} ms, against plain zbuf "
        f"{errs['zbuf']:.3g}, sil {errs['sil']:.3g}, pix_to_face mismatches {errs['p2f']}, "
        f"d(xy) {errs['dxy']:.3g} (max {errs['dxy_max']:.3g}); launches K1 {launches['K1']}, "
        f"K2 {launches['K2']} ({steps} steps), K3 {launches['K3']} (view chunks {chunks}); peak "
        f"{peak / 2**30:.2f} GiB allocated — {card}", flush=True,
    )
    return seqs


def phase_multi_small(dev) -> None:
    """tests/test_multiseq.py's two boxes pooled (4 frames each, 32²),
    ``refine_poses_multi`` in coarse mode on the fused raster for
    MULTI_BOX_STEPS steps, on the card (K1/K2 once per step) and on the
    CPU (their plain versions): poses within RUN_CARD_TOL."""
    from dynhor_tpu_torch.ops import rasterize as RZ
    from dynhor_tpu_torch.parallel import multiseq as MS
    from dynhor_tpu_torch.tracker import refine as RF
    from dynhor_tpu_torch.utils import geometry as G
    from dynhor_tpu_torch.utils.objio import MeshData

    size = 32
    K = torch.tensor([[size, 0, size / 2], [0, size, size / 2], [0, 0, 1.0]])
    meshes, targets, rots = [], [], []
    for s, (scale, extra) in enumerate(((1.0, 0), (0.7, 3))):
        v = scale * np.array(BOX_V, np.float32)
        v = np.concatenate([v, np.tile(v[:1], (extra, 1))])
        m = MeshData(verts=v, faces=np.array(BOX_F, np.int32),
                     face_uvs=np.full((12, 3, 2), 0.5, np.float32),
                     texture=np.full((2, 2, 3), 0.6, np.float32), has_texture=False)
        rot = uniform_rotations(4, 40 + s, "cpu")
        vp = RZ.project_perspective(torch.as_tensor(v) @ rot + torch.tensor([0.0, 0.0, 2.0]), K)
        masks = (RZ.rasterize(vp, torch.as_tensor(m.faces), (size, size), face_chunk=12)
                 .pix_to_face >= 0).float()
        meshes.append(m)
        targets.append(RF.FrameTargets(masks, torch.zeros((4, 4, 8)), K.expand(4, 3, 3)))
        rots.append(rot)
    c, s_ = np.cos(0.08), np.sin(0.08)
    nudge = torch.tensor([[c, -s_, 0.0], [s_, c, 0.0], [0.0, 0.0, 1.0]], dtype=torch.float32)
    rot0 = torch.cat(rots) @ nudge
    trans0 = torch.tensor([[0.02, -0.01, 2.05]]).expand(8, 3)
    cfg = RF.RefineConfig(num_iterations=MULTI_BOX_STEPS, crop_size=size, mode="coarse",
                          face_chunk=12)
    out = {}
    for where in (dev, "cpu"):
        reset_launches()
        batch = MS.build_batch(meshes, targets, device=where)
        out[str(where)] = MS.refine_poses_multi(batch, rot0, trans0, None, None, cfg,
                                                device=where)
        if where == dev:
            rl = read_launches()
            check(rl["K1"] == rl["K2"] == MULTI_BOX_STEPS,
                  f"the pooled boxes launched K1/K2 {rl['K1']}/{rl['K2']} times in "
                  f"{MULTI_BOX_STEPS} steps")
    a, b = out[str(dev)], out["cpu"]
    err = max(float((a.rot6d.cpu() - b.rot6d).abs().max()),
              float((a.translations.cpu() - b.translations).abs().max()))
    moved = float((b.rot6d - G.matrix_to_rot6d(rot0)).abs().max())
    print(f"[multi-small] two boxes pooled (8 frames, {MULTI_BOX_STEPS} coarse steps on the "
          f"fused raster): card vs CPU max abs pose difference {err:.3g} (the poses moved "
          f"{moved:.3g}); overflow {a.max_overflow} / {b.max_overflow}", flush=True)
    check(a.max_overflow == 0 == b.max_overflow, "the pooled boxes overflowed")
    check(err <= RUN_CARD_TOL, f"card and CPU pooled poses differ by {err}")
    check(moved > 1e-3, "the pooled boxes' poses did not move")


NEUS_FAST = "configs/neus_shoes_fast.yaml"
RECON_STEPS = 1000  # configs/neus_shoes_fast.yaml's 4000, cut to fit the script's time
RECON_WINDOW = (501, 750)  # timed steps: between the occupancy refreshes at 500 and 750
RECON_CHAMFER_MAX = 0.1  # sanity: the initial sphere sits well above it against the shoe
BENCH_NEUS = (("pe", "neus", (1024,)), ("pe", "occgrid", (1024, 4096)),
              ("hash", "occgrid", (1024,)))
NEUS_SMALL = dict(pe_freqs=4, hidden=64, depth=4, skip_layer=2, feat_dim=32, color_hidden=64,
                  color_depth=3)  # tests/test_neus.py's small field
NEUS_TOL = 1e-4  # the CPU tests' tolerance for renders, logs and parameters


class _WindowedStep:
    """Wraps ``neus.trainer.make_train_step`` (looked up by ``train`` at call
    time) so that the step function it returns synchronizes the device before
    step ``RECON_WINDOW[0]`` and after step ``RECON_WINDOW[1] - 1``, and
    records the seconds between."""

    def __init__(self, module):
        self.module, self.fn, self.seconds = module, module.make_train_step, None
        module.make_train_step = self

    def __call__(self, *args, **kw):
        inner = self.fn(*args, **kw)
        lo, hi = RECON_WINDOW

        def step(state, *a, **k):
            if state.step == lo:
                torch.cuda.synchronize()
                self.t0 = time.time()
            logs = inner(state, *a, **k)
            if state.step == hi:
                torch.cuda.synchronize()
                self.seconds = time.time() - self.t0
            return logs

        return step

    def restore(self) -> None:
        self.module.make_train_step = self.fn


def write_gt_poses(seq_dir: str, out: str) -> int:
    """The twin's gt_poses.npz as per-frame {R, T, K} npz files, as
    tools/export_gt_poses.py writes them; returns the frame count."""
    gt = np.load(os.path.join(seq_dir, "gt_poses.npz"))
    os.makedirs(out, exist_ok=True)
    for i in range(gt["R"].shape[0]):
        np.savez(os.path.join(out, f"{i:04d}.npz"), R=gt["R"][i].astype(np.float32),
                 T=gt["T"][i].astype(np.float32), K=gt["K"].astype(np.float32))
    return int(gt["R"].shape[0])


def phase_recon(dev, card: str, tmp: str, run: dict) -> dict:
    """Phase 9a: ``python -m dynhor_tpu_torch.recon`` (its main, in this
    process) at configs/neus_shoes_fast.yaml's recon block on phase 6's
    shoes sequence with its ground-truth poses, ``num_steps`` cut to
    RECON_STEPS.  Prints rays/s over a synchronized window of steps, the
    seconds per phase, the peak memory, the final PSNR and loss, the mesh and
    the Chamfer distance to the shoes mesh; checks finite losses, a falling
    loss, a non-empty mesh from the native library, no kernel launched, and
    the Chamfer under RECON_CHAMFER_MAX."""
    import yaml

    from dynhor_tpu_torch import native
    from dynhor_tpu_torch import recon as REC
    from dynhor_tpu_torch.neus import trainer as TT

    poses = os.path.join(tmp, "gt_obj_infos")
    n_frames = write_gt_poses(run["seq_dir"], poses)
    with open(NEUS_FAST) as fh:
        fast = yaml.safe_load(fh)
    rc = dict(fast["system"]["recon"])
    print(f"[recon] {NEUS_FAST}'s recon block on phase 6's sequence ({n_frames} frames, "
          f"gt poses written as tools/export_gt_poses.py writes them); num_steps cut "
          f"{rc['num_steps']} -> {RECON_STEPS}", flush=True)
    rc.update(num_steps=RECON_STEPS, poses_dir=poses, gt_mesh=os.path.abspath(SHOES))
    cfg = {"seq_name": "custom_shoes", "exp_name": "recon_smoke",
           "data_info": {"dataroot": run["seq_dir"], "obj_path": os.path.abspath(SHOES)},
           "system": {"recon": rc}}
    cfg_path = os.path.join(tmp, "neus_smoke.yaml")
    with open(cfg_path, "w") as fh:
        yaml.safe_dump(cfg, fh)
    window, marching = _WindowedStep(TT), _Spy(native, "marching_tetrahedra_native")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    try:
        res, t_run = wall(lambda: REC.main(["--config_path", cfg_path, "--exps_root",
                                            run["exps"], "--no_resume"]))
    finally:
        window.restore()
        marching.restore()
    peak = torch.cuda.max_memory_allocated()
    launches = read_launches()
    h = res.history
    check(all(np.isfinite(v).all() for v in h.values()), "a recon log is not finite")
    check(h["loss"][-1] < h["loss"][0], f"the recon loss did not fall: {h['loss']}")
    check(len(res.faces) > 0 and len(res.verts) > 0, "the extracted mesh is empty")
    check(len(marching.calls) == 1 and len(marching.calls[0][2][1]) == len(res.faces),
          "the mesh did not come from the native marching library")
    check(res.chamfer is not None and res.chamfer < RECON_CHAMFER_MAX,
          f"Chamfer {res.chamfer} to the shoes mesh is not under {RECON_CHAMFER_MAX}")
    check(not any(launches.values()), f"recon launched kernels of the kernels line: {launches}")
    steps = RECON_WINDOW[1] - RECON_WINDOW[0]
    check(window.seconds is not None, "the timed window of steps did not run")
    rays = steps * int(rc["batch_rays"]) / window.seconds
    print(
        f"[recon] python -m dynhor_tpu_torch.recon, {RECON_STEPS} steps of "
        f"{rc['batch_rays']} rays ({rc['encoder']}, {rc['sampler']}, n_shade "
        f"{rc.get('n_shade', 16)}): {t_run:.3f} s wall; phase seconds "
        f"{ {k: round(v, 3) for k, v in res.seconds.items()} }; steps {RECON_WINDOW[0]}-"
        f"{RECON_WINDOW[1] - 1} synchronized: {1e3 * window.seconds / steps:.3f} ms/step, "
        f"{rays:.1f} rays/s; peak {peak / 2**30:.2f} GiB allocated; final psnr "
        f"{h['psnr'][-1]:.3f} dB, loss {h['loss'][0]:.4f} -> {h['loss'][-1]:.4f}; mesh "
        f"{len(res.verts)} verts / {len(res.faces)} faces at "
        f"{rc['mesh_resolution']}^3 (native library {native.load_marching()._name}); "
        f"Chamfer to the shoes mesh {res.chamfer:.5f}; no kernel launched — {card}",
        flush=True,
    )
    return {"rays_s": rays, "seconds": res.seconds, "chamfer": res.chamfer}


def phase_recon_bench(dev, card: str) -> None:
    """Phase 9b: the bench twin (``tools.bench_neus``): rays/s of a whole
    train step for each (encoder, sampler, batch) of BENCH_NEUS, 3 warm-up
    and 20 timed steps; then the hash encoder's forward and forward +
    backward alone at a step's 65,536 points."""
    from dynhor_tpu_torch.tools import bench_neus as BN

    rows = []
    for enc, sampler, batches in BENCH_NEUS:
        for batch, rps in BN.bench_encoder(enc, batches, steps=20, sampler=sampler,
                                           device=dev).items():
            rows.append((enc, sampler, batch, rps))
    ms_step = 1024 / next(r for e, sm, b, r in rows if (e, sm, b) == ("pe", "occgrid", 1024)) * 1e3
    recon_step_profile(dev, card, ms_step)
    fwd, fwd_bwd = BN.bench_hash_encoder(65536, device=dev)
    print(f"[recon-bench] rays/s of a train step (3 warm-up, 20 timed): "
          f"{[(e, s, b, round(r, 1)) for e, s, b, r in rows]}; hash encoder at 65,536 "
          f"points (16 levels of 2^19 x 2): forward {fwd:.4f} ms, forward + backward "
          f"{fwd_bwd:.4f} ms — {card}", flush=True)
    check(all(np.isfinite(r) and r > 0 for *_, r in rows), "a bench row is not a rate")


def recon_step_profile(dev, card: str, ms_step: float, steps: int = 5) -> None:
    """The device's busy time in a (pe, occgrid, 1024 rays) train step of
    the bench twin's scene, from a ``torch.profiler`` window of ``steps``
    steps after 3 warm-up steps: kernels by group, launches per step, and
    the idle share against the bench's unprofiled ``ms_step``."""
    from torch.profiler import ProfilerActivity, profile

    from dynhor_tpu_torch.neus import trainer as T
    from dynhor_tpu_torch.neus.draws import Key
    from dynhor_tpu_torch.neus.fields import SDFConfig
    from dynhor_tpu_torch.neus.rendering import RenderConfig, occupancy_from_sdf
    from dynhor_tpu_torch.tools import bench_neus as BN

    rcfg, tcfg = RenderConfig(sampler="occgrid"), T.TrainConfig(batch_rays=1024)
    data = BN.synthetic_data(device=dev)
    state = T.init_train_state(Key(0, dev), SDFConfig(), tcfg)
    step = T.make_train_step(rcfg, tcfg)
    occ = occupancy_from_sdf(state.field, rcfg)
    for i in range(3):
        step(state, Key(1, dev).fold_in(i), data, None, occ)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            step(state, Key(1, dev).fold_in(100 + i), data, None, occ)
        torch.cuda.synchronize()
    kernels_ = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels_) / steps / 1e3
    if busy == 0.0:
        print("[recon-profile] device busy time: not measured (the profiler saw no kernels)")
        return
    groups = {"matmul": 0.0, "gather/scatter": 0.0, "sort/scan": 0.0, "other kernels": 0.0}
    for e in kernels_:
        name = e.key.lower()
        if any(k in name for k in ("gemm", "xmma", "cutlass", "nvjet")):
            key = "matmul"
        elif any(k in name for k in ("index", "gather", "scatter")):
            key = "gather/scatter"
        elif any(k in name for k in ("sort", "scan", "radix", "cumsum", "cumprod", "search")):
            key = "sort/scan"
        else:
            key = "other kernels"
        groups[key] += e.self_device_time_total / steps / 1e3
    launches = sum(e.count for e in kernels_) // steps
    print(f"[recon-profile] (pe, occgrid, 1024 rays) step: device busy {busy:.2f} ms/step "
          f"(profiler, kernels only; {launches} kernel launches a step): "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in groups.items())
          + f"; idle share {max(0.0, 1.0 - busy / ms_step):.3f} of the bench's unprofiled "
          f"{ms_step:.2f} ms/step — {card}", flush=True)
    for e in sorted(kernels_, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"[recon-profile]   {e.self_device_time_total / steps / 1e3:8.3f} ms/step "
              f"{e.count // steps:5d} launches/step  {e.key[:90]}", flush=True)


def _sphere_scene(frames: int = 3, hw: int = 24, radius: float = 0.4):
    """tests/test_neus.py's ``_sphere_data`` in torch (a white sphere on
    grey, analytic masks), with unit random normals and 300 random
    correspondences, on the CPU."""
    from dynhor_tpu_torch.neus import data as ND
    from dynhor_tpu_torch.neus import rendering as R

    K = torch.tensor([[hw, 0, hw / 2], [0, hw, hw / 2], [0, 0, 1.0]])
    ys, xs = torch.meshgrid(torch.arange(hw) + 0.5, torch.arange(hw) + 0.5, indexing="ij")
    pix = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1)
    Rs, imgs, masks = [], [], []
    for i in range(frames):
        ang = 2 * np.pi * i / frames
        c, s = float(np.cos(ang)), float(np.sin(ang))
        R_row = torch.tensor([[c, 0, -s], [0, 1, 0], [s, 0, c]])
        rays = R.rays_from_pose(pix, K, R_row, torch.tensor([0.0, 0.0, 1.5]), 1.0)
        b = (rays.origins * rays.dirs).sum(-1)
        cc = (rays.origins ** 2).sum(-1) - radius ** 2
        mask = ((b * b - cc) > 0).float().reshape(hw, hw)
        imgs.append(torch.where(mask[..., None] > 0, 0.9, 0.2).expand(hw, hw, 3))
        Rs.append(R_row)
        masks.append(mask)
    gen = torch.Generator().manual_seed(0)
    nrm = torch.randn((frames, hw, hw, 3), generator=gen)
    nrm = nrm / nrm.norm(dim=-1, keepdim=True)
    data = ND.ReconData(torch.stack(imgs), torch.stack(masks), nrm, torch.stack(Rs),
                        torch.tensor([[0.0, 0.0, 1.5]]).repeat(frames, 1), K)
    m = 300
    corr = ND.CorrData(torch.randint(0, frames, (m,), generator=gen, dtype=torch.int32),
                       torch.randint(0, frames, (m,), generator=gen, dtype=torch.int32),
                       4 + 16 * torch.rand((m, 2), generator=gen),
                       4 + 16 * torch.rand((m, 2), generator=gen))
    return data, corr


def phase_recon_small(dev) -> None:
    """Phase 9c: the small field (tests/test_neus.py's widths) on the card and
    on the CPU, the same draws on both sides (each drawn on the CPU from its
    key and moved): ``render_rays`` dense, compacted and with the occgrid
    sampler on 32 rays, then three train steps of each sampler with normals
    and correspondences on, at the CPU tests' tolerances (parameters whose
    clipped gradient fell under 1e-7 within 2 x lr x steps, counted)."""
    import math

    from dynhor_tpu_torch.neus import draws as DR
    from dynhor_tpu_torch.neus import fields as F
    from dynhor_tpu_torch.neus import rendering as R
    from dynhor_tpu_torch.neus import trainer as T

    cpu = torch.device("cpu")
    devs = (dev, cpu)
    draw = DR.draw
    DR.draw = lambda key, *a, **k: draw(DR.Key(key.seed, "cpu", key.path), *a, **k).to(key.device)
    try:
        cfg = F.SDFConfig(**NEUS_SMALL)
        fields = {d: F.NeuSField(cfg, DR.Key(0, d)) for d in devs}
        for f in fields.values():
            with torch.no_grad():
                f.variance.fill_(math.log(200.0) / 10.0)
        gen = torch.Generator().manual_seed(1)
        px = 10 + 80 * torch.rand((32, 2), generator=gen)
        K = torch.tensor([[100.0, 0, 50], [0, 100.0, 50], [0, 0, 1]])
        rays = {d: R.Rays(*(x.to(d) for x in R.rays_from_pose(
            px, K, torch.eye(3), torch.tensor([0.1, -0.05, 2.0]), 1.0))) for d in devs}
        errs = {}
        for name, rcfg in (
                ("dense", R.RenderConfig(n_coarse=32, n_importance=16, up_sample_steps=2,
                                         n_shade=0)),
                ("compacted", R.RenderConfig(n_coarse=32, n_importance=16, up_sample_steps=2,
                                             n_shade=8)),
                ("occgrid", R.RenderConfig(sampler="occgrid", occ_res=32, n_candidates=64,
                                           n_occ_samples=32, n_shade=8))):
            outs = {}
            for d in devs:
                occ = R.occupancy_from_sdf(fields[d], rcfg) if rcfg.sampler == "occgrid" else None
                outs[d] = R.render_rays(fields[d], rcfg, rays[d], DR.Key(5, d), occ)
            errs[name] = max(float((a.detach().cpu() - b.detach()).abs().max())
                             for a, b in zip(outs[dev], outs[cpu]))
        data, corr = _sphere_scene()
        data_d = {d: data.to(d) for d in devs}
        corr_d = {d: corr.to(d) for d in devs}
        lr = 1e-3
        tcfg = T.TrainConfig(num_steps=10, batch_rays=32, lr=lr, warmup=2, lw_corr=0.01)
        step_errs = {}
        for sampler, rcfg in (
                ("neus", R.RenderConfig(n_coarse=16, n_importance=8, up_sample_steps=2,
                                        n_shade=8)),
                ("occgrid", R.RenderConfig(sampler="occgrid", occ_res=16, n_candidates=32,
                                           n_occ_samples=16, n_shade=8))):
            states = {d: T.init_train_state(DR.Key(0, d), cfg, tcfg) for d in devs}
            step = T.make_train_step(rcfg, tcfg)
            small, prev, log_err, n_small = {}, {}, 0.0, 0
            for i in range(3):
                logs = {}
                for d in devs:
                    occ = (R.occupancy_from_sdf(states[d].field, rcfg)
                           if rcfg.sampler == "occgrid" else None)
                    logs[d] = step(states[d], DR.Key(0, d).fold_in(i), data_d[d], corr_d[d], occ)
                for k, v in logs[cpu].items():
                    e = abs(float(logs[dev][k]) - float(v))
                    check(e <= NEUS_TOL * abs(float(v)) + 1e-6,
                          f"recon small {sampler} step {i}: log {k} differs by {e}")
                    log_err = max(log_err, e / max(abs(float(v)), 1e-6))
                p_err, n_small = 0.0, 0
                pc = dict(states[cpu].field.named_parameters())
                for name, p in states[dev].field.named_parameters():
                    mu = states[cpu].opt.state[pc[name]]["exp_avg"]
                    g = (mu - 0.9 * prev.get(name, torch.zeros_like(mu))) / 0.1
                    lo = small[name] = (g.abs() < 1e-7) | small.get(name, g.abs() < 0)
                    prev[name] = mu.clone()
                    diff = (p.detach().cpu() - pc[name].detach()).abs()
                    n_small += int(lo.sum())
                    check(bool((diff[~lo] <= 1e-5 + NEUS_TOL * pc[name].detach()[~lo].abs()).all()),
                          f"recon small {sampler} step {i}: parameter {name} differs")
                    check(float(diff[lo].max()) <= 2 * lr * (i + 1) if lo.any() else True,
                          f"recon small {sampler} step {i}: small-gradient {name} moved apart")
                    if (~lo).any():
                        p_err = max(p_err, float(diff[~lo].max()))
            step_errs[sampler] = (log_err, p_err, n_small)
    finally:
        DR.draw = draw
    print(f"[recon-small] card vs CPU, same draws: render max abs difference {errs}; 3 train "
          f"steps (log relative difference, parameter difference, parameters with a clipped "
          f"gradient under 1e-7) {step_errs}", flush=True)
    check(all(e <= NEUS_TOL for e in errs.values()), f"card and CPU renders differ: {errs}")


REMAT_POLICIES = (False, True, "dots", "frozen")


def phase_remat(dev, sc, card: str, dcfg) -> dict:
    """Phase 3's recomputation sweep: the fine refine at full width (8
    frames, STEPS steps, ``dcfg.attn_impl``, bf16) under each ``dino_remat``
    policy in turns (False, True, "dots", "frozen", then backwards): ms/step,
    peak memory and K5 launches of each run (each K5 kernel once per layer
    and step; the forward again per layer under every policy that
    recomputes); a profiler window of each policy (device busy ms/step,
    kernels only, and the idle share of its unprofiled step); the largest
    difference of the final poses from False's.  One step's loss and
    d(rot6d, trans) under each policy, three times, are held to False's (at
    most the repeats' own difference, or REMAT_TOL of the largest).  Returns
    {policy: {"ms", "peak_gib", "busy_ms", "idle"}} (ms and peak the
    medians of the two runs)."""
    from torch.profiler import ProfilerActivity, profile

    from dynhor_tpu_torch.models import dino as D
    from dynhor_tpu_torch.tracker import refine as RF
    from dynhor_tpu_torch.utils import geometry as G

    mesh, rot, trans, K, _, masks, cap, act_cap = sc
    dparams = D.map_params(
        D.init_params(dcfg, torch.Generator().manual_seed(0)), lambda a: a.to(dev)
    )
    gen = torch.Generator().manual_seed(1)
    gt = torch.randn((FRAMES, dcfg.feat_size**2, dcfg.embed_dim), generator=gen)
    gt = (gt / torch.linalg.norm(gt, dim=-1, keepdim=True)).to(dev)
    targets = RF.FrameTargets(masks, gt, K.expand(FRAMES, 3, 3))

    def config(remat, steps=STEPS):
        return RF.RefineConfig(num_iterations=steps, crop_size=CROP, mode="fine",
                               max_faces_per_tile=cap, max_active_tiles=act_cap,
                               dino_remat=remat)

    tag = f"[remat {dcfg.attn_impl}]"
    runs = {p: [] for p in REMAT_POLICIES}
    for remat in REMAT_POLICIES + REMAT_POLICIES[::-1]:
        cfg = config(remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        res, t = wall(lambda: RF.refine_poses(mesh, targets, rot, trans * 1.0001, dparams,
                                              dcfg, cfg, device=dev))
        check(bool(torch.isfinite(res.final_loss).all()), f"{tag} {remat}: loss not finite")
        fwd, bwd = k5_per_step(dcfg, cfg)
        launches = read_launches()
        check_k5_launches(launches, fwd * STEPS, bwd * STEPS, f"{tag} dino_remat {remat!r}")
        runs[remat].append((t / STEPS * 1e3, torch.cuda.max_memory_allocated() / 2**30, res,
                            launches["K5 fwd"]))

    def diff(a, b):
        return max(float((a.rot6d - b.rot6d).abs().max()),
                   float((a.translations - b.translations).abs().max()))

    bf16 = D.map_params(dparams, lambda a: a.to(torch.bfloat16))

    def one_step(remat):
        r6 = G.matrix_to_rot6d(rot).clone().requires_grad_(True)
        tr = trans.reshape(FRAMES, 1, 3).clone().requires_grad_(True)
        loss, _, _ = RF._frame_loss(r6, tr, mesh, targets, bf16, dcfg, config(remat, 1))
        loss.sum().backward()
        return torch.cat([loss.detach(), r6.grad.flatten(), tr.grad.flatten()])

    # Three runs of each policy: the card's step is not bit-reproducible, and
    # the pairs of repeats give the spread the policies are held to.
    g = {remat: [one_step(remat) for _ in range(3)] for remat in REMAT_POLICIES}
    within = max(float((a - b).abs().max()) for runs_ in g.values()
                 for i, a in enumerate(runs_) for b in runs_[i + 1:])
    scale = float(g[False][0].abs().max())
    out = {}
    for remat in REMAT_POLICIES:
        ms = float(np.median([r[0] for r in runs[remat]]))
        steps = 3
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            RF.refine_poses(mesh, targets, rot, trans, dparams, dcfg, config(remat, steps),
                            device=dev)
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / steps / 1e3
        across = float((g[remat][0] - g[False][0]).abs().max())
        out[remat] = {"ms": ms, "peak_gib": float(np.median([r[1] for r in runs[remat]])),
                      "busy_ms": busy or None,
                      "idle": max(0.0, 1.0 - busy / ms) if busy else None}
        busy_text = (f"device busy {busy:.2f} ms/step, idle share {out[remat]['idle']:.3f}"
                     if busy else "device busy: not measured (the profiler saw no kernels)")
        print(f"{tag} dino_remat {remat!r}: "
              f"{', '.join(f'{r[0]:.2f}' for r in runs[remat])} ms/step (in turns), peak "
              f"{', '.join(f'{r[1]:.2f}' for r in runs[remat])} GiB, K5 forward launches "
              f"{[r[3] for r in runs[remat]]}; {busy_text}; final poses against False's "
              f"{diff(runs[remat][0][2], runs[False][0][2]):.3g}; one step's loss and "
              f"d(rot6d, trans) against False's {across:.3g} (repeats of one policy differ "
              f"by up to {within:.3g}, largest value {scale:.3g}) — {card}", flush=True)
        check(across <= max(within, REMAT_TOL * scale),
              f"{tag} dino_remat {remat!r} changed one step by {across}, more than repeats "
              f"differ ({within})")
    return out


# ---------------------------------------------------------------------------
# Phase 10: sharding over torch.distributed
# ---------------------------------------------------------------------------

SHARD_WORLD = 2  # ranks sharing the one card over gloo
SHARD_NEUS_STEPS = 50
SHARD_TIMEOUT = 600  # seconds a rank may take before the phase fails
SHARD_KEYS = ("K1", "K2", "K3")
# The entry points under two ranks (phase 10b), cut in depth: the views of
# each scoring call and the refine and joint steps.  Widths stay: ViT-B/14
# at 518, 256^2 crops, 12 frames at 480x640 a sequence.
SHARD_RUN_VIEWS = 1000
SHARD_MULTI_VIEWS = 300
SHARD_RUN_JOINT = 20
# The ranks' 50 NeuS steps against this process taking the two ranks'
# halves in their order (the same sums in the same order): relative.
SHARD_WITNESS_TOL = 1e-6


def phase_shard_nccl(dev, tmp: str) -> None:
    """Phase 10a: a one-rank NCCL group through ``init_distributed``; every
    collective of ``parallel/mesh.py`` on CUDA tensors against the values
    they must give on one rank (the collectives run: one rank is a live
    group, not a shortcut)."""
    import torch.distributed as dist

    from dynhor_tpu_torch.parallel import mesh as PM
    from dynhor_tpu_torch.parallel import multihost as MH

    MH.init_distributed(f"file://{os.path.join(tmp, 'nccl_rendezvous')}", 1, 0, backend="nccl")
    try:
        check(dist.get_backend() == "nccl", f"backend {dist.get_backend()}")
        mesh = PM.make_mesh(axis_name="frames")
        x = torch.arange(24.0, device=dev).reshape(8, 3).requires_grad_(True)
        local = PM.shard_leading(x, mesh)
        got = {
            "shard": bool(torch.equal(local, x)),
            "gather": bool(torch.equal(PM.gather_leading(x.detach(), mesh), x.detach())),
            "gather bool": bool(torch.equal(PM.gather_leading(x.detach() > 5, mesh), x.detach() > 5)),
            "sum": float(PM.all_reduce(torch.tensor(2.5, device=dev), mesh)) == 2.5,
            "max": int(PM.all_reduce(torch.tensor(7, device=dev), mesh, op="max")) == 7,
            "replicate": bool(torch.equal(PM.replicate({"a": x.detach()}, mesh)["a"], x.detach())),
            "pad": PM.pad_to_multiple(x.detach(), 3)[0].shape == (9, 3),
        }
        h = PM.halo_prev(local, mesh)
        (h.sum() + local.sum()).backward()
        got["halo"] = bool(torch.equal(h, torch.zeros(3, device=dev)))
        got["halo grad"] = bool(torch.equal(x.grad, torch.ones_like(x)))
        check(all(got.values()), f"one-rank NCCL collectives: {got}")
        print(f"[shard] one-rank NCCL group: shard_leading, gather_leading (f32, bool), "
              f"all_reduce (sum, max), replicate, pad_to_multiple and halo_prev (forward and "
              f"gradient) on CUDA tensors as expected: {sorted(got)}", flush=True)
    finally:
        dist.destroy_process_group()


def _digest(tensors) -> str:
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def _vit(dev):
    """The random-weight ViT-B/14 of phase 3 (CPU tensors from seed 0), and
    the digest of its weights."""
    from dynhor_tpu_torch.models import dino as D

    dcfg = D.DinoConfig()
    params = D.init_params(dcfg, torch.Generator().manual_seed(0))
    leaves = []
    D.map_params(params, leaves.append)
    return params, dcfg, _digest(leaves)


def _shard_refine_cfg(inp):
    from dynhor_tpu_torch.tracker import refine as RF

    return RF.RefineConfig(num_iterations=STEPS, crop_size=CROP, mode="fine",
                           max_faces_per_tile=inp["cap"], max_active_tiles=inp["act_cap"])


def _shard_joint_cfg(inp):
    from dynhor_tpu_torch.tracker import jointopt as TJ

    return TJ.JointConfig(
        num_iterations=JOINT_STEPS, lr=1e-4, lw_sil_obj=1.0, lw_smooth_obj=10.0, crop_size=CROP,
        sigma=SIGMA, max_faces_per_tile=inp["cap"], max_active_tiles=inp["act_cap"],
        silhouette_impl="pallas",
    )


def _shard_neus(inp, dev):
    """neus_shoes_fast's recon block on phase 6's sequence: data, configs."""
    import yaml

    from dynhor_tpu_torch.neus import data as ND
    from dynhor_tpu_torch.neus import fields as F
    from dynhor_tpu_torch.neus import rendering as R
    from dynhor_tpu_torch.neus import trainer as T

    with open(NEUS_FAST) as fh:
        rc = yaml.safe_load(fh)["system"]["recon"]
    data, frame_ids = ND.load_recon_data(inp["seq_dir"], inp["poses"], int(rc["downscale"]))
    corr = ND.load_correspondences(inp["seq_dir"], frame_ids, int(rc["downscale"]))
    rcfg = R.RenderConfig(sampler=rc["sampler"])
    tcfg = T.TrainConfig(
        num_steps=int(rc["num_steps"]), batch_rays=int(rc["batch_rays"]),
        lw_rgb=float(rc["lw_rgb"]), lw_mask=float(rc["lw_mask"]),
        lw_eikonal=float(rc["lw_eikonal"]), lw_normal=float(rc["lw_normal"]),
        lw_corr=0.0 if corr is None else 0.01,
    )
    corr = None if corr is None else corr.to(dev)
    return data.to(dev), corr, F.SDFConfig(encoder=rc["encoder"]), rcfg, tcfg


def _witness_step(rcfg, tcfg):
    """The ray-sharded train step of SHARD_WORLD ranks, taken in this one
    process: each rank's loss (``loss_fn`` at a mesh that names that rank,
    whose collectives are this process's own) is back-propagated in rank
    order, so every gradient and the logged loss are the ranks' sums as
    their all-reduce forms them (two addends: the same bits in either
    order); then the update every rank takes."""
    from dynhor_tpu_torch.neus import trainer as T
    from dynhor_tpu_torch.parallel import mesh as PM

    views = [PM.Mesh(("rays",), {"rays": SHARD_WORLD}, tuple(range(SHARD_WORLD)), {"rays": r},
                     {"rays": PM._SELF}) for r in range(SHARD_WORLD)]

    def step(state, key, data, corr, occ):
        state.opt.zero_grad(set_to_none=True)
        state.bg.grad = None
        loss = 0.0
        for view in views:
            part, _ = T.loss_fn(state.field, state.bg, key, data, corr, occ, rcfg, tcfg, view)
            part.backward()
            loss = loss + part.detach()
        T.apply_update(state, tcfg)
        return {"loss": loss}

    return step


def _neus_steps(dev, inp, ray_mesh=None, witness: bool = False):
    """SHARD_NEUS_STEPS train steps from seed 0 (the occupancy grid
    refreshed as ``train`` refreshes it): the whole batch in one process,
    its shard under ``ray_mesh``, or with ``witness`` the ranks' halves in
    this process (``_witness_step``); (the loss of each step, the digest of
    the final weights)."""
    from dynhor_tpu_torch.neus import rendering as R
    from dynhor_tpu_torch.neus import trainer as T
    from dynhor_tpu_torch.neus.draws import Key

    data, corr, sdf_cfg, rcfg, tcfg = _shard_neus(inp, dev)
    key = Key(tcfg.seed, dev)
    state = T.init_train_state(key, sdf_cfg, tcfg)
    if witness:
        step = _witness_step(rcfg, tcfg)
    else:
        step = T.make_train_step(rcfg, tcfg, ray_sharding=ray_mesh)
    losses = []
    for i in range(SHARD_NEUS_STEPS):
        if i % tcfg.occ_update_every == 0:
            occ = R.occupancy_from_sdf(state.field, rcfg)
        losses.append(step(state, key.fold_in(i), data, corr, occ)["loss"])
    return [float(v) for v in losses], _digest(state.field.parameters())


def shard_worker(argv: list[str]) -> None:
    """One of SHARD_WORLD ranks sharing the card over gloo (phase 10b):
    ``chip_smoke.py --shard-rank R RENDEZVOUS INPUTS OUT``.  Runs each case
    on its shard, times it between barriers and synchronizations, counts its
    K1, K2 and K3 launches, and saves what it computed to OUT.  The entry
    points run as a user launches them on SHARD_WORLD cards, in the group
    this process joined, each rank with an experiment root of its own so
    that what each wrote can be told apart."""
    import torch.distributed as dist

    from dynhor_tpu_torch import run as RUN
    from dynhor_tpu_torch import run_multi as RM
    from dynhor_tpu_torch.models import dino as D
    from dynhor_tpu_torch.parallel import mesh as PM
    from dynhor_tpu_torch.parallel import multihost as MH
    from dynhor_tpu_torch.tracker import jointopt as TJ
    from dynhor_tpu_torch.tracker import priors as TP
    from dynhor_tpu_torch.tracker import refine as RF

    rank, rendezvous, inp_path, out_path = int(argv[0]), argv[1], argv[2], argv[3]
    MH.init_distributed(rendezvous, SHARD_WORLD, rank, backend="gloo", timeout_s=SHARD_TIMEOUT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    inp = torch.load(inp_path, weights_only=False)
    out = {"seconds": {}, "launches": {}}

    def timed(name, fn):
        dist.barrier()
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.time()
        res = fn()
        torch.cuda.synchronize()
        out["seconds"][name] = time.time() - t0
        out["launches"][name] = {k: v for k, v in read_launches().items() if k in SHARD_KEYS}
        return res

    fm = PM.make_mesh(axis_name="frames")
    params, dcfg, own = _vit(dev)
    params = PM.replicate(params, fm)  # rank 0's weights on every rank
    leaves = []
    D.map_params(params, leaves.append)
    out["vit_digest"] = (own, _digest(leaves))

    mesh = RF.MeshArrays(*(t.to(dev) for t in inp["mesh"]))
    targets = RF.FrameTargets(*(t.to(dev) for t in inp["targets"]))
    cfg = _shard_refine_cfg(inp)
    shard = lambda t: PM.shard_leading(t.to(dev), fm)  # noqa: E731
    local_targets = RF.FrameTargets(*(shard(t) for t in inp["targets"]))
    RF.refine_poses(mesh, local_targets, shard(inp["rot"]), shard(inp["trans"]), params, dcfg,
                    dataclasses.replace(cfg, num_iterations=1), device=dev,
                    frame_mesh=fm)  # warm-up
    res = timed("refine", lambda: RF.refine_poses(
        mesh, local_targets, shard(inp["rot"]), shard(inp["trans"]), params, dcfg, cfg,
        device=dev, frame_mesh=fm))
    out["refine"] = {k: PM.gather_leading(getattr(res, k), fm).cpu()
                     for k in ("rot6d", "translations", "final_loss")}
    out["refine"]["overflow"] = res.max_overflow

    jres = timed("joint", lambda: TJ.joint_optimize(
        mesh.verts, mesh.faces, shard(inp["R0"]), shard(inp["t0"]), shard(targets.K_rois),
        shard(targets.target_masks), _shard_joint_cfg(inp), device=dev, frame_mesh=fm))
    out["joint"] = {"rot6d": PM.gather_leading(jres.rot6d, fm).cpu(),
                    "trans": PM.gather_leading(jres.translations, fm).cpu(),
                    "history": {k: v.numpy() for k, v in jres.history.items()}}

    vm = PM.make_mesh(axis_name="views")
    p = inp["priors"]
    out["priors"] = timed("priors", lambda: TP.prior_scores_two_stage(
        params, dcfg, *(t.to(dev) for t in p["mesh"]), p["view_rots"].to(dev),
        p["crops"].to(dev), p["masks"].to(dev), p["gt_feats"].to(dev), p["cos_masks"].to(dev),
        TP.PriorConfig(num_views=PRIOR_VIEWS), p["window"], host_batch=1000,
        prescreen_edge=112, prescreen_scale=2, topk=24, device=dev, view_mesh=vm)).cpu()

    rm = PM.make_mesh(axis_name="rays")
    out["neus"] = timed("neus", lambda: _neus_steps(dev, inp, rm))

    root = inp["exps_ranks"][rank]
    with contextlib.redirect_stdout(io.StringIO()):
        res = timed("run", lambda: RUN.main(["--config_path", inp["run_cfg"], "--exps_root",
                                             root]))
        out["run"] = {"rot": res.rotations_row, "trans": res.translations,
                      "selected": res.selected_idx}
        mres = timed("run_multi", lambda: RM.main(["--config_paths", *inp["multi_cfgs"],
                                                   "--exps_root", root]))
    out["run_multi"] = {"pooled": mres.refine.rot6d.cpu(),
                        "rot": np.concatenate([q["rotations_row"] for q in mres.sequences]),
                        "trans": np.concatenate([q["translations"] for q in mres.sequences]),
                        "overflow": mres.refine.max_overflow}
    torch.save(out, out_path)
    dist.barrier()
    dist.destroy_process_group()


def phase_shard(dev, card: str, tmp: str, run: dict, seqs: dict) -> None:
    """Phase 10b: SHARD_WORLD ranks sharing the card over gloo (NCCL refuses
    two ranks on one device), spawned here, against the same work in this
    process: the frame-sharded refine of phase 3's scene (8 frames as 4 + 4,
    STEPS steps), the frame-sharded joint (4 + 4, JOINT_STEPS steps, the
    smoothness halo across the ranks), view-sharded two-stage prior scoring
    of PRIOR_VIEWS views (each chunk split between the ranks), the
    ray-sharded NeuS step of neus_shoes_fast (1024 rays as 512 + 512,
    SHARD_NEUS_STEPS steps), and the entry points ``run`` on phase 6's
    sequence and ``run_multi`` on phase 8's two with ``system.devices``
    SHARD_WORLD (SHARD_RUN_VIEWS and SHARD_MULTI_VIEWS views, STEPS refine
    and SHARD_RUN_JOINT joint steps; one process resolves the same file to
    one device).  Tolerances: the poses and the joint's history to
    BOX_SPREAD x the spread of this process's own runs (the refine twice,
    and split 4 + 4 as the ranks split it; the joint twice, and from inits
    nudged by 1e-6; each entry point twice, and ``run_multi``'s pool
    refined again in the ranks' groups), at least RUN_CARD_TOL; the
    scores to BOX_SPREAD x the spread between this process's scores at view
    chunks of 25 and of 13 (what a rank's chunk holds), winners held where
    the gap beats that, and the entry point's selected views equal; the
    NeuS losses of the first three steps to NEUS_TOL relative (phase 9c's,
    over its three steps) against the whole batch, and of all
    SHARD_NEUS_STEPS to SHARD_WITNESS_TOL against this process taking the
    ranks' two halves in their order (``_witness_step``: the same sums in
    the same order), the whole batch's own drift over the 50 steps printed.
    Rank 0 alone writes each entry point's artifacts, the poses it returned.
    Prints each rank's K1/K2/K3 launches and wall seconds per case; they are
    two ranks sharing one card, not a scaling figure."""
    import yaml

    from dynhor_tpu_torch import run as RUN
    from dynhor_tpu_torch import run_multi as RM
    from dynhor_tpu_torch.parallel import multiseq as MS
    from dynhor_tpu_torch.tracker import jointopt as TJ
    from dynhor_tpu_torch.tracker import priors as TP
    from dynhor_tpu_torch.tracker import refine as RF
    from dynhor_tpu_torch.utils import geometry as G

    mesh, rot, trans, K, _, masks, cap, act_cap = scene(dev)
    gen = torch.Generator().manual_seed(1)
    params, dcfg, vit_digest = _vit(dev)
    gt = torch.randn((FRAMES, dcfg.feat_size**2, dcfg.embed_dim), generator=gen)
    gt = (gt / torch.linalg.norm(gt, dim=-1, keepdim=True)).to(dev)
    targets = RF.FrameTargets(masks, gt, K.expand(FRAMES, 3, 3).contiguous())
    rng = np.random.default_rng(6)
    r6 = G.matrix_to_rot6d(rot)
    R0 = G.rot6d_to_matrix(r6 + torch.as_tensor(0.05 * rng.standard_normal(r6.shape),
                                                dtype=torch.float32, device=dev))
    t0 = trans + torch.as_tensor(0.02 * rng.standard_normal((FRAMES, 3)), dtype=torch.float32,
                                 device=dev)
    pverts, pfaces, puvs, ptex = prior_mesh(dev)
    crops, pmasks, _ = render_frames(pverts, pfaces, puvs, ptex, FRAMES, CROP, 21)
    gt_feats, cos_masks = TP.frame_gt_features(params, dcfg, crops, pmasks, "bfloat16", dev)
    view_rots = uniform_rotations(PRIOR_VIEWS, 22, dev)
    pcfg = TP.PriorConfig(num_views=PRIOR_VIEWS)
    radius, _ = TP.mesh_radius_center(pverts)
    window = TP.compute_window(pcfg, float(TP.mesh_norm_radius(pverts)),
                               float(pcfg.distance_scale * radius))
    poses = os.path.join(tmp, "gt_obj_infos")
    write_gt_poses(run["seq_dir"], poses)

    def cut_config(name, root, obj, views, exp):
        path = os.path.join(tmp, f"{name}_{exp}.yaml")
        with open(path, "w") as fh:
            yaml.safe_dump({
                "seq_name": name, "exp_name": exp,
                "data_info": {"dataroot": root, "obj_path": os.path.abspath(obj)},
                "system": {"devices": SHARD_WORLD, "init_num_iterations": STEPS,
                           "joint_num_iterations": SHARD_RUN_JOINT,
                           "prior": {"num_views": views}}}, fh)
        return path

    run_cfg = cut_config("custom_shoes", run["seq_dir"], SHOES, SHARD_RUN_VIEWS, "shard")
    multi_cfgs = [cut_config(name, root, obj, SHARD_MULTI_VIEWS, "shard_multi")
                  for name, (root, obj) in seqs.items()]
    exps_ranks = [os.path.join(tmp, f"shard_exps_rank{r}") for r in range(SHARD_WORLD)]
    inp = {"run_cfg": run_cfg, "multi_cfgs": multi_cfgs, "exps_ranks": exps_ranks,
           "mesh": [t.cpu() for t in mesh], "targets": [t.cpu() for t in targets],
           "rot": rot.cpu(), "trans": trans.cpu(), "cap": cap, "act_cap": act_cap,
           "R0": R0.cpu(), "t0": t0.cpu(), "seq_dir": run["seq_dir"], "poses": poses,
           "priors": {"mesh": [pverts.cpu(), pfaces.cpu(), puvs.cpu(), ptex.cpu()],
                      "view_rots": view_rots.cpu(), "crops": crops.cpu(), "masks": pmasks.cpu(),
                      "gt_feats": gt_feats.cpu(), "cos_masks": cos_masks.cpu(),
                      "window": window}}
    inp_path = os.path.join(tmp, "shard_inputs.pt")
    torch.save(inp, inp_path)

    # ---- this process: the same work, and the spreads ----
    one, times = {}, {}
    cfg = _shard_refine_cfg(inp)
    refine = lambda r_rows, sl=slice(None): RF.refine_poses(  # noqa: E731
        mesh, RF.FrameTargets(*(t[sl] for t in targets)), r_rows[sl], trans[sl], params,
        dcfg, cfg, device=dev)
    reset_launches()
    (one["refine"], times["refine"]) = wall(lambda: refine(rot))
    one_launches = {"refine": read_launches()}
    again = refine(rot)
    halves = [refine(rot, slice(0, FRAMES // 2)), refine(rot, slice(FRAMES // 2, None))]
    split = torch.cat([h.rot6d for h in halves]), torch.cat([h.translations for h in halves])

    def pose_diff(a, b):
        return max(float((a[0] - b[0]).abs().max()), float((a[1] - b[1]).abs().max()))

    ref_pose = (one["refine"].rot6d, one["refine"].translations)
    spread_r = max(pose_diff(ref_pose, (again.rot6d, again.translations)),
                   pose_diff(ref_pose, split))
    tol_r = max(RUN_CARD_TOL, BOX_SPREAD * spread_r)

    jcfg = _shard_joint_cfg(inp)
    jargs = (mesh.verts, mesh.faces, R0, t0, targets.K_rois, masks)
    reset_launches()
    one["joint"], times["joint"] = wall(lambda: TJ.joint_optimize(*jargs, jcfg, device=dev))
    one_launches["joint"] = read_launches()
    j_again = TJ.joint_optimize(*jargs, jcfg, device=dev)
    nudge = 1.0 + 1e-6 * torch.randn(R0.shape, generator=torch.Generator().manual_seed(3))
    j_nudged = TJ.joint_optimize(mesh.verts, mesh.faces, G.rot6d_to_matrix(
        G.matrix_to_rot6d(R0) * nudge[..., :2].to(dev)), t0, targets.K_rois, masks, jcfg,
        device=dev)
    jref = (one["joint"].rot6d, one["joint"].translations)
    spread_j = max(pose_diff(jref, (r.rot6d, r.translations)) for r in (j_again, j_nudged))
    tol_j = max(RUN_CARD_TOL, BOX_SPREAD * spread_j)
    h_ref = {k: v.numpy() for k, v in one["joint"].history.items()}
    spread_h = max(float(np.abs(r.history["loss"].numpy() - h_ref["loss"]).max())
                   for r in (j_again, j_nudged))
    tol_h = max(RUN_CARD_TOL, BOX_SPREAD * spread_h)

    pargs = (params, dcfg, pverts, pfaces, puvs, ptex, view_rots, crops, pmasks, gt_feats,
             cos_masks)
    pkw = dict(host_batch=1000, prescreen_edge=112, prescreen_scale=2, topk=24, device=dev)
    reset_launches()
    with contextlib.redirect_stdout(io.StringIO()):
        one["priors"], times["priors"] = wall(
            lambda: TP.prior_scores_two_stage(*pargs, pcfg, window, **pkw))
        one_launches["priors"] = read_launches()
        chunk13 = TP.prior_scores_two_stage(
            *pargs, dataclasses.replace(pcfg, view_chunk=-(-pcfg.view_chunk // SHARD_WORLD)),
            window, **pkw)
    spread_s = float((one["priors"] - chunk13).abs().max())
    tol_s = max(RUN_CARD_TOL, BOX_SPREAD * spread_s)

    (one["neus"], times["neus"]) = wall(lambda: _neus_steps(dev, inp))
    (witness, times["witness"]) = wall(lambda: _neus_steps(dev, inp, witness=True))

    def rel(a, b):
        return max(abs(x - y) / max(abs(y), 1e-12) for x, y in zip(a, b))

    drift_n = rel(witness[0], one["neus"][0])  # the split itself, in one process

    # The entry points, twice each (their spread), launches counted.
    def entry(fn):
        reset_launches()
        with contextlib.redirect_stdout(io.StringIO()):
            res, secs = wall(fn)
        return res, secs, read_launches()

    def run_once(root):
        return entry(lambda: RUN.main(["--config_path", run_cfg, "--exps_root", root]))

    def multi_once(root):
        return entry(lambda: RM.main(["--config_paths", *multi_cfgs, "--exps_root", root]))

    def arrays(res):
        if hasattr(res, "rotations_row"):
            return res.rotations_row, res.translations
        return (np.concatenate([q["rotations_row"] for q in res.sequences]),
                np.concatenate([q["translations"] for q in res.sequences]))

    def np_diff(a, b):
        return max(float(np.abs(np.asarray(x) - np.asarray(y)).max()) for x, y in zip(a, b))

    one["run"], times["run"], one_launches["run"] = run_once(os.path.join(tmp, "shard_exps_a"))
    run_b = run_once(os.path.join(tmp, "shard_exps_b"))[0]
    spread_e = np_diff(arrays(one["run"]), arrays(run_b))
    tol_e = max(RUN_CARD_TOL, BOX_SPREAD * spread_e)
    pooled = _Spy(MS, "refine_poses_multi")
    try:
        one["multi"], times["multi"], one_launches["multi"] = multi_once(
            os.path.join(tmp, "shard_exps_a"))
    finally:
        pooled.restore()
    multi_b = multi_once(os.path.join(tmp, "shard_exps_b"))[0]
    # The pool again in the ranks' groups (each rank refines its half in one
    # group): other batch shapes, so other roundings in the bf16 ViT.
    p_args, p_kw, _ = pooled.calls[-1]
    regrouped = MS.refine_poses_multi(
        *p_args, **{**p_kw, "frames_per_launch": len(seqs) * RUN_FRAMES // SHARD_WORLD})
    spread_m = max(np_diff(arrays(one["multi"]), arrays(multi_b)), *(
        float((one["multi"].refine.rot6d - x.rot6d).abs().max())
        for x in (multi_b.refine, regrouped)))
    tol_m = max(RUN_CARD_TOL, BOX_SPREAD * spread_m)

    # ---- the ranks ----
    rendezvous = f"file://{os.path.join(tmp, 'shard_rendezvous')}"
    outs = [os.path.join(tmp, f"shard_rank{r}.pt") for r in range(SHARD_WORLD)]
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    t_start = time.time()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--shard-rank", str(r), rendezvous, inp_path,
         outs[r]], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
    ) for r in range(SHARD_WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SHARD_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    t_ranks = time.time() - t_start
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            print(log[-6000:], file=sys.stderr, flush=True)
        check(p.returncode == 0, f"shard rank {r} exited with {p.returncode}")
    ranks = [torch.load(o, weights_only=False) for o in outs]

    print(
        f"[shard] one process on the card: wall s refine {times['refine']:.3f}, joint "
        f"{times['joint']:.3f}, priors {times['priors']:.3f}, neus {times['neus']:.3f}, neus "
        f"as the ranks' halves {times['witness']:.3f}, run {times['run']:.3f}, run_multi "
        f"{times['multi']:.3f}; launches refine K1 {one_launches['refine']['K1']}, joint K1 "
        f"{one_launches['joint']['K1']}, priors K3 {one_launches['priors']['K3']}, run "
        f"{ {k: one_launches['run'][k] for k in SHARD_KEYS} }, run_multi "
        f"{ {k: one_launches['multi'][k] for k in SHARD_KEYS} }; the {SHARD_WORLD} ranks' whole "
        f"run {t_ranks:.1f} s with start-up — {card}", flush=True,
    )
    print(
        f"[shard] NeuS in this process, {SHARD_NEUS_STEPS} steps: the ranks' two halves taken in "
        f"their order against the whole batch {drift_n:.3g} relative (the split's own "
        f"summation order; the first 3 steps {rel(witness[0][:3], one['neus'][0][:3]):.3g}); "
        f"entry points run twice: poses {spread_e:.3g} apart (run), {spread_m:.3g} (run_multi, "
        f"with its pool refined again in the ranks' groups of "
        f"{len(seqs) * RUN_FRAMES // SHARD_WORLD})",
        flush=True,
    )

    # ---- compare: each rank's numbers printed, then checked ----
    top = torch.topk(one["priors"], 2, dim=1).values
    decided = (top[:, 0] - top[:, 1]) > tol_s
    for r, o in enumerate(ranks):
        rr, jr, ln = o["refine"], o["joint"], o["launches"]
        sc_ = o["priors"].to(dev)
        err_r = pose_diff(ref_pose, (rr["rot6d"].to(dev), rr["translations"].to(dev)))
        err_j = pose_diff(jref, (jr["rot6d"].to(dev), jr["trans"].to(dev)))
        err_h = float(np.abs(jr["history"]["loss"] - h_ref["loss"]).max())
        err_s = float((sc_ - one["priors"]).abs().max())
        n_losses, n_digest = o["neus"]
        err_n3, err_n = rel(n_losses[:3], one["neus"][0][:3]), rel(n_losses, one["neus"][0])
        err_w = rel(n_losses, witness[0])
        er, em = o["run"], o["run_multi"]
        err_e = np_diff(arrays(one["run"]), (er["rot"], er["trans"]))
        err_m = max(np_diff(arrays(one["multi"]), (em["rot"], em["trans"])),
                    float((one["multi"].refine.rot6d.cpu() - em["pooled"]).abs().max()))
        sec = o["seconds"]
        same_sel = np.array_equal(er["selected"], one["run"].selected_idx)
        same_w = "equal" if n_digest == witness[1] else "differ"
        print(
            f"[shard] rank {r} of {SHARD_WORLD} (gloo, two ranks sharing one card): launches "
            f"refine {ln['refine']}, joint {ln['joint']}, priors {ln['priors']}, neus "
            f"{ln['neus']}, run {ln['run']}, run_multi {ln['run_multi']}; wall s refine "
            f"{sec['refine']:.3f}, joint {sec['joint']:.3f}, priors {sec['priors']:.3f}, neus "
            f"{sec['neus']:.3f}, run {sec['run']:.3f}, run_multi {sec['run_multi']:.3f} — {card}",
            flush=True,
        )
        print(
            f"[shard] rank {r} against one process: refine poses {err_r:.3g} (bound {tol_r:.3g},"
            f" spread {spread_r:.3g}), joint poses {err_j:.3g} (bound {tol_j:.3g}), joint loss "
            f"history {err_h:.3g} (bound {tol_h:.3g}), scores {err_s:.3g} (bound {tol_s:.3g}, "
            f"chunk spread {spread_s:.3g}; {int(decided.sum())} of {FRAMES} winners decided), "
            f"NeuS losses {err_n3:.3g} relative over 3 steps (bound {NEUS_TOL:g}), over "
            f"{SHARD_NEUS_STEPS} {err_w:.3g} against the halves in this process (bound "
            f"{SHARD_WITNESS_TOL:g}; final weights {same_w}) and {err_n:.3g} against the whole "
            f"batch; run poses {err_e:.3g} (bound {tol_e:.3g}), selected views "
            f"{'equal' if same_sel else 'DIFFER'}; run_multi poses {err_m:.3g} (bound {tol_m:.3g})", flush=True,
        )
        check(o["vit_digest"][1] == vit_digest,
              f"rank {r}: the replicated ViT weights differ from this process's")
        check(rr["overflow"] == 0, f"rank {r}: the sharded refine overflowed")
        check(err_r <= tol_r, f"rank {r}: sharded refine poses differ by {err_r:.3g}")
        check(err_j <= tol_j and err_h <= tol_h, f"rank {r}: the sharded joint differs")
        check(float(jr["history"]["bin_overflow"].max()) == 0, f"rank {r}: the joint overflowed")
        check(err_s <= tol_s, f"rank {r}: sharded scores differ by {err_s:.3g}")
        check(bool((sc_.argmax(1) == one["priors"].argmax(1))[decided].all()),
              f"rank {r}: a decided winner of the sharded scoring differs")
        check(err_n3 <= NEUS_TOL, f"rank {r}: sharded NeuS losses differ over 3 steps")
        check(err_w <= SHARD_WITNESS_TOL,
              f"rank {r}: sharded NeuS losses differ from the halves taken in one process")
        check(n_digest == ranks[0]["neus"][1], f"rank {r}: the NeuS replicas diverged")
        check(ln["refine"]["K1"] == STEPS and ln["refine"]["K2"] == STEPS,
              f"rank {r}: sharded refine launches {ln['refine']}")
        check(ln["joint"]["K1"] == JOINT_STEPS and ln["joint"]["K2"] == JOINT_STEPS,
              f"rank {r}: sharded joint launches {ln['joint']}")
        check(ln["priors"]["K3"] == one_launches["priors"]["K3"] > 0,
              f"rank {r}: sharded scoring launched K3 {ln['priors']['K3']} times, one process "
              f"{one_launches['priors']['K3']}")
        # run: only the scoring is sharded; every rank refines and joins all
        # frames, as one process does.
        check(same_sel, f"rank {r}: run selected {er['selected']}, one process {one['run'].selected_idx}")
        check(err_e <= tol_e, f"rank {r}: run poses differ by {err_e:.3g}")
        check(ln["run"] == {k: one_launches["run"][k] for k in SHARD_KEYS}
              and ln["run"]["K3"] > 0 and ln["run"]["K1"] > 0,
              f"rank {r}: run launches {ln['run']}, one process {one_launches['run']}")
        # run_multi: each rank refines its half of the pooled frames in one
        # group (one process: groups of FRAMES_PER_CARD), every rank joins
        # every sequence.
        check(em["overflow"] == 0, f"rank {r}: the sharded pool overflowed")
        check(err_m <= tol_m, f"rank {r}: run_multi poses differ by {err_m:.3g}")
        n_pool = len(seqs) * RUN_FRAMES
        groups = -(-(n_pool // SHARD_WORLD) // MS.FRAMES_PER_CARD)
        want = STEPS * groups + len(seqs) * SHARD_RUN_JOINT
        check(ln["run_multi"]["K1"] == ln["run_multi"]["K2"] == want
              and ln["run_multi"]["K3"] == one_launches["multi"]["K3"] > 0,
              f"rank {r}: run_multi launches {ln['run_multi']} (K1/K2 {want} wanted), one "
              f"process {one_launches['multi']}")

    # Rank 0 alone wrote each entry point's experiments: the poses it
    # returned, each sequence's frames, its config and board.
    wrote1 = sorted(os.listdir(exps_ranks[1])) if os.path.exists(exps_ranks[1]) else []
    check(not wrote1, f"rank 1 wrote {wrote1}")
    r0 = ranks[0]
    written = [("custom_shoes", "shard", r0["run"]["rot"], r0["run"]["trans"])]
    for i, name in enumerate(seqs):
        sl = slice(i * RUN_FRAMES, (i + 1) * RUN_FRAMES)
        written.append((name, "shard_multi", r0["run_multi"]["rot"][sl],
                        r0["run_multi"]["trans"][sl]))
    for name, exp, rot, trans in written:
        exp_dir = os.path.join(exps_ranks[0], name, exp)
        npzs = sorted(os.listdir(os.path.join(exp_dir, "obj_infos")))
        check(npzs == [f"{i:04d}.npz" for i in range(RUN_FRAMES)], f"{name}/{exp}: {npzs}")
        for i, fname in enumerate(npzs):
            d = np.load(os.path.join(exp_dir, "obj_infos", fname))
            check(np.array_equal(d["R"], rot[i].T.astype(np.float32))
                  and np.array_equal(d["T"].reshape(-1), trans[i].reshape(-1).astype(np.float32)),
                  f"{name}/{exp} {fname}: not the poses rank 0 returned")
        check(os.path.exists(os.path.join(exp_dir, "config.yaml"))
              and os.listdir(os.path.join(exp_dir, "board")), f"{name}/{exp}: no config or board")
    print(f"[shard] rank 0 alone wrote the entry points' experiments ({len(written)} sequences "
          f"of {RUN_FRAMES} pose files, config, board); rank 1 wrote nothing", flush=True)


# ---------------------------------------------------------------------------
# Phase 11: the tools at full width
# ---------------------------------------------------------------------------

# BASELINE.md:337-338's matched settings of the quality ablations.
ABL_INIT, ABL_JOINT, ABL_VIEWS = 50, 100, 500
ABL_K, ABL_TOURNAMENT, ABL_PROPAGATE = 4, 25, 1
# ablate_fine_edge: two edges (518 = 1370 tokens, 252 = 325, a count off
# K5's tiles), depth cut to fit the script's time.
EDGES, EDGE_INIT, EDGE_JOINT, EDGE_VIEWS = (518, 252), 20, 40, 500
# ab_prescreen at 1000 views; its refine and joint cut from the defaults'
# 100 / 200 steps to fit the script's time (the comparison is of the views
# selected, which the steps do not change).  At 1000 views and 12 frames the
# default variant's top-48 falls back to one stage (the two-stage scoring
# prescreens only above 2 x topk x frames = 1152 views), so the variant
# prescreened is the top 24.
PRESCREEN_VIEWS, PRESCREEN_INIT, PRESCREEN_JOINT = 1000, 10, 20
PRESCREEN_VARIANT = "224:2:24"
# The oracle arm's floor: the JAX package's oracle arm reached joint IoU
# 0.9846 and 0.7 deg on its own kettle trajectory (BASELINE.md:245, a quality
# figure taken on a TPU); a miss is a quality fault of the port.
ORACLE_MIN_IOU, ORACLE_MAX_ROT = 0.90, 5.0
EVAL_TOL = 1e-4  # eval_poses against phase 6's own angles, degrees
# probe_vit_attention, max |grad - xla's| over max |xla's|: "flash" (the
# kernels phase 2c holds) within VIT_PROBE_FLASH_MAX of xla, bf16's rounding
# (5.18e-3 on an H100 80GB HBM3); "splash" and the fused backward within
# VIT_PROBE_FACTOR times flash's own gap in the same run (5.18e-3 each).
VIT_PROBE_FLASH_MAX, VIT_PROBE_FACTOR = 2e-2, 2.0


def _finite(*values) -> bool:
    return all(np.isfinite(np.asarray(v, np.float64)).all() for v in values)


def phase_tools(dev, card: str, tmp: str, run: dict, seqs: dict) -> dict:
    """Phase 11: the port's tools (``python -m dynhor_tpu_torch.tools.<name>``)
    at full width on the card, each through its ``main`` or ``run``, with
    K1-K3 (and K5 where the ViT runs "flash") on the tracking paths:

    - ``ablate_oracle_init`` on phase 8's kettle (12 frames at 480x640, seed
      0) at BASELINE.md's matched settings (50 refine and 100 joint steps,
      500 views): the oracle arm's selected views are the GT-nearest prior
      views, its joint IoU at least ORACLE_MIN_IOU and its mean joint
      rotation error at most ORACLE_MAX_ROT degrees;
    - ``ablate_multihyp`` there with K 4, tournament 25, one propagation
      round, its K=4 arm only (``--skip-k1``): its K=1 arm is the oracle
      tool's dino-gate arm, the same configuration;
    - ``eval_poses`` on phase 6's artifacts against the twin's GT, equal to
      phase 6's own angles within EVAL_TOL degrees;
    - ``ab_prescreen`` at 1000 views, ``ablate_fine_edge`` at edges 518 and
      252 on phase 6's shoes;
    - each probe once at its own default shapes (the ViT probe under both
      attentions);
    - ``warm_cache`` into a fresh build directory (the kettle's pipeline
      pass) and ``weak_scaling`` at one NCCL rank.

    Every tool must return finite numbers.  Returns the quality numbers."""
    import yaml

    from dynhor_tpu_torch import kernels
    from dynhor_tpu_torch.io.config import DEFAULTS
    from dynhor_tpu_torch.tools import (ab_prescreen, ablate_fine_edge, ablate_multihyp,
                                        ablate_oracle_init, eval_poses, probe_hash_breakdown,
                                        probe_hash_step, probe_prior_stages,
                                        probe_raster_stages, probe_step_breakdown,
                                        probe_vit_attention, probe_vit_fused, warm_cache,
                                        weak_scaling)
    from dynhor_tpu_torch.tracker import priors as TP
    from dynhor_tpu_torch.utils import geometry as G

    def config(name, seq, system=None):
        root, obj = seqs[seq]
        path = os.path.join(tmp, f"tools_{name}.yaml")
        with open(path, "w") as fh:
            yaml.safe_dump({"seq_name": seq, "exp_name": f"tools_{name}", "system": system or {},
                            "data_info": {"dataroot": root, "obj_path": os.path.abspath(obj)}}, fh)
        return path

    def timed(name, fn):
        torch.cuda.synchronize()
        reset_launches()
        out, t = wall(fn)
        launches = {k: n for k, n in read_launches().items() if n}
        print(f"[tools] {name}: {t:.1f} s, launches {launches} — {card}", flush=True)
        return out, t, launches

    kettle = config("kettle", "custom_kettle")
    quality, secs = {}, {}

    # -- ablate_oracle_init --
    ora, secs["ablate_oracle_init"], la = timed("ablate_oracle_init", lambda: ablate_oracle_init.main(
        ["--config", kettle, "--init-iters", str(ABL_INIT), "--joint-iters", str(ABL_JOINT),
         "--views", str(ABL_VIEWS)]))
    steps = 2 * (ABL_INIT + ABL_JOINT)
    check(la.get("K1") == la.get("K2") == steps and la.get("K3", 0) > 0,
          f"ablate_oracle_init: launches {la}, expected K1/K2 {steps} and K3")
    gt_R = np.load(os.path.join(seqs["custom_kettle"][0], "gt_poses.npz"))["R"]
    seed = int(DEFAULTS["system"]["prior"].get("seed", 0))
    views = TP.prior_view_rotations(TP.PriorConfig(num_views=ABL_VIEWS),
                                    torch.Generator().manual_seed(seed))
    priors_row = views.to(dev).transpose(-1, -2)
    gt_row = torch.as_tensor(gt_R, device=dev).transpose(-1, -2)
    nearest = torch.argmin(G.rotation_angle_difference(priors_row[None, :], gt_row[:, None]), 1)
    oracle = ora["oracle-init"]
    check(np.array_equal(np.asarray(oracle["result"].selected_idx), nearest.cpu().numpy()),
          f"oracle arm's views {oracle['result'].selected_idx} are not the GT-nearest "
          f"{nearest.tolist()}")
    for arm, r in ora.items():
        check(_finite(r["iou"], r["init_rot_err"], r["joint_rot_err"]), f"oracle {arm}: not finite")
        quality[("kettle", arm)] = r
    check(oracle["iou"] >= ORACLE_MIN_IOU and float(np.mean(oracle["joint_rot_err"]))
          <= ORACLE_MAX_ROT,
          f"oracle arm: joint IoU {oracle['iou']:.4f} (floor {ORACLE_MIN_IOU}), mean joint "
          f"rotation error {float(np.mean(oracle['joint_rot_err'])):.2f} deg (limit "
          f"{ORACLE_MAX_ROT}): a quality fault of the port")

    # -- ablate_multihyp, its K=4 arm --
    mh, secs["ablate_multihyp"], lm = timed("ablate_multihyp", lambda: ablate_multihyp.main(
        ["--config", kettle, "--k", str(ABL_K), "--init-iters", str(ABL_INIT), "--joint-iters",
         str(ABL_JOINT), "--views", str(ABL_VIEWS), "--tournament", str(ABL_TOURNAMENT),
         "--propagate-rounds", str(ABL_PROPAGATE), "--skip-k1"]))
    arm = mh[f"multihyp-K{ABL_K}"]
    check(_finite(arm["iou"], arm["init_rot_err"], arm["joint_rot_err"]), "multihyp: not finite")
    quality[("kettle", f"multihyp-K{ABL_K}")] = arm
    gate = ora["dino-gate"]
    print(f"[tools] multi-hypothesis ablation (K=1 is the oracle tool's dino-gate arm): joint "
          f"IoU K=1 {gate['iou']:.4f} -> K={ABL_K} {arm['iou']:.4f}; mean joint rotation error "
          f"{float(np.mean(gate['joint_rot_err'])):.2f} -> "
          f"{float(np.mean(arm['joint_rot_err'])):.2f} deg; wall {gate['wall']:.1f} -> "
          f"{arm['wall']:.1f} s — {card}", flush=True)

    # -- eval_poses on phase 6's artifacts --
    ev, secs["eval_poses"], _ = timed("eval_poses", lambda: eval_poses.main(
        ["--exp", run["exp"], "--gt", os.path.join(run["seq_dir"], "gt_poses.npz")]))
    err = float(np.abs(ev["rot_deg"] - run["rot_deg"]).max())
    check(_finite(ev["rot_deg"], ev["trans"]) and err <= EVAL_TOL,
          f"eval_poses against phase 6's angles: {err} deg (limit {EVAL_TOL})")
    quality[("shoes", "run (phase 6)")] = {"rot": ev}

    # -- ab_prescreen, ablate_fine_edge on the shoes --
    shoes = config("prescreen", "custom_shoes", {"init_num_iterations": PRESCREEN_INIT,
                                                 "joint_num_iterations": PRESCREEN_JOINT})
    ab, secs["ab_prescreen"], _ = timed("ab_prescreen", lambda: ab_prescreen.main(
        ["--config", shoes, "--views", str(PRESCREEN_VIEWS), "--variants", PRESCREEN_VARIANT]))
    check(all(_finite(r["iou"]) for k, r in ab.items() if k != "agreement"),
          "ab_prescreen: not finite")
    edge_cfg = config("fine_edge", "custom_shoes")
    fe, secs["ablate_fine_edge"], lf = timed("ablate_fine_edge", lambda: ablate_fine_edge.main(
        ["--config", edge_cfg, "--edges", *map(str, EDGES), "--init-iters", str(EDGE_INIT),
         "--joint-iters", str(EDGE_JOINT), "--views", str(EDGE_VIEWS)]))
    for edge, r in fe.items():
        check(_finite(r["iou"], r["init"], r["joint"]), f"fine edge {edge}: not finite")
        quality[("shoes", f"edge {edge} ({r['tokens']} tokens)")] = {
            "iou": r["iou"], "init_rot_err": r["init"], "joint_rot_err": r["joint"],
            "wall": r["wall"]}

    # -- the probes, each at its own default shapes --
    prior_cfg = config("probe_priors", "custom_shoes")
    probes = {
        "probe_vit_fused": lambda: probe_vit_fused.run(dev, ("xla", "flash")),
        "probe_vit_attention": lambda: probe_vit_attention.run(dev),
        "probe_step_breakdown": lambda: probe_step_breakdown.run(dev),
        "probe_prior_stages": lambda: probe_prior_stages.run(prior_cfg, 0, dev),
        "probe_raster_stages": lambda: probe_raster_stages.run(dev),
        "probe_raster_stages --bwd": lambda: probe_raster_stages.run(dev, bwd=True),
        "probe_hash_step": lambda: probe_hash_step.run(dev),
        "probe_hash_breakdown": lambda: probe_hash_breakdown.run(dev),
    }
    for name, fn in probes.items():
        res, secs[name], launched = timed(name, fn)
        flat = [v for r in res.values() for v in (r.values() if isinstance(r, dict) else (r,))
                if v is not None]
        check(flat and _finite(*flat), f"{name}: numbers not finite: {res}")
        if name == "probe_vit_attention":
            check(launched.get("K5c", 0) > 0 and launched.get("K5 dq", 0) > 0,
                  f"probe_vit_attention: launches {launched}, expected the fused and the "
                  "two-pass backward")
            gap = res["flash"]["rel_grad_diff"]
            check(gap <= VIT_PROBE_FLASH_MAX
                  and all(r["rel_grad_diff"] <= VIT_PROBE_FACTOR * gap for r in res.values()),
                  f"probe_vit_attention: gradients against xla's {res}, flash's gap {gap}")

    # -- warm_cache into a fresh build directory; weak_scaling at one rank --
    fresh = os.path.join(tmp, "warm_build")
    wc, secs["warm_cache"], _ = timed("warm_cache", lambda: warm_cache.main(
        ["--config", kettle, "--build-dir", fresh]))
    built = sorted(f for f in os.listdir(fresh) if f.endswith(".so"))
    check(len(built) == len(kernels.SOURCES) and _finite(*wc.values()),
          f"warm_cache built {built} into {fresh}")
    torch.cuda.empty_cache()
    ws, secs["weak_scaling"], _ = timed("weak_scaling", lambda: weak_scaling.run(devices=[1]))
    check(_finite(ws[0]["ms"], ws[0]["losses"]), f"weak_scaling: {ws}")
    print(f"[tools] phase 11 seconds by tool {json.dumps({k: round(v, 1) for k, v in secs.items()})}"
          f", {sum(secs.values()):.1f} s in all — {card}", flush=True)
    print("[tools] quality (sequence, arm): joint IoU, mean / median rotation error after refine "
          "and after joint (deg) against gt_poses.npz — " + "; ".join(
              f"{seq} {arm}: " + (f"{r['iou']:.4f}, {np.mean(r['init_rot_err']):.2f} / "
                                  f"{np.median(r['init_rot_err']):.2f}, "
                                  f"{np.mean(r['joint_rot_err']):.2f} / "
                                  f"{np.median(r['joint_rot_err']):.2f}"
                                  if "iou" in r else
                                  f"final {r['rot']['rot_mean']:.2f} / {r['rot']['rot_median']:.2f}")
              for (seq, arm), r in quality.items()) + f" — {card}", flush=True)
    return quality


T0 = time.time()


def stamp(what: str) -> None:
    """The script's seconds so far, after ``what``."""
    print(f"[time] {time.time() - T0:.1f} s: {what} done", flush=True)


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
    stamp("phases 1, 2, 2b")
    kernel_rows.extend(phase_flash_kernels(dev, smi))
    kernel_rows.extend(phase_flash_kernels(dev, smi, torch.float32))
    kernel_rows.extend(phase_fused_kernels(dev, smi))
    kernel_rows.extend(phase_fused_kernels(dev, smi, torch.float32))
    stamp("phase 2c")
    kernel_rows.extend(phase_silhouette_kernels(dev, sc, smi))
    kernel_rows.extend(phase_gather_kernels(dev, smi))
    stamp("phases 2d, 2e")
    from dynhor_tpu_torch.models.dino import DinoConfig

    flash, xla = DinoConfig(attn_impl="flash"), DinoConfig(attn_impl="xla")
    written = phase_main(dev, sc, smi, kernel_rows, xla)
    fused = phase_main(dev, sc, smi, kernel_rows, flash, again=True)
    print(
        f"[main] attn_impl xla vs flash: {written['ms_step']:.2f} vs {fused['ms_step']:.2f} "
        f"ms/step, peak {written['peak_gib']:.2f} vs {fused['peak_gib']:.2f} GiB; final losses "
        f"{written['loss']} vs {fused['loss']}; max abs difference of the final rot6d "
        f"{float((written['rot6d'] - fused['rot6d']).abs().max()):.3g}, of the translations "
        f"{float((written['trans'] - fused['trans']).abs().max()):.3g} — {smi}", flush=True,
    )
    f32 = phase_main(dev, sc, smi, kernel_rows, flash, "float32", steps=2, again=True)
    print(
        f"[main] flash, ViT in f32 against bf16: {f32['ms_step']:.2f} vs {fused['ms_step']:.2f} "
        f"ms/step, peak {f32['peak_gib']:.2f} vs {fused['peak_gib']:.2f} GiB — {smi}", flush=True,
    )
    phase_fused_refine(dev, sc, smi, kernel_rows, fused, f32)
    remat = {impl: phase_remat(dev, sc, smi, cfg) for impl, cfg in (("xla", xla),
                                                                     ("flash", flash))}
    print("[remat] policy x attn_impl: " + "; ".join(
        f"{impl} {p!r} {r['ms']:.2f} ms/step {r['peak_gib']:.2f} GiB"
        for impl, rs in remat.items() for p, r in rs.items()) + f" — {smi}", flush=True)
    for impl, dtype in (("xla", "float32"), ("flash", "bfloat16"), ("flash", "float32")):
        phase_small_reference(dev, impl, dtype)
    for dtype in ("bfloat16", "float32"):
        phase_small_reference(dev, "splash", dtype, fused=True)
    stamp("phase 3")
    phase_joint(dev, sc, smi)
    phase_joint_small(dev)
    phase_profiler(dev, sc, smi, kernel_rows)
    stamp("phases 3b, 3c")
    pw = phase_priors(dev, smi, kernel_rows, xla)
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
    stamp("phases 4, 4b")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_run_")
    try:
        run = phase_run(dev, smi, kernel_rows, tmp)
        phase_run_small(dev)
        stamp("phase 6")
        phase_multihyp(dev, smi, tmp, run)
        phase_vis(dev, smi, run)
        phase_multihyp_small(dev, smi)
        stamp("phases 7, 7b")
        seqs = phase_multi(dev, smi, tmp, run)
        phase_multi_small(dev)
        stamp("phase 8")
        phase_recon(dev, smi, tmp, run)
        phase_recon_bench(dev, smi)
        phase_recon_small(dev)
        stamp("phase 9")
        phase_shard_nccl(dev, tmp)
        phase_shard(dev, smi, tmp, run, seqs)
        stamp("phase 10")
        phase_tools(dev, smi, tmp, run, seqs)
        stamp("phase 11")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
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
    if sys.argv[1:2] == ["--shard-rank"]:
        shard_worker(sys.argv[2:])
    else:
        main()
