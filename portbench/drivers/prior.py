"""Prior scoring at the tracker's defaults: one sequence a unit, its frames'
ViT features (``tracker.priors.frame_gt_features``) and then
``prior_scores_two_stage`` over the sequence's view rotations.  Sequence
``i`` is a video of its own, the ``i mod scenes``-th drawn from the seed
(made in set-up), so that a run's rate is the mean over several videos and
not one video's rescored union.

Set-up scores one sequence, which builds and warms every shape.  The check
takes one sequence of the window, drawn from the seed, and holds its
(frames x views) matrix against the reference: the rescored entries and
the filled ones.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import scene as SC
from ..counts import raster as CR
from ..counts import vit as CV
from ..reference import prior as RP
from ..reference import raster as RR
from ..reference import vit as RV
from . import tracker as TK

# Limits of the compared numbers: see PERF.md, "What decides correct".
LIMITS = {"full_gap": 2.5e-3, "fill_gap": 5e-3}


def rescored_union(scores: np.ndarray, topk: int) -> np.ndarray:
    """The views the program rescored at full resolution, read from its
    output: the largest set, of at most ``topk`` x frames views, that is
    every frame's top set and sits at least 1e-4 above each frame's next
    entry (every other entry is kept 1e-4 below the frame's lowest
    rescored score)."""
    f, n = scores.shape
    order = np.argsort(-scores, axis=1, kind="stable")
    rank = np.empty_like(order)
    rank[np.arange(f)[:, None], order] = np.arange(n)[None, :]
    worst = np.maximum.accumulate(rank[:, order[0]].max(0))  # over the first k of frame 0
    k = np.arange(1, n + 1)
    same = worst == k - 1
    srt = np.take_along_axis(scores, order, 1)
    gap = np.full(n, np.inf)
    gap[:-1] = (srt[:, :-1] - srt[:, 1:]).min(0)
    ok = same & (gap >= 1e-4 - 1e-6) & (k >= topk) & (k <= topk * f)
    if not ok.any():
        return np.zeros(0, np.int64)
    size = int(k[ok].max())
    return np.sort(order[0, :size])


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from dynhor_tpu_torch.tracker import priors as P

        self.P, self.device, self.config, self.traffic, self.seed = P, device, config, traffic, seed
        pr = config["prior"]
        self.sc = TK.TrackerScene(config, traffic["frames"], seed, device)
        self.dcfg = self.sc.dino_config()
        self.pcfg = P.PriorConfig(num_views=traffic["views"], render_h=pr["render_hw"],
                                  render_w=pr["render_hw"], distance_scale=pr["distance_scale"],
                                  crop_size=config["crop_size"], bbox_expansion=config["bbox_expansion"],
                                  view_chunk=pr["view_chunk"], dino_dtype=config["vit"]["dtype"])
        v = self.sc.mesh.verts
        radius, _ = P.mesh_radius_center(v)
        self.window = P.compute_window(self.pcfg, float(P.mesh_norm_radius(v)),
                                       float(self.pcfg.distance_scale * radius))
        self.scenes = [sequence_frames(self.sc, config, traffic, seed, i, device)
                       for i in range(traffic["scenes"])]
        self.failed, self.done, self.outputs = 0, 0, {}
        self._sequence(keep=False)  # builds and warms every shape

    def rotations(self, i: int) -> torch.Tensor:
        return SC.rotations(self.traffic["views"], SC.generator(self.seed, f"views/{i}", self.device),
                            self.device)

    def _sequence(self, keep: bool = True):
        pr, i = self.config["prior"], self.done
        fr = self.scenes[i % len(self.scenes)]
        rots = self.rotations(i)
        gt, cos = self.P.frame_gt_features(self.sc.params, self.dcfg, fr.crop_images,
                                           fr.target_masks, self.pcfg.dino_dtype, self.device)
        scores = self.P.prior_scores_two_stage(
            self.sc.params, self.dcfg, self.sc.mesh.verts, self.sc.mesh.faces,
            self.sc.mesh.face_uvs, self.sc.tex, rots, fr.crop_images, fr.target_masks, gt, cos,
            self.pcfg, self.window, host_batch=pr["host_batch"], prescreen_edge=pr["prescreen_edge"],
            prescreen_scale=pr["prescreen_scale"], topk=pr["topk"], device=self.device)
        out = scores.cpu().numpy()
        if not np.isfinite(out).all():
            self.failed += 1
        if keep:
            self.outputs[i] = out
        self.done += 1

    def unit(self) -> float:
        """One sequence; the views scored."""
        self._sequence()
        return float(self.traffic["views"])

    def trace_units(self) -> int:
        return self.traffic["trace_calls"]

    def layer_stats(self, trace) -> dict:
        """K3's work over both stages of the traced sequences, counted from
        the views' real bins, and each kept sequence's operations: the ViT
        at both edges over its own rescored union, and K3 at the traced
        sequences' operations a view of each stage."""
        pr, vit = self.config["prior"], self.config["vit"]
        s = pr["prescreen_scale"]
        n_frames = self.sc.frames.crop_images.shape[0]
        edges = (pr["prescreen_edge"], vit["smaller_edge_size"])
        k3_ops, k3_views, k3_bound = [0.0, 0.0], [0, 0], 0.0
        for i in range(self.done - trace.units, self.done):
            union = rescored_union(self.outputs[i], pr["topk"])
            rots = self.rotations(i)
            stages = ((rots, pr["render_hw"] // s), (rots[torch.as_tensor(union, device=self.device)],
                                                     pr["render_hw"]))
            for st, (R, render) in enumerate(stages):
                win = RP.window_side(render, self.config["bbox_expansion"], self.sc.mesh.verts,
                                     pr["distance_scale"])
                ops, nbytes = self._k3(R, render, win)
                k3_ops[st] += ops
                k3_views[st] += R.shape[0]
                k3_bound += CR.bound_s(ops, nbytes)
        per_view = [o / max(v, 1) for o, v in zip(k3_ops, k3_views)]
        seq_flops = []
        for i in sorted(self.outputs):
            views = (self.traffic["views"], rescored_union(self.outputs[i], pr["topk"]).size)
            seq_flops.append(n_frames * CV.forward_flops(vit, vit["smaller_edge_size"]) + sum(
                (v + n_frames) * CV.forward_flops(vit, e) + v * k for v, e, k in zip(views, edges, per_view)))
        return {"seq_flops": seq_flops, "k3_bound_s": k3_bound, "peak_flops": CR.PEAK_BF16}

    def _k3(self, R, render, win):
        """(ops, bytes) of K3 over the views R at this render and window."""
        mesh = self.sc.mesh
        ops = nbytes = 0.0
        grid = -(-win // CR.TILE) * CR.TILE
        for j in range(0, R.shape[0], 500):
            _, vp = RP.project_views(mesh, R[j:j + 500], render, win, self.pcfg.distance_scale)
            loads = RR.tile_loads(vp, mesh.faces, (win, win), 0.0)
            o, b = CR.k3(loads, CR.inside_pairs(vp, mesh.faces, (grid, grid)), mesh.faces.shape[0])
            ops, nbytes = ops + o, nbytes + b
        return ops, nbytes

    def check(self):
        """One sequence of the window, drawn from the seed, against the
        reference."""
        done = sorted(self.outputs)
        gen = torch.Generator().manual_seed(self.seed % (1 << 63))
        pick = done[int(torch.randint(len(done), (1,), generator=gen))]
        prog = self.outputs[pick]
        self.outputs = {}
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return judge(prog, self.sc, self.scenes[pick % len(self.scenes)], self.rotations(pick),
                     self.config)


def sequence_frames(sc, config: dict, traffic: dict, seed: int, i: int, device):
    """The frames of the seed's ``i``-th video: the scene's own for 0, else
    drawn anew (pose path, placement, depth, hand, background)."""
    if i == 0:
        return sc.frames
    return SC.tracker_frames(sc.mesh, sc.tex, traffic["frames"], config["crop_size"],
                             config["bbox_expansion"], SC.generator(seed, f"scene/{i}", device),
                             device)


def judge(prog: np.ndarray, sc, fr, rots, config: dict) -> list:
    """(name, value, limit) of a sequence's (frames x views) matrix against
    the reference: the rescored entries and the filled ones.  Which views
    were rescored is not judged: the prescreen's bfloat16 low scores swap
    near-ties at a frame's ``topk``-th place by as much as the precision
    below it does (see PERF.md)."""
    pr = config["prior"]
    union = rescored_union(prog, pr["topk"])
    if union.size == 0:
        return [("union_found", 1.0, 0.0)]
    ref = RP.two_stage(sc.params_f32(), config["vit"], sc.mesh, sc.tex, rots, fr.crop_images,
                       fr.target_masks, _prior(config), union)
    rest = np.ones(prog.shape[1], bool)
    rest[union] = False
    full_gap = float(np.abs(prog[:, union] - ref["full"]).max())
    fill_gap = float(np.abs(prog[:, rest] - ref["filled"][:, rest]).max())
    return [("full_gap", full_gap, LIMITS["full_gap"]), ("fill_gap", fill_gap, LIMITS["fill_gap"])]


def _prior(config: dict) -> dict:
    return {**config["prior"], "crop_size": config["crop_size"],
            "bbox_expansion": config["bbox_expansion"]}


def control(config: dict, traffic: dict, seed: int, device) -> list:
    """The check's numbers when the reference with its ViT's products in
    float8 (e4m3) takes the program's place, on the seed's first sequence."""
    sc = TK.TrackerScene(config, traffic["frames"], seed, device)
    rots = SC.rotations(traffic["views"], SC.generator(seed, "views/0", device), device)
    fr = sc.frames  # sequence 0's
    ctl = RP.two_stage(sc.params_f32(), config["vit"], sc.mesh, sc.tex, rots, fr.crop_images,
                       fr.target_masks, _prior(config), None, RV.fp8_e4m3)
    return judge(ctl["filled"].astype(np.float32), sc, fr, rots, config)
