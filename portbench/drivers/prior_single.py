"""Single-stage prior scoring, ``run_multi``'s path: one sequence a unit,
its frames' ViT features (``tracker.priors.frame_gt_features``) and then
``prior_scores_batched`` over all the sequence's view rotations, every
view rendered, cropped and put through the ViT at its full edge.  The
sequences, their views and the set-up are ``drivers/prior.py``'s.

The check takes one sequence of the window, drawn from the seed, and holds
the full scores of ``check_views`` of its views, drawn from the seed, at
every frame against the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from ..counts import raster as CR
from ..counts import vit as CV
from ..reference import prior as RP
from ..reference import vit as RV
from . import prior as DP
from . import tracker as TK


class Driver(DP.Driver):
    def _sequence(self, keep: bool = True):
        pr, i = self.config["prior"], self.done
        fr = self.scenes[i % len(self.scenes)]
        gt, cos = self.P.frame_gt_features(self.sc.params, self.dcfg, fr.crop_images,
                                           fr.target_masks, self.pcfg.dino_dtype, self.device)
        mesh = self.sc.mesh
        scores = self.P.prior_scores_batched(
            self.sc.params, self.dcfg, mesh.verts, mesh.faces, mesh.face_uvs, self.sc.tex,
            self.rotations(i), gt, cos, self.pcfg, self.window, host_batch=pr["host_batch"],
            device=self.device)
        out = scores.cpu().numpy()
        if not np.isfinite(out).all():
            self.failed += 1
        if keep:
            self.outputs[i] = out
        self.done += 1

    def layer_stats(self, trace) -> dict:
        """K3's work over every view of the traced sequences at the render
        size, counted from the views' real bins, and each kept sequence's
        operations: the ViT's forward at its edge over the frames and every
        view (K3's, a few thousandth of them, left out)."""
        pr, vit = self.config["prior"], self.config["vit"]
        win = RP.window_side(pr["render_hw"], self.config["bbox_expansion"], self.sc.mesh.verts,
                             pr["distance_scale"])
        k3_bound = 0.0
        for i in range(self.done - trace.units, self.done):
            ops, nbytes = self._k3(self.rotations(i), pr["render_hw"], win)
            k3_bound += CR.bound_s(ops, nbytes)
        n_frames = self.sc.frames.crop_images.shape[0]
        seq = (n_frames + self.traffic["views"]) * CV.forward_flops(vit, vit["smaller_edge_size"])
        return {"seq_flops": [seq] * len(self.outputs), "k3_bound_s": k3_bound,
                "peak_flops": CR.PEAK_BF16}

    def check(self):
        """``check_views`` views of one sequence of the window, both drawn from
        the seed, against the reference."""
        done = sorted(self.outputs)
        gen = torch.Generator().manual_seed(self.seed % (1 << 63))
        pick = done[int(torch.randint(len(done), (1,), generator=gen))]
        views = torch.randperm(self.traffic["views"], generator=gen)[:self.traffic["check_views"]]
        prog = self.outputs[pick]
        self.outputs = {}
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return judge(prog, self.sc, self.scenes[pick % len(self.scenes)], self.rotations(pick),
                     np.sort(views.numpy()), self.config)


def full_scores(sc, fr, rots, views: np.ndarray, config: dict, quant=None) -> np.ndarray:
    """The reference's (frames x views) full scores of the views ``views``."""
    pr, vit = config["prior"], config["vit"]
    exp, ds, render, edge = config["bbox_expansion"], pr["distance_scale"], pr["render_hw"], vit["smaller_edge_size"]
    params = sc.params_f32()
    gt, cos = RP.frame_features(params, vit, fr.crop_images, fr.target_masks, edge, quant)
    win = RP.window_side(render, exp, sc.mesh.verts, ds)
    idx = torch.as_tensor(views, device=rots.device)
    return RP.view_scores(params, vit, sc.mesh, sc.tex, rots[idx], gt, cos, render, config["crop_size"],
                          win, edge, exp, ds, quant, batch=50).cpu().numpy()


def judge(prog: np.ndarray, sc, fr, rots, views: np.ndarray, config: dict) -> list:
    ref = full_scores(sc, fr, rots, views, config)
    full_gap = float(np.abs(prog[:, views] - ref).max())
    return [("full_gap", full_gap, DP.LIMITS["full_gap"])]


def control(config: dict, traffic: dict, seed: int, device) -> list:
    """The check's numbers when the reference with its ViT's products in
    float8 (e4m3) takes the program's place, on the seed's first sequence."""
    sc = TK.TrackerScene(config, traffic["frames"], seed, device)
    rots = DP.SC.rotations(traffic["views"], DP.SC.generator(seed, "views/0", device), device)
    gen = torch.Generator().manual_seed(seed % (1 << 63))
    views = np.sort(torch.randperm(traffic["views"], generator=gen)[:traffic["check_views"]].numpy())
    ctl = np.zeros((sc.frames.crop_images.shape[0], traffic["views"]), np.float32)
    ctl[:, views] = full_scores(sc, sc.frames, rots, views, config, RV.fp8_e4m3)
    return judge(ctl, sc, sc.frames, rots, views, config)
