"""The fine refine: ``tracker.refine.refine_poses`` over all frames, one
Adam step of every frame a step, refines of ``num_iterations`` steps back
to back in calls of ``steps_per_call`` resumed through ``carry_state``.

Set-up draws the scene, counts the raster caps at every drawn init (as the
tracker counts them), and drives the first refine's first
``checked_steps`` steps through the window's own call, one step a call;
the window goes on from there.  The check follows those steps with the
plain reference: each step's loss, the first gradient as Adam got it, and
each frame's parameter change after them.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import scene as SC
from ..counts import raster as CR
from ..counts import vit as CV
from ..counts.timing import timeit
from ..reference import raster as RR
from ..reference import refine as RRF
from ..reference import shading as RS
from ..reference import vit as RV
from . import tracker as TK

# Limits of the compared numbers: see PERF.md, "What decides correct".
LIMITS = {"loss_gap": 3.5e-3, "grad_gap": 5e-2, "change_gap": 0.15}
BETA1 = 0.9


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from dynhor_tpu_torch.tracker import priors as P
        from dynhor_tpu_torch.tracker import refine as RF

        self.RF, self.device, self.config, self.traffic = RF, device, config, traffic
        rc = config["refine"]
        self.total = rc["num_iterations"]
        self.chunk = traffic["steps_per_call"]
        self.sc = TK.TrackerScene(config, traffic["frames"], seed, device)
        self.dcfg = self.sc.dino_config()
        fr = self.sc.frames
        gen = SC.generator(seed, "inits", device)
        self.inits = [SC.perturbed_inits(fr, traffic["max_init_deg"], gen)
                      for _ in range(traffic["refines_drawn"])]
        cap, act = self._caps()
        self.cfg = RF.RefineConfig(
            num_iterations=self.chunk, lr=rc["lr"], crop_size=config["crop_size"],
            offscreen_weight=rc["offscreen_weight"], sigma=rc["sigma"], far=rc["far"],
            lw_sem=rc["lw_sem"], mode="fine", max_faces_per_tile=cap, max_active_tiles=act,
            dino_dtype=config["vit"]["dtype"])
        gt_feats, _ = P.frame_gt_features(self.sc.params, self.dcfg, fr.crop_images,
                                          fr.target_masks, config["vit"]["dtype"], device)
        self.targets = RF.FrameTargets(fr.target_masks, gt_feats, fr.K_rois)
        self.mesh = RF.MeshArrays(self.sc.mesh.verts, self.sc.mesh.faces, self.sc.mesh.face_uvs,
                                  self.sc.tex)
        self.failed = 0
        # The first refine's first steps, one a call: what the check follows.
        self.refine, self.state, self.step = 0, None, 0
        losses, self.first = [], None
        for _ in range(traffic["checked_steps"]):
            res = self._call(1)
            losses.append(res.final_loss.detach().clone())
            if self.first is None:
                self.first = (self.state.m_rot6d / (1 - BETA1), self.state.m_trans / (1 - BETA1))
        self.checked = (torch.stack(losses), self.state.rot6d.clone(), self.state.trans.clone())
        self._call(self.chunk - traffic["checked_steps"])

    def _caps(self):
        """The per-tile face cap and active-tile cap at every drawn init,
        with the tracker's headroom and rounding."""
        rc, s = self.config["refine"], self.config["crop_size"]
        n_faces = int(self.sc.mesh.faces.shape[0])
        t_total = (-(-s // CR.TILE)) ** 2
        worst = active = 0
        for R, t in self.inits:
            vp = RS.project(self.sc.mesh.verts @ R + t[:, None], self.sc.frames.K_rois)
            loads = RR.tile_loads(vp, self.sc.mesh.faces, (s, s), 6.0 * rc["sigma"] + 1.0)
            worst = max(worst, int(loads.max()))
            active = max(active, int((loads > 0).sum(-1).max()))
        h = rc["cap_headroom"]
        cap = max(256, min(-(-int(worst * h) // 128) * 128, n_faces))
        act = max(8, min(-(-int(active * h) // 8) * 8, t_total))
        return cap, (act if act < t_total else None)

    def _call(self, n: int):
        R, t = self.inits[self.refine % len(self.inits)]
        res, self.state = self.RF.refine_poses(
            self.mesh, self.targets, R, t, self.sc.params, self.dcfg,
            dataclasses.replace(self.cfg, num_iterations=n), carry_state=self.state,
            return_state=True, device=self.device)
        self.step += n
        if res.max_overflow > 0 or not bool(torch.isfinite(res.final_loss).all()):
            self.failed += 1
        return res

    def unit(self) -> float:
        """One call of up to ``steps_per_call`` steps; the frames refined."""
        if self.step >= self.total:
            self.refine, self.state, self.step = self.refine + 1, None, 0
        n = min(self.chunk, self.total - self.step)
        self._call(n)
        return self.targets.K_rois.shape[0] * n / self.total

    def trace_units(self) -> int:
        return self.traffic["trace_calls"]

    def layer_stats(self, trace) -> dict:
        """Work of the traced calls' steps, counted at the poses they started
        from, and the ViT's forward and backward alone."""
        steps = self.chunk * trace.units
        s = self.config["crop_size"]
        with torch.no_grad():
            R = RRF.rot6d_to_matrix(self.state.rot6d)
            vp = RS.project(self.sc.mesh.verts @ R + self.state.trans, self.sc.frames.K_rois)
            loads = RR.tile_loads(vp, self.sc.mesh.faces, (s, s), 6.0 * self.config["refine"]["sigma"] + 1.0)
        kk = CR.k1k2(loads)
        vit = self.config["vit"]
        b = self.targets.K_rois.shape[0]
        unit_flops = b * CV.forward_input_backward_flops(vit, vit["smaller_edge_size"])
        unit_flops += kk["K1"][0] + kk["K2"][0]
        from dynhor_tpu_torch.models import dino as D

        rgb = torch.rand((b, 3, s, s), generator=SC.generator(0, "vit_alone", self.device),
                         device=self.device)

        def vit_fb():
            x = rgb.clone().requires_grad_(True)
            D.forward_tokens_from_crop(self.sc.params, x, self.dcfg,
                                       remat=self.cfg.dino_remat).float().sum().backward()

        return {"steps": steps, "unit_flops": unit_flops,
                "k1k2_bound_s": steps * (CR.bound_s(*kk["K1"]) + CR.bound_s(*kk["K2"])),
                "vit_fb_ms": timeit(vit_fb, self.device, n=5, warmup=2)
                if self.device.type == "cuda" else None,
                "peak_flops": CR.PEAK_BF16, "frames": b, "steps_per_unit": self.total}

    def check(self):
        """The first ``checked_steps`` steps against the reference."""
        losses_p, rot_p, trans_p = self.checked
        g_rot_p, g_trans_p = self.first
        R0, t0 = self.inits[0]
        del self.state, self.targets
        torch.cuda.empty_cache() if self.device.type == "cuda" else None
        ref = RRF.run(R0, t0, losses_p.shape[0], self.sc.mesh, self.sc.tex, self.sc.frames,
                      self.sc.params_f32(), {**self.config, **self.config["refine"]})
        return compare(losses_p, (g_rot_p, g_trans_p), (rot_p, trans_p), R0, t0, ref)


def control(config: dict, traffic: dict, seed: int, device) -> list:
    """The check's numbers when the reference with its ViT's products in
    float8 (e4m3) takes the program's place."""
    sc = TK.TrackerScene(config, traffic["frames"], seed, device)
    R0, t0 = SC.perturbed_inits(sc.frames, traffic["max_init_deg"], SC.generator(seed, "inits", device))
    cfg, n = {**config, **config["refine"]}, traffic["checked_steps"]
    params = sc.params_f32()
    ctl = RRF.run(R0, t0, n, sc.mesh, sc.tex, sc.frames, params, cfg, RV.fp8_e4m3)
    ref = RRF.run(R0, t0, n, sc.mesh, sc.tex, sc.frames, params, cfg)
    return compare(ctl["loss"], ctl["grad"], (ctl["rot6d"], ctl["trans"]), R0, t0, ref)


def compare(losses_p, grads_p, params_p, R0, t0, ref) -> list:
    """(name, value, limit) of the three numbers; a frame's rotation and
    translation are leaves of their own."""
    b = losses_p.shape[1]

    def leaf_norms(rot, trans):
        return torch.cat([rot.reshape(b, -1).norm(dim=-1), trans.reshape(b, -1).norm(dim=-1)])

    loss_gap = max(TK.relative_gaps(losses_p[k], ref["loss"][k]) for k in range(losses_p.shape[0]))
    g_p, g_r = leaf_norms(*grads_p), leaf_norms(*ref["grad"])
    grad_gap = TK.relative_gaps(g_p, g_r)
    rot0, tr0 = R0[..., :2], t0.reshape(b, 1, 3)
    d_p = leaf_norms(params_p[0] - rot0, params_p[1] - tr0)
    d_r = leaf_norms(ref["rot6d"] - rot0, ref["trans"] - tr0)
    # Leaves whose reference gradient is nought to rounding move under Adam
    # by round-off alone: left out by a rule on that gradient.
    moved = g_r >= 1e-3 * g_r.median()
    change_gap = TK.relative_gaps(d_p[moved], d_r[moved])
    return [("loss_gap", loss_gap, LIMITS["loss_gap"]), ("grad_gap", grad_gap, LIMITS["grad_gap"]),
            ("change_gap", change_gap, LIMITS["change_gap"])]
