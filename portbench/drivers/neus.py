"""The NeuS train step: ``neus.trainer.make_train_step`` over the twin's
frames, steps back to back, the occupancy grid
(``neus.rendering.occupancy_from_sdf``) refreshed every
``occ_update_every`` steps as the trainer's loop refreshes it.

Set-up draws the frames, initializes the field from the seed's key and
drives the first ``checked_steps`` steps through the window's own step
function; the window goes on from there.  The check follows those steps
with the plain reference: each step's loss, the first gradient as Adam got
it, and each parameter's change after them.
"""
from __future__ import annotations

import hashlib

import torch

from .. import scene as SC
from ..counts import neus as CN
from ..counts import raster as CR
from ..reference import neus as RN
from . import tracker as TK

# Limits of the compared numbers: see PERF.md, "What decides correct".
LIMITS = {"loss_gap": 5e-6, "grad_gap": 5e-5, "change_gap": 4e-5}
BETA1 = 0.9


def field_seed(seed: int) -> int:
    digest = hashlib.sha256(f"{int(seed)}/field".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from dynhor_tpu_torch.neus import data as ND
        from dynhor_tpu_torch.neus import fields as NF
        from dynhor_tpu_torch.neus import rendering as NR
        from dynhor_tpu_torch.neus import trainer as NT
        from dynhor_tpu_torch.neus.draws import Key

        self.NR, self.device, self.config, self.traffic = NR, device, config, traffic
        f, r, t = config["field"], config["render"], config["train"]
        mesh = SC.load_mesh(config, device)
        gen = SC.generator(seed, "neus_scene", device)
        fr = SC.neus_frames(mesh, SC.texture(gen, device), traffic["frames"], config["downscale"],
                            gen, device)
        self.frames = fr
        self.data = ND.ReconData(fr.images, fr.masks, fr.normals, fr.R_row, fr.Ts, fr.K)
        sdf_keys = ("encoder", "pe_freqs", "hidden", "depth", "skip_layer", "feat_dim",
                    "geometric_init_radius", "color_hidden", "color_depth", "dir_freqs", "bound")
        self.sdf_cfg = NF.SDFConfig(**{k: f[k] for k in sdf_keys})
        self.rcfg = NR.RenderConfig(**{k: r[k] for k in (
            "sampler", "n_candidates", "n_occ_samples", "occ_res", "n_shade", "bound", "n_coarse",
            "n_importance", "up_sample_steps")})
        self.tcfg = NT.TrainConfig(batch_rays=traffic["batch_rays"], lw_corr=0.0, seed=field_seed(seed),
                                   **{k: v for k, v in t.items()})
        self.key = Key(self.tcfg.seed, device)
        self.state = NT.init_train_state(self.key, self.sdf_cfg, self.tcfg)
        self.step_fn = NT.make_train_step(self.rcfg, self.tcfg)
        self.occ = NR.occupancy_from_sdf(self.state.field, self.rcfg)
        self.failed, self.i = 0, 0
        params = list(self.state.field.parameters())
        p0 = [p.detach().clone() for p in params] + [self.state.bg.detach().clone()]
        losses = []
        for _ in range(traffic["checked_steps"]):
            losses.append(self._step()["loss"].clone())
            if self.i == 1:
                st = self.state.opt.state
                self.first = [st[p]["exp_avg"] / (1 - BETA1) if "exp_avg" in st.get(p, {})
                              else torch.zeros_like(p) for p in params]
                bg = self.state.bg
                self.first.append(torch.zeros_like(bg) if bg.grad is None else bg.grad.detach().clone())
        p3 = [p.detach().clone() for p in params] + [self.state.bg.detach().clone()]
        self.checked = (torch.stack(losses), [b - a for a, b in zip(p0, p3)])

    def _step(self) -> dict:
        if self.i % max(self.tcfg.occ_update_every, 1) == 0 and self.i > 0:
            self.occ = self.NR.occupancy_from_sdf(self.state.field, self.rcfg)
        logs = self.step_fn(self.state, self.key.fold_in(self.i), self.data, None, self.occ)
        self.i += 1
        return logs

    def unit(self) -> float:
        """One train step; the rays trained on."""
        self._step()
        return float(self.traffic["batch_rays"])

    def trace_units(self) -> int:
        return self.traffic["trace_calls"]

    def layer_stats(self, trace) -> dict:
        return {"steps": trace.units, "unit_flops": CN.step_flops(self.config, self.traffic["batch_rays"]),
                "peak_flops": CR.PEAK_F32}

    def check(self):
        """The first ``checked_steps`` steps against the reference."""
        losses_p, change_p = self.checked
        if not torch.isfinite(losses_p).all():
            self.failed += 1
        del self.state, self.occ
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        ref = reference(self.config, self.traffic, self.tcfg.seed, self.frames, self.device,
                        losses_p.shape[0])
        return compare(losses_p, self.first, change_p, *ref)


def reference(config: dict, traffic: dict, seed: int, frames, device, steps: int, quant=None):
    """(losses, first gradients, changes) of the reference's first steps, in
    f32 with TF32 off (``quant`` rounds its products' operands)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        tr = RN.Trainer(seed, device, config["field"], config["render"],
                        {**config["train"], "batch_rays": traffic["batch_rays"]}, quant)
        leaves = list(tr.field.parameters()) + [tr.bg]
        p0 = [p.detach().clone() for p in leaves]
        data = RN.Data(frames.images, frames.masks, frames.normals, frames.R_row, frames.Ts, frames.K)
        key = RN.Key(seed, device)
        occ = RN.occupancy(tr.field, config["render"])
        losses, grads = [], None
        for i in range(steps):
            if i % config["train"]["occ_update_every"] == 0 and i > 0:
                occ = RN.occupancy(tr.field, config["render"])
            losses.append(tr.train_step(key.fold_in(i), data, occ))
            if grads is None:
                grads = [p.grad.detach().clone() for p in leaves]
        return torch.stack(losses), grads, [p.detach() - a for p, a in zip(leaves, p0)]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def control(config: dict, traffic: dict, seed: int, device) -> list:
    """The check's numbers when the reference with its products' operands in
    TF32 takes the program's place."""
    gen = SC.generator(seed, "neus_scene", device)
    mesh = SC.load_mesh(config, device)
    fr = SC.neus_frames(mesh, SC.texture(gen, device), traffic["frames"], config["downscale"], gen,
                        device)
    fs, n = field_seed(seed), traffic["checked_steps"]
    ctl = reference(config, traffic, fs, fr, device, n, RN.tf32)
    return compare(*ctl, *reference(config, traffic, fs, fr, device, n))


def compare(losses_p, grads_p, change_p, losses_r, grads_r, change_r) -> list:
    def norms(xs):
        return torch.stack([x.double().norm() for x in xs])

    loss_gap = float(((losses_p.double() - losses_r.double()).abs() / losses_r.double().abs()).max())
    g_r = norms(grads_r)
    grad_gap = TK.relative_gaps(norms(grads_p), g_r)
    # Leaves whose reference gradient is nought to rounding move under Adam
    # by round-off alone: left out by a rule on that gradient.
    moved = g_r >= 1e-3 * g_r.median()
    change_gap = TK.relative_gaps(norms(change_p)[moved], norms(change_r)[moved])
    return [("loss_gap", loss_gap, LIMITS["loss_gap"]), ("grad_gap", grad_gap, LIMITS["grad_gap"]),
            ("change_gap", change_gap, LIMITS["change_gap"])]
