"""The NeuS train step with instant-nsr-pl's hash-grid field (the program's
``"ngp"`` encoder), driven as ``drivers/neus.py`` drives the PE field:
``neus.trainer.make_train_step`` over the twin's frames, steps back to
back, the occupancy grid refreshed every ``occ_update_every`` steps.

Set-up first builds the program's field configuration, and stops at once
where the program has no such encoder.  The check follows the first
``checked_steps`` steps with ``reference/neus_ngp.py``: each step's loss,
the first gradient as Adam got it, each parameter's change after them, and
Adam's first moment after them.  The moment carries the size of the
table's gradient, which the rest cannot: the table's first gradients are
0 (the sphere init's zero grid columns), and Adam's step normalises the
size of a later one away.
"""
from __future__ import annotations

import math

import torch

from .. import scene as SC
from ..counts import neus_ngp as CN
from ..counts import raster as CR
from ..reference import neus as RN
from ..reference import neus_ngp as RG
from . import neus as DN
from . import tracker as TK

# Limits of the compared numbers: see PERF.md, "What decides correct".
LIMITS = {"loss_gap": 2e-6, "grad_gap": 5e-5, "change_gap": 2e-4, "moment_gap": 5e-4}
# What the program's field fixes; a configuration that differs is refused.
FIXED = {"encoder": "ngp", "include_xyz": True, "sphere_init": True, "weight_norm": True,
         "softplus_beta": 100, "grad_type": "analytic", "sh_degree": 4, "color_activation": "sigmoid",
         "variance_init": 0.3}


def sdf_config(NF, field: dict):
    """The program's ``SDFConfig`` of the configuration's field."""
    for k, v in FIXED.items():
        if field[k] != v:
            raise SystemExit(f"field {k} {field[k]!r}: the program's ngp field has {v!r}")
    if not hasattr(NF, "NGP_WIDTHS"):
        raise SystemExit("the program's NeuS fields have no ngp encoder")
    levels, base = field["n_levels"], field["base_resolution"]
    max_res = round(base * field["per_level_scale"] ** (levels - 1))
    if math.exp((math.log(max_res) - math.log(base)) / (levels - 1)) != field["per_level_scale"]:
        raise SystemExit(f"per_level_scale {field['per_level_scale']!r} is not (max / base)^(1 / (L - 1))")
    return NF.SDFConfig(
        encoder="ngp", bound=field["radius"], hash_levels=levels,
        hash_features=field["n_features_per_level"], hash_table_size=2 ** field["log2_hashmap_size"],
        hash_base_res=base, hash_max_res=max_res, hash_hidden=field["geo_n_neurons"],
        hash_depth=field["geo_n_hidden_layers"], feat_dim=field["feature_dim"],
        geometric_init_radius=field["sphere_init_radius"], color_hidden=field["tex_n_neurons"],
        color_depth=field["tex_n_hidden_layers"] + 1)


class Driver(DN.Driver):
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from dynhor_tpu_torch.neus import data as ND
        from dynhor_tpu_torch.neus import fields as NF
        from dynhor_tpu_torch.neus import rendering as NR
        from dynhor_tpu_torch.neus import trainer as NT
        from dynhor_tpu_torch.neus.draws import Key

        self.sdf_cfg = sdf_config(NF, config["field"])
        self.NR, self.device, self.config, self.traffic = NR, device, config, traffic
        r, t = config["render"], config["train"]
        mesh = SC.load_mesh(config, device)
        gen = SC.generator(seed, "neus_scene", device)
        fr = SC.neus_frames(mesh, SC.texture(gen, device), traffic["frames"], config["downscale"],
                            gen, device)
        self.frames = fr
        self.data = ND.ReconData(fr.images, fr.masks, fr.normals, fr.R_row, fr.Ts, fr.K)
        self.rcfg = NR.RenderConfig(**{k: r[k] for k in (
            "sampler", "n_candidates", "n_occ_samples", "occ_res", "n_shade", "bound", "n_coarse",
            "n_importance", "up_sample_steps")})
        self.tcfg = NT.TrainConfig(batch_rays=traffic["batch_rays"], lw_corr=0.0,
                                   seed=DN.field_seed(seed), **t)
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
                self.first = [st[p]["exp_avg"] / (1 - DN.BETA1) if "exp_avg" in st.get(p, {})
                              else torch.zeros_like(p) for p in params]
                bg = self.state.bg
                self.first.append(torch.zeros_like(bg) if bg.grad is None else bg.grad.detach().clone())
        p3 = [p.detach().clone() for p in params] + [self.state.bg.detach().clone()]
        self.checked = (torch.stack(losses), [b - a for a, b in zip(p0, p3)],
                        moments(self.state.opt, params))

    def layer_stats(self, trace) -> dict:
        """The MLPs' operations a step; the readers add the grid's from the
        program's count of the points it encoded."""
        return {"steps": trace.units, "unit_flops": CN.step_flops(self.config, self.traffic["batch_rays"]),
                "peak_flops": CR.PEAK_F32}

    def check(self):
        """The first ``checked_steps`` steps against the reference."""
        losses_p, change_p, moments_p = self.checked
        if not torch.isfinite(losses_p).all():
            self.failed += 1
        del self.state, self.occ
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        ref = reference(self.config, self.traffic, self.tcfg.seed, self.frames, self.device,
                        losses_p.shape[0])
        return compare(losses_p, self.first, change_p, moments_p, *ref)


def moments(opt, params) -> list:
    """Adam's first moment of each parameter (0 where it has none yet)."""
    st = opt.state
    return [st[p]["exp_avg"].detach().clone() if "exp_avg" in st.get(p, {}) else torch.zeros_like(p)
            for p in params]


def reference(config: dict, traffic: dict, seed: int, frames, device, steps: int, quant=None,
              grid_half: bool = False):
    """(losses, first gradients, changes, Adam's first moments) of the
    reference's first steps, in
    f32 with TF32 off (``quant`` rounds its products' operands;
    ``grid_half`` keeps the table and its interpolation in half)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        tr = RG.Trainer(seed, device, config["field"], config["render"],
                        {**config["train"], "batch_rays": traffic["batch_rays"]}, quant, grid_half)
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
        return (torch.stack(losses), grads, [p.detach() - a for p, a in zip(leaves, p0)],
                moments(tr.opt, list(tr.field.parameters())))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def control(config: dict, traffic: dict, seed: int, device) -> list:
    """The check's numbers when the reference in a lower precision takes the
    program's place: ``fp16.*`` with the table and its interpolation in half
    (tiny-cuda-nn's precision), ``tf32.*`` with its products' operands in
    TF32."""
    gen = SC.generator(seed, "neus_scene", device)
    mesh = SC.load_mesh(config, device)
    fr = SC.neus_frames(mesh, SC.texture(gen, device), traffic["frames"], config["downscale"], gen,
                        device)
    fs, n = DN.field_seed(seed), traffic["checked_steps"]
    ref = reference(config, traffic, fs, fr, device, n)
    out = []
    for name, kw in (("fp16", {"grid_half": True}), ("tf32", {"quant": RN.tf32})):
        ctl = reference(config, traffic, fs, fr, device, n, **kw)
        out += [(f"{name}.{k}", v, lim) for k, v, lim in compare(*ctl, *ref)]
    return out


def compare(losses_p, grads_p, change_p, moments_p, losses_r, grads_r, change_r, moments_r) -> list:
    """As ``drivers/neus.compare``, at this cell's limits; a program whose
    parameters are not the reference's, tensor by tensor, is refused."""
    shapes_p, shapes_r = [tuple(g.shape) for g in grads_p], [tuple(g.shape) for g in grads_r]
    if shapes_p != shapes_r:
        raise SystemExit(f"the program's parameters {shapes_p} are not the reference's {shapes_r}")

    def norms(xs):
        return torch.stack([x.double().norm() for x in xs])

    loss_gap = float(((losses_p.double() - losses_r.double()).abs() / losses_r.double().abs()).max())
    g_r, c_r = norms(grads_r), norms(change_r)
    grad_gap = TK.relative_gaps(norms(grads_p), g_r)
    # Leaves whose first gradient is nought to rounding move under Adam by
    # round-off alone: left out.  One whose first gradient is exactly 0 and
    # that moves later is kept: the table, whose first gradient is 0 while
    # the sphere init's zero columns of the first layer hide it.
    moved = (g_r >= 1e-3 * g_r.median()) | ((g_r == 0) & (c_r > 0))
    change_gap = TK.relative_gaps(norms(change_p)[moved], c_r[moved])
    # Each moment against its own size: the table's is about 1e-4 of the
    # median tensor's, which would hide it under ``relative_gaps``'s floor.
    m_p, m_r = norms(moments_p), norms(moments_r)
    moment_gap = float(((m_p - m_r).abs() / m_r.clamp_min(1e-300)).max())
    return [("loss_gap", loss_gap, LIMITS["loss_gap"]), ("grad_gap", grad_gap, LIMITS["grad_gap"]),
            ("change_gap", change_gap, LIMITS["change_gap"]),
            ("moment_gap", moment_gap, LIMITS["moment_gap"])]
