"""Plain reference of instant-nsr-pl's NeuS field (``configs/neus-blender.yaml``,
the ``geometry``, ``texture`` and ``variance`` blocks) and of one train step
with it, rendered, judged and trained by ``reference/neus.py``'s functions
with this field in place of the PE one.

The field, from its equations, in float32:

- input u = clip((x / bound + 1) / 2, 0, 1);
- level l of L: s_l = base * scale^l - 1 (rounded to f32), R_l = ceil(s_l)
  + 1; p = u s_l + 0.5, the cell c = floor(p), trilinear weights from p - c;
- a corner's row: where R_l^3 <= T, (c_x + R_l c_y + R_l^2 c_z) mod the
  level's rows (R_l^3 rounded up to 8); else (c_x ^ c_y 2654435761 ^ c_z
  805459861) mod 2^32 mod T; T = 2^log2_hashmap_size;
- h_l = sum over the 8 corners of weight x table row (F features);
  encoding [2u - 1, h_0 .. h_{L-1}];
- geometry: weight-normed linear layers (w = g v / |v| by output row),
  softplus(beta 100) between; sphere init: first layer bias 0, the grid's
  columns 0, the xyz columns N(0, sqrt(2 / width)); last layer bias -r,
  weights N(sqrt(pi / width), 1e-4); sdf = output 0, the feature = every
  output;
- texture: [feature, SH_4(d) (16, tiny-cuda-nn's real basis), n] through
  linear layers without biases (Xavier-uniform init), ReLU between, a
  sigmoid at the end; n is the analytic gradient of the sdf (taken with
  ``create_graph``, so the Eikonal and normal terms differentiate it);
- variance v, s = exp(10 v), from 0.3.

Departures from instant-nsr-pl, each as the port makes it: the domain is
the twin's [-1, 1]^3 (its ``radius`` 1.5 for Blender scenes); p is a
multiply and an add (tiny-cuda-nn's ``fmaf`` rounds once); SH of d itself
(instant-nsr-pl maps d to (d + 1) / 2 and tiny-cuda-nn back, in f32);
everything in float32 (tiny-cuda-nn keeps the table and the fused MLP in
half); NeuS's sampler of ``reference/neus.py`` (occupancy-grid candidates
and inverse-CDF sections) in place of nerfacc's marching; no learned
background.  ``grid_half`` computes the table and its interpolation in
half, tiny-cuda-nn's precision (the control).

Every random value is drawn at a path of ``reference/neus.py``'s key tree.
Plain PyTorch only; this file imports nothing of the program.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import neus as RN

Tensor = torch.Tensor
PRIMES = (1, 2654435761, 805459861)
SH_C = (0.28209479177387814, 0.48860251190291987, 1.0925484305920792, 0.94617469575755997,
        0.31539156525251999, 0.54627421529603959, 0.59004358992664352, 2.8906114426405538,
        0.45704579946446572, 0.3731763325901154, 1.4453057213202769)


def levels(cfg: dict) -> list[dict]:
    """Each level's scale s_l, vertices an axis R_l, rows, first row and
    whether it is dense."""
    t = 2 ** cfg["log2_hashmap_size"]
    out, first = [], 0
    for lvl in range(cfg["n_levels"]):
        s = float(np.float32(cfg["base_resolution"] * cfg["per_level_scale"] ** lvl - 1.0))
        r = int(math.ceil(s)) + 1
        dense = r**3 <= t
        rows = ((r**3 + 7) // 8) * 8 if dense else t
        out.append({"s": s, "R": r, "rows": rows, "first": first, "dense": dense})
        first += rows
    return out


def corner_rows(u: Tensor, cfg: dict):
    """For each level, the 8 corners' (rows (N,) int64, weights (N,)),
    corner i taking c + 1 on axis d where bit d of i is set."""
    out = []
    for lv in levels(cfg):
        p = u * torch.tensor(lv["s"], dtype=torch.float32, device=u.device) + 0.5
        c = torch.floor(p)
        f = p - c
        c = c.long()
        corners = []
        for i in range(8):
            bit = [(i >> d) & 1 for d in range(3)]
            cx, cy, cz = (c[:, d] + bit[d] for d in range(3))
            if lv["dense"]:
                row = (cx + lv["R"] * cy + lv["R"] * lv["R"] * cz) % lv["rows"]
            else:
                row = (((cx * PRIMES[0]) ^ (cy * PRIMES[1]) ^ (cz * PRIMES[2])) % 2**32) % lv["rows"]
            w = torch.ones_like(f[:, 0])
            for d in range(3):
                w = w * (f[:, d] if bit[d] else 1.0 - f[:, d])
            corners.append((row + lv["first"], w))
        out.append(corners)
    return out


def sh4(d: Tensor) -> Tensor:
    """Real spherical harmonics of degrees 0..3 of unit directions (N, 3),
    tiny-cuda-nn's signs and order."""
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    c = SH_C
    return torch.stack([
        torch.full_like(x, c[0]), -c[1] * y, c[1] * z, -c[1] * x,
        c[2] * x * y, -c[2] * y * z, c[3] * z * z - c[4], -c[2] * x * z, c[5] * (x * x - y * y),
        c[6] * y * (-3.0 * x * x + y * y),
        c[7] * x * y * z, c[8] * y * (1.0 - 5.0 * z * z), c[9] * z * (5.0 * z * z - 3.0),
        c[8] * x * (1.0 - 5.0 * z * z), c[10] * z * (x * x - y * y), c[6] * x * (-x * x + 3.0 * y * y),
    ], -1)


class Field(nn.Module):
    """The geometry (the table, g, v and bias of each layer), the texture
    layers and ``variance``, in that order of parameters."""

    def __init__(self, cfg: dict, key: RN.Key, quant=None, grid_half: bool = False):
        super().__init__()
        self.cfg, self.quant, self.grid_half = cfg, quant, grid_half
        dev = key.device
        self.variance = nn.Parameter(torch.tensor(0.3, device=dev))
        k_geo, k_tex = key.split()
        k_table, k_first, k_mid, k_last = k_geo.split(4)
        rows = sum(lv["rows"] for lv in levels(cfg))
        nf, hid, n_out = cfg["n_features_per_level"], cfg["geo_n_neurons"], cfg["feature_dim"]
        self.table = nn.Parameter(1e-4 * RN.draw(k_table, "uniform", (rows, nf), -1.0, 1.0))
        n_in = 3 + cfg["n_levels"] * nf
        std = math.sqrt(2.0) / math.sqrt(hid)
        vs = [torch.zeros((hid, n_in), device=dev)]
        vs[0][:, :3] = std * RN.draw(k_first, "normal", (hid, 3))
        vs += [std * RN.draw(k_mid.fold_in(i), "normal", (hid, hid))
               for i in range(cfg["geo_n_hidden_layers"] - 1)]
        vs.append(math.sqrt(math.pi) / math.sqrt(hid) + 1e-4 * RN.draw(k_last, "normal", (n_out, hid)))
        biases = [torch.zeros(hid, device=dev)] * (len(vs) - 1) + [
            torch.full((n_out,), -cfg["sphere_init_radius"], device=dev)]
        self.n_geo = len(vs)
        for i, (v, b) in enumerate(zip(vs, biases)):
            setattr(self, f"g{i}", nn.Parameter(torch.sqrt((v * v).sum(1, keepdim=True))))
            setattr(self, f"v{i}", nn.Parameter(v.clone()))
            setattr(self, f"b{i}", nn.Parameter(b.clone()))
        dims = [n_out + 16 + 3] + [cfg["tex_n_neurons"]] * cfg["tex_n_hidden_layers"] + [3]
        keys = k_tex.split(len(dims) - 1)
        self.n_tex = len(dims) - 1
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            lim = math.sqrt(6.0 / (a + b))
            setattr(self, f"t{i}", nn.Parameter(RN.draw(keys[i], "uniform", (b, a), -lim, lim)))

    def _mm(self, h: Tensor, w: Tensor, b=None) -> Tensor:
        if self.quant is not None:
            h, w = self.quant(h), self.quant(w)
        out = h @ w.T
        return out if b is None else out + b

    def encode(self, x: Tensor) -> Tensor:
        shape = x.shape[:-1]
        u = RN.clip((x.reshape(-1, 3) / self.cfg["radius"] + 1.0) / 2.0, 0.0, 1.0)
        table = self.table.half() if self.grid_half else self.table
        feats = [2.0 * u - 1.0]
        for corners in corner_rows(u, self.cfg):
            h = 0.0
            for row, w in corners:
                if self.grid_half:
                    w = w.half()
                h = h + table[row] * w[:, None]
            feats.append(h.float())
        return torch.cat(feats, -1).reshape(shape + (-1,))

    def sdf(self, x: Tensor):
        h = self.encode(x)
        for i in range(self.n_geo):
            g, v, b = (getattr(self, f"{k}{i}") for k in "gvb")
            h = self._mm(h, v * (g / torch.sqrt((v * v).sum(1, keepdim=True))), b)
            if i + 1 < self.n_geo:
                h = F.softplus(h, beta=100.0)
        return h[..., 0], h

    def rgb(self, x, dirs, normals, feat):
        shape = feat.shape[:-1]
        h = torch.cat([feat.reshape(-1, feat.shape[-1]), sh4(dirs.reshape(-1, 3)),
                       normals.reshape(-1, 3)], -1)
        for i in range(self.n_tex):
            h = self._mm(h, getattr(self, f"t{i}"))
            if i + 1 < self.n_tex:
                h = torch.relu(h)
        return torch.sigmoid(h).reshape(shape + (3,))

    def grad(self, x: Tensor) -> Tensor:
        keep = torch.is_grad_enabled()
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(self.sdf(xg)[0].sum(), xg, create_graph=keep)
        return g if keep else g.detach()


class Trainer(RN.Trainer):
    """``reference/neus.py``'s trainer with this field: Adam over every
    parameter at the one learning rate, the clip, the schedule, the band."""

    def __init__(self, seed: int, device, field_cfg: dict, rc: dict, tc: dict, quant=None,
                 grid_half: bool = False):
        self.field = Field(field_cfg, RN.Key(seed, device), quant, grid_half)
        self.rc, self.tc = rc, tc
        self.opt = torch.optim.Adam(self.field.parameters(), lr=tc["lr"], betas=(0.9, 0.999), eps=1e-8)
        self.bg = torch.zeros(3, device=device, requires_grad=True)
        self.step = 0
