"""Floating-point operations of one NeuS train step (a multiply-add
counts as 2), from the networks' widths.

Matrix products only.  A point that takes part in the loss costs its
network's forward, and a backward into inputs and weights twice that: 6
operations a multiply-add.  A point whose SDF gradient the loss uses (the
shaded sections, the uniform Eikonal points) costs the forward and the
backward into the input (4), and the loss's backward through both twice
that again (8): 12.  The occupancy grid's forward over R³ cell centres
counts once per ``occ_update_every`` steps.
"""
from __future__ import annotations


def sdf_macs(field: dict) -> int:
    in_dim = 3 + 6 * field["pe_freqs"]
    hid, depth, skip = field["hidden"], field["depth"], field["skip_layer"]
    dims = [in_dim] + [hid] * depth
    macs = sum((dims[i] + (in_dim if i == skip else 0)) * dims[i + 1] for i in range(depth))
    return macs + hid * (1 + field["feat_dim"])


def color_macs(field: dict) -> int:
    c_in = 3 + (3 + 6 * field["dir_freqs"]) + 3 + field["feat_dim"]
    dims = [c_in] + [field["color_hidden"]] * (field["color_depth"] - 1) + [3]
    return sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def step_flops(config: dict, rays: int) -> float:
    f, r, t = config["field"], config["render"], config["train"]
    sdf, col = sdf_macs(f), color_macs(f)
    per_ray = r["n_occ_samples"] * 6 * sdf + r["n_shade"] * (12 * sdf + 6 * col)
    extra = t["n_eikonal_uniform"] * 12 * sdf + (128 + 16) * 6 * sdf
    occ = r["occ_res"] ** 3 * 2 * sdf / t["occ_update_every"]
    return float(rays * per_ray + extra + occ)
