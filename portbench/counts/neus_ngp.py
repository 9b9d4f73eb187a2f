"""Floating-point operations of one NeuS train step of instant-nsr-pl's
hash-grid field (a multiply-add counts as 2), from its widths.

The MLPs' matrix products are counted as ``counts/neus.py`` counts the PE
field's: 6 operations a multiply-add for a point in the loss, 12 for a
point whose SDF gradient the loss uses, the occupancy grid's forward once
per ``occ_update_every`` steps.  The grid's interpolation adds 8 corners x
F multiply-adds a level for every point encoded, counted from the
program's ``neus.encoded_points``.
"""
from __future__ import annotations


def sdf_macs(field: dict) -> int:
    """Multiply-adds of the geometry MLP a point: (3 + L F) -> width ...
    -> the feature."""
    dims = ([3 + field["n_levels"] * field["n_features_per_level"]]
            + [field["geo_n_neurons"]] * field["geo_n_hidden_layers"] + [field["feature_dim"]])
    return sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def color_macs(field: dict) -> int:
    """Multiply-adds of the texture MLP a point: feature + 16 SH + 3 normal
    -> width ... -> 3."""
    dims = ([field["feature_dim"] + 16 + 3] + [field["tex_n_neurons"]] * field["tex_n_hidden_layers"]
            + [3])
    return sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def step_flops(config: dict, rays: int) -> float:
    """The MLPs' operations of a step of ``rays`` rays."""
    f, r, t = config["field"], config["render"], config["train"]
    sdf, col = sdf_macs(f), color_macs(f)
    per_ray = r["n_occ_samples"] * 6 * sdf + r["n_shade"] * (12 * sdf + 6 * col)
    extra = t["n_eikonal_uniform"] * 12 * sdf + (128 + 16) * 6 * sdf
    occ = r["occ_res"] ** 3 * 2 * sdf / t["occ_update_every"]
    return float(rays * per_ray + extra + occ)


def interp_flops(field: dict, points: float) -> float:
    """The grid's interpolation over ``points`` encoded points."""
    return float(points) * field["n_levels"] * 8 * field["n_features_per_level"] * 2
