"""What the tracker's cells share: the twin scene of a configuration, the
ViT's weights, and the comparison arithmetic of their checks."""
from __future__ import annotations

import torch

from .. import scene as SC

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class TrackerScene:
    """The mesh, its texture, the ViT weights and the frames of one seed."""

    def __init__(self, config: dict, n_frames: int, seed: int, device):
        self.config = config
        self.device = device
        self.mesh = SC.load_mesh(config, device)
        gen = SC.generator(seed, "scene", device)
        self.tex = SC.texture(gen, device)
        self.frames = SC.tracker_frames(self.mesh, self.tex, n_frames, config["crop_size"],
                                        config["bbox_expansion"], gen, device)
        vit = config["vit"]
        self.params = SC.vit_weights(vit, SC.generator(seed, "vit", device), device,
                                     DTYPES[vit["dtype"]])

    def dino_config(self):
        """The port's ViT configuration at this configuration's widths, its
        other settings (attention, recomputation) the port's defaults."""
        from dynhor_tpu_torch.models import dino as D

        vit = self.config["vit"]
        return D.DinoConfig(patch_size=vit["patch_size"], embed_dim=vit["embed_dim"],
                            depth=vit["depth"], num_heads=vit["num_heads"],
                            mlp_ratio=vit["mlp_ratio"], pos_grid=vit["smaller_edge_size"] // vit["patch_size"],
                            smaller_edge_size=vit["smaller_edge_size"])

    def params_f32(self) -> dict:
        def f32(d):
            return {k: f32(v) if isinstance(v, dict) else v.float() for k, v in d.items()}

        return f32(self.params)


def relative_gaps(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest |prog - ref| over the leaves (the last axis of a (..., L)
    array), each against the larger of its own |ref| and the median leaf's."""
    prog, ref = prog.double(), ref.double()
    scale = torch.maximum(ref.abs(), ref.abs().median())
    return float(((prog - ref).abs() / scale.clamp_min(1e-300)).max())
