"""Overlay visualization of tracked poses (PyTorch; reference:
utils/visualizer.py).

Port of ``dynhor_tpu/visualizer.py``.  The reference renders through
pyrender + OSMesa with a pink material and three directional lights
(visualizer.py:12-56); as in the JAX package, the overlay here is the dense
hard raster with a flat-colour Phong material, so nothing needs GL.
"""
from __future__ import annotations

import numpy as np
import torch

from .ops import rasterize as rz
from .ops.shading import Lights, phong_shade
from .utils.device import resolve_device

BASE_COLOR = (0.8, 0.46, 0.51)  # visualizer.py:33 baseColorFactor


def _render_overlay(v: torch.Tensor, f: torch.Tensor, K: torch.Tensor, h: int, w: int):
    """(H, W, 4) RGBA of camera-frame verts v (V, 3) under K (3, 3)."""
    dev = v.device
    vc = v[None]
    vp = rz.project_perspective(vc, K)
    frag = rz.rasterize(vp, f, (h, w), face_chunk=1024)
    vn = rz.compute_vertex_normals(vc, f)
    lights = Lights(
        location=torch.tensor([0.0, -1.0, 0.0], device=dev),
        ambient=torch.tensor([0.45, 0.45, 0.45], device=dev),
        diffuse=torch.tensor([0.55, 0.55, 0.55], device=dev),
        specular=torch.tensor([0.05, 0.05, 0.05], device=dev),
    )
    tex = torch.ones((2, 2, 3), device=dev) * torch.tensor(BASE_COLOR, device=dev)
    fuv = torch.zeros((f.shape[0], 3, 2), device=dev) + 0.5
    return phong_shade(frag, f, vc, vn, fuv, tex, lights)[0]


class Visualizer:
    def __init__(self, img_shape: tuple[int, int]):
        self.img_shape = img_shape  # (H, W)

    def draw_mesh(
        self,
        input_image: np.ndarray,
        verts: np.ndarray,
        faces: np.ndarray,
        pred_camera: tuple[float, float, float, float],
        return_mask: bool = False,
        device: str | torch.device | None = None,
    ):
        """Render ``verts`` (camera frame, OpenCV convention) over the image.

        Args:
          input_image: (H, W, 3) float in [0, 1].
          pred_camera: (fx, fy, cx, cy).
          device: None = the CUDA card (raises without one); "cpu" renders
            on the CPU.

        Returns the (H, W, 3) numpy composite [, the (H, W, 1) bool overlay
        mask if return_mask].
        """
        dev = resolve_device(device)
        h, w = self.img_shape
        fx, fy, cx, cy = pred_camera
        K = torch.tensor([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]], dtype=torch.float32, device=dev)
        v = torch.as_tensor(np.asarray(verts, np.float32), device=dev)
        f = torch.as_tensor(np.asarray(faces), device=dev).long()
        with torch.inference_mode():
            rgba = _render_overlay(v, f, K, h, w).cpu().numpy()
        valid = rgba[:, :, 3:4] > 0
        out = np.where(valid, np.clip(rgba[:, :, :3], 0, 1), input_image)
        if return_mask:
            return out, valid
        return out
