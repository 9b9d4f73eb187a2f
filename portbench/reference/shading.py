"""Plain Phong shading with a bilinear UV texture, and the camera helpers
the twin scene and the references share.

``texel * (ambient + diffuse * relu(n.l)) + specular * relu(r.v)^64`` with
one point light in camera space; the normal, position and UV are the
winning face's corners weighted by the pixel's screen-space barycentrics.
Plain PyTorch only; this file imports nothing of the program.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .raster import barycentrics

Tensor = torch.Tensor


class Lights(NamedTuple):
    location: tuple[float, float, float]
    ambient: tuple[float, float, float]
    diffuse: tuple[float, float, float]
    specular: tuple[float, float, float]


# The tracker's two light sets: the prior views' (a light at the camera
# centre) and the fine loss's (PyTorch3D's PointLights defaults).
PRIOR_LIGHTS = Lights((0.0, 0.0, 0.0), (0.6, 0.6, 0.6), (0.4, 0.4, 0.5), (0.01, 0.01, 0.01))
FINE_LIGHTS = Lights((0.0, 1.0, 0.0), (0.5, 0.5, 0.5), (0.3, 0.3, 0.3), (0.2, 0.2, 0.2))


def project(verts_cam: Tensor, K: Tensor) -> Tensor:
    """(..., V, 3) camera-space points -> (u, v, z) pixels; K (..., 3, 3)."""
    z = verts_cam[..., 2:3]
    xy = verts_cam[..., :2] / torch.where(z.abs() < 1e-9, 1e-9, z)
    u = K[..., 0, 0][..., None] * xy[..., 0] + K[..., 0, 2][..., None]
    v = K[..., 1, 1][..., None] * xy[..., 1] + K[..., 1, 2][..., None]
    return torch.stack([u, v, verts_cam[..., 2]], dim=-1)


def unit(v: Tensor, eps2: float = 1e-12) -> Tensor:
    n2 = (v * v).sum(-1, keepdim=True)
    safe = n2 > eps2
    return torch.where(safe, v / torch.sqrt(torch.where(safe, n2, 1.0)), 0.0)


def vertex_normals(verts: Tensor, faces: Tensor) -> Tensor:
    """Area-weighted unit vertex normals; verts (B, V, 3), faces (F, 3)."""
    faces = faces.long()
    v0, v1, v2 = verts[:, faces[:, 0]], verts[:, faces[:, 1]], verts[:, faces[:, 2]]
    fn = torch.linalg.cross(v1 - v0, v2 - v0, dim=-1)
    vn = torch.zeros_like(verts)
    for k in range(3):
        vn = vn.index_add(1, faces[:, k], fn)
    return unit(vn)


def sample_texture(texture: Tensor, uv: Tensor) -> Tensor:
    """Bilinear lookup, v = 0 the bottom row, corners aligned; texture
    (Ht, Wt, 3), uv (..., 2) -> (..., 3)."""
    ht, wt = texture.shape[0], texture.shape[1]
    u = uv[..., 0].clamp(0.0, 1.0) * (wt - 1)
    v = (1.0 - uv[..., 1].clamp(0.0, 1.0)) * (ht - 1)
    x0, y0 = torch.floor(u).long(), torch.floor(v).long()
    x1, y1 = (x0 + 1).clamp_max(wt - 1), (y0 + 1).clamp_max(ht - 1)
    fx, fy = (u - x0)[..., None], (v - y0)[..., None]
    return (texture[y0, x0] * (1 - fx) * (1 - fy) + texture[y0, x1] * fx * (1 - fy)
            + texture[y1, x0] * (1 - fx) * fy + texture[y1, x1] * fx * fy)


def _corners(pix_to_face: Tensor, vp: Tensor, faces: Tensor, hw: tuple[int, int]):
    """(live (B, P), vertex ids (B, P, 3), frame index (B, 1, 1), bary (B, P, 3, 1)):
    each pixel's face and its screen-space barycentrics, 0 off the mesh."""
    h, w = hw
    live = pix_to_face >= 0
    vid = faces.long()[pix_to_face.clamp_min(0)]
    bi = torch.arange(vp.shape[0], device=vp.device)[:, None, None]
    cxy = vp[bi, vid][..., :2]  # (B, P, 3, 2)
    gx = (torch.arange(w, device=vp.device, dtype=torch.float32) + 0.5).repeat(h)
    gy = (torch.arange(h, device=vp.device, dtype=torch.float32) + 0.5).repeat_interleave(w)
    (w0, w1, w2), _ = barycentrics(cxy[..., 0, 0], cxy[..., 0, 1], cxy[..., 1, 0], cxy[..., 1, 1],
                                   cxy[..., 2, 0], cxy[..., 2, 1], gx, gy)
    bary = torch.where(live[..., None], torch.stack([w0, w1, w2], -1), 0.0)[..., None]
    return live, vid, bi, bary


def shade(pix_to_face: Tensor, vp: Tensor, verts_cam: Tensor, faces: Tensor, face_uvs: Tensor,
          texture: Tensor, lights: Lights, hw: tuple[int, int], shininess: float = 64.0,
          background: float = 1.0) -> Tensor:
    """RGBA (B, H, W, 4) of the pixels' faces (alpha the hit mask).
    Differentiable in vp's xy (through the barycentrics) and verts_cam."""
    h, w = hw
    live, vid, bi, bary = _corners(pix_to_face, vp, faces, hw)
    vn = vertex_normals(verts_cam, faces)
    pos = torch.where(live[..., None], (bary * verts_cam[bi, vid]).sum(-2), 0.0)
    nrm = unit(torch.where(live[..., None], (bary * vn[bi, vid]).sum(-2), 0.0))
    uv = torch.where(live[..., None], (bary * face_uvs[pix_to_face.clamp_min(0)]).sum(-2), 0.0)
    texel = sample_texture(texture, uv)

    def vec(x):
        return torch.tensor(x, dtype=torch.float32, device=vp.device)

    l_dir = unit(vec(lights.location) - pos)
    v_dir = unit(-pos)
    ndl = (nrm * l_dir).sum(-1, keepdim=True)
    refl = 2.0 * ndl * nrm - l_dir
    rdv = torch.relu((refl * v_dir).sum(-1, keepdim=True))
    rgb = texel * (vec(lights.ambient) + vec(lights.diffuse) * torch.relu(ndl))
    rgb = rgb + vec(lights.specular) * rdv**shininess
    rgb = torch.where(live[..., None], rgb, background)
    return torch.cat([rgb, live[..., None].float()], -1).reshape(vp.shape[0], h, w, 4)


def normals_image(pix_to_face: Tensor, vp: Tensor, verts_cam: Tensor, faces: Tensor,
                  hw: tuple[int, int]) -> Tensor:
    """(B, H, W, 3) interpolated unit camera-space normals (0 off the mesh)."""
    h, w = hw
    live, vid, bi, bary = _corners(pix_to_face, vp, faces, hw)
    n = unit((bary * vertex_normals(verts_cam, faces)[bi, vid]).sum(-2))
    return torch.where(live[..., None], n, 0.0).reshape(vp.shape[0], h, w, 3)
