"""Phong shading + UV texture sampling (PyTorch, differentiable, batched
over frames).

Port of ``dynhor_tpu/ops/shading.py``.  Replaces PyTorch3D's
SoftPhongShader + TexturesUV (reference: pose_initializtion.py:417-419):
``texel * (ambient + diffuse * relu(n.l)) + specular * relu(r.v)^shininess``
with one point light.  Faces, face UVs and textures are either one mesh's,
shared by the B frames ((F, 3), (F, 3, 2), (Ht, Wt, 3)), or a mesh per
frame ((B, F, 3), (B, F, 3, 2), and (B, Ht, Wt, 3) or a ``TextureSet``:
the pooled multi-sequence batch, whose frames of one sequence share one
copy of its texture).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .rasterize import Fragments, face_verts

Tensor = torch.Tensor


class TextureSet(NamedTuple):
    """The textures of a batch with a mesh per frame, one copy each: frame
    b samples ``textures[index[b]]`` (so the frames of one sequence share a
    texture, where the JAX package holds a copy per frame)."""

    textures: Tensor  # (S, Ht, Wt, 3)
    index: Tensor  # (B,) int64


class Lights(NamedTuple):
    """Point light in CAMERA space."""

    location: Tensor  # (3,)
    ambient: Tensor  # (3,)
    diffuse: Tensor  # (3,)
    specular: Tensor  # (3,)


def default_lights(device, dtype=torch.float32) -> Lights:
    """The reference's prior-view lighting (render.py:140-146): a point
    light at the camera center, ambient 0.6, diffuse (0.4, 0.4, 0.5),
    specular 0.01."""

    def vec(*v):
        return torch.tensor(v, dtype=dtype, device=device)

    return Lights(
        location=vec(0.0, 0.0, 0.0),
        ambient=vec(0.6, 0.6, 0.6),
        diffuse=vec(0.4, 0.4, 0.5),
        specular=vec(0.01, 0.01, 0.01),
    )


def fine_lights(device, dtype=torch.float32) -> Lights:
    """PyTorch3D PointLights defaults — the fine-loss textured render uses
    SoftPhongShader with no explicit lights (pose_initializtion.py:417-419):
    location (0, 1, 0), ambient 0.5, diffuse 0.3, specular 0.2."""

    def vec(*v):
        return torch.tensor(v, dtype=dtype, device=device)

    return Lights(
        location=vec(0.0, 1.0, 0.0),
        ambient=vec(0.5, 0.5, 0.5),
        diffuse=vec(0.3, 0.3, 0.3),
        specular=vec(0.2, 0.2, 0.2),
    )


def sample_texture(texture: Tensor, uv: Tensor) -> Tensor:
    """Bilinear UV texture sampling (TexturesUV semantics: v up,
    align_corners).  texture (Ht, Wt, 3); or (B, Ht, Wt, 3), one a frame,
    or a TextureSet, with uv (B, ..., 2); uv in [0, 1], v=0 the BOTTOM of
    the image.  Returns (..., 3)."""
    frame_tex = None
    if isinstance(texture, TextureSet):
        texture, frame_tex = texture
    elif texture.dim() == 4:
        frame_tex = torch.arange(texture.shape[0], device=uv.device)
    ht, wt = texture.shape[-3], texture.shape[-2]
    u = uv[..., 0].clamp(0.0, 1.0) * (wt - 1)
    v = (1.0 - uv[..., 1].clamp(0.0, 1.0)) * (ht - 1)
    x0 = torch.floor(u).long()
    y0 = torch.floor(v).long()
    x1 = (x0 + 1).clamp_max(wt - 1)
    y1 = (y0 + 1).clamp_max(ht - 1)
    fx = (u - x0)[..., None]
    fy = (v - y0)[..., None]
    if frame_tex is not None:
        bi = frame_tex.reshape((-1,) + (1,) * (uv.dim() - 2))
        t00, t01 = texture[bi, y0, x0], texture[bi, y0, x1]
        t10, t11 = texture[bi, y1, x0], texture[bi, y1, x1]
    else:
        t00, t01 = texture[y0, x0], texture[y0, x1]
        t10, t11 = texture[y1, x0], texture[y1, x1]
    return (
        t00 * (1 - fx) * (1 - fy)
        + t01 * fx * (1 - fy)
        + t10 * (1 - fx) * fy
        + t11 * fx * fy
    )


def pack_shading_rows(
    faces: Tensor, verts_cam: Tensor, vert_normals_cam: Tensor, face_uvs: Tensor
) -> Tensor:
    """All per-face shading attributes in ONE (B, F, 24) record, so each
    pixel does a single row gather instead of chained faces -> attr ones."""
    b = verts_cam.shape[0]
    f = faces.shape[-2]
    uvs = face_uvs.reshape(-1, f, 6)
    return torch.cat(
        [
            face_verts(verts_cam, faces).reshape(b, f, 9),
            face_verts(vert_normals_cam, faces).reshape(b, f, 9),
            uvs.expand(b, -1, -1) if uvs.shape[0] == 1 else uvs,
        ],
        dim=-1,
    )


def _safe_unit(v: Tensor, eps2: float = 1e-12) -> Tensor:
    # Double-where normalization: clean zero + zero gradient at v = 0.
    n2 = (v * v).sum(-1, keepdim=True)
    safe = n2 > eps2
    n2_safe = torch.where(safe, n2, 1.0)
    return torch.where(safe, v / torch.sqrt(n2_safe), 0.0)


def _shade_flat(
    packed: Tensor,
    fid: Tensor,
    bary: Tensor,
    texture: Tensor,
    lights: Lights,
    shininess: float,
    background: float,
) -> tuple[Tensor, Tensor]:
    """Phong-shade flat pixel lists: packed (B, F, 24), fid (B, P),
    bary (B, P, 3).  Returns (rgb (B, P, 3), live (B, P, 1))."""
    b, f = packed.shape[:2]
    idx = fid.long().clamp(0, f - 1)
    rows = torch.gather(packed, 1, idx[..., None].expand(-1, -1, 24))  # (B, P, 24)
    bk = bary[..., None]
    pos = (bk * rows[..., 0:9].reshape(b, -1, 3, 3)).sum(2)
    nrm = (bk * rows[..., 9:18].reshape(b, -1, 3, 3)).sum(2)
    uv = (bk * rows[..., 18:24].reshape(b, -1, 3, 2)).sum(2)
    live = (fid >= 0)[..., None]
    pos = torch.where(live, pos, 0.0)
    nrm = _safe_unit(torch.where(live, nrm, 0.0))
    uv = torch.where(live, uv, 0.0)
    texel = sample_texture(texture, uv)

    l_dir = _safe_unit(lights.location - pos)
    v_dir = _safe_unit(-pos)
    ndl_raw = (nrm * l_dir).sum(-1, keepdim=True)
    refl = 2.0 * ndl_raw * nrm - l_dir
    rdv = torch.relu((refl * v_dir).sum(-1, keepdim=True))
    spec = lights.specular * rdv**shininess
    rgb = texel * (lights.ambient + lights.diffuse * torch.relu(ndl_raw)) + spec
    rgb = torch.where(live, rgb, background)
    return rgb, live


def phong_shade(
    fragments: Fragments,
    faces: Tensor,
    verts_cam: Tensor,
    vert_normals_cam: Tensor,
    face_uvs: Tensor,
    texture: Tensor,
    lights: Lights,
    shininess: float = 64.0,
    background: float = 1.0,
) -> Tensor:
    """Shade hit pixels; returns (B, H, W, 4) RGBA (alpha = hit mask).

    Args:
      fragments: (B, H, W) maps; faces (F, 3) or (B, F, 3); verts_cam,
      vert_normals_cam (B, V, 3) camera space (differentiable); face_uvs
      (F, 3, 2) or (B, F, 3, 2); texture (Ht, Wt, 3), (B, Ht, Wt, 3) or a
      TextureSet.
    """
    b, h, w = fragments.pix_to_face.shape
    packed = pack_shading_rows(faces, verts_cam, vert_normals_cam, face_uvs)
    rgb, live = _shade_flat(
        packed, fragments.pix_to_face.reshape(b, -1),
        fragments.bary.reshape(b, -1, 3), texture, lights, shininess, background,
    )
    return torch.cat([rgb, live.to(rgb.dtype)], dim=-1).reshape(b, h, w, 4)


def phong_shade_tiles(
    compact,
    image_size: tuple[int, int],
    tile: int,
    faces: Tensor,
    verts_cam: Tensor,
    vert_normals_cam: Tensor,
    face_uvs: Tensor,
    texture: Tensor,
    lights: Lights,
    shininess: float = 64.0,
    background: float = 1.0,
) -> Tensor:
    """phong_shade over ACTIVE raster tiles only; returns dense (B, H, W, 4).

    Shades the compacted (t_act x tile²) pixel list of
    ops/raster_fused.CompactTiles and scatters RGBA into the constant
    background: pixels of inactive tiles are exactly ``background`` with
    alpha 0, identical to the dense result (a hit needs a candidate face,
    hence an active tile).
    """
    h, w = image_size
    th, tw = -(-h // tile), -(-w // tile)
    t_total, p_tile = th * tw, tile * tile
    b, t_act = compact.fid.shape[:2]
    packed = pack_shading_rows(faces, verts_cam, vert_normals_cam, face_uvs)
    rgb, live = _shade_flat(
        packed, compact.fid.reshape(b, -1), compact.bary.reshape(b, -1, 3),
        texture, lights, shininess, background,
    )
    rgba_c = torch.cat([rgb, live.to(rgb.dtype)], dim=-1).reshape(b, t_act, p_tile, 4)
    base = torch.cat(
        [
            rgb.new_full((b, t_total + 1, p_tile, 3), background),
            rgb.new_zeros((b, t_total + 1, p_tile, 1)),
        ],
        dim=-1,
    )  # one spare row takes the sentinel ids of padding rows
    idx = compact.act_ids[:, :, None, None].expand(-1, -1, p_tile, 4)
    dense = base.scatter(1, idx, rgba_c)[:, :t_total]
    return (
        dense.reshape(b, th, tw, tile, tile, 4)
        .transpose(2, 3)
        .reshape(b, th * tile, tw * tile, 4)[:, :h, :w]
    )
