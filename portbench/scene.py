"""The twin scene every cell is made from: the mesh, its texture, the ViT's
weights, the frames, their masks and poses, all drawn from ``--seed`` on the
device.  The frames are rendered by the plain reference renderer
(``reference/raster.py``, ``reference/shading.py``), so the program and the
reference are handed the same inputs and nothing of the program makes them.
"""
from __future__ import annotations

import hashlib
import math
import os
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .reference import raster as RR
from .reference import shading as RS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Tensor = torch.Tensor
FRAME_HW = (480, 640)
FOCAL_FACTOR = 1.2  # f = 1.2 min(H, W), the tracker's synthesized intrinsics
BBOX_PAD = 5.0
SKIN = (0.86, 0.64, 0.52)


def generator(seed: int, label: str, device) -> torch.Generator:
    """A generator on ``device`` for one named stream of a run's seed."""
    digest = hashlib.sha256(f"{int(seed)}/{label}".encode()).digest()
    gen = torch.Generator(device=device)
    gen.manual_seed(int.from_bytes(digest[:8], "little") >> 1)
    return gen


class Mesh(NamedTuple):
    verts: Tensor  # (V, 3) f32, centred at the mean, largest norm 0.5
    faces: Tensor  # (F, 3) int64
    face_uvs: Tensor  # (F, 3, 2) f32


def load_mesh(config: dict, device) -> Mesh:
    """The configuration's OBJ (``mesh``, from the checkout's root), its
    triangles (fan-triangulated) with their corner UVs, normalized as the
    tracker loads a template.  Refuses a file whose SHA-256 is not the
    configuration's ``mesh_sha256``: the mesh is an input of the yardstick."""
    with open(os.path.join(ROOT, config["mesh"]), "rb") as f:
        raw = f.read()
    digest = hashlib.sha256(raw).hexdigest()
    if digest != config["mesh_sha256"]:
        raise SystemExit(f"{config['mesh']} has SHA-256 {digest}, not the configuration's "
                         f"{config['mesh_sha256']}")
    verts, uvs, fv, ft = [], [], [], []
    for line in raw.decode(errors="ignore").splitlines():
        p = line.split()
        if not p:
            continue
        if p[0] == "v":
            verts.append([float(x) for x in p[1:4]])
        elif p[0] == "vt":
            uvs.append([float(p[1]), float(p[2]) if len(p) > 2 else 0.0])
        elif p[0] == "f":
            idx = [(int(t.split("/")[0]) - 1, int(t.split("/")[1]) - 1) for t in p[1:]]
            for k in range(1, len(idx) - 1):
                fv.append((idx[0][0], idx[k][0], idx[k + 1][0]))
                ft.append((idx[0][1], idx[k][1], idx[k + 1][1]))
    v = np.asarray(verts, np.float32)
    v = v - v.mean(0, keepdims=True)
    v = (v / np.linalg.norm(v, axis=1).max() * 0.5).astype(np.float32)
    face_uvs = np.asarray(uvs, np.float32)[np.asarray(ft, np.int64)]
    return Mesh(torch.as_tensor(v, device=device), torch.as_tensor(np.asarray(fv, np.int64), device=device),
                torch.as_tensor(face_uvs, device=device))


def texture(gen: torch.Generator, device, size: int = 256) -> Tensor:
    """(size, size, 3) smooth colours in [0.1, 0.9]."""
    coarse = torch.rand((1, 3, 8, 8), generator=gen, device=device)
    tex = F.interpolate(coarse, size=(size, size), mode="bicubic", align_corners=True)
    return (0.1 + 0.8 * tex.clamp(0.0, 1.0))[0].permute(1, 2, 0).contiguous()


def vit_weights(vit: dict, gen: torch.Generator, device, dtype: torch.dtype) -> dict:
    """Random ViT weights in the tracker's layout, in ``dtype``: every
    matrix, token and position table trunc-normal(0, std) within two std,
    drawn as one buffer; norms 1 and 0; biases 0; LayerScale ``vit['layer_scale']``."""
    d, depth = vit["embed_dim"], vit["depth"]
    h = vit["mlp_ratio"] * d
    p = vit["patch_size"]
    grid = vit["smaller_edge_size"] // p
    std = vit["init_std"]
    shapes = {
        "cls_token": (1, 1, d), "pos_embed": (1, grid * grid + 1, d), "patch_kernel": (3 * p * p, d),
        "qkv_kernel": (depth, d, 3 * d), "proj_kernel": (depth, d, d),
        "fc1_kernel": (depth, d, h), "fc2_kernel": (depth, h, d),
    }
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.empty(total, device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, std, -2 * std, 2 * std, generator=gen)
    flat = flat.to(dtype)
    drawn, off = {}, 0
    for k, s in shapes.items():
        n = math.prod(s)
        drawn[k] = flat[off:off + n].view(s)
        off += n

    def full(value, *shape):
        return torch.full(shape, value, dtype=dtype, device=device)

    ls = vit["layer_scale"]
    return {
        "cls_token": drawn["cls_token"], "pos_embed": drawn["pos_embed"],
        "patch_kernel": drawn["patch_kernel"], "patch_bias": full(0.0, d),
        "blocks": {
            "norm1_scale": full(1.0, depth, d), "norm1_bias": full(0.0, depth, d),
            "qkv_kernel": drawn["qkv_kernel"], "qkv_bias": full(0.0, depth, 3 * d),
            "proj_kernel": drawn["proj_kernel"], "proj_bias": full(0.0, depth, d),
            "ls1": full(ls, depth, d),
            "norm2_scale": full(1.0, depth, d), "norm2_bias": full(0.0, depth, d),
            "fc1_kernel": drawn["fc1_kernel"], "fc1_bias": full(0.0, depth, h),
            "fc2_kernel": drawn["fc2_kernel"], "fc2_bias": full(0.0, depth, d),
            "ls2": full(ls, depth, d),
        },
        "norm_scale": full(1.0, d), "norm_bias": full(0.0, d),
    }


def rotations(n: int, gen: torch.Generator, device) -> Tensor:
    """(n, 3, 3) rotations uniform on SO(3) (unit quaternions)."""
    q = torch.randn((n, 4), generator=gen, device=device)
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
        2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
        2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y),
    ], -1).reshape(n, 3, 3)


def axis_angle(axis: Tensor, angle: Tensor) -> Tensor:
    """(n, 3) unit axes, (n,) radians -> (n, 3, 3) (Rodrigues)."""
    x, y, z = axis.unbind(-1)
    zero = torch.zeros_like(x)
    k = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], -1).reshape(-1, 3, 3)
    s, c = torch.sin(angle)[:, None, None], torch.cos(angle)[:, None, None]
    eye = torch.eye(3, device=axis.device).expand_as(k)
    return eye + s * k + (1 - c) * (k @ k)


def _unit_vectors(n: int, gen, device) -> Tensor:
    v = torch.randn((n, 3), generator=gen, device=device)
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def full_intrinsics(device, hw=FRAME_HW) -> Tensor:
    h, w = hw
    f = FOCAL_FACTOR * min(h, w)
    return torch.tensor([[f, 0.0, w // 2], [0.0, f, h // 2], [0.0, 0.0, 1.0]], device=device)


def crop_intrinsics(K: Tensor, box_xyxy: Tensor, size: int) -> Tensor:
    """Intrinsics of a square box of the frame resized to ``size``
    (half-pixel centres)."""
    side = box_xyxy[:, 2] - box_xyxy[:, 0]
    s = size / side
    cj = (box_xyxy[:, 0] + box_xyxy[:, 2]) / 2.0
    ci = (box_xyxy[:, 1] + box_xyxy[:, 3]) / 2.0
    out = torch.zeros((box_xyxy.shape[0], 3, 3), device=K.device)
    out[:, 0, 0] = s * K[0, 0]
    out[:, 1, 1] = s * K[1, 1]
    out[:, 0, 2] = (size - 1.0) / 2.0 + s * (K[0, 2] - cj)
    out[:, 1, 2] = (size - 1.0) / 2.0 + s * (K[1, 2] - ci)
    out[:, 2, 2] = 1.0
    return out


def render(mesh: Mesh, tex: Tensor, R_row: Tensor, t: Tensor, K: Tensor, hw, lights):
    """(rgba (B, H, W, 4), pix_to_face (B, H*W), verts_cam, vp) of the mesh
    under row-convention poses (X_cam = X @ R_row + t)."""
    verts_cam = mesh.verts @ R_row + t[:, None, :]
    vp = RS.project(verts_cam, K if K.dim() == 3 else K.expand(R_row.shape[0], 3, 3))
    pix_to_face, _ = RR.hard_raster(vp, mesh.faces, hw)
    rgba = RS.shade(pix_to_face, vp, verts_cam, mesh.faces, mesh.face_uvs, tex, lights, hw)
    return rgba, pix_to_face, verts_cam, vp


class TrackerFrames(NamedTuple):
    crop_images: Tensor  # (F, 3, S, S) in [0, 1]
    target_masks: Tensor  # (F, S, S) 1 object, 0 background, -1 hand
    K_rois: Tensor  # (F, 3, 3) crop intrinsics, pixels
    R_row: Tensor  # (F, 3, 3) true rotations
    t: Tensor  # (F, 3) true translations


def tracker_frames(mesh: Mesh, tex: Tensor, n_frames: int, crop: int, expansion: float,
                   gen: torch.Generator, device) -> TrackerFrames:
    """A hand-held object filmed at 480 x 640: the object turns 4 degrees a
    frame about one axis, moves in the image plane, and a hand (a skin-
    coloured ellipse) covers part of each crop; the crops are square boxes
    around the projected object, grown by ``expansion``."""
    h, w = FRAME_HW
    K = full_intrinsics(device)
    axis = _unit_vectors(1, gen, device).expand(n_frames, 3)
    ang = torch.arange(n_frames, device=device).float() * math.radians(4.0)
    R_row = axis_angle(axis, ang) @ rotations(1, gen, device)
    u = torch.rand((2,), generator=gen, device=device)
    du = torch.rand((2,), generator=gen, device=device)
    steps = torch.arange(n_frames, device=device).float()[:, None]
    centre = (torch.tensor([w / 2, h / 2], device=device) + (u - 0.5) * 160.0
              + (du - 0.5) * 6.0 * steps)
    z = 2.0 + 0.5 * torch.rand((n_frames, 1), generator=gen, device=device)
    xy = (centre - K[:2, 2]) / K[0, 0] * z
    t = torch.cat([xy, z], -1)
    vp = RS.project(mesh.verts @ R_row + t[:, None], K.expand(n_frames, 3, 3))
    lo, hi = vp[..., :2].amin(1) - BBOX_PAD, vp[..., :2].amax(1) + BBOX_PAD
    c, side = (lo + hi) / 2, (hi - lo).amax(-1, keepdim=True) * (1.0 + expansion)
    box = torch.cat([c - side / 2, c + side / 2], -1)
    K_rois = crop_intrinsics(K, box, crop)
    rgba, _, _, _ = render(mesh, tex, R_row, t, K_rois, (crop, crop), RS.PRIOR_LIGHTS)
    obj = rgba[..., 3] > 0.5
    bg = texture(gen, device, crop).permute(2, 0, 1)
    img = torch.where(obj[:, None], rgba[..., :3].permute(0, 3, 1, 2), bg[None])
    # The hand: an ellipse centred on an object pixel near the box's bottom.
    yy, xx = torch.meshgrid(torch.arange(crop, device=device).float() + 0.5,
                            torch.arange(crop, device=device).float() + 0.5, indexing="ij")
    hc = torch.rand((n_frames, 2), generator=gen, device=device) * torch.tensor(
        [0.5, 0.25], device=device) * crop + torch.tensor([0.25, 0.6], device=device) * crop
    radii = (0.08 + 0.08 * torch.rand((n_frames, 2), generator=gen, device=device)) * crop
    hand = (((xx - hc[:, 0, None, None]) / radii[:, 0, None, None]) ** 2
            + ((yy - hc[:, 1, None, None]) / radii[:, 1, None, None]) ** 2) <= 1.0
    skin = torch.tensor(SKIN, device=device).reshape(1, 3, 1, 1)
    img = torch.where(hand[:, None], skin, img)
    target = torch.where(hand, -1.0, obj.float())
    return TrackerFrames(img.contiguous(), target, K_rois, R_row, t)


def perturbed_inits(frames: TrackerFrames, max_deg: float, gen: torch.Generator):
    """Inits of one refine: each frame's true rotation turned by up to
    ``max_deg`` degrees (at least a third of it) about a random axis, its
    translation moved by up to 2 % of the depth sideways and 3 % in depth.
    Returns (R_row (F, 3, 3), t (F, 3))."""
    n, dev = frames.R_row.shape[0], frames.R_row.device
    ang = torch.deg2rad(max_deg * (1.0 / 3.0 + (2.0 / 3.0) * torch.rand((n,), generator=gen, device=dev)))
    R = axis_angle(_unit_vectors(n, gen, dev), ang) @ frames.R_row
    z = frames.t[:, 2:]
    dt = (torch.rand((n, 3), generator=gen, device=dev) * 2 - 1) * torch.cat(
        [0.02 * z, 0.02 * z, 0.03 * z], -1)
    return R, frames.t + dt


class NeusFrames(NamedTuple):
    images: Tensor  # (F, H, W, 3)
    masks: Tensor  # (F, H, W)
    normals: Tensor  # (F, H, W, 3) OpenGL-convention camera normals, 0 off the object
    R_row: Tensor  # (F, 3, 3)
    Ts: Tensor  # (F, 3)
    K: Tensor  # (3, 3)


def neus_frames(mesh: Mesh, tex: Tensor, n_frames: int, downscale: int,
                gen: torch.Generator, device) -> NeusFrames:
    """The twin's frames for the reconstruction: a turn of the object in
    front of the camera (``n_frames`` views spread over 360 degrees about a
    tilted axis, depth 2 to 2.4), at 480 x 640 / ``downscale``."""
    h, w = FRAME_HW[0] // downscale, FRAME_HW[1] // downscale
    K = full_intrinsics(device)
    K = torch.cat([K[:2] / downscale, K[2:]], 0)
    axis = _unit_vectors(1, gen, device).expand(n_frames, 3)
    ang = torch.arange(n_frames, device=device).float() * (2 * math.pi / n_frames)
    R_row = axis_angle(axis, ang) @ rotations(1, gen, device)
    z = 2.0 + 0.4 * torch.rand((n_frames, 1), generator=gen, device=device)
    xy = (torch.rand((n_frames, 2), generator=gen, device=device) - 0.5) * 0.2
    t = torch.cat([xy, z], -1)
    rgba, p2f, verts_cam, vp = render(mesh, tex, R_row, t, K, (h, w), RS.PRIOR_LIGHTS)
    n_cv = RS.normals_image(p2f, vp, verts_cam, mesh.faces, (h, w))
    n_gl = n_cv * torch.tensor([1.0, -1.0, -1.0], device=device)
    return NeusFrames(rgba[..., :3].contiguous(), rgba[..., 3].contiguous(), n_gl.contiguous(),
                      R_row, t, K)
