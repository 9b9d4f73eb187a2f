"""Generate a synthetic demo sequence with the port (no JAX needed).

Twin of ``tools/make_demo_data.py``: a scripted trajectory of a mesh,
rendered with the port's ``rasterize``, ``phong_shade`` and
``compute_vertex_normals``.  Writes the same files:

  <out>/rgb/NNNN.jpg                 frames (grey background, a hand disc)
  <out>/sam_seg/NNNN.png             G channel = visible object, B = hand
                                     (run.py:84-85 convention)
  <out>/monocular_normal/NNNN.png    camera-space normals, (n + 1) / 2
  <out>/correspondence_infos/pairs_*.npz  matches of adjacent frames
  <out>/gt_poses.npz                 {R (o2c column), T, K} per frame

The start pose is drawn from ``torch.Generator().manual_seed(seed)``, so the
trajectory differs from the JAX tool's at the same seed.

    python -m dynhor_tpu_torch.tools.make_demo_data --out data/custom_shoes
    python -m dynhor_tpu_torch.tools.make_demo_data --out ... --device cpu
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..ops import rasterize as rz
from ..ops.shading import default_lights, phong_shade
from ..utils import camera as cam
from ..utils import geometry as G
from ..utils.device import resolve_device
from ..utils.objio import load_obj

SHOES = "assets/shoes/1229a2e6e97e_A_basketball_shoes_.obj"


def sample_surface(verts: np.ndarray, faces: np.ndarray, n: int, seed: int = 0):
    """Area-weighted uniform surface samples (``neus/extract.sample_surface``)."""
    if len(faces) == 0:
        return np.zeros((0, 3), np.float32)
    rng = np.random.RandomState(seed)
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    p = areas / max(areas.sum(), 1e-12)
    idx = rng.choice(len(faces), size=n, p=p)
    r1 = np.sqrt(rng.rand(n, 1))
    r2 = rng.rand(n, 1)
    return (1 - r1) * v0[idx] + r1 * (1 - r2) * v1[idx] + r1 * r2 * v2[idx]


def trajectory(r0: np.ndarray, i: int) -> tuple[np.ndarray, np.ndarray]:
    """Row-convention pose of frame i: a slow rotation about a fixed axis
    and a gentle drift."""
    ang = 0.05 * i
    c, s = np.cos(ang), np.sin(ang)
    Rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    cy, sy = np.cos(0.03 * i), np.sin(0.03 * i)
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32)
    t = np.array(
        [0.1 * np.sin(0.2 * i), 0.05 * np.cos(0.3 * i), 2.0 + 0.1 * np.sin(0.15 * i)],
        np.float32,
    )
    return (r0 @ Rz @ Ry).astype(np.float32), t


@torch.no_grad()
def _render_frame(verts, faces, face_uvs, texture, K, R_row, t, h, w):
    """(rgba (H, W, 4), camera-space normal image (H, W, 3) in [0, 1])."""
    verts_cam = (verts @ R_row + t)[None]
    vn = rz.compute_vertex_normals(verts_cam, faces)
    vp = rz.project_perspective(verts_cam, K)
    frag = rz.rasterize(vp, faces, (h, w), face_chunk=256)
    rgba = phong_shade(frag, faces, verts_cam, vn, face_uvs, texture, default_lights(verts.device))
    # Per-FACE geometric normals flipped toward the camera (vertex normals
    # cancel on meshes with mixed winding), OpenGL-encoded.
    fv = verts_cam[0][faces]  # (F, 3, 3)
    fn = torch.linalg.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0], dim=-1)
    n2 = (fn * fn).sum(-1, keepdim=True)
    fn = torch.where(n2 > 1e-20, fn / torch.sqrt(torch.where(n2 > 1e-20, n2, 1.0)), 0.0)
    toward = -torch.sign((fn * fv.mean(dim=1)).sum(-1, keepdim=True))
    fn = fn * torch.where(toward == 0, 1.0, toward)
    fid = frag.pix_to_face[0].reshape(-1).long()
    n_cam = torch.where(
        (fid >= 0)[:, None], fn[fid.clamp_min(0)], 0.0
    ).reshape(h, w, 3)  # the face's normal is constant over it
    n_gl = n_cam * torch.tensor([1.0, -1.0, -1.0], device=verts.device)
    return rgba[0].cpu().numpy(), ((n_gl + 1.0) / 2.0).cpu().numpy()


def write_sequence(
    out: str,
    obj: str = SHOES,
    frames: int = 12,
    height: int = 480,
    width: int = 640,
    hand: bool = True,
    seed: int = 0,
    correspondences: bool = True,
    normals: bool = True,
    device: str | torch.device | None = None,
    verbose: bool = True,
) -> None:
    """Write the sequence under ``out`` (see the module docstring).
    ``device``: None = the CUDA card (raises without one); "cpu"."""
    from PIL import Image

    dev = resolve_device(device)
    mesh = load_obj(obj)
    verts = G.center_and_normalize_verts(torch.as_tensor(mesh.verts, device=dev))
    faces = torch.as_tensor(mesh.faces, device=dev).long()
    face_uvs = torch.as_tensor(mesh.face_uvs, device=dev)
    texture = torch.as_tensor(mesh.texture, device=dev)
    h, w = height, width
    K = cam.intrinsics_from_image(h, w, device=dev)

    for sub, on in (("rgb", True), ("sam_seg", True),
                    ("correspondence_infos", correspondences), ("monocular_normal", normals)):
        if on:
            os.makedirs(os.path.join(out, sub), exist_ok=True)

    r0 = G.random_rotations(1, torch.Generator().manual_seed(seed))[0].numpy()
    Rs_out, Ts_out, vis_masks = [], [], []
    for i in range(frames):
        R_row, t = trajectory(r0, i)
        rgba, normal_img = _render_frame(
            verts, faces, face_uvs, texture, K, torch.as_tensor(R_row, device=dev),
            torch.as_tensor(t, device=dev), h, w,
        )
        obj_mask = rgba[:, :, 3] > 0.5
        rgb = np.clip(rgba[:, :, :3], 0, 1)
        rgb = np.where(obj_mask[:, :, None], rgb, 0.45)  # grey background

        # Synthetic "hand": a disc occluding part of the object from below.
        hand_mask = np.zeros((h, w), bool)
        if hand:
            ys, xs = np.nonzero(obj_mask)
            if len(ys):
                cx = int(xs.mean())
                cy = int(ys.max())
                rr = max(8, int(0.25 * (ys.max() - ys.min())))
                yy, xx = np.mgrid[0:h, 0:w]
                hand_mask = (yy - cy) ** 2 + (xx - cx) ** 2 < rr**2
                rgb = np.where(hand_mask[:, :, None], np.array([0.75, 0.55, 0.45]), rgb)
        # SAM convention: the hand occludes the object.
        visible_obj = obj_mask & ~hand_mask

        seg = np.zeros((h, w, 3), np.uint8)
        seg[:, :, 1] = visible_obj.astype(np.uint8) * 255
        seg[:, :, 2] = hand_mask.astype(np.uint8) * 255

        fid = f"{i:04d}"
        Image.fromarray((rgb * 255).astype(np.uint8)).save(
            os.path.join(out, "rgb", fid + ".jpg"), quality=95
        )
        Image.fromarray(seg).save(os.path.join(out, "sam_seg", fid + ".png"))
        if normals:
            nimg = np.where(obj_mask[:, :, None], normal_img, 0.5)
            Image.fromarray((np.clip(nimg, 0, 1) * 255).astype(np.uint8)).save(
                os.path.join(out, "monocular_normal", fid + ".png")
            )
        Rs_out.append(R_row.T)  # o2c column convention (npz parity)
        Ts_out.append(t)
        vis_masks.append(visible_obj)
        if verbose:
            print(f"frame {fid}: obj px {int(visible_obj.sum())}, hand px {int(hand_mask.sum())}")

    K_np = K.cpu().numpy()
    if correspondences:
        surf = sample_surface(
            verts.cpu().numpy(), mesh.faces.astype(np.int64), 400, seed=1
        ).astype(np.float32)
        K_t = torch.as_tensor(K_np)
        for i in range(frames - 1):
            ua, ub = (
                cam.batch_proj2d(torch.as_tensor(surf @ Rs_out[k].T + Ts_out[k])[None], K_t[None])[0].numpy()
                for k in (i, i + 1)
            )
            ok = (
                (ua[:, 0] >= 1) & (ua[:, 0] < w - 1) & (ua[:, 1] >= 1) & (ua[:, 1] < h - 1)
                & (ub[:, 0] >= 1) & (ub[:, 0] < w - 1) & (ub[:, 1] >= 1) & (ub[:, 1] < h - 1)
            )
            # Keep matches that land on the visible object in both frames.
            ok &= vis_masks[i][ua[:, 1].astype(int).clip(0, h - 1), ua[:, 0].astype(int).clip(0, w - 1)]
            ok &= vis_masks[i + 1][ub[:, 1].astype(int).clip(0, h - 1), ub[:, 0].astype(int).clip(0, w - 1)]
            if ok.sum() < 8:
                continue
            np.savez(
                os.path.join(out, "correspondence_infos", f"pairs_{i:04d}_{i + 1:04d}.npz"),
                frame_i=f"{i:04d}", frame_j=f"{i + 1:04d}",
                xy_i=ua[ok].astype(np.float32), xy_j=ub[ok].astype(np.float32),
            )
        if verbose:
            print(f"wrote correspondences for {frames - 1} adjacent pairs")

    np.savez(
        os.path.join(out, "gt_poses.npz"), R=np.stack(Rs_out), T=np.stack(Ts_out), K=K_np
    )
    if verbose:
        print(f"wrote {frames} frames to {out}")


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", type=str, default="data/custom_shoes")
    parser.add_argument("--obj", type=str, default=SHOES)
    parser.add_argument("--frames", type=int, default=12)
    parser.add_argument("--height", type=int, default=480)
    parser.add_argument("--width", type=int, default=640)
    parser.add_argument("--hand", action=argparse.BooleanOptionalAction, default=True)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--correspondences", action=argparse.BooleanOptionalAction, default=True,
        help="write DKM-style correspondence_infos npz for adjacent frames",
    )
    parser.add_argument(
        "--normals", action=argparse.BooleanOptionalAction, default=True,
        help="write monocular_normal maps (from the rendered geometry)",
    )
    parser.add_argument(
        "--device", type=str, default=None,
        help="torch device; the default is the CUDA card (no CPU fallback)",
    )
    args = parser.parse_args(argv)
    write_sequence(
        args.out, args.obj, args.frames, args.height, args.width, args.hand, args.seed,
        args.correspondences, args.normals, args.device,
    )


if __name__ == "__main__":
    main()
