"""Ingest validation for the reference data convention (README.md:27-44).

Real sequences arrive from external models — SAM-v2 segmentations,
StableNormal monocular normals, DKM correspondences — written by
preprocessing scripts we don't control.  The reference consumes them with
zero validation (run.py:74-88 indexes channels blind), so a miswired
export (wrong channel order, anti-aliased masks, normalized-coordinate
correspondences, mismatched sizes) silently mis-tracks.  This module
checks the directory convention:

  <seq>/rgb/*.png|jpg            target frames
  <seq>/sam_seg/<fid>.png        >=3-channel masks, G==255 object,
                                 B==255 hand (run.py:84-85)
  <seq>/monocular_normal/<fid>.png  (optional) camera-space normals,
                                 encoded (n+1)/2 in RGB
  <seq>/correspondence_infos/*.npz  (optional) {frame_i, frame_j,
                                 xy_i (M,2), xy_j (M,2)} pixel coords

and reports actionable findings.  ERROR findings mean the tracker or the
NeuS stage would crash or silently corrupt; WARNING findings are suspect
but loadable.  ``validate_dataroot`` is importable (the pipeline driver
runs it before loading); ``tools/ingest_data.py`` is the CLI.

A copy of ``dynhor_tpu/io/ingest.py`` (numpy and PIL): the same findings,
word for word, on the same inputs.
"""
from __future__ import annotations

import glob as globlib
import os
from typing import NamedTuple

import numpy as np


class Finding(NamedTuple):
    level: str  # "error" | "warning" | "info"
    where: str  # file or directory the finding is about
    message: str

    def __str__(self) -> str:  # pragma: no cover - formatting
        return f"[{self.level.upper():7s}] {self.where}: {self.message}"


class IngestError(RuntimeError):
    """Raised by validate_or_raise when ERROR findings exist."""

    def __init__(self, findings: list[Finding]):
        self.findings = findings
        errs = [str(f) for f in findings if f.level == "error"]
        super().__init__(
            "dataset validation failed:\n  " + "\n  ".join(errs)
        )


def _err(out, where, msg):
    out.append(Finding("error", where, msg))


def _warn(out, where, msg):
    out.append(Finding("warning", where, msg))


def _info(out, where, msg):
    out.append(Finding("info", where, msg))


def validate_dataroot(
    dataroot: str, max_frames: int | None = None
) -> list[Finding]:
    """Validate a sequence directory; returns findings (possibly empty).

    Args:
      max_frames: cap on per-frame image decodes (None = all frames).
    """
    from PIL import Image

    out: list[Finding] = []
    if not os.path.isdir(dataroot):
        _err(out, dataroot, "sequence directory does not exist")
        return out

    # --- rgb ---------------------------------------------------------------
    rgb_dir = os.path.join(dataroot, "rgb")
    jpgs = sorted(globlib.glob(os.path.join(rgb_dir, "*.jpg")))
    pngs = sorted(globlib.glob(os.path.join(rgb_dir, "*.png")))
    if not os.path.isdir(rgb_dir):
        _err(out, rgb_dir, "missing rgb/ directory")
        return out
    if not jpgs and not pngs:
        _err(out, rgb_dir, "no *.jpg or *.png frames")
        return out
    if jpgs and pngs:
        # Loader quirk preserved from the reference (run.py:99 globs .jpg
        # first): when both exist, the pngs are silently ignored.
        _warn(
            out, rgb_dir,
            f"both .jpg ({len(jpgs)}) and .png ({len(pngs)}) present; the "
            "loader uses ONLY the .jpg frames (reference run.py:99 quirk)",
        )
    paths = jpgs or pngs
    frame_ids = [os.path.basename(p)[:-4] for p in paths]
    if max_frames is not None:
        paths = paths[:max_frames]

    shape = None
    for p in paths:
        try:
            img = np.asarray(Image.open(p).convert("RGB"))
        except Exception as e:  # noqa: BLE001 — report any decode failure
            _err(out, p, f"undecodable image ({type(e).__name__}: {e})")
            continue
        if shape is None:
            shape = img.shape[:2]
        elif img.shape[:2] != shape:
            _err(
                out, p,
                f"frame size {img.shape[:2]} != first frame {shape} — the "
                "tracker assumes one size per sequence (run.py:101)",
            )
    if shape is None:
        return out
    h, w = shape

    # --- sam_seg -----------------------------------------------------------
    seg_dir = os.path.join(dataroot, "sam_seg")
    if not os.path.isdir(seg_dir):
        _err(out, seg_dir, "missing sam_seg/ directory (SAM-v2 masks)")
        return out
    n_obj_empty, n_soft, n_r_only, n_obj_eq_hand, any_hand = 0, 0, 0, 0, False
    checked = paths if max_frames is None else paths[:max_frames]
    for p in checked:
        fid = os.path.basename(p)[:-4]
        sp = os.path.join(seg_dir, fid + ".png")
        if not os.path.exists(sp):
            _err(out, sp, "no segmentation for this rgb frame id")
            continue
        seg = np.asarray(Image.open(sp))
        if seg.ndim != 3 or seg.shape[2] < 3:
            _err(
                out, sp,
                f"expected >=3 channels (G=object, B=hand, run.py:84-85), "
                f"got shape {seg.shape}",
            )
            continue
        if seg.shape[:2] != (h, w):
            _err(out, sp, f"mask size {seg.shape[:2]} != rgb size {(h, w)}")
            continue
        g, b = seg[:, :, 1], seg[:, :, -1]
        obj = g == 255
        hand = b == 255
        any_hand = any_hand or bool(hand.any())
        if not obj.any():
            n_obj_empty += 1
            r_obj = seg[:, :, 0] == 255
            if r_obj.any():
                n_r_only += 1
        # Anti-aliased / probability masks: the ==255 test drops every
        # soft pixel, shrinking the object silently.
        soft = ((g > 0) & (g < 255)).mean()
        if soft > 0.005:
            n_soft += 1
        if obj.any() and bool((obj == hand).all()):
            n_obj_eq_hand += 1
        if obj.mean() > 0.9:
            _warn(
                out, sp,
                f"object mask covers {obj.mean():.0%} of the frame — "
                "inverted mask?",
            )
    if n_obj_empty:
        msg = (
            f"{n_obj_empty}/{len(checked)} frames have an EMPTY object mask "
            "(G channel == 255 nowhere) — the tracker requires an object in "
            "every frame (pipeline.process_frames)"
        )
        if n_r_only:
            msg += (
                f"; {n_r_only} of them have R==255 pixels — the channels "
                "look miswired (object must be G, hand B; run.py:84-85)"
            )
        _err(out, seg_dir, msg)
    if n_soft:
        _warn(
            out, seg_dir,
            f"{n_soft}/{len(checked)} masks have anti-aliased / soft G "
            "values in (0,255) — only exact 255 counts as object; "
            "re-export with hard masks",
        )
    if n_obj_eq_hand:
        _warn(
            out, seg_dir,
            f"{n_obj_eq_hand}/{len(checked)} frames have object mask == "
            "hand mask — duplicated channel in the export?",
        )
    if not any_hand:
        _info(
            out, seg_dir,
            "no hand pixels (B==255) in any checked frame — occlusion "
            "handling will be a no-op (fine for unoccluded sequences)",
        )

    # --- monocular_normal (optional) ----------------------------------------
    nrm_dir = os.path.join(dataroot, "monocular_normal")
    if os.path.isdir(nrm_dir):
        n_missing = 0
        norm_samples = []
        for p in checked:
            fid = os.path.basename(p)[:-4]
            np_path = os.path.join(nrm_dir, fid + ".png")
            if not os.path.exists(np_path):
                n_missing += 1
                continue
            nimg = np.asarray(Image.open(np_path))
            if nimg.ndim != 3 or nimg.shape[2] < 3:
                _err(out, np_path, f"expected RGB normal map, got {nimg.shape}")
                continue
            if nimg.shape[:2] != (h, w):
                _warn(
                    out, np_path,
                    f"normal size {nimg.shape[:2]} != rgb {(h, w)} (the NeuS "
                    "loader resizes, but a different aspect suggests a wrong "
                    "export)",
                )
            n = nimg[:, :, :3].astype(np.float32) / 255.0 * 2.0 - 1.0
            sp = os.path.join(seg_dir, fid + ".png")
            if os.path.exists(sp):
                seg = np.asarray(Image.open(sp))
                if seg.ndim == 3 and seg.shape[:2] == nimg.shape[:2]:
                    m = seg[:, :, 1] == 255
                    if m.any():
                        norm_samples.append(
                            float(np.linalg.norm(n[m], axis=-1).mean())
                        )
        if n_missing:
            _err(
                out, nrm_dir,
                f"{n_missing}/{len(checked)} frames missing a normal map "
                "(directory exists, so normal supervision is expected — "
                "neus/data.py loads it per frame id)",
            )
        if norm_samples:
            mean_norm = float(np.mean(norm_samples))
            if not 0.6 <= mean_norm <= 1.4:
                _warn(
                    out, nrm_dir,
                    f"mean |n| over object pixels is {mean_norm:.2f} after "
                    "the (v/255)*2-1 decode — expected ~1.0; the encoding "
                    "is probably not StableNormal's (n+1)/2 RGB",
                )

    # --- correspondence_infos (optional) -------------------------------------
    corr_dir = os.path.join(dataroot, "correspondence_infos")
    if os.path.isdir(corr_dir):
        npzs = sorted(globlib.glob(os.path.join(corr_dir, "*.npz")))
        if not npzs:
            _warn(out, corr_dir, "directory exists but contains no *.npz pairs")
        id_set = set(frame_ids)
        for path in npzs:
            try:
                d = np.load(path, allow_pickle=True)
            except Exception as e:  # noqa: BLE001
                _err(out, path, f"unreadable npz ({type(e).__name__}: {e})")
                continue
            missing = [
                k for k in ("frame_i", "frame_j", "xy_i", "xy_j") if k not in d
            ]
            if missing:
                _err(
                    out, path,
                    f"missing keys {missing} (schema: frame_i, frame_j, "
                    "xy_i (M,2), xy_j (M,2) — neus/data.py docstring)",
                )
                continue
            xi, xj = d["xy_i"], d["xy_j"]
            if xi.ndim != 2 or xi.shape[1] != 2 or xi.shape != xj.shape:
                _err(
                    out, path,
                    f"xy_i {xi.shape} / xy_j {xj.shape} must both be (M, 2)",
                )
                continue
            for key in ("frame_i", "frame_j"):
                raw = d[key]
                val = raw.item() if getattr(raw, "ndim", 1) == 0 else raw
                if isinstance(val, str) and not val.isdigit() and val not in id_set:
                    _warn(
                        out, path,
                        f"{key}={val!r} matches no rgb frame id — the loader "
                        "SKIPS this pair silently (neus/data.py:122)",
                    )
            if xi.size and float(np.abs(xi).max()) <= 1.5 and max(h, w) > 4:
                _warn(
                    out, path,
                    "all xy_i coordinates are within [0, 1.5] — these look "
                    "NORMALIZED; the loader expects PIXEL coordinates",
                )
            elif xi.size and (
                float(xi[:, 0].max()) > w or float(xi[:, 1].max()) > h
            ):
                _warn(
                    out, path,
                    f"xy_i exceeds the image bounds ({w}x{h}) — wrong "
                    "resolution or swapped axes?",
                )
    return out


def validate_or_raise(dataroot: str, max_frames: int | None = None) -> None:
    """Print all findings; raise IngestError if any are errors."""
    findings = validate_dataroot(dataroot, max_frames=max_frames)
    for f in findings:
        print(str(f), flush=True)
    if any(f.level == "error" for f in findings):
        raise IngestError(findings)
