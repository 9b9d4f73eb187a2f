"""The port package stands alone: it imports neither JAX nor the JAX
package, its entry points default to the card, and its kernel wrappers
refuse tensors that are not on a CUDA device."""
import subprocess
import sys

import numpy as np
import pytest
import torch

from dynhor_tpu_torch import kernels
from dynhor_tpu_torch.tracker import refine as TRF

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises
sys.modules["dynhor_tpu"] = None   # as does any import of the JAX package
import dynhor_tpu_torch
names = [m.name for m in pkgutil.walk_packages(dynhor_tpu_torch.__path__, "dynhor_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = [k for k in sys.modules if (k == "jax" or k.startswith(("jax.", "dynhor_tpu.")))
       and sys.modules[k] is not None]
assert not bad, bad
assert len(names) >= 15, names
run_slice = {"dynhor_tpu_torch." + m for m in (
    "run", "tracker.pipeline", "tracker.outliers", "io.config", "io.artifacts", "io.ingest",
    "neus.data", "utils.profiling", "utils.constants", "tools.make_demo_data", "vis",
    "visualizer", "run_multi", "parallel.multiseq", "neus.fields", "neus.rendering",
    "neus.trainer", "neus.extract", "neus.draws", "native", "recon", "tools.bench_neus",
    "parallel.mesh", "parallel.multihost", "tools.eval_poses", "tools.export_gt_poses",
    "tools.ingest_data", "tools.make_kettle_mesh", "tools.make_dino_checkpoint",
    "tools.convert_dino_checkpoint", "tools.ablate_oracle_init", "tools.ablate_multihyp",
    "tools.ab_prescreen", "tools.ablate_fine_edge", "tools.probe_vit_fused",
    "tools.probe_step_breakdown", "tools.probe_prior_stages", "tools.probe_raster_stages",
    "tools.probe_hash_step", "tools.probe_hash_breakdown", "tools.warm_cache",
    "tools.weak_scaling", "tools.multihost_input_demo")}
assert run_slice <= set(names), sorted(run_slice - set(names))
print("ok", len(names))
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_entry_point_without_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mesh = TRF.MeshArrays(
        np.zeros((3, 3), np.float32), np.array([[0, 1, 2]]),
        np.zeros((1, 3, 2), np.float32), np.ones((2, 2, 3), np.float32),
    )
    targets = TRF.FrameTargets(
        np.zeros((1, 32, 32), np.float32), np.zeros((1, 4, 8), np.float32),
        np.eye(3, dtype=np.float32)[None],
    )
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TRF.refine_poses(
            mesh, targets, np.eye(3, dtype=np.float32)[None],
            np.zeros((1, 3), np.float32), None, None,
            TRF.RefineConfig(num_iterations=1, crop_size=32, mode="coarse"),
        )


@pytest.mark.parametrize("which", ["fused_fwd", "sil_bwd", "depth_fwd", "sil_mass_fwd", "sil_mass_bwd"])
def test_kernel_wrappers_refuse_cpu_tensors(which):
    rows = torch.zeros((1, 1, 128, 16))
    counts = torch.zeros((1, 1), dtype=torch.int32)
    before = getattr(kernels, which).launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        if which == "fused_fwd":
            kernels.fused_fwd(rows, counts, 16, 1, 0.25, 1e-2)
        elif which in ("sil_bwd", "sil_mass_bwd"):
            getattr(kernels, which)(rows, counts, torch.zeros((1, 1, 256)), 16, 1, 0.25)
        elif which == "sil_mass_fwd":
            kernels.sil_mass_fwd(rows, counts, 16, 1, 0.25)
        else:  # K3 reads per-face records through the bins' face ids
            kernels.depth_fwd(rows[0], torch.zeros((1, 1, 128), dtype=torch.int32), counts,
                              16, 1, 1e-2)
    assert getattr(kernels, which).launches == before


def test_joint_optimize_without_device_needs_a_card(monkeypatch):
    from dynhor_tpu_torch.tracker import jointopt as TJ

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TJ.joint_optimize(
            np.zeros((3, 3), np.float32), np.array([[0, 1, 2]]), np.eye(3, dtype=np.float32)[None],
            np.zeros((1, 3), np.float32), np.eye(3, dtype=np.float32)[None],
            np.zeros((1, 32, 32), np.float32), TJ.JointConfig(num_iterations=1, crop_size=32),
        )


def test_prior_entry_points_without_device_need_a_card(monkeypatch):
    from dynhor_tpu_torch.tracker import priors as TP

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TP.frame_gt_features({}, None, np.zeros((1, 3, 8, 8)), np.zeros((1, 8, 8)))


def test_recon_entry_points_without_device_need_a_card(monkeypatch, tmp_path):
    from dynhor_tpu_torch import recon
    from dynhor_tpu_torch.neus import data as TDA
    from dynhor_tpu_torch.neus import trainer as TT

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tmp_path / "c.yaml"
    cfg.write_text("seq_name: s\ndata_info: {dataroot: none}\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        recon.main(["--config_path", str(cfg), "--exps_root", str(tmp_path)])
    data = TDA.ReconData(torch.zeros((1, 4, 4, 3)), torch.zeros((1, 4, 4)), None,
                         torch.eye(3)[None], torch.zeros((1, 3)), torch.eye(3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.train(data, tcfg=TT.TrainConfig(num_steps=1))
    assert not any(tmp_path.iterdir()) or [p.name for p in tmp_path.iterdir()] == ["c.yaml"]


@pytest.mark.parametrize("tool", ["probe_vit_fused", "probe_step_breakdown", "probe_raster_stages",
                                  "probe_hash_step", "probe_hash_breakdown", "weak_scaling"])
def test_tools_without_device_need_a_card(monkeypatch, tool):
    """The probes time on the card only, and weak scaling takes cards
    unless asked for the CPU: without a card each raises before any work."""
    import importlib

    mod = importlib.import_module(f"dynhor_tpu_torch.tools.{tool}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.run(out=lambda s: None)
