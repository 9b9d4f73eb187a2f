"""The reconstruction stage as a whole: ``python -m dynhor_tpu_torch.recon
--device cpu`` (its ``main``) against ``recon.py``'s ``main`` on a tiny twin
sequence (3 frames of 48x64 from the port's demo-data twin, downscaled by
2, ground-truth poses written as ``tools/export_gt_poses.py`` writes them,
normals and correspondences on), at recon.py's full-width PE field with the
occgrid sampler, 3 steps of 64 rays, a 32^3 mesh, and the JAX package's
draws injected into the port (the init's and every step's).

``recon.py`` runs with its init's variance given as a strongly typed f32
0.3 (the same value; the weakly typed one makes its jitted step compile
twice).  Held: the same printed lines (the data line exactly; every logged
value within 1e-4 relative, plus 1e-4 for the four printed decimals, the
final loss too; the mesh's vertex and face counts
exactly; the Chamfer to the ground-truth mesh within 1e-4), the same
artifact tree (``board/``, ``recon/mesh.obj``, ``recon/checkpoints/`` with
a checkpoint at steps 2 and 3: orbax directories there, ``step_<N>.pt``
here), and the two meshes' vertex sets within a Chamfer distance of 1e-3
of each other.  Then the port resumes from its step-3 checkpoint with
``num_steps`` 3: no step runs and the same mesh comes out.

``recon.py`` extracts its mesh through the JAX package's native library,
which is built for this module alone, into its own temporary directory
(``jax_native``, as in tests/test_torch_neus_extract.py): its loader
compiles straight onto one shared path, which the suite's parallel workers
would otherwise write and load at once, and a worker that loads a
half-written file keeps ``None`` and falls back to the numpy marching path
for the rest of the process.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from dynhor_tpu import native as JN
from dynhor_tpu_torch import recon as TREC
from dynhor_tpu_torch.neus import draws as TDR
from dynhor_tpu_torch.tools import make_demo_data as MD

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_neus_fields import jax_draw  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
SHOES = str(REPO / "assets" / "shoes" / "1229a2e6e97e_A_basketball_shoes_.obj")


@pytest.fixture(autouse=True, scope="module")
def _torch_on_one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def jax_native(tmp_path_factory):
    """The JAX package's ``marching.cpp`` compiled into this module's own
    directory, and its loader pointed there (``_LIB``, with ``_lib`` and
    ``_tried`` reset) until the module ends."""
    lib = tmp_path_factory.mktemp("jax_native") / "libmarching.so"
    subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", JN._SRC, "-o", str(lib)],
                   check=True, capture_output=True, timeout=300)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JN, "_LIB", str(lib))
        mp.setattr(JN, "_lib", None)
        mp.setattr(JN, "_tried", False)
        yield str(lib)


@pytest.fixture(scope="module")
def twin(tmp_path_factory):
    root = tmp_path_factory.mktemp("recon")
    seq = root / "custom_shoes"
    MD.write_sequence(str(seq), SHOES, frames=3, height=48, width=64, seed=0, device="cpu",
                      verbose=False)
    gt = np.load(seq / "gt_poses.npz")
    poses = root / "gt_obj_infos"
    poses.mkdir()
    for i in range(gt["R"].shape[0]):  # tools/export_gt_poses.py's layout
        np.savez(poses / f"{i:04d}.npz", R=gt["R"][i].astype(np.float32),
                 T=gt["T"][i].astype(np.float32), K=gt["K"].astype(np.float32))
    cfg = {
        "seq_name": "custom_shoes", "exp_name": "twin",
        "data_info": {"dataroot": str(seq), "obj_path": SHOES},
        "system": {"recon": {
            "encoder": "pe", "sampler": "occgrid", "num_steps": 3, "batch_rays": 64,
            "n_candidates": 48, "n_occ_samples": 16, "occ_res": 16, "n_shade": 8,
            "poses_dir": str(poses), "mesh_resolution": 32, "log_every": 1,
            "checkpoint_every": 2, "gt_mesh": SHOES,
        }},
    }
    path = root / "twin.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return root, str(path)


def _steps(text):
    out = []
    for line in text.splitlines():
        if line.startswith("[neus] step "):
            out.append({k: float(v) for k, v in re.findall(r"(\w+)=([-\d.e+]+)", line)})
    return out


def _tree(exp):
    names = set()
    for dirpath, dirs, files in os.walk(exp):
        rel = os.path.relpath(dirpath, exp)
        if rel.startswith(os.path.join("recon", "checkpoints", "")):
            continue  # inside an orbax checkpoint directory
        for n in dirs + files:
            if rel == "board":
                n = "events" if n.startswith("events.out.tfevents") else n
            names.add(os.path.join(rel, n.removesuffix(".pt")))
    return names


def test_recon_main_matches_recon_py(twin, monkeypatch, capsys):
    import jax.numpy as jnp

    from dynhor_tpu.neus import fields as JF
    from dynhor_tpu.utils import compcache

    root, cfg = twin
    sys.path.insert(0, str(REPO))
    import recon as JREC  # recon.py

    monkeypatch.setattr(compcache, "enable_persistent_cache", lambda *a, **k: None)
    # The init's variance as a strongly typed f32 0.3 (the same value): the
    # weakly typed one makes the jitted step compile twice, at steps 0 and 1.
    monkeypatch.setattr(JF, "init_variance", lambda init_val=0.3: jnp.asarray(np.float32(init_val)))
    monkeypatch.setattr(sys, "argv", ["recon.py", "--config_path", cfg, "--exps_root",
                                      str(root / "jax")])
    assert JN.load_marching() is not None, f"the JAX package's library built at {JN._LIB} loads"
    JREC.main()
    text_j = capsys.readouterr().out
    monkeypatch.setattr(TDR, "draw", jax_draw)
    res = TREC.main(["--config_path", cfg, "--exps_root", str(root / "torch"), "--device", "cpu"])
    text_t = capsys.readouterr().out

    def line(text, prefix):
        found = [ln for ln in text.splitlines() if ln.startswith(prefix)]
        assert len(found) == 1, (prefix, text)
        return found[0]

    assert line(text_t, "recon:") == line(text_j, "recon:")
    assert "normals=yes" in line(text_t, "recon:") and "correspondences=yes" in text_t
    steps_j, steps_t = _steps(text_j), _steps(text_t)
    assert len(steps_t) == len(steps_j) == 3
    for a, b in zip(steps_t, steps_j):
        assert set(a) == set(b)
        for k in b:  # printed with 4 decimals
            assert abs(a[k] - b[k]) <= 1e-4 * abs(b[k]) + 1e-4, (k, a[k], b[k])
    np.testing.assert_allclose(res.history["loss"][-1], steps_j[-1]["loss"], rtol=1e-4, atol=1e-4)
    counts = [re.search(r"extracted mesh: (\d+) verts / (\d+) faces", t).groups()
              for t in (text_t, text_j)]
    assert counts[0] == counts[1] and int(counts[0][1]) > 100
    cd_j = float(re.search(r"chamfer vs .*: ([\d.]+)", text_j).group(1))
    assert abs(res.chamfer - cd_j) <= 1e-4
    assert line(text_t, "final psnr") == line(text_j, "final psnr")

    exp_j = root / "jax" / "custom_shoes" / "twin"
    exp_t = root / "torch" / "custom_shoes" / "twin"
    tree_t = _tree(exp_t)
    assert tree_t == _tree(exp_j)
    assert {"board/events", "recon/mesh.obj", "recon/checkpoints/step_2",
            "recon/checkpoints/step_3"} <= tree_t

    from scipy.spatial import cKDTree

    from dynhor_tpu_torch.utils.objio import load_obj

    vj = load_obj(str(exp_j / "recon" / "mesh.obj")).verts
    vt = load_obj(str(exp_t / "recon" / "mesh.obj")).verts
    cd = 0.5 * (cKDTree(vj).query(vt)[0].mean() + cKDTree(vt).query(vj)[0].mean())
    print(f"vertex-set Chamfer between the two meshes: {cd:.3g}")
    assert cd <= 1e-3

    again = TREC.main(["--config_path", cfg, "--exps_root", str(root / "torch"), "--device",
                       "cpu"])
    assert again.state.step == 3 and not _steps(capsys.readouterr().out)
    np.testing.assert_array_equal(again.verts, res.verts)
