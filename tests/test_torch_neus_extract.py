"""The port's mesh extraction (``dynhor_tpu_torch/neus/extract.py``) and its
native library (``dynhor_tpu_torch/native``, a copy of the JAX package's
``marching.cpp`` built into ``build/``) against the JAX package's, on
tests/test_native.py's sphere grids and a lumpy grid.

Held exactly: the numpy ``marching_tetrahedra`` (vertices and faces), the
native extraction (the same source, so the same bytes out),
``sample_surface``, ``chamfer_distance``, ``save_obj``'s file and
``extract_mesh_from_field`` (the port's SDF batches in torch, the JAX
package's in numpy).  The copy is byte for byte the JAX package's source;
a source g++ refuses raises with g++'s message (no numpy fallback).

The JAX package's native library is built for this module alone, into its
own temporary directory (``jax_native``): its loader compiles straight onto
one shared path, which the suite's parallel workers would otherwise write
and load at once, and a worker that loads a half-written file keeps
``None`` for the rest of the process.
"""
import filecmp
import os
import subprocess

import numpy as np
import pytest
import torch

from dynhor_tpu import native as JN
from dynhor_tpu.neus import extract as JE
from dynhor_tpu_torch import native as TN
from dynhor_tpu_torch.neus import extract as TE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sphere_grid(n, r=0.55):
    xs = np.linspace(-1, 1, n)
    g = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), -1)
    return (np.linalg.norm(g, axis=-1) - r).astype(np.float32)


def _lumpy_grid(n=28):
    xs = np.linspace(-1, 1, n)
    x, y, z = np.meshgrid(xs, xs, xs, indexing="ij")
    s = np.sqrt(x * x + y * y + z * z) - 0.5 + 0.12 * np.sin(5 * x) * np.cos(4 * y) * np.sin(3 * z)
    s[n // 2, n // 2, :] = 0.0  # exact zeros on grid points
    return s.astype(np.float32)


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
        assert JN.load_marching() is not None, f"the JAX package's library built at {lib} loads"
        yield str(lib)


def jax_native_marching(sdf, origin, spacing):
    """``JN.marching_tetrahedra_native``, which returns None when its
    library did not load."""
    out = JN.marching_tetrahedra_native(sdf, origin, spacing)
    assert out is not None, f"the JAX package's native library ({JN._LIB}) did not load"
    return out


GRIDS = {"sphere40": (_sphere_grid(40), 2 / 39), "sphere17": (_sphere_grid(17, 0.3), 2 / 16),
         "lumpy": (_lumpy_grid(), 2 / 27)}


def test_marching_source_is_the_reference_copy():
    assert filecmp.cmp(os.path.join(REPO, "dynhor_tpu", "native", "marching.cpp"),
                       os.path.join(REPO, "dynhor_tpu_torch", "native", "marching.cpp"),
                       shallow=False)


@pytest.mark.parametrize("grid", list(GRIDS))
def test_numpy_and_native_marching_equal_jax(grid):
    sdf, spacing = GRIDS[grid]
    v_np, f_np = TE.marching_tetrahedra(sdf, (-1, -1, -1), spacing)
    jv, jf = JE.marching_tetrahedra(sdf, (-1, -1, -1), spacing)
    np.testing.assert_array_equal(v_np, jv)
    np.testing.assert_array_equal(f_np, jf)
    assert v_np.dtype == jv.dtype and f_np.dtype == jf.dtype
    v_cc, f_cc = TN.marching_tetrahedra_native(sdf, (-1, -1, -1), spacing)
    jv_cc, jf_cc = jax_native_marching(sdf, (-1, -1, -1), spacing)
    np.testing.assert_array_equal(v_cc, jv_cc)
    np.testing.assert_array_equal(f_cc, jf_cc)
    assert len(v_cc) == len(v_np) > 0 and len(f_cc) == len(f_np)
    lib = [n for n in os.listdir(os.path.join(REPO, "build")) if n.startswith("marching_")
           and n.endswith(".so")]
    assert lib, "the native library is built into build/"


def test_native_empty_and_full_grids():
    ones = np.ones((8, 8, 8), np.float32)
    for sdf in (ones, -ones):
        v, f = TN.marching_tetrahedra_native(sdf, (0, 0, 0), 1.0)
        assert v.shape == (0, 3) and f.shape == (0, 3)


def test_surface_samples_chamfer_and_obj_equal_jax(tmp_path):
    va, fa = TE.marching_tetrahedra(*GRIDS["lumpy"][:1], (-1, -1, -1), GRIDS["lumpy"][1])
    vb, fb = TE.marching_tetrahedra(_sphere_grid(24, 0.45), (-1, -1, -1), 2 / 23)
    np.testing.assert_array_equal(TE.sample_surface(va, fa, 500, 3),
                                  JE.sample_surface(va, fa, 500, 3))
    assert TE.chamfer_distance(va, fa, vb, fb, 2000) == JE.chamfer_distance(va, fa, vb, fb, 2000)
    assert TE.chamfer_distance(va, fa, vb[:0], fb[:0]) == float("inf")
    TE.save_obj(str(tmp_path / "a.obj"), va, fa)
    JE.save_obj(str(tmp_path / "b.obj"), va, fa)
    assert filecmp.cmp(tmp_path / "a.obj", tmp_path / "b.obj", shallow=False)


@pytest.mark.parametrize("use_native", [True, False])
def test_extract_mesh_from_field_equals_jax(use_native):
    def t_eval(p):  # torch points -> torch sdf
        return torch.linalg.norm(p, dim=-1) - 0.4 + 0.05 * torch.sin(6 * p[:, 0])

    def j_eval(p):  # numpy points -> numpy sdf, the same f32 arithmetic
        t = torch.from_numpy(np.asarray(p))
        return t_eval(t).numpy()

    tv, tf = TE.extract_mesh_from_field(t_eval, resolution=30, bound=0.8, batch=4096,
                                        use_native=use_native, device="cpu")
    if use_native:  # the JAX side falls back to numpy when its library is missing
        assert JN.load_marching() is not None, f"the JAX package's library ({JN._LIB}) loads"
    jv, jf = JE.extract_mesh_from_field(j_eval, resolution=30, bound=0.8, batch=4096,
                                        use_native=use_native)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    assert len(tv) > 100


def test_native_build_failure_raises_with_the_compiler_message(tmp_path, monkeypatch):
    bad = tmp_path / "marching.cpp"
    bad.write_text("int mt_extract( {\n")
    monkeypatch.setattr(TN, "_SRC", str(bad))
    monkeypatch.setattr(TN, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(TN, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on native/marching.cpp"):
        TN.marching_tetrahedra_native(np.ones((4, 4, 4), np.float32), (0, 0, 0), 1.0)
    with pytest.raises(RuntimeError):
        TE.mesh_from_sdf_grid(np.ones((4, 4, 4), np.float32), 1.0, use_native=True)
    assert TE.mesh_from_sdf_grid(np.ones((4, 4, 4), np.float32), 1.0, use_native=False)[0].shape \
        == (0, 3)
