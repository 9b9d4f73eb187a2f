"""The port's NeuS trainer (``dynhor_tpu_torch/neus/trainer.py``) against the
JAX package's, on a small sphere scene (tests/test_neus.py's ``_sphere_data``
at 3 frames of 24², with monocular normals and correspondences added) and
tests/test_neus.py's small field.

Held, for three steps of ``make_train_step`` in both samplers with
normals and correspondences on and the JAX package's draws injected (the
init's and every step's, ``fold_in(key, step)`` as ``train`` folds):
every log within rtol 1e-4 (atol 1e-6); each step's clipped gradients,
through Adam's two moments (mu after step 0 is 0.1 x the gradient), within
rtol 1e-4 and 1e-4 x each tensor's largest entry, the Eikonal term's
second-order path included; the background colour; the parameters after
each step within 1e-5 (+ rtol 1e-4), except entries whose clipped JAX
gradient was under 1e-7 at some step so far (Adam's m / sqrt(v) turns
rounding there into +-lr), held within 2 x lr x steps and counted.  The schedule and the clip against optax's chain over
10 steps (clipped and unclipped steps, both groups of a hash field); the
checkpoint round trip and resume from the largest step; ``load_recon_data``
equal to the JAX package's on tests/test_neus_data.py's sequence.
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynhor_tpu.neus import rendering as JR
from dynhor_tpu.neus import trainer as JT
from dynhor_tpu_torch.neus import data as TDA
from dynhor_tpu_torch.neus import draws as TDR
from dynhor_tpu_torch.neus import fields as TF
from dynhor_tpu_torch.neus import rendering as TR
from dynhor_tpu_torch.neus import trainer as TT

sys.path.insert(0, str(Path(__file__).parent))
from test_neus import _sphere_data  # noqa: E402
from test_neus_data import recon_root  # noqa: E402,F401
from test_torch_neus_fields import jax_draws, small_cfgs  # noqa: E402,F401

LR = 1e-3
GRAD_FLOOR = 1e-7


@pytest.fixture(autouse=True, scope="module")
def _torch_on_one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    """(JAX ReconData, JAX CorrData, port ReconData, port CorrData)."""
    d = _sphere_data(n_frames=3, hw=24, radius=0.4)
    rng = np.random.RandomState(0)
    nrm = rng.randn(3, 24, 24, 3).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    d = d._replace(normals=jnp.asarray(nrm))
    m = 300
    corr = JT.CorrData(
        frame_i=jnp.asarray(rng.randint(0, 3, m).astype(np.int32)),
        frame_j=jnp.asarray(rng.randint(0, 3, m).astype(np.int32)),
        xy_i=jnp.asarray(rng.uniform(4, 20, (m, 2)).astype(np.float32)),
        xy_j=jnp.asarray(rng.uniform(4, 20, (m, 2)).astype(np.float32)),
    )
    td = TDA.ReconData(*(torch.from_numpy(np.array(x)) for x in d))
    tcorr = TDA.CorrData(*(torch.from_numpy(np.array(x)) for x in corr))
    return d, corr, td, tcorr


def _configs(sampler):
    jc, tc = small_cfgs("pe")
    if sampler == "occgrid":
        jr = JR.RenderConfig(sampler="occgrid", occ_res=16, n_candidates=32, n_occ_samples=16,
                             n_shade=8)
    else:
        jr = JR.RenderConfig(n_coarse=16, n_importance=8, up_sample_steps=2, n_shade=8)
    tr = TR.RenderConfig(**dataclasses.asdict(jr))
    jt = JT.TrainConfig(num_steps=10, batch_rays=32, lr=LR, warmup=2, lw_corr=0.01,
                        log_every=1)
    tt = TT.TrainConfig(**dataclasses.asdict(jt))
    return jc, tc, jr, tr, jt, tt


def _closure(fn, name):
    code = fn.__wrapped__.__code__
    return fn.__wrapped__.__closure__[code.co_freevars.index(name)].cell_contents


def _adam_moments(opt_state):
    """The "net" group's Adam (mu, nu) trees of the JAX optimizer state."""
    adam = opt_state[1].inner_states["net"].inner_state[0]
    return adam.mu, adam.nu


@pytest.mark.parametrize("sampler", ["neus", "occgrid"])
def test_three_train_steps_match_jax(sampler, scene, jax_draws):
    """Each step's (clipped) gradients are compared through Adam's moments:
    after step 0 ``mu`` is 0.1 x the gradient, then each step adds 0.1 x
    its gradient to 0.9 x the last (``nu`` the same with squares)."""
    jd, jcorr, td, tcorr = scene
    jc, tc, jrc, trc, jtc, ttc = _configs(sampler)
    opt = JT.make_optimizer(jtc)
    key = jax.random.PRNGKey(0)
    jstate = JT.init_train_state(key, jc, jtc, opt)  # eager, as train() runs it
    # The init's variance (and its Adam moments) are weakly typed and the
    # step's are not: made strong up front, so that the jitted step
    # compiles once, not twice.
    jstate = jax.tree.map(lambda x: jnp.array(np.asarray(x)), jstate)
    jstep = JT.make_train_step(jc, jrc, jtc, opt)
    jocc_fn = jax.jit(lambda p: JR.occupancy_from_sdf(p, jc, jrc))
    tkey = TDR.Key(0)
    tstate = TT.init_train_state(tkey, tc, ttc)
    tstep = TT.make_train_step(trc, ttc)
    for name, p in TF.params_from_jax(jstate.params).items():
        assert torch.equal(tstate.field.state_dict()[name], p), name  # injected init
    params = dict(tstate.field.named_parameters())

    small: dict[str, np.ndarray] = {}
    for i in range(3):
        jocc = tocc = None
        if sampler == "occgrid":
            jocc = jocc_fn(jstate.params)
            tocc = TR.occupancy_from_sdf(tstate.field, trc)
            assert torch.equal(tocc, torch.from_numpy(np.asarray(jocc)))
        bg_before = np.asarray(jstate.bg_color)
        jstate, jlogs = jstep(jstate, jax.random.fold_in(key, i), jd, jcorr, jocc)
        tlogs = tstep(tstate, tkey.fold_in(i), td, tcorr, tocc)
        assert set(tlogs) == set(jlogs) == {"rgb", "mask", "eikonal", "inv_s", "shell", "normal",
                                            "corr", "psnr", "loss"}
        for name in jlogs:
            np.testing.assert_allclose(float(tlogs[name]), float(jlogs[name]), rtol=1e-4,
                                       atol=1e-6, err_msg=f"step {i} log {name}")
        mu, nu = (TF.params_from_jax(t) for t in _adam_moments(jstate.opt_state))
        for name, p in params.items():
            st = tstate.opt.state[p]
            for what, want, got in (("mu", mu, st["exp_avg"]), ("nu", nu, st["exp_avg_sq"])):
                w = want[name].numpy()
                np.testing.assert_allclose(got.numpy(), w, rtol=1e-4,
                                           atol=1e-4 * max(np.abs(w).max(), 1e-30),
                                           err_msg=f"step {i} Adam {what} {name}")
            g = (mu[name].numpy() - (0.9 * prev_mu[name] if i else 0.0)) / 0.1
            low = np.abs(g) < GRAD_FLOOR
            small[name] = low if name not in small else small[name] | low
        prev_mu = {k: v.numpy() for k, v in mu.items()}
        # bg moves by plain gradient descent, outside Adam and the clip.
        np.testing.assert_allclose(tstate.bg.detach().numpy(), np.asarray(jstate.bg_color),
                                   rtol=1e-4, atol=1e-7)
        assert np.abs(np.asarray(jstate.bg_color) - bg_before).max() > 0
        want_p = TF.params_from_jax(jstate.params)
        n_small = 0
        for name, p in params.items():
            w, got = want_p[name].numpy(), p.detach().numpy()
            lo = small[name]
            n_small += int(lo.sum())
            np.testing.assert_allclose(got[~lo], w[~lo], rtol=1e-4, atol=1e-5,
                                       err_msg=f"step {i} param {name}")
            assert np.abs(got[lo] - w[lo]).max(initial=0.0) <= 2 * LR * (i + 1), name
        assert tstate.step == int(jstate.step)
        print(f"{sampler} step {i}: {n_small} parameter entries with a JAX gradient under "
              f"{GRAD_FLOOR} held within 2 lr steps")


def test_schedule_and_clip_match_optax():
    """10 steps of the port's Adam + LambdaLR + clip against optax's chain on
    a hash field (both groups, the table at 20 x lr), gradients alternately
    above and below the clip's norm of 1.  Parameters within rtol 1e-5 and
    1e-4 x the sum of the group's learning rates so far: optax forms Adam's
    bias corrections 1 - 0.999^t in f32, 6e-5 relative at t = 1 (3e-5 in
    the update through the square root), where torch forms them in f64."""
    import optax

    from dynhor_tpu.neus import fields as JF

    jc, tc = small_cfgs("hash")
    tcfg = JT.TrainConfig(num_steps=10, lr=1e-2, warmup=3)
    jp = JF.init_field_params(jax.random.PRNGKey(0), jc)
    opt = JT.make_optimizer(tcfg)
    ostate = opt.init(jp)
    update = jax.jit(lambda g, st, p: (lambda u, s2: (optax.apply_updates(p, u), s2))(
        *opt.update(g, st, p)))
    field = TF.NeuSField(tc)
    field.load_state_dict(TF.params_from_jax(jp))
    topt, tsched = TT.make_optimizer(field, TT.TrainConfig(**dataclasses.asdict(tcfg)))
    assert [g["name"] for g in topt.param_groups] == ["net", "grid"]
    params = dict(field.named_parameters())
    leaves, tree = jax.tree_util.tree_flatten(jp)
    key = jax.random.PRNGKey(1)
    lrs, lr_sums = [], {"net": 0.0, "grid": 0.0}
    for i in range(10):
        scale = 5.0 if i % 2 else 1e-3
        g = jax.tree_util.tree_unflatten(tree, [
            scale * jax.random.normal(jax.random.fold_in(key, 100 * i + j), x.shape)
            for j, x in enumerate(leaves)])
        jp, ostate = update(g, ostate, jp)
        topt.zero_grad()
        for name, gv in TF.params_from_jax(g).items():
            params[name].grad = gv.clone()
        norm = TT.clip_by_global_norm_([p.grad for p in params.values()])
        assert (float(norm) >= 1.0) == bool(i % 2)
        lrs.append(topt.param_groups[0]["lr"])
        for group in topt.param_groups:
            lr_sums[group["name"]] += group["lr"]
        topt.step()
        tsched.step()
        for name, w in TF.params_from_jax(jp).items():
            atol = 1e-4 * lr_sums["grid" if name == "sdf.table" else "net"]
            np.testing.assert_allclose(params[name].detach().numpy(), w.numpy(), rtol=1e-5,
                                       atol=max(atol, 1e-9), err_msg=f"step {i} {name}")
    sched = optax.warmup_cosine_decay_schedule(0.0, tcfg.lr, tcfg.warmup, tcfg.num_steps)
    np.testing.assert_allclose(lrs, [float(sched(i)) for i in range(10)], rtol=1e-6, atol=1e-9)
    assert lrs[0] == 0.0


def test_checkpoint_round_trip_and_resume(tmp_path):
    _, tc = small_cfgs("pe")
    tcfg = TT.TrainConfig(num_steps=10)
    state = TT.init_train_state(TDR.Key(0), tc, tcfg)
    for p in state.field.parameters():
        p.grad = torch.ones_like(p)
    state.opt.step()
    state.sched.step()
    with torch.no_grad():
        state.bg += 0.25
    state.step = 7
    ck = str(tmp_path / "ck")
    TT.save_checkpoint(ck, state)
    state.step = 3
    TT.save_checkpoint(ck, state)
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["step_3.pt", "step_7.pt"]
    fresh = TT.init_train_state(TDR.Key(1), tc, tcfg)
    assert TT.restore_checkpoint(ck, fresh) is fresh
    assert fresh.step == 7  # the largest step
    for (n, a), b in zip(state.field.state_dict().items(), fresh.field.state_dict().values()):
        assert torch.equal(a, b), n
    assert torch.equal(fresh.bg.detach(), state.bg.detach())
    assert fresh.sched.last_epoch == state.sched.last_epoch == 1
    sa, sb = state.opt.state_dict()["state"], fresh.opt.state_dict()["state"]
    assert all(torch.equal(sa[k]["exp_avg"], sb[k]["exp_avg"]) for k in sa)
    assert TT.restore_checkpoint(str(tmp_path / "none"), fresh) is None


@pytest.mark.parametrize("downscale", [1, 2])
def test_load_recon_data_matches_jax(recon_root, downscale):
    from dynhor_tpu.neus import data as JDA

    root, poses = recon_root
    jd, jids = JDA.load_recon_data(str(root), str(poses), downscale)
    td, tids = TDA.load_recon_data(str(root), str(poses), downscale)
    assert tids == jids == ["0000", "0001"]
    for name, a, b in zip(jd._fields, jd, td):
        assert b.device.type == "cpu" and b.dtype == torch.float32, name
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
