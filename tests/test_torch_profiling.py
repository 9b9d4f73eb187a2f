"""The port's recorder (``dynhor_tpu_torch/utils/profiling.py``): spans and
counters off and on, their parents, self times and stamps on the
profiler's clock, ``Profiler``'s self times with nested phases, and the
spans and counters that the refine, the two-stage prior scoring and the
NeuS train step record at tiny CPU sizes, whose outputs stay bit for bit
what they are with the recorder off."""
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dynhor_tpu_torch.models import dino as TD
from dynhor_tpu_torch.neus import data as ND
from dynhor_tpu_torch.neus import fields as NF
from dynhor_tpu_torch.neus import rendering as NR
from dynhor_tpu_torch.neus import trainer as NT
from dynhor_tpu_torch.neus.draws import Key
from dynhor_tpu_torch.tracker import priors as TP
from dynhor_tpu_torch.tracker import refine as TR
from dynhor_tpu_torch.utils import profiling as PF


@pytest.fixture(autouse=True, scope="module")
def _torch_on_one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _profiled(fn):
    """The names of the host events of ``fn()`` under a CPU profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof, [e.name() for e in prof.profiler.kineto_results.events()]


def test_off_is_the_shared_null_context():
    assert not PF.active()
    s = PF.span("test.off")
    assert s is PF.span("test.other") is PF._NULL
    PF.count("test.off", 3)

    def work():
        with PF.span("test.off"):
            torch.ones(4).sum()

    _, names = _profiled(work)
    assert "test.off" not in names and "aten::sum" in names
    with PF.recording() as rec:
        pass
    assert rec.spans == [] and dict(rec.counters) == {}


def test_parents_self_time_and_counters():
    with PF.recording() as rec:
        assert PF.active()
        with PF.span("a") as a:
            time.sleep(0.02)
            with PF.span("b") as b:
                time.sleep(0.03)
            PF.count("n", 2)
            PF.count("n", 5)
        with PF.span("c") as c:
            pass
    assert not PF.active()
    assert [s.name for s in rec.spans] == ["a", "b", "c"]
    assert a.parent is None and b.parent is a and c.parent is None
    assert {a.thread, b.thread} == {threading.get_ident()}
    assert rec.counters == {"n": 7}
    tot = rec.totals()
    assert tot["a"][0] == 1 and tot["b"][0] == 1
    assert tot["a"][1] == pytest.approx(a.seconds) and tot["a"][1] >= 0.05
    assert tot["a"][2] == pytest.approx(a.seconds - b.seconds)
    assert tot["b"][2] == pytest.approx(b.seconds)
    assert a.start_ns <= b.start_ns <= b.end_ns <= a.end_ns <= c.start_ns


def test_nested_recordings_reach_the_outer_one():
    with PF.recording() as outer:
        with PF.span("o"):
            with PF.recording() as inner:
                with PF.span("i"):
                    PF.count("k")
    assert [s.name for s in inner.spans] == ["i"] and inner.counters == {"k": 1}
    assert [s.name for s in outer.spans] == ["o", "i"] and outer.counters == {"k": 1}
    assert outer.spans[1].parent is outer.spans[0]


def test_span_between_grads_links_across_threads():
    """The backward's span opens on the thread that runs the backward, its
    parent the span open on the thread that registered it."""
    lin = torch.nn.Linear(8, 8)
    x = torch.randn(4, 8, requires_grad=True)
    with PF.recording() as rec:
        h = x * 2.0
        y = lin(h)
        PF.span_between_grads("t.mod_bwd", y, h)
        loss = (y * y).sum()
        with PF.span("t.backward") as bwd:
            worker = threading.Thread(target=loss.backward)
            worker.start()
            worker.join(timeout=60)
        assert not worker.is_alive()
    (mod,) = [s for s in rec.spans if s.name == "t.mod_bwd"]
    assert mod.parent is bwd and mod.thread == worker.ident != bwd.thread
    assert bwd.start_ns <= mod.start_ns <= mod.end_ns <= bwd.end_ns
    assert rec.totals()["t.backward"][2] == pytest.approx(bwd.seconds - mod.seconds)
    # Off, no hook is registered and the gradient is the same.
    g_on = x.grad.clone()
    x.grad = None
    y = lin(x * 2.0)
    PF.span_between_grads("t.mod_bwd", y, x)
    assert y._backward_hooks is None
    (y * y).sum().backward()
    assert torch.equal(x.grad, g_on)


def test_span_between_grads_waits_for_every_input_and_spans_the_double_backward():
    """The span closes at the last input gradient that the pass computes
    (only the points' in ``torch.autograd.grad`` over them, the weights'
    and the points' in the full backward), and a pass that builds a graph
    gives the later pass a span of its double backward, which ends before
    the module's own backward starts."""
    w = torch.randn(4, 3, requires_grad=True)
    x = torch.randn(5, 3, requires_grad=True)
    seen = []
    with PF.recording() as rec:
        a, b = x * 2.0, w.view_as(w)
        a.register_hook(lambda g: seen.append(("a", time.perf_counter_ns() + rec.offset_ns)))
        b.register_hook(lambda g: seen.append(("b", time.perf_counter_ns() + rec.offset_ns)))
        y = torch.tanh(a @ b.T)
        PF.span_between_grads("t.mod_bwd", y, b, a)
        (gx,) = torch.autograd.grad(torch.sin(y).sum(), x, create_graph=True)
        assert [n for n, _ in seen] == ["a"]
        first = [s for s in rec.spans if s.name == "t.mod_bwd"]
        assert len(first) == 1 and first[0].end_ns >= seen[0][1]
        seen.clear()
        (gx.pow(2).sum() + y.sum()).backward()
    spans = sorted((s for s in rec.spans if s.name == "t.mod_bwd"), key=lambda s: s.start_ns)
    assert len(spans) == 3 and all(s.end_ns is not None for s in spans)
    double, own = spans[1], spans[2]
    assert double.end_ns <= own.start_ns
    assert sorted(n for n, _ in seen) == ["a", "b"]
    assert own.end_ns >= max(t for _, t in seen)


def test_stamps_on_the_profilers_clock():
    def work():
        with PF.recording() as rec:
            with PF.span("t.clock"):
                torch.ones(64, 64).matmul(torch.ones(64, 64))
                time.sleep(0.005)
        work.rec = rec

    prof, _ = _profiled(work)
    (s,) = work.rec.spans
    (e,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "t.clock"]
    assert abs(e.start_ns() - s.start_ns) < 1e6 and abs(e.end_ns() - s.end_ns) < 1e6


def test_profiler_self_time_with_nested_phases():
    prof = PF.Profiler(device="cpu")
    with PF.recording() as rec:
        with prof.phase("outer"):
            time.sleep(0.02)
            with prof.phase("inner"):
                time.sleep(0.03)
    lines = []
    seconds = prof.summary(lines.append)
    assert set(seconds) == {"outer", "inner"} and len(lines) == 3
    # The phases are the recorder's spans.
    outer, inner = rec.spans
    assert (outer.name, inner.name, inner.parent) == ("outer", "inner", outer)
    # A phase's seconds enclose its span; the outer phase's exclude the inner one.
    assert seconds["inner"] >= inner.seconds >= 0.025
    assert seconds["outer"] + seconds["inner"] >= outer.seconds
    assert 0.015 <= seconds["outer"] <= outer.seconds - inner.seconds + 1e-3


# ---------------------------------------------------------------------------
# The cells' spans at tiny sizes.

_VIT = dict(patch_size=14, embed_dim=32, depth=1, num_heads=2, pos_grid=4, smaller_edge_size=56)


def _box():
    v = torch.tensor([[-0.3, -0.2, -0.1], [0.3, -0.2, -0.1], [0.3, 0.2, -0.1], [-0.3, 0.2, -0.1],
                      [-0.3, -0.2, 0.1], [0.3, -0.2, 0.1], [0.3, 0.2, 0.1], [-0.3, 0.2, 0.1]])
    f = torch.tensor([[0, 1, 2], [0, 2, 3], [4, 6, 5], [4, 7, 6], [0, 4, 5], [0, 5, 1],
                      [1, 5, 6], [1, 6, 2], [2, 6, 7], [2, 7, 3], [3, 7, 4], [3, 4, 0]])
    gen = torch.Generator().manual_seed(3)
    uvs = torch.rand((12, 3, 2), generator=gen)
    tex = torch.rand((8, 8, 3), generator=gen)
    return v, f, uvs, tex


def _names(rec):
    return {k: v[0] for k, v in rec.totals().items()}


def _twice(fn):
    """``fn()`` with the recorder off, then on: (off, on, the recording)."""
    off = fn()
    with PF.recording() as rec:
        on = fn()
    return off, on, rec


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))


def test_refine_spans_and_identical_steps():
    v, f, uvs, tex = _box()
    s = 32
    K = torch.tensor([[float(s), 0.0, s / 2], [0.0, float(s), s / 2], [0.0, 0.0, 1.0]])
    masks = torch.zeros((2, s, s))
    masks[:, 10:22, 8:24] = 1.0
    dcfg = TD.DinoConfig(**_VIT)
    params = TD.init_params(dcfg, torch.Generator().manual_seed(0))
    gt = torch.randn((2, dcfg.feat_size ** 2, 32), generator=torch.Generator().manual_seed(1))
    targets = TR.FrameTargets(masks, gt, K.expand(2, 3, 3).clone())
    R0 = torch.eye(3).expand(2, 3, 3).clone()
    t0 = torch.tensor([[0.0, 0.0, 2.0], [0.02, -0.01, 2.1]])
    cfg = TR.RefineConfig(num_iterations=2, crop_size=s, mode="fine", dino_dtype="float32",
                          face_chunk=12)

    def run():
        res = TR.refine_poses(TR.MeshArrays(v, f, uvs, tex), targets, R0, t0, params, dcfg, cfg,
                              device="cpu")
        return res.rot6d, res.translations, res.final_loss, res.final_iou

    off, on, rec = _twice(run)
    _same(off, on)
    assert _names(rec) == {"refine.step": 2, "refine.render": 2, "refine.vit_fwd": 2,
                           "refine.backward": 2, "refine.vit_bwd": 2, "refine.adam": 2}
    # Depth 1: the attention kernel's forward and "frozen"'s recomputation a step.
    assert rec.counters == {"refine.frame_steps": 4, "vit.attn_kernel": 4}
    by = {s.name: s for s in rec.spans}
    assert by["refine.vit_bwd"].parent is by["refine.backward"]
    assert by["refine.render"].parent is by["refine.step"] is by["refine.adam"].parent


def test_prior_two_stage_spans_and_identical_scores(monkeypatch):
    v, f, uvs, tex = _box()
    dcfg = TD.DinoConfig(**_VIT)
    params = TD.init_params(dcfg, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(4)
    rots = torch.linalg.qr(torch.randn((24, 3, 3), generator=gen))[0]
    rots = rots * torch.linalg.det(rots)[:, None, None]
    crops = torch.rand((2, 3, 32, 32), generator=gen)
    masks = torch.zeros((2, 32, 32))
    masks[0, 8:24, 8:24] = 1.0
    masks[1, 6:26, 10:22] = 1.0
    cfg = TP.PriorConfig(num_views=24, view_chunk=4, crop_size=32, render_h=64, render_w=64,
                         dino_dtype="float32")
    radius, _ = TP.mesh_radius_center(v)
    window = TP.compute_window(cfg, float(TP.mesh_norm_radius(v)),
                               float(cfg.distance_scale * radius))
    calls = []
    batched = TP.prior_scores_batched
    monkeypatch.setattr(TP, "prior_scores_batched",
                        lambda *a, **k: calls.append(len(a[6])) or batched(*a, **k))

    def run():
        gt, cm = TP.frame_gt_features(params, dcfg, crops, masks, "float32", "cpu")
        return (TP.prior_scores_two_stage(params, dcfg, v, f, uvs, tex, rots, crops, masks, gt,
                                          cm, cfg, window, prescreen_edge=28, prescreen_scale=2,
                                          topk=2, device="cpu"),)

    off, on, rec = _twice(run)
    _same(off, on)
    union = calls[-1]
    assert calls[-2] == 24 and 2 <= union <= 4
    chunks = 3 + -(-union // 4)  # the prescreen's chunks of 8, the rescore's of 4
    assert _names(rec) == {"prior.frame_features": 2, "prior.prescreen": 1, "prior.cap": 2,
                           "prior.rescore": 1, "prior.calibrate": 1, "prior.render": chunks,
                           "prior.crop": chunks, "prior.vit": chunks, "prior.score": chunks}
    # Depth 1: one attention a ViT call, two for the frames' features.
    assert rec.counters == {"prior.views_prescreened": 24, "prior.views_rescored": union,
                            "vit.attn_kernel": 2 + chunks}
    by = {}
    for s in rec.spans:
        by.setdefault(s.name, []).append(s)
    assert by["prior.frame_features"][1].parent is by["prior.prescreen"][0]
    assert by["prior.render"][-1].parent is by["prior.rescore"][0]


@pytest.mark.parametrize("attn_impl, counter", [(None, "vit.attn_kernel"),
                                                ("xla", "vit.attn_written_out")])
def test_vit_counts_its_attention_path(attn_impl, counter):
    """A depth-2 ViT forward counts one attention a layer, under the path it
    takes and under no other (the default is the kernel); a backward under
    "frozen" runs the attention core again, and counts it again."""
    kw = dict(_VIT, depth=2) if attn_impl is None else dict(_VIT, depth=2, attn_impl=attn_impl)
    dcfg = TD.DinoConfig(**kw)
    params = TD.init_params(dcfg, torch.Generator().manual_seed(0))
    rgb = torch.rand((2, 3, 32, 32), generator=torch.Generator().manual_seed(1), requires_grad=True)
    with PF.recording() as rec:
        tok = TD.forward_tokens_from_crop(params, rgb, dcfg, remat="frozen")
    assert rec.counters == {counter: 2}
    with PF.recording() as rec:
        tok.sum().backward()
    assert rec.counters == {counter: 2}
    assert rgb.grad is not None


def test_neus_step_spans_and_identical_steps():
    h = w = 16
    K = torch.tensor([[float(w), 0.0, w / 2], [0.0, float(h), h / 2], [0.0, 0.0, 1.0]])
    gen = torch.Generator().manual_seed(5)
    data = ND.ReconData(torch.rand((2, h, w, 3), generator=gen),
                        (torch.rand((2, h, w), generator=gen) > 0.5).float(), None,
                        torch.eye(3).expand(2, 3, 3).clone(), torch.tensor([[0.0, 0.0, 1.5]] * 2), K)
    scfg = NF.SDFConfig(pe_freqs=4, hidden=32, depth=4, skip_layer=2, feat_dim=16,
                        color_hidden=32, color_depth=3)
    rcfg = NR.RenderConfig(sampler="occgrid", occ_res=8, n_candidates=16, n_occ_samples=8,
                           n_shade=4)
    tcfg = NT.TrainConfig(num_steps=10, batch_rays=16, warmup=2, lw_corr=0.0)

    def run():
        key = Key(7, "cpu")
        state = NT.init_train_state(key, scfg, tcfg)
        step = NT.make_train_step(rcfg, tcfg)
        occ = NR.occupancy_from_sdf(state.field, rcfg)
        logs = [step(state, key.fold_in(i), data, None, occ)["loss"] for i in range(2)]
        return [*logs, state.bg.detach().clone(), *(p.detach().clone() for p in state.field.parameters())]

    off, on, rec = _twice(run)
    _same(off, on)
    assert _names(rec) == {"neus.occupancy": 1, "neus.step": 2, "neus.sample": 2, "neus.field": 6,
                           "neus.backward": 2, "neus.update": 2}
    assert rec.counters == {"neus.rays": 32}
    by = {s.name: s for s in rec.spans}
    assert by["neus.sample"].parent.name == "neus.step" and by["neus.field"].parent.name == "neus.step"

