"""The span statistics (``portbench/spans.py``): device time, launches and
idle gaps put down to the program's spans on a synthetic event list, and
the eight readers of them on a synthetic ``SpanStats``."""
from types import SimpleNamespace

import pytest
import torch

from portbench import harness as H
from portbench import spans as S

CPU, GPU = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Ev:
    """The methods of ``kineto_results.events()``'s entries that are read."""

    def __init__(self, dev, name, start, end, thread, corr=0, link=0, ann=False):
        self._v = dict(device_type=dev, name=name, start_ns=start, end_ns=end,
                       start_thread_id=thread, correlation_id=corr, linked_correlation_id=link,
                       is_user_annotation=ann)

    def __getattr__(self, k):
        return lambda: self._v[k]


def _span(name, start, end, parent=None):
    return SimpleNamespace(name=name, start_ns=start, end_ns=end, parent=parent)


def _events():
    """A step on thread 1 with a ViT forward and a backward inside it; the
    ViT's backward on thread 2 below the backward; launches inside nested
    spans, on the other thread and outside every span."""
    step = _span("refine.step", 0, 100)
    fwd = _span("refine.vit_fwd", 10, 30, step)
    bwd = _span("refine.backward", 40, 90, step)
    vbwd = _span("refine.vit_bwd", 50, 70, bwd)
    ev = [Ev(CPU, s.name, s.start_ns, s.end_ns, t, ann=True)
          for s, t in ((step, 1), (fwd, 1), (bwd, 1), (vbwd, 2))]
    ev.append(Ev(CPU, "aten::mm", 14, 16, 1, corr=900))  # an operation: no launch of its own
    for corr, (t_launch, thread, d0, d1, name) in enumerate((
            (15, 1, 20, 25, "k_fwd"),  # inside refine.vit_fwd on its own thread
            (55, 2, 56, 60, "k_vbwd"),  # inside refine.vit_bwd, autograd's thread
            (75, 2, 76, 84, "k_bwd"),  # autograd's thread, no span of its own there
            (88, 1, 95, 97, "Memcpy DtoD (Device -> Device)"),  # a copy, not a launch
            (120, 1, 121, 131, "k_after"))):  # after every span
        ev.append(Ev(CPU, "cudaLaunchKernel", t_launch, t_launch + 1, thread, corr=corr, link=900))
        ev.append(Ev(GPU, name, d0, d1, thread, corr=corr))
    ev.append(Ev(GPU, "refine.step", 20, 97, 1, ann=True))  # the span's device annotation
    return ev, [step, fwd, bwd, vbwd]


def test_device_time_launches_and_idle_by_span():
    ev, spans = _events()
    got = S.attribute(ev, spans)
    ns = 1e-9
    assert got["device_self_s"] == pytest.approx({
        "refine.vit_fwd": 5 * ns, "refine.vit_bwd": 4 * ns, "refine.backward": 10 * ns})
    assert got["device_s"] == pytest.approx({
        "refine.step": 19 * ns, "refine.vit_fwd": 5 * ns, "refine.backward": 14 * ns,
        "refine.vit_bwd": 4 * ns})
    assert got["launches"] == {"refine.step": 3, "refine.vit_fwd": 1, "refine.backward": 2,
                               "refine.vit_bwd": 1}
    # Gaps 25-56 (mid 40.5: the backward), 60-76 (mid 68: the ViT's backward,
    # opened last), 84-95 (the backward) and 97-121 (mid 109: outside).
    assert got["idle_s"] == pytest.approx({"refine.backward": 42 * ns, "refine.vit_bwd": 16 * ns,
                                           "outside": 24 * ns})
    assert got["busy_share"] == pytest.approx(19 / 29)
    assert got["launch_share"] == pytest.approx(3 / 4)


def test_only_the_recorders_spans_count():
    ev, spans = _events()
    got = S.attribute(ev, spans[:1])  # the recorder opened refine.step alone
    assert got["device_s"] == pytest.approx({"refine.step": 19e-9})
    assert got["launches"] == {"refine.step": 3}


def _stats():
    return S.SpanStats(
        units=2,
        host_s={"prior.prescreen": 5.0, "prior.rescore": 1.8, "refine.step": 3.0},
        self_s={}, spans={"refine.step": 10},
        counters={"prior.views_rescored": 200, "prior.views_prescreened": 12000},
        unit_counters=[], wrapper_launches={},
        device_s={"refine.vit_fwd": 1.1, "refine.vit_bwd": 2.2, "neus.field": 0.55,
                  "neus.backward": 0.33},
        device_self_s={}, launches={"prior.prescreen": 240000}, idle_s={},
        spans2={"refine.step": 10, "neus.step": 10},
        counters2={"prior.views_prescreened": 12000}, busy_share=0.99, launch_share=0.99,
        stretch_s=(1.0, 2.0))


EXPECTED = {"vit_fwd_ms.refine": 110.0, "vit_bwd_ms.refine": 220.0, "prescreen_ms.prior": 2500.0,
            "prescreen_launches_per_view.prior": 20.0, "rescore_ms_per_view.prior": 9.0,
            "rescored_views.prior": 100.0, "field_ms.neus": 55.0, "bwd_ms.neus": 33.0}


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_readers(metric):
    read = H.load_reader(metric).read
    run = SimpleNamespace(trace=object(), stats={"spans": _stats()})
    assert read(run) == pytest.approx(EXPECTED[metric])
    assert read(SimpleNamespace(trace=object(), stats={"spans": None})) is None
    # Untraced, or called from outside the harness: nothing to read.
    assert read(SimpleNamespace(trace=None, stats={})) is None
    assert read(SimpleNamespace(trace=object(), stats={})) is None


def test_new_metrics_are_listed():
    names = {m["name"]: m for m in H._read_json(H.os.path.join(H.ROOT, "BENCHMARK.json"))["per_layer"]}
    for metric in EXPECTED:
        assert len(names[metric]["workloads"]) == 1
