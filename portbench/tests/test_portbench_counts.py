"""The operation and byte counts against hand counts at tiny shapes."""
import pytest
import torch

from portbench.counts import neus as CN
from portbench.counts import raster as CR
from portbench.counts import vit as CV
from portbench.reference import raster as RR
from portbench.tests import tiny


def test_vit_flops_by_hand():
    # 4 x 4 patches + the class token = 17 tokens of width 64, two blocks.
    vit = tiny.config("tiny_shoes")["vit"]
    linear = 2 * 17 * (64 * 192 + 64 * 64 + 64 * 256 + 256 * 64)  # 1,671,168
    attn = 2 * (17 * 17 * 64) * 2  # q kᵀ and the weighted values: 73,984
    embed = 2 * 16 * 192 * 64  # 393,216
    assert CV.forward_flops(vit, 32) == embed + 2 * (linear + attn) == 3_883_520
    assert CV.forward_input_backward_flops(vit, 32) == embed + 2 * (2 * linear + 3 * attn) == 7_521_792


@pytest.fixture
def triangle():
    # One triangle with 8-pixel legs at (2, 2) in a 32 x 32 image (2 x 2 tiles).
    vp = torch.tensor([[[2.0, 2.0, 1.0], [10.0, 2.0, 1.0], [2.0, 10.0, 1.0]]])
    return vp, torch.tensor([[0, 1, 2]])


def test_raster_counts_by_hand(triangle):
    vp, faces = triangle
    loads = RR.tile_loads(vp, faces, (32, 32), 2.5)  # box [-0.5, 12.5]: tile 0 only
    assert loads.tolist() == [[1, 0, 0, 0]]
    kk = CR.k1k2(loads)
    assert kk["K1"] == (256 * 90, 64 + 4 + 256 * 12)
    assert kk["K2"] == (256 * 100, 64 + 4 + 256 * 4 + 24)
    # Centres (j + 0.5, i + 0.5) with x, y >= 2 and x + y <= 12: a + b <= 7 for
    # a, b in 0..7, 36 of them, the hypotenuse's included.
    inside = CR.inside_pairs(vp, faces, (32, 32))
    assert inside == 36
    assert CR.k3(RR.tile_loads(vp, faces, (32, 32), 0.0), inside, 1) == (
        256 * 23 + 36 * 9, 64 + 4 + 4 + 256 * 8)


def test_bound_is_the_larger_of_the_two():
    assert CR.bound_s(67e12, 0.0) == 1.0
    assert CR.bound_s(0.0, 3.35e12) == 1.0


def test_neus_flops_by_hand():
    cfg = tiny.config("tiny_neus")
    sdf = 39 * 32 + 32 * 32 + (32 + 39) * 32 + 32 * 32 + 32 * 17  # 6,112 MACs a point
    color = 49 * 32 + 32 * 3  # 1,664
    assert CN.sdf_macs(cfg["field"]) == sdf and CN.color_macs(cfg["field"]) == color
    per_ray = 16 * 6 * sdf + 4 * (12 * sdf + 6 * color)
    extra = 256 * 12 * sdf + (128 + 16) * 6 * sdf
    occ = 16**3 * 2 * sdf / 250
    assert CN.step_flops(cfg, 64) == pytest.approx(64 * per_ray + extra + occ, rel=1e-12)


def test_idle_share_takes_the_windows_pace():
    from portbench import harness as H
    from portbench import trace as TR
    from portbench.metrics.common import idle_share

    # 2 units traced with 0.6 s busy each (their stretch slowed to 2 s a unit)
    # against a window of 10 units in 8 s: 1 - 0.6 / 0.8 = 25 % idle.
    st = TR.TraceStats(1.2, 4.0, {}, {}, 0, 2, 5.0)
    run = H.Run(None, 10, 10.0, 8.0, st, {})
    assert idle_share(run) == pytest.approx(25.0)
    assert idle_share(run._replace(trace=st._replace(busy_s=0.0))) is None
    assert idle_share(run._replace(trace=None)) is None


def test_prior_mfu_counts_the_windows_own_sequences():
    from portbench import harness as H

    # Two sequences in the window, a third traced after it and not counted.
    run = H.Run(None, 2, 12000.0, 4.0, None, {"seq_flops": [1e12, 3e12, 5e12], "peak_flops": 1e12})
    assert H.load_reader("mfu.prior").read(run) == pytest.approx(100.0 * 4e12 / 4.0 / 1e12)
