"""The frozen yardsticks: kernel bounds at their main shapes, the idle-share
arithmetic on overlapping timelines, and the model FLOP count against the
port's own modules."""

from __future__ import annotations

import pytest

from benchmark.costs import flops, idle
from benchmark.costs.kernels import k1_bound_s, k2_bound_s


def test_kernel_bounds_at_the_main_shapes():
    # PERF.md's table: K2 at B=128, M=680 and K1 at B=128, S=330, bf16, both bytes-bound
    assert round(k2_bound_s(128, 680, 8, 256, "bfloat16") * 1e3, 4) == 0.0136
    assert round(k1_bound_s(128, 330, 256, False, "bfloat16") * 1e3, 4) == 0.0258


@pytest.mark.parametrize("intervals, lo, hi, want", [
    ([(0, 4), (2, 6), (8, 9)], 0, 10, 0.3),  # overlap counted once
    ([(0, 10), (0, 10), (1, 3)], 0, 10, 0.0),  # three streams over the whole window
    ([(-5, 2), (9, 20)], 0, 10, 0.7),  # clipped to the window
    ([], 0, 10, 1.0),
])
def test_idle_share_on_overlapping_timelines(intervals, lo, hi, want):
    share = idle.idle_share(intervals, lo, hi)
    assert 0.0 <= share <= 1.0
    assert share == pytest.approx(want)
    gaps = idle.gaps(intervals, lo, hi)
    assert sum(e - s for s, e in gaps) == pytest.approx(want * (hi - lo))


def test_summed_durations_would_pass_the_window_but_the_union_does_not():
    intervals = [(0, 8), (1, 9), (2, 10)]
    assert sum(e - s for s, e in intervals) > 10
    assert idle.busy(intervals, 0, 10) == 10


def test_resnet_flops_match_the_ports_convolutions():
    """The frozen count of the trunk equals 2 Cin Cout k^2 Hout Wout summed
    over the port's own convolutions at a CGL canvas."""
    import torch
    from ralf_tpu_torch.models.resnet import ResNetTrunk

    trunk = ResNetTrunk("resnet50").eval()
    counted = []

    def hook(mod, inp, out):
        k = mod.kernel_size[0] * mod.kernel_size[1]
        counted.append(2.0 * mod.in_channels * mod.out_channels * k * out.shape[2] * out.shape[3])

    for m in trunk.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.register_forward_hook(hook)
    with torch.no_grad():
        f3, f4 = trunk(torch.zeros(1, 4, 350, 240))
    total, tap3, tap4 = flops.resnet_taps("resnet50", 350, 240)
    assert total == pytest.approx(sum(counted))
    assert tap3 == tuple(f3.shape[1:]) and tap4 == tuple(f4.shape[1:])
    assert tap3[1] * tap3[2] == 330  # the image encoder's tokens


def test_ralf_layout_flops_are_about_twenty_gflop():
    cfg = {"model": {"d_model": 256, "dim_feedforward": 1024, "backbone": "resnet50",
                     "num_encoder_layers": 6, "num_decoder_layers": 6},
           "dataset": {"image_h": 350, "image_w": 240, "max_seq_length": 10},
           "retrieval": {"top_k": 16}, "const_len": 4, "vocab_size": 519}
    f = flops.ralf_layout(cfg)
    assert 15e9 < f["encode"] + f["decode"] < 30e9
    assert f["decode"] < f["encode"]
