"""The frozen operation and byte counts against an independent sum: the
operations that ``torch.utils.flop_counter`` counts when the plain reference
runs, at two shapes."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from h100_bench.common import counts
from h100_bench.common.weights import biovil_weights
from h100_bench.reference import biovil as ref


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("crop", [64, 128])
def test_biovil_network_flops(crop):
    w = biovil_weights(1, "cpu")
    w["encoder.conv1.weight"] = w["encoder.conv1.weight"].sum(1, keepdim=True)  # one grey plane
    net = ref.Net(w)
    x = torch.rand(1, 1, crop, crop)
    assert _counted(lambda: net.embed(x)) == pytest.approx(counts.biovil_image_flops(crop), rel=1e-9)


@pytest.mark.parametrize("h,w,crop", [(390, 320, 512), (320, 390, 256)])
def test_resize_flops(h, w, crop):
    a, x, b = torch.rand(crop, h), torch.rand(h, w), torch.rand(crop, w)
    assert _counted(lambda: a @ x @ b.T) == counts.resize_flops(h, w, crop)


@pytest.mark.parametrize("b,t", [(16, 10), (1024, 20)])
def test_k1_counts(b, t):
    x, y = torch.rand(b, 128), torch.rand(t, 128)
    ops, byts = counts.k1_counts(b, t)
    assert _counted(lambda: x @ y.T) == 2 * b * t * 128 <= ops
    assert byts == 4 * (b * 128 + t * 128 + b * t)


def test_joint_run_flops_counts_the_adapters():
    p = {"rows": [100, 20, 10], "batch": 32, "eval_batch": 16, "epochs": 2}
    one_mlp_row = 2 * (128 * 256 + 256 * 128)
    total = counts.joint_run_flops(p)
    assert total > p["epochs"] * 3 * 100 * one_mlp_row
    assert counts.joint_run_flops({**p, "epochs": 4}) == pytest.approx(2 * total)


def test_bound_picks_the_binding_resource():
    assert counts.bound_s(989e12, 0.0, counts.PEAK_BF16) == pytest.approx(1.0)
    assert counts.bound_s(0.0, 3.35e12, counts.PEAK_BF16) == pytest.approx(1.0)
