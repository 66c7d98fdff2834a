"""The FLOP and byte counts against hand counts at small shapes, and the
published configurations' totals."""

import json

import pytest

from portbench.counts import cmf_flow, coupler_stack, gram_logdet, least_seconds, peaks
from portbench.harness.cell import BENCH_DIR


def cfgfile(name):
    with open(BENCH_DIR / "configs" / f"{name}.json") as f:
        return json.load(f)


def test_gram_logdet_by_hand():
    # d=2, B=3, D=4: the symmetric Gram 4·2·3 multiply-add pairs, 8/3 for the factor, 2 logs.
    assert gram_logdet.forward(2, 3, 4) == pytest.approx((3 * (24 + 8 / 3 + 2), 4 * (24 + 24 + 3)))
    # J read twice over (J and dJ), the factor and Ḡ, ḡ_ld.
    assert gram_logdet.backward(2, 3, 4) == pytest.approx((3 * (32 + 16 / 3 + 8), 4 * (48 + 24 + 3)))


def test_coupler_launch_by_hand():
    # B=1, 1 → 2 channels, 2×2 pixels, hidden 1, one block: per pixel 9 + 2·9 + 2 multiply-adds.
    flops, nbytes = coupler_stack.launch(1, 1, 2, 2, 2, 1, 1)
    assert flops == 2 * 4 * (9 + 18 + 2)
    weights = 9 + 2 * (9 + 1) + 2 + 3 * 2
    assert nbytes == 4 * (4 * (1 + 2) + weights)


def test_least_seconds_takes_the_larger_bound():
    p = peaks()
    assert least_seconds(p["flops_per_s"], 1.0) == pytest.approx(1.0)
    assert least_seconds(1.0, p["bytes_per_s"] * 2) == pytest.approx(2.0)


def test_mlp_row_flops():
    specs = [("w", (2, 3), 0, 1), ("b", (3,), 0, 1), ("w", (3, 4), 0, 1), ("b", (4,), 0, 1)]
    assert cmf_flow.mlp_row_flops(specs) == 2 * (6 + 12)


def test_train_step_flops_by_hand():
    """D=4, d=2, batch 5: one coupling [2]→[3]→[4] each way, a prior coupling [1]→[3]→[2]."""
    tiny = {
        "architecture": {"x_shape": [4], "x_hidden_key": "h", "x_layers": [{"type": "alternating", "reverse": False}],
                         "preprocessing": []},
        "config": {"h": [3], "latent_dimension": 2, "prior_num_density_layers": 1, "prior_hidden_channels": [3],
                   "train_batch_size": 5},
    }
    cx, cp = 2 * (2 * 3 + 3 * 4), 2 * (1 * 3 + 3 * 2)
    gram = gram_logdet.forward(2, 5, 4)[0]
    assert cmf_flow.train_step_flops(tiny, False) == 5 * cp + 3 * (2 * 5 * cx)
    assert cmf_flow.train_step_flops(tiny, True) == pytest.approx(3 * (2 * 5 * cx + 2 * 5 * cx + 5 * cp + gram))


def test_published_totals():
    mb, mn = cfgfile("miniboone-cmf"), cfgfile("mnist-cmf")
    # 400 rows through 10 couplings of ~115 kFLOP each way, plus 21 tangent rows each, ×3 with the backward.
    assert cmf_flow.train_step_flops(mb, True) == pytest.approx(3.174e10, rel=1e-3)
    assert cmf_flow.train_step_flops(mb, False) == pytest.approx(2.764e9, rel=1e-3)
    launches = cmf_flow.coupler_launches(mn, 50)
    assert launches == [(50, 1, 2, 28, 28, 64, 8)] * 3 + [(50, 2, 4, 14, 14, 64, 8)] * 7
    assert cmf_flow.sample_chunk_flops(mn, 50) == pytest.approx(2.200e11, rel=1e-3)
    assert least_seconds(*gram_logdet.forward(21, 400, 43)) == pytest.approx(0.853e-6, rel=1e-3)
