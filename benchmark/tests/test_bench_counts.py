"""The yardstick's operation and byte counts against hand counts at small
shapes."""

from __future__ import annotations

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops
from benchmark.reference import sd2
from benchmark.tests import tiny


def _count(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("b, h, nq, nk, d", [(2, 3, 64, 32, 16), (1, 5, 128, 128, 64)])
def test_attention_forward_is_4_bhnqnkd(b, h, nq, nk, d):
    q, k, v = (torch.empty(b, n, h * d, device="meta") for n in (nq, nk, nk))
    assert _count(lambda: sd2.attention(sd2.Arith(), q, k, v, h)) == 4 * b * h * nq * nk * d


def test_attention_bounds_forward_4_and_backward_10():
    b, h, n, d = 8, 5, 8192, 64
    assert flops.attention_bound_s(b, h, n, n, d) == pytest.approx(4 * b * h * n * n * d / 989e12)
    assert flops.attention_bound_s(b, h, n, n, d, backward=True) == pytest.approx(10 * b * h * n * n * d / 989e12)
    # a tiny one is bound by its bytes: q, k, v read and o written once, bf16
    assert flops.attention_bound_s(1, 1, 8, 8, 64) == pytest.approx(2 * 64 * (2 * 8 + 2 * 8) / 3.35e12)


def test_conv3x3_is_2_hw_9_ci_co():
    b, ci, co, hh, ww = 2, 8, 16, 6, 10
    p = sd2.Params({"c.weight": torch.empty(co, ci, 3, 3, device="meta"), "c.bias": torch.empty(co, device="meta")},
                   sd2.Arith())
    assert _count(lambda: sd2.conv(p, torch.empty(b, ci, hh, ww, device="meta"), "c")) == 2 * b * hh * ww * 9 * ci * co


def test_frozen_weight_backward_counts_input_gradients_only():
    b, ci, co, hh, ww = 2, 8, 16, 6, 10
    fwd = 2 * b * hh * ww * 9 * ci * co

    def step(weight_grad):
        w = torch.empty(co, ci, 3, 3, device="meta", requires_grad=weight_grad)
        x = torch.empty(b, ci, hh, ww, device="meta", requires_grad=True)
        torch.nn.functional.conv2d(x, w, padding=1).sum().backward()

    assert _count(lambda: step(False)) == 2 * fwd  # the forward and dX
    assert _count(lambda: step(True)) == 3 * fwd  # and dW, which prompt tuning does not need


def test_sampling_counts_share_the_prefix_once_under_cfg_dup():
    cfg = json.loads((tiny.HERE / "data" / "tiny_ref1.json").read_text())
    full = flops.sampling_flops(cfg, 2, 64, 128, 3)
    dup = flops.sampling_flops(cfg, 2, 64, 128, 3, cfg_dup=True)
    u = cfg["unet"]
    mc, hw = u["model_channels"], 32 * 64
    # per step, half of the rows skip: conv_in, the first ResBlock's two convs and its emb
    # projection, and the first transformer's proj_in and self-attention
    conv_in = 2 * hw * 9 * u["in_channels"] * mc
    res = 2 * (2 * hw * 9 * mc * mc) + 2 * 4 * mc * mc
    attn1 = 2 * hw * mc * mc + 4 * 2 * hw * mc * mc + 4 * hw * hw * mc
    assert full - dup == 3 * 2 * (conv_in + res + attn1)


def test_train_step_counts_no_weight_gradient():
    cfg = json.loads((tiny.HERE / "data" / "tiny_ref1.json").read_text())
    step = flops.train_step_flops(cfg, 2, 64, 128)
    fwd = flops.sampling_flops(cfg, 2, 64, 128, 1)
    assert fwd < step < 4 * fwd
