"""The GroupNorm dispatcher (``ops.layers.group_norm32``): its plain version
is the GroupNorm (+ SiLU) the models ran before the kernel, bit for bit; the
kernel is chosen only for a bf16 CUDA tensor that autograd records nothing
of; the kernel's counts and site inventory.  The kernel itself runs on the
card only (``chip_smoke.py`` phase 2g holds it to this plain version)."""

from collections import Counter

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from leftrefill_torch import kernels, tools
from leftrefill_torch.ops import layers


def _group_norm_before(x, scale, bias, num_groups=32, eps=1e-5, fast_affine=True):
    """``group_norm32`` as the models called it before the kernel existed."""
    dtype = x.dtype
    b, c = x.shape[0], x.shape[-1]
    g = layers.adjust_groups(num_groups, c)
    xg = x.reshape(b, -1, g, c // g).to(torch.float32)
    var, mean = torch.var_mean(xg, dim=(1, 3), keepdim=True, correction=0)
    rstd = torch.rsqrt(var + eps)
    gamma = scale.to(torch.float32).reshape(g, c // g)
    beta = bias.to(torch.float32).reshape(g, c // g)
    one = (1,) * (x.ndim - 2)
    a = (rstd * gamma).reshape(b, *one, c)
    bb = (beta - mean * rstd * gamma).reshape(b, *one, c)
    if fast_affine and dtype != torch.float32:
        return x * a.to(dtype) + bb.to(dtype)
    return (x.to(torch.float32) * a + bb).to(dtype)


def _inputs(c, dtype, offset, seed=0, b=2, hw=(4, 6)):
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((b, *hw, c)) + offset * (1 + rng.standard_normal((1, 1, 1, c)))
    scale = 1 + 0.3 * rng.standard_normal(c)
    bias = 0.5 * rng.standard_normal(c)
    return (torch.from_numpy(x.astype(np.float32)).to(dtype), torch.from_numpy(scale.astype(np.float32)),
            torch.from_numpy(bias.astype(np.float32)))


@pytest.mark.parametrize("offset", [0.0, 100.0], ids=["centred", "mean_100x_spread"])
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("per_group", [4, 10, 20, 40])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_plain_version_is_the_group_norm_before(dtype, per_group, eps, silu, offset):
    """The kernel's plain version, the dispatcher on the CPU and the
    module's fused-SiLU form all equal the GroupNorm (+ ``F.silu``) the
    models ran before, bit for bit, at 4-40 channels a group (the UNet's 10,
    20, 40; the VAE's 4-16), both eps, and with a mean 100 times the spread."""
    c = 8 * per_group
    x, scale, bias = _inputs(c, dtype, offset)
    want = _group_norm_before(x, scale, bias, 8, eps)
    if silu:
        want = F.silu(want)
    norm = layers.GroupNorm32(c, num_groups=8, eps=eps)
    with torch.no_grad():
        norm.weight.copy_(scale)
        norm.bias.copy_(bias)
    for got in (layers.group_norm_plain(x, scale, bias, 8, eps, silu),
                layers.group_norm32(x, scale, bias, 8, eps, silu=silu),
                layers.group_norm_op(x, scale, bias, 8, eps, silu),
                norm(x, silu=silu)):
        assert got.dtype == dtype and torch.equal(got, want)
    assert torch.isfinite(want).all()


def test_fp32_affine_form_is_unchanged():
    """``fast_affine=False`` (no shipped config sets it) keeps its fp32
    affine, with and without the SiLU."""
    x, scale, bias = _inputs(64, torch.bfloat16, 3.0)
    for silu in (False, True):
        want = _group_norm_before(x, scale, bias, 32, 1e-6, fast_affine=False)
        want = F.silu(want) if silu else want
        assert torch.equal(layers.group_norm32(x, scale, bias, 32, 1e-6, fast_affine=False, silu=silu), want)


def _meta(c=320, dtype=torch.bfloat16, b=2, grad=False):
    x = torch.empty(b, 8, 16, c, dtype=dtype, device="meta", requires_grad=grad)
    return x, torch.empty(c, device="meta"), torch.empty(c, device="meta")


@pytest.mark.parametrize("case,expected", [
    ("bf16_no_grad", True), ("bf16_inference_mode", True), ("bf16_grad_mode_nothing_requires_grad", True),
    ("cpu", False), ("fp32", False), ("x_requires_grad", False), ("gamma_requires_grad", False),
    ("groups_do_not_divide", False), ("channels_not_a_multiple_of_8", False), ("fp32_affine", False),
])
def test_routing(monkeypatch, case, expected):
    """Which GroupNorm calls take the kernel: a bf16 tensor the kernels run
    on (CUDA, stood in for by ``meta``) that autograd records nothing of;
    the CPU, fp32, a recording call (x or gamma requiring grad under grad
    mode), groups that do not divide C, C off the 16-byte vectors and the
    fp32 affine run the plain version.  The decision only: on the kernel's
    route the dispatcher notes the site (B, HW, C, G, SiLU) and calls the
    kernel's wrapper."""
    monkeypatch.setattr(kernels, "uses_kernel", lambda t: t.device.type in ("cuda", "meta"))
    calls = []
    monkeypatch.setattr(layers, "group_norm_op", lambda *a: calls.append(a[3:]) or a[0])
    x, scale, bias = _meta()
    groups, fast = 32, True
    grad = torch.enable_grad()
    if case in ("bf16_no_grad", "cpu", "fp32", "groups_do_not_divide", "channels_not_a_multiple_of_8",
                "fp32_affine"):
        grad = torch.no_grad()
    if case == "bf16_inference_mode":
        grad = torch.inference_mode()
    if case == "cpu":
        x, scale, bias = _inputs(320, torch.bfloat16, 0.0)
    elif case == "fp32":
        x = x.float()
    elif case == "x_requires_grad":
        x, scale, bias = _meta(grad=True)
    elif case == "gamma_requires_grad":
        scale.requires_grad_(True)
    elif case == "groups_do_not_divide":
        groups = 48
    elif case == "channels_not_a_multiple_of_8":
        x, scale, bias = _meta(c=36)
        groups = 4
    elif case == "fp32_affine":
        fast = False
    with grad:
        assert layers.group_norm_uses_kernel(x, scale, bias, groups, fast) == expected
        with kernels.record_sites() as sites:
            layers.group_norm32(x, scale, bias, groups, 1e-6, fast_affine=fast, silu=True)
    if expected:
        assert sites == [("group_norm", (2, 128, 320, 32, True))] and calls == [(32, 1e-6, True)]
    else:
        assert sites == [] and calls == []


def test_kernel_is_a_dispatcher_with_a_launch_counter():
    """``group_norm`` is routed like the other kernels (``kernels.NAMES``,
    ``plain_kernels``) and counted like them (``tools.LAUNCH_COUNTERS``,
    ``tools.KERNEL_FNS``); its bound is one read and one write of x."""
    assert "group_norm" in kernels.NAMES and "group_norm" in tools.LAUNCH_COUNTERS
    assert tools.KERNEL_FNS["group_norm"] == (layers.group_norm_op, layers.group_norm_plain)
    assert tools.LAUNCH_COUNTERS["group_norm"] is layers.group_norm_op and layers.group_norm_op.launches >= 0
    with kernels.plain_kernels(["group_norm"]):
        assert kernels.plain_kernels_active("group_norm")
    assert not kernels.plain_kernels_active("group_norm")
    nbytes, ops = tools.site_cost("group_norm", (8, 8192, 320, 32, True))
    assert ops == 0 and nbytes == 4 * 8 * 8192 * 320 + 8 * 320


@pytest.mark.parametrize("path,per_call", [("vae_encode", tools.PER_ENCODE_VAE), ("vae_decode", tools.PER_DECODE_VAE)])
def test_vae_group_norm_sites(path, per_call):
    """The bf16 VAE's GroupNorms at the 512x1024 canvas on ``meta``
    (``tools.group_norm_sites``): 22 an encode, 30 a decode, every one on
    the kernel, the SiLU fused but at the attention's norm; and the
    benchmark's UNet forwards, 60 a forward (the predict request's prefix at
    half its CFG batch)."""
    sites = tools.group_norm_sites()
    for b in (4, 8):
        got = sites[f"{path}_b{b}"]
        assert sum(got.values()) == per_call["group_norm"]
        assert {k for k, n in per_call.items() if n} == {"group_norm"}
        assert {s[0] for s in got} == {b} and sum(n for s, n in got.items() if not s[4]) == 1
    assert sum(sites["predict_unet_b8"].values()) == sum(sites["scene_unet_b16"].values()) == 60
    assert Counter(s[0] for s, n in sites["predict_unet_b8"].items() for _ in range(n)) == {8: 57, 4: 3}


def test_operand_steps_read_a_fold_step_as_about_one():
    """``tools.group_norm_ulps``, the chip check's measure: 0 on equal
    outputs; a and bb each one bf16 step off at one channel (what another
    order of the statistics' sums can do) reads at most 2; gamma one channel
    out of place (the planted fault) reads far above."""
    x, scale, bias = _inputs(320, torch.bfloat16, 4.0, b=2, hw=(8, 8))
    ref = layers.group_norm_plain(x, scale, bias, 32, 1e-6, True)
    assert tools.group_norm_ulps(ref, ref, x, scale, bias, 32, 1e-6) == 0
    a, bb = (t.to(torch.bfloat16) for t in layers.group_norm_affine(x, scale, bias, 32, 1e-6))
    a2, bb2 = a.clone(), bb.clone()
    a2.view(torch.int16)[..., 7] += 1
    bb2.view(torch.int16)[..., 5] += 1
    moved = F.silu(x * a2 + bb2)
    assert torch.equal(F.silu(x * a + bb), ref) and not torch.equal(moved, ref)
    assert tools.group_norm_ulps(moved, ref, x, scale, bias, 32, 1e-6) <= 2
    wrong = layers.group_norm_plain(x, scale.roll(1), bias, 32, 1e-6, True)
    assert tools.group_norm_ulps(wrong, ref, x, scale, bias, 32, 1e-6) > 100
