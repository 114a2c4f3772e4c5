"""The port's timing probes (``leftrefill_torch/ops/probes.py``) against the
JAX package's probe scripts, P1-P5, on the CPU.

Importing a script would run its TPU timings at module level, so each test
loads only the named top-level ``def``s from the script's source (``ast``)
into a namespace holding ``jax``, ``jnp``, ``pl``, ``pltpu``, ``functools``
and ``CLAMP = 75.0``; the scripts are not edited.  Their Pallas kernels run
in interpret mode (``pltpu.force_tpu_interpret_mode()``), as the JAX
package's own kernel tests run them.  A recording ``pl.pallas_call`` keeps
each call's inputs and outputs, so the int8 codes and scales that P1
quantizes in XLA, and the lse that P3 and P4 compute but do not return, are
compared too.  The CUDA kernels run only on the card, where
``chip_smoke.py`` phase 2p holds them to the plain versions tested here.

Inputs: numpy normal draws from a seed, rounded to bf16 (the kernels' type),
[1, 2, 256, 64] (512 tokens for the 512-row block).  Tolerances, each
against the script's output on the same inputs:
- P1 codes and scales: equal (the same IEEE divisions and half-to-even
  rounding); o rel L2 <= 1e-2, as the card holds the kernel: the bf16 output
  rounds after fp32 sums in another order, and with ``pv_int8`` a p / l * 127
  that lands on .5 may round to the other int8 step.
- P2-P4 o rel L2 <= 1e-2 and lse max abs <= 1e-5 (fp32 sums in another
  order; the bf16 exp rounds exp(bf16(s)) to bf16 on both sides, where two
  exp implementations a last bit apart may round to neighbouring bf16 p).
- P5 bit-equal.
Readings on the CPU: P1 o 4.2e-7 (0 with ``pv_int8``); P2 1.5e-9 with the
fp32 exp, 2.4e-3 and 2.5e-3 with the bf16 exp; P3 and P4 o <= 2.6e-5, lse
4.8e-7.
"""

import ast
import functools
import re
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from test_torch_parity_utils import rel_l2

from leftrefill_torch import tools
from leftrefill_torch.ops import probes

ROOT = Path(__file__).resolve().parent.parent
O_L2, LSE_ABS = 1e-2, 1e-5

# probe -> (script, {line: what it starts with}): the def of the kernel body,
# of its launcher and the pallas_call, as PERF.md's kernel table names them
LINES = {
    "P1": ("tpu_r3_attnprobe.py", {75: "def _flash_i8_kernel(", 105: "def flash_int8(", 124: "out = pl.pallas_call("}),
    "P2": ("tpu_r3_attnprobe2.py", {40: "def make_kernel(exp_bf16, clamp):", 71: "def flash_var(",
                                    75: "return pl.pallas_call("}),
    "P3": ("tpu_r5_headpack.py", {99: "def _kernel(", 115: "def fwd(", 118: "return pl.pallas_call("}),
    "P4": ("tpu_r5_attn_ab.py", {50: "def _kernel(", 67: "def _kernel_nolse(", 71: "def probe_fwd(",
                                 80: "r = pl.pallas_call("}),
    "P5": ("tpu_r3_overhead.py", {59: "def _noop_kernel(", 61: "def noop(", 62: "return pl.pallas_call("}),
}


def _load(script: str, names: tuple):
    """The script's top-level defs ``names`` in a fresh namespace, and the
    list of (inputs, outputs) of each pallas_call they make."""
    path = ROOT / "scripts" / script
    tree = ast.parse(path.read_text())
    body = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name in names]
    assert sorted(n.name for n in body) == sorted(names)
    calls = []

    def pallas_call(*args, **kwargs):
        fn = pl.pallas_call(*args, **kwargs)

        def run(*inputs):
            out = fn(*inputs)
            calls.append((inputs, out))
            return out

        return run

    shim = types.SimpleNamespace(pallas_call=pallas_call, BlockSpec=pl.BlockSpec, CostEstimate=pl.CostEstimate)
    ns = {"jax": jax, "jnp": jnp, "pl": shim, "pltpu": pltpu, "functools": functools, "CLAMP": 75.0}
    exec(compile(ast.Module(body=body, type_ignores=[]), str(path), "exec"), ns)
    return ns, calls


def _draws(seed: int, shape: tuple, n: int = 3, nonneg: bool = False):
    """n bf16-rounded normal draws as (torch bf16, jnp bf16) pairs."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        a = rng.standard_normal(shape).astype(np.float32)
        t = torch.from_numpy(np.abs(a) if nonneg else a).to(torch.bfloat16)
        out.append((t, jnp.asarray(t.float().numpy(), jnp.bfloat16)))
    return out


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32)))


def _l2(got: torch.Tensor, ref: torch.Tensor) -> float:
    return rel_l2(got.float().numpy(), ref.numpy())


@pytest.mark.parametrize("pv_int8", [False, True])
def test_flash_int8_matches_the_script(pv_int8):
    """P1: the codes and scales the script hands its kernel equal the port's
    (``probes.int8_operands``); o within the stated tolerance."""
    ns, calls = _load("tpu_r3_attnprobe.py", ("_flash_i8_kernel", "flash_int8"))
    (q, qj), (k, kj), (v, vj) = _draws(0, (1, 2, 256, 64))
    scale = 64**-0.5
    with pltpu.force_tpu_interpret_mode():
        ref = ns["flash_int8"](qj, kj, vj, scale, pv_int8=pv_int8)
    (qi, sq, ki, skr, vin), _ = calls[0]
    pqi, psq, pki, psk, pvin, _ = probes.int8_operands(q, k, v, pv_int8)
    assert torch.equal(_t(qi), pqi.float()) and torch.equal(_t(ki), pki.float())
    assert torch.equal(_t(sq)[..., 0], psq) and torch.equal(_t(skr)[:, 0], psk)
    assert torch.equal(_t(vin), pvin.float())
    got = probes.flash_int8(q, k, v, scale, pv_int8)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert _l2(got, _t(ref)) <= O_L2


P2_CONFIGS = [  # scripts/tpu_r3_attnprobe2.py:105-112
    dict(exp_bf16=False, clamp=True, blk_q=128), dict(exp_bf16=False, clamp=False, blk_q=128),
    dict(exp_bf16=True, clamp=True, blk_q=128), dict(exp_bf16=True, clamp=True, blk_q=256),
    dict(exp_bf16=False, clamp=True, blk_q=256), dict(exp_bf16=True, clamp=True, blk_q=512),
]


@pytest.mark.parametrize("cfg", P2_CONFIGS, ids=lambda c: f"bf16{int(c['exp_bf16'])}-clamp{int(c['clamp'])}-"
                         f"blk{c['blk_q']}")
def test_flash_variant_matches_attnprobe2(cfg):
    """P2: the six configurations (no lse).  Every fourth query row's q is
    scaled by 20 where the clamp holds, so scores pass 75 (std 20); without
    the clamp by 10, so no exp overflows fp32 (past 88.7 both sides give
    inf / inf)."""
    ns, _ = _load("tpu_r3_attnprobe2.py", ("make_kernel", "flash_var"))
    n = max(256, cfg["blk_q"])
    (q, _), (k, kj), (v, vj) = _draws(1, (1, 2, n, 64))
    amp = 20.0 if cfg["clamp"] else 10.0
    q = (q.float() * torch.where(torch.arange(n)[:, None] % 4 == 0, amp, 1.0)).to(torch.bfloat16)
    qj = jnp.asarray(q.float().numpy(), jnp.bfloat16)
    scale = 64**-0.5
    with pltpu.force_tpu_interpret_mode():
        ref = ns["flash_var"](qj, kj, vj, scale, **cfg)
    got = probes.flash_variant(q, k, v, scale, exp="bf16" if cfg["exp_bf16"] else "f32", clamp=cfg["clamp"],
                               lse=False, rows=cfg["blk_q"])
    assert _l2(got, _t(ref)) <= O_L2


@pytest.mark.parametrize("use_exp", [True, False])
def test_flash_variant_matches_headpack(use_exp):
    """P3: the full and the identity-exp kernel, o and lse; the identity is
    defined only where the row sum of min(s, 75) is positive, so it is held
    on non-negative q and k."""
    ns, calls = _load("tpu_r5_headpack.py", ("_kernel", "fwd"))
    (q, qj), (k, kj), (v, vj) = _draws(2, (2, 256, 64), nonneg=not use_exp)
    if not use_exp:
        v, vj = _draws(3, (2, 256, 64), n=1)[0]
    scale = 64**-0.5
    with pltpu.force_tpu_interpret_mode():
        ns["fwd"](qj, kj, vj, scale, use_exp)
    ref_o, ref_lse = calls[0][1]
    got_o, got_lse = probes.flash_variant(q, k, v, scale, exp="f32" if use_exp else "identity", lse=True, rows=256)
    assert _l2(got_o, _t(ref_o)) <= O_L2
    assert float((got_lse - _t(ref_lse)[..., 0]).abs().max()) <= LSE_ABS


@pytest.mark.parametrize("blk_q", [128, 256])
@pytest.mark.parametrize("lse", [True, False])
def test_flash_variant_matches_attn_ab(lse, blk_q):
    """P4: the simplified K1 with and without its lse output, both blocks."""
    ns, calls = _load("tpu_r5_attn_ab.py", ("_kernel", "_kernel_nolse", "probe_fwd"))
    (q, qj), (k, kj), (v, vj) = _draws(4, (2, 256, 64))
    scale = 64**-0.5
    with pltpu.force_tpu_interpret_mode():
        ref_o = ns["probe_fwd"](qj, kj, vj, scale, blk_q=blk_q, lse=lse)
    got = probes.flash_variant(q, k, v, scale, exp="f32", lse=lse, rows=blk_q)
    got_o = got[0] if lse else got
    assert _l2(got_o, _t(ref_o)) <= O_L2
    if lse:
        assert float((got[1] - _t(calls[0][1][1])[..., 0]).abs().max()) <= LSE_ABS


def test_noop_matches_the_script():
    """P5: o = x + 1 on an [8, 128] bf16 tile, bit for bit."""
    ns, _ = _load("tpu_r3_overhead.py", ("_noop_kernel", "noop"))
    x = torch.from_numpy(np.random.RandomState(5).standard_normal((8, 128)).astype(np.float32) * 50).to(torch.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        ref = ns["noop"](jnp.asarray(x.float().numpy(), jnp.bfloat16))
    got = probes.noop(x)
    assert got.dtype == torch.bfloat16 and torch.equal(got.float(), _t(ref))


@pytest.mark.parametrize("probe", sorted(LINES))
def test_script_lines_named_in_perf_md(probe):
    """The def and pallas_call lines of each probe that PERF.md's kernel
    table names still hold what the table says they hold."""
    script, lines = LINES[probe]
    src = (ROOT / "scripts" / script).read_text().splitlines()
    for line, start in lines.items():
        assert src[line - 1].strip().startswith(start), (script, line, src[line - 1])
    row = next(r for r in (ROOT / "PERF.md").read_text().splitlines() if r.startswith(f"| {probe} |"))
    named = {int(n) for n in re.findall(rf"{re.escape(script)}:(\d+)", row)}
    assert named and named <= set(lines), (row, named)


def test_vq_key_order_matches_the_fragment_packing():
    """The int8 P V of ``csrc/flash_int8.cu``: each thread packs its own S
    accumulator bytes into the int8 A fragment (``pack_pq``), so A's k
    positions hold the keys in ``vq_key_order``; with Vq^T's keys written in
    that order the product is P V.  Modelled here on one 64-row warpgroup
    tile of 128 keys, lane by lane, from the accumulator layout of
    ``csrc/sm90.cuh``."""
    order = probes.vq_key_order(128)
    assert sorted(order.tolist()) == list(range(128))
    rng = np.random.RandomState(6)
    p = rng.randint(0, 128, (64, 128))
    v = rng.randint(-127, 128, (128, 64))
    a = np.zeros((64, 128), np.int64)  # A[row, k position]
    for w in range(4):
        for lane in range(32):
            g, t = 16 * w + lane // 4, lane % 4
            acc = {}  # accumulator index i -> (row, column)
            for i in range(64):
                acc[i] = (g + 8 * ((i // 2) % 2), 8 * (i // 4) + 2 * t + i % 2)
            for c in range(4):
                regs = [(0, 1, 4, 5), (2, 3, 6, 7), (8, 9, 12, 13), (10, 11, 14, 15)]  # pack_pq
                for j, idx in enumerate(regs):
                    row = g + 8 * (j % 2)  # a[0], a[2]: row g; a[1], a[3]: row g + 8
                    kpos = 32 * c + 16 * (j // 2) + 4 * t  # the A fragment's bytes of register j
                    for b, i in enumerate(idx):
                        r, col = acc[16 * c + i]
                        assert r == row
                        a[row, kpos + b] = p[r, col]
    vt = v.T[:, order.numpy()]  # Vq^T with its keys in the kernel's order
    assert np.array_equal(a @ vt.T, p @ v)


def test_probe_wrappers_take_the_plain_version_on_the_cpu():
    """On CPU tensors each probe wrapper runs its plain version and counts no
    launch; a variant's unknown exp is refused."""
    before = {n: tools.LAUNCH_COUNTERS[n].launches for n in ("flash_int8", "flash_variant", "noop")}
    (q, _), (k, _), (v, _) = _draws(7, (1, 1, 128, 64))
    assert torch.equal(probes.flash_int8(q, k, v, 0.125, True), probes.flash_int8_plain(q, k, v, 0.125, True))
    o, lse = probes.flash_variant(q, k, v, 0.125, exp="bf16", rows=256)
    assert o.shape == q.shape and lse.shape == q.shape[:-1]
    assert torch.equal(probes.noop(q), q + 1)
    assert {n: tools.LAUNCH_COUNTERS[n].launches for n in before} == before
    with pytest.raises(ValueError, match="exp"):
        probes.flash_variant(q, k, v, 0.125, exp="f16")


def test_probe_bounds():
    """P1's bound counts one Q K^T at the int8 peak and one P V at the bf16
    or int8 peak (the function's work: not the second Q K^T of the kernel's
    two passes with pv_int8); the variants K1's products; the no-op its 4
    bytes a value."""
    n = 2 * 5 * 8192 * 8192 * 64
    for pv_int8, ops in ((False, 2 * n / tools.PEAK_INT8 + 2 * n / tools.PEAK_BF16),
                         (True, 4 * n / tools.PEAK_INT8)):
        ms, by = tools.bound_ms("flash_int8", (2, 5, 8192, 8192, 64, pv_int8))
        assert by == "operations" and ms == pytest.approx(ops * 1e3)
    ms, by = tools.bound_ms("flash_variant", (2, 5, 8192, 8192, 64, "f32", True, True, 256))
    assert by == "operations" and ms == pytest.approx(4 * n / tools.PEAK_BF16 * 1e3)
    assert tools.site_cost("noop", (8, 128)) == (4 * 1024, 0)


@pytest.mark.parametrize("fast_affine", [True, False])
def test_group_norm32_fast_affine_matches_jax(fast_affine):
    """The GN32 + SiLU cells of ``tools.probes.r3_overhead`` against JAX's
    ``group_norm32(fast_affine=...)`` in bf16: the port's ``group_norm32``
    with the same argument (the fold in fp32, then one bf16 multiply-add; or
    x A + B in fp32 rounded once).  Within one bf16
    ulp of the output's largest value (XLA may contract the fp32 multiply-add
    that PyTorch rounds twice)."""
    from leftrefill_tpu.ops.layers import group_norm32

    from leftrefill_torch.ops import layers

    rng = np.random.RandomState(8)
    x = torch.from_numpy(rng.standard_normal((2, 4, 8, 64)).astype(np.float32) * 3 + 1).to(torch.bfloat16)
    s, b = (torch.from_numpy(a.astype(np.float32)) for a in (1 + 0.1 * rng.standard_normal(64),
                                                             0.1 * rng.standard_normal(64)))
    ref = group_norm32(jnp.asarray(x.float().numpy(), jnp.bfloat16), jnp.asarray(s.numpy()), jnp.asarray(b.numpy()),
                       num_groups=32, fast_affine=fast_affine)
    got = layers.group_norm32(x, s, b, fast_affine=fast_affine)
    assert got.dtype == torch.bfloat16
    assert float((got.float() - _t(ref)).abs().max()) <= float(_t(ref).abs().max()) * 2.0**-8
