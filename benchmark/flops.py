"""The yardstick's arithmetic: the chip's published peaks, the model's
operations per request, scene call or train step (counted by running the
plain reference on ``meta`` tensors under ``torch.utils.flop_counter``,
products only), and the attention kernels' least time.

The operations are the model's work as the program's path defines it:
every UNet forward of the sampler with the CFG-doubled rows, the layers
before the first cross-attention once at half batch where the 1-reference
request shares them (``cfg_dup``), the cross-attention K/V of the fixed
text context once per request; for prompt tuning the forward and the
backward to the prompt table alone (the UNet, VAE and text weights are
frozen, so no weight gradient is work), without remat's recomputation."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import sd2

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate, HBM3 bandwidth
PEAK_BF16 = 989e12
HBM_BYTES_PER_S = 3.35e12


def _meta_params(cfg: dict, requires_grad_table: bool = False) -> sd2.Params:
    weights = {k: torch.empty(s, device="meta") for k, s in sd2.param_shapes(cfg).items()}
    override = {}
    if requires_grad_table:
        key = "cond_stage_model.special_embeddings.weight"
        override[key] = torch.empty(weights[key].shape, device="meta", requires_grad=True)
    return sd2.Params(weights, sd2.Arith(), override)


def _count(fn) -> float:
    with FlopCounterMode(display=False) as fc:
        fn()
    return float(fc.get_total_flops())


def _cross_kv(cfg: dict, rows: int) -> float:
    """The cross-attention K and V projections of ``rows`` 77-token contexts."""
    u = cfg["unet"]
    inp, mid, out = sd2.unet_layout(u)
    chans = [arg for blk in [*inp, mid, *out] for kind, arg in blk if kind == "st"]
    return sum(2 * 2 * rows * cfg["text"]["context_length"] * u["context_dim"] * c for c in chans)


def _latent(cfg, h, w):
    ds = 2 ** (len(cfg["vae"]["ch_mult"]) - 1)
    return h // ds, w // ds


def sampling_flops(cfg: dict, rows: int, h: int, w: int, steps: int, views: int = 1, cfg_dup: bool = False) -> float:
    """One sampled batch of ``rows`` images of h x w: the text tower over
    the cond and uncond prompts, the VAE encode of the masked images, ``steps``
    CFG-doubled UNet forwards (the cross K/V once), the VAE decode."""
    p = _meta_params(cfg)
    lh, lw = _latent(cfg, h, w)
    m = lambda *s: torch.empty(s, device="meta")
    tokens = torch.zeros((rows, cfg["text"]["context_length"]), dtype=torch.long, device="meta")
    text = 2 * _count(lambda: sd2.text_encode(p, cfg, tokens))
    enc = _count(lambda: sd2.vae_encode(p, cfg, m(rows, 3, h, w), m(rows, cfg["vae"]["z_channels"], lh, lw)))
    t = torch.zeros((2 * rows,), dtype=torch.long, device="meta")
    fwd = _count(lambda: sd2.unet(p, cfg, m(2 * rows, cfg["unet"]["in_channels"], lh, lw), t,
                                  m(2 * rows, cfg["text"]["context_length"], cfg["text"]["width"]), views=views,
                                  cfg_dup=cfg_dup))
    dec = _count(lambda: sd2.vae_decode(p, cfg, m(rows, cfg["vae"]["z_channels"], lh, lw)))
    kv = _cross_kv(cfg, 2 * rows)
    return text + enc + steps * (fwd - kv) + kv + dec


def train_step_flops(cfg: dict, rows: int, h: int, w: int) -> float:
    """One prompt-tuning step: two VAE encodes (the image, the masked image),
    the text tower and the UNet forward, and their backward to the prompt
    table alone."""
    lh, lw = _latent(cfg, h, w)
    m = lambda *s: torch.empty(s, device="meta")
    p = _meta_params(cfg)
    enc = _count(lambda: sd2.vae_encode(p, cfg, m(rows, 3, h, w), m(rows, cfg["vae"]["z_channels"], lh, lw)))

    def step():
        pg = _meta_params(cfg, requires_grad_table=True)
        tokens = torch.zeros((rows, cfg["text"]["context_length"]), dtype=torch.long, device="meta")
        ctx = sd2.text_encode(pg, cfg, tokens)
        out = sd2.unet(pg, cfg, m(rows, cfg["unet"]["in_channels"], lh, lw),
                       torch.zeros((rows,), dtype=torch.long, device="meta"), ctx)
        (out ** 2).mean().backward()

    return 2 * enc + _count(step)


def attention_bound_s(b: int, h: int, nq: int, nk: int, d: int, backward: bool = False) -> float:
    """The least time of one attention over (b, h) heads of head size d in
    bf16: the larger of its operations over the peak (forward 4 b h nq nk d:
    S and P V; backward 10 b h nq nk d: S, dP, dV, dQ, dK once each) and its
    bytes over the bandwidth (forward q, k, v read and o written once;
    backward q, k, v, o, dO and the row statistics read, dq, dk, dv written)."""
    ops = (10 if backward else 4) * b * h * nq * nk * d
    if backward:
        nbytes = 2 * b * h * d * (3 * nq + 2 * nk) + 8 * b * h * nq + 2 * b * h * d * (nq + 2 * nk)
    else:
        nbytes = 2 * b * h * d * (2 * nq + 2 * nk)
    return max(ops / PEAK_BF16, nbytes / HBM_BYTES_PER_S)
