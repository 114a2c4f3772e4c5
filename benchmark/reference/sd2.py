"""Plain PyTorch reference of the SD2-inpainting model as LeftRefill runs it:
the OpenCLIP ViT-H text tower with its prompt-token table, the f8
AutoencoderKL, and the UNet (SD2's openaimodel with linear transformer
projections), with the multi-view block that folds the views of a scene
into one self-attention sequence.

It follows the published modules (ldm ``openaimodel.py``, ``attention.py``,
``autoencoder.py``; open_clip's text transformer) in NCHW, computed in float32
with TF32 off.  It imports nothing of the program under test: it reads its
weights from a ``{checkpoint key: tensor}`` dict that the benchmark draws,
the keys the SD2 checkpoint's (``model.diffusion_model.*``,
``first_stage_model.*``, ``cond_stage_model.*``).

Departures: none in the mathematics.  The program's flash attention clamps
scores at 75 before the exponential; with these weights no score comes near
that, so the reference's exact softmax is the same function here.

``Arith(fp8=True)`` is the control: every product's operands rounded to
float8 E4M3 (activations per tensor, weights per output channel), the
precision below the configuration's bfloat16.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
SCORE_CHUNK = 1 << 28  # attention scores held at once, elements


def _fp8(x: torch.Tensor, dims) -> torch.Tensor:
    s = x.abs().amax(dim=dims, keepdim=True).clamp(min=1e-30) / E4M3_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class Arith:
    """How the reference computes a product: float32 operands, or with
    ``fp8`` their E4M3 roundings (the gradient passes the rounding as if
    it were not there)."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def act(self, x: torch.Tensor) -> torch.Tensor:
        if not self.fp8:
            return x
        q = _fp8(x.detach(), None)
        return q if not x.requires_grad else x + (q - x).detach()

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        return _fp8(w, tuple(range(1, w.ndim))) if self.fp8 and w.ndim >= 2 else w


class Params:
    """The weights as float32 (rounded by ``arith``), converted once each.
    ``override`` maps keys to tensors used as they are (a trained table)."""

    def __init__(self, weights: dict, arith: Arith, override: Optional[dict] = None):
        self.weights, self.arith, self.override = weights, arith, dict(override or {})
        self._cache: dict = {}

    def __call__(self, name: str) -> torch.Tensor:
        if name in self.override:
            return self.override[name]
        if name not in self._cache:
            self._cache[name] = self.arith.weight(self.weights[name].to(torch.float32))
        return self._cache[name]


def groups_of(c: int, groups: int = 32) -> int:
    g = min(groups, c)
    while c % g:
        g -= 1
    return g


# ---------------------------------------------------------------- primitives


def linear(p: Params, x, name: str, bias: bool = True):
    return F.linear(p.arith.act(x), p(name + ".weight"), p(name + ".bias") if bias else None)


def conv(p: Params, x, name: str, stride: int = 1, padding: int = 1):
    return F.conv2d(p.arith.act(x), p(name + ".weight"), p(name + ".bias"), stride=stride, padding=padding)


def group_norm(p: Params, x, name: str, eps: float):
    return F.group_norm(x, groups_of(x.shape[1]), p(name + ".weight"), p(name + ".bias"), eps)


def layer_norm(p: Params, x, name: str, eps: float = 1e-5):
    return F.layer_norm(x, x.shape[-1:], p(name + ".weight"), p(name + ".bias"), eps)


def attention(arith: Arith, q, k, v, heads: int, causal: bool = False):
    """softmax(q k^T / sqrt(d)) v over [B, N, H*D] rows, the scores in
    chunks of (batch, head) pairs."""
    b, nq, inner = q.shape
    nk, d = k.shape[1], inner // heads
    qh, kh, vh = (t.reshape(b, -1, heads, d).transpose(1, 2).reshape(b * heads, -1, d) for t in (q, k, v))
    step = max(1, SCORE_CHUNK // (nq * nk))
    outs = []
    for i in range(0, b * heads, step):
        s = torch.matmul(arith.act(qh[i:i + step]), arith.act(kh[i:i + step]).transpose(1, 2)) * d ** -0.5
        if causal:
            s = s.masked_fill(~torch.ones(nq, nk, dtype=torch.bool, device=s.device).tril(), float("-inf"))
        outs.append(torch.matmul(arith.act(torch.softmax(s, dim=-1)), arith.act(vh[i:i + step])))
    return torch.cat(outs).reshape(b, heads, nq, d).transpose(1, 2).reshape(b, nq, inner)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.to(torch.float32)[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


# ---------------------------------------------------------------- the UNet


def unet_layout(u: dict):
    """The UNet's blocks in checkpoint order: (prefix, kind, args) with kind
    "res" (cin, cout), "st" (channels), "down" / "up" (channels)."""
    mc, mult, nrb, attn = u["model_channels"], u["channel_mult"], u["num_res_blocks"], u["attention_resolutions"]
    inp, out = [], []
    chans, ch, ds = [mc], mc, 1
    for level, m in enumerate(mult):
        for _ in range(nrb):
            blk = [("res", (ch, m * mc))]
            ch = m * mc
            if ds in attn:
                blk.append(("st", ch))
            inp.append(blk)
            chans.append(ch)
        if level != len(mult) - 1:
            inp.append([("down", ch)])
            chans.append(ch)
            ds *= 2
    mid = [("res", (ch, ch)), ("st", ch), ("res", (ch, ch))]
    for level, m in reversed(list(enumerate(mult))):
        for i in range(nrb + 1):
            blk = [("res", (ch + chans.pop(), mc * m))]
            ch = mc * m
            if ds in attn:
                blk.append(("st", ch))
            if level and i == nrb:
                blk.append(("up", ch))
                ds //= 2
            out.append(blk)
    return inp, mid, out


def _res(p: Params, x, emb, name: str):
    h = conv(p, F.silu(group_norm(p, x, name + ".in_layers.0", 1e-5)), name + ".in_layers.2")
    h = h + linear(p, F.silu(emb), name + ".emb_layers.1")[:, :, None, None]
    h = conv(p, F.silu(group_norm(p, h, name + ".out_layers.0", 1e-5)), name + ".out_layers.3")
    skip = conv(p, x, name + ".skip_connection", padding=0) if name + ".skip_connection.weight" in p.weights else x
    return skip + h


def _block(p: Params, x, ctx, name: str, heads: int, views: int, dup_before_cross: bool):
    """Self-attention (over each scene's ``views`` rows folded into one
    sequence), cross-attention on ctx, GEGLU feed-forward; pre-norm,
    residual."""
    bv, hw, c = x.shape
    xs = x.reshape(bv // views, views * hw, c)
    y = layer_norm(p, xs, name + ".norm1")
    a = attention(p.arith, linear(p, y, name + ".attn1.to_q", False), linear(p, y, name + ".attn1.to_k", False),
                  linear(p, y, name + ".attn1.to_v", False), heads)
    x = (linear(p, a, name + ".attn1.to_out.0") + xs).reshape(bv, hw, c)
    if dup_before_cross:
        x = torch.cat([x, x])
    y = layer_norm(p, x, name + ".norm2")
    a = attention(p.arith, linear(p, y, name + ".attn2.to_q", False), linear(p, ctx, name + ".attn2.to_k", False),
                  linear(p, ctx, name + ".attn2.to_v", False), heads)
    x = linear(p, a, name + ".attn2.to_out.0") + x
    val, gate = linear(p, layer_norm(p, x, name + ".norm3"), name + ".ff.net.0.proj").chunk(2, dim=-1)
    return linear(p, val * F.gelu(gate), name + ".ff.net.2") + x


def _st(p: Params, x, ctx, name: str, head_ch: int, views: int, dup: bool):
    b, c, h, w = x.shape
    y = group_norm(p, x, name + ".norm", 1e-6).permute(0, 2, 3, 1).reshape(b, h * w, c)
    y = _block(p, linear(p, y, name + ".proj_in"), ctx, name + ".transformer_blocks.0", c // head_ch, views, dup)
    y = linear(p, y, name + ".proj_out")
    if dup:
        x = torch.cat([x, x])
    return y.reshape(-1, h, w, c).permute(0, 3, 1, 2) + x


def unet(p: Params, cfg: dict, x, t, ctx, views: int = 1, cfg_dup: bool = False):
    """eps [B, 4, h, w] of x [B, 9, h, w] at timesteps t [B] under the text
    context ctx [B, 77, C].  ``cfg_dup`` (the two batch halves of x and t
    equal): the layers before the first cross-attention run once at half
    batch, which gives the same eps (kept to count the program's work)."""
    u = cfg["unet"]
    pre = "model.diffusion_model."
    emb = linear(p, F.silu(linear(p, timestep_embedding(t, u["model_channels"]), pre + "time_embed.0")),
                 pre + "time_embed.2")
    state = {"dup": cfg_dup}
    if cfg_dup:
        x, emb_h = x[: x.shape[0] // 2], emb[: emb.shape[0] // 2]
    else:
        emb_h = emb

    def run(blocks, h, name):
        nonlocal emb_h
        for j, (kind, arg) in enumerate(blocks):
            n = f"{name}.{j}"
            if kind == "res":
                h = _res(p, h, emb_h, n)
            elif kind == "st":
                h = _st(p, h, ctx, n, u["num_head_channels"], views, state["dup"])
                if state["dup"]:
                    state["dup"], emb_h = False, emb
            elif kind == "down":
                h = conv(p, h, n + ".op", stride=2)
            else:
                h = conv(p, F.interpolate(h, scale_factor=2, mode="nearest"), n + ".conv")
        return h

    inp, mid, out = unet_layout(u)
    h = conv(p, x, pre + "input_blocks.0.0")
    hs = [h]
    for i, blk in enumerate(inp, start=1):
        h = run(blk, h, f"{pre}input_blocks.{i}")
        hs.append(h)
    h = run(mid, h, pre + "middle_block")
    for i, blk in enumerate(out):
        skip = hs.pop()
        if skip.shape[0] != h.shape[0]:
            skip = torch.cat([skip, skip])
        h = run(blk, torch.cat([h, skip], dim=1), f"{pre}output_blocks.{i}")
    if state["dup"]:
        h = torch.cat([h, h])
    return conv(p, F.silu(group_norm(p, h, pre + "out.0", 1e-5)), pre + "out.2")


# ---------------------------------------------------------------- the VAE


def _vres(p: Params, x, name: str):
    h = conv(p, F.silu(group_norm(p, x, name + ".norm1", 1e-6)), name + ".conv1")
    h = conv(p, F.silu(group_norm(p, h, name + ".norm2", 1e-6)), name + ".conv2")
    if name + ".nin_shortcut.weight" in p.weights:
        x = conv(p, x, name + ".nin_shortcut", padding=0)
    return x + h


def _vattn(p: Params, x, name: str):
    b, c, h, w = x.shape
    y = group_norm(p, x, name + ".norm", 1e-6)
    q, k, v = (conv(p, y, f"{name}.{s}", padding=0).reshape(b, c, h * w).transpose(1, 2) for s in "qkv")
    a = attention(p.arith, q, k, v, 1).transpose(1, 2).reshape(b, c, h, w)
    return x + conv(p, a, name + ".proj_out", padding=0)


def vae_encode(p: Params, cfg: dict, x, noise):
    """Scaled latent [B, 4, h, w] of an image [B, 3, H, W] in [-1, 1]: the
    posterior mean plus its std times ``noise`` [B, 4, h, w]."""
    v, pre = cfg["vae"], "first_stage_model.encoder."
    h = conv(p, x, pre + "conv_in")
    for i in range(len(v["ch_mult"])):
        for j in range(v["num_res_blocks"]):
            h = _vres(p, h, f"{pre}down.{i}.block.{j}")
        if i != len(v["ch_mult"]) - 1:
            h = conv(p, F.pad(h, (0, 1, 0, 1)), f"{pre}down.{i}.downsample.conv", stride=2, padding=0)
    h = _vres(p, _vattn(p, _vres(p, h, pre + "mid.block_1"), pre + "mid.attn_1"), pre + "mid.block_2")
    h = conv(p, F.silu(group_norm(p, h, pre + "norm_out", 1e-6)), pre + "conv_out")
    mean, logvar = conv(p, h, "first_stage_model.quant_conv", padding=0).chunk(2, dim=1)
    return cfg["schedule"]["scale_factor"] * (mean + torch.exp(0.5 * logvar.clamp(-30.0, 20.0)) * noise)


def vae_decode(p: Params, cfg: dict, z):
    v, pre = cfg["vae"], "first_stage_model.decoder."
    h = conv(p, conv(p, z / cfg["schedule"]["scale_factor"], "first_stage_model.post_quant_conv", padding=0),
             pre + "conv_in")
    h = _vres(p, _vattn(p, _vres(p, h, pre + "mid.block_1"), pre + "mid.attn_1"), pre + "mid.block_2")
    for i in reversed(range(len(v["ch_mult"]))):
        for j in range(v["num_res_blocks"] + 1):
            h = _vres(p, h, f"{pre}up.{i}.block.{j}")
        if i:
            h = conv(p, F.interpolate(h, scale_factor=2, mode="nearest"), f"{pre}up.{i}.upsample.conv")
    return conv(p, F.silu(group_norm(p, h, pre + "norm_out", 1e-6)), pre + "conv_out")


# ---------------------------------------------------------------- the text tower


def text_encode(p: Params, cfg: dict, tokens):
    """[B, 77] ids -> [B, 77, width]: ids at or past the vocabulary pick
    rows of the prompt table; the output is ln_final of the layer
    ``skip_last`` before the top."""
    tx, pre = cfg["text"], "cond_stage_model.model."
    vocab = tx["vocab_size"]
    special = tokens >= vocab
    emb = torch.where(special[..., None], p("cond_stage_model.special_embeddings.weight")[
        (tokens - vocab).clamp(min=0)], p(pre + "token_embedding.weight")[tokens.clamp(0, vocab - 1)])
    x = emb + p(pre + "positional_embedding")
    for i in range(tx["layers"] - tx["skip_last"]):
        n = f"{pre}transformer.resblocks.{i}"
        y = layer_norm(p, x, n + ".ln_1")
        qkv = F.linear(p.arith.act(y), p(n + ".attn.in_proj_weight"), p(n + ".attn.in_proj_bias"))
        x = x + linear(p, attention(p.arith, *qkv.chunk(3, dim=-1), tx["heads"], causal=True), n + ".attn.out_proj")
        x = x + linear(p, F.gelu(linear(p, layer_norm(p, x, n + ".ln_2"), n + ".mlp.c_fc")), n + ".mlp.c_proj")
    return layer_norm(p, x, pre + "ln_final")


# ---------------------------------------------------------------- the checkpoint's keys


def param_shapes(cfg: dict) -> dict:
    """{checkpoint key: shape} of every weight of the bundle."""
    out: dict = {}

    def lin(name, din, dout, bias=True):
        out[name + ".weight"] = (dout, din)
        if bias:
            out[name + ".bias"] = (dout,)

    def cv(name, cin, cout, k=3):
        out[name + ".weight"] = (cout, cin, k, k)
        out[name + ".bias"] = (cout,)

    def norm(name, c):
        out[name + ".weight"], out[name + ".bias"] = (c,), (c,)

    u, pre = cfg["unet"], "model.diffusion_model."
    mc, ctx_dim = u["model_channels"], u["context_dim"]
    lin(pre + "time_embed.0", mc, 4 * mc)
    lin(pre + "time_embed.2", 4 * mc, 4 * mc)
    cv(pre + "input_blocks.0.0", u["in_channels"], mc)

    def blocks(blks, name):
        for j, (kind, arg) in enumerate(blks):
            n = f"{name}.{j}"
            if kind == "res":
                cin, cout = arg
                norm(n + ".in_layers.0", cin)
                cv(n + ".in_layers.2", cin, cout)
                lin(n + ".emb_layers.1", 4 * mc, cout)
                norm(n + ".out_layers.0", cout)
                cv(n + ".out_layers.3", cout, cout)
                if cin != cout:
                    cv(n + ".skip_connection", cin, cout, 1)
            elif kind == "st":
                c = arg
                norm(n + ".norm", c)
                lin(n + ".proj_in", c, c)
                b = n + ".transformer_blocks.0"
                for a, kv in (("attn1", c), ("attn2", ctx_dim)):
                    lin(f"{b}.{a}.to_q", c, c, False)
                    lin(f"{b}.{a}.to_k", kv, c, False)
                    lin(f"{b}.{a}.to_v", kv, c, False)
                    lin(f"{b}.{a}.to_out.0", c, c)
                lin(b + ".ff.net.0.proj", c, 8 * c)
                lin(b + ".ff.net.2", 4 * c, c)
                for k in (1, 2, 3):
                    norm(f"{b}.norm{k}", c)
                lin(n + ".proj_out", c, c)
            elif kind == "down":
                cv(n + ".op", arg, arg)
            else:
                cv(n + ".conv", arg, arg)

    inp, mid, outb = unet_layout(u)
    for i, blk in enumerate(inp, start=1):
        blocks(blk, f"{pre}input_blocks.{i}")
    blocks(mid, pre + "middle_block")
    for i, blk in enumerate(outb):
        blocks(blk, f"{pre}output_blocks.{i}")
    norm(pre + "out.0", mc)
    cv(pre + "out.2", mc, u["out_channels"])

    v, pre = cfg["vae"], "first_stage_model."

    def vres(n, cin, cout):
        norm(n + ".norm1", cin)
        cv(n + ".conv1", cin, cout)
        norm(n + ".norm2", cout)
        cv(n + ".conv2", cout, cout)
        if cin != cout:
            cv(n + ".nin_shortcut", cin, cout, 1)

    def vattn(n, c):
        norm(n + ".norm", c)
        for s in ("q", "k", "v", "proj_out"):
            cv(f"{n}.{s}", c, c, 1)

    ch, z = v["ch"], v["z_channels"]
    cv(pre + "encoder.conv_in", v["in_channels"], ch)
    c = ch
    for i, m in enumerate(v["ch_mult"]):
        for j in range(v["num_res_blocks"]):
            vres(f"{pre}encoder.down.{i}.block.{j}", c, ch * m)
            c = ch * m
        if i != len(v["ch_mult"]) - 1:
            cv(f"{pre}encoder.down.{i}.downsample.conv", c, c)
    vres(pre + "encoder.mid.block_1", c, c)
    vattn(pre + "encoder.mid.attn_1", c)
    vres(pre + "encoder.mid.block_2", c, c)
    norm(pre + "encoder.norm_out", c)
    cv(pre + "encoder.conv_out", c, 2 * z)
    c = ch * v["ch_mult"][-1]
    cv(pre + "decoder.conv_in", z, c)
    vres(pre + "decoder.mid.block_1", c, c)
    vattn(pre + "decoder.mid.attn_1", c)
    vres(pre + "decoder.mid.block_2", c, c)
    for i in reversed(range(len(v["ch_mult"]))):
        for j in range(v["num_res_blocks"] + 1):
            vres(f"{pre}decoder.up.{i}.block.{j}", c, ch * v["ch_mult"][i])
            c = ch * v["ch_mult"][i]
        if i:
            cv(f"{pre}decoder.up.{i}.upsample.conv", c, c)
    norm(pre + "decoder.norm_out", c)
    cv(pre + "decoder.conv_out", c, v["out_ch"])
    cv(pre + "quant_conv", 2 * z, 2 * v["embed_dim"], 1)
    cv(pre + "post_quant_conv", v["embed_dim"], z, 1)

    tx, pre = cfg["text"], "cond_stage_model."
    w = tx["width"]
    out[pre + "model.token_embedding.weight"] = (tx["vocab_size"], w)
    out[pre + "model.positional_embedding"] = (tx["context_length"], w)
    for i in range(tx["layers"]):
        n = f"{pre}model.transformer.resblocks.{i}"
        norm(n + ".ln_1", w)
        out[n + ".attn.in_proj_weight"], out[n + ".attn.in_proj_bias"] = (3 * w, w), (3 * w,)
        lin(n + ".attn.out_proj", w, w)
        norm(n + ".ln_2", w)
        lin(n + ".mlp.c_fc", w, 4 * w)
        lin(n + ".mlp.c_proj", 4 * w, w)
    norm(pre + "model.ln_final", w)
    out[pre + "special_embeddings.weight"] = (prompt_table_rows(cfg), w)
    return out


def prompt_table_rows(cfg: dict) -> int:
    pr = cfg["prompt"]
    return pr["repeat"] + pr.get("view_tokens", 0) * (cfg.get("view_num") or 0)
