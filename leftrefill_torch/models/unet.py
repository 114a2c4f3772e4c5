"""The SD2-inpainting UNet in PyTorch (counterpart of
``leftrefill_tpu/models/unet.py``, bf16/fp32 path).

Activations are NHWC, as in the JAX package.  Matmul and conv weights are held
in the compute dtype (the JAX package keeps fp32 and casts at every use: the
values are the same), norm parameters and the GEGLU biases in fp32.  Module
names follow the SD2 checkpoint
(``input_blocks.1.0.in_layers.2.weight`` ...), so ``state_dict()`` keys are
the checkpoint's keys under ``model.diffusion_model.``.  Placeholder
``nn.SiLU`` / ``nn.Identity`` entries keep the checkpoint's Sequential
indices; the forward calls the parametrised entries directly.

``UNetModel(quant=True)`` is the W8A8 int8 UNet: JAX's ``quant=True`` UNet
with the TPU dispatch, in JAX's default configuration (``fused=True``:
``LEFTREFILL_FUSED_RES`` and ``LEFTREFILL_FUSED_LNQ`` on, the fused
prologues K4, K7 and K8 of the bf16 model) or its unfused one
(``fused=False``: both flags 0).  Its quantized sites hold an int8
``weight``, a ``weight_scale`` and an fp32 bias (load them with
``ops.quant.quantize_params_like``); the stem conv, the out conv,
``time_embed`` and ``emb_layers`` stay fp, as in JAX.  Its dispatch depends
on the shape only: the int8 convs take KI1, the proj_out sites KI2, the
feed-forwards KI3 and the prologues K4/K7/K8 wherever JAX's TPU rules take
the Pallas kernels, on any device (a CPU tensor runs the plain versions).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from leftrefill_torch import kernels
from leftrefill_torch.ops.attention import attention_probs, multi_head_attention
from leftrefill_torch.ops.conv import conv3x3_apply
from leftrefill_torch.ops import mlp, quant as q8
from leftrefill_torch.ops.layers import (
    GroupNorm32,
    Linear,
    adjust_groups,
    avg_pool_2x,
    conv2d_nhwc,
    nearest_upsample_2x,
    timestep_embedding,
)


class Conv3x3(nn.Module):
    """3x3 conv (OIHW weight + bias), stride 1 through the K2 dispatcher,
    stride 2 (Downsample) through the plain convolution.  The weight is held
    in channels-last memory (OHWI order), the layout K2 and KI1 read.

    ``quant=True`` (JAX: ``conv3x3_forward`` with an int8 kernel): an int8
    weight, its ``weight_scale`` and an fp32 bias.  A stride-1 conv whose
    shape qualifies runs KI1 on the per-tensor quantized x; any other (the
    stride-2 Downsamples) runs the conv on the dequantized weight."""

    def __init__(self, cin: int, cout: int, stride: int = 1, dtype=torch.float32, quant: bool = False):
        super().__init__()
        self.stride, self.dtype, self.quant = stride, dtype, quant
        w = torch.empty(cout, cin, 3, 3, dtype=torch.int8 if quant else dtype)
        self.weight = nn.Parameter(w.to(memory_format=torch.channels_last), requires_grad=not quant)
        self.bias = nn.Parameter(torch.zeros(cout, dtype=torch.float32 if quant else dtype))
        if quant:
            self.weight_scale = nn.Parameter(torch.ones(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.quant:
            _, h, w, ci = x.shape
            bias = self.bias.to(self.dtype)  # JAX rounds the bias to the compute dtype here
            if self.stride == 1 and q8.conv3x3_int8_qualifies(h, w, ci, self.weight.shape[0]):
                return q8.conv3x3_int8_apply(x, self.weight.permute(0, 2, 3, 1), self.weight_scale,
                                             bias.to(torch.float32))
            weight = (self.weight.to(torch.float32) * self.weight_scale[:, None, None, None]).to(self.dtype)
            if self.stride != 1:
                return conv2d_nhwc(x, weight, None, stride=self.stride, padding=1) + bias
            return conv3x3_apply(x, weight, bias)
        if self.stride != 1:
            return conv2d_nhwc(x, self.weight, self.bias, stride=self.stride, padding=1)
        return conv3x3_apply(x, self.weight, self.bias)


class Conv1x1(nn.Module):
    """1x1 conv (weight [Co, Ci, 1, 1]) as a dense map over channels.
    ``quant=True`` (JAX: ``QConv1x1``): int8 weight, ``weight_scale``, fp32
    bias, x quantized per pixel, ``dense_int8``."""

    def __init__(self, cin: int, cout: int, dtype=torch.float32, quant: bool = False):
        super().__init__()
        self.dtype, self.quant = dtype, quant
        self.weight = nn.Parameter(torch.empty(cout, cin, 1, 1, dtype=torch.int8 if quant else dtype),
                                   requires_grad=not quant)
        self.bias = nn.Parameter(torch.zeros(cout, dtype=torch.float32 if quant else dtype))
        if quant:
            self.weight_scale = nn.Parameter(torch.ones(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.dtype
        if self.quant:
            xq, sx = q8.quantize_activation_rowwise(x.reshape(-1, x.shape[-1]))
            y = q8.dense_int8(xq, sx, self.weight.flatten(1), self.weight_scale, self.bias, out_dtype=d)
            return y.reshape(*x.shape[:-1], -1)
        return F.linear(x.to(d), self.weight.flatten(1).to(d), self.bias.to(d))


class LayerNormF32(nn.Module):
    """LayerNorm computed in fp32, output cast back to the input dtype."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.to(torch.float32), x.shape[-1:], self.weight, self.bias, self.eps).to(x.dtype)

    def quant_rows(self, x: torch.Tensor, norm_out: bool = True):
        """The norm with the per-row int8 quantization of its output (JAX:
        unet.py:252-273, ``quant_rowwise``): (x_norm | None, xq, scales) from
        K7 where JAX's rule takes it and x is bf16 (``norm_out=False``: every
        consumer reads the int8 side, so x_norm is not written), else
        (x_norm, None, None)."""
        dim = x.shape[-1]
        if x.dtype == torch.bfloat16 and q8.ln_quant_qualifies(x.numel() // dim, dim):
            return q8.ln_quant_rowwise(x, self.weight, self.bias, eps=self.eps, norm_out=norm_out)
        return self(x), None, None


class Upsample(nn.Module):
    """Nearest 2x, then the 3x3 conv (``use_conv=False``: no conv, JAX's
    ``conv_resample=False``)."""

    def __init__(self, channels: int, dtype=torch.float32, quant: bool = False, use_conv: bool = True):
        super().__init__()
        self.conv = Conv3x3(channels, channels, dtype=dtype, quant=quant) if use_conv else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = nearest_upsample_2x(x)
        return x if self.conv is None else self.conv(x)


class Downsample(nn.Module):
    """The stride-2 3x3 conv (``use_conv=False``: the 2x2 average pool)."""

    def __init__(self, channels: int, dtype=torch.float32, quant: bool = False, use_conv: bool = True):
        super().__init__()
        self.op = Conv3x3(channels, channels, stride=2, dtype=dtype, quant=quant) if use_conv else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return avg_pool_2x(x) if self.op is None else self.op(x)


class ResBlock(nn.Module):
    """Timestep-conditioned residual block.  ``quant``: the two 3x3 convs and
    the skip 1x1 are int8; ``emb_layers`` stays fp.

    ``use_scale_shift_norm`` (JAX: unet.py:376-380, :413-418, :436-439):
    ``emb_layers`` gives 2 * cout, split into (scale, shift), and the second
    norm's output becomes norm(h) * (1 + scale) + shift, in place of the
    emb-add before the norm.  ``up`` / ``down``: after the first norm and SiLU, h and the skip input
    x are resampled (nearest 2x, or the 2x2 average pool) before the first
    conv, as JAX's ResBlock does (unet.py:428-433).

    ``fused`` (JAX: unet.py:382-423, ``LEFTREFILL_FUSED_RES`` on): in a bf16
    int8 block without ``up`` / ``down`` whose two convs qualify, each GN +
    SiLU + conv stack is ``gn_silu_conv3x3_int8`` (K4, then KI1 on its int8
    output), the emb-add or the scale-shift folded into the second GN's
    affine.  Otherwise the unfused int8 arm runs."""

    def __init__(self, cin: int, cout: int, emb_dim: int, dtype=torch.float32, quant: bool = False,
                 fused: bool = True, use_scale_shift_norm: bool = False, up: bool = False, down: bool = False):
        super().__init__()
        self.dtype, self.quant, self.fused = dtype, quant, fused
        self.use_scale_shift_norm, self.up, self.down = use_scale_shift_norm, up, down
        self.in_layers = nn.ModuleList([GroupNorm32(cin), nn.SiLU(), Conv3x3(cin, cout, dtype=dtype, quant=quant)])
        self.emb_layers = nn.ModuleList(
            [nn.SiLU(), Linear(emb_dim, 2 * cout if use_scale_shift_norm else cout, dtype=dtype)])
        self.out_layers = nn.ModuleList(
            [GroupNorm32(cout), nn.SiLU(), nn.Identity(), Conv3x3(cout, cout, dtype=dtype, quant=quant)]
        )
        self.skip_connection = Conv1x1(cin, cout, dtype=dtype, quant=quant) if cin != cout else None

    def _fused_groups(self, x: torch.Tensor):
        """(g1, g2) where the fused arm applies to x, else None."""
        if not (self.fused and self.quant and self.dtype == torch.bfloat16 and x.ndim == 4
                and not self.up and not self.down):
            return None
        _, hh, ww, cin = x.shape
        cout = self.out_layers[3].weight.shape[0]
        g1, g2 = adjust_groups(32, cin), adjust_groups(32, cout)
        if (q8.gn_silu_conv3x3_int8_qualifies(hh, ww, cin, cout, g1)
                and q8.gn_silu_conv3x3_int8_qualifies(hh, ww, cout, cout, g2)):
            return g1, g2
        return None

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        # emb is projected at the full batch, then cut to h's (half, under
        # cfg_dup) batch: a 1-row product takes another CPU path than a 2-row
        # one, and the shared prefix must stay bit-identical to the doubled run
        groups = self._fused_groups(x)
        if groups is not None:
            (n1, _, c1), (n2, _, _, c2) = self.in_layers, self.out_layers
            h = q8.gn_silu_conv3x3_int8(x.to(self.dtype), n1.weight, n1.bias, c1.weight.permute(0, 2, 3, 1),
                                        c1.weight_scale, c1.bias, num_groups=groups[0], eps=n1.eps)
            eo = self.emb_layers[1](F.silu(emb))[: h.shape[0]]
            fold = dict(scale_shift=eo.chunk(2, dim=-1)) if self.use_scale_shift_norm else dict(emb=eo)
            h = q8.gn_silu_conv3x3_int8(h, n2.weight, n2.bias, c2.weight.permute(0, 2, 3, 1), c2.weight_scale,
                                        c2.bias, num_groups=groups[1], eps=n2.eps, **fold)
        else:
            h = F.silu(self.in_layers[0](x))
            if self.up:
                h, x = nearest_upsample_2x(h), nearest_upsample_2x(x)
            elif self.down:
                h, x = avg_pool_2x(h), avg_pool_2x(x)
            h = self.in_layers[2](h)
            eo = self.emb_layers[1](F.silu(emb))[: h.shape[0]].to(h.dtype)
            if self.use_scale_shift_norm:
                scale, shift = eo.chunk(2, dim=-1)
                h = self.out_layers[0](h) * (1 + scale[:, None, None, :]) + shift[:, None, None, :]
            else:
                h = self.out_layers[0](h + eo[:, None, None, :])
            h = self.out_layers[3](F.silu(h))
        skip = x if self.skip_connection is None else self.skip_connection(x)
        return skip.to(h.dtype) + h


class CrossAttention(nn.Module):
    """``quant``: the four projections are int8; each distinct activation is
    quantized once per row (q, k and v share x's pass when self-attending,
    the context's pass when the K/V cache is built).

    ``probs_sink``: None, or a callable that each forward hands its
    head-averaged attention probabilities [B, Nq, Nk] (``attention_probs`` of
    the q and k it computed, on every path: the K/V cache, int8, the fused
    prenorm's ``pre_quant``); ``eval.attn_vis.collect_attention_maps`` sets
    it on the cross-attentions and clears it after (JAX: ``return_attn`` and
    ``sow``).

    ``attn_fn``: None (``multi_head_attention``), or a function of its
    signature that replaces the attention math; the view-sharded multi-view
    block sets the context-parallel one (``parallel.context``)."""

    probs_sink = None
    attn_fn = None

    def __init__(self, query_dim: int, heads: int, dim_head: int, context_dim: Optional[int] = None,
                 dtype=torch.float32, quant: bool = False):
        super().__init__()
        inner = heads * dim_head
        kv_dim = context_dim if context_dim is not None else query_dim
        self.heads, self.quant = heads, quant
        self.to_q = Linear(query_dim, inner, bias=False, dtype=dtype, quant=quant)
        self.to_k = Linear(kv_dim, inner, bias=False, dtype=dtype, quant=quant)
        self.to_v = Linear(kv_dim, inner, bias=False, dtype=dtype, quant=quant)
        self.to_out = nn.ModuleList([Linear(inner, query_dim, dtype=dtype, quant=quant), nn.Identity()])

    def _quantized(self, x: torch.Tensor):
        return q8.quantize_activation_rowwise(x) if self.quant else (None, None)

    def kv(self, context: torch.Tensor, pre=None) -> tuple[torch.Tensor, torch.Tensor]:
        """(k, v) for a fixed context: the conditioning KV cache."""
        cq, cs = pre if pre is not None else self._quantized(context)
        return self.to_k(context, cq, cs), self.to_v(context, cq, cs)

    def forward(self, x, context=None, kv=None, pre_quant=None) -> torch.Tensor:
        """``pre_quant``: (xq, scales) of x from the fused LN + quant prenorm
        (JAX: unet.py:603-620); x is then only a stand-in and is not read
        by the int8 projections."""
        xq, sx = pre_quant if pre_quant is not None else self._quantized(x)
        q = self.to_q(x, xq, sx)
        if kv is not None:
            k, v = kv
        else:
            k, v = self.kv(x, (xq, sx)) if context is None else self.kv(context)
        if self.probs_sink is not None:
            self.probs_sink(attention_probs(q, k, self.heads))
        fn = self.attn_fn if self.attn_fn is not None else multi_head_attention
        return self.to_out[0](fn(q, k, v, self.heads))


def _linear_fp32_bias(din: int, dout: int, dtype) -> nn.Linear:
    """Linear with the weight in the compute dtype and an fp32 bias (K3 adds
    its biases in fp32, as the TPU kernel does)."""
    lin = nn.Linear(din, dout, dtype=dtype)
    lin.bias = nn.Parameter(torch.zeros(dout))
    return lin


def _ff_linear(din: int, dout: int, dtype, quant: bool) -> nn.Linear:
    return Linear(din, dout, dtype=dtype, quant=True) if quant else _linear_fp32_bias(din, dout, dtype)


class GEGLUProj(nn.Module):
    """Holder of ``ff.net.0.proj`` (Linear dim -> 2*inner, [value | gate])."""

    def __init__(self, dim: int, inner: int, dtype=torch.float32, quant: bool = False):
        super().__init__()
        self.proj = _ff_linear(dim, 2 * inner, dtype, quant)


class GEGLUFeedForward(nn.Module):
    """GEGLU feed-forward: value * gelu_erf(gate), then Linear(inner, dim).
    bf16 runs go through the fused kernel K3 where the shape qualifies;
    ``quant`` runs go through KI3 where JAX's int8 rule takes K10, otherwise
    through two int8 dense products (h requantized per row as a whole)."""

    def __init__(self, dim: int, mult: int = 4, dtype=torch.float32, quant: bool = False):
        super().__init__()
        self.dim, self.inner, self.dtype, self.quant = dim, dim * mult, dtype, quant
        self.net = nn.ModuleList(
            [GEGLUProj(dim, self.inner, dtype, quant), nn.Identity(), _ff_linear(self.inner, dim, dtype, quant)]
        )

    def _int8(self, x2: torch.Tensor, pre_quant=None) -> torch.Tensor:
        p1, p2 = self.net[0].proj, self.net[2]
        r, din = x2.shape
        if self.dtype == torch.bfloat16 and mlp.geglu_int8_qualifies(r, din, self.inner, self.dim):
            chunk = mlp.geglu_int8_chunk(r, din, self.inner, self.dim)
            kernels.note_site("geglu_int8", (r, din, self.inner, self.dim, chunk))
            if pre_quant is not None:
                xq, sx = pre_quant[0].reshape(r, din), pre_quant[1].reshape(r, 1)
            else:
                xq, sx = q8.quantize_activation_rowwise(x2.to(self.dtype))
            fn = mlp.geglu_int8_plain if kernels.plain_kernels_active("geglu_int8") else mlp.geglu_int8_fused
            return fn(xq, sx, p1.weight, p1.weight_scale, p1.bias, p2.weight, p2.weight_scale, p2.bias, chunk)
        val, gate = p1(x2).chunk(2, dim=-1)
        return p2(val * F.gelu(gate.to(torch.float32)).to(val.dtype))

    def forward(self, x: torch.Tensor, res: Optional[torch.Tensor] = None, pre_quant=None) -> torch.Tensor:
        """``pre_quant``: (xq, scales) of x from the fused LN + quant prenorm
        (JAX: unet.py:498-541), taken by KI3 in place of its own per-row
        quantization; the two-dense fallback reads x itself."""
        d = self.dtype
        din = x.shape[-1]
        x2 = x.reshape(-1, din)
        p1, p2 = self.net[0].proj, self.net[2]
        if self.quant:
            out = self._int8(x2, pre_quant)
        elif d == torch.bfloat16 and mlp.geglu_fused_qualifies(x2, din, self.inner, self.dim):
            kernels.note_site("geglu", (x2.shape[0], din, self.inner, self.dim))
            out = mlp.geglu_apply(x2.to(d).contiguous(), p1.weight.to(d), p1.bias.to(torch.float32),
                                  p2.weight.to(d), p2.bias.to(torch.float32))
        else:
            xg = F.linear(x2.to(d), p1.weight.to(d), p1.bias.to(d))
            val, gate = xg.chunk(2, dim=-1)
            h = val * F.gelu(gate.to(torch.float32)).to(val.dtype)
            out = F.linear(h.to(d), p2.weight.to(d), p2.bias.to(d))
        out = out.reshape(*x.shape[:-1], self.dim)
        return out if res is None else out + res.to(out.dtype)


class BasicTransformerBlock(nn.Module):
    """Self-attention -> cross-attention(context) -> GEGLU FF, pre-norm and
    residual.

    ``lnq`` (``quant`` and ``fused``; JAX: unet.py:736-773,
    ``LEFTREFILL_FUSED_LNQ`` on): the three prenorms go through K7, whose
    int8 rows feed the attention projections and KI3 directly.  Every
    consumer of norm1 and norm2 is int8, so they write no bf16 output; norm3
    writes it only where the feed-forward falls back to its two dense
    products (which read it)."""

    collects_attention = True  # ``attn2`` hands its probabilities to a set ``probs_sink``

    def __init__(self, dim: int, n_heads: int, d_head: int, context_dim: int, dtype=torch.float32,
                 quant: bool = False, fused: bool = True):
        super().__init__()
        self.dim, self.dtype, self.lnq = dim, dtype, quant and fused
        self.attn1 = CrossAttention(dim, n_heads, d_head, dtype=dtype, quant=quant)
        self.ff = GEGLUFeedForward(dim, dtype=dtype, quant=quant)
        self.attn2 = CrossAttention(dim, n_heads, d_head, context_dim=context_dim, dtype=dtype, quant=quant)
        self.norm1 = LayerNormF32(dim)
        self.norm2 = LayerNormF32(dim)
        self.norm3 = LayerNormF32(dim)

    def cross_kv(self, context: torch.Tensor):
        return self.attn2.kv(context)

    def _prenorm(self, norm: LayerNormF32, x: torch.Tensor, norm_out: bool = False):
        """(input for the consumer, its pre_quant or None) from a prenorm."""
        if not self.lnq:
            return norm(x), None
        xn, xq, sx = norm.quant_rows(x, norm_out=norm_out)
        return (xn if xn is not None else xq), (None if xq is None else (xq, sx))

    def self_attention(self, x: torch.Tensor) -> torch.Tensor:
        """norm1 -> attn1 -> + x (the multi-view block regroups the tokens
        around this)."""
        xin, pq = self._prenorm(self.norm1, x)
        return self.attn1(xin, pre_quant=pq) + x

    def cross_attention_ff(self, x: torch.Tensor, context, cross_kv) -> torch.Tensor:
        """norm2 -> attn2(context) -> + x, then norm3 -> GEGLU FF -> + x."""
        xin, pq = self._prenorm(self.norm2, x)
        x = self.attn2(xin, context, kv=cross_kv, pre_quant=pq) + x
        r = x.numel() // self.dim
        ff_int8 = self.dtype == torch.bfloat16 and mlp.geglu_int8_qualifies(r, self.dim, 4 * self.dim, self.dim)
        xin, pq = self._prenorm(self.norm3, x, norm_out=not ff_int8)
        return self.ff(xin, res=x, pre_quant=pq)

    def forward(self, x, context=None, cross_kv=None, dup_to_context: bool = False):
        """``dup_to_context``: x carries half the context batch (the CFG
        shared prefix); it is duplicated right before the cross-attention."""
        x = self.self_attention(x)
        if dup_to_context:
            x = torch.cat([x, x], dim=0)
        return self.cross_attention_ff(x, context, cross_kv)


class SpatialTransformer(nn.Module):
    """GroupNorm -> proj_in -> transformer blocks -> proj_out, residual.
    ``use_linear`` (SD2's setting): the projections are linear maps of the
    token rows; otherwise (JAX: unet.py:809-811, :880-898) they are 1x1
    convolutions of the NHWC map with the checkpoint's [C, C, 1, 1] weights,
    kept fp in an int8 UNet as in JAX.
    ``quant``: every linear projection int8; proj_out and the residual go
    through KI2 where JAX's rule takes K9, otherwise ``dense_int8`` and a
    bf16 add.  ``quant``, ``fused`` and ``use_linear`` (JAX:
    unet.py:853-877): for bf16 x where JAX's rule takes it, the GroupNorm and
    proj_in's per-pixel quantization are one K8 pass (no bf16 output:
    proj_in reads the int8 side).
    ``ctx_slot`` (JAX: unet.py:792, :828-838): this transformer's index in
    the UNet's traversal order, which ``UNetModel`` sets; a deep-prompt
    context [B, n_layers, L, C] gives it ``context[:, ctx_slot]`` (a
    [B, L, C] context passes through).
    ``block_cls`` / ``block_kwargs`` (JAX's fields of the same names) build
    the transformer blocks, the multi-view block among them."""

    def __init__(self, channels: int, n_heads: int, d_head: int, depth: int = 1,
                 context_dim: int = 1024, dtype=torch.float32, quant: bool = False, fused: bool = True,
                 block_cls=BasicTransformerBlock, block_kwargs: Optional[dict] = None, use_linear: bool = True):
        super().__init__()
        inner = n_heads * d_head
        self.dtype, self.quant, self.fused, self.use_linear = dtype, quant, fused, use_linear
        self.ctx_slot = 0  # the UNet numbers its transformers
        self.norm = GroupNorm32(channels, eps=1e-6)
        self.proj_in = Linear(channels, inner, dtype=dtype, quant=quant) if use_linear else Conv1x1(
            channels, inner, dtype=dtype)
        self.transformer_blocks = nn.ModuleList(
            [block_cls(inner, n_heads, d_head, context_dim, dtype=dtype, quant=quant, fused=fused,
                       **(block_kwargs or {}))
             for _ in range(depth)]
        )
        self.proj_out = Linear(inner, channels, dtype=dtype, quant=quant) if use_linear else Conv1x1(
            inner, channels, dtype=dtype)

    def slice_context(self, context: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """This transformer's slice of a deep-prompt context."""
        if context is not None and context.ndim == 4:
            return context[:, self.ctx_slot]
        return context

    def cross_kv(self, context: torch.Tensor) -> list:
        context = self.slice_context(context)
        return [blk.cross_kv(context) for blk in self.transformer_blocks]

    def forward(self, x, context=None, cross_kv=None, dup_to_context: bool = False):
        b, h, w, c = x.shape
        context = self.slice_context(context)
        x_in = x
        if not self.use_linear:
            x = self.proj_in(self.norm(x)).reshape(b, h * w, -1)
        elif (self.quant and self.fused and x.dtype == torch.bfloat16
                and q8.gn_quant_qualifies(h, w, c, self.norm.num_groups)):
            _, xq, sc = q8.gn_quant_rowwise(x, self.norm.weight, self.norm.bias, num_groups=self.norm.num_groups,
                                            eps=self.norm.eps, norm_out=False)
            xq = xq.reshape(b, h * w, c)
            x = self.proj_in(xq, xq, sc.reshape(b, h * w, 1))
        else:
            x = self.norm(x).reshape(b, h * w, c)
            x = self.proj_in(x)
        for i, blk in enumerate(self.transformer_blocks):
            x = blk(x, context, cross_kv=None if cross_kv is None else cross_kv[i],
                    dup_to_context=dup_to_context and i == 0)
        b2, hw, inner = x.shape
        if b2 != x_in.shape[0]:  # the prefix ran at half batch (cfg_dup)
            x_in = torch.cat([x_in, x_in], dim=0)
        if not self.use_linear:
            return self.proj_out(x.reshape(b2, h, w, inner)) + x_in
        res = x_in.reshape(b2, hw, c)
        if self.quant and x.dtype == torch.bfloat16 and q8.dense_int8_res_qualifies(b2, hw, inner, c):
            kernels.note_site("dense_int8_res", (b2 * hw, inner, c))
            po = self.proj_out
            xq, sx = q8.quantize_activation_rowwise(x.reshape(b2 * hw, inner))
            fn = q8.dense_int8_res_plain if kernels.plain_kernels_active("dense_int8_res") else q8.dense_int8_res_op
            out = fn(xq, sx, po.weight, po.weight_scale, po.bias, res.reshape(b2 * hw, c).to(x.dtype).contiguous())
            return out.reshape(b2, h, w, c)
        x = self.proj_out(x)
        return (x + res.to(x.dtype)).reshape(b2, h, w, c)


class UNetModel(nn.Module):
    """The SD2-inpainting UNet: 9 -> 4 channels, model_channels 320,
    ch_mult (1, 2, 4, 4), 2 res blocks per level, spatial transformers at
    ds 1/2/4 (depth 1, linear projections, head dim 64), context 1024.
    ``quant``: the W8A8 int8 UNet (module docstring); ``fused`` (default on,
    as JAX's two fusion flags) selects its fused prologues, ``fused=False``
    the unfused arm.  ``block_cls`` / ``block_kwargs``: the transformer block
    of every SpatialTransformer (``models.multiview``).  ``remat`` (JAX:
    ``nn.remat`` on ResBlock and SpatialTransformer, the training path)
    recomputes each such block in the backward instead of keeping its
    activations; the forward's values are unchanged.

    The options of JAX's ``UNetModel`` that no shipped config sets:
    ``num_heads`` with ``num_head_channels=-1`` (a fixed head count, the
    head width ch / num_heads); ``use_linear_in_transformer=False`` (1x1
    conv projections); ``conv_resample=False`` (Upsample without its conv,
    Downsample as the 2x2 average pool); ``use_scale_shift_norm`` (ResBlock);
    ``resblock_updown`` is taken and ignored: JAX's ``UNetModel`` holds it
    and builds the Down- and Upsamples whatever its value.  A context of
    four dimensions, [B, n_layers, L, C], is a deep-prompt context: each
    SpatialTransformer takes its own slice, in traversal order
    (``ctx_slot``)."""

    def __init__(
        self,
        in_channels: int = 9,
        model_channels: int = 320,
        out_channels: int = 4,
        num_res_blocks: int = 2,
        attention_resolutions: Sequence[int] = (4, 2, 1),
        channel_mult: Sequence[int] = (1, 2, 4, 4),
        num_head_channels: int = 64,
        transformer_depth: int = 1,
        context_dim: int = 1024,
        dtype: torch.dtype = torch.float32,
        quant: bool = False,
        fused: bool = True,
        block_cls=BasicTransformerBlock,
        block_kwargs: Optional[dict] = None,
        remat: bool = False,
        num_heads: int = -1,
        use_linear_in_transformer: bool = True,
        conv_resample: bool = True,
        use_scale_shift_norm: bool = False,
        resblock_updown: bool = False,
    ):
        super().__init__()
        del resblock_updown  # JAX's UNetModel ignores it too
        if num_head_channels == -1 and num_heads <= 0:
            raise ValueError("num_head_channels=-1 needs a positive num_heads")
        self.remat = remat
        self.model_channels, self.out_channels = model_channels, out_channels
        self.num_res_blocks, self.channel_mult = num_res_blocks, tuple(channel_mult)
        self.in_channels, self.context_dim, self.dtype = in_channels, context_dim, dtype
        emb_dim = 4 * model_channels
        self.time_embed = nn.ModuleList(
            [Linear(model_channels, emb_dim, dtype=dtype), nn.SiLU(), Linear(emb_dim, emb_dim, dtype=dtype)]
        )

        def st(ch):
            heads, dim_head = (num_heads, ch // num_heads) if num_head_channels == -1 else (
                ch // num_head_channels, num_head_channels)
            return SpatialTransformer(ch, heads, dim_head, transformer_depth, context_dim, dtype=dtype,
                                      quant=quant, fused=fused, block_cls=block_cls, block_kwargs=block_kwargs,
                                      use_linear=use_linear_in_transformer)

        def res(cin, cout):
            return ResBlock(cin, cout, emb_dim, dtype=dtype, quant=quant, fused=fused,
                            use_scale_shift_norm=use_scale_shift_norm)

        self.input_blocks = nn.ModuleList([nn.ModuleList([Conv3x3(in_channels, model_channels, dtype=dtype)])])
        chans, ch, ds = [model_channels], model_channels, 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [res(ch, mult * model_channels)]
                ch = mult * model_channels
                if ds in attention_resolutions:
                    layers.append(st(ch))
                self.input_blocks.append(nn.ModuleList(layers))
                chans.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(nn.ModuleList([Downsample(ch, dtype=dtype, quant=quant,
                                                                     use_conv=conv_resample)]))
                chans.append(ch)
                ds *= 2
        self.middle_block = nn.ModuleList(
            [res(ch, ch), st(ch), res(ch, ch)]
        )
        self.output_blocks = nn.ModuleList()
        for level, mult in reversed(list(enumerate(channel_mult))):
            for i in range(num_res_blocks + 1):
                skip_ch = chans.pop()
                layers = [res(ch + skip_ch, model_channels * mult)]
                ch = model_channels * mult
                if ds in attention_resolutions:
                    layers.append(st(ch))
                if level and i == num_res_blocks:
                    layers.append(Upsample(ch, dtype=dtype, quant=quant, use_conv=conv_resample))
                    ds //= 2
                self.output_blocks.append(nn.ModuleList(layers))
        self.out = nn.ModuleList([GroupNorm32(ch), nn.SiLU(), Conv3x3(ch, out_channels, dtype=dtype)])
        for slot, st_ in enumerate(self.spatial_transformers()):
            st_.ctx_slot = slot

    def spatial_transformers(self):
        for layers in [*self.input_blocks, self.middle_block, *self.output_blocks]:
            for layer in layers:
                if isinstance(layer, SpatialTransformer):
                    yield layer

    def cross_kv(self, context: torch.Tensor) -> list:
        """Every cross-attention layer's (k, v) for a fixed context, in
        traversal order: pass it back as ``cross_kv=``."""
        context = context.to(self.dtype)
        return [st.cross_kv(context) for st in self.spatial_transformers()]

    def _run(self, layer, *args, **kwargs):
        """A ResBlock or SpatialTransformer; under ``remat`` (while autograd
        records) through ``torch.utils.checkpoint``, which keeps only the
        block's inputs and runs its forward again in the backward."""
        if self.remat and torch.is_grad_enabled():
            return checkpoint(layer, *args, use_reentrant=False, **kwargs)
        return layer(*args, **kwargs)

    def _apply_seq(self, layers, h, emb, context, kv_iter, state):
        for layer in layers:
            if isinstance(layer, ResBlock):
                h = self._run(layer, h, emb)
            elif isinstance(layer, SpatialTransformer):
                kv = next(kv_iter) if kv_iter is not None else None
                h = self._run(layer, h, context, cross_kv=kv, dup_to_context=state["dup"])
                state["dup"] = False
            else:
                h = layer(h)
        return h

    def forward(self, x, timesteps, context=None, cross_kv=None, cfg_dup: bool = False):
        """x: [B, H, W, in_channels] NHWC.  ``cfg_dup``: the caller guarantees
        the two batch halves of x and timesteps are identical (the CFG
        layout); everything before the first cross-attention then runs once
        at half batch and is duplicated there."""
        t_emb = timestep_embedding(timesteps, self.model_channels, dtype=self.dtype)
        emb = self.time_embed[2](F.silu(self.time_embed[0](t_emb)))
        h = x.to(self.dtype)
        if context is not None:
            context = context.to(self.dtype)
        state = {"dup": bool(cfg_dup and context is not None)}
        if state["dup"]:
            assert h.shape[0] % 2 == 0, "cfg_dup needs the CFG-doubled batch"
            h = h[: h.shape[0] // 2]
        kv_iter = iter(cross_kv) if cross_kv is not None else None
        hs = []
        for layers in self.input_blocks:
            h = self._apply_seq(layers, h, emb, context, kv_iter, state)
            hs.append(h)
        h = self._apply_seq(self.middle_block, h, emb, context, kv_iter, state)
        for layers in self.output_blocks:
            skip = hs.pop()
            if skip.shape[0] != h.shape[0]:  # stored before the duplication point
                skip = torch.cat([skip, skip], dim=0)
            h = self._apply_seq(layers, torch.cat([h, skip], dim=-1), emb, context, kv_iter, state)
        if state["dup"]:  # no transformer consumed the context
            h = torch.cat([h, h], dim=0)
        h = F.silu(self.out[0](h.to(x.dtype)))
        return self.out[2](h).to(x.dtype)
