"""The OpenCLIP ViT-H text tower and the prompt-token embedder in PyTorch
(counterpart of ``leftrefill_tpu/models/clip.py``).  Module names follow the
checkpoint under ``cond_stage_model.`` (``model.transformer.resblocks.N.*``,
``special_embeddings.weight``)."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from leftrefill_torch.models.tokenizer import SimpleTokenizer, expand_special_tokens, multiview_prompts

from leftrefill_torch.ops.attention import causal_text_attention
from leftrefill_torch.ops.layers import Linear


class MultiheadAttentionParams(nn.Module):
    """torch ``nn.MultiheadAttention``'s parameter layout (packed in_proj)."""

    def __init__(self, width: int, dtype=torch.float32):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width, dtype=dtype))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width, dtype=dtype))
        self.out_proj = Linear(width, width, dtype=dtype)


class TextResBlock(nn.Module):
    """Pre-norm attention + pre-norm GELU MLP (open_clip ResidualAttentionBlock)."""

    def __init__(self, width: int, heads: int, dtype=torch.float32):
        super().__init__()
        self.heads, self.dtype = heads, dtype
        self.ln_1 = nn.LayerNorm(width)
        self.attn = MultiheadAttentionParams(width, dtype)
        self.ln_2 = nn.LayerNorm(width)
        self.mlp = nn.Module()
        self.mlp.c_fc = Linear(width, 4 * width, dtype=dtype)
        self.mlp.c_proj = Linear(4 * width, width, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.dtype
        y = self.ln_1(x.to(torch.float32)).to(x.dtype)
        qkv = F.linear(y.to(d), self.attn.in_proj_weight.to(d), self.attn.in_proj_bias.to(d))
        q, k, v = qkv.chunk(3, dim=-1)
        x = x + self.attn.out_proj(causal_text_attention(q, k, v, self.heads))
        y = self.ln_2(x.to(torch.float32)).to(x.dtype)
        y = F.gelu(self.mlp.c_fc(y).to(torch.float32)).to(x.dtype)
        return x + self.mlp.c_proj(y)


class CLIPTextTransformer(nn.Module):
    """The frozen causal text transformer; input is the blended token
    embedding [B, L, width], output the ln_final'd fp32 sequence."""

    def __init__(self, width=1024, heads=16, layers=24, context_length=77, vocab_size=49408,
                 dtype=torch.float32):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(torch.empty(context_length, width))
        self.transformer = nn.Module()
        self.transformer.resblocks = nn.ModuleList(
            [TextResBlock(width, heads, dtype) for _ in range(layers)]
        )
        self.ln_final = nn.LayerNorm(width)

    def forward(self, text_emb: torch.Tensor, skip_last: int) -> torch.Tensor:
        x = text_emb + self.positional_embedding.to(text_emb.dtype)
        blocks = self.transformer.resblocks
        for blk in blocks[: len(blocks) - skip_last]:
            x = blk(x)
        return self.ln_final(x.to(torch.float32))


class PromptCLIPEmbedder(nn.Module):
    """Text conditioning with trainable prompt tokens: ids >= vocab_size pick
    rows of ``special_embeddings``; the output is, after ln_final, the
    penultimate layer (``layer="penultimate"``: the last resblock is
    skipped, SD2's setting) or the last (``layer="last"``).

    ``deep_prompt`` (JAX: clip.py:116-163): a table of
    ``num_special_tokens * cross_attn_layers`` rows (each cross-attention
    layer its own prompt tokens), and ids [B, n_layers, L] give one context
    per layer, [B, n_layers, L, width]."""

    def __init__(self, vocab_size=49408, width=1024, heads=16, layers=24, context_length=77,
                 num_special_tokens=50, dtype=torch.float32, layer: str = "penultimate", deep_prompt: bool = False,
                 cross_attn_layers: int = 16):
        super().__init__()
        if layer not in ("last", "penultimate"):
            raise ValueError(f"layer must be 'last' or 'penultimate', got {layer!r}")
        self.vocab_size, self.dtype, self.num_special_tokens = vocab_size, dtype, num_special_tokens
        self.layer, self.deep_prompt, self.cross_attn_layers = layer, deep_prompt, cross_attn_layers
        self.model = CLIPTextTransformer(width, heads, layers, context_length, vocab_size, dtype)
        self.special_embeddings = nn.Embedding(num_special_tokens * (cross_attn_layers if deep_prompt else 1), width)

    @property
    def skip_last(self) -> int:
        return 1 if self.layer == "penultimate" else 0

    def blend_embeddings(self, tokens: torch.Tensor) -> torch.Tensor:
        mask = (tokens >= self.vocab_size).to(torch.float32)[..., None]
        regular = self.model.token_embedding.weight[tokens.clamp(0, self.vocab_size - 1)]
        special = self.special_embeddings.weight[(tokens - self.vocab_size).clamp(min=0)]
        return (regular * (1 - mask) + special * mask).to(self.dtype)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, L] int -> [B, L, width] fp32; under ``deep_prompt``
        [B, n_layers, L] -> [B, n_layers, L, width]."""
        if self.deep_prompt:
            b, n, length = tokens.shape
            z = self.model(self.blend_embeddings(tokens.reshape(b * n, length)), skip_last=self.skip_last)
            return z.reshape(b, n, length, -1)
        return self.model(self.blend_embeddings(tokens), skip_last=self.skip_last)


def build_prompt_tokenizer(
    special_tokens: Sequence[str],
    init_text: Sequence[str] | None = None,
    bpe_path: str | None = None,
    deep_prompt: bool = False,
    cross_attn_layers: int = 16,
) -> tuple[SimpleTokenizer, list[str], list[str] | None]:
    """Expand ``repeat_N_*`` token lists (and, ``deep_prompt``, each token
    into one per cross-attention layer, ``<tok-layerI>``) and build the
    extended tokenizer."""
    sp, init = expand_special_tokens(special_tokens, init_text, deep_prompt, cross_attn_layers)
    return SimpleTokenizer(bpe_path=bpe_path, special_tokens=sp), sp, init


def build_multiview_prompt_tokenizer(view_num: int, bpe_path: str | None = None):
    """The multi-view embedder's tokenizer (20 repeated prompt tokens and
    30 view tokens per view, ``tokenizer.multiview_prompts``): returns
    (tokenizer, special tokens, one prompt per view).  The embedder that
    reads these ids is ``PromptCLIPEmbedder(num_special_tokens=len(special))``."""
    sp, prompts = multiview_prompts(view_num)
    return SimpleTokenizer(bpe_path=bpe_path, special_tokens=sp), sp, prompts


def init_special_embeddings(
    tokenizer: SimpleTokenizer,
    special_tokens: Sequence[str],
    token_embedding: np.ndarray,
    init_text: Sequence[str] | None,
    tokenwise_init: bool = False,
) -> np.ndarray:
    """The prompt table's first values from the frozen token embedding
    (JAX: ``models/clip.py:init_special_embeddings``): per token the mean
    embedding of its init sentence (of its own name without the brackets,
    dashes as spaces, when there is no init text), or, ``tokenwise_init``,
    the first sentence's tokens one by one and the mean of the following
    sentences for the rest.  fp32 [len(special_tokens), width]."""
    width = token_embedding.shape[1]
    out = np.zeros((len(special_tokens), width), dtype=np.float32)
    if tokenwise_init:
        assert init_text is not None
        origin = tokenizer.encode(init_text[0])[: len(special_tokens)]
        for i, tok_idx in enumerate(origin):
            out[i] = token_embedding[tok_idx]
        for i in range(len(origin), len(special_tokens)):
            out[i] = token_embedding[np.asarray(tokenizer.encode(init_text[i]))].mean(axis=0)
        return out
    for i, sp_token in enumerate(special_tokens):
        text = sp_token.strip("<").strip(">").replace("-", " ") if init_text is None else init_text[i]
        out[i] = token_embedding[np.asarray(tokenizer.encode(text))].mean(axis=0)
    return out


def init_prompt_table(embedder: PromptCLIPEmbedder, tokenizer: SimpleTokenizer, special_tokens: Sequence[str],
                      init_text: Sequence[str] | None, tokenwise_init: bool = False) -> None:
    """Set ``embedder.special_embeddings`` (fp32, as JAX's parameters) from
    :func:`init_special_embeddings`, as the JAX task does at set-up
    (``tasks.py:_init_special_embeddings``): left as it is when
    ``init_text`` is None or starts with "<random>"."""
    if init_text is None or (init_text and init_text[0] == "<random>"):
        return
    table = embedder.model.token_embedding.weight.detach().to(torch.float32).cpu().numpy()
    w = init_special_embeddings(tokenizer, special_tokens, table, init_text, tokenwise_init)
    with torch.no_grad():
        embedder.special_embeddings.weight.copy_(torch.from_numpy(w))
