"""CLIP BPE tokenizer with dynamic special tokens (the port's own copy of
``leftrefill_tpu/models/tokenizer.py``; the port imports nothing of the JAX
package), and the multi-view prompt set-up.

Byte-level BPE over the ``bytes_to_unicode`` alphabet, the CLIP word regex,
``<start_of_text>`` = 49406 / ``<end_of_text>`` = 49407, vocab size 49408,
and special tokens with ids >= 49408 (the prompt embedder routes those to its
own table).  Without a BPE merges file (``bpe_path=None``) the vocab is the
synthetic byte-level one with the same id layout: multi-byte token ids differ
from real OpenCLIP's, and a warning says so.  ``tests/test_torch_isolation.py``
holds the copy equal to the JAX package's module on the same prompts.
"""

from __future__ import annotations

import functools
import gzip
import html
import warnings
from typing import Iterable, List, Sequence

import numpy as np

try:  # stdlib re lacks \p{L} classes
    import regex as re

    _HAS_REGEX = True
except ImportError:  # pragma: no cover
    import re  # type: ignore[no-redef]

    _HAS_REGEX = False

CONTEXT_LENGTH = 77
CLIP_VOCAB_SIZE = 49408
SOT_TEXT = "<start_of_text>"
EOT_TEXT = "<end_of_text>"


@functools.lru_cache()
def bytes_to_unicode() -> dict[int, str]:
    """Reversible byte -> printable-unicode map (the GPT-2/CLIP scheme)."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1)) \
        + list(range(ord("\xae"), ord("\xff") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word: tuple[str, ...]) -> set[tuple[str, str]]:
    return set(zip(word[:-1], word[1:]))


def basic_clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class SimpleTokenizer:
    """OpenCLIP-compatible BPE tokenizer with special-token extension."""

    def __init__(self, bpe_path: str | None = None, special_tokens: Sequence[str] | None = None,
                 context_length: int = CONTEXT_LENGTH):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.context_length = context_length
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        if bpe_path is not None:
            with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
                merges = f.read().split("\n")
            # header line, then the merges CLIP uses: entries 1 : 49152-256-2+1
            merges = [tuple(m.split()) for m in merges[1: 49152 - 256 - 2 + 1]]
            vocab.extend("".join(m) for m in merges)
            self.bpe_ranks = dict(zip(merges, range(len(merges))))
        else:
            warnings.warn(
                "No BPE merges file given: using the synthetic byte-level CLIP vocab (id layout "
                "identical, multi-byte token ids differ from real OpenCLIP). Pass "
                "bpe_path=bpe_simple_vocab_16e6.txt.gz for exact parity.",
                stacklevel=2,
            )
            self.bpe_ranks = {}
        # pad to the fixed CLIP vocab size minus the two control tokens
        while len(vocab) < CLIP_VOCAB_SIZE - 2:
            vocab.append(f"<unused{len(vocab)}>")
        base_specials = [SOT_TEXT, EOT_TEXT]
        special_tokens = list(special_tokens or [])
        vocab = vocab[: CLIP_VOCAB_SIZE - 2] + base_specials + special_tokens
        self.encoder = {t: i for i, t in enumerate(vocab)}
        self.decoder = {i: t for t, i in self.encoder.items()}
        self.vocab_size_base = CLIP_VOCAB_SIZE
        self.all_special: list[str] = base_specials + special_tokens
        self.cache = {t: t for t in self.all_special}
        # the specials come first in the alternation, in table order: a prompt
        # token that extends a shorter special is split after that special
        special_re = "|".join(re.escape(t) for t in self.all_special)
        words = (r"""|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""" if _HAS_REGEX
                 else r"""|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""")
        self.pat = re.compile(special_re + words, re.IGNORECASE)

    @property
    def sot_token(self) -> int:
        return self.encoder[SOT_TEXT]

    @property
    def eot_token(self) -> int:
        return self.encoder[EOT_TEXT]

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: list[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        result = " ".join(word)
        self.cache[token] = result
        return result

    def encode(self, text: str) -> List[int]:
        bpe_tokens: list[int] = []
        for token in self.pat.findall(whitespace_clean(basic_clean(text)).lower()):
            if token in self.all_special:
                bpe_tokens.append(self.encoder[token])
                continue
            token_b = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t] for t in self.bpe(token_b).split(" "))
        return bpe_tokens

    def decode(self, tokens: Iterable[int]) -> str:
        text = "".join(self.decoder[int(t)] for t in tokens)
        try:
            return bytearray(self.byte_decoder[c] for c in text).decode("utf-8", errors="replace").replace("</w>", " ")
        except KeyError:
            return text.replace("</w>", " ")

    def tokenize(self, texts: str | Sequence[str]) -> np.ndarray:
        """[n, context_length] int32: sot + tokens + eot, zero-padded, cut
        with eot kept last."""
        if isinstance(texts, str):
            texts = [texts]
        result = np.zeros((len(texts), self.context_length), dtype=np.int32)
        for i, text in enumerate(texts):
            tokens = [self.sot_token] + self.encode(text) + [self.eot_token]
            if len(tokens) > self.context_length:
                tokens = tokens[: self.context_length]
                tokens[-1] = self.eot_token
            result[i, : len(tokens)] = np.asarray(tokens, dtype=np.int32)
        return result


def expand_special_tokens(special_tokens: Sequence[str], init_text: Sequence[str] | None,
                          deep_prompt: bool = False, cross_attn_layers: int = 16):
    """The ``repeat_N_<tok>`` expansion and the deep-prompt per-layer
    duplication.  Returns (special_tokens, init_text)."""
    special_tokens = list(special_tokens)
    init_text = list(init_text) if init_text is not None else None
    if special_tokens and special_tokens[0].startswith("repeat_"):
        n = int(special_tokens[0].split("_")[1])
        special_tokens = special_tokens * n
        if init_text is not None:
            init_text = init_text * n
        for i in range(n):
            special_tokens[i] = special_tokens[i].split("_")[-1].replace(">", f"{i}>")
    if deep_prompt:
        special_tokens = [t.replace(">", f"-layer{i}>") for i in range(cross_attn_layers) for t in special_tokens]
        if init_text is not None:
            init_text = init_text * cross_attn_layers
    return special_tokens, init_text


def multiview_prompts(view_num: int, view_token_len: int = 30, repeat: int = 20,
                      sp_token: str = "<special-token>") -> tuple[list[str], list[str]]:
    """The multi-view embedder's special-token table and its per-view prompts
    (``configs/multiview_ref_inpainting.yaml``: ``repeat_20_<special-token>``,
    view_token_len 30, concat_target off).  The table holds the 20 repeated
    tokens and then ``<view_direct-j-l`` for each view j and position l,
    without a closing ``>``; view j's prompt is the 20 tokens joined by
    spaces, followed directly by ``<view_direct-j-l>`` for each l, with the
    ``>``.  Both quirks are the reference's (JAX: ``config.py:259-295``,
    ``data/datasets.py:284-298``).  Returns (special_tokens, prompts)."""
    special, _ = expand_special_tokens([f"repeat_{repeat}_{sp_token}"], None)
    view_tokens = [f"<view_direct-{j}-{l}" for j in range(view_num) for l in range(view_token_len)]
    base = " ".join(sp_token.replace(">", f"{i}>") for i in range(repeat))
    prompts = [base + "".join(f"<view_direct-{j}-{l}>" for l in range(view_token_len)) for j in range(view_num)]
    return special + view_tokens, prompts
