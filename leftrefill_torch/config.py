"""The config system (counterpart of ``leftrefill_tpu/config.py``): the
reference's ``target:`` / ``params:`` model YAMLs build the port's modules.

A ``REGISTRY`` maps the reference's ``target`` strings to builders of the
port's modules; ``build_model_from_config`` assembles the bundle of a model
YAML (``configs/*.yaml``): the ``LeftRefillModel`` (UNet, VAE, prompt
embedder, schedule, and the refinement branch where the novel-view YAML
turns it on), the tokenizer with its prompt tokens and init text, and the
YAML's data, LoRA and refinement settings.  The modules are built on
``meta`` and materialized on ``device`` without values: the task's
``init_params`` fills them.  As in JAX, ``use_checkpoint`` is dropped (no
rematerialization).

``load_yaml`` is the port's own reader of the YAML the repository's configs
use (no PyYAML): block and flow mappings and lists, quoted and plain
strings, ints, floats in ``1.0e-4`` form, ``true`` / ``false`` (also
capitalized), ``null`` / ``~`` and comments, resolved as PyYAML's
``safe_load`` resolves them.  Anything else raises.  ``dump_yaml`` writes
a parsed config back (block mappings, the rest inline) in a form the reader
reads back equal.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Optional

import torch

from leftrefill_torch.diffusion.core import LeftRefillModel
from leftrefill_torch.diffusion.schedules import DiffusionSchedule
from leftrefill_torch.models.autoencoder import AutoencoderKL, DDConfig
from leftrefill_torch.models.clip import PromptCLIPEmbedder
from leftrefill_torch.models.tokenizer import SimpleTokenizer, expand_special_tokens
from leftrefill_torch.models.unet import UNetModel

# ---------------------------------------------------------------------------
# the YAML reader

_INT = re.compile(r"[-+]?(0|[1-9][0-9]*)")
_FLOAT = re.compile(r"[-+]?([0-9][0-9]*)?\.[0-9]*([eE][-+][0-9]+)?")
_BOOL = {"true": True, "True": True, "TRUE": True, "false": False, "False": False, "FALSE": False}
_NULL = ("null", "Null", "NULL", "~", "")
# plain scalars PyYAML resolves to something this reader does not produce
_REFUSED = re.compile(r"(yes|Yes|YES|no|No|NO|on|On|ON|off|Off|OFF|[-+]?\.(inf|Inf|INF)|\.(nan|NaN|NAN)|"
                      r"[-+]?0[0-7_]+|[-+]?0[xob][0-9a-fA-F_]+|[-+]?[0-9][0-9_]*(:[0-5]?[0-9])+(\.[0-9_]*)?|"
                      r"[-+]?[0-9][0-9_]*_[0-9_]*|\d{4}-\d\d?-\d\d?.*)")


class YAMLError(ValueError):
    pass


def _scalar(text: str, where: str):
    """A plain scalar resolved as PyYAML's safe loader resolves it."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.fullmatch(text):
        return int(text)
    if _FLOAT.fullmatch(text) and any(c.isdigit() for c in text):
        return float(text)
    if _REFUSED.fullmatch(text) or text[0] in "&*!|>%@`" or text.startswith(("- ", "? ")):
        raise YAMLError(f"{where}: the scalar {text!r} is outside the YAML this reader takes")
    return text


def _quoted(s: str, i: int, where: str) -> tuple[str, int]:
    """The quoted string starting at s[i]; returns (value, index past it)."""
    q = s[i]
    out, i = [], i + 1
    escapes = {"n": "\n", "t": "\t", "\\": "\\", '"': '"', "/": "/", "0": "\0", "r": "\r", " ": " "}
    while i < len(s):
        c = s[i]
        if q == "'" and c == "'":
            if s[i + 1: i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if q == '"' and c == '"':
            return "".join(out), i + 1
        if q == '"' and c == "\\":
            e = s[i + 1: i + 2]
            if e in escapes:
                out.append(escapes[e])
                i += 2
                continue
            if e == "u" and re.fullmatch(r"[0-9a-fA-F]{4}", s[i + 2: i + 6]):
                out.append(chr(int(s[i + 2: i + 6], 16)))
                i += 6
                continue
            raise YAMLError(f"{where}: unknown escape \\{e}")
        out.append(c)
        i += 1
    raise YAMLError(f"{where}: unterminated quoted string")


def _strip_comment(line: str) -> str:
    """The line without its comment (a # at the start or after a blank,
    outside quotes)."""
    q, i = None, 0
    while i < len(line):
        c = line[i]
        if q:
            if q == "'" and line[i:i + 2] == "''":  # an escaped quote
                i += 1
            elif q == '"' and c == "\\":
                i += 1
            elif c == q:
                q = None
        elif c in "'\"" and (i == 0 or line[i - 1] in " \t[{,:"):
            q = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        i += 1
    return line.rstrip()


def _flow(s: str, i: int, where: str):
    """A flow node starting at s[i] (after blanks): returns (value, index)."""
    while i < len(s) and s[i] in " \t":
        i += 1
    if i >= len(s):
        raise YAMLError(f"{where}: flow collection ends early")
    c = s[i]
    if c in "[{":
        close = "]" if c == "[" else "}"
        items: Any = [] if c == "[" else {}
        i += 1
        while True:
            while i < len(s) and s[i] in " \t":
                i += 1
            if i < len(s) and s[i] == close:
                return items, i + 1
            if c == "[":
                v, i = _flow(s, i, where)
                items.append(v)
            else:
                k, i = _flow(s, i, where)
                while i < len(s) and s[i] in " \t":
                    i += 1
                if s[i: i + 1] != ":":
                    raise YAMLError(f"{where}: a flow mapping entry without ':'")
                v, i = _flow(s, i + 1, where)
                items[k] = v
            while i < len(s) and s[i] in " \t":
                i += 1
            if s[i: i + 1] == ",":
                i += 1
            elif s[i: i + 1] != close:
                raise YAMLError(f"{where}: expected ',' or {close!r} in a flow collection")
    if c in "'\"":
        return _quoted(s, i, where)
    j = i
    while j < len(s) and s[j] not in ",]}" and not (s[j] == ":" and (j + 1 == len(s) or s[j + 1] in " \t,]}")):
        j += 1
    return _scalar(s[i:j].strip(), where), j


def _value(text: str, where: str):
    """An inline value: a flow collection, a quoted or a plain scalar."""
    if text[:1] in "[{'\"":
        v, end = _flow(text, 0, where)
        if text[end:].strip():
            raise YAMLError(f"{where}: text after the value: {text[end:]!r}")
        return v
    return _scalar(text, where)


def _split_key(text: str, where: str):
    """'key: value' / 'key:' -> (key, value text) or None where the line is
    no mapping entry."""
    if text[:1] in "'\"":
        key, i = _quoted(text, 0, where)
    else:
        m = re.match(r"([^\s:#][^:#]*?|[^\s:#]*?):(?=\s|$)", text)
        if not m:
            return None
        key, i = _scalar(m.group(1).strip(), where), len(m.group(1))
    rest = text[i:].lstrip()
    if not rest.startswith(":"):
        return None
    return key, rest[1:].strip()


def _logical_lines(src: str) -> list[tuple[int, str, int]]:
    """(indent, text, line number) of the non-blank lines, comments cut and
    a flow collection's continuation lines joined to the line it starts on."""
    out = []
    depth, buf = 0, None
    for n, raw in enumerate(src.splitlines(), 1):
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise YAMLError(f"line {n}: tab indentation")
        line = _strip_comment(raw)
        if not line.strip():
            continue
        if line.strip() in ("---", "...") or line.lstrip().startswith("%"):
            raise YAMLError(f"line {n}: documents and directives are outside the YAML this reader takes")
        q = None
        for c in line:
            if q:
                q = None if c == q else q
            elif c in "'\"":
                q = c
            elif c in "[{":
                depth += 1
            elif c in "]}":
                depth -= 1
        if buf is None:
            buf = [len(line) - len(line.lstrip()), line.strip(), n]
        else:
            buf[1] += " " + line.strip()
        if depth == 0:
            out.append(tuple(buf))
            buf = None
    if buf is not None:
        raise YAMLError(f"line {buf[2]}: unclosed flow collection")
    return out


def _block(lines, pos: int, indent: int):
    """The block node whose lines start at lines[pos] with this indent:
    returns (value, next position)."""
    first = lines[pos][1]
    if first == "-" or first.startswith("- "):
        items = []
        while pos < len(lines) and lines[pos][0] == indent and (lines[pos][1] == "-" or lines[pos][1].startswith("- ")):
            _, text, n = lines[pos]
            rest = text[1:].strip()
            pos += 1
            if rest:
                if _split_key(rest, f"line {n}") is not None and rest[:1] not in "[{":
                    raise YAMLError(f"line {n}: a mapping inside a block list item is outside this reader")
                items.append(_value(rest, f"line {n}"))
            elif pos < len(lines) and lines[pos][0] > indent:
                v, pos = _block(lines, pos, lines[pos][0])
                items.append(v)
            else:
                items.append(None)
        return items, pos
    out: dict = {}
    while pos < len(lines) and lines[pos][0] == indent:
        _, text, n = lines[pos]
        kv = _split_key(text, f"line {n}")
        if kv is None:
            raise YAMLError(f"line {n}: expected 'key: value', got {text!r}")
        key, rest = kv
        pos += 1
        if rest:
            out[key] = _value(rest, f"line {n}")
        elif pos < len(lines) and (lines[pos][0] > indent or (lines[pos][0] == indent and lines[pos][1][:2] == "- ")):
            out[key], pos = _block(lines, pos, lines[pos][0])
        else:
            out[key] = None
    if pos < len(lines) and lines[pos][0] > indent:
        raise YAMLError(f"line {lines[pos][2]}: unexpected indentation")
    return out, pos


def parse_yaml(src: str):
    """The YAML text ``src`` as Python values (None for an empty document)."""
    lines = _logical_lines(src)
    if not lines:
        return None
    if len(lines) == 1 and _split_key(lines[0][1], "line 1") is None and not lines[0][1].startswith("-"):
        return _value(lines[0][1], f"line {lines[0][2]}")
    value, pos = _block(lines, 0, lines[0][0])
    if pos != len(lines):
        raise YAMLError(f"line {lines[pos][2]}: unexpected indentation")
    return value


def load_yaml(path: str):
    with open(path) as f:
        return parse_yaml(f.read())


_PLAIN_KEY = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")


def _dump_scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        text = repr(v)
        if text in ("inf", "-inf", "nan"):
            raise YAMLError(f"the float {v} is outside the YAML this writer gives")
        mantissa, _, exp = text.partition("e")
        # the reader takes floats with a dot (1.0e-05): PyYAML reads 1e-05 as a string
        return (mantissa if "." in mantissa else mantissa + ".0") + ("e" + exp if exp else "")
    if isinstance(v, str):
        if any(ord(c) < 0x20 or 0x7f <= ord(c) <= 0x9f for c in v):
            raise YAMLError(f"the string {v!r} holds a control character, outside the YAML this writer gives")
        return '"' + v.replace("\\", "\\\\").replace('"', '\\"') + '"'
    raise YAMLError(f"a {type(v).__name__} is outside the YAML this writer gives")


def _dump_key(k) -> str:
    if isinstance(k, str) and _PLAIN_KEY.fullmatch(k) and k not in _BOOL and k not in _NULL \
            and not _REFUSED.fullmatch(k):
        return k
    return _dump_scalar(k)


def _dump_flow(v) -> str:
    if isinstance(v, dict):
        return "{" + ", ".join(f"{_dump_key(k)}: {_dump_flow(x)}" for k, x in v.items()) + "}"
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_dump_flow(x) for x in v) + "]"
    return _dump_scalar(v)


def dump_yaml(value, indent: int = 0) -> str:
    """``value`` as YAML that ``parse_yaml`` reads back equal: mappings as
    blocks, two spaces a level, every list and scalar inline (flow lists,
    double-quoted strings, floats with a dot).  Values outside what the
    reader gives (a float infinity, a set, an object) raise."""
    if not isinstance(value, dict):
        return " " * indent + _dump_flow(value) + "\n"
    lines = []
    for k, v in value.items():
        if isinstance(v, dict) and v:
            lines.append(" " * indent + f"{_dump_key(k)}:\n" + dump_yaml(v, indent + 2))
        else:
            lines.append(" " * indent + f"{_dump_key(k)}: {_dump_flow(v)}\n")
    return "".join(lines)


# ---------------------------------------------------------------------------
# the registry and its builders

REGISTRY: dict[str, Callable[..., Any]] = {}


def register(*targets: str):
    def deco(fn):
        for t in targets:
            REGISTRY[t] = fn
        return fn

    return deco


def instantiate_from_config(config, **extra) -> Any:
    """{'target': name, 'params': {...}} -> the registered builder's result
    with ``params`` and ``extra``; the reference's placeholder strings give
    None."""
    if "target" not in config:
        if config in ("__is_first_stage__", "__is_unconditional__"):
            return None
        raise KeyError("Expected key `target` to instantiate.")
    target = config["target"]
    if target not in REGISTRY:
        raise KeyError(f"Unknown target '{target}'. Registered: {sorted(REGISTRY)}")
    params = dict(config.get("params") or {})
    params.update(extra)
    return REGISTRY[target](**params)


DTYPE = torch.bfloat16  # the compute dtype of the towers where none is given


def _unsupported(what: str):
    raise NotImplementedError(f"{what} is not in the port's modules")


@register("ldm.modules.diffusionmodules.openaimodel.UNetModel")
def build_unet(image_size=32, in_channels=9, out_channels=4, model_channels=320, attention_resolutions=(4, 2, 1),
               num_res_blocks=2, channel_mult=(1, 2, 4, 4), num_heads=-1, num_head_channels=64,
               use_spatial_transformer=True, use_linear_in_transformer=True, transformer_depth=1,
               context_dim=1024, use_checkpoint=True, legacy=False, dtype=None, use_sep=None,
               quant=False, **kwargs) -> UNetModel:
    """The SD2 UNet, or with ``use_sep`` given (the novel-view YAML) the
    ``NVSUnetModel``; ``use_checkpoint`` is dropped, as JAX drops it, and so
    are the UNet options JAX's builder does not pass on (``conv_resample``,
    ``use_scale_shift_norm``, ``resblock_updown``: the module takes them).
    ``num_heads`` (with ``num_head_channels: -1``) and
    ``use_linear_in_transformer`` are JAX's.  ``quant`` (not a YAML key: the
    serving entry point passes it) gives JAX's default W8A8 int8 UNet, its
    fused prologues included; no JAX entry point builds an int8 novel-view
    UNet, and neither does the port."""
    del image_size, use_checkpoint, legacy, kwargs
    if not use_spatial_transformer:
        _unsupported("a UNet without spatial transformers")
    common = dict(in_channels=in_channels, model_channels=model_channels, out_channels=out_channels,
                  num_res_blocks=num_res_blocks, attention_resolutions=tuple(attention_resolutions),
                  channel_mult=tuple(channel_mult), num_head_channels=num_head_channels, num_heads=num_heads,
                  use_linear_in_transformer=use_linear_in_transformer, transformer_depth=transformer_depth,
                  context_dim=context_dim, dtype=dtype or DTYPE)
    if use_sep is not None:
        from leftrefill_torch.models.nvs import NVSUnetModel

        if quant:
            _unsupported("an int8 novel-view UNet (no JAX entry point builds one)")
        return NVSUnetModel(use_sep=bool(use_sep), **common)
    return UNetModel(quant=quant, **common)


@register("ldm.modules.diffusionmodules.multiview_unet.MultiViewUnetModel")
def build_multiview_unet(view_num=2, concat_target=False, no_rearrange_selfattn=False, **kwargs):
    from leftrefill_torch.models.multiview import MultiViewUnetModel

    base = build_unet(**kwargs)
    return MultiViewUnetModel(
        view_num=view_num, concat_target=concat_target, no_rearrange_selfattn=no_rearrange_selfattn,
        in_channels=base.in_channels, model_channels=base.model_channels, out_channels=base.out_channels,
        num_res_blocks=base.num_res_blocks, attention_resolutions=tuple(kwargs.get("attention_resolutions", (4, 2, 1))),
        channel_mult=base.channel_mult, num_head_channels=kwargs.get("num_head_channels", 64),
        num_heads=kwargs.get("num_heads", -1), use_linear_in_transformer=kwargs.get("use_linear_in_transformer", True),
        transformer_depth=kwargs.get("transformer_depth", 1), context_dim=base.context_dim, dtype=base.dtype,
        quant=kwargs.get("quant", False))


@register("ldm.models.autoencoder.AutoencoderKL")
def build_vae(embed_dim=4, ddconfig=None, lossconfig=None, monitor=None, dtype=None, **kwargs) -> AutoencoderKL:
    del lossconfig, monitor, kwargs
    dd = ddconfig or {}
    cfg = DDConfig(double_z=dd.get("double_z", True), z_channels=dd.get("z_channels", 4),
                   resolution=dd.get("resolution", 256), in_channels=dd.get("in_channels", 3),
                   out_ch=dd.get("out_ch", 3), ch=dd.get("ch", 128), ch_mult=tuple(dd.get("ch_mult", (1, 2, 4, 4))),
                   num_res_blocks=dd.get("num_res_blocks", 2), attn_resolutions=tuple(dd.get("attn_resolutions", ())))
    return AutoencoderKL(cfg, embed_dim=embed_dim, dtype=dtype or DTYPE)


@dataclasses.dataclass
class CondStageBundle:
    """The embedder module with its tokenizer, prompt tokens and init text."""

    module: PromptCLIPEmbedder
    tokenizer: SimpleTokenizer
    special_tokens: list[str]
    init_text: Optional[list[str]]
    tokenwise_init: bool = False


@register("ldm.modules.encoders.NVS_modules.NVSCLIPEmbedder")
def build_nvs_clip(freeze=True, layer="penultimate", special_tokens=("<left>", "<right>"), init_text=None,
                   tokenwise_init=False, deep_prompt=False, cross_attn_layers=16, view_prompt=False, view_num=None,
                   view_token_len=1, pos_strengthen=False, cfg_rate=0.0, bpe_path=None, dtype=None, width=1024,
                   heads=16, layers=24, vocab_size=49408, **kwargs) -> CondStageBundle:
    """The novel-view embedder.  ``view_prompt`` with ``view_num`` appends
    ``<view_direct-j-l`` (no closing '>') for each view j and position l to
    the prompt table, as JAX does (config.py:176-181): the init text is not
    extended over them, and the pose token's slot moves past them."""
    from leftrefill_torch.models.nvs import NVSCLIPEmbedder

    del freeze, cross_attn_layers, kwargs
    if deep_prompt:
        # JAX's NVSCLIPEmbedder.__call__ (nvs.py:233-267) has no deep branch:
        # it writes the pose into slot num_special_tokens + 1 of a 3-D embedding
        _unsupported("the novel-view embedder's deep prompt (JAX's NVSCLIPEmbedder has no deep-prompt forward)")
    sp, init = expand_special_tokens(list(special_tokens), init_text)
    if view_prompt and view_num is not None:
        sp = sp + [f"<view_direct-{j}-{k}" for j in range(view_num) for k in range(view_token_len)]
    module = NVSCLIPEmbedder(vocab_size=vocab_size, width=width, heads=heads, layers=layers, num_special_tokens=len(sp),
                             pos_strengthen=pos_strengthen, cfg_rate=cfg_rate, dtype=dtype or DTYPE, layer=layer)
    return CondStageBundle(module, SimpleTokenizer(bpe_path=bpe_path, special_tokens=sp), sp, init, tokenwise_init)


# the multi-view view tokens' init sentence (the reference hard-codes it)
VIEW_INIT = ("The whole image is splited into two parts with the same size, they share the same scene/landmark "
             "captured with different viewpoints and times")


@register(
    "ldm.modules.encoders.Refill_modules.PromptCLIPEmbedder",
    "ldm.modules.encoders.cyn_mod_PGIC_modules.PromptCLIPEmbedder",
    "ldm.modules.encoders.multiview_Refill_modules.PromptCLIPEmbedder",
)
def build_prompt_clip(freeze=True, layer="penultimate", special_tokens=("<left>", "<right>"), init_text=None,
                      tokenwise_init=False, deep_prompt=False, cross_attn_layers=16, view_num=None,
                      view_token_len=None, bpe_path=None, dtype=None, width=1024, heads=16, layers=24,
                      vocab_size=49408, **kwargs) -> CondStageBundle:
    """The prompt embedder; with ``view_num`` and ``view_token_len`` the
    multi-view one, whose table adds ``<view_direct-j-l`` (no closing '>',
    the reference's quirk) for each view j and position l.  ``deep_prompt``
    expands each prompt token into one per cross-attention layer
    (``<tok-layerI>``, with its init text repeated); the embedder's
    ``num_special_tokens`` is the table's rows over ``cross_attn_layers``,
    JAX's integer division (config.py:284-294).  A deep prompt with view
    tokens is refused."""
    del freeze, kwargs
    views_appended = view_num is not None and view_token_len is not None
    if deep_prompt and views_appended:
        # the view tokens are not expanded per layer, so rows // layers leaves
        # ids past the table's end (JAX's jnp.take fills NaN for them), and the
        # multi-view dataset writes no per-layer prompts
        _unsupported("the multi-view embedder's deep prompt with view tokens (its view tokens fall past the "
                     "per-layer table, and the multi-view dataset writes no per-layer prompts)")
    sp, init = expand_special_tokens(list(special_tokens), init_text, deep_prompt, cross_attn_layers)
    if views_appended:
        views = [f"<view_direct-{j}-{k}" for j in range(view_num) for k in range(view_token_len)]
        sp = sp + views
        if init is not None:
            init = init + [VIEW_INIT] * len(views)
    module = PromptCLIPEmbedder(vocab_size=vocab_size, width=width, heads=heads, layers=layers,
                                num_special_tokens=len(sp) // cross_attn_layers if deep_prompt else len(sp),
                                dtype=dtype or DTYPE, layer=layer, deep_prompt=deep_prompt,
                                cross_attn_layers=cross_attn_layers)
    return CondStageBundle(module, SimpleTokenizer(bpe_path=bpe_path, special_tokens=sp), sp, init, tokenwise_init)


@dataclasses.dataclass
class ModelBundle:
    """Everything a model YAML builds: the model, its prompt set-up and the
    YAML's settings."""

    model: LeftRefillModel
    cond_bundle: CondStageBundle
    data_config: dict
    save_prompt_only: bool
    task_target: str
    raw_config: dict
    lora_config: dict = dataclasses.field(default_factory=dict)
    refinement_config: dict = dataclasses.field(default_factory=dict)
    view_num: int = 1
    concat_target: bool = False
    reduced_loss: bool = False

    @property
    def tokenizer(self) -> SimpleTokenizer:
        return self.cond_bundle.tokenizer

    @property
    def special_tokens(self) -> list[str]:
        return self.cond_bundle.special_tokens


NVS_TARGET = "inpainting_ldm.NVS_ldm.NVSLDM"
TASK_TARGETS = ("inpainting_ldm.ref_inpainting_ldm.RefInpaintLDM",
                "inpainting_ldm.multiview_ref_inpainting_ldm.RefInpaintLDM", NVS_TARGET)


def build_model_from_config(config, dtype: Optional[torch.dtype] = None, device="cuda") -> ModelBundle:
    """The bundle of a model YAML (a path or its parsed dict), its modules
    computing in ``dtype`` (default bf16) on ``device`` without values
    (``"meta"``: shapes only).  On the card unless ``device`` says
    otherwise; without a card it raises."""
    from leftrefill_torch.models.nvs import RefinementCNN
    from leftrefill_torch.pipeline import request_device

    if isinstance(config, str):
        config = load_yaml(config)
    mc = config["model"]
    target = mc["target"]
    if target not in TASK_TARGETS:
        raise KeyError(f"Unknown task model target {target}")
    p = mc["params"]
    dev = torch.device(device) if str(device) == "meta" else request_device(device)
    refinement_config = p.get("refinement_config", {"use_input_refinement": False, "only_masked_refine": False})
    with torch.device("meta"):
        unet = instantiate_from_config(p["unet_config"], dtype=dtype)
        vae = instantiate_from_config(p["first_stage_config"], dtype=dtype)
        cond = instantiate_from_config(p["cond_stage_config"], dtype=dtype)
        refine = (RefinementCNN(unet.model_channels)
                  if target == NVS_TARGET and refinement_config.get("use_input_refinement") else None)
        model = LeftRefillModel(
            unet=unet, vae=vae, cond_model=cond.module,
            schedule=DiffusionSchedule.create(
                timesteps=p.get("timesteps", 1000), beta_schedule=p.get("beta_schedule", "linear"),
                linear_start=p.get("linear_start", 1e-4), linear_end=p.get("linear_end", 2e-2),
                parameterization=p.get("parameterization", "eps")),
            scale_factor=p.get("scale_factor", 0.18215),
            conditioning_key=p.get("conditioning_key", "hybrid"),
            refinement=refine,
        )
    if dev.type != "meta":
        model = model.to_empty(device=dev)
    return ModelBundle(
        model=model.eval(),
        cond_bundle=cond,
        data_config=p.get("data_config", {}),
        save_prompt_only=p.get("save_prompt_only", False),
        task_target=target,
        raw_config=config,
        lora_config=p.get("lora", {"do_lora": False}),
        refinement_config=refinement_config,
        view_num=p.get("view_num", 1),
        concat_target=p.get("concat_target", False),
        reduced_loss=p.get("reduced_loss", False),
    )
