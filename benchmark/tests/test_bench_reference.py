"""The plain reference against the program's modules at a small size on
the CPU (the reference itself imports nothing of the program), its keys
against the program's state dict at full width, and its tokens against the
program's tokenizer."""

from __future__ import annotations

import ast
import json

import pytest
import torch

from benchmark import inputs, port
from benchmark.reference import pipelines, sd2
from benchmark.tests import tiny

REF = tiny.BENCH / "reference"


def _cfg(name):
    return json.loads((tiny.HERE / "data" / f"{name}.json").read_text())


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def test_reference_imports_nothing_of_the_program_or_jax():
    for path in REF.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] if isinstance(node, ast.Import) else [node.module or ""]
                assert not any(n.split(".")[0] in ("leftrefill_torch", "leftrefill_tpu", "jax", "jaxlib", "flax")
                               for n in names), (path.name, names)


@pytest.mark.parametrize("name", ["sd2inp_ref1_bf16", "sd2inp_mv4_bf16"])
def test_keys_and_shapes_are_the_programs_at_full_width(name):
    cfg = json.loads((tiny.BENCH / "configs" / f"{name}.json").read_text())
    shapes = sd2.param_shapes(cfg)
    sd = port.build_model(cfg, {k: torch.empty(s, device="meta") for k, s in shapes.items()}, "meta").state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == shapes
    tok, sp, view_prompts = port.tokenizer(cfg)
    assert sp == pipelines.special_tokens(cfg)
    texts = view_prompts or [" ".join(sp)]
    assert (tok.tokenize(texts + [""]) == pipelines.tokenize(pipelines.prompts(cfg) + [""], sp)).all()


@pytest.mark.parametrize("name, views", [("tiny_ref1", 1), ("tiny_mv2", 2)])
def test_modules_match_the_program(name, views):
    cfg = _cfg(name)
    w = inputs.draw_weights(sd2.param_shapes(cfg), 3, "cpu")
    model = port.build_model(cfg, w, "cpu")
    p = sd2.Params(w, sd2.Arith())
    g = torch.Generator().manual_seed(0)
    b = 2 * views
    x = torch.randn((b, 16, 32, 9), generator=g)
    t = torch.tensor([981, 21] * views)
    ctx = torch.randn((b, 77, cfg["text"]["width"]), generator=g)
    with torch.no_grad():
        got = model.unet(x, t, ctx)
        want = sd2.unet(p, cfg, x.permute(0, 3, 1, 2), t, ctx, views=views).permute(0, 2, 3, 1)
        assert _rel(got, want) < 1e-5
        if views == 1:  # the shared CFG prefix gives the same eps
            x2, t2 = x[:1].repeat(2, 1, 1, 1), t[:1].repeat(2)
            plain = sd2.unet(p, cfg, x2.permute(0, 3, 1, 2), t2, ctx)
            assert _rel(sd2.unet(p, cfg, x2.permute(0, 3, 1, 2), t2, ctx, cfg_dup=True), plain) < 1e-5
        img = torch.rand((2, 32, 64, 3), generator=g) * 2 - 1
        noise = torch.randn((2, 16, 32, 4), generator=g)
        z = model.encode_first_stage(img, noise)
        assert _rel(z, sd2.vae_encode(p, cfg, img.permute(0, 3, 1, 2), noise.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)) < 1e-5
        assert _rel(model.decode_first_stage(z), sd2.vae_decode(p, cfg, z.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)) < 1e-5
        tok = torch.from_numpy(pipelines.tokenize(pipelines.prompts(cfg) + [""], pipelines.special_tokens(cfg)))
        assert _rel(model.get_learned_conditioning(tok), sd2.text_encode(p, cfg, tok)) < 1e-5


def test_control_rounds_to_fp8():
    x = torch.linspace(-3, 3, 1001)
    q = sd2.Arith(fp8=True).act(x)
    # E4M3 keeps 3 mantissa bits: half a step is 1/16 of the value, or a
    # subnormal step (2^-9 of the scale 3 / 448) near zero
    assert bool(((q - x).abs() <= x.abs() / 16 + 3 / 448 * 2**-10).all()) and len(q.unique()) < 256
    assert float((q - x).abs().max()) > 0
    assert sd2.Arith().act(x) is x


def test_schedule_is_sd2s():
    tab = pipelines.schedule(_cfg("tiny_ref1"), 50, 1.0)
    assert list(tab["t"][:2]) == [981, 961] and tab["t"][-1] == 1
    # alphas_cumprod at t = 981 and the last step's eta-1 sigma (t 21 -> 1) of SD2's linear schedule
    assert tab["a"][0] == pytest.approx(0.0057755, rel=1e-4) and tab["sigma"][-1] == pytest.approx(0.0206484, rel=1e-4)
