"""The port's real-weights runbook (``leftrefill_torch.tools.runbook``) on
the CPU with its tiny synthetic stand-ins, and the YAML writer it writes its
experiment's config with (``config.dump_yaml``):

- ``--synthetic`` passes its five stages (tokenizer, convert, parity, eval,
  ab) and exits 0 (the convert stage's key accounting against JAX's, and a
  broken checkpoint's exit 1, in ``test_torch_runbook_convert.py``);
- the tokenizer's ids on the stand-in merges equal JAX's ``SimpleTokenizer``'s;
- the eval stage's PSNR and SSIM equal JAX's ``cli/test.py`` on the same
  pairs and checkpoint, in fp32, with JAX's sampling draws fed to the port
  (``test_torch_tasks._draws``): 1e-4 relative on PSNR, 1e-4 absolute on
  SSIM (fp32 canvases within 1e-4 of each other, as the tasks' tests hold
  them).  LPIPS is not compared: without AlexNet weights each side draws
  its convs from its own generator.
"""

from __future__ import annotations

import functools
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from test_torch_tasks import _draws

from leftrefill_torch.config import dump_yaml, load_yaml, parse_yaml
from leftrefill_torch.tools import runbook

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _report(out) -> dict:
    with open(os.path.join(out, "report.json")) as f:
        return json.load(f)


def _metrics(path) -> dict:
    with open(path) as f:
        return {k: float(v) for k, v in (line.strip().split(":") for line in f)}


def test_synthetic_dry_run_passes_every_stage_and_its_eval_matches_jax(tmp_path, monkeypatch):
    from leftrefill_tpu import config as jconfig
    from leftrefill_tpu.cli import test as jtest

    from leftrefill_torch.tasks import RefInpaintTask

    torch.set_num_threads(2)
    log_images = RefInpaintTask.log_images

    def with_jax_draws(self, batch, generator=None, ddim_steps=50, **kw):
        key = jax.random.PRNGKey(generator.initial_seed())  # JAX's cli/test.py: PRNGKey(seed + batch index)
        return log_images(self, batch, generator=generator, ddim_steps=ddim_steps, **kw,
                          **_draws(batch["image"].shape[0], key, steps=ddim_steps))

    monkeypatch.setattr(RefInpaintTask, "log_images", with_jax_draws)
    out = str(tmp_path / "rb")
    assert runbook.main(["--synthetic", "--out", out, "--limit", "2", "--device", "cpu"]) == 0
    report = _report(out)
    assert list(report) == list(runbook.STAGES)
    for stage, r in report.items():
        assert r["ok"], (stage, r)
    assert report["convert"]["skipped_other"] == 2 and report["convert"]["missing"] == 0
    assert report["parity"]["against"].startswith("fp32")
    ours = _metrics(report["eval"]["metric_files"][0])
    assert set(ours) == {"PSNR", "SSIM", "LPIPS"} and report["eval"]["ddim_steps"] == 4
    ab = report["ab"]
    assert ab["pairs"] == 2 and all(np.isfinite(ab[f"cross_psnr_bf16_vs_{o}_db"]) for o in ("int8", "int8+vae8"))

    # JAX's evaluation CLI on the runbook's experiment directory, pairs and checkpoint, in fp32
    monkeypatch.setattr(jconfig, "build_model_from_config",
                        functools.partial(jconfig.build_model_from_config, dtype=jnp.float32))
    syn = os.path.join(out, "synthetic")
    mdir = str(tmp_path / "jax_metrics")
    assert jtest.main(["--model_path", os.path.join(out, "exp"), "--test_path", os.path.join(syn, "testpairs"),
                       "--sd_ckpt", os.path.join(syn, "sd_stand_in.ckpt"), "--test_size", "32", "--metric_size", "32",
                       "--output_path", str(tmp_path / "jax_eval"), "--metric_output", mdir, "--limit", "2",
                       "--ddim_steps", "4"]) == 0
    ref = _metrics(os.path.join(mdir, "exp_32.txt"))
    assert ours["PSNR"] == pytest.approx(ref["PSNR"], rel=1e-4), (ours, ref)
    assert ours["SSIM"] == pytest.approx(ref["SSIM"], abs=1e-4), (ours, ref)


def test_tokenizer_ids_match_jax_on_the_stand_in_merges(tmp_path):
    from leftrefill_tpu.models.tokenizer import SimpleTokenizer as JTok

    from leftrefill_torch.models.tokenizer import SimpleTokenizer

    merges = runbook.build_synthetic(str(tmp_path))["bpe_merges"]
    sp = ["<special-token0>"]
    ours, ref = SimpleTokenizer(bpe_path=merges, special_tokens=sp), JTok(bpe_path=merges, special_tokens=sp)
    for text in ("a photo of a cat", "hello", "hell o world <special-token0>", "two views of one scene", ""):
        assert np.array_equal(np.asarray(ours.tokenize(text)), np.asarray(ref.tokenize(text))), text
    report = {}
    args = runbook.parse_args(["--bpe_merges", merges])
    assert runbook.stage_tokenizer(args, report, {})
    assert report["tokenizer"]["ids"] == [int(v) for v in np.asarray(ref.tokenize("a photo of a cat"))[0][:7]]
    assert report["tokenizer"]["merges"] == 5


@pytest.mark.parametrize("name", sorted(os.path.basename(p) for p in glob.glob(os.path.join(REPO, "configs", "*.yaml"))))
def test_dump_yaml_round_trips_every_shipped_config(name):
    """``parse_yaml`` (and PyYAML's ``safe_load``) read back every shipped
    config after ``dump_yaml`` equal to the parsed original."""
    cfg = load_yaml(os.path.join(REPO, "configs", name))
    text = dump_yaml(cfg)
    assert parse_yaml(text) == cfg
    assert yaml.safe_load(text) == cfg


def test_dump_yaml_writes_what_the_reader_reads_back():
    """Values a config may carry beyond the shipped ones: floats without a
    dot in repr (1e-05 reads as a string in YAML), keys and strings YAML
    would read as booleans or null, quotes, backslashes, non-ASCII text,
    empty collections, mappings inside lists; a value outside the YAML the
    writer gives (a float infinity, a set, a control character) raises."""
    from leftrefill_torch.config import YAMLError

    odd = {"a": 1e-05, "b": [1.5, -2.0, 3e20, None, True, "x: y", "it's \"q\" \\ ", {"k": []}], "yes": "no",
           "1": 1, "e": {}, "f": "null", "g": "", "h": "a \\n b", "u": "é", "nested": {"deep": {"x": [[1, 2], []]}}}
    text = dump_yaml(odd)
    assert parse_yaml(text) == odd and yaml.safe_load(text) == odd
    for bad in ({"x": float("inf")}, {"x": {1, 2}}, {"x": "a\nb"}, {"x": ["tab\t"]}, {"x": "\x01"}):
        with pytest.raises(YAMLError):
            dump_yaml(bad)
