"""The runbook's convert stage (``leftrefill_torch.tools.runbook``) on the
CPU with its tiny synthetic stand-ins: the stand-in checkpoint's key
accounting equals the JAX package's (``convert/torch_to_flax.convert_state_dict``
+ ``merge_params`` over the JAX bundle of the same YAML: the same skipped
keys, the same missing parameters, as many unexpected entries), and a
checkpoint with one key renamed fails the stage and the runbook exits 1.
The stage's limit of 5 skipped keys counts those outside the schedule's
buffers and the EMA copy (the JAX runbook counts them all)."""

from __future__ import annotations

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leftrefill_torch.config import parse_yaml
from leftrefill_torch.convert.from_jax import state_dict_from_flax
from leftrefill_torch.tools import runbook


def _report(out) -> dict:
    with open(os.path.join(out, "report.json")) as f:
        return json.load(f)


def test_key_accounting_matches_jax_and_a_renamed_key_fails(tmp_path):
    """The stand-in checkpoint through the port's convert stage and through
    JAX's converter and merge: equal accounting; then one UNet key renamed
    (to a block index the UNet lacks): the convert stage fails with one
    missing and one unexpected key, as JAX counts them, and the runbook
    exits 1."""
    from leftrefill_tpu.config import build_model_from_config as jbuild
    from leftrefill_tpu.convert.torch_to_flax import convert_state_dict, load_torch_state_dict, merge_params
    from leftrefill_tpu.tasks import build_task as jtask

    torch.set_num_threads(2)
    out = str(tmp_path / "rb")
    paths = runbook.build_synthetic(out)
    jt = jtask(jbuild(parse_yaml(runbook.SYN_YAML), dtype=jnp.float32))
    base = jt.init_params(jax.random.PRNGKey(0), latent_hw=(4, 8))

    def jax_accounting(ckpt):
        loaded, skipped = convert_state_dict(load_torch_state_dict(ckpt))
        _, missing, unexpected = merge_params(base, loaded)
        return skipped, missing, unexpected

    def torch_keys(flax_paths):
        """JAX's missing paths ("/unet/out_2/kernel") as checkpoint keys."""
        tree = {}
        for p in flax_paths:
            node, (*mods, leaf) = tree, p.strip("/").split("/")
            for m in mods:
                node = node.setdefault(m, {})
            ref = functools.reduce(lambda n, k: n[k], p.strip("/").split("/"), base)
            node[leaf] = np.asarray(ref)
        return sorted(state_dict_from_flax(tree))

    skipped, missing, unexpected = jax_accounting(paths["sd_ckpt"])
    base_args = ["--out", out, "--limit", "2", "--device", "cpu", "--skip", "eval,ab",
                 *(x for k in ("sd_ckpt", "bpe_merges", "lpips_weights", "model_config", "test_path")
                   for x in (f"--{k}", paths[k])), "--test_size", "32"]
    assert runbook.main(base_args) == 0
    conv = _report(out)["convert"]
    stand_in = (*runbook.SCHEDULE_BUFFERS, *runbook.EMA_KEYS, *runbook.SKIPPED_EXTRA)
    assert conv["ok"] and sorted(conv["skipped_keys"]) == sorted(skipped) == sorted(stand_in)
    assert conv["skipped_recomputed"] == len(runbook.SCHEDULE_BUFFERS) + len(runbook.EMA_KEYS)
    assert conv["skipped_other"] == len(runbook.SKIPPED_EXTRA)
    assert missing == ["/cond/special_embeddings"] and torch_keys(missing) == ["cond_stage_model.special_embeddings.weight"]
    assert conv["missing"] == conv["unexpected"] == conv["shape_mismatch"] == 0 and not unexpected

    sd = torch.load(paths["sd_ckpt"], weights_only=False)["state_dict"]
    sd["model.diffusion_model.out.3.weight"] = sd.pop("model.diffusion_model.out.2.weight")
    broken = str(tmp_path / "broken.ckpt")
    torch.save({"state_dict": sd}, broken)
    skipped, missing, unexpected = jax_accounting(broken)
    assert runbook.main([*base_args, "--sd_ckpt", broken]) == 1
    report = _report(out)
    conv = report["convert"]
    assert not conv["ok"] and report["tokenizer"]["ok"] and report["parity"]["ok"]
    assert conv["missing_keys"] == ["model.diffusion_model.out.2.weight"]
    assert torch_keys([m for m in missing if "special_embeddings" not in m]) == conv["missing_keys"]
    assert conv["unexpected_keys"] == ["model.diffusion_model.out.3.weight"] and unexpected == ["/unet/out_3"]
    assert conv["skipped"] == len(skipped)


@pytest.mark.parametrize("other, ok", [(4, True), (5, False)])
def test_convert_limit_counts_skips_outside_the_schedule_and_ema(other, ok):
    """A real LatentDiffusion checkpoint's 12 schedule buffers and its EMA
    copy pass; the 5th skipped key of another kind fails."""
    loaded = {"skipped": [*runbook.SCHEDULE_BUFFERS, *runbook.EMA_KEYS, *(f"unknown.{i}" for i in range(other))],
              "missing": ["cond_stage_model.special_embeddings.weight"], "shape_mismatch": [], "unexpected": []}
    v = runbook.convert_verdict(loaded)
    assert v["ok"] is ok and v["skipped_other"] == other and v["missing"] == 0
    assert v["skipped_recomputed"] == len(runbook.SCHEDULE_BUFFERS) + len(runbook.EMA_KEYS)
