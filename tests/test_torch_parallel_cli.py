"""The port's training CLI over 2 gloo CPU ranks (``--device cpu --nchip
2``, each rank started as torchrun would start it, by
``tools.dryrun.run_ranks``) on the tiny MegaDepth tree and the 1-reference
YAMLs of ``tests/test_torch_cli_megadepth.py`` (batch 2 a rank, 2 steps,
one validation batch), and ``tools.dryrun.dryrun_multichip``:

- the global first batch (the two ranks' rows put together) bit-equal to
  the one JAX's CLI hands its step at ``--nchip 2`` (a per-host batch of
  batch_size x 2 devices), both loaders on one worker;
- the ranks' prompt tables bit-equal after each step, and moved;
- only rank 0 writing checkpoints and sample grids, its last checkpoint
  holding the table the ranks ended with;
- ``--nchip 2`` without torchrun's process group, and ``--nchip`` other
  than the world size, raising;
- ``dryrun_multichip(2)`` for the ``ref`` and ``cfgpar`` families in a
  time-limited subprocess.

The CLI's step draws t and the noise from torch's generator, not JAX's
key, so its table after a step is not JAX's; the step's equality with
JAX's mesh step on JAX's draws is ``tests/test_torch_parallel_train.py``'s."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from test_torch_cli_megadepth import _args, _first_batch, workdir  # noqa: F401 (the fixture)

from leftrefill_torch.tools.dryrun import REPO, run_ranks

HERE = __file__.rsplit("/", 1)[0]
TABLE = "cond_stage_model.special_embeddings.weight"


def test_cli_over_two_ranks(workdir, monkeypatch, tmp_path):  # noqa: F811
    from leftrefill_tpu.cli import train as jcli
    from leftrefill_tpu.data import loader as jloader
    from leftrefill_tpu.train import trainer as jtrainer

    argv = _args(workdir, "ref", "--device", "cpu", "--no_restore", "--nchip", "2")
    argv[argv.index("--exp_name") + 1] = "ref_dp"
    outs = run_ranks("torch_parallel_ranks:cli_body", 2, str(tmp_path), {"argv": argv, "table_key": TABLE},
                     timeout=240, pythonpath=(HERE,))
    got = {k[len("batch/"):]: np.concatenate([o[k] for o in outs]) for k in outs[0] if k.startswith("batch/")}
    np.random.seed(0)  # the data config's seed: the match masks' numpy draws (the port's RandomState(0))
    jargs = _args(workdir, "ref", "--no_restore", "--nchip", "2")
    jargs[jargs.index("--exp_name") + 1] = "ref_dp_jax"
    ref, _ = _first_batch(monkeypatch, jloader, jtrainer, lambda: jcli.main(jargs))
    assert set(got) == set(ref) and ref["image"].shape == (4, 32, 64, 3)
    for k in ref:
        assert np.array_equal(got[k], ref[k]), k
    steps = sorted(k for k in outs[0] if k.startswith("table"))
    assert steps == ["table0", "table1"]
    for k in steps:
        assert np.array_equal(outs[0][k], outs[1][k]), k
    assert not np.array_equal(outs[0]["table0"], outs[0]["table1"])
    assert (int(outs[0]["saves"]), int(outs[1]["saves"])) == (1, 0)
    assert int(outs[0]["grids"]) == 2 and int(outs[1]["grids"]) == 0
    saved = torch.load(os.path.join(workdir, "ck", "ref_dp", "ckpts", "last.pt"), weights_only=True)
    assert np.array_equal(saved[TABLE].numpy(), outs[0]["table1"])


def test_cli_refuses_a_rank_count_it_cannot_start(workdir, monkeypatch):  # noqa: F811
    from leftrefill_torch.cli.train import main

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        main(_args(workdir, "ref", "--device", "cpu", "--no_restore", "--nchip", "2"))
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="the run has 2 ranks"):
        main(_args(workdir, "ref", "--device", "cpu", "--no_restore", "--nchip", "3"))


@pytest.mark.parametrize("family", ["ref", "cfgpar"])
def test_dryrun_multichip_two_ranks(family):
    res = subprocess.run([sys.executable, "-m", "leftrefill_torch.tools.dryrun", "2", family], cwd=REPO,
                         capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    assert f"dryrun_multichip(2): ok ({family})" in res.stdout
