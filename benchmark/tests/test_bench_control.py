"""The check's control, at each cell's own size on the card: the plain
reference computed with fp8 (E4M3) operands, the precision below the
configuration's bf16, put in the program's place, must come out as not
correct on every seed.  Run on the card with

    python -m pytest benchmark/tests/test_bench_control.py -m card -s

(each seed prints the numbers compared and their limits)."""

from __future__ import annotations

import json
import time

import pytest

from benchmark import harness
from benchmark.tests import tiny

SEEDS = (4100000001, 4100000003, 4100000005)


@pytest.mark.card
@pytest.mark.parametrize("workload", [w["name"] for w in tiny.spec()["workloads"]])
def test_control_is_not_correct(card, workload):
    cell = harness.Cell(tiny.spec(), workload)
    for seed in SEEDS:
        out = harness.run(cell, seed, 0.0, False, card, time.time(), control=True)
        print(workload, seed, json.dumps(out["checked"]), flush=True)
        assert not out["correct"], (seed, out["checked"])
