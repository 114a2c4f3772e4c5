"""The harness: its files found by name, the import guard, the spec's
shape, and whole runs of CPU-size cells, sound and with the timed path
broken (each fault the cell can have must read as not correct)."""

from __future__ import annotations

import json
import re
import time

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.drivers import predict, train
from benchmark.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_spec_keys_names_and_files():
    s = tiny.spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert s["paths"] == ["benchmark"] and s["command"] == ["python3", "benchmark/run.py"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in s[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (tiny.BENCH.parent / c["file"]).exists()
    for w in s["workloads"]:
        cell = harness.Cell(s, w["name"])
        assert "setup_s" in {m["name"] for m in cell.end_to_end} and len(cell.end_to_end) >= 2
        assert cell.per_layer and all(cell.metric_reader(m["name"]) for m in cell.per_layer)
        assert (tiny.BENCH / "checks" / f"{w['name']}.json").exists()
    e2e = {m["name"] for m in s["end_to_end"]}
    assert all(m["moves"] in e2e for m in s["per_layer"])


def test_finds_a_new_cell_config_traffic_and_metric_by_name(tmp_path):
    base, s = tiny.tiny_copy(tmp_path)
    (base / "configs" / "new_cfg.json").write_text((base / "configs" / "tiny_ref1.json").read_text())
    (base / "traffic" / "new_mix.json").write_text(json.dumps({**tiny.TRAFFIC["t_predict"], "num_samples": 3}))
    (base / "checks" / "new.cell.json").write_text(json.dumps({"hole_rms": 1.0, "outside_changed": 0}))
    (base / "metrics" / "new_metric.py").write_text("def read(name, ctx):\n    return 42.0\n")
    s["configs"].append({"name": "new_cfg"})
    s["workloads"].append({"name": "new.cell", "config": "new_cfg", "traffic": "new_mix", "chips": 1})
    s["end_to_end"][0]["workloads"].append("new.cell")
    s["per_layer"].append({"name": "new_metric.infer", "unit": "%", "better": "higher", "source": "device_trace",
                           "layer": "Device", "moves": "images_per_s", "workloads": ["new.cell"]})
    cell = harness.Cell(s, "new.cell", base)
    assert cell.traffic["num_samples"] == 3 and cell.cfg["name"] == "tiny_ref1"
    assert cell.limits == {"hole_rms": 1.0, "outside_changed": 0}
    assert [m["name"] for m in cell.per_layer] == ["new_metric.infer"]
    assert cell.metric_reader("new_metric.infer")("new_metric.infer", {}) == 42.0
    assert cell.metric_reader("idle_share.train").__module__.endswith("idle_share")
    assert cell.driver().RATE == "images_per_s"


@pytest.mark.parametrize("names, found", [
    (["jax"], ["jax"]), (["jax.numpy"], ["jax"]), (["jaxlib.xla_client"], ["jaxlib"]), (["flax.linen"], ["flax"]),
    (["leftrefill_tpu", "leftrefill_tpu.ops"], ["leftrefill_tpu"]),
    (["leftrefill_torch", "leftrefill_torch.ops"], []), (["jaxtyping", "flaxen", "leftrefill_tpu_x"], []),
])
def test_import_guard_compares_whole_top_level_names(names, found):
    assert harness.banned_modules(names + ["torch", "numpy"]) == found


def _run(base, s, cell, **kw):
    return harness.run(harness.Cell(s, cell, base), 2**31 + 12345, 0.05, kw.pop("trace", False), "cpu",
                       time.time(), **kw)


def _plant(monkeypatch, driver, fault):
    """Break the timed path under the driver class ``driver`` with ``fault``."""
    if fault == "altered":  # an answer altered where it is produced (training: its gradient doubled)
        if driver is train.Driver:
            _wrap_optimizer(monkeypatch, "setup", lambda drv, apply: (drv.table.grad.mul_(2.0), apply())[1])
            return
        unit = driver.unit

        def altered(drv, i):  # the first image's hole painted over
            unit(drv, i)
            if i < 0:
                return
            out = drv.outputs[i]
            if driver is predict.Driver:
                out[0] = np.where(drv._req(i)["mask"][..., None] > 0, np.uint8(128), out[0])
            else:
                out = drv.outputs[i] = out.clone()
                out[:, 0] = torch.where(drv._call(i)["masks"][:, 0] > 0.5, torch.zeros_like(out[:, 0]), out[:, 0])

        monkeypatch.setattr(driver, "unit", altered)
    elif fault == "half_batch":  # half of the batch left out, the mean over the rest
        step = train.Driver._step
        monkeypatch.setattr(train.Driver, "_step",
                            lambda drv, batch: step(drv, {k: v[: v.shape[0] // 2] for k, v in batch.items()}))
    elif fault in ("frozen", "frozen_window"):  # a step that returns its state unchanged, from set-up or the window
        _wrap_optimizer(monkeypatch, "setup" if fault == "frozen" else "warm",
                        lambda drv, apply: drv.tx.adamw.zero_grad(set_to_none=True))
    else:
        raise ValueError(fault)


def _wrap_optimizer(monkeypatch, after: str, broken):
    """Replace the train driver's optimizer step with ``broken(drv, apply)``
    once ``Driver.<after>`` has run."""
    original = getattr(train.Driver, after)

    def then(drv, *a):
        original(drv, *a)
        if getattr(drv, "tx", None) is not None:
            apply = drv.tx.step
            drv.tx.step = lambda: broken(drv, apply)

    monkeypatch.setattr(train.Driver, after, then)


@pytest.mark.parametrize("cell, fault", [
    ("t.predict", None), ("t.predict", "altered"), ("t.train", None), ("t.train", "frozen"),
    ("t.train", "frozen_window"), ("t.train", "half_batch"), ("t.train", "altered"), ("t.scene", None),
    ("t.scene", "altered"),
])
def test_cell_runs_sound_and_each_fault_fails(tmp_path, monkeypatch, cell, fault):
    base, s = tiny.tiny_copy(tmp_path)
    c = harness.Cell(s, cell, base)
    if fault is None:
        out = _run(base, s, cell)
        assert out["correct"], out["checked"]
        assert list(out)[-1] == "checked" and out["attempted"] >= 1
        assert set(out["metrics"]) == {m["name"] for m in c.end_to_end}
    else:
        _plant(monkeypatch, c.driver().Driver, fault)
        bad = _run(base, s, cell)
        assert not bad["correct"], (fault, bad["checked"])


@pytest.mark.parametrize("cell", ["t.predict", "t.scene"])
def test_traced_run_reports_per_layer_metrics_and_breakdown(tmp_path, cell):
    base, s = tiny.tiny_copy(tmp_path)
    out = _run(base, s, cell, trace=True)
    assert out["correct"], out["checked"]
    assert {"busy_s", "window_s"} <= set(out["device"]) and "breakdown" in out
    assert "mfu.infer" in out["metrics"] and "launches_per_image.infer" in out["metrics"]


def test_control_reads_far_above_the_sound_run(tmp_path):
    base, s = tiny.tiny_copy(tmp_path)
    sound = _run(base, s, "t.predict")["checked"]["hole_rms"]["value"]
    control = _run(base, s, "t.predict", control=True)["checked"]["hole_rms"]["value"]
    assert control > 100 * max(sound, 1e-3)
