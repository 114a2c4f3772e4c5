"""The readers of the program's spans and syncs (``benchmark/spans.py`` and
the six metrics on it) on synthetic gaps and spans, and in a traced run of
a CPU-size cell."""

from __future__ import annotations

import itertools
import sys
import time
import types

import pytest

from benchmark import harness, spans
from benchmark.tests import tiny

METRICS = ("entry_idle_share", "sampler_idle_share", "forward_idle_share", "backward_idle_share",
           "host_syncs_per_image", "host_syncs_per_step")


def _span(name, start, end, id, parent=None, unit=None):
    return types.SimpleNamespace(name=name, start_ns=start, end_ns=end, id=id, parent=parent,
                                 unit=id if unit is None else unit)


def _sync(unit):
    return types.SimpleNamespace(kind="h2d", nbytes=8, unit=unit)


def _request(t0: int, uid: int):
    """A request unit from t0 to t0 + 100: its own work at 0-10 and 90-100,
    the canvas 0-5, a pipeline 10-90 (inputs 10-15, text 15-20, the sampler
    20-80 with one step 25-75 holding a UNet call 30-70, decode 80-88),
    the output 92-98."""
    ids = itertools.count(uid)
    r = next(ids)
    out = [_span("request", t0, t0 + 100, r)]
    add = lambda name, a, b, parent: out.append(_span(name, t0 + a, t0 + b, next(ids), parent, r)) or out[-1].id
    add("request.canvas", 0, 5, r)
    p = add("pipeline", 10, 90, r)
    add("pipeline.inputs", 10, 15, p)
    add("text", 15, 20, p)
    s = add("sample", 20, 80, p)
    st = add("sample.step", 25, 75, s)
    add("unet", 30, 70, st)
    add("vae.decode", 80, 88, p)
    add("request.output", 92, 98, r)
    return out


class _Trace:
    def __init__(self, gaps, window_s):
        self.gaps, self.window_s = gaps, window_s


def _ctx(gaps, kind="infer", units=2, per_unit=4, window_s=1e-6):
    return {"kind": kind, "units": units, "per_unit": per_unit, "trace": _Trace(gaps, window_s)}


@pytest.fixture
def held(monkeypatch):
    """Set what ``spans.recorded`` returns."""
    box = {}
    monkeypatch.setattr(spans, "recorded", lambda: box.get("rec"))
    return box


# the midpoint of each gap, and the stage it falls in
GAPS = [((1, 3), "entry"), ((7, 9), "entry"), ((11, 13), "entry"), ((16, 18), None), ((21, 23), "sampler"),
        ((40, 50), "sampler"), ((76, 78), "sampler"), ((81, 83), None), ((88, 92), "entry"), ((93, 95), "entry"),
        ((99, 101), None), ((101, 103), None)]


def test_each_gap_goes_to_one_stage_at_most():
    sp = _request(0, 1)
    for g, want in GAPS:
        hits = [st for st in ("entry", "sampler", "forward", "backward") if spans.stage_idle_ns([g], sp, st)]
        assert hits == ([want] if want else []), (g, hits)
    total = sum(b - a for (a, b), _ in GAPS)
    parts = sum(spans.stage_idle_ns([g for g, _ in GAPS], sp, st) for st in ("entry", "sampler"))
    assert parts == sum(b - a for (a, b), w in GAPS if w) < total


def test_train_stages():
    sp = [_span("train.step", 0, 100, 1), _span("train.forward", 0, 40, 2, 1, 1), _span("unet", 10, 30, 3, 2, 1),
          _span("train.backward", 40, 80, 4, 1, 1), _span("train.optimizer", 80, 95, 5, 1, 1)]
    gaps = [(12, 14), (38, 42), (50, 60), (85, 87), (96, 98)]
    assert spans.stage_idle_ns(gaps, sp, "forward") == 2
    assert spans.stage_idle_ns(gaps, sp, "backward") == 4 + 10  # 38-42: its midpoint is the backward's start


def test_shares_sum_to_no_more_than_the_idle_share(held):
    sp = _request(0, 1) + _request(200, 100)
    gaps = [g for g, _ in GAPS] + [(200 + a, 200 + b) for (a, b), _ in GAPS] + [(150, 190)]
    held["rec"] = (sp, [])
    ctx = _ctx(gaps, window_s=300e-9)
    idle = 100.0 * sum(b - a for a, b in gaps) * 1e-9 / 300e-9
    entry, sampler = spans.idle_share(ctx, "entry"), spans.idle_share(ctx, "sampler")
    assert entry == pytest.approx(100.0 * 2 * 12 / 300) and sampler == pytest.approx(100.0 * 2 * 14 / 300)
    assert entry + sampler <= idle


def test_only_the_windows_units_are_counted(held):
    """The window's units are the first ``units`` the recorder holds: a
    later unit (the host-traced one) adds neither gaps nor syncs."""
    sp = _request(0, 1) + _request(200, 100) + _request(400, 1000)
    gaps = [(40, 50), (240, 250), (440, 450)]
    held["rec"] = (sp, [_sync(1)] * 11 + [_sync(100)] * 11 + [_sync(1000)] * 11 + [_sync(None)] * 3)
    ctx = _ctx(gaps, units=2, per_unit=4, window_s=1e-6)
    assert spans.idle_share(ctx, "sampler") == pytest.approx(100.0 * 20e-9 / 1e-6)
    assert spans.syncs_per_unit(ctx) == 11.0
    reader = harness.Cell(tiny.spec(), "ref1_bf16.predict_n4").metric_reader("host_syncs_per_image.infer")
    assert reader("host_syncs_per_image.infer", ctx) == 2.75
    assert spans.window_units(sp, 3) == {1, 100, 1000} and spans.window_units(sp, 4) is None


@pytest.mark.parametrize("rec", [None, ([], [])])
def test_readers_return_none_without_spans(held, rec):
    held["rec"] = rec
    cell = harness.Cell(tiny.spec(), "ref1_bf16.predict_n4")
    train = harness.Cell(tiny.spec(), "ref1_bf16.train_b8")
    for m in METRICS:
        kind = "train" if m in ("forward_idle_share", "backward_idle_share", "host_syncs_per_step") else "infer"
        name = f"{m}.{kind}"
        reader = (train if kind == "train" else cell).metric_reader(name)
        assert reader(name, _ctx([(1, 2)], kind=kind)) is None


def test_no_recorder_reads_none(monkeypatch):
    """A program without ``leftrefill_torch.trace`` (its parent commit)."""
    import leftrefill_torch

    monkeypatch.delattr(leftrefill_torch, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "leftrefill_torch.trace", None)
    assert spans.recorded() is None
    assert spans.idle_share(_ctx([(1, 2)]), "entry") is None and spans.syncs_per_unit(_ctx([])) is None


def test_dropped_records_read_none(monkeypatch):
    from leftrefill_torch import trace

    monkeypatch.setattr(trace, "dropped", lambda: 1)
    assert spans.recorded() is None


@pytest.mark.parametrize("cell, names", [
    ("t.predict", {"entry_idle_share.infer", "sampler_idle_share.infer", "host_syncs_per_image.infer"}),
    ("t.train", {"forward_idle_share.train", "backward_idle_share.train", "host_syncs_per_step.train"}),
])
def test_traced_cpu_run_reports_the_new_metrics(tmp_path, cell, names):
    """A traced run of a CPU-size cell: every new metric reads a number (no
    device, so no gap and no crossing: 0)."""
    base, s = tiny.tiny_copy(tmp_path)
    out = harness.run(harness.Cell(s, cell, base), 2**31 + 777, 0.05, True, "cpu", time.time())
    assert out["correct"], out["checked"]
    assert names <= set(out["metrics"])
    assert all(out["metrics"][n]["value"] == 0.0 for n in names)
