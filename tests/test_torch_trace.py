"""The program's spans and host-sync counter (``leftrefill_torch.trace``) on
tiny CPU bundles: nothing recorded without a profiler, the nesting of a
1-reference request, a multi-view call and a train step under a CPU
profiler, the spans on the profiler's clock, and the blocking copies each
unit makes, counted with the card test patched to take the CPU for the
card."""

from __future__ import annotations

import json
import statistics
import threading
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from leftrefill_torch import trace

TINY_UNET = dict(in_channels=9, model_channels=16, out_channels=4, num_res_blocks=1,
                 attention_resolutions=(1,), channel_mult=(1, 2), num_head_channels=8, context_dim=24)
TINY_VAE = dict(z_channels=4, resolution=64, ch=16, ch_mult=(1, 2), num_res_blocks=1)
TINY_CLIP = dict(vocab_size=49408, width=24, heads=2, layers=2)
STEPS = 2


def _model(unet, n_special: int):
    from leftrefill_torch.diffusion.core import LeftRefillModel
    from leftrefill_torch.models.autoencoder import AutoencoderKL, DDConfig
    from leftrefill_torch.models.clip import PromptCLIPEmbedder
    from leftrefill_torch.pipeline import fill_random_, sd2_schedule

    model = LeftRefillModel(unet, AutoencoderKL(DDConfig(**TINY_VAE), embed_dim=4),
                            PromptCLIPEmbedder(**TINY_CLIP, num_special_tokens=n_special), sd2_schedule())
    fill_random_(model, torch.Generator().manual_seed(0))
    return model.eval()


@pytest.fixture(scope="module")
def ref_pipe():
    from leftrefill_torch.models.clip import build_prompt_tokenizer
    from leftrefill_torch.models.unet import UNetModel
    from leftrefill_torch.pipeline import RefInpaintPipeline

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tok, sp, _ = build_prompt_tokenizer([f"<special-token{i}>" for i in range(4)])
    return RefInpaintPipeline(model=_model(UNetModel(**TINY_UNET), len(sp)), tokenizer=tok, special_tokens=sp,
                              device="cpu", ddim_steps=STEPS)


@pytest.fixture(scope="module")
def mv_pipe():
    from leftrefill_torch.models.clip import build_multiview_prompt_tokenizer
    from leftrefill_torch.models.multiview import MultiViewUnetModel
    from leftrefill_torch.pipeline import MultiViewInpaintPipeline

    tok, sp, prompts = build_multiview_prompt_tokenizer(2)
    return MultiViewInpaintPipeline(model=_model(MultiViewUnetModel(view_num=2, **TINY_UNET), len(sp)),
                                    tokenizer=tok, view_prompts=prompts, device="cpu", ddim_steps=STEPS)


def _request(pipe):
    from leftrefill_torch.serving.gradio_app import predict

    rng = np.random.RandomState(1)
    ref, src = (rng.randint(0, 256, (64, 64, 3), dtype=np.uint8) for _ in range(2))
    mask = np.zeros((64, 64), np.uint8)
    mask[16:48, 20:40] = 255
    return predict(pipe, ref, src, mask, ddim_steps=STEPS, num_samples=1, scale=2.5, seed=3, img_size=64)


def _scene(pipe):
    g = torch.Generator().manual_seed(2)
    images = torch.rand((1, 2, 32, 32, 3), generator=g) * 2 - 1
    masks = torch.zeros((1, 2, 32, 32, 1))
    masks[0, 0, 8:24, 8:24] = 1.0
    return pipe(images, masks, generator=torch.Generator().manual_seed(4))


def _train_step(pipe):
    from leftrefill_torch.train import create_train_state, make_train_step

    model = pipe.model
    state, tx = create_train_state(model)
    step = make_train_step(model, tx)
    g = torch.Generator().manual_seed(5)
    image = torch.rand((2, 32, 64, 3), generator=g) * 2 - 1
    mask = torch.zeros((2, 32, 64, 1))
    mask[:, :, 32:] = 1.0
    batch = {"image": image, "mask": mask, "masked_image": image * (mask < 0.5),
             "tokens": torch.as_tensor(pipe.prompt_tokens(2), dtype=torch.long)}
    try:
        return step(state, batch, torch.Generator().manual_seed(6))
    finally:
        for p in model.parameters():
            p.requires_grad_(False)


def _recorded(fn, *args):
    """``fn(*args)`` under a CPU profiler: (its spans, its syncs)."""
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        fn(*args)
    return trace.spans(), trace.syncs()


def _tree(spans) -> list:
    """The spans as nested (name, [children]) lists in the order they
    started."""
    kids = {}
    for s in sorted(spans, key=lambda s: s.start_ns):
        kids.setdefault(s.parent, []).append(s)

    def node(s):
        return (s.name, [node(c) for c in kids.get(s.id, [])])

    return [node(s) for s in kids.get(None, [])]


def _pipeline_tree(steps: int) -> tuple:
    return ("pipeline", [("pipeline.inputs", []), ("vae.encode", []), ("text", []), ("text", []),
                         ("cross_kv", []), ("sample", [("sample.step", [("unet", [])])] * steps),
                         ("vae.decode", [])])


def test_nothing_is_recorded_without_a_profiler(ref_pipe):
    """No profiler: a whole request records no span and no sync, and
    ``span`` hands out the one shared no-op."""
    trace.clear()
    assert not trace.recording()
    _request(ref_pipe)
    assert trace.spans() == [] and trace.syncs() == [] and trace.dropped() == 0
    assert trace.span("request") is trace.NOOP and trace.span("sample.step", i=3) is trace.NOOP


def test_request_nests_as_the_stages(ref_pipe):
    spans, _ = _recorded(_request, ref_pipe)
    assert _tree(spans) == [("request", [("request.canvas", []), _pipeline_tree(STEPS), ("request.output", []),
                                         ("request.output", [])])]
    assert {s.unit for s in spans} == {next(s.id for s in spans if s.name == "request")}
    steps = sorted((s for s in spans if s.name == "sample.step"), key=lambda s: s.start_ns)
    assert [s.attrs for s in steps] == [{"i": i} for i in range(STEPS)]
    assert all(s.start_ns <= s.end_ns for s in spans)


def test_multiview_call_nests_as_the_stages(mv_pipe):
    spans, _ = _recorded(_scene, mv_pipe)
    assert _tree(spans) == [_pipeline_tree(STEPS)]
    assert len({s.unit for s in spans}) == 1


def test_train_step_nests_as_the_stages(ref_pipe):
    spans, _ = _recorded(_train_step, ref_pipe)
    assert _tree(spans) == [("train.step", [
        ("train.forward", [("vae.encode", []), ("vae.encode", []), ("text", []), ("unet", [])]),
        ("train.backward", []), ("train.optimizer", [])])]
    assert len({s.unit for s in spans}) == 1


def test_units_are_one_per_call_and_threads_nest_apart(monkeypatch):
    """Two calls on one thread are two units; two threads inside spans at
    the same time each nest under their own unit.  (A profiler session is
    on for the thread that started it only, so recording is patched on for
    the workers.)"""
    monkeypatch.setattr(trace, "recording", lambda: True)
    barrier = threading.Barrier(2, timeout=30)
    done = []

    def worker(name):
        with trace.span(name):
            barrier.wait()
            with trace.span(name + ".inner"):
                barrier.wait()
        done.append(name)

    trace.clear()
    for _ in range(2):
        with trace.span("call"):
            with trace.span("call.inner"):
                pass
    threads = [threading.Thread(target=worker, args=(n,)) for n in ("a", "b")]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    assert sorted(done) == ["a", "b"] and not any(th.is_alive() for th in threads)
    spans = trace.spans()
    by_name = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s)
    calls = by_name["call"]
    assert len(calls) == 2 and calls[0].unit != calls[1].unit
    for inner in by_name["call.inner"]:
        assert inner.unit in {c.unit for c in calls} and inner.parent == inner.unit
    for n in ("a", "b"):
        (outer,), (inner,) = by_name[n], by_name[n + ".inner"]
        assert inner.parent == outer.id and inner.unit == outer.unit == outer.id
        assert inner.thread == outer.thread
    assert by_name["a"][0].thread != by_name["b"][0].thread


def test_span_lies_on_the_profilers_clock():
    """A span and a ``record_function`` range opened at the same point start
    and end within 50 us of each other (the median of 20 pairs)."""
    starts, ends = [], []
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm-up"):
            torch.ones(8) + 1
        for i in range(20):
            with trace.span("probe", i=i):
                with record_function(f"probe_{i}"):
                    torch.ones(64) * 2
    rf = {e.name(): e for e in prof.profiler.kineto_results.events() if e.name().startswith("probe_")}
    for s in trace.spans():
        e = rf[f"probe_{s.attrs['i']}"]
        starts.append(abs(e.start_ns() - s.start_ns))
        ends.append(abs(e.start_ns() + e.duration_ns() - s.end_ns))
    assert len(starts) == 20
    assert statistics.median(starts) < 50_000 and statistics.median(ends) < 50_000


@pytest.fixture
def cpu_is_the_card(monkeypatch):
    """Every device counts as the card's, so a CPU tensor is "on the card"
    and host data (numpy, lists) crosses."""
    monkeypatch.setattr(trace, "on_card", lambda device: True)


@pytest.mark.parametrize("unit,count", [("request", 11), ("scene", 8), ("train", 5)])
def test_blocking_copies_per_unit(ref_pipe, mv_pipe, cpu_is_the_card, unit, count):
    """The blocking copies one unit makes: a request 11 (its image, mask
    and two token arrays, the mask's two resize indices, the DDIM step's
    four tables, the result read back), a multi-view call 8 (its views
    already on the card: the two token arrays, the two indices, the four
    tables), a train step 5 (its batch on the card: q_sample's two schedule
    columns, the loss's lvlb weights, the two indices); each in the unit."""
    fn, pipe = {"request": (_request, ref_pipe), "scene": (_scene, mv_pipe), "train": (_train_step, ref_pipe)}[unit]
    spans, syncs = _recorded(fn, pipe)
    assert len(syncs) == count
    units = {s.unit for s in spans if s.parent is None}
    assert len(units) == 1 and {y.unit for y in syncs} == units
    kinds = [y.kind for y in syncs]
    assert kinds == ["h2d"] * (count - 1) + ["d2h"] if unit == "request" else kinds == ["h2d"] * count
    assert all(y.nbytes > 0 for y in syncs)


def test_helpers_count_only_crossings(cpu_is_the_card):
    x = torch.arange(6, dtype=torch.float32)
    with profile(activities=[ProfilerActivity.CPU]):
        trace.clear()
        assert trace.to_device(x, torch.float32, "cpu") is x  # already on the target: no copy, no count
        trace.to_device(x, torch.float64, "cpu")
        assert trace.syncs() == []
        y = trace.to_device(np.arange(6, dtype=np.float64), torch.float32, "cpu")
        host = trace.to_host(y)
    assert torch.equal(y, x) and torch.equal(host, x)
    assert [(s.kind, s.nbytes, s.unit) for s in trace.syncs()] == [("h2d", 24, None), ("d2h", 24, None)]


def test_cpu_copies_count_nothing(ref_pipe):
    """Unpatched, a CPU run never crosses to a card."""
    assert trace.on_card("cuda") and trace.on_card(torch.device("cuda", 0)) and not trace.on_card("cpu")
    _, syncs = _recorded(_request, ref_pipe)
    assert syncs == []


def test_sync_checks_its_kind():
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError):
            trace.sync("flush")
    trace.sync("flush")  # no profiler: returns at once


def test_buffers_are_bounded():
    rec = trace.Recorder(maxlen=3)
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(5):
            with rec.span("s", i=i):
                rec.sync("wait")
    assert [s.attrs["i"] for s in rec.spans()] == [2, 3, 4] and len(rec.syncs()) == 3
    assert rec.dropped() == 4
    rec.clear()
    assert rec.spans() == [] and rec.syncs() == [] and rec.dropped() == 0


def test_step_timer_window_carries_the_program_track(tmp_path):
    """The step timer's profiler window, written as a Chrome trace, holds
    the spans and syncs of its steps as a process of their own, on the
    trace's clock."""
    from leftrefill_torch.train.logger import PROGRAM_TRACK, StepTimer

    timer = StepTimer(trace_dir=str(tmp_path), trace_steps=(1, 2))
    for step in range(4):
        timer.start(step)
        with trace.span("train.step"):
            with record_function(f"mark_{step}"):
                trace.sync("wait")
                torch.ones(16) + step
        timer.stop(step)
    assert timer.mean_step_s() > 0
    (path,) = tmp_path.glob("trace_steps_1_2.json")
    events = json.loads(path.read_text())["traceEvents"]
    ours = [e for e in events if e.get("pid") == PROGRAM_TRACK and e.get("ph") == "X"]
    assert [e["name"] for e in ours] == ["train.step", "train.step"]
    assert [e["name"] for e in events if e.get("pid") == PROGRAM_TRACK and e.get("ph") == "i"] == ["sync.wait"] * 2
    marks = sorted((e for e in events if str(e.get("name", "")).startswith("mark_")), key=lambda e: e["ts"])
    assert [e["name"] for e in marks] == ["mark_1", "mark_2"]
    for span, mark in zip(sorted(ours, key=lambda e: e["ts"]), marks):
        assert span["ts"] <= mark["ts"] + 50 and mark["ts"] + mark["dur"] <= span["ts"] + span["dur"] + 50
