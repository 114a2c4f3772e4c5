"""One run of one cell: find the cell's files by the names in
``BENCHMARK.json``, set up (weights and inputs from the seed, the program
built and warmed), measure whole units for ``--seconds`` (or trace a fixed
number of them), then judge what the timed path produced against the plain
reference and print the result line.

A cell's pieces are files found by name: the configuration
``configs/<config>.json``, the traffic mix ``traffic/<traffic>.json`` (its
``driver`` names the general driver in ``drivers/``), the limits of its
check ``checks/<workload>.json``, and each per-layer metric's reader
``metrics/<name>.py`` (or ``metrics/<name up to its first dot>.py``)."""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
BANNED = frozenset({"jax", "jaxlib", "flax", "leftrefill_tpu"})


def banned_modules(names=None) -> list:
    """Loaded modules (or ``names``) whose top-level name, the part before
    the first dot, is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules if names is None else names)} & BANNED)


def process_start(fallback: float) -> float:
    """The wall time at which this process started (from /proc), else
    ``fallback``."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return fallback


class Cell:
    """A workload of the spec with its configuration, traffic, limits and
    metrics, all read from the benchmark's folder ``base``."""

    def __init__(self, spec: dict, workload: str, base: Path = HERE):
        self.base = base
        by_name = {w["name"]: w for w in spec["workloads"]}
        if workload not in by_name:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.workload = by_name[workload]
        self.name = workload
        self.config_entry = next(c for c in spec["configs"] if c["name"] == self.workload["config"])
        self.cfg = json.loads((base / "configs" / f"{self.config_entry['name']}.json").read_text())
        self.traffic = json.loads((base / "traffic" / f"{self.workload['traffic']}.json").read_text())
        self.limits = json.loads((base / "checks" / f"{workload}.json").read_text())
        self.end_to_end = [m for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]
        names = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in spec["per_layer"]
                          if workload in m.get("workloads", [workload]) and m["moves"] in names]

    def driver(self):
        return importlib.import_module(f"benchmark.drivers.{self.traffic['driver']}")

    def metric_reader(self, name: str):
        for stem in (name, name.split(".")[0]):
            path = self.base / "metrics" / f"{stem}.py"
            if path.exists():
                spec = importlib.util.spec_from_file_location(f"benchmark_metric_{stem.replace('.', '_')}", path)
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
                return mod.read
        raise FileNotFoundError(f"no reader for the metric {name!r} under {self.base / 'metrics'}")


class Run:
    """What a driver sees of the run: the cell's data, the seed, the device."""

    def __init__(self, cell: Cell, seed: int, device):
        self.cell, self.cfg, self.traffic, self.seed, self.device = cell, cell.cfg, cell.traffic, seed, device


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, started: float, control: bool = False) -> dict:
    """One run; returns the result line's object (``checked`` last)."""
    import torch

    from benchmark import inputs
    from benchmark.reference import sd2

    cuda = torch.device(device).type == "cuda"
    mod = cell.driver()
    drv = mod.Driver(Run(cell, seed, device))
    shapes = sd2.param_shapes(cell.cfg)
    weights = inputs.draw_weights(shapes, seed, device)
    drv.setup(None if control else weights)
    del weights
    gc.collect()
    if not control:
        drv.warm()
    _sync(device)
    found = banned_modules()
    if found:
        raise SystemExit(f"refusing to time: loaded modules of JAX or the JAX package: {found}")
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.time() - started
    units, window_s, traced = 0, 0.0, None
    if control:
        units = drv.control_units()
    elif trace:
        units, window_s, traced = _traced(drv, cell.traffic["trace_units"], device)
    else:
        t0 = time.perf_counter()  # one client: each unit starts as the one before returns
        marks = [t0]
        while True:
            drv.unit(units)
            units += 1
            marks.append(time.perf_counter())
            if marks[-1] - t0 >= seconds:
                break
        _sync(device)
        window_s = time.perf_counter() - t0
        _report_units(marks)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    found = banned_modules()
    if found:
        raise SystemExit(f"after the window: loaded modules of JAX or the JAX package: {found}")
    per_layer = _per_layer(cell, drv, units, window_s, traced, peak) if traced is not None else None
    drv.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    weights = inputs.draw_weights(shapes, seed, device)
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    t_check = time.perf_counter()
    try:
        if control:
            drv.control(weights, sd2.Arith(fp8=True))
        numbers = drv.check(weights, sd2.Arith(), units)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    print(f"set-up {setup_s:.1f} s, window {window_s:.1f} s, {units} units, check {time.perf_counter() - t_check:.1f} s",
          file=sys.stderr)
    checked = {k: {"value": float(v), "limit": float(cell.limits[k])} for k, v in numbers.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checked.values())
    dev = {"platform": "gpu" if cuda else "cpu", "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if per_layer is not None:
        metrics = per_layer
        dev.update(busy_s=traced.busy_s, window_s=traced.window_s)
    else:
        rate = drv.per_unit * units / window_s if window_s else float("nan")
        values = {"setup_s": setup_s, mod.RATE: rate}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
    out = {"correct": correct, "attempted": units, "failed": 0, "metrics": metrics, "device": dev}
    if traced is not None:
        out["breakdown"] = {"device_ops": traced.top_device_ops(), "idle_gaps": traced.host.idle_gaps()}
    out["checked"] = checked
    return out


def _report_units(marks: list) -> None:
    """The host's time per unit in the window (quartiles and the longest),
    on standard error."""
    import statistics

    d = [b - a for a, b in zip(marks, marks[1:])]
    q = statistics.quantiles(d, n=4) if len(d) > 1 else [d[0]] * 3
    print(f"units: {len(d)}, host s a unit q1 {q[0]:.4f} median {q[1]:.4f} q3 {q[2]:.4f} max {max(d):.4f}",
          file=sys.stderr)


def _traced(drv, n: int, device):
    """``n`` units under the device tracer alone (its cost to the host is
    small), then one more unit with the host's ops traced as well, for the
    idle gaps by host op (that tracer slows the host, so it sets no other
    number)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from leftrefill_torch import kernels

    from benchmark.trace import WINDOW, Trace

    cuda = torch.device(device).type == "cuda"
    with kernels.record_sites() as sites, profile(
            activities=[ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            drv.unit(i)
        _sync(device)
        window_s = time.perf_counter() - t0
    tr = Trace(prof, window_s)
    tr.sites = list(sites)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            drv.unit(n)
            _sync(device)
    tr.host = Trace(prof)
    return n, window_s, tr


def _per_layer(cell: Cell, drv, units: int, window_s: float, tr, peak: int) -> dict:
    ctx = {"kind": drv.KIND, "units": units, "per_unit": drv.per_unit, "trace": tr, "sites": tr.sites,
           "flops_per_unit": drv.flops_per_unit, "peak_bytes": peak, "window_s": tr.window_s}
    out = {}
    for m in cell.per_layer:
        value = cell.metric_reader(m["name"])(m["name"], ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def main(argv, root: Path, started: float) -> int:
    p = argparse.ArgumentParser(description="Run one cell of the benchmark once and print its result line.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0,
                   help="1: the reference in fp8 in the program's place (the check's control), no window")
    args = p.parse_args(argv)
    import torch

    spec = json.loads((root / "BENCHMARK.json").read_text())
    cell = Cell(spec, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.workload["chips"]:
        print(f"no CUDA device for {args.workload} (needs {cell.workload['chips']}): not run", file=sys.stderr)
        return 2
    out = run(cell, args.seed, args.seconds, bool(args.trace), "cuda", started, bool(args.control))
    try:
        import subprocess

        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        card = "nvidia-smi unavailable"
    sys.stdout.flush()
    print(f"card: {card}", file=sys.stderr)
    for k, c in out["checked"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
