"""Reading a ``torch.profiler`` trace of the traced units: the device's
intervals (kernels, copies, sets) inside the benchmark's window span, their
union (busy time), the idle gaps between them with the host op that was
running, and device time by kernel.  Kept in memory: no trace file is
written."""

from __future__ import annotations

import bisect
import re
from collections import defaultdict

import torch

WINDOW = "benchmark.window"
PORT_KERNEL = "lr::"  # the program's own kernels live in namespace lr


def _name(n: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.:-]", "_", n)[:64]


class Trace:
    """``device``: [(start_ns, end_ns, name)] of the device's activity in the
    window; ``window_s``; ``busy_s`` (their union).  The window is the
    ``benchmark.window`` span where the host's ops were traced, else every
    device event and the host-clock ``window_s`` given."""

    def __init__(self, prof, window_s: float | None = None):
        events = prof.profiler.kineto_results.events()
        cuda = torch.autograd.DeviceType.CUDA
        window, dev, ops = None, [], []
        for e in events:
            name = e.name()
            if e.device_type() == cuda:
                if name.startswith("benchmark."):  # the annotations' device-side ranges
                    continue
                dev.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
            elif name == WINDOW:
                window = (e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id())
            elif name.startswith("aten::"):
                ops.append((e.start_ns(), e.start_ns() + e.duration_ns(), name, e.start_thread_id()))
        if window is None:
            if window_s is None:
                raise RuntimeError(f"the trace holds no {WINDOW!r} span")
            w0 = min((s for s, _, _ in dev), default=0)
            window = (w0, max((e for _, e, _ in dev), default=w0), None)
        w0, w1, thread = window
        self.window_s = (w1 - w0) * 1e-9 if window_s is None else window_s
        self.device = sorted((s, e, n) for s, e, n in dev if e > w0 and s < w1)
        self.ops = sorted((s, e, n) for s, e, n, th in ops if th == thread and e > w0 and s < w1)
        busy, gaps, cur_s, cur_e = 0, [], None, w0
        for s, e, _ in self.device:
            s, e = max(s, w0), min(e, w1)
            if cur_s is None or s > cur_e:
                if s > cur_e:
                    gaps.append((cur_e, s))
                if cur_s is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_s is not None:
            busy += cur_e - cur_s
        if cur_e < w1:
            gaps.append((cur_e, w1))
        self.busy_s = busy * 1e-9
        self.gaps = gaps

    def kernels(self):
        return [d for d in self.device if not d[2].startswith(("Memcpy", "Memset"))]

    def device_time_s(self, match=None) -> float:
        return sum(e - s for s, e, n in self.device if match is None or match(n)) * 1e-9

    def top_device_ops(self, k: int = 10) -> list:
        total = defaultdict(int)
        for s, e, n in self.device:
            total[_name(n)] += e - s
        return [[n, t * 1e-9] for n, t in sorted(total.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list:
        """The idle time by the innermost host op running at each gap's
        midpoint, looked for among the 64 ops that started last before it
        (``host`` where none of them runs)."""
        starts = [s for s, _, _ in self.ops]
        total = defaultdict(int)
        for g0, g1 in self.gaps:
            mid = (g0 + g1) // 2
            i = bisect.bisect_right(starts, mid) - 1
            label = "host"
            for i in range(i, max(i - 64, -1), -1):
                s, e, n = self.ops[i]
                if e >= mid:
                    label = n
                    break
            total[label] += g1 - g0
        return [[n, t * 1e-9] for n, t in sorted(total.items(), key=lambda kv: -kv[1])[:k]]
