"""The program's spans and syncs (``leftrefill_torch.trace``) as the
per-layer metrics read them.  The program records only while a profiler
session is on, so what its recorder holds after a traced run are the units
of the device-traced window (the first ``ctx["units"]`` units it opened),
then the one unit traced with the host's ops.  Each idle gap of the
window's device trace is put down to the program stage the host was in at
the gap's midpoint: the innermost span open there.  The spans are on the
host's wall clock (``time.time_ns``), the device's events on the clock the
profiler converts them to, which on an H100 under torch 2.11 kept within
~20 us of it in one process and ran 0.5 ms behind in another, and within a
window wandered by up to a few ms: a gap is put down to its stage with that
uncertainty at the stages' edges.  Where the program keeps no spans (a
version without the recorder, or one that dropped records), every reader
gets None."""

from __future__ import annotations

import bisect

# the stage of the innermost span open at a gap's midpoint
ENTRY = ("request", "pipeline", "pipeline.inputs")  # and every "request.*"
WITHIN = {"sampler": "sample", "forward": "train.forward", "backward": "train.backward"}


def recorded():
    """(spans, syncs) the program's recorder holds, or None where there is
    no recorder or it dropped records (its first units are then lost)."""
    try:
        from leftrefill_torch import trace
    except ImportError:
        return None
    if trace.dropped():
        return None
    return trace.spans(), trace.syncs()


def window_units(spans, n: int):
    """The ids of the first ``n`` units (a unit's id is its outermost
    span's, in the order they opened), or None where fewer are held."""
    units = sorted({s.unit for s in spans if s.parent is None})
    return set(units[:n]) if len(units) >= n else None


def in_stage(span, stage: str, by_id: dict) -> bool:
    """Whether ``span``, the innermost open at a midpoint, is of ``stage``:
    ``entry`` (a request's or a pipeline call's own host work, outside
    their inner stages), or ``sampler``, ``forward``, ``backward`` (inside a
    ``sample``, ``train.forward`` or ``train.backward`` span, at any
    depth)."""
    if stage == "entry":
        return span.name in ENTRY or span.name.startswith("request.")
    target = WITHIN[stage]
    while span is not None:
        if span.name == target:
            return True
        span = by_id.get(span.parent)
    return False


def innermost(spans):
    """(times, spans): from ``times[i]`` on, ``spans[i]`` is the innermost
    span open (None where none is)."""
    by_id = {s.id: s for s in spans}
    depth = {}

    def depth_of(s):
        if s.id not in depth:
            p = by_id.get(s.parent)
            depth[s.id] = 0 if p is None else depth_of(p) + 1
        return depth[s.id]

    events = sorted([(s.start_ns, 1, s) for s in spans if s.end_ns > s.start_ns]
                    + [(s.end_ns, 0, s) for s in spans if s.end_ns > s.start_ns], key=lambda e: (e[0], e[1]))
    times, tops, open_ = [], [], []
    for t, starts, s in events:
        if starts:
            open_.append(s)
        else:
            open_.remove(s)
        times.append(t)
        tops.append(max(open_, key=depth_of) if open_ else None)
    return times, tops


def stage_idle_ns(gaps, spans, stage: str) -> int:
    """The idle time, in ns, of the ``gaps`` [(start_ns, end_ns)] whose
    midpoint falls where the innermost open span is of ``stage``."""
    by_id = {s.id: s for s in spans}
    times, tops = innermost(spans)
    verdict = {}
    total = 0
    for g0, g1 in gaps:
        i = bisect.bisect_right(times, (g0 + g1) // 2) - 1
        top = tops[i] if i >= 0 else None
        if top is None:
            continue
        if top.id not in verdict:
            verdict[top.id] = in_stage(top, stage, by_id)
        if verdict[top.id]:
            total += g1 - g0
    return total


def idle_share(ctx, stage: str):
    """The share of the traced window, in %, that the device idled while the
    host was in ``stage``; None without spans of the window's units."""
    rec = recorded()
    units = rec and window_units(rec[0], ctx["units"])
    if not units:
        return None
    tr = ctx["trace"]
    spans = [s for s in rec[0] if s.unit in units]
    return 100.0 * stage_idle_ns(tr.gaps, spans, stage) * 1e-9 / tr.window_s


def syncs_per_unit(ctx):
    """The host's syncs with the card in the window's units, per unit; None
    without spans of those units."""
    rec = recorded()
    units = rec and window_units(rec[0], ctx["units"])
    if not units:
        return None
    return sum(1 for y in rec[1] if y.unit in units) / ctx["units"]
