"""The program's spans and its host-sync counter.

``span(name, **attrs)`` marks a stage of the program (a request, the
sampler, one UNet call, a train step's backward) and ``sync(kind, nbytes)``
an instant at which the host waits on the card.  The outermost span on a
thread opens a unit (a request, a multi-view call, a train step), and every
span and sync inside it carries that unit's id; each thread keeps its own
stack, so concurrent requests nest apart.  ``to_device`` and ``to_host``
make a copy between host and card and count it where it crosses: PyTorch
issues a blocking copy and then synchronises the stream, so the host waits
for the card's queue to drain.

Both record only while a ``torch.profiler`` session is active on the
calling thread (the thread that started it, and those PyTorch hands its
state to, as autograd's engine).  Otherwise
``span`` returns one shared object that does nothing and ``sync`` returns at
once: a flag check a call.  Nothing is handed to the profiler (a
``record_function`` range would come back as a device event under a CUDA
profiler); the records stay in memory, in bounded buffers that drop their
oldest first and count what they dropped, with timestamps in ns of
``time.time_ns``, the clock of the profiler's host events.  ``spans()``,
``syncs()``, ``dropped()`` and ``clear()`` read and empty them.

The spans, one name per boundary: ``request`` (``serving.gradio_app``'s
request), ``request.canvas``, ``request.output``; ``pipeline`` (a pipeline
call), ``pipeline.inputs``; ``text``, ``vae.encode``, ``vae.decode``,
``cross_kv``, ``unet`` (``diffusion.core.LeftRefillModel``); ``sample`` and
``sample.step`` (attribute ``i``) in the samplers; ``train.step``,
``train.forward``, ``train.backward``, ``train.optimizer``."""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import NamedTuple, Optional

import torch

MAX_RECORDS = 1 << 18  # per buffer: ~2000 requests' spans
SYNC_KINDS = ("h2d", "d2h", "wait")

recording = torch._C._autograd._profiler_enabled  # whether a torch.profiler session is on for this thread


class SpanRecord(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]  # the enclosing span's id, None for a unit's own span
    unit: int  # the id of the unit's (outermost) span
    thread: int
    attrs: dict


class SyncRecord(NamedTuple):
    kind: str
    nbytes: int
    t_ns: int  # when the host resumed
    unit: Optional[int]  # None outside every span
    span: Optional[int]  # the innermost open span's id
    thread: int


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


class _Span:
    __slots__ = ("rec", "name", "attrs", "id", "parent", "unit", "start_ns")

    def __init__(self, rec: "Recorder", name: str, attrs: dict):
        self.rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self):
        stack = self.rec._stack()
        top = stack[-1] if stack else None
        self.id = self.rec._next_id()
        self.parent = top.id if top else None
        self.unit = top.unit if top else self.id
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        stack = self.rec._stack()
        stack.remove(self)
        self.rec._append(self.rec._spans, SpanRecord(self.name, self.start_ns, end, self.id, self.parent,
                                                     self.unit, threading.get_ident(), self.attrs))
        return False


class Recorder:
    """Spans and syncs of the threads of one process (module docstring)."""

    def __init__(self, maxlen: int = MAX_RECORDS):
        self._spans: deque = deque(maxlen=maxlen)
        self._syncs: deque = deque(maxlen=maxlen)
        self._dropped = 0
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _next_id(self) -> int:
        with self._lock:
            return next(self._ids)

    def _append(self, buf: deque, rec) -> None:
        with self._lock:
            if len(buf) == buf.maxlen:
                self._dropped += 1
            buf.append(rec)

    def span(self, name: str, **attrs):
        """A context manager that records the stage ``name`` while a
        profiler session is active, else the shared no-op."""
        if not recording():
            return NOOP
        return _Span(self, name, attrs)

    def sync(self, kind: str, nbytes: int = 0) -> None:
        """Record that the host waits on the card here (``kind``: ``h2d``,
        ``d2h`` or ``wait``), in the current unit, while a profiler session
        is active."""
        if not recording():
            return
        if kind not in SYNC_KINDS:
            raise ValueError(f"sync kind {kind!r} is none of {SYNC_KINDS}")
        stack = self._stack()
        top = stack[-1] if stack else None
        self._append(self._syncs, SyncRecord(kind, int(nbytes), time.time_ns(), top.unit if top else None,
                                             top.id if top else None, threading.get_ident()))

    def spans(self) -> list:
        """The finished spans held, in the order they ended."""
        with self._lock:
            return list(self._spans)

    def syncs(self) -> list:
        with self._lock:
            return list(self._syncs)

    def dropped(self) -> int:
        """Records dropped (the oldest first) since the last ``clear``."""
        return self._dropped

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._syncs.clear()
            self._dropped = 0


RECORDER = Recorder()
span, sync, spans, syncs, dropped, clear = (RECORDER.span, RECORDER.sync, RECORDER.spans, RECORDER.syncs,
                                            RECORDER.dropped, RECORDER.clear)


def on_card(device) -> bool:
    """Whether ``device`` is the card's: a copy between it and the host
    crosses."""
    return torch.device(device).type == "cuda"


def to_device(x, dtype: Optional[torch.dtype] = None, device=None) -> torch.Tensor:
    """``torch.as_tensor(x, dtype=dtype, device=device)``, counted as an
    ``h2d`` sync where it copies host data to the card; a tensor already on
    the card counts nothing."""
    out = torch.as_tensor(x, dtype=dtype, device=device)
    if recording() and device is not None and on_card(device) and not (
            isinstance(x, torch.Tensor) and on_card(x.device)):
        sync("h2d", out.numel() * out.element_size())
    return out


def to_host(t: torch.Tensor) -> torch.Tensor:
    """``t.cpu()``, counted as a ``d2h`` sync where ``t`` is on the card."""
    out = t.cpu()
    if recording() and on_card(t.device):
        sync("d2h", out.numel() * out.element_size())
    return out
