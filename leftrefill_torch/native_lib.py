"""Build, load and route the port's native libraries: the CUDA kernels
(``kernels/``) and the host image layer (``data/native.py``).

A :class:`Library` is compiled at first use from the repo's sources into
``leftrefill_torch/_build/<hash>/<name>`` (the hash covers every source, the
compiler and its flags, so an edit rebuilds), under an exclusive file lock
on that directory, and renamed into place when whole, so that several
processes (test workers, ranks) can build at once.  It is loaded with
``ctypes.CDLL``, which releases the GIL for every call.  A failed build
raises with the compiler's output.

A :class:`Router` names the operations that a context routes to their plain
versions.  Importing this module compiles nothing.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable

BUILD_ROOT = Path(__file__).resolve().parent / "_build"


class Library:
    """One shared library.  ``sources()`` lists its files, ``compiler()``
    finds the compiler (raising where there is none), and ``stages(compiler,
    sources, work, target)`` gives the build's commands: a list of stages,
    each a list of commands that run at once, the stages in turn, the last
    writing ``target``; every file they write goes under the scratch
    directory ``work``, which is removed after.  ``signatures``: {entry point:
    (argument types, result type)}."""

    def __init__(self, name: str, sources: Callable[[], list[Path]], compiler: Callable[[], str], flags: tuple,
                 stages: Callable, signatures: dict):
        self.name, self.sources, self.compiler, self.flags = name, sources, compiler, flags
        self.stages, self.signatures = stages, signatures
        self.root = BUILD_ROOT
        self.lib = None
        self._lock = threading.Lock()

    def path(self) -> Path:
        h = hashlib.sha256()
        for p in self.sources():
            h.update(p.name.encode())
            h.update(p.read_bytes())
        h.update(" ".join(self.flags).encode())
        h.update(self.compiler().encode())
        return self.root / h.hexdigest()[:16] / self.name

    def build(self) -> Path:
        """Compile the sources unless this hash is built."""
        out = self.path()
        if out.exists():
            return out
        out.parent.mkdir(parents=True, exist_ok=True)
        with open(out.parent / "lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes, or the process ends
            if out.exists():  # another process built it while this one waited
                return out
            work = out.parent / "work"
            shutil.rmtree(work, ignore_errors=True)  # what a killed build left
            work.mkdir()
            logs = []
            try:
                for stage in self.stages(self.compiler(), self.sources(), work, work / self.name):
                    jobs = [(cmd, _start(cmd)) for cmd in stage]
                    failed = []
                    for cmd, proc in jobs:
                        logs.append(" ".join(cmd) + "\n" + proc.communicate()[0])
                        if proc.returncode != 0:
                            failed.append(logs[-1])
                    if failed:
                        raise RuntimeError(f"the compiler {stage[0][0]!r} failed to build {self.name}:\n"
                                           f"{failed[0][-4000:]}")
                os.replace(work / self.name, out)
            finally:
                (out.parent / "build.log").write_text("\n".join(logs))
                shutil.rmtree(work, ignore_errors=True)
        return out

    def load(self) -> ctypes.CDLL:
        """The loaded library, built on first use."""
        with self._lock:
            if self.lib is None:
                lib = ctypes.CDLL(str(self.build()))
                for name, (argtypes, restype) in self.signatures.items():
                    fn = getattr(lib, name)
                    fn.argtypes, fn.restype = argtypes, restype
                self.lib = lib
        return self.lib

    def reset(self) -> None:
        """Forget the loaded library: the next :meth:`load` builds from the
        sources as they are then (the kernel-variant studies swap them)."""
        with self._lock:
            self.lib = None


def _start(cmd: list[str]) -> subprocess.Popen:
    try:
        return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    except OSError as e:
        raise RuntimeError(f"the compiler {cmd[0]!r} could not be run: {e}") from None


class Router:
    """The operations ``names`` of a library that :meth:`plain` routes to
    their plain versions, in every thread, while its context is open."""

    def __init__(self, names: tuple, what: str):
        self.names, self.what = tuple(names), what
        self._plain: frozenset = frozenset()

    def is_plain(self, name: str) -> bool:
        return name in self._plain

    @contextlib.contextmanager
    def plain(self, names):
        unknown = set(names) - set(self.names)
        if unknown:
            raise ValueError(f"unknown {self.what} {sorted(unknown)}")
        prev, self._plain = self._plain, frozenset(names)
        try:
            yield
        finally:
            self._plain = prev
