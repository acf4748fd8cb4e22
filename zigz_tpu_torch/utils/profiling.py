"""Observability: prove spans, counter tables and torch.profiler traces.

Three parts, one module:

* **Spans.** ``span(name)`` times a phase with two ``perf_counter_ns``
  reads.  Inside a root (``root("prove", prove_id)``, opened by
  ``Prover.prove``; ``root("serialize", ...)`` by the serializer) each span
  is kept as ``(prove_id, span_id, parent_id, name, start_ns, end_ns)`` in
  the root's ``SpanLog``, which ``Prover.last_spans`` holds for the last
  prove only.  ``Prover.last_timings`` is filled from these spans.  While
  torch's profiler runs, each leaf span (every span not opened with
  ``outer=True``) also enters ``record_function("zigz/<parent>/<leaf>")``,
  so the profiler's trace names the host phase beside the kernels and
  copies.  A root also counts the seconds and runs of Python's garbage
  collector inside it (one ``gc.callbacks`` hook).  Spans are opened and
  closed on the prover's one thread.
* **Counter tables.** ``counter_table(prefix, keys)`` makes a module's
  launch or work counter dict and registers it; ``counters()`` is a
  snapshot of every registered table.
* **Device traces.** ``device_trace(log_dir)`` wraps ``torch.profiler``
  and leaves a Chrome trace (chrome://tracing, Perfetto) of the host ops
  and, on a card, of the CUDA kernels.

Usage:
    from zigz_tpu_torch.utils.profiling import device_trace, format_tree

    with device_trace("traces/prove") as prof:  # torch.profiler trace
        prover.prove(...)
    prof.key_averages()                         # sums by op and kernel
    print(format_tree(prover.last_spans))       # the prove's span tree

Counterpart of zigz_tpu/utils/profiling.py: ``device_trace`` wraps
``torch.profiler.profile`` instead of ``jax.profiler``; ``maybe_trace_env``
takes the directory as an argument (None = no trace) instead of reading an
environment variable.
"""

from __future__ import annotations

import contextlib
import gc
import os
import time
from typing import Dict, Iterable, List, Optional

from torch.autograd import profiler as _autograd_profiler

__all__ = ["device_trace", "maybe_trace_env", "TRACE_FILE", "span", "root", "SpanLog", "format_tree",
           "counter_table", "counters"]

TRACE_FILE = "trace.json"
_NS = 1e-9


@contextlib.contextmanager
def device_trace(log_dir: str):
    """torch.profiler trace context: CPU activities, and CUDA activities
    where a card is present.  Yields the profiler; on exit the Chrome
    trace is written to ``log_dir/trace.json``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


@contextlib.contextmanager
def maybe_trace_env(log_dir: Optional[str]):
    """Trace into ``log_dir`` when it is given; no-op otherwise."""
    if not log_dir:
        yield None
        return
    with device_trace(log_dir) as prof:
        yield prof


# -- spans ---------------------------------------------------------------------

class SpanLog(list):
    """The spans of one root, the root first, in the order they open.  Each
    span's ``span_id`` is its index here.  ``gc_s`` and ``gc_collections``
    are the garbage collector's seconds and runs while the root was open."""

    __slots__ = ("prove_id", "gc_s", "gc_collections")

    def __init__(self, prove_id):
        self.prove_id = prove_id
        self.gc_s = 0.0
        self.gc_collections = 0

    def children(self, parent: "span") -> List["span"]:
        return [s for s in self if s._up is parent]

    def self_seconds(self, s: "span") -> float:
        """The span's seconds less its children's."""
        return s.seconds - sum(c.seconds for c in self.children(s))


_OPEN: list = [None, None]  # the open root's log and its innermost open span (None, None outside a root)
_clock = time.perf_counter_ns


class span:
    """``with span(name) as s:`` times the block; ``s.seconds`` after it.

    Inside a root the span is kept in the root's ``SpanLog`` with its
    parent, the innermost span open around it; its ``prove_id``,
    ``span_id`` and ``parent_id`` are read from there (None outside a
    root).  A span that holds other spans is opened with ``outer=True``:
    only leaves are shown to torch's profiler, since a trace reader that
    sums overlap by name would credit an outer span with its children's
    time.  No span name starts with ``prove#`` or ``serialize#``, a
    benchmark's own window marks."""

    __slots__ = ("name", "outer", "start_ns", "end_ns", "_log", "_up", "_rf")

    def __init__(self, name: str, outer: bool = False):
        self.name = name
        self.outer = outer

    def __enter__(self) -> "span":
        log = self._log = _OPEN[0]
        if log is None:
            self._up = None
        else:
            self._up = _OPEN[1]
            log.append(self)
            _OPEN[1] = self
        if self.outer or not _autograd_profiler._is_profiler_enabled:
            self._rf = None
        else:
            parent = self._up.name if self._up is not None else "-"
            self._rf = _autograd_profiler.record_function(f"zigz/{parent}/{self.name}")
            self._rf.__enter__()
        self.start_ns = _clock()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.end_ns = _clock()
        if self._rf is not None:
            self._rf.__exit__(exc_type, exc, tb)
        if _OPEN[1] is self:
            _OPEN[1] = self._up

    @property
    def prove_id(self):
        return None if self._log is None else self._log.prove_id

    @property
    def span_id(self) -> Optional[int]:
        return None if self._log is None else self._log.index(self)

    @property
    def parent_id(self) -> Optional[int]:
        return None if self._up is None else self._up.span_id

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * _NS

    def __repr__(self) -> str:
        return (f"span({self.prove_id}, {self.span_id}, {self.parent_id}, {self.name!r}, "
                f"{getattr(self, 'start_ns', None)}, {getattr(self, 'end_ns', None)})")


_GC = [0, 0, 0]  # the collector's nanoseconds and runs since the hook went in, the open run's start


def _on_gc(phase: str, info: dict) -> None:
    if phase == "start":
        _GC[2] = _clock()
    else:
        _GC[0] += _clock() - _GC[2]
        _GC[1] += 1


class root:
    """``with root(name, prove_id) as log:`` opens a root span and yields
    its ``SpanLog``, which collects every span opened inside it; on exit the
    log holds the collector's time inside.  A root opened inside another
    keeps its spans apart and gives the outer root back on exit."""

    __slots__ = ("log", "_outer", "_gc0")

    def __init__(self, name: str, prove_id):
        if _on_gc not in gc.callbacks:
            gc.callbacks.append(_on_gc)
        self.log = SpanLog(prove_id)
        top = span(name, outer=True)
        top._log, top._up = self.log, None
        self.log.append(top)

    def __enter__(self) -> SpanLog:
        self._outer = _OPEN[0], _OPEN[1]
        self._gc0 = _GC[0], _GC[1]
        _OPEN[0], _OPEN[1] = self.log, self.log[0]
        self.log[0].start_ns = _clock()
        return self.log

    def __exit__(self, exc_type, exc, tb) -> None:
        log = self.log
        log[0].end_ns = _clock()
        log.gc_s, log.gc_collections = (_GC[0] - self._gc0[0]) * _NS, _GC[1] - self._gc0[1]
        _OPEN[0], _OPEN[1] = self._outer


def format_tree(log: SpanLog) -> str:
    """One line a span, indented under its parent: total and self ms."""
    lines = []

    def walk(s, depth):
        lines.append(f"{'  ' * depth}{s.name:<{28 - 2 * depth}}{s.seconds * 1e3:11.3f} ms"
                     f"{log.self_seconds(s) * 1e3:11.3f} ms self")
        for c in log.children(s):
            walk(c, depth + 1)

    for s in log:
        if s.parent_id is None:
            walk(s, 0)
    return "\n".join(lines)


# -- counter tables ------------------------------------------------------------

_COUNTERS: Dict[str, dict] = {}


def counter_table(prefix: str, keys: Iterable[str]) -> dict:
    """A module's counter dict, every key at 0 (0.0 for a key that ends in
    ``_s``, which counts seconds), registered under ``prefix``.  The module
    keeps and updates the dict itself; a reloaded module's table replaces
    the one it had."""
    table = {key: 0.0 if key.endswith("_s") else 0 for key in keys}
    _COUNTERS[prefix] = table
    return table


def counters() -> dict:
    """A snapshot of every registered table: ``{"<prefix>.<key>": value}``."""
    return {f"{prefix}.{key}": value for prefix, table in _COUNTERS.items() for key, value in table.items()}
