"""Observability: phase timers + torch.profiler integration.

The reference's only timing is ad-hoc millisecond stamps around
prove/verify (SURVEY.md §5); here it is structured phase timing
(Prover.last_timings) plus on-demand device traces: a Chrome trace
(chrome://tracing, Perfetto) of the host ops and, on a card, of the CUDA
kernels.

Usage:
    from zigz_tpu_torch.utils.profiling import device_trace, PhaseTimer

    with device_trace("traces/prove") as prof:  # torch.profiler trace
        prover.prove(...)
    prof.key_averages()                         # sums by op and kernel

    t = PhaseTimer()
    with t.phase("witness"):
        ...
    print(t.report())

Counterpart of zigz_tpu/utils/profiling.py: ``PhaseTimer`` is the same
class; ``device_trace`` wraps ``torch.profiler.profile`` instead of
``jax.profiler``; ``maybe_trace_env`` takes the directory as an argument
(None = no trace) instead of reading an environment variable.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

__all__ = ["device_trace", "PhaseTimer", "maybe_trace_env", "TRACE_FILE"]

TRACE_FILE = "trace.json"


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


class PhaseTimer:
    """Named phase timing with nesting-free accumulation."""

    def __init__(self):
        self.timings: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timings[name] = self.timings.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        total = sum(self.timings.values())
        lines = [f"{name:<20}{dt * 1e3:10.2f} ms" for name, dt in self.timings.items()]
        lines.append(f"{'total':<20}{total * 1e3:10.2f} ms")
        return "\n".join(lines)
