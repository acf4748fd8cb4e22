"""Reading a torch.profiler Chrome trace of the measured window.

The device is busy wherever a kernel, a copy or a memset runs; busy time is
the length of the union of those intervals inside the window, so work that
overlaps on two streams counts once. The window is the span from the start
of the run's first `prove` span to the end of its last `serialize` span
(spans the benchmark itself records around each call).
"""

from __future__ import annotations

import json
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPANS = ("prove", "serialize")  # the benchmark's own spans, named "<span>#<i>"


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Sorted, merged copy of [start, end) intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals, lo: float, hi: float):
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


@dataclass
class Summary:
    window_s: float
    busy_s: float
    kernel_s: Dict[str, float]  # device time by kernel name inside the window
    op_s: Dict[str, float]  # device time by name, kernels, copies and memsets
    gaps: List[Tuple[str, float]] = field(default_factory=list)  # longest idle gaps, named

    def kernels_matching(self, needles) -> float:
        """Seconds of the kernels whose name holds any of `needles`."""
        return sum(s for k, s in self.kernel_s.items() if any(n in k for n in needles))


def summarize(events: List[dict], top: int = 10) -> Summary:
    """The window's device busy time, device time by name, and its longest
    idle gaps from a list of Chrome trace events (times in microseconds)."""
    spans, device, host = [], [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        name, cat = ev.get("name", ""), ev.get("cat", "")
        s, e = float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0.0))
        if cat in DEVICE_CATS:
            device.append((s, e, name, cat))
        elif cat == "user_annotation" and name.split("#")[0] in SPANS:
            spans.append((s, e, name.split("#")[0]))
        elif cat in ("cpu_op", "python_function", "user_annotation", "cuda_runtime", "cuda_driver"):
            host.append((s, e, name))
    if not spans:
        raise ValueError("the trace holds none of the benchmark's spans")
    lo, hi = min(s for s, _, _ in spans), max(e for _, e, _ in spans)
    busy = union(clip([(s, e) for s, e, _, _ in device], lo, hi))
    kernel_s, op_s = defaultdict(float), defaultdict(float)
    for s, e, name, cat in device:
        (c,) = clip([(s, e)], lo, hi) or [(0.0, 0.0)]
        dur = (c[1] - c[0]) * 1e-6
        op_s[name] += dur
        if cat == "kernel":
            kernel_s[name] += dur
    gaps, prev = [], lo
    for s, e in busy + [(hi, hi)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    gaps.sort(key=lambda g: g[0] - g[1])
    named = [(_name_gap(g, spans, host), (g[1] - g[0]) * 1e-6) for g in gaps[:top]]
    return Summary(window_s=(hi - lo) * 1e-6, busy_s=sum(e - s for s, e in busy) * 1e-6,
                   kernel_s=dict(kernel_s), op_s=dict(op_s), gaps=named)


def _name_gap(gap, spans, host) -> str:
    """`<span>:<host op>`: the benchmark span the gap lies in, and the name
    of the host events that overlap the gap most, summed by name, where any
    do."""
    lo, hi = gap
    mid = (lo + hi) / 2
    span = next((n for s, e, n in spans if s <= mid <= e), "between")
    overlap = defaultdict(float)
    for s, e, name in host:
        if e > lo and s < hi and name.split("#")[0] not in SPANS:
            overlap[name] += min(e, hi) - max(s, lo)
    return f"{span}:{max(overlap, key=overlap.get)}" if overlap else span


def load(path) -> List[dict]:
    with open(path) as f:
        doc = json.load(f)
    return doc["traceEvents"] if isinstance(doc, dict) else doc


def top_ops(summary: Summary, top: int = 10):
    return sorted(summary.op_s.items(), key=lambda kv: -kv[1])[:top]
