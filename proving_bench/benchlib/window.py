"""Set-up and the measured window: one prover, proves back to back.

Set-up builds one `Prover` and warms it up with proves at the cell's own
size. The window then proves the seed's inputs one after another, each
prove followed by the serialization of its proof (the bytes a user ships),
and starts a prove only while the time of the last prove before it (the
last warm-up's, for the first) says it will end inside `--seconds`; the
first always runs. Each prove is timed by the host
clock once the device has drained. A few proofs are kept for the
comparison with the reference: a seeded sample and the longest.
"""

from __future__ import annotations

import contextlib
import gc
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from . import card, cell as cells, trace as traces

@dataclass
class Prove:
    i: int
    n: int
    steps: int
    num_vars: int
    seconds: float  # prove and serialize
    serialize_s: float
    timings: Dict[str, float]  # every number of the prover's `last_timings`
    error: Optional[str] = None


@dataclass
class Run:
    cell: cells.Cell
    seed: int
    setup_s: float = 0.0
    window_s: float = 0.0
    warmup_s: List[float] = field(default_factory=list)
    proves: List[Prove] = field(default_factory=list)
    kept: Dict[int, bytes] = field(default_factory=dict)  # prove index -> proof bytes
    memory: Dict[str, int] = field(default_factory=dict)
    counters: Dict[str, int] = field(default_factory=dict)
    trace: Optional[traces.Summary] = None
    card: Dict[str, float] = field(default_factory=dict)
    cpu_per_s: float = 0.0  # this process's CPU seconds a second of window

    @property
    def config(self):
        return self.cell.config

    @property
    def mix(self):
        return self.cell.mix

    @staticmethod
    def work(group: str):
        return cells.work(group)

    def good(self) -> List[Prove]:
        return [p for p in self.proves if p.error is None]


def numbers(timings: dict) -> Dict[str, float]:
    """The entries of a `last_timings` that are numbers, as floats."""
    return {k: float(v) for k, v in timings.items()
            if isinstance(v, (int, float, np.integer, np.floating)) and not isinstance(v, bool)}


class _Keep:
    """A seeded reservoir sample of the window's proofs, plus the longest."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = np.random.default_rng([seed & ((1 << 64) - 1), 3])
        self.sample: Dict[int, bytes] = {}
        self.seen = 0
        self.longest = (-1, -1, b"")  # steps, index, bytes

    def offer(self, i: int, steps: int, data: bytes) -> None:
        self.seen += 1
        if len(self.sample) < self.size:
            self.sample[i] = data
        else:
            j = int(self.rng.integers(self.seen))
            if j < self.size:
                del self.sample[sorted(self.sample)[j]]
                self.sample[i] = data
        if steps > self.longest[0]:
            self.longest = (steps, i, data)

    def kept(self) -> Dict[int, bytes]:
        out = dict(self.sample)
        if self.longest[1] >= 0:
            out[self.longest[1]] = self.longest[2]
        return out


def process_age() -> float:
    """Seconds since this process started, from /proc."""
    import os

    with open("/proc/self/stat") as f:
        start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def run_cell(c: cells.Cell, seed: int, seconds: float, traced: bool, device: str,
             trace_dir: Optional[Path] = None) -> Run:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    import zigz_tpu_torch as zt
    from zigz_tpu_torch.prover.serialization import BinarySerializer

    run = Run(cell=c, seed=seed)
    mix, conf = c.mix, c.config
    is_cuda = device.startswith("cuda")

    def sync():
        if is_cuda:
            torch.cuda.synchronize()

    field_ = getattr(zt, conf["field"])
    prover = zt.Prover(field_, seed=seed & ((1 << 64) - 1), device=device,
                       protocol_version=conf["protocol_version"])
    ser = BinarySerializer(field_)
    max_steps = 1 << mix["log2_trace"]
    entry = int.from_bytes(c.guest[0x18:0x20], "little")  # the ELF header's entry point

    warm = cells.inputs(mix, seed, "warmup")
    for _ in range(mix["warmup_proves"]):
        t0 = time.perf_counter()
        ser.serialize(prover.prove(c.guest, entry, None, max_steps, None, [warm.next()]))
        sync()
        run.warmup_s.append(time.perf_counter() - t0)
    estimate = run.warmup_s[-1]

    keep = _Keep(mix["check_sample"], seed)
    order = cells.inputs(mix, seed, "window")
    if is_cuda:
        torch.cuda.reset_peak_memory_stats()
    before = card.counters()
    gc.collect()
    cpu_before = card.process_cpu_s()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if is_cuda else [])
    prof_cm = profile(activities=activities) if traced else contextlib.nullcontext()
    with prof_cm as prof:
        run.setup_s = process_age()
        start = time.perf_counter()
        i = 0
        while i == 0 or time.perf_counter() - start + estimate <= seconds:
            n = order.next()
            try:
                with record_function(f"prove#{i}"):
                    t0 = time.perf_counter()
                    proof = prover.prove(c.guest, entry, None, max_steps, None, [n])
                    sync()
                    t1 = time.perf_counter()
                with record_function(f"serialize#{i}"):
                    data = ser.serialize(proof)
                    t2 = time.perf_counter()
                meta = proof.metadata
                rec = Prove(i, n, meta.num_steps, meta.num_vars, t2 - t0, t2 - t1, numbers(prover.last_timings))
                if meta.num_vars != mix["log2_trace"]:
                    rec.error = f"input {n} gave {meta.num_vars} variables, the mix states {mix['log2_trace']}"
                keep.offer(i, meta.num_steps, data)
                del proof, data
            except Exception as exc:  # a prove that raises is a failed prove; the window goes on
                rec = Prove(i, n, 0, 0, time.perf_counter() - t0, 0.0, {}, error=repr(exc))
            run.proves.append(rec)
            estimate = rec.seconds
            i += 1
        run.window_s = time.perf_counter() - start
    run.cpu_per_s = (card.process_cpu_s() - cpu_before) / run.window_s
    if is_cuda:
        run.memory = {"max_memory_allocated_B": torch.cuda.max_memory_allocated(),
                      "max_memory_reserved_B": torch.cuda.max_memory_reserved()}
    run.counters = card.counter_delta(before, card.counters())
    run.kept = keep.kept()
    if traced:
        trace_dir = Path(trace_dir or cells.REPO / "build" / "proving_bench")
        trace_dir.mkdir(parents=True, exist_ok=True)
        path = trace_dir / "window_trace.json"
        prof.export_chrome_trace(str(path))
        del prof
        try:
            run.trace = traces.summarize(traces.load(path))
        finally:
            path.unlink()
    del prover
    gc.collect()
    if is_cuda:
        torch.cuda.empty_cache()
    return run
