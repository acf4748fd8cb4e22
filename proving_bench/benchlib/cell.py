"""A cell of BENCHMARK.json and everything it names, found by name.

A cell names a configuration (`configs/<config>.json` beside this package,
via the `file` of its BENCHMARK.json entry) and a traffic mix
(`traffic/<mix>.json`). A per-layer metric is `metrics/<metric>.py`, a
kernel group's work count `work/<group>.py`. Adding any of them is adding a
file and an entry; nothing here names one. A quantity split between cells
that report different end-to-end metrics keeps its name up to the first dot
(`serialize_s.short`), and is read by `metrics/<that name>.py` unless a file
of the whole name is there.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

import numpy as np

BENCH_DIR = Path(__file__).resolve().parent.parent  # proving_bench/
REPO = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: List[dict]  # the metrics this cell reports with --trace 0
    per_layer: List[dict]  # ... with --trace 1
    guest: bytes


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(workload: str, bench_file: Optional[Path] = None) -> Cell:
    bench_file = bench_file or REPO / "BENCHMARK.json"
    bench = json.loads(bench_file.read_text())
    root = bench_file.parent
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in {bench_file}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = json.loads((root / conf["file"]).read_text())
    mix = json.loads((BENCH_DIR / "traffic" / f"{entry['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if m["moves"] in moved and _reports(m, workload)]
    guest = (BENCH_DIR / "guests" / mix["guest"]).read_bytes()
    return Cell(workload, entry["chips"], config, mix, e2e, layer, guest)


def _module(kind: str, name: str):
    path = BENCH_DIR / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"proving_bench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """`read(run) -> float | None` of metrics/<name>.py, or of the file of
    the name up to its first dot where there is none of the whole name."""
    if not (BENCH_DIR / "metrics" / f"{name}.py").exists():
        name = name.split(".")[0]
    return _module("metrics", name).read


def work(group: str):
    """The module of work/<group>.py."""
    return _module("work", group)


def inputs(mix: dict, seed: int, stream: str) -> "Inputs":
    """The guest inputs a run proves, from its seed: a seeded order of the
    mix's grid of inputs, the same set for every seed. `stream` keeps the
    warm-up's draws apart from the window's."""
    lo, hi, points = mix["input"]["min"], mix["input"]["max"], mix["input"]["grid"]
    grid = np.unique(np.linspace(lo, hi, points).round().astype(np.int64))
    salt = {"warmup": 1, "window": 2}[stream]
    rng = np.random.default_rng([seed & ((1 << 64) - 1), seed >> 64 & ((1 << 64) - 1), salt])
    return Inputs([int(x) for x in rng.permutation(grid)])


class Inputs:
    """Cycles through a seeded order of the grid."""

    def __init__(self, order: List[int]):
        self.order = order
        self.i = 0

    def next(self) -> int:
        n = self.order[self.i % len(self.order)]
        self.i += 1
        return n


def steps_for(mix: dict, n: int) -> int:
    """The guest's step count for input n, as the mix states it (a n + b)."""
    a, b = mix["steps_per_input"]
    return a * n + b
