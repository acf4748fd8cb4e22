"""Shared set-up of the benchmark's CPU tests: the import path, and a cell
cut to a tiny Fibonacci input that a CPU prove takes in well under a second."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
REPO = BENCH.parent
for path in (str(BENCH), str(REPO)):
    if path not in sys.path:
        sys.path.insert(0, path)

from benchlib import cell  # noqa: E402

SEED = 2**40 + 12345  # larger than 32 bits, as the driver's are
TINY = {"input": {"min": 10, "max": 19, "grid": 8}, "log2_trace": 7, "warmup_proves": 1, "check_sample": 2}


def tiny_cell(workload: str):
    """The workload's cell, its inputs cut to n in [10, 19] (73-127 steps)."""
    c = cell.load(workload)
    c.mix = dict(c.mix, **TINY)
    return c
