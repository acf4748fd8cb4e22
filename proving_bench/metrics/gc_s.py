"""`Prover.last_timings["gc_s"]`, Python's garbage collection inside the prove, the mean a prove over the window."""

from statistics import mean


def read(run):
    values = [p.timings["gc_s"] for p in run.good() if "gc_s" in p.timings]
    return mean(values) if values else None
