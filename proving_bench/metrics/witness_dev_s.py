"""`Prover.last_timings["witness_dev_s"]`, the program's own span of that phase,
the mean a prove over the window."""

from statistics import mean


def read(run):
    values = [p.timings["witness_dev_s"] for p in run.good() if "witness_dev_s" in p.timings]
    return mean(values) if values else None
