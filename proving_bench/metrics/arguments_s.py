"""`Prover.last_timings["arguments_s"]`, the host extraction of queries, operands and accesses and the construction of the five v2 arguments, the mean a prove over the window."""

from statistics import mean


def read(run):
    values = [p.timings["arguments_s"] for p in run.good() if "arguments_s" in p.timings]
    return mean(values) if values else None
