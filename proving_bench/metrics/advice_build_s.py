"""`Prover.last_timings["advice_build_s"]`, the five arguments' ADVICE phases (challenges, logUp inverse columns, sums), less the early start of their zerochecks, the mean a prove over the window."""

from statistics import mean


def read(run):
    values = [p.timings["advice_build_s"] for p in run.good() if "advice_build_s" in p.timings]
    return mean(values) if values else None
