"""`Prover.last_timings["data_build_s"]`, the five arguments' DATA phases (their challenge-independent columns), before the DATA commit, the mean a prove over the window."""

from statistics import mean


def read(run):
    values = [p.timings["data_build_s"] for p in run.good() if "data_build_s" in p.timings]
    return mean(values) if values else None
