"""`Prover.last_timings["sumcheck_lasso_s"]`, the program's own span of that phase,
the mean a prove over the window."""

from statistics import mean


def read(run):
    values = [p.timings["sumcheck_lasso_s"] for p in run.good() if "sumcheck_lasso_s" in p.timings]
    return mean(values) if values else None
