"""`Prover.last_timings["lasso_s"]`, the v2 Lasso records (per-table sumchecks), the mean a prove over the window."""

from statistics import mean


def read(run):
    values = [p.timings["lasso_s"] for p in run.good() if "lasso_s" in p.timings]
    return mean(values) if values else None
