"""`Prover.last_timings["lasso_absorb_s"]`, the Lasso id stream and its transcript absorb inside `sumcheck_lasso_s`, the mean a prove over the window."""

from statistics import mean


def read(run):
    values = [p.timings["lasso_absorb_s"] for p in run.good() if "lasso_absorb_s" in p.timings]
    return mean(values) if values else None
