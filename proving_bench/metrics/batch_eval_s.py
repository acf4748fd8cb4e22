"""`Prover.last_timings["batch_eval_s"]`, the batch evaluation that folds every claim to one point, the mean a prove over the window."""

from statistics import mean


def read(run):
    values = [p.timings["batch_eval_s"] for p in run.good() if "batch_eval_s" in p.timings]
    return mean(values) if values else None
