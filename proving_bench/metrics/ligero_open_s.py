"""`Prover.last_timings["open_s"]`, the openings of the DATA and ADVICE commitments at the batch evaluation's
point, the mean a prove over the window."""

from statistics import mean


def read(run):
    values = [p.timings["open_s"] for p in run.good() if "open_s" in p.timings]
    return mean(values) if values else None
