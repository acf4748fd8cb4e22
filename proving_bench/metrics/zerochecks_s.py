"""`Prover.last_timings["zerochecks_s"]`, the extension zerochecks of the five arguments, the mean a prove over the window."""

from statistics import mean


def read(run):
    values = [p.timings["zerochecks_s"] for p in run.good() if "zerochecks_s" in p.timings]
    return mean(values) if values else None
