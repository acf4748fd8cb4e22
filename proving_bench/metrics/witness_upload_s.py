"""`Prover.last_timings["witness_upload_s"]`, the host-to-device copies of the packed columns inside `witness_dev_s`, the mean a prove over the window."""

from statistics import mean


def read(run):
    values = [p.timings["witness_upload_s"] for p in run.good() if "witness_upload_s" in p.timings]
    return mean(values) if values else None
