"""`Prover.last_timings["witness_pack_s"]`, the host packing of the trace columns inside `witness_dev_s`, the mean a prove over the window."""

from statistics import mean


def read(run):
    values = [p.timings["witness_pack_s"] for p in run.good() if "witness_pack_s" in p.timings]
    return mean(values) if values else None
