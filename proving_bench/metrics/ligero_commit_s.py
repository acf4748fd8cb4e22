"""`Prover.last_timings["data_commit_s"] + ["advice_commit_s"]`, the two Ligero commits of a v2 prove (encode,
column hash, Merkle levels), the mean a prove over the window."""

from statistics import mean


def read(run):
    values = [p.timings["data_commit_s"] + p.timings["advice_commit_s"] for p in run.good()
              if "data_commit_s" in p.timings and "advice_commit_s" in p.timings]
    return mean(values) if values else None
