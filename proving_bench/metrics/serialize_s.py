"""Seconds a prove spends serializing its proof (the benchmark's own span
around `BinarySerializer.serialize`), the mean over the window."""

from statistics import mean


def read(run):
    values = [p.serialize_s for p in run.good()]
    return mean(values) if values else None
