"""Seconds from the process's start to the window's start: imports, the
prover's construction, loading (or the first time, building) the kernels,
and the warm-up proves."""


def read(run):
    return run.setup_s
