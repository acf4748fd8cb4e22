"""Start n local ranks as subprocesses and collect their results.

The port's counterpart of the JAX package's virtual device mesh and of its
two-process test worker: ``torch.distributed`` runs one process per rank, so
a job of n ranks on one host is n subprocesses
(``python -m zigz_tpu_torch.parallel.launch <job dir> <rank>``), each of
which joins the group through a rendezvous file in the job directory, runs
one named function of parallel/jobs.py on the job's JSON spec, and writes
its result file atomically (temporary name, then rename).  A caller with
rank functions of its own gives ``launch`` the command of a script that
calls :func:`worker_main` with them.

**Fail fast.**  When any rank exits non-zero, or the deadline passes, the
launcher kills the other ranks by the exact PIDs it started, removes every
result file and raises :class:`LaunchFailed`: a job leaves either all of its
results or none.  Proof generation is a pure function of the spec, so the
answer to a lost rank is to launch the whole job again.

    results = launch(2, "prove", {"program": {"kind": "nop", "count": 128}},
                     work_dir=path, device="cpu")

``device="cpu"`` ranks run single-threaded (a host that runs n of them, and
a test suite that runs several jobs, has no cores to spare for torch's own
thread pool); ranks on a card may all name the same card (``"cuda:0"``),
with ``"gloo"`` as the transport.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import List, Optional, Sequence

__all__ = ["launch", "LaunchFailed", "worker_main"]

_POLL_S = 0.05


class LaunchFailed(Exception):
    """A rank failed or the job passed its deadline; nothing is left of it."""


def _paths(work_dir: str, n_ranks: int) -> dict:
    return {
        "job": os.path.join(work_dir, "job.json"),
        "rendezvous": os.path.join(work_dir, "rendezvous"),
        "results": [os.path.join(work_dir, f"result_{r}.json") for r in range(n_ranks)],
        "logs": [os.path.join(work_dir, f"rank_{r}.log") for r in range(n_ranks)],
    }


def _tail(path: str, limit: int = 3000) -> str:
    try:
        with open(path, "rb") as f:
            return f.read()[-limit:].decode("utf-8", "replace")
    except OSError:
        return ""


def launch(n_ranks: int, function: str, spec: dict, *, work_dir: str, device: str = "cuda",
           backend: str = "gloo", timeout_s: float = 600.0,
           command: Optional[Sequence[str]] = None) -> List[dict]:
    """Run ``function`` of parallel/jobs.py on ``spec`` in ``n_ranks``
    subprocesses and return their results in rank order.

    ``command`` replaces ``[python, "-m", "zigz_tpu_torch.parallel.launch"]``
    for a caller that must prepare the interpreter before the package is
    imported, or that has rank functions of its own for
    :func:`worker_main`; the job directory and the rank are appended to
    it."""
    os.makedirs(work_dir, exist_ok=True)
    p = _paths(work_dir, n_ranks)
    for stale in [p["rendezvous"]] + p["results"]:
        if os.path.exists(stale):
            os.unlink(stale)
    with open(p["job"], "w") as f:
        json.dump({
            "function": function, "spec": spec, "world_size": n_ranks, "device": device,
            "backend": backend, "timeout_s": timeout_s,
        }, f)

    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    command = list(command) if command else [sys.executable, "-m", "zigz_tpu_torch.parallel.launch"]
    procs, logs = [], []
    try:
        for rank in range(n_ranks):
            log = open(p["logs"][rank], "wb")
            logs.append(log)
            procs.append(subprocess.Popen(command + [work_dir, str(rank)], env=env,
                                          stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout_s
        why = None
        while why is None:
            rcs = [proc.poll() for proc in procs]
            bad = [r for r, rc in enumerate(rcs) if rc not in (None, 0)]
            if bad:
                why = f"rank {bad[0]} exited with code {rcs[bad[0]]}:\n{_tail(p['logs'][bad[0]])}"
            elif all(rc == 0 for rc in rcs):
                break
            elif time.monotonic() > deadline:
                why = f"the job passed its deadline of {timeout_s} s"
            else:
                time.sleep(_POLL_S)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()  # the exact PID this launcher started, never a pattern
            proc.wait()
        for log in logs:
            log.close()
    missing = [path for path in p["results"] if not os.path.exists(path)]
    if why is None and missing:
        why = f"ranks exited 0 without results: {missing}"
    if why is not None:
        for path in p["results"]:
            if os.path.exists(path):
                os.unlink(path)
        raise LaunchFailed(why)
    results = []
    for path in p["results"]:
        with open(path) as f:
            results.append(json.load(f))
    return results


def worker_main(argv: Sequence[str], functions: Optional[dict] = None) -> None:
    """One rank: join the group, run the job's function, write the result.
    ``functions`` (name -> ``fn(group, spec, work_dir)``) are known to this
    rank beside those of parallel/jobs.py."""
    work_dir, rank = argv[0], int(argv[1])
    with open(os.path.join(work_dir, "job.json")) as f:
        job = json.load(f)
    p = _paths(work_dir, job["world_size"])

    import torch

    if job["device"] == "cpu":
        torch.set_num_threads(1)

    from . import jobs
    from .multihost import initialize, shutdown, sync_hosts

    known = {**jobs.JOBS, **(functions or {})}
    fn = known.get(job["function"])
    if fn is None:
        raise ValueError(f"unknown job function {job['function']!r}: one of {sorted(known)}")
    group = initialize(job["backend"], rank, job["world_size"], device=job["device"],
                       rendezvous_file=p["rendezvous"], timeout_s=job["timeout_s"])
    result = fn(group, job["spec"], work_dir)
    # No rank writes before every rank has its result: a job that fails
    # late leaves no partial results either.
    sync_hosts(group)
    tmp = p["results"][rank] + ".tmp"
    with open(tmp, "w") as f:
        json.dump(result, f)
    os.replace(tmp, p["results"][rank])
    shutdown()


if __name__ == "__main__":
    worker_main(sys.argv[1:])
