#!/usr/bin/env python3
"""One run of one cell of the zigz_tpu_torch prover benchmark.

    python3 proving_bench/run.py --workload v1-fib-2e16 --seed 7 --seconds 10 --trace 0

Builds one prover, warms it up at the cell's size, proves the seed's inputs
back to back for `--seconds`, compares a seeded sample of the proofs (and
the longest) with the plain reference in `reference/`, and prints one JSON
object as the last line of standard output: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with `--trace 1` its
per-layer metrics from a profiled window), `device`, with `--trace 1` a
`breakdown`, and last `compared`, each number compared beside its limit
(also the last lines of standard error). Earlier lines carry the card's
name, power limit and max SM clock, a fixed host workload's seconds, the
process's CPU seconds a second of window, the program's launch counters
and the window's peak device memory. The host's thread pools are held to one thread.

It needs CUDA and as many cards as the cell asks for; without them it exits
with 2 and prints no result. It exits with another code than 0, and prints
no result, if a module of JAX or of the JAX package is loaded once the
window has closed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "zigz_tpu")  # top-level module names, compared whole
HOST_THREADS = 1


def forbidden_modules(modules=None) -> list:
    names = {name.split(".")[0] for name in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def steady_host() -> None:
    """One thread in every host thread pool (OpenMP, BLAS, torch's intra-
    and inter-op pools), so that a run does its host work the same way on a
    machine of any core count. Call before torch is imported."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = str(HOST_THREADS)
    import torch

    torch.set_num_threads(HOST_THREADS)
    torch.set_num_interop_threads(HOST_THREADS)


def drive(c, seed: int, seconds: float, traced: bool, device: str):
    """Run the cell and judge it: (result, earlier lines, compared numbers).
    Does not look for a card: `main` does."""
    import torch

    from benchlib import card, cell, judge, window

    run = window.run_cell(c, seed, seconds, traced, device)
    is_cuda = device.startswith("cuda")
    run.card = card.smi() if is_cuda else {"name": "cpu", "power_limit_w": None, "sm_clock_max_mhz": None}
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of JAX or the JAX package loaded: {found}")
    anchor = card.host_anchor()

    metrics = {}
    for m in (c.per_layer if traced else c.end_to_end):
        value = cell.metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    inputs = {p.i: p.n for p in run.proves}
    t0 = time.perf_counter()
    numbers, bad = judge.judge(run.kept, inputs, c.guest, 1 << c.mix["log2_trace"], c.config["modulus"], device)
    early = [{"card": run.card, "host_anchor_s": anchor, "cpu_per_s": run.cpu_per_s},
             {"counters": run.counters, "memory": run.memory, "proves": len(run.proves), "warmup_s": run.warmup_s,
              "reference_s": time.perf_counter() - t0, "checked": sorted(run.kept),
              "errors": [p.error for p in run.proves if p.error][:5]}]
    failed = sum(p.error is not None for p in run.proves) + len(bad - {p.i for p in run.proves if p.error})
    dev = {"platform": "gpu" if is_cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if is_cuda else "cpu",
           "count": c.chips,
           "memory_peak_bytes": run.memory.get("max_memory_reserved_B", 0)}
    result = {"correct": judge.verdict(numbers) and failed == 0, "attempted": len(run.proves),
              "failed": failed, "metrics": metrics, "device": dev}
    if traced and run.trace is not None:
        from benchlib import trace

        dev["busy_s"], dev["window_s"] = run.trace.busy_s, run.trace.window_s
        result["breakdown"] = {"device_ops": [list(x) for x in trace.top_ops(run.trace)],
                               "idle_gaps": [list(x) for x in run.trace.gaps]}
    result["compared"] = {k: {"value": v, "limit": judge.LIMITS[k]} for k, v in numbers.items()}
    return result, early, numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(HERE), str(REPO)]
    steady_host()

    import torch

    from benchlib import cell, judge

    c = cell.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
        print(f"{c.name} needs {c.chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result, early, numbers = drive(c, args.seed, args.seconds, bool(args.trace), "cuda")
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package loaded: {found}", file=sys.stderr)
        return 3
    for line in early:
        print(json.dumps(line))
    print(json.dumps(result), flush=True)
    print("\n".join(judge.lines(numbers)), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
