#!/usr/bin/env python3
"""What the prove spans (zigz_tpu_torch/utils/profiling.py) cost a prove.

    python3 scripts/torch_span_cost.py [--device cuda] [--log2-steps 16] [--proves 20]

Times one empty span inside a root of 17 of them, with torch's profiler
off and on, and one empty root; counts the spans of a v1
prove and its serialize (the Fibonacci fixture, sized to
``2^log2_steps``); and times ``--proves`` such proves.  Prints one JSON
line: the cost of one span off and on and of one root (ns), the spans and
roots a prove, the median prove + serialize seconds, and the recorder's
cost a prove, off and on, as a share of that median.  It imports no JAX and
nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def costs(profiling, n: int, k: int = 17):
    """Nanoseconds of one empty root, and of one empty span inside a root
    of ``k`` spans, as a prove's spans are opened: ``n`` roots each."""
    t0 = time.perf_counter_ns()
    for _ in range(n):
        with profiling.root("prove", 0):
            pass
    roots = time.perf_counter_ns() - t0
    t0 = time.perf_counter_ns()
    for _ in range(n):
        with profiling.root("prove", 0):
            for _ in range(k):
                with profiling.span("leaf"):
                    pass
    return roots / n, (time.perf_counter_ns() - t0 - roots) / (n * k)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--log2-steps", type=int, default=16)
    ap.add_argument("--proves", type=int, default=20)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    import zigz_tpu_torch as zt
    from zigz_tpu_torch import elf
    from zigz_tpu_torch.device import resolve_device, synchronize
    from zigz_tpu_torch.prover.serialization import BinarySerializer
    from zigz_tpu_torch.utils import profiling

    top_ns, off_ns = costs(profiling, 20_000)
    with profile(activities=[ProfilerActivity.CPU]):
        _, on_ns = costs(profiling, 2_000)

    with open(os.path.join(ROOT, "tests", "fixtures", "fibonacci_program.bin"), "rb") as f:
        program = f.read()
    loaded = elf.load(program)
    n = ((1 << args.log2_steps) - 13) // 6  # the guest runs 6 n + 13 steps
    device = resolve_device(args.device)
    prover, ser = zt.Prover(zt.BabyBear, device=device), BinarySerializer(zt.BabyBear)
    seconds = []
    for i in range(args.proves + 2):
        t0 = time.perf_counter()
        ser.serialize(prover.prove(program, loaded.entry_pc, None, 1 << args.log2_steps, loaded.segments, [n]))
        synchronize(device)
        if i >= 2:  # two warm-ups
            seconds.append(time.perf_counter() - t0)
    spans = len(prover.last_spans) - 1 + len(ser.last_spans) - 1  # besides the two roots
    prove_s = statistics.median(seconds)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu",
        "span_off_ns": off_ns, "span_on_ns": on_ns, "root_ns": top_ns, "spans_a_prove": spans, "roots_a_prove": 2,
        "num_steps": prover.last_timings["num_steps"], "prove_serialize_s_median": prove_s,
        "off_share_of_prove": (spans * off_ns + 2 * top_ns) * 1e-9 / prove_s,
        "on_share_of_prove": (spans * on_ns + 2 * top_ns) * 1e-9 / prove_s,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
