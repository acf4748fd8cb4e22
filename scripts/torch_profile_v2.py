#!/usr/bin/env python3
"""Where a v2 prove of the PyTorch port spends its time on the card.

    python scripts/torch_profile_v2.py [--log2-steps 20] [--top 12] [--trace-dir DIR]

Needs one CUDA device.  Proves ``2^log2_steps`` NOP steps with
``zigz_tpu_torch``'s ``Prover(BabyBear, device="cuda", protocol_version=2)``
twice: once untraced (the warm-up, whose phase timings are printed), once
under ``torch.profiler`` (``zigz_tpu_torch.utils.profiling.device_trace``,
which leaves the Chrome trace in ``DIR/trace.json``).  Prints the card's nvidia-smi name and power
limit, both runs' phase timings, the traced run's wall time, the sum of the
kernels' device time, the idle share (1 - device time / wall), Z1's device
time and launches (every generated program's kernel), the device time by
kernel name, the count of device zerochecks with the DAG sweep's launches,
and peak device memory.  The profiler slows the host down, so
the idle share of the traced run is an upper bound for an untraced one.
It imports no JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log2-steps", type=int, default=20)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--trace-dir", default=os.path.join("build", "torch_profile_v2"))
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType

    if not torch.cuda.is_available():
        print("torch_profile_v2: a CUDA device is required", file=sys.stderr)
        return 2
    import zigz_tpu_torch as zt
    from zigz_tpu_torch.device import card_info
    from zigz_tpu_torch.lookups import pipeline_lasso
    from zigz_tpu_torch.ops import zerocheck_dev_ext
    from zigz_tpu_torch.utils.profiling import device_trace

    print(card_info()["nvidia_smi"], flush=True)
    program = bytes([0x13, 0x00, 0x00, 0x00]) * (1 << args.log2_steps)
    keys = ("total_s", "zerochecks_s", "dag_build_s", "zerocheck_host_s", "zerocheck_start_s", "advice_build_s",
            "lasso_s", "data_commit_s", "advice_commit_s",
            "batch_eval_s", "open_s", "unified_s", "execute_s", "commitments_s")

    def prove():
        zerocheck_dev_ext.reset_counters()
        pipeline_lasso.DEVICE_ROUNDS["count"] = 0
        torch.cuda.reset_peak_memory_stats()
        prover = zt.Prover(zt.BabyBear, seed=0, device="cuda", protocol_version=2)
        t0 = time.perf_counter()
        prover.prove(program, 0x1000, None, 2 << args.log2_steps, None, None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        t = prover.last_timings
        print(" ".join(f"{k}={t[k]}" for k in keys), flush=True)
        print(f"wall_s={wall} device_zerochecks={zerocheck_dev_ext.DEVICE_PROVES['count']} "
              f"sweep_launches={zerocheck_dev_ext.DEVICE_PROVES['sweep_launches']} "
              f"lasso_device_rounds={pipeline_lasso.DEVICE_ROUNDS['count']} "
              f"peak_device_memory_B={torch.cuda.max_memory_allocated()}", flush=True)
        return wall

    print("untraced:", flush=True)
    prove()
    print("traced:", flush=True)
    with device_trace(args.trace_dir) as prof:
        wall = prove()
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue  # a host op's row repeats the device time of the kernels it launched
        device_us = getattr(ev, "self_device_time_total", None)
        if device_us is None:
            device_us = ev.self_cuda_time_total
        if device_us > 0:
            rows.append((device_us, ev.count, ev.key))
    busy_s = sum(r[0] for r in rows) / 1e6
    if busy_s <= 0:
        print("torch.profiler recorded no device time", file=sys.stderr)
        return 1
    print(f"traced wall_s={wall} device_busy_s={busy_s} idle_share={1 - busy_s / wall}", flush=True)
    z1 = [r for r in rows if "zigz_dag_round_sums_kernel" in r[2]]  # every generated program's kernel
    print(f"z1_device_ms={sum(r[0] for r in z1) / 1e3} z1_launches={sum(r[1] for r in z1)}", flush=True)
    for device_us, count, key in sorted(rows, reverse=True)[: args.top]:
        print(f"  {device_us / 1e3:12.3f} ms  {count:9d} x  {key[:90]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
