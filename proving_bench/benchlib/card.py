"""The card's identity and limits, a fixed host workload, this process's CPU
time, and the program's launch and work counters."""

from __future__ import annotations

import hashlib
import statistics
import subprocess
import time

import numpy as np

P = 2013265921
ANCHOR_CHUNK = 1 << 20
ANCHOR_CHUNKS = 64
ANCHOR_LANES = 1 << 24

# Published peaks of one H100 SXM (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12
SMS = 132
INT32_LANES_PER_SM = 64


def smi() -> dict:
    """name, power limit (W) and max SM clock (MHz) of card 0, by nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader,nounits", "-i", "0"],
        capture_output=True, text=True, timeout=30, check=True,
    ).stdout.strip().splitlines()[0]
    name, power, clock = [x.strip() for x in out.split(",")]
    return {"name": name, "power_limit_w": float(power), "sm_clock_max_mhz": float(clock)}


def int32_per_s(sm_clock_mhz: float) -> float:
    """32-bit integer instructions a second: 132 SMs x 64 INT32 lanes x clock."""
    return SMS * INT32_LANES_PER_SM * sm_clock_mhz * 1e6


def host_anchor(runs: int = 3) -> float:
    """Median seconds of a fixed host workload that runs no code of this
    repository: SHA3-256 of 64 MiB and a numpy (a * b) % p over 2^24 values.
    It moves with the machine, never with the code."""
    rng = np.random.default_rng(0)
    blob = rng.bytes(ANCHOR_CHUNK * ANCHOR_CHUNKS)
    a = rng.integers(0, P, size=ANCHOR_LANES, dtype=np.int64)
    b = rng.integers(0, P, size=ANCHOR_LANES, dtype=np.int64)
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        h = hashlib.sha3_256()
        for k in range(ANCHOR_CHUNKS):
            h.update(blob[k * ANCHOR_CHUNK:(k + 1) * ANCHOR_CHUNK])
        h.digest()
        (a * b) % P
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def process_cpu_s() -> float:
    """This process's CPU seconds so far, user and system, all threads."""
    import resource

    use = resource.getrusage(resource.RUSAGE_SELF)
    return use.ru_utime + use.ru_stime


def counters() -> dict:
    """A copy of the program's launch and work counters."""
    from zigz_tpu_torch.lookups import pipeline_lasso
    from zigz_tpu_torch.ops import keccak, ligero_dev, ntt_dev, poseidon2, zerocheck_dev_ext

    out = {}
    for prefix, table in (("keccak", keccak.LAUNCHES), ("ligero", ligero_dev.LAUNCHES), ("ntt", ntt_dev.LAUNCHES),
                          ("poseidon2", poseidon2.LAUNCHES), ("zerocheck", zerocheck_dev_ext.DEVICE_PROVES),
                          ("zerocheck_columns", zerocheck_dev_ext.COLUMNS),
                          ("lasso_rounds", pipeline_lasso.DEVICE_ROUNDS)):
        for key, value in table.items():
            out[f"{prefix}.{key}"] = value
    return out


def counter_delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}
