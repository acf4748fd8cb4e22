#!/usr/bin/env python3
"""Bench of the PyTorch/CUDA port: prints ONE JSON line, in bench.py's shape.

    python bench_torch.py                  (on the card: the full ladder; needs a CUDA device)
    python bench_torch.py --device cpu --v1 10 --v2 10 --v3 --v4
                                           (a tiny run of the kernels' plain versions)

The twin of bench.py for ``zigz_tpu_torch``: it imports torch, numpy and the
port, never JAX and nothing of ``zigz_tpu``.  It runs on ``--device cuda``
unless ``--device cpu`` is given; without a CUDA device the default run
raises in ``device.resolve_device`` and prints no result.  The last line of
standard output is ``{"metric", "value", "unit", "vs_baseline", "extra"}``;
the line before it is the card's ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` line (on the card); progress goes to standard error.

Stages, in order (each stops early only for the budget, ``--budget-s``; the
stages it skipped are listed in ``extra.skipped_for_budget``):

1. ``host_anchor_s``: a fixed host workload that runs no code of the repo
   (hashlib SHA3-256 of 64 MiB in 1 MiB chunks and a numpy int64
   ``(a * b) % p`` over 2^24 values from seed 0), median of 3 runs.  It is
   timed at the start and at the end and moves with the machine, never with
   the code: the port's spread is host time, as bench.py's was the link's.
2. The headline ``babybear_field_ops_per_s_per_chip`` in ``field_mul/s``:
   ``ops/babybear.mul_chain`` (the CUDA kernel of csrc/field_kernels.cu,
   eight dependent multiplies an element) over 2^22 random lanes: one call
   whose output is held to the plain version, one warm-up, then 20 reps timed
   by CUDA events with the launches queued behind a spin, so that the events
   time the card and not Python's launch rate.  ``extra.torch_int64_mul_per_s`` is the plain int64 torch chain
   on the same card, the rate the prover's torch-op folds get.  On the CPU
   ``value`` is null: no CPU rate goes under the card's metric.
3. The v1 ladder of NOP traces, 2^14 to 2^22 and then 2^24 and 2^25, per
   size in ``extra.v1_ladder``.
4. v2 at 2^16 and 2^20, then v3 and v4 at 2^20, with bench.py's keys
   (``v2_*`` for the first v2 size, ``v<N>_2e<k>_*`` for the others) and the
   device counters.

Every benched proof is held: each pass's proof is serialized outside its
timed window, and its (steps, bytes, sha256) must equal the pin of
zigz_tpu_torch/testdata/proof_digests.json; where nothing is pinned, every
pass must equal the first and the first must verify Accept.  A mismatch
raises: a faster prove with other bytes is another result.

Verbatim from bench.py: the metric name, ``vs_baseline`` (v1 steps/s of the
ladder's last size over 1M steps in 1.5 s), the ladder's walk (a size runs
while one pass is projected under 240 s and 45% of the budget is left), its
early-stop rule, and the v2 keys.  ``mont_vs_raw_mul_ratio`` is dropped: it
asked whether the TPU vector unit's 16-bit-limb Montgomery reduction hides
behind memory (bench.py:14-27); on Hopper a 32 x 32 -> 64 product is one
IMAD.WIDE and the question does not arise.  ``device_link_mbps`` gives way
to ``host_anchor_s`` (the port has no link probe by design).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import resource
import statistics
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
ASPIRATIONAL_STEPS_PER_S = 1_000_000 / 1.5
P = 2013265921
FIELD_REPS = 20
PROJECTED_PASS_LIMIT_S = 240.0
# A stage starts only while this share of the budget is left unspent
# (bench.py: 0.45 for the v1 ladder, 0.7 for v2 past its first size).
BUDGET_SHARE = {1: 0.45, 2: 0.7, 3: 0.8, 4: 0.85}
ANCHOR_CHUNK = 1 << 20
ANCHOR_CHUNKS = 64
ANCHOR_LANES = 1 << 24
# A rep of the chain kernel (~30 us) is shorter than its launch from Python,
# so the timed launches are queued behind a spin of this many clocks (about
# 50 ms at 1.98 GHz): the events then bracket the card's work, not the host's
# launch rate.
QUEUE_SPIN_CYCLES = 100_000_000


class ProofMismatch(AssertionError):
    """A benched proof differs from its pin, or from the run's first pass."""


def log(msg: str) -> None:
    print(f"bench_torch: {msg}", file=sys.stderr, flush=True)


def host_anchor(runs: int = 3) -> float:
    """Median seconds of the fixed host workload (no code of this repo)."""
    rng = np.random.default_rng(0)
    blob = rng.bytes(ANCHOR_CHUNK * ANCHOR_CHUNKS)
    a = rng.integers(0, P, size=ANCHOR_LANES, dtype=np.int64)
    b = rng.integers(0, P, size=ANCHOR_LANES, dtype=np.int64)
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        h = hashlib.sha3_256()
        for k in range(ANCHOR_CHUNKS):
            h.update(blob[k * ANCHOR_CHUNK : (k + 1) * ANCHOR_CHUNK])
        h.digest()
        (a * b) % P
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def queued_event_ms(fn, x, y, reps: int) -> float:
    """ms a rep of ``out = fn(out, y)`` from ``out = x``, by CUDA events
    around ``reps`` launches queued behind a spin (QUEUE_SPIN_CYCLES), after
    one warm-up call."""
    import torch

    fn(x, y)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_SPIN_CYCLES)
    start.record()
    out = x
    for _ in range(reps):
        out = fn(out, y)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bench_field_ops(dev, log2_size: int = 22, reps: int = FIELD_REPS) -> dict:
    """The headline: the multiply-chain kernel's rate on the card, and the
    plain int64 chain's beside it.  The kernel's warm-up output must equal
    the plain version's."""
    import torch

    from zigz_tpu_torch.ops import babybear as bb

    if dev.type != "cuda":
        return {"value": None, "field_ops_note": (
            "the headline is the CUDA kernel's rate on the card; a CPU run has no kernel and reports no rate")}
    size = 1 << log2_size
    rng = np.random.default_rng(0)  # bench.py's inputs
    x = torch.from_numpy(rng.integers(0, P, size=size, dtype=np.uint64).astype(np.int32)).to(dev)
    y = torch.from_numpy(rng.integers(0, P, size=size, dtype=np.uint32).astype(np.int32)).to(dev)

    launches0 = bb.LAUNCHES["mul_chain"]
    if not torch.equal(bb.mul_chain(x, y), bb._mul_chain_plain(x, y)):
        raise ProofMismatch("the multiply-chain kernel differs from its plain version")
    kernel_ms = queued_event_ms(bb.mul_chain, x, y, reps)
    launches = bb.LAUNCHES["mul_chain"] - launches0
    plain_ms = queued_event_ms(bb._mul_chain_plain, x, y, reps)
    muls_a_rep = bb.CHAIN * size
    return {"value": muls_a_rep / kernel_ms * 1e3, "torch_int64_mul_per_s": muls_a_rep / plain_ms * 1e3,
            "field_lanes": size, "field_reps": reps, "field_kernel_ms": kernel_ms, "field_plain_ms": plain_ms,
            "field_kernel_launches": launches}


def _passes(version: int, v: int, first: bool):
    """(passes, early stop) for one size: bench.py's rule below 2^22 v1
    steps (up to 4, stop once a pass is no longer 10% faster than the best),
    5 passes at 2^22, 3 from 2^24; v2 2 passes at its first size and 3 past
    it, v3 and v4 2."""
    if version == 1:
        return (4, True) if v < 22 else ((5, False) if v < 24 else (3, False))
    if version == 2:
        return (2, False) if first else (3, False)
    return 2, False


def _counters_reset() -> None:
    from zigz_tpu_torch.lookups import pipeline_lasso
    from zigz_tpu_torch.ops import keccak, ligero_dev, ntt_dev, poseidon2, zerocheck_dev_ext

    keccak.LAUNCHES.update(leaves=0, merge=0)
    ligero_dev.LAUNCHES.update(columns=0, absorb=0)
    ntt_dev.LAUNCHES.update(dict.fromkeys(ntt_dev.LAUNCHES, 0))
    poseidon2.LAUNCHES.update(leaves=0, merge=0, absorb=0)
    poseidon2.PERMUTATIONS["count"] = 0
    zerocheck_dev_ext.reset_counters()
    pipeline_lasso.DEVICE_ROUNDS["count"] = 0


def _counters(proof, version: int) -> dict:
    from zigz_tpu_torch.lookups import pipeline_lasso
    from zigz_tpu_torch.ops import keccak, ligero_dev, ntt_dev, poseidon2, zerocheck_dev_ext
    from zigz_tpu_torch.proofs.zerocheck import count_zerocheck_proofs

    counts = {"K1": keccak.LAUNCHES["leaves"], "K2": keccak.LAUNCHES["merge"]}
    if version >= 2:
        counts.update({
            "K4": ligero_dev.LAUNCHES["columns"], "K5": ligero_dev.LAUNCHES["absorb"],
            "N1": ntt_dev.LAUNCHES["tile"], "N2": ntt_dev.LAUNCHES["pass"],
            "P1": poseidon2.LAUNCHES["leaves"], "P2": poseidon2.LAUNCHES["merge"],
            "P3": poseidon2.LAUNCHES["absorb"], "p2_permutations": poseidon2.PERMUTATIONS["count"],
            "zerochecks": count_zerocheck_proofs(proof),
            "device_zerochecks": zerocheck_dev_ext.DEVICE_PROVES["count"],
            "sweep_launches": zerocheck_dev_ext.DEVICE_PROVES["sweep_launches"],
            "columns_resident": zerocheck_dev_ext.COLUMNS["resident"],
            "columns_uploaded": zerocheck_dev_ext.COLUMNS["uploaded"],
            "lasso_device_rounds": pipeline_lasso.DEVICE_ROUNDS["count"],
        })
    return counts


def hold(case: str, num_steps: int, digests, pinned: dict, verified) -> str:
    """Hold a size's passes, given as (bytes, sha256) each: equal to the pin
    of ``case`` where there is one, else equal to the first pass, whose
    verdict ``verified`` must be Accept.  Returns how they were held."""
    want = pinned.get(case)
    if want is not None:
        for k, (n_bytes, digest) in enumerate(digests):
            got = (num_steps, n_bytes, digest)
            if got != (want["num_steps"], want["bytes"], want["sha256"]):
                raise ProofMismatch(f"{case} pass {k}: (steps, bytes, sha256) {got} differ from the pin")
        return "pinned"
    if any(d != digests[0] for d in digests[1:]):
        raise ProofMismatch(f"{case}: the passes' proofs differ: {digests}")
    if verified != "Accept":
        raise ProofMismatch(f"{case}: no pin, and the first pass's proof was not accepted: {verified}")
    return "unpinned: every pass equal to the first, which verifies Accept"


def bench_proves(dev, version: int, v: int, first: bool, pinned: dict) -> dict:
    """The passes of one size; every proof is held (``hold``)."""
    import torch

    import zigz_tpu_torch as zt
    from zigz_tpu_torch.verifier.benchmarks import nop_program, timed_prove

    F = zt.BabyBear
    ser = zt.serialization.BinarySerializer(F)
    case = f"v{version}-nop-2^{v}"
    num_steps = 1 << v
    program = nop_program(num_steps)
    prover = zt.Prover(F, seed=0, device=dev, protocol_version=version)
    if dev.type == "cuda":
        torch.cuda.empty_cache()  # so the reserved peak is this size's, not the cache of an earlier one
    max_passes, early_stop = _passes(version, v, first)
    times, digests, peaks, verify_s, verdict, waits = [], [], [], [], None, []
    for k in range(max_passes):
        _counters_reset()
        proof, seconds, peak = timed_prove(prover, program, 2 * num_steps)
        counters = _counters(proof, version)
        if version >= 2:  # the wait on nvcc for Z1's generated kernels (the first pass of a process pays it)
            waits.append({key: prover.last_timings[key] for key in ("dag_build_s", "zerocheck_host_s",
                                                                      "zerocheck_start_s", "zerochecks_s")})
        data = ser.serialize(proof)  # outside the timed window
        digests.append((len(data), hashlib.sha256(data).hexdigest()))
        if proof.metadata.num_steps != num_steps:
            raise ProofMismatch(f"{case}: proved {proof.metadata.num_steps} steps")
        if k == 0 and (version >= 2 or case not in pinned):
            restored = ser.deserialize(data)
            for _ in range(2 if version >= 2 else 1):
                t0 = time.perf_counter()
                verdict = zt.Verifier(F).verify(restored, program)
                verify_s.append(time.perf_counter() - t0)
            del restored
        del proof, data
        times.append(seconds)
        peaks.append(peak)
        log(f"{case} pass {k}: {seconds} s, sha256 {digests[-1][1][:16]}"
            + (" " + " ".join(f"{key}={val}" for key, val in waits[-1].items()) if waits else ""))
        if early_stop and len(times) >= 2 and seconds > 0.9 * min(times[:-1]):
            break
    held = hold(case, num_steps, digests, pinned, verdict)
    timings = prover.last_timings  # the last pass's
    res = {"num_steps": num_steps, "pass_s": times, "median_s": statistics.median(times), "min_s": min(times),
           "steps_per_s": num_steps / min(times), "proof_bytes": digests[0][0], "sha256": digests[0][1],
           "held": held, "verify_s": min(verify_s) if verify_s else None, "counters": counters,
           "timings": timings, "zerocheck_passes": waits, "max_memory_allocated_B": None,
           "max_memory_reserved_B": None}
    if peaks[0] is not None:
        res["max_memory_allocated_B"] = max(p["max_memory_allocated_B"] for p in peaks)
        res["max_memory_reserved_B"] = max(p["max_memory_reserved_B"] for p in peaks)
    return res


def _phase_split(timings: dict) -> dict:
    return {k: v for k, v in timings.items() if k.endswith("_s")}


def _v1_entry(res: dict) -> dict:
    entry = {k: res[k] for k in ("num_steps", "pass_s", "median_s", "min_s", "steps_per_s", "proof_bytes",
                                 "sha256", "held", "verify_s", "max_memory_allocated_B", "max_memory_reserved_B")}
    entry.update(last_timings=_phase_split(res["timings"]), forest_plan=res["timings"].get("forest_plan"),
                 launches=res["counters"])
    return entry


def _proof_keys(version: int, v: int, first: bool, res: dict) -> dict:
    """bench.py's v2 keys: ``v2_*`` for the first v2 size, ``v<N>_2e<k>_*``
    for every other, and the device counters and peaks beside them."""
    timings = {k: val for k, val in res["timings"].items()
               if k.endswith("_s") or k.startswith("advice_dev") or k.endswith("_path")}
    if version == 2 and first:
        p, rate = "v2_", "v2_prover_steps_per_s"
        head = {"v2_num_steps": res["num_steps"]}
    else:
        p = f"v{version}_2e{v}_"
        rate, head = p + "steps_per_s", {}
    return {rate: res["steps_per_s"], **head, p + "pass_s": res["pass_s"], p + "median_s": res["median_s"],
            p + "proof_bytes": res["proof_bytes"], p + "sha256": res["sha256"], p + "held": res["held"],
            p + "verify_s": res["verify_s"], p + "phase_timings_s": timings, p + "counters": res["counters"],
            p + "zerocheck_passes": res["zerocheck_passes"],
            p + "max_memory_allocated_B": res["max_memory_allocated_B"],
            p + "max_memory_reserved_B": res["max_memory_reserved_B"]}


def run(args) -> dict:
    import torch

    from zigz_tpu_torch.device import card_info, resolve_device

    t_start = time.perf_counter()
    dev = resolve_device(args.device)  # "cuda" without a card raises here

    def elapsed() -> float:
        return time.perf_counter() - t_start

    def in_budget(version: int) -> bool:
        return elapsed() < BUDGET_SHARE[version] * args.budget_s

    with open(os.path.join(ROOT, "zigz_tpu_torch", "testdata", "proof_digests.json")) as f:
        pinned = json.load(f)["proofs"]
    cuda_device = None
    if dev.type == "cuda":
        info = card_info()
        if not info["nvidia_smi"]:
            raise RuntimeError(info["nvidia_smi_error"])
        cuda_device = {"nvidia_smi": info["nvidia_smi"], "name": torch.cuda.get_device_name(dev),
                       "count": torch.cuda.device_count(), "cuda": info["cuda"]}
    anchor_start = host_anchor()
    log(f"host anchor {anchor_start} s")
    field = bench_field_ops(dev, args.field_log2)
    log(f"field mul chain: {field}")
    extra = {"backend": dev.type, "torch_version": torch.__version__, "cuda_device": cuda_device,
             "triton": False, "budget_s": args.budget_s}
    extra.update({k: v for k, v in field.items() if k != "value"})
    skipped = []

    ladder, top, steps_per_s = [], None, None
    for i, v in enumerate(args.v1):
        if i and ((1 << v) / steps_per_s > PROJECTED_PASS_LIMIT_S or not in_budget(1)):
            skipped += [f"v1 2^{w}" for w in args.v1[i:]]
            break
        top = bench_proves(dev, 1, v, False, pinned)
        steps_per_s = top["steps_per_s"]
        ladder.append(_v1_entry(top))
    extra["v1_ladder"] = ladder
    if top is not None:
        warm = top["pass_s"][1:] or top["pass_s"]
        extra.update({"prover_steps_per_s": top["steps_per_s"], "prover_num_steps": top["num_steps"],
                      "prover_warm_s": warm,
                      "prover_warm_stddev_s": statistics.stdev(warm) if len(warm) >= 2 else None,
                      "prover_phase_timings_s": _phase_split(top["timings"])})

    for version, sizes in ((2, args.v2), (3, args.v3), (4, args.v4)):
        for i, v in enumerate(sizes):
            first = i == 0 and version == 2
            if not first and not in_budget(version):
                skipped.append(f"v{version} 2^{v}")
                continue
            extra.update(_proof_keys(version, v, first, bench_proves(dev, version, v, first, pinned)))

    extra["host_anchor_s"] = [anchor_start, host_anchor()]
    extra["host_max_rss_B"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024  # Linux reports KiB
    extra["skipped_for_budget"] = skipped
    extra["elapsed_s"] = elapsed()
    return {"metric": "babybear_field_ops_per_s_per_chip", "value": field["value"], "unit": "field_mul/s",
            "vs_baseline": steps_per_s / ASPIRATIONAL_STEPS_PER_S if steps_per_s else None, "extra": extra}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--budget-s", type=float, default=1500.0,
                    help="wall-clock budget; later stages are skipped once their share is spent")
    ap.add_argument("--field-log2", type=int, default=22, help="log2 of the headline's lanes")
    ap.add_argument("--v1", type=int, nargs="*", default=[14, 16, 18, 20, 22, 24, 25],
                    help="log2 NOP steps of the v1 ladder")
    ap.add_argument("--v2", type=int, nargs="*", default=[16, 20], help="log2 NOP steps of the v2 proves")
    ap.add_argument("--v3", type=int, nargs="*", default=[20], help="log2 NOP steps of the v3 proves")
    ap.add_argument("--v4", type=int, nargs="*", default=[20], help="log2 NOP steps of the v4 proves")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="wrap the run in a torch.profiler trace written to DIR/trace.json")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    sys.path.insert(0, ROOT)
    from zigz_tpu_torch.utils.profiling import maybe_trace_env

    with maybe_trace_env(args.trace):
        result = run(args)
    if result["extra"]["cuda_device"]:
        print(result["extra"]["cuda_device"]["nvidia_smi"])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
