#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's v1 prover on one NVIDIA GPU and check it.

    python3 chip_smoke.py        (from the root of a checkout; needs one CUDA device)

Phases; any failure raises, so the script exits non-zero before the last line:

  0. the card: nvidia-smi name and power limit, torch and CUDA versions.
     Without a CUDA device the script exits 2 and prints no result.
  1. build the CUDA kernels from zigz_tpu_torch/csrc/ (nvcc, sm_90a).
  2. each kernel against its plain PyTorch version on the card: K1 on
     43 * 2^20 random canonical values (the leaf level of a 2^20-step
     forest), K2 on the 43 * 2^19 pairs of that level, ragged sizes 1, 255
     and 4097 with the edge values 0, p - 1 and 2^64 - 1, and a hashlib
     check of a sample.  Digests must agree to the byte (tolerance 0).
     Kernel and plain times are taken with CUDA events at those shapes.
  3. the port's v1 proof bytes equal tests/fixtures/{nop4,add,fibonacci}_v1.bin.
  4. at 2^16 and 2^20 NOP steps and for the fibonacci guest (about 2^20
     steps), the port's proof bytes equal zigz_tpu's host-path proof bytes
     (sha256), and every proof verifies Accept.
  5. the main path: Prover(BabyBear, device="cuda").prove at 2^22 NOP steps,
     twice, each verified Accept and compared with zigz_tpu's host-path
     proof; phase timings, steps/s and peak device memory.

The kernel launch counters are reset before each prove and must be > 0
after it; those of the first 2^22 prove go into the kernel line.  The last
three lines are the kernel JSON line, the card's nvidia-smi line and the
result line {"ok": true, "device": {...}}.

The reference proofs come from zigz_tpu's host path (the native VM and C++
SHA3 forest), which loads no JAX; this script blocks ``jax`` from import,
so neither the port nor the reference can reach it.
"""

import hashlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.modules["jax"] = None  # any import of jax now raises ImportError

P = 2013265921
NOP = bytes([0x13, 0x00, 0x00, 0x00])
FIB_TAPE = [150_000]  # 5 steps per iteration: about 2^19.5 steps, v = 20


def log(msg: str) -> None:
    print(msg, flush=True)


def sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; an NVIDIA GPU is required",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import zigz_tpu_torch as zt
    from zigz_tpu_torch.device import card_info
    from zigz_tpu_torch.ops import _build, keccak
    from zigz_tpu_torch.prover.prover import ReferenceProver

    F = zt.BabyBear
    dev = torch.device("cuda", 0)
    ser = zt.serialization.BinarySerializer(F)

    # -- phase 0: the card -------------------------------------------------
    info = card_info()
    if not info["nvidia_smi"]:
        raise RuntimeError(info["nvidia_smi_error"])
    log(f"phase 0 card: {info['nvidia_smi']} | torch {info['torch']} cuda {info['cuda']} "
        f"| devices {info['device_count']} | nvcc {info['nvcc']}")

    # -- phase 1: build ----------------------------------------------------
    t0 = time.perf_counter()
    kernels = _build.load()
    log(f"phase 1 build: {time.perf_counter() - t0:.3f} s (nvcc {kernels.build_s:.3f} s) -> "
        f"{os.path.relpath(kernels.path, ROOT)}")
    for line in kernels.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")

    # -- phase 2: kernels against their plain versions ---------------------
    gen = torch.Generator(device=dev).manual_seed(0)

    def byte_err(a, b) -> int:
        return int((a.view(torch.uint8).to(torch.int16) - b.view(torch.uint8).to(torch.int16)).abs().max())

    def event_ms(fn, x, reps) -> float:
        fn(x)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn(x)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def edge_values(n):
        vals = torch.randint(0, P, (n,), device=dev, dtype=torch.int64, generator=gen)
        edge = torch.tensor([0, P - 1, -1], device=dev, dtype=torch.int64)[:n]  # -1 = 2^64 - 1
        vals[: edge.numel()] = edge
        return vals

    def check_hashlib(name, digests, messages, idx):
        """Digests at ``idx`` against hashlib of the messages: one u64 value
        (8 bytes, little-endian) or eight lanes (64 bytes) per row."""
        for got, msg in zip(digests[idx].cpu(), messages[idx].cpu()):
            data = msg.numpy().tobytes() if msg.dim() else (int(msg) % (1 << 64)).to_bytes(8, "little")
            if got.numpy().tobytes() != hashlib.sha3_256(data).digest():
                raise AssertionError(f"{name}: a digest differs from hashlib")

    results = {}
    leaves_in = edge_values(43 << 20)
    leaves_out = keccak.sha3_leaves(leaves_in)
    err = byte_err(leaves_out, keccak._sha3_leaves_plain(leaves_in))
    sample = torch.randint(0, leaves_in.numel(), (64,), generator=gen, device=dev)
    check_hashlib("K1", leaves_out, leaves_in, torch.cat([torch.arange(3, device=dev), sample]))
    merge_in = leaves_out.view(-1, 8)
    merge_out = keccak.sha3_merge(merge_in)
    merge_err = byte_err(merge_out, keccak._sha3_merge_plain(merge_in))
    check_hashlib("K2", merge_out, merge_in, sample // 2)
    for n in (1, 255, 4097):
        vals = edge_values(n)
        got = keccak.sha3_leaves(vals)
        err = max(err, byte_err(got, keccak._sha3_leaves_plain(vals)))
        check_hashlib(f"K1 n={n}", got, vals, torch.arange(n, device=dev))
        msg = torch.randint(-(1 << 63), (1 << 63) - 1, (n, 8), device=dev, dtype=torch.int64, generator=gen)
        got = keccak.sha3_merge(msg)
        merge_err = max(merge_err, byte_err(got, keccak._sha3_merge_plain(msg)))
        check_hashlib(f"K2 n={n}", got, msg, torch.arange(n, device=dev))
    if err or merge_err:
        raise AssertionError(f"kernels disagree with their plain versions: K1 {err}, K2 {merge_err}")
    results["leaves"] = dict(max_abs_err=err, shape=f"({43 << 20},) -> ({43 << 20}, 4)",
                             ms=event_ms(keccak.sha3_leaves, leaves_in, 20),
                             plain_ms=event_ms(keccak._sha3_leaves_plain, leaves_in, 2))
    results["merge"] = dict(max_abs_err=merge_err, shape=f"({43 << 19}, 8) -> ({43 << 19}, 4)",
                            ms=event_ms(keccak.sha3_merge, merge_in, 20),
                            plain_ms=event_ms(keccak._sha3_merge_plain, merge_in, 2))
    for name, r in results.items():
        log(f"phase 2 {name}: kernel == plain == hashlib (max byte err {r['max_abs_err']}); "
            f"{r['shape']}: kernel {r['ms']} ms, plain {r['plain_ms']} ms")
    del leaves_in, leaves_out, merge_in, merge_out
    torch.cuda.empty_cache()

    # -- proves ------------------------------------------------------------
    def port_prove(program, entry, segments, tape, max_steps):
        keccak.LAUNCHES.update(leaves=0, merge=0)
        prover = zt.Prover(F, seed=0, device=dev)
        proof = prover.prove(program, entry, None, max_steps, segments, tape)
        counts = dict(keccak.LAUNCHES)
        if proof.metadata.num_steps > 1 and not (counts["leaves"] > 0 and counts["merge"] > 0):
            raise AssertionError(f"the prove did not launch both kernels: {counts}")
        if proof.metadata.num_steps >= 1 << 20 and not prover.use_native_vm:
            raise AssertionError("the native VM is required at 2^20 steps and above")
        data = ser.serialize(proof)
        verdict = zt.Verifier(F).verify(ser.deserialize(data), program)
        if verdict != "Accept":
            raise AssertionError(f"the port's proof was rejected: {verdict}")
        return data, prover, counts

    def reference_prove(program, entry, segments, tape, max_steps):
        os.environ["ZIGZ_TPU_COMMITMENTS"] = "host"
        try:
            t0 = time.perf_counter()
            proof = ReferenceProver(F, seed=0).prove(program, entry, None, max_steps, segments, tape)
            return ser.serialize(proof), time.perf_counter() - t0
        finally:
            del os.environ["ZIGZ_TPU_COMMITMENTS"]

    def timings(prover) -> str:
        t = prover.last_timings
        keys = ("total_s", "execute_s", "witness_dev_s", "forest_s", "evals_s", "opens_s",
                "sumcheck_lasso_s", "commitments_s")
        return " ".join(f"{k}={t[k]}" for k in keys) + f" steps_per_s={t['num_steps'] / t['total_s']}"

    # -- phase 3: golden fixtures -----------------------------------------
    fixtures = os.path.join(ROOT, "tests", "fixtures")
    for name, tape in (("nop4", None), ("add", None), ("fibonacci", [10])):
        with open(os.path.join(fixtures, f"{name}_program.bin"), "rb") as f:
            program = f.read()
        with open(os.path.join(fixtures, f"{name}_v1.bin"), "rb") as f:
            golden = f.read()
        entry, segments = 0x1000, None
        if zt.elf.is_elf(program):
            loaded = zt.elf.load(program)
            entry, segments = loaded.entry_pc, loaded.segments
        data, prover, counts = port_prove(program, entry, segments, tape, 1 << 16)
        if data != golden:
            raise AssertionError(f"{name}: port proof bytes differ from {name}_v1.bin")
        log(f"phase 3 {name}: bytes == {name}_v1.bin ({len(data)} B), Accept, launches {counts}")

    # -- phase 4: against zigz_tpu's host path -----------------------------
    with open(os.path.join(fixtures, "fibonacci_program.bin"), "rb") as f:
        fib = f.read()
    fib_loaded = zt.elf.load(fib)
    cases = [
        ("nop 2^16", NOP * (1 << 16), 0x1000, None, None, 1 << 17),
        ("nop 2^20", NOP * (1 << 20), 0x1000, None, None, 1 << 21),
        (f"fibonacci tape={FIB_TAPE}", fib, fib_loaded.entry_pc, fib_loaded.segments, FIB_TAPE, 1 << 21),
    ]
    for label, program, entry, segments, tape, max_steps in cases:
        data, prover, counts = port_prove(program, entry, segments, tape, max_steps)
        ref, ref_s = reference_prove(program, entry, segments, tape, max_steps)
        if sha(data) != sha(ref):
            raise AssertionError(f"{label}: port proof differs from zigz_tpu's")
        log(f"phase 4 {label}: steps {prover.last_timings['num_steps']} sha256 {sha(data)[:16]} == zigz_tpu "
            f"(host path {ref_s} s), {len(data)} B, Accept, launches {counts}")
        log(f"  port timings: {timings(prover)}")

    # -- phase 5: the main path at 2^22 steps ------------------------------
    n = 1 << 22
    program = NOP * n
    main_counts = None
    for rep in range(2):
        torch.cuda.reset_peak_memory_stats(dev)
        data, prover, counts = port_prove(program, 0x1000, None, None, 2 * n)
        main_counts = main_counts or counts
        log(f"phase 5 nop 2^22 pass {rep}: sha256 {sha(data)[:16]} {len(data)} B, Accept, launches {counts}, "
            f"peak device memory {torch.cuda.max_memory_allocated(dev)} B")
        log(f"  port timings: {timings(prover)}")
    ref, ref_s = reference_prove(program, 0x1000, None, None, 2 * n)
    if sha(data) != sha(ref):
        raise AssertionError("nop 2^22: port proof differs from zigz_tpu's")
    log(f"phase 5 nop 2^22: sha256 == zigz_tpu (host path {ref_s} s)")

    # -- the contract's lines ----------------------------------------------
    source = "zigz_tpu_torch/csrc/sha3_kernels.cu"
    kernels_line = {"kernels": [
        {"name": "sha3_leaves (K1)", "route": "cuda", "source": source,
         "replaces": "zigz_tpu/ops/keccak_pallas.py:93", "launches": main_counts["leaves"],
         "max_abs_err": results["leaves"]["max_abs_err"], "ms": results["leaves"]["ms"],
         "plain_ms": results["leaves"]["plain_ms"]},
        {"name": "sha3_merge (K2)", "route": "cuda", "source": source,
         "replaces": "zigz_tpu/ops/keccak_pallas.py:108", "launches": main_counts["merge"],
         "max_abs_err": results["merge"]["max_abs_err"], "ms": results["merge"]["ms"],
         "plain_ms": results["merge"]["plain_ms"]},
    ]}
    log(json.dumps(kernels_line))
    log(info["nvidia_smi"])
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
