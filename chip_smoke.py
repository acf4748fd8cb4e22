#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's v1 and v2 provers on one NVIDIA GPU and check them.

    python3 chip_smoke.py        (from the root of a checkout; needs one CUDA device)

Phases, in order; any failure raises, so the script exits non-zero before
the last line:

  0. the card: nvidia-smi name and power limit, torch and CUDA versions.
     Without a CUDA device the script exits 2 and prints no result.
  1. build the CUDA kernels from zigz_tpu_torch/csrc/ (one nvcc per unit,
     all started together, sm_90a).
  2. each kernel against its plain PyTorch version on the card, digests
     equal to the byte (tolerance 0), kernel and plain times by CUDA events:
     K1 on 43 * 2^20 random canonical values (the leaf level of a
     2^20-step forest) and K2 on the 43 * 2^19 pairs of that level, with
     ragged sizes 1, 255 and 4097 and the edge values 0, p - 1 and
     2^64 - 1; K5 on one full 544-row stream block at n_e = 2^19 (the
     2^20 v2 DATA commit's width) from a random carried state; K4 on
     688 x 2^19 (``ligero_commit_device`` of the 43 witness MLEs at 2^20);
     K4 and K5 (driven over the raw rows) at 1, 255 and 4097 columns times
     1, 33, 34, 543, 544 and 545 rows with the values 0 and p - 1.
     A hashlib check of a sample for every kernel, and the time of the
     Reed-Solomon encode of one 544-row block (torch ops, 2^16 -> 2^19).
  3. the port's v1 proof bytes equal tests/fixtures/{nop4,add,fibonacci}_v1.bin.
  4. at 2^16 and 2^20 NOP steps and for the fibonacci guest (about 2^20
     steps), the port's v1 proof bytes equal zigz_tpu's host-path proof
     bytes (sha256), and every proof verifies Accept.
  5. the v1 main path: Prover(BabyBear, device="cuda").prove at 2^22 NOP
     steps, once, verified Accept and compared with zigz_tpu's host-path
     proof; phase timings, steps/s and peak device memory.
  6. the v2 main path: Prover(BabyBear, device="cuda", protocol_version=2)
     at 2^16 NOP steps, for the fibonacci guest with a small tape, and at
     2^20 NOP steps, each sha256-equal to zigz_tpu's host-path v2 proof and
     verified Accept; phase timings, both commit paths (must be
     "stream-dev"), peak device memory and the K1/K2/K5 launches.
  7. ``ligero_commit_device`` of 43 random MLEs at 2^18: root, leaf digests
     and levels equal zigz_tpu's host ``ligero_commit`` of the same columns.

The kernel launch counters are reset before each prove or commit and must
be > 0 after it; the kernel line takes K1/K2's from phase 5, K5's from the
2^20 prove of phase 6 and K4's from phase 7.  The last three lines are the
kernel JSON line, the card's nvidia-smi line and the result line
{"ok": true, "device": {...}}.

The reference proofs come from zigz_tpu's host path (the native VM, the
C++ SHA3 forest, the C++ NTT and column hashing), which loads no JAX; this
script blocks ``jax`` from import, so neither the port nor the reference
can reach it.  zigz_tpu's v2 host path reaches zigz_tpu.ops, which the port
makes importable without JAX (zigz_tpu_torch/_jaxfree.py).
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
FIB_TAPE_V2 = [10_000]  # about 2^15.6 steps, v = 16
V2_DATA_ROWS = 2130  # rows of the 2^20 v2 DATA commit, n = 2^16, n_e = 2^19


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
    from zigz_tpu.commitments.ligero import ligero_commit
    from zigz_tpu_torch.ops import _build, keccak, ligero_dev, ntt_dev
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
    del leaves_in, leaves_out, merge_in, merge_out
    torch.cuda.empty_cache()

    def words(r, n):
        """(r, n) random canonical int32 message words; the first two are
        0 and p - 1."""
        w = torch.randint(0, P, (r, n), device=dev, dtype=torch.int32, generator=gen)
        edge = torch.tensor([0, P - 1], device=dev, dtype=torch.int32)[: min(2, w.numel())]
        w.view(-1)[: edge.numel()] = edge
        return w

    def check_columns(name, digests, mat, cols):
        """Digests of columns ``cols`` against hashlib of their words, little-endian."""
        for j in cols:
            col = mat[:, j].cpu().numpy().astype("<u4").tobytes()
            if digests[j].cpu().numpy().tobytes() != hashlib.sha3_256(col).digest():
                raise AssertionError(f"{name}: the digest of column {j} differs from hashlib")

    def stream_raw(mat):
        """K5 over the raw rows of ``mat``, in the streamed commit's blocks."""
        r, n = mat.shape
        state = torch.zeros((25, n), dtype=torch.int64, device=dev)
        for k0, live, nb in ligero_dev._stream_blocks(r):
            ligero_dev.sha3_absorb(state, mat[k0 : k0 + live], k0, nb, r)
        return state[:4].t().contiguous()

    n_e = 1 << 19
    state0 = torch.randint(-(1 << 63), (1 << 63) - 1, (25, n_e), device=dev, dtype=torch.int64, generator=gen)
    block = words(544, n_e)
    absorbed = ligero_dev.sha3_absorb(state0.clone(), block, 0, 16, V2_DATA_ROWS)
    absorb_err = byte_err(absorbed, ligero_dev._sha3_absorb_plain(state0.clone(), block, 0, 16, V2_DATA_ROWS))
    scratch = state0.clone()
    results["absorb"] = dict(
        max_abs_err=absorb_err, shape=f"state (25, {n_e}) + (544, {n_e}) words, 16 rate blocks",
        ms=event_ms(lambda s: ligero_dev.sha3_absorb(s, block, 0, 16, V2_DATA_ROWS), scratch, 20),
        plain_ms=event_ms(lambda s: ligero_dev._sha3_absorb_plain(s, block, 0, 16, V2_DATA_ROWS), scratch, 2))
    del state0, absorbed, scratch, block

    mat = words(688, n_e)
    columns_out = ligero_dev.sha3_columns(mat)
    columns_err = byte_err(columns_out, ligero_dev._sha3_columns_plain(mat))
    check_columns("K4", columns_out, mat, [0, 1, n_e - 1, *sample[:8].remainder(n_e).tolist()])
    results["columns"] = dict(
        max_abs_err=columns_err, shape=f"(688, {n_e}) -> ({n_e}, 4)",
        ms=event_ms(ligero_dev.sha3_columns, mat, 10),
        plain_ms=event_ms(ligero_dev._sha3_columns_plain, mat, 2))
    del mat, columns_out

    for n in (1, 255, 4097):
        for r in (1, 33, 34, 543, 544, 545):
            mat = words(r, n)
            plain = ligero_dev._sha3_columns_plain(mat)
            columns_err = max(columns_err, byte_err(ligero_dev.sha3_columns(mat), plain))
            absorb_err = max(absorb_err, byte_err(stream_raw(mat), plain))
            check_columns(f"K4/K5 ({r}, {n})", plain, mat, sorted({0, n - 1}))
    results["columns"]["max_abs_err"] = columns_err
    results["absorb"]["max_abs_err"] = absorb_err
    if columns_err or absorb_err:
        raise AssertionError(f"kernels disagree with their plain versions: K4 {columns_err}, K5 {absorb_err}")
    for name, r in results.items():
        log(f"phase 2 {name}: kernel == plain == hashlib (max byte err {r['max_abs_err']}); "
            f"{r['shape']}: kernel {r['ms']} ms, plain {r['plain_ms']} ms")
    coeffs = words(544, 1 << 16)
    log(f"phase 2 encode: (544, {1 << 16}) -> (544, {n_e}) in "
        f"{event_ms(lambda m: ntt_dev.encode_rows(m, n_e), coeffs, 5)} ms (torch ops)")
    del coeffs
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

    # -- phase 5: the v1 main path at 2^22 steps ---------------------------
    n = 1 << 22
    program = NOP * n
    torch.cuda.reset_peak_memory_stats(dev)
    data, prover, main_counts = port_prove(program, 0x1000, None, None, 2 * n)
    log(f"phase 5 nop 2^22: sha256 {sha(data)[:16]} {len(data)} B, Accept, launches {main_counts}, "
        f"peak device memory {torch.cuda.max_memory_allocated(dev)} B")
    log(f"  port timings: {timings(prover)}")
    ref, ref_s = reference_prove(program, 0x1000, None, None, 2 * n)
    if sha(data) != sha(ref):
        raise AssertionError("nop 2^22: port proof differs from zigz_tpu's")
    log(f"phase 5 nop 2^22: sha256 == zigz_tpu (host path {ref_s} s)")
    del data, ref

    # -- phase 6: the v2 main path ------------------------------------------
    def port_prove_v2(program, entry, segments, tape, max_steps):
        keccak.LAUNCHES.update(leaves=0, merge=0)
        ligero_dev.LAUNCHES.update(columns=0, absorb=0)
        torch.cuda.reset_peak_memory_stats(dev)
        prover = zt.Prover(F, seed=0, device=dev, protocol_version=2)
        proof = prover.prove(program, entry, None, max_steps, segments, tape)
        counts = {**keccak.LAUNCHES, "absorb": ligero_dev.LAUNCHES["absorb"]}
        if not all(counts.values()):
            raise AssertionError(f"the v2 prove did not launch K1, K2 and K5: {counts}")
        paths = (prover.last_timings["data_commit_path"], prover.last_timings["advice_commit_path"])
        if paths != ("stream-dev", "stream-dev"):
            raise AssertionError(f"the v2 commits did not take the device path: {paths}")
        data = ser.serialize(proof)
        verdict = zt.Verifier(F).verify(ser.deserialize(data), program)
        if verdict != "Accept":
            raise AssertionError(f"the port's v2 proof was rejected: {verdict}")
        return data, prover, counts, torch.cuda.max_memory_allocated(dev)

    def reference_prove_v2(program, entry, segments, tape, max_steps):
        os.environ["ZIGZ_TPU_COMMITMENTS"] = "host"
        try:
            t0 = time.perf_counter()
            proof = ReferenceProver(F, seed=0, protocol_version=2).prove(
                program, entry, None, max_steps, segments, tape)
            return ser.serialize(proof), time.perf_counter() - t0
        finally:
            del os.environ["ZIGZ_TPU_COMMITMENTS"]

    v2_keys = ("total_s", "execute_s", "data_commit_s", "data_assemble_s", "data_upload_s",
               "data_stream_s", "data_levels_s", "advice_build_s", "advice_commit_s",
               "advice_assemble_s", "advice_upload_s", "advice_stream_s", "advice_levels_s",
               "zerochecks_s", "batch_eval_s", "open_s", "unified_s", "lasso_s", "witness_dev_s",
               "forest_s", "evals_s", "opens_s", "commitments_s")
    v2_cases = [
        ("nop 2^16", NOP * (1 << 16), 0x1000, None, None, 1 << 17),
        (f"fibonacci tape={FIB_TAPE_V2}", fib, fib_loaded.entry_pc, fib_loaded.segments, FIB_TAPE_V2, 1 << 17),
        ("nop 2^20", NOP * (1 << 20), 0x1000, None, None, 1 << 21),
    ]
    for label, program, entry, segments, tape, max_steps in v2_cases:
        data, prover, counts, peak = port_prove_v2(program, entry, segments, tape, max_steps)
        if label == "nop 2^20":
            v2_counts = counts
        t = prover.last_timings
        log(f"phase 6 v2 {label}: steps {t['num_steps']}, {len(data)} B, Accept, commit paths "
            f"{t['data_commit_path']}/{t['advice_commit_path']}, launches {counts}, peak device memory {peak} B")
        log("  port timings: " + " ".join(f"{k}={t[k]}" for k in v2_keys)
            + f" steps_per_s={t['num_steps'] / t['total_s']}")
        ref, ref_s = reference_prove_v2(program, entry, segments, tape, max_steps)
        if sha(data) != sha(ref):
            raise AssertionError(f"v2 {label}: port proof differs from zigz_tpu's")
        log(f"phase 6 v2 {label}: sha256 {sha(data)[:16]} == zigz_tpu (host path {ref_s} s)")
        del data, ref
        torch.cuda.empty_cache()

    # -- phase 7: ligero_commit_device against ligero_commit ---------------
    names = [f"w{k:02d}" for k in range(43)]
    rows = words(43, 1 << 18)
    columns = {name: rows[k].cpu().numpy().astype("uint64") for k, name in enumerate(names)}
    ligero_dev.LAUNCHES.update(columns=0, absorb=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    port_state = ligero_dev.ligero_commit_device(F, names, rows)
    port_s = time.perf_counter() - t0
    columns_launches = ligero_dev.LAUNCHES["columns"]
    if not columns_launches:
        raise AssertionError("ligero_commit_device did not launch K4")
    t0 = time.perf_counter()
    ref_state = ligero_commit(F, columns, "sha3")
    ref_s = time.perf_counter() - t0
    if (port_state.root, port_state.leaf_digests, port_state.levels) != (
            ref_state.root, ref_state.leaf_digests, ref_state.levels):
        raise AssertionError("ligero_commit_device differs from zigz_tpu's ligero_commit")
    log(f"phase 7 ligero_commit_device 43 x 2^18 ({port_state.m * 43} x {port_state.n_e} encoded): "
        f"root {port_state.root.hex()[:16]} == ligero_commit, {port_s} s (host ligero_commit {ref_s} s), "
        f"K4 launches {columns_launches}")

    # -- the contract's lines ----------------------------------------------
    def entry_of(name, key, source, replaces, launches):
        r = results[key]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"]}

    sha3_source = "zigz_tpu_torch/csrc/sha3_kernels.cu"
    ligero_source = "zigz_tpu_torch/csrc/ligero_kernels.cu"
    kernels_line = {"kernels": [
        entry_of("sha3_leaves (K1)", "leaves", sha3_source, "zigz_tpu/ops/keccak_pallas.py:93",
                 main_counts["leaves"]),
        entry_of("sha3_merge (K2)", "merge", sha3_source, "zigz_tpu/ops/keccak_pallas.py:108",
                 main_counts["merge"]),
        entry_of("sha3_columns (K4)", "columns", ligero_source, "zigz_tpu/ops/ligero_dev.py:45",
                 columns_launches),
        entry_of("sha3_absorb (K5)", "absorb", ligero_source, "zigz_tpu/ops/ligero_dev.py:256",
                 v2_counts["absorb"]),
    ]}
    log(json.dumps(kernels_line))
    log(info["nvidia_smi"])
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
