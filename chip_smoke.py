#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's v1 and v2 provers on one NVIDIA GPU and check them.

    python3 chip_smoke.py        (from the root of a checkout; needs one CUDA device)

The script imports ``zigz_tpu_torch`` and nothing of JAX or of the JAX
package ``zigz_tpu``: both are blocked from import before the port loads.
The reference for every proof is data: the golden fixtures under
tests/fixtures/ and the pinned byte lengths and sha256 digests of
zigz_tpu_torch/testdata/proof_digests.json (made on a CPU by
scripts/torch_reference_digests.py from zigz_tpu's host path), plus the
port's own ``Verifier``.  A digest that differs raises.

Phases, in order; any failure raises, so the script exits non-zero before
the last line:

  0. the card: nvidia-smi name, power limit and clocks, torch and CUDA
     versions.  Without a CUDA device the script exits 2 and prints no
     result.
  1. build the CUDA kernels from zigz_tpu_torch/csrc/ (one nvcc per unit,
     all started together, sm_90a) and the host C++ runtime from
     zigz_tpu_torch/runtime/ (one g++ per library, all started together);
     count the Keccak permutation's integer instructions in the built
     library's SASS (``cuobjdump -sass``), for the kernels' bounds.
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
     Each kernel's bound: the larger of its bytes (inputs read once,
     outputs written once) over 3.35 TB/s and its Keccak permutations
     times the counted instructions over 132 SMs x 64 INT32 lanes x the
     card's maximum SM clock.  No PyTorch call computes SHA3-256, so
     ``library_ms`` is null.
  3. the port's v1 proof bytes equal tests/fixtures/{nop4,add,fibonacci}_v1.bin.
  4. at 2^16 and 2^20 NOP steps and for the fibonacci guest (900,013
     steps), the port's v1 proof equals its pinned digest and verifies
     Accept.
  5. the v1 main path: Prover(BabyBear, device="cuda").prove at 2^22 NOP
     steps, once, equal to its pinned digest and verified Accept; phase
     timings, steps/s and peak device memory.
  6. the v2 main path: Prover(BabyBear, device="cuda", protocol_version=2)
     at 2^16 NOP steps, for the fibonacci guest (60,013 steps) and at 2^20
     NOP steps, each equal to its pinned digest and verified Accept.  The
     commitments, every zerocheck and the Lasso rounds run on the card:
     both commit paths must be "stream-dev", the count of zerochecks
     proven by GenericDeviceZerocheckExt must equal the count of zerocheck
     proofs in the proof, and the Lasso device rounds must be > 0.  One
     line per case prints zerochecks_s, lasso_s, total_s, those counts,
     the columns read from the resident matrices against those uploaded,
     the DAG sweep's launches and peak device memory.
  7. ``ligero_commit_device`` of 43 random MLEs at 2^18: root, leaf digests
     and levels equal the port's host ``ligero_commit`` (the C++ encoder and
     column hasher) of the same columns.

The kernel launch counters are reset before each prove or commit and must
be > 0 after it; the kernel line takes K1/K2's from phase 5, K5's from the
2^20 prove of phase 6 and K4's from phase 7.  The last three lines are the
kernel JSON line, the card's nvidia-smi line and the result line
{"ok": true, "device": {...}}.
"""

import hashlib
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.modules["jax"] = None  # any import of jax or of the JAX package now raises ImportError
sys.modules["zigz_tpu"] = None

P = 2013265921
NOP = bytes([0x13, 0x00, 0x00, 0x00])
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
INT32_LANES = 132 * 64  # SMs x INT32 lanes per SM and clock (Hopper white paper)
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
    from zigz_tpu_torch.commitments.ligero import ligero_commit
    from zigz_tpu_torch.lookups import pipeline_lasso
    from zigz_tpu_torch.ops import _build, keccak, ligero_dev, ntt_dev, zerocheck_dev_ext
    from zigz_tpu_torch.proofs.zerocheck import count_zerocheck_proofs
    from zigz_tpu_torch import runtime
    from zigz_tpu_torch.runtime import native_vm

    F = zt.BabyBear
    dev = torch.device("cuda", 0)
    ser = zt.serialization.BinarySerializer(F)
    with open(os.path.join(ROOT, "zigz_tpu_torch", "testdata", "proof_digests.json")) as f:
        pinned = json.load(f)["proofs"]

    # -- phase 0: the card -------------------------------------------------
    info = card_info()
    if not info["nvidia_smi"]:
        raise RuntimeError(info["nvidia_smi_error"])
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader,nounits"],
                            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    sm_mhz, max_sm_mhz = (float(x) for x in clocks.split(","))
    log(f"phase 0 card: {info['nvidia_smi']} | SM clock {sm_mhz} MHz now, {max_sm_mhz} MHz max "
        f"| torch {info['torch']} cuda {info['cuda']} | devices {info['device_count']} | nvcc {info['nvcc']}")

    # -- phase 1: build ----------------------------------------------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:  # each loader waits on its own g++; nvcc runs beside them
        host_libs = [pool.submit(fn) for fn in (runtime._load_dag, runtime._load_ext4, runtime._load_ntt,
                                                runtime._load_lasso, native_vm._load)]
        kernels = _build.load()
        if not runtime.NATIVE_AVAILABLE or any(lib.result() is None for lib in host_libs):
            raise RuntimeError("the host C++ runtime (zigz_tpu_torch/runtime/*.cpp) did not build")
    log(f"phase 1 build: {time.perf_counter() - t0:.3f} s (nvcc {kernels.build_s:.3f} s; 6 host libraries) -> "
        f"{os.path.relpath(kernels.path, ROOT)}")
    for line in kernels.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")

    # Integer instructions of one Keccak-f[1600], from the SASS of K2 (a
    # straight-line kernel: one full-state permutation per thread).
    cuobjdump = os.path.join(os.path.dirname(info["nvcc"]), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", kernels.path], capture_output=True, text=True, check=True).stdout
    merge_sass = next(part for part in sass.split("Function :")[1:] if "sha3_merge" in part.splitlines()[0])
    opcodes = re.findall(r"^\s+/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\d+\s+)?([A-Z][A-Z0-9_]*)", merge_sass, flags=re.M)
    perm_instr = sum(1 for op in opcodes if op in ("LOP3", "SHF", "IADD3", "IMAD", "LEA", "PRMT", "MOV"))
    if not 1000 < perm_instr < 20000:
        raise AssertionError(f"implausible instruction count {perm_instr} for Keccak-f in K2's SASS ({len(opcodes)} in all)")
    log(f"phase 1 sass: K2 has {len(opcodes)} instructions, {perm_instr} of them integer ALU "
        f"({ {op: opcodes.count(op) for op in sorted(set(opcodes))} })")

    def bound(perms: int, nbytes: int) -> dict:
        """The least time the card could take: bytes over the memory rate, or
        permutations x instructions over the INT32 issue rate at the maximum clock."""
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = perms * perm_instr / (INT32_LANES * max_sm_mhz * 1e6) * 1e3
        return dict(bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                    library_ms=None)

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
                             plain_ms=event_ms(keccak._sha3_leaves_plain, leaves_in, 2),
                             **bound(43 << 20, (43 << 20) * (8 + 32)))
    results["merge"] = dict(max_abs_err=merge_err, shape=f"({43 << 19}, 8) -> ({43 << 19}, 4)",
                            ms=event_ms(keccak.sha3_merge, merge_in, 20),
                            plain_ms=event_ms(keccak._sha3_merge_plain, merge_in, 2),
                            **bound(43 << 19, (43 << 19) * (64 + 32)))
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
        plain_ms=event_ms(lambda s: ligero_dev._sha3_absorb_plain(s, block, 0, 16, V2_DATA_ROWS), scratch, 2),
        **bound(16 * n_e, n_e * (2 * 25 * 8 + 544 * 4)))  # the state read and written, the block read
    del state0, absorbed, scratch, block

    mat = words(688, n_e)
    columns_out = ligero_dev.sha3_columns(mat)
    columns_err = byte_err(columns_out, ligero_dev._sha3_columns_plain(mat))
    check_columns("K4", columns_out, mat, [0, 1, n_e - 1, *sample[:8].remainder(n_e).tolist()])
    results["columns"] = dict(
        max_abs_err=columns_err, shape=f"(688, {n_e}) -> ({n_e}, 4)",
        ms=event_ms(ligero_dev.sha3_columns, mat, 10),
        plain_ms=event_ms(ligero_dev._sha3_columns_plain, mat, 2),
        **bound(ligero_dev.pad_words(688) // ligero_dev.RATE_WORDS * n_e, n_e * (688 * 4 + 32)))
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
            f"{r['shape']}: kernel {r['ms']} ms, plain {r['plain_ms']} ms, "
            f"bound {r['bound_ms']} ms by {r['bound_by']}")
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

    def load_case(name):
        """(program, entry, segments, tape, max_steps, entry of the file) of a pinned case."""
        case = pinned[name]
        spec = case["program"]
        if spec["kind"] == "nop":
            return NOP * spec["count"], 0x1000, None, None, case["max_steps"], case
        with open(os.path.join(ROOT, "tests", "fixtures", spec["name"]), "rb") as f:
            program = f.read()
        loaded = zt.elf.load(program)
        return program, loaded.entry_pc, loaded.segments, spec.get("tape"), case["max_steps"], case

    def check_pinned(name, case, data, num_steps):
        got = (num_steps, len(data), sha(data))
        want = (case["num_steps"], case["bytes"], case["sha256"])
        if got != want:
            raise AssertionError(f"{name}: (steps, bytes, sha256) {got} differ from the pinned {want}")

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

    # -- phase 4: against the pinned digests --------------------------------
    for name in ("v1-nop-2^16", "v1-nop-2^20", "v1-fibonacci-150000"):
        program, entry, segments, tape, max_steps, case = load_case(name)
        data, prover, counts = port_prove(program, entry, segments, tape, max_steps)
        check_pinned(name, case, data, prover.last_timings["num_steps"])
        log(f"phase 4 {name}: steps {prover.last_timings['num_steps']} sha256 {sha(data)[:16]} == pinned, "
            f"{len(data)} B, Accept, launches {counts}")
        log(f"  port timings: {timings(prover)}")

    # -- phase 5: the v1 main path at 2^22 steps ---------------------------
    program, entry, segments, tape, max_steps, case = load_case("v1-nop-2^22")
    torch.cuda.reset_peak_memory_stats(dev)
    data, prover, main_counts = port_prove(program, entry, segments, tape, max_steps)
    check_pinned("v1-nop-2^22", case, data, prover.last_timings["num_steps"])
    log(f"phase 5 v1-nop-2^22: sha256 {sha(data)[:16]} == pinned, {len(data)} B, Accept, launches {main_counts}, "
        f"peak device memory {torch.cuda.max_memory_allocated(dev)} B")
    log(f"  port timings: {timings(prover)}")
    del data, program
    torch.cuda.empty_cache()

    # -- phase 6: the v2 main path ------------------------------------------
    def port_prove_v2(program, entry, segments, tape, max_steps):
        keccak.LAUNCHES.update(leaves=0, merge=0)
        ligero_dev.LAUNCHES.update(columns=0, absorb=0)
        zerocheck_dev_ext.reset_counters()
        pipeline_lasso.DEVICE_ROUNDS["count"] = 0
        torch.cuda.reset_peak_memory_stats(dev)
        prover = zt.Prover(F, seed=0, device=dev, protocol_version=2)
        proof = prover.prove(program, entry, None, max_steps, segments, tape)
        counts = {**keccak.LAUNCHES, "absorb": ligero_dev.LAUNCHES["absorb"]}
        if not all(counts.values()):
            raise AssertionError(f"the v2 prove did not launch K1, K2 and K5: {counts}")
        device_work = {"zerochecks": count_zerocheck_proofs(proof),
                       "device_zerochecks": zerocheck_dev_ext.DEVICE_PROVES["count"],
                       "sweep_launches": zerocheck_dev_ext.DEVICE_PROVES["sweep_launches"],
                       "columns_resident": zerocheck_dev_ext.COLUMNS["resident"],
                       "columns_uploaded": zerocheck_dev_ext.COLUMNS["uploaded"],
                       "lasso_device_rounds": pipeline_lasso.DEVICE_ROUNDS["count"]}
        if device_work["device_zerochecks"] != device_work["zerochecks"] or not device_work["zerochecks"]:
            raise AssertionError(f"not every zerocheck ran on the device: {device_work}")
        if not device_work["lasso_device_rounds"] or not device_work["columns_resident"]:
            raise AssertionError(f"the Lasso rounds or the resident columns were not used: {device_work}")
        paths = (prover.last_timings["data_commit_path"], prover.last_timings["advice_commit_path"])
        if paths != ("stream-dev", "stream-dev"):
            raise AssertionError(f"the v2 commits did not take the device path: {paths}")
        data = ser.serialize(proof)
        verdict = zt.Verifier(F).verify(ser.deserialize(data), program)
        if verdict != "Accept":
            raise AssertionError(f"the port's v2 proof was rejected: {verdict}")
        return data, prover, counts, torch.cuda.max_memory_allocated(dev), device_work

    v2_keys = ("total_s", "execute_s", "data_commit_s", "data_assemble_s", "data_upload_s",
               "data_stream_s", "data_levels_s", "advice_build_s", "advice_commit_s",
               "advice_assemble_s", "advice_upload_s", "advice_stream_s", "advice_levels_s",
               "zerochecks_s", "batch_eval_s", "open_s", "unified_s", "lasso_s", "witness_dev_s",
               "forest_s", "evals_s", "opens_s", "commitments_s")
    for name in ("v2-nop-2^16", "v2-fibonacci-10000", "v2-nop-2^20"):
        program, entry, segments, tape, max_steps, case = load_case(name)
        data, prover, counts, peak, device_work = port_prove_v2(program, entry, segments, tape, max_steps)
        if name == "v2-nop-2^20":
            v2_counts = counts
        t = prover.last_timings
        check_pinned(name, case, data, t["num_steps"])
        log(f"phase 6 {name}: steps {t['num_steps']}, {len(data)} B, sha256 {sha(data)[:16]} == pinned, Accept, "
            f"commit paths {t['data_commit_path']}/{t['advice_commit_path']}, launches {counts}")
        log(f"phase 6 {name} device rounds: zerochecks_s={t['zerochecks_s']} lasso_s={t['lasso_s']} "
            f"total_s={t['total_s']} " + " ".join(f"{k}={v}" for k, v in device_work.items())
            + f" peak_device_memory_B={peak}")
        log("  port timings: " + " ".join(f"{k}={t[k]}" for k in v2_keys)
            + f" steps_per_s={t['num_steps'] / t['total_s']}")
        del data, program
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
        raise AssertionError("ligero_commit_device differs from the host ligero_commit")
    log(f"phase 7 ligero_commit_device 43 x 2^18 ({port_state.m * 43} x {port_state.n_e} encoded): "
        f"root {port_state.root.hex()[:16]} == ligero_commit, {port_s} s (host ligero_commit {ref_s} s), "
        f"K4 launches {columns_launches}")

    # -- the contract's lines ----------------------------------------------
    def entry_of(name, key, source, replaces, launches):
        r = results[key]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"]}

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
