#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's v1 to v4 provers, its forest's memory plan
at 2^25 steps, its base-field device zerocheck, its standalone modules and
its sharded prover (two ranks sharing the card) on one NVIDIA GPU and check
them.

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
     the two column shards that a rank of two sponges in the sharded 2^20 v2
     prove of phase 15, 2,540 x 2^18 (ADVICE, the entry of the kernel line)
     and 2,089 x 2^18 (DATA), and on 688 x 2^19 (``ligero_commit_device`` of
     the 43 witness MLEs at 2^20), each with its own times and bound; K4
     and K5 (driven over the raw rows) at 1, 255 and 4097 columns times
     1, 33, 34, 543, 544 and 545 rows with the values 0 and p - 1.
     A hashlib check of a sample for every kernel, and the time of the
     Reed-Solomon encode of one 544-row block (torch ops, 2^16 -> 2^19).
     Each kernel's bound: the larger of its bytes (inputs read once,
     outputs written once) over 3.35 TB/s and its Keccak permutations
     times the counted instructions over 132 SMs x 64 INT32 lanes x the
     card's maximum SM clock.  No PyTorch call computes SHA3-256, so
     ``library_ms`` is null.
     Then the device functions that are torch ops, not kernels (the JAX
     package computes them in jnp): Poseidon2 ``p2_leaves``, ``p2_merge``
     and the column sponge against the host core/poseidon2.py and
     ``_hash_columns(..., "poseidon2")`` at 2^16 hashes and ragged sizes,
     byte error 0; ``vecmat_device`` against the host ``_vecmat``; and the
     time by CUDA events and the launches (``torch.profiler``) of each, of
     ``encode_rows`` and of one Poseidon2 permutation at the widths of the
     2^20 proves.  The three advice twins are held against the host
     advice columns of every v2, v3 and v4 prove below, plane by plane,
     after that prove has returned (its timings carry none of the check).
  3. the port's v1 proof bytes equal tests/fixtures/{nop4,add,fibonacci}_v1.bin.
  4. at 2^16 and 2^20 NOP steps and for the fibonacci guest (900,013
     steps), the port's v1 proof equals its pinned digest and verifies
     Accept.
  5. the v1 main path: Prover(BabyBear, device="cuda").prove at 2^22 NOP
     steps, once, equal to its pinned digest and verified Accept; phase
     timings, steps/s, the forest's plan (nothing freed, one group) and
     peak device memory, allocated and reserved.
  6. the v2 main path: Prover(BabyBear, device="cuda", protocol_version=2)
     at 2^16 NOP steps, for the fibonacci guest (60,013 steps) and at 2^20
     NOP steps, each equal to its pinned digest and verified Accept.  The
     commitments, every zerocheck and the Lasso rounds run on the card:
     both commit paths must be "stream-dev", the count of zerochecks
     proven by GenericDeviceZerocheckExt must equal the count of zerocheck
     proofs in the proof, and the Lasso device rounds must be > 0.  One
     line per case prints zerochecks_s, lasso_s, total_s, those counts,
     the columns read from the resident matrices against those uploaded,
     the DAG sweep's launches and peak device memory, the advice planes
     built on the device (148 at 2^20), the build time of each twin and
     the ADVICE rows that were uploaded.
  7. ``ligero_commit_device`` of 43 random MLEs at 2^18: root, leaf digests
     and levels equal the port's host ``ligero_commit`` (the C++ encoder and
     column hasher) of the same columns; the state, whose matrix lies on
     the device, is opened with ``ligero_prove_eval`` (``vecmat_device``,
     ``column_evals_device``) and verified with ``ligero_verify_eval``.
  8. protocol v4 (the 43 witness MLEs under the DATA commitment, no
     forest) at 2^16 and 2^20 NOP steps: pinned digest, Accept, K1 and K2
     launches 0, K5 launches > 0, the DATA commit's total_rows, n and n_e.
  9. protocol v3 (Poseidon2 forest and column sponge, torch ops) at 2^16
     NOP steps, for the fibonacci guest (60,013 steps) and at 2^20 NOP
     steps: pinned digest, Accept, no SHA3 kernel launched, the Poseidon2
     permutation calls.
 10. the forest's memory plan at sizes that have a reference: with the
     thresholds of commitments/device_forest.py forced low (three levels
     freed, three groups of 16, 16 and 11 trees), v1 at 2^22 NOP steps and
     for the fibonacci guest (900,013 steps) and v3 at 2^16 NOP steps
     (Poseidon2 forest) equal their pinned digests and verify Accept; K1
     runs once per group and once per freed level of the openings, K2 once
     per level per group and k times for the freed level k.
 11. the size the forest cannot hold whole: Prover(BabyBear).prove at 2^25
     NOP steps with the thresholds as shipped (the plan frees levels 0..2
     and builds in groups of 16 trees on its own; all levels would be
     92.4 GB).  No reference digest exists at this size, so the proof is
     held three ways: the port's Verifier accepts it (all 43 openings
     against the roots); every tree's root equals the root of that tree
     built alone by K1/K2 with nothing freed; every opened sibling, at the
     freed levels and above, equals the same node of that single-tree
     build.  Prints forest_s, opens_s, total_s, steps/s, the plan, K1/K2
     launches, and the peak device memory allocated and reserved.  Then
     2^24 NOP steps once with the thresholds as shipped and once with
     nothing freed and one group (the forest as it was before the plan),
     for the peak each needs.
 12. the base-field device zerocheck (ops/zerocheck_gen.py) of a
     grand-product combiner (five columns, degree 4) at width 2^20 through
     ``make_zerocheck_prover(..., device=card)``, against the native C++
     prover from the same transcript: round values, challenges, terminal
     evaluations and the transcript's next challenge equal; time and sweep
     launches printed.
 13. the standalone modules, host code that must import and run here with
     JAX blocked: ``SumcheckProver.prove`` on a 2^16 polynomial, accepted by
     ``SumcheckVerifier.verify_rounds`` against the hypercube sum; a
     ``LassoProver`` proof of 64 queries into the 4-bit XOR table, whose
     rounds verify against the queries' sum and which
     ``LassoVerifier.verify_fast`` accepts; ``HostMerkleForest`` (one
     native call) roots and openings equal ``DeviceMerkleForest`` on the
     card at 43 x 2^12.
 14. the sharded prover's pieces on two ranks that share the card.  A rank
     is this script started again with ``--rank`` (JAX and zigz_tpu blocked
     there too), joined by ``torch.distributed`` with gloo as the transport
     (NCCL refuses two ranks on one GPU), both on ``cuda:0``, every
     collective staged through the host (zigz_tpu_torch/parallel/).  Each
     The rank functions are those of tests/torch_group_checks.py.  Each
     piece must equal its single-device result on both ranks:
     ``DistSumcheckProver`` on 2^20 seeded values against the host
     ``SumcheckProver``'s proof bytes; ``device_prove_step`` at (43, 2^20);
     ``commit_columns_mesh`` at the 2^20 v2 DATA commit's shape (2,089 x
     2^16, n_e = 2^19) against ``sha3_columns_stream``'s digest blob, K4
     launched once on each rank, and ``MeshEncoded.gather`` of 64 columns
     against ``StreamedEncoded.gather``; ``prove_rounds_mesh`` over tables of
     20, 20, 18, 16 and 10 variables against the native rounds (rounds,
     challenges, terminal evaluations, the transcript's next challenge); the
     forest at (43, 2^16) under a forced plan.  Then one rank under
     ``"nccl"``: every collective wrapper once on CUDA tensors.
 15. this slice's path at full width: ``Prover(BabyBear, device="cuda:0",
     group=...)`` on the two ranks at 2^22 NOP steps (v1) and 2^20 NOP steps
     (v2), each rank's proof equal to the pinned digest and verified Accept;
     v2's ``data_commit_sharded``, ``advice_commit_sharded``,
     ``batch_eval_sharded`` and ``open_sharded`` true and
     ``zerochecks_sharded`` false, and the two commits' shapes those whose
     column shards phase 2 held K4 to; per rank the K1/K2/K4/K5 launches (K1, K2
     and, for v2, K4 > 0), the forest's plan, the phase timings and the peak
     device memory.  Then a job whose rank 1 kills itself after
     ``initialize``: the launcher must fail inside its timeout and leave no
     result file, and the relaunch must give the pinned digest.  Two ranks
     time-share one card: their figures are printed as what they are and
     compared with nothing.

The kernel launch counters are reset before each prove or commit and must
be > 0 after it; the kernel line takes K1/K2's from phase 5
(``launches_large`` beside them from the 2^25 prove of phase 11), K5's from the
2^20 prove of phase 6 (``launches_v4`` beside it from phase 8) and K4's from
rank 0 of the sharded 2^20 v2 prove of phase 15, the one prove that runs it
(``launches_commit_device`` beside it from phase 7, ``other_shapes`` its
measurements at the other two shapes of phase 2); K3, the permutation inlined in all four, is listed with K2's
measurements (one permutation per thread) and K1's plus K2's launches; every
entry carries the launches per rank of phase 15's two proves
(``launches_group_v1_2_22``, ``launches_group_v2_2_20``).  The last three lines are the
kernel JSON line, the card's nvidia-smi line and the result line
{"ok": true, "device": {...}}.
"""

import contextlib
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
V2_DATA_ROWS = 2089  # rows of the 2^20 v2 DATA commit, n = 2^16, n_e = 2^19
V2_ADVICE_ROWS = 2540  # rows of its ADVICE commit, same n and n_e
GROUP_KEYS = {"leaves": "K1", "merge": "K2", "columns": "K4", "absorb": "K5"}  # a rank's launch counts


def log(msg: str) -> None:
    print(msg, flush=True)


def sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def group_phases(pinned) -> dict:
    """Phases 14 and 15; returns the per-rank kernel launches of the two
    sharded proves, by pinned case."""
    import shutil
    import tempfile

    import torch

    from zigz_tpu_torch.parallel.launch import LaunchFailed, launch

    # -- phases 14, 15: the sharded prover, two ranks sharing the card ------
    # A rank is this script started again with --rank: jax and zigz_tpu are
    # blocked there too, before the port is imported.  Both ranks name
    # cuda:0 and use gloo as the transport (NCCL refuses two ranks on one
    # GPU), so every collective is staged through the host.  The two ranks
    # time-share the card: their figures are printed as what they are and
    # compared with nothing.
    rank_command = [sys.executable, os.path.abspath(__file__), "--rank"]
    jobs_dir = tempfile.mkdtemp(prefix="chip_smoke_jobs_", dir=os.path.join(ROOT, "build"))
    torch.cuda.empty_cache()

    def on_two_ranks(function, spec, timeout_s):
        results = launch(2, function, spec, work_dir=jobs_dir, device="cuda:0", backend="gloo",
                         timeout_s=timeout_s, command=rank_command)
        if [r["rank"] for r in results] != [0, 1] or any(r["device"] != "cuda:0" for r in results):
            raise AssertionError(f"the ranks did not run on cuda:0: {[(r['rank'], r['device']) for r in results]}")
        return results

    t0 = time.perf_counter()
    pieces = on_two_ranks("checks", {"checks": [
        {"name": "wrappers", "kind": "wrappers", "seed": 14},
        {"name": "dist_sumcheck 2^20", "kind": "dist_sumcheck", "seed": 14, "log2_n": 20},
        {"name": "device_prove_step (43, 2^20)", "kind": "prove_step", "seed": 15, "B": 43, "v": 20},
        {"name": f"commit_columns_mesh {V2_DATA_ROWS} x 2^16 -> 2^19", "kind": "commit", "seed": 16,
         "rows": V2_DATA_ROWS, "n": 1 << 16, "n_e": 1 << 19, "n_gather": 64},
        {"name": "prove_rounds_mesh 20, 20, 18, 16, 10 variables", "kind": "batch_eval", "seed": 17,
         "log2_sizes": [20, 20, 18, 16, 10]},
        {"name": "forest (43, 2^16) freed levels, three groups", "kind": "forest", "seed": 18, "B": 43, "v": 16,
         "discard_digests": (43 << 16) >> 3, "group_leaf_digests": 16 << 15},
    ]}, timeout_s=600)
    for res in pieces:
        for name, check in res["results"].items():
            if name == "wrappers":
                if not (check["rows_to_columns_ok"] and check["gather_cyclic_ok"] and check["gather_last_ok"]
                        and check["all_reduce"] == [0, 3, 6, 9, 12, 15]
                        and check["exchange_rows"] == [res["rank"], 100 + res["rank"]]):
                    raise AssertionError(f"rank {res['rank']}: a collective wrapper gave a wrong result: {check}")
            elif not check["equal_single"]:
                raise AssertionError(f"rank {res['rank']}: {name} differs from the single-device result")
            if name.startswith("commit_columns_mesh") and not (check["launches"]["K4"] == 1 and check["ok_predicate"]):
                raise AssertionError(f"rank {res['rank']}: the sharded commit did not launch K4 once: {check}")
            if name.startswith("prove_rounds_mesh") and not (check["sharded"] and check["mesh_rounds"] > 0):
                raise AssertionError(f"rank {res['rank']}: the batch-eval rounds did not run sharded: {check}")
            if name.startswith("forest") and (check["plan"]["discarded_levels"], check["plan"]["groups"]) != (3, 3):
                raise AssertionError(f"rank {res['rank']}: the forced plan was not taken: {check['plan']}")
    if len({json.dumps({n: c.get("sha256") for n, c in r["results"].items()}, sort_keys=True) for r in pieces}) != 1:
        raise AssertionError("the two ranks' results differ")
    log(f"phase 14 the group's pieces, 2 ranks on cuda:0 over gloo ({time.perf_counter() - t0:.1f} s with the "
        f"ranks' start): every piece == its single-device result on both ranks; seconds on rank 0 (two ranks "
        f"time-share the card): "
        + "; ".join(f"{n} {c.get('seconds', c['check_s']):.3f}" for n, c in pieces[0]["results"].items())
        + f"; collectives of the wrappers check {pieces[0]['results']['wrappers']['collectives']}")

    # The "nccl" branch of the wrappers: a group of one rank on the card
    # (two ranks cannot share a GPU under NCCL), every wrapper once on CUDA
    # tensors handed to the collectives as they are.
    nccl = launch(1, "checks", {"checks": [{"name": "wrappers", "kind": "wrappers", "seed": 14}]},
                  work_dir=jobs_dir, device="cuda:0", backend="nccl", timeout_s=300, command=rank_command)
    check = nccl[0]["results"]["wrappers"]
    if not (check["rows_to_columns_ok"] and check["gather_cyclic_ok"] and check["gather_last_ok"]
            and check["all_reduce"] == [0, 1, 2, 3, 4, 5] and check["exchange_rows"] == [0]
            and check["collectives"] == {"all_reduce": 1, "all_gather": 3, "all_to_all": 2}):
        raise AssertionError(f"the wrappers under a one-rank nccl group gave a wrong result: {check}")
    log(f"phase 14 nccl: one rank on cuda:0, every wrapper once on CUDA tensors, collectives {check['collectives']}")

    group_launches = {}
    for name, version, timeout_s in (("v1-nop-2^22", 1, 600), ("v2-nop-2^20", 2, 900)):
        case = pinned[name]
        t0 = time.perf_counter()
        ranks = on_two_ranks("prove", {"program": case["program"], "max_steps": case["max_steps"],
                                       "protocol_version": version}, timeout_s=timeout_s)
        for res in ranks:
            got = (res["num_steps"], res["bytes"], res["sha256"], res["verify"])
            want = (case["num_steps"], case["bytes"], case["sha256"], "Accept")
            if got != want:
                raise AssertionError(f"{name} on rank {res['rank']}: {got} differs from the pinned {want}")
            counts, t = res["launches"], res["timings"]
            if version == 1 and not (counts["K1"] > 0 and counts["K2"] > 0):
                raise AssertionError(f"{name} on rank {res['rank']}: K1 or K2 was not launched: {counts}")
            if version == 2:
                if not (counts["K1"] > 0 and counts["K2"] > 0 and counts["K4"] > 0):
                    raise AssertionError(f"{name} on rank {res['rank']}: K1, K2 or K4 was not launched: {counts}")
                flags = {k: t.get(k) for k in ("data_commit_sharded", "advice_commit_sharded", "batch_eval_sharded",
                                               "open_sharded", "zerochecks_sharded")}
                if flags != {"data_commit_sharded": True, "advice_commit_sharded": True, "batch_eval_sharded": True,
                             "open_sharded": True, "zerochecks_sharded": False}:
                    raise AssertionError(f"{name} on rank {res['rank']}: what ran sharded: {flags}")
                shapes = [list(t["data_commit_shape"]), list(t["advice_commit_shape"])]
                if shapes != [[V2_DATA_ROWS, 1 << 16, 1 << 19], [V2_ADVICE_ROWS, 1 << 16, 1 << 19]]:
                    raise AssertionError(f"{name} on rank {res['rank']}: the commits' (rows, n, n_e) {shapes} are "
                                         f"not the shapes whose column shards phase 2 held K4 to")
                if (t["data_commit_path"], t["advice_commit_path"]) != ("mesh", "mesh"):
                    raise AssertionError(f"{name} on rank {res['rank']}: commit paths "
                                         f"{t['data_commit_path']}, {t['advice_commit_path']}")
            keys = [k for k in ("total_s", "execute_s", "witness_dev_s", "forest_s", "evals_s", "opens_s", "unified_s",
                                "data_commit_s", "advice_commit_s", "zerochecks_s", "batch_eval_s", "open_s",
                                "lasso_s", "forest_plan") if k in t]
            log(f"phase 15 {name} on rank {res['rank']} of 2 sharing cuda:0: sha256 {res['sha256'][:16]} == pinned, "
                f"{res['bytes']} B, Accept, launches {counts}, max_memory_allocated {res['max_memory_allocated']} B, "
                f"max_memory_reserved {res['max_memory_reserved']} B, " + " ".join(f"{k}={t[k]}" for k in keys))
        group_launches[name] = [res["launches"] for res in ranks]
        log(f"phase 15 {name}: both ranks' proofs == the pinned digest ({time.perf_counter() - t0:.1f} s with the "
            f"ranks' start)")

    # A lost rank: rank 1 kills itself after initialize.  The launcher must
    # fail within its timeout and leave no result; the relaunch must give
    # the pinned digest.
    case = pinned["v1-nop-2^16"]
    spec = {"program": case["program"], "max_steps": case["max_steps"], "protocol_version": 1}
    t0 = time.perf_counter()
    try:
        on_two_ranks("prove_lost_rank", dict(spec, lost_rank=1), timeout_s=120)
    except LaunchFailed as failure:
        failed_s = time.perf_counter() - t0
        reason = str(failure).splitlines()[0]
    else:
        raise AssertionError("a job whose rank 1 killed itself did not fail")
    left = [f for f in os.listdir(jobs_dir) if f.startswith("result_")]
    if left or failed_s >= 120:
        raise AssertionError(f"the failed job took {failed_s:.1f} s and left {left}")
    ranks = on_two_ranks("prove", spec, timeout_s=300)
    if {(r["sha256"], r["verify"]) for r in ranks} != {(case["sha256"], "Accept")}:
        raise AssertionError("the relaunched job's proofs differ from the pinned digest")
    log(f"phase 15 lost rank: the job failed in {failed_s:.1f} s ({reason}), no result file left; the relaunch "
        f"gave sha256 {case['sha256'][:16]} == pinned on both ranks")
    shutil.rmtree(jobs_dir, ignore_errors=True)
    return group_launches


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; an NVIDIA GPU is required",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import zigz_tpu_torch as zt
    from zigz_tpu_torch.device import card_info
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from zigz_tpu_torch.commitments import device_forest, host_forest, ligero
    from zigz_tpu_torch.commitments.ligero import ligero_commit
    from zigz_tpu_torch.core import poseidon2 as p2_host
    from zigz_tpu_torch.core.hash import FiatShamirTranscript
    from zigz_tpu_torch.lookups import lasso, pipeline_lasso
    from zigz_tpu_torch.lookups.table_builder import build_xor_table
    from zigz_tpu_torch.ops import (_build, advice_dev, keccak, ligero_dev, ntt_dev, poseidon2, witness_dev,
                                    zerocheck_dev_ext, zerocheck_gen)
    from zigz_tpu_torch.ops.zerocheck_native import NativeZerocheckProver
    from zigz_tpu_torch.prover import prover as prover_module
    from zigz_tpu_torch.prover import unified
    from zigz_tpu_torch.proofs.zerocheck import count_zerocheck_proofs, make_zerocheck_prover
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

    # K4 at the shapes its callers give it: the (rows, n_e / 2) column shard
    # of each commit of the sharded 2^20 v2 prove on two ranks (phase 15),
    # and ligero_commit_device's 688 x 2^19 (phase 7).
    columns_err, columns_at = 0, {}
    for key, r, n in (("columns", V2_ADVICE_ROWS, n_e // 2), ("columns_data_shard", V2_DATA_ROWS, n_e // 2),
                      ("columns_commit_device", 688, n_e)):
        mat = words(r, n)
        columns_out = ligero_dev.sha3_columns(mat)
        err_here = byte_err(columns_out, ligero_dev._sha3_columns_plain(mat))
        check_columns(f"K4 ({r}, {n})", columns_out, mat, [0, 1, n - 1, *sample[:8].remainder(n).tolist()])
        columns_at[key] = dict(
            max_abs_err=err_here, shape=f"({r}, {n}) -> ({n}, 4)",
            ms=event_ms(ligero_dev.sha3_columns, mat, 10),
            plain_ms=event_ms(ligero_dev._sha3_columns_plain, mat, 2),
            **bound(ligero_dev.pad_words(r) // ligero_dev.RATE_WORDS * n, n * (r * 4 + 32)))
        columns_err = max(columns_err, err_here)
        del mat, columns_out
        torch.cuda.empty_cache()
    results.update(columns_at)

    for n in (1, 255, 4097):
        for r in (1, 33, 34, 543, 544, 545):
            mat = words(r, n)
            plain = ligero_dev._sha3_columns_plain(mat)
            columns_err = max(columns_err, byte_err(ligero_dev.sha3_columns(mat), plain))
            absorb_err = max(absorb_err, byte_err(stream_raw(mat), plain))
            check_columns(f"K4/K5 ({r}, {n})", plain, mat, sorted({0, n - 1}))
    for key in columns_at:
        results[key]["max_abs_err"] = max(results[key]["max_abs_err"], columns_err)
    results["absorb"]["max_abs_err"] = absorb_err
    if columns_err or absorb_err:
        raise AssertionError(f"kernels disagree with their plain versions: K4 {columns_err}, K5 {absorb_err}")
    for name, r in results.items():
        log(f"phase 2 {name}: kernel == plain == hashlib (max byte err {r['max_abs_err']}); "
            f"{r['shape']}: kernel {r['ms']} ms, plain {r['plain_ms']} ms, "
            f"bound {r['bound_ms']} ms by {r['bound_by']}")
    # The device functions that are torch ops: against their host twins,
    # then ms by CUDA events and launches by the profiler.
    def launches_of(fn, x) -> int:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn(x)
            torch.cuda.synchronize()
        return sum(ev.count for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA)

    def canonical(shape):
        return torch.randint(0, P, shape, device=dev, dtype=torch.int32, generator=gen)

    def host_u64(t):
        return t.cpu().numpy().astype("uint64")

    for n in (1, 255, 4097, 1 << 16):
        vals = canonical((n,))
        vals[:2] = torch.tensor([0, P - 1], device=dev, dtype=torch.int32)[:n]
        leaf_limbs = poseidon2.p2_leaves(vals)
        if poseidon2.limbs_to_bytes(leaf_limbs) != p2_host.np_batch_leaf_hashes(host_u64(vals)):
            raise AssertionError(f"p2_leaves differs from core/poseidon2.py at n={n}")
        level = canonical((8, 2 * n))
        if poseidon2.limbs_to_bytes(poseidon2.p2_merge(level)) != p2_host.np_batch_merge_hashes(
                poseidon2.limbs_to_bytes(level)):
            raise AssertionError(f"p2_merge differs from core/poseidon2.py at n={n}")
    for r, n in ((1, 1), (13, 256), (545, 128), (1100, 8)):
        mat = canonical((r, n))
        want = ligero._hash_columns(ligero.ntt_pow2_u32(host_u64(mat), 8 * n), "poseidon2")
        if poseidon2.limbs_to_bytes(poseidon2.p2_columns_stream(mat, 8 * n)) != want:
            raise AssertionError(f"the Poseidon2 column sponge differs from _hash_columns at ({r}, {n})")
    weights = host_u64(canonical((688,)))
    wide = words(688, 1 << 16)
    if not (ligero_dev.vecmat_device(weights, wide) == ligero._vecmat(weights, host_u64(wide))).all():
        raise AssertionError("vecmat_device differs from the host _vecmat")
    log("phase 2 torch ops: p2_leaves, p2_merge == core/poseidon2.py at 1, 255, 4097, 65536 hashes; column sponge == "
        "_hash_columns(poseidon2) at (1, 1), (13, 256), (545, 128), (1100, 8) rows x columns; vecmat_device == _vecmat: byte err 0")

    coeffs = words(544, 1 << 16)
    enc_block = ntt_dev.encode_rows(coeffs, n_e)
    leaf_vals = canonical((43 << 16,))
    leaf_level = canonical((8, 43 << 16))
    state_forest = canonical((16, poseidon2.CHUNK)).to(torch.int64)
    state_sponge = canonical((16, n_e)).to(torch.int64)
    torch_ops = {}
    for name, fn, x, reps in (
            (f"encode_rows (544, 65536) -> (544, {n_e})", lambda m: ntt_dev.encode_rows(m, n_e), coeffs, 5),
            (f"permute_device (16, {poseidon2.CHUNK}) [forest chunk]", poseidon2.permute_device, state_forest, 3),
            (f"permute_device (16, {n_e}) [column sponge]", poseidon2.permute_device, state_sponge, 5),
            (f"p2_leaves ({43 << 16},) [2^16-step forest]", poseidon2.p2_leaves, leaf_vals, 3),
            (f"p2_merge (8, {43 << 16})", poseidon2.p2_merge, leaf_level, 3),
            (f"p2_absorb one 544-row block at n_e = {n_e} (68 permutations)",
             lambda m: poseidon2.p2_absorb(state_sponge.clone(), m), enc_block, 1),
            ("vecmat_device (688,) x (688, 65536)", lambda m: ligero_dev.vecmat_device(weights, m), wide, 5)):
        torch_ops[name] = dict(ms=event_ms(fn, x, reps), launches=launches_of(fn, x))
        log(f"phase 2 torch op {name}: {torch_ops[name]['ms']} ms, {torch_ops[name]['launches']} launches")
    del coeffs, enc_block, leaf_vals, leaf_level, state_forest, state_sponge, wide
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
                "sumcheck_lasso_s", "commitments_s", "forest_plan")
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
    if prover.last_timings["forest_plan"]["discarded_levels"] or prover.last_timings["forest_plan"]["groups"] != 1:
        raise AssertionError(f"the shipped plan frees or groups at 2^22 steps: {prover.last_timings['forest_plan']}")
    log(f"phase 5 v1-nop-2^22: sha256 {sha(data)[:16]} == pinned, {len(data)} B, Accept, launches {main_counts}, "
        f"peak device memory {torch.cuda.max_memory_allocated(dev)} B allocated, "
        f"{torch.cuda.max_memory_reserved(dev)} B reserved")
    log(f"  port timings: {timings(prover)}")
    del data, program
    torch.cuda.empty_cache()

    # -- phases 6, 8, 9: the v2, v4 and v3 main paths -----------------------
    # Every advice commit is watched: the spy keeps the device twins' planes
    # and the host advice columns by reference, and after the prove has
    # returned each plane is held against its host column, on the card.
    # Nothing is copied, compared or synchronized inside the timed prove;
    # the twins are timed by CUDA events that are read afterwards.
    advice_seen = {}
    commit_mixed = unified.ligero_commit_mixed

    def watched_commit(F_, columns, hash_mode="sha3", *, device, dev_columns=None, group=None):
        if dev_columns:
            advice_seen["planes"] = dict(dev_columns)
            advice_seen["host"] = columns
        return commit_mixed(F_, columns, hash_mode, device=device, dev_columns=dev_columns, group=group)

    unified.ligero_commit_mixed = watched_commit
    twin_events = {}

    def timed_twin(twin_name):
        twin = getattr(advice_dev, twin_name)

        def run(*args, **kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = twin(*args, **kwargs)
            end.record()
            twin_events[twin_name] = (start, end)
            return out

        setattr(advice_dev, twin_name, run)

    for twin_name in ("core_logup_advice_dev", "regcheck_advice_dev", "bytecode_advice_dev"):
        timed_twin(twin_name)

    def check_advice_planes():
        """(planes, their bytes, ms per twin) of the last prove; raises where a
        plane differs from the host advice column of the same prove."""
        planes, host = advice_seen.pop("planes", {}), advice_seen.pop("host", {})
        for col_name, plane in planes.items():
            host_col = torch.from_numpy(host[col_name].astype("int64")).to(plane.device)
            if not torch.equal(plane.to(torch.int64), host_col):
                raise AssertionError(f"device advice plane {col_name} differs from the host advice column")
        if sorted({c.split(":")[0] for c in planes}) != ["bc", "rc", "v2"]:
            raise AssertionError(f"not every argument built its planes on the device: {sorted(planes)}")
        torch.cuda.synchronize()
        twin_ms = {name: start.elapsed_time(end) for name, (start, end) in twin_events.items()}
        return len(planes), sum(pl.numel() * pl.element_size() for pl in planes.values()), twin_ms

    def port_prove_v2(program, entry, segments, tape, max_steps, version=2):
        keccak.LAUNCHES.update(leaves=0, merge=0)
        ligero_dev.LAUNCHES.update(columns=0, absorb=0)
        poseidon2.PERMUTATIONS["count"] = 0
        ligero.STITCHED.update(dev_columns=0, host_rows=0)
        zerocheck_dev_ext.reset_counters()
        pipeline_lasso.DEVICE_ROUNDS["count"] = 0
        advice_seen.clear()
        twin_events.clear()
        torch.cuda.reset_peak_memory_stats(dev)
        prover = zt.Prover(F, seed=0, protocol_version=version)  # the default device: the card
        if prover.device.type != "cuda":
            raise AssertionError(f"Prover's default device is {prover.device}, not the card")
        proof = prover.prove(program, entry, None, max_steps, segments, tape)
        peak = torch.cuda.max_memory_allocated(dev)  # before the checks below allocate
        counts = {**keccak.LAUNCHES, **ligero_dev.LAUNCHES, "p2_permutations": poseidon2.PERMUTATIONS["count"]}
        if counts["columns"]:
            raise AssertionError(f"K4 is on no prove, yet the v{version} prove launched it: {counts}")
        # v2: SHA3 forest and sponge; v4: no forest; v3: Poseidon2 throughout.
        want = {2: (True, True, True, False), 3: (False, False, False, True), 4: (False, False, True, False)}[version]
        if tuple(bool(counts[k]) for k in ("leaves", "merge", "absorb", "p2_permutations")) != want:
            raise AssertionError(f"the v{version} prove's launches are not those of its path: {counts}")
        device_work = {"zerochecks": count_zerocheck_proofs(proof),
                       "device_zerochecks": zerocheck_dev_ext.DEVICE_PROVES["count"],
                       "sweep_launches": zerocheck_dev_ext.DEVICE_PROVES["sweep_launches"],
                       "columns_resident": zerocheck_dev_ext.COLUMNS["resident"],
                       "columns_uploaded": zerocheck_dev_ext.COLUMNS["uploaded"],
                       "lasso_device_rounds": pipeline_lasso.DEVICE_ROUNDS["count"],
                       "advice_planes_on_device": ligero.STITCHED["dev_columns"],
                       "advice_rows_uploaded": ligero.STITCHED["host_rows"]}
        if device_work["device_zerochecks"] != device_work["zerochecks"] or not device_work["zerochecks"]:
            raise AssertionError(f"not every zerocheck ran on the device: {device_work}")
        if not device_work["lasso_device_rounds"] or not device_work["columns_resident"]:
            raise AssertionError(f"the Lasso rounds or the resident columns were not used: {device_work}")
        planes_checked, planes_held_B, twin_ms = check_advice_planes()
        if not (device_work["advice_planes_on_device"] == planes_checked
                == prover.last_timings["advice_dev_cols"] == 148):
            raise AssertionError(f"the advice planes were not all built on the device: {device_work}, "
                                 f"{planes_checked} checked")
        device_work.update(advice_twins_ms=twin_ms, planes_held_for_the_check_B=planes_held_B)
        paths = (prover.last_timings["data_commit_path"], prover.last_timings["advice_commit_path"])
        if paths != ("stream-dev", "stream-dev"):
            raise AssertionError(f"the v{version} commits did not take the device path: {paths}")
        if bool(proof.witness_commitments) != (version != 4):
            raise AssertionError(f"v{version}: {len(proof.witness_commitments)} witness commitments")
        data = ser.serialize(proof)
        verdict = zt.Verifier(F).verify(ser.deserialize(data), program)
        if verdict != "Accept":
            raise AssertionError(f"the port's v{version} proof was rejected: {verdict}")
        return data, prover, counts, peak, device_work

    v2_keys = ("total_s", "execute_s", "data_commit_s", "data_assemble_s", "data_upload_s",
               "data_stream_s", "data_levels_s", "advice_build_s", "advice_dev_s", "advice_commit_s",
               "advice_assemble_s", "advice_upload_s", "advice_stream_s", "advice_levels_s",
               "zerochecks_s", "batch_eval_s", "open_s", "unified_s", "lasso_s", "witness_dev_s",
               "forest_s", "evals_s", "opens_s", "commitments_s")
    launches_at_2_20 = {}
    for phase, version, names in ((6, 2, ("v2-nop-2^16", "v2-fibonacci-10000", "v2-nop-2^20")),
                                  (8, 4, ("v4-nop-2^16", "v4-nop-2^20")),
                                  (9, 3, ("v3-nop-2^16", "v3-fibonacci-10000", "v3-nop-2^20"))):
        for name in names:
            program, entry, segments, tape, max_steps, case = load_case(name)
            data, prover, counts, peak, device_work = port_prove_v2(program, entry, segments, tape, max_steps, version)
            if name.endswith("nop-2^20"):
                launches_at_2_20[version] = counts
            t = prover.last_timings
            check_pinned(name, case, data, t["num_steps"])
            log(f"phase {phase} {name}: steps {t['num_steps']}, {len(data)} B, sha256 {sha(data)[:16]} == pinned, Accept, "
                f"commit paths {t['data_commit_path']}/{t['advice_commit_path']}, launches {counts}, "
                f"DATA commit (total_rows, n, n_e) {t['data_commit_shape']}, ADVICE {t['advice_commit_shape']}")
            log(f"phase {phase} {name} device rounds: zerochecks_s={t['zerochecks_s']} lasso_s={t['lasso_s']} "
                f"total_s={t['total_s']} advice_dev_s={t['advice_dev_s']} advice_upload_s={t['advice_upload_s']} "
                + " ".join(f"{k}={v}" for k, v in device_work.items())
                + f" planes == host advice columns (held after the prove) peak_device_memory_B={peak}")
            log("  port timings: " + " ".join(f"{k}={t[k]}" for k in v2_keys if k in t)
                + f" steps_per_s={t['num_steps'] / t['total_s']}")
            del data, program
            torch.cuda.empty_cache()
    v2_counts = launches_at_2_20[2]

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
    # Open the state whose matrix and encoded matrix lie on the device, and
    # the host state beside it: the same query row, columns and evaluations.
    point = [int(x) for x in torch.randint(1, P, (18,), generator=gen, device=dev).tolist()]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    opened = ligero.ligero_prove_eval(port_state, point, FiatShamirTranscript())
    evals = ligero.ligero_column_evals(port_state, point)
    open_s = time.perf_counter() - t0
    ref_opened = ligero.ligero_prove_eval(ref_state, point, FiatShamirTranscript())
    if not ((opened.us[0].c == ref_opened.us[0].c).all() and (opened.columns == ref_opened.columns).all()
            and opened.nodes == ref_opened.nodes and evals == ligero.ligero_column_evals(ref_state, point)):
        raise AssertionError("the opening of the device state differs from the host state's")
    if not ligero.ligero_verify_eval(F, port_state.root, 18, names, evals, point, opened, FiatShamirTranscript()):
        raise AssertionError("ligero_verify_eval rejected the opening of the ligero_commit_device state")
    log(f"phase 7 ligero_commit_device 43 x 2^18 ({port_state.m * 43} x {port_state.n_e} encoded): "
        f"root {port_state.root.hex()[:16]} == ligero_commit, {port_s} s (host ligero_commit {ref_s} s), "
        f"K4 launches {columns_launches}; opened through vecmat_device/column_evals_device in {open_s} s "
        f"== the host opening, ligero_verify_eval accepts")

    # -- phase 10: the forest's memory plan, where a reference exists -------
    @contextlib.contextmanager
    def forest_thresholds(discard, group):
        """commitments/device_forest.py's thresholds for the proves inside."""
        shipped = device_forest.DISCARD_DIGESTS, device_forest.GROUP_LEAF_DIGESTS
        device_forest.DISCARD_DIGESTS, device_forest.GROUP_LEAF_DIGESTS = discard, group
        try:
            yield
        finally:
            device_forest.DISCARD_DIGESTS, device_forest.GROUP_LEAF_DIGESTS = shipped

    for name, version in (("v1-nop-2^22", 1), ("v1-fibonacci-150000", 1), ("v3-nop-2^16", 3)):
        program, entry, segments, tape, max_steps, case = load_case(name)
        v = (case["num_steps"] - 1).bit_length()
        # level 3 of the 43 trees is the widest kept; 16 trees a group
        with forest_thresholds(discard=(43 << v) >> 3, group=16 << v):
            if version == 1:
                data, prover, counts = port_prove(program, entry, segments, tape, max_steps)
                if counts != {"leaves": 3 + 3, "merge": 3 * v + 3}:
                    raise AssertionError(f"{name}: launches {counts} are not those of 3 groups and 3 freed levels")
            else:
                data, prover, counts, _peak, _work = port_prove_v2(program, entry, segments, tape, max_steps, version)
        t = prover.last_timings
        check_pinned(name, case, data, t["num_steps"])
        plan = t["forest_plan"]
        if (plan["discarded_levels"], plan["groups"], plan["group_trees"]) != (3, 3, 16):
            raise AssertionError(f"{name}: the forced plan was not taken: {plan}")
        log(f"phase 10 {name} under a forced plan {plan}: sha256 {sha(data)[:16]} == pinned, {len(data)} B, Accept, "
            f"launches {counts}, forest_s={t['forest_s']} opens_s={t['opens_s']} total_s={t['total_s']}")
        del data, program
        torch.cuda.empty_cache()

    # -- phase 11: 2^25 steps, which the forest cannot hold whole ----------
    kept_forest = {}
    forest_type = prover_module.DeviceMerkleForest

    def keeping_forest(*args, **kwargs):
        kept_forest["forest"] = forest_type(*args, **kwargs)
        return kept_forest["forest"]

    def large_prove(v):
        """One v1 prove at 2^v NOP steps on the default device, verified:
        (proof, prover, K1/K2 launches)."""
        program = NOP * (1 << v)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        keccak.LAUNCHES.update(leaves=0, merge=0)
        prover = zt.Prover(F, seed=0)
        proof = prover.prove(program, 0x1000, None, 2 << v, None, None)
        counts = dict(keccak.LAUNCHES)
        peaks = torch.cuda.max_memory_allocated(dev), torch.cuda.max_memory_reserved(dev)
        if prover.device.type != "cuda" or proof.metadata.num_steps != 1 << v:
            raise AssertionError(f"2^{v} steps: proved {proof.metadata.num_steps} steps on {prover.device}")
        t0 = time.perf_counter()
        data = ser.serialize(proof)
        verdict = zt.Verifier(F).verify(ser.deserialize(data), program)
        if verdict != "Accept":
            raise AssertionError(f"the port's proof of 2^{v} steps was rejected: {verdict}")
        t = prover.last_timings
        log(f"phase 11 v1-nop-2^{v}: {len(data)} B, Accept (serialize, deserialize and verify "
            f"{time.perf_counter() - t0:.3f} s), launches {counts}, plan {t['forest_plan']}, "
            f"all levels would hold {43 * ((2 << v) - 1) * 32} B, "
            f"max_memory_allocated {peaks[0]} B, max_memory_reserved {peaks[1]} B")
        log(f"  port timings: {timings(prover)}")
        return proof, prover, counts

    prover_module.DeviceMerkleForest = keeping_forest
    v = 25
    proof, prover, large_counts = large_prove(v)
    prover_module.DeviceMerkleForest = forest_type
    plan = prover.last_timings["forest_plan"]
    if (plan["discarded_levels"], plan["group_trees"], plan["groups"]) != (3, 16, 3):
        raise AssertionError(f"the shipped plan at 2^25 steps is not D = 3 in groups of 16 trees: {plan}")
    if large_counts != {"leaves": 3 + 3, "merge": 3 * v + 3}:
        raise AssertionError(f"2^25 steps: launches {large_counts} are not those of the plan")
    forest = kept_forest.pop("forest")
    t0 = time.perf_counter()
    for i, commitment in enumerate(proof.witness_commitments):
        # tree i alone, every level kept
        level = keccak.sha3_leaves(forest.lo[i].to(torch.int64))
        opening = commitment.proof.merkle_proof
        siblings = []
        for k in range(v):
            siblings.append(level[(opening.index >> k) ^ 1])
            level = keccak.sha3_merge(level.view(-1, 8))
        if keccak.digests_to_bytes(level) != commitment.commitment:
            raise AssertionError(f"2^25 steps: the root of tree {i} differs from the tree built alone")
        want = keccak.digests_to_bytes(torch.stack(siblings))
        if b"".join(opening.path.siblings) != want:
            differ = [k for k in range(v) if opening.path.siblings[k] != want[32 * k : 32 * k + 32]]
            raise AssertionError(f"2^25 steps: tree {i}'s opened siblings differ at levels {differ}")
        if int(forest.lo[i, opening.index]) != opening.value.value:
            raise AssertionError(f"2^25 steps: tree {i}'s opened leaf value differs from the witness")
    log(f"phase 11 v1-nop-2^25: 43 roots and 43 x {v} opened siblings (levels 0..2 recomputed by open_all) == "
        f"each tree built alone by K1/K2 with every level kept ({time.perf_counter() - t0:.3f} s)")
    del forest, proof, level, siblings
    large_prove(24)
    with forest_thresholds(discard=1 << 62, group=1 << 62):
        _proof, prover, counts = large_prove(24)
    if prover.last_timings["forest_plan"]["discarded_levels"] or counts != {"leaves": 1, "merge": 24}:
        raise AssertionError(f"2^24 steps with nothing freed: {prover.last_timings['forest_plan']}, {counts}")
    del _proof
    torch.cuda.empty_cache()

    # -- phase 12: the base-field device zerocheck --------------------------
    n = 1 << 20
    zc_rng = np.random.default_rng(12)
    zc_cols = {name: zc_rng.integers(0, P, size=n, dtype=np.uint64) for name in ("a", "b", "g")}
    zc_cols["__sel__"] = zc_rng.integers(0, 2, size=n, dtype=np.uint64)
    zc_cols["__idx__"] = np.arange(n, dtype=np.uint64)
    zc_tau, zc_gamma = (int(x) for x in zc_rng.integers(1, P, size=2))

    def grand_product(cols, alphas, p):
        """Fingerprint products, public-column mixing, degree-3 gating."""
        sel, idx = cols["__sel__"], cols["__idx__"]
        a, b, g = cols["a"], cols["b"], cols["g"]
        fp = (zc_tau + p - (a + zc_gamma * b) % p) % p
        c1 = (g * fp + p - sel) % p
        c2 = sel * ((1 + p - sel) % p) % p
        c3 = sel * b % p * ((idx + a) % p) % p
        return (alphas[0] * c1 + alphas[1] * c2 + alphas[2] * c3) % p

    def zerocheck_run(zc_prover):
        transcript = FiatShamirTranscript()
        transcript.append_bytes(b"chip-smoke-zerocheck")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        zc = zc_prover.prove(transcript)
        seconds = time.perf_counter() - t0
        return (zc.num_vars, zc.degree, zc.round_evals, zc.final_point, zc.column_evals,
                transcript.challenge_value(P)), seconds

    zerocheck_gen.DEVICE_PROVES.update(count=0, sweep_launches=0)
    device_zc = make_zerocheck_prover(F, zc_cols, grand_product, 4, num_alphas=3, device=dev)
    if not isinstance(device_zc, zerocheck_gen.GenericDeviceZerocheck) or device_zc.device.type != "cuda":
        raise AssertionError(f"make_zerocheck_prover(device=card) gave {type(device_zc).__name__}")
    on_card, card_s = zerocheck_run(device_zc)
    on_host, host_s = zerocheck_run(NativeZerocheckProver(F, zc_cols, grand_product, 4, num_alphas=3))
    if on_card != on_host:
        raise AssertionError("the base-field device zerocheck differs from the native C++ prover")
    if zerocheck_gen.DEVICE_PROVES["count"] != 1 or not zerocheck_gen.DEVICE_PROVES["sweep_launches"]:
        raise AssertionError(f"the zerocheck did not run on the card: {zerocheck_gen.DEVICE_PROVES}")
    log(f"phase 12 base-field zerocheck, 5 columns x 2^20, degree 4: GenericDeviceZerocheck on the card == "
        f"NativeZerocheckProver (20 rounds, terminal evaluations {sorted(on_card[4])}, next challenge equal); "
        f"card {card_s} s with {zerocheck_gen.DEVICE_PROVES['sweep_launches']} sweep launches over "
        f"{20 - 12} device rounds, native host prover {host_s} s")

    # -- phase 13: the standalone modules ------------------------------------
    sc_rng = np.random.default_rng(13)
    poly = zt.Multilinear(F, sc_rng.integers(0, P, size=1 << 16, dtype=np.uint64))
    t0 = time.perf_counter()
    sc_proof = zt.SumcheckProver.prove(poly)
    sc_s = time.perf_counter() - t0
    ok, final_claim = zt.SumcheckVerifier.verify_rounds(F, sc_proof, poly.sum_over_hypercube())
    if not ok or final_claim.value != sc_proof.final_eval.value:
        raise AssertionError("SumcheckVerifier.verify_rounds rejected the 2^16 sumcheck proof")
    if zt.SumcheckVerifier.verify_rounds(F, sc_proof, poly.sum_over_hypercube().add(F.one()))[0]:
        raise AssertionError("SumcheckVerifier.verify_rounds accepted a wrong sum")
    table = build_xor_table(F, 4)
    picks = [int(i) for i in sc_rng.integers(0, len(table), size=64)]
    queries = [lasso.LookupQuery(inputs=table.entry(i).inputs, expected_outputs=table.entry(i).outputs)
               for i in picks]
    lasso_proof = lasso.LassoProver.prove_with_mapping(F, table, queries, picks)
    query_sum = F(sum(lasso.hash_entry_chain(F, q.input_values(), q.output_values()).value for q in queries) % P)
    ok, _claim = zt.SumcheckVerifier.verify_rounds(F, lasso_proof.sumcheck_proof, query_sum)
    fast = lasso.LassoVerifier.verify_fast(F, lasso_proof, lasso_proof.table_commitment, len(queries),
                                           lasso_proof.sumcheck_proof.final_eval)
    wrong_table = lasso.LassoVerifier.verify(F, lasso_proof, build_xor_table(F, 3), len(queries))
    if not (ok and fast.is_valid) or wrong_table.is_valid:
        raise AssertionError(f"the Lasso round trip failed: rounds {ok}, {fast.reason}; wrong table: {wrong_table.reason}")
    matrix = sc_rng.integers(0, P, size=(43, 1 << 12), dtype=np.uint64)
    if not host_forest.available():
        raise RuntimeError("zigz_sha3_forest is not in the host runtime")
    t0 = time.perf_counter()
    on_host = host_forest.HostMerkleForest(F, matrix)
    host_forest_s = time.perf_counter() - t0
    on_card = device_forest.DeviceMerkleForest(F, lo=witness_dev.from_numpy(matrix.astype(np.uint32), dev))
    indices = sc_rng.integers(0, 1 << 12, size=43)
    if on_host.roots() != on_card.roots() or any(
            (a.index, a.value.value, a.path.siblings, a.path.directions)
            != (b.index, b.value.value, b.path.siblings, b.path.directions)
            for a, b in zip(on_host.open_all(indices), on_card.open_all(indices))):
        raise AssertionError("HostMerkleForest differs from DeviceMerkleForest at 43 x 2^12")
    log(f"phase 13 standalone: SumcheckProver.prove on 2^16 values in {sc_s:.3f} s, verify_rounds accepts "
        f"({len(sc_proof.to_bytes())} B); Lasso: 64 queries into the 4-bit XOR table, rounds verify, verify_fast "
        f"accepts, another table rejected ({wrong_table.reason}); HostMerkleForest 43 x 2^12 in "
        f"{host_forest_s:.3f} s: roots and 43 openings == DeviceMerkleForest on the card")

    group_launches = group_phases(pinned)

    # -- the contract's lines ----------------------------------------------
    def entry_of(name, key, source, replaces, launches):
        r = results[key]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"],
                "shape": r["shape"],
                "launches_v4": launches_at_2_20[4][key], "launches_v3": launches_at_2_20[3][key],
                "launches_large": large_counts.get(key, 0),
                # per rank, two ranks sharing the card (phase 15)
                "launches_group_v1_2_22": [c[GROUP_KEYS[key]] for c in group_launches["v1-nop-2^22"]],
                "launches_group_v2_2_20": [c[GROUP_KEYS[key]] for c in group_launches["v2-nop-2^20"]]}

    sha3_source = "zigz_tpu_torch/csrc/sha3_kernels.cu"
    ligero_source = "zigz_tpu_torch/csrc/ligero_kernels.cu"
    # K3, the permutation, is a device function inlined in the four kernels
    # and has no launch of its own: it runs in every launch of K1 and K2, and
    # K2 is exactly one permutation per thread, so its entry carries K2's
    # measurements and the sum of K1's and K2's launches.
    permutation = dict(entry_of("keccak_f1600 (K3)", "merge", "zigz_tpu_torch/csrc/keccak.cuh",
                                "zigz_tpu/ops/keccak_pallas.py:60", main_counts["leaves"] + main_counts["merge"]),
                       inlined_in=["K1", "K2", "K4", "K5"], measured_as="K2: one permutation per thread",
                       launches_large=large_counts["leaves"] + large_counts["merge"],
                       **{f"launches_group_{tag}": [c["K1"] + c["K2"] for c in group_launches[name]]
                          for tag, name in (("v1_2_22", "v1-nop-2^22"), ("v2_2_20", "v2-nop-2^20"))})
    kernels_line = {"kernels": [
        entry_of("sha3_leaves (K1)", "leaves", sha3_source, "zigz_tpu/ops/keccak_pallas.py:93",
                 main_counts["leaves"]),
        entry_of("sha3_merge (K2)", "merge", sha3_source, "zigz_tpu/ops/keccak_pallas.py:108",
                 main_counts["merge"]),
        permutation,
        dict(entry_of("sha3_columns (K4)", "columns", ligero_source, "zigz_tpu/ops/ligero_dev.py:45",
                      group_launches["v2-nop-2^20"][0]["K4"]),
             launches_commit_device=columns_launches,
             other_shapes=[{k: results[key][k] for k in ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                                         "bound_by")}
                           for key in ("columns_data_shard", "columns_commit_device")]),
        entry_of("sha3_absorb (K5)", "absorb", ligero_source, "zigz_tpu/ops/ligero_dev.py:256",
                 v2_counts["absorb"]),
    ]}
    log(json.dumps({"torch_ops": torch_ops}))
    log(json.dumps(kernels_line))
    log(info["nvidia_smi"])
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


def rank_main(argv) -> int:
    """One rank of phases 14 and 15 (``--rank <job dir> <rank>``): the
    port's worker with the rank functions of tests/torch_group_checks.py,
    jax and zigz_tpu blocked as in the script itself."""
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    import torch_group_checks  # the rank functions of phases 14 and 15

    torch_group_checks.worker_main(argv, torch_group_checks.FUNCTIONS)
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "zigz_tpu") and sys.modules[m] is not None)
    if loaded:
        raise AssertionError(f"a rank imported {loaded}")
    return 0


if __name__ == "__main__":
    sys.exit(rank_main(sys.argv[2:]) if sys.argv[1:2] == ["--rank"] else main())
