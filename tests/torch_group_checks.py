"""Rank functions for the tests of the port's process groups, and the rank
command that knows them.

    python tests/torch_group_checks.py <job dir> <rank>

is one rank of a job of ``zigz_tpu_torch.parallel.launch.launch(...,
command=COMMAND)``: the package's worker with the functions below beside its
own.  tests/test_torch_*.py and chip_smoke.py launch them on gloo CPU ranks
and on ranks that share a card.  The module imports the port and nothing of
JAX or of the JAX package.

* ``checks``: the group's pieces one by one (the collective wrappers, the
  distributed sumcheck, the proving step, the sharded Ligero commit, the
  mixed commit and its opening, the batch-evaluation rounds, the forest,
  the witness slices, the Lasso rounds and the base-field zerocheck).
  Inputs are made from the spec's seeds with numpy, the same on every rank
  and in whoever launched the job, so a caller can hold a rank's result
  against its own computation of the same inputs; every check also runs the
  unsharded path on the rank and reports ``equal_single``.  Outputs come
  back as hex strings or integer lists when ``return_data`` is set (small
  shapes) and always as a SHA-256.
* ``prove_lost_rank``: the package's ``prove`` job, except that rank
  ``spec["lost_rank"]`` kills itself first (after ``initialize``): a lost
  host, with no cleanup and no exit handlers.
* ``prove_forced_plan``: the package's ``prove`` job under the forest
  thresholds of ``spec["forest_plan"]``.
"""

from __future__ import annotations

import hashlib
import os
import signal
import sys
import time
from typing import Dict

import numpy as np
import torch

from zigz_tpu_torch.core.field import BabyBear
from zigz_tpu_torch.core.hash import FiatShamirTranscript
from zigz_tpu_torch.device import synchronize
from zigz_tpu_torch.parallel import dist, jobs
from zigz_tpu_torch.parallel.jobs import counters, make_program, reset_counters, seeded
from zigz_tpu_torch.parallel.launch import launch, worker_main

COMMAND = [sys.executable, os.path.abspath(__file__)]  # launch(..., command=COMMAND)
P = BabyBear.MODULUS


def launch_checks(n_ranks: int, checks_list, **kwargs):
    """``launch`` of the ``checks`` function on ranks that know it."""
    return launch(n_ranks, "checks", {"checks": checks_list}, command=COMMAND, **kwargs)


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _tensor_bytes(t: torch.Tensor) -> bytes:
    return t.cpu().contiguous().numpy().tobytes()


def _check_wrappers(group, c: dict) -> dict:
    """Every collective wrapper and both layouts on small seeded tensors."""
    D, rank, dev = group.world_size, group.rank, group.device
    out = {}
    base = torch.arange(6, dtype=torch.int64, device=dev)
    out["all_reduce"] = dist.all_reduce_sum(group, base * (rank + 1)).tolist()
    out["all_gather"] = dist.all_gather_cat(group, (base[:3] + 10 * rank)[None, :], 1).tolist()
    rows_loc, n = 3, 4 * D
    whole = torch.from_numpy(seeded(c["seed"], (rows_loc * D, n)).astype(np.int64)).to(torch.int32)
    mine = whole[rank * rows_loc : (rank + 1) * rows_loc].to(dev)
    cols = dist.rows_to_columns(group, mine)
    out["rows_to_columns_ok"] = bool(torch.equal(cols.cpu(), whole[:, rank * 4 : (rank + 1) * 4]))
    out["shard_rows_shape"] = list(dist.shard_rows(group, np.zeros((43, 256), dtype=np.uint32)).shape)
    out["shard_rows_axis0_shape"] = list(dist.shard_rows(group, np.zeros((8 * D, 5)), axis=0).shape)
    values = torch.from_numpy(seeded(c["seed"] + 1, (2, 8 * D)).astype(np.int64))
    local = dist.shard_cyclic(group, values).to(dev)
    out["cyclic_first"] = local[0, :2].tolist()
    out["gather_cyclic_ok"] = bool(torch.equal(dist.gather_cyclic(group, local.contiguous()).cpu(), values))
    contiguous = dist.shard_rows(group, values).to(dev)
    out["gather_last_ok"] = bool(torch.equal(dist.all_gather_last(group, contiguous.contiguous()).cpu(), values))
    mine = (torch.arange(D, dtype=torch.int64, device=dev) + 100 * rank)[:, None]
    out["exchange_rows"] = dist.exchange_rows(group, mine, [1] * D, [1] * D)[:, 0].tolist()
    out["collectives"] = dict(dist.COLLECTIVES)
    return out


def _check_dist_sumcheck(group, c: dict) -> dict:
    from zigz_tpu_torch.poly.multilinear import Multilinear
    from zigz_tpu_torch.proofs.sumcheck import SumcheckProver

    vals = seeded(c["seed"], 1 << c["log2_n"])
    t0 = time.perf_counter()
    proof = dist.DistSumcheckProver(BabyBear, group).prove(vals)
    seconds = time.perf_counter() - t0
    data = proof.to_bytes()
    host = SumcheckProver.prove(Multilinear(BabyBear, vals.copy())).to_bytes()
    out = {"sha256": _sha(data), "equal_single": data == host, "num_vars": proof.num_vars, "seconds": seconds}
    if c.get("return_data"):
        out["hex"] = data.hex()
    return out


def _check_prove_step(group, c: dict) -> dict:
    B, v, dev = c["B"], c["v"], group.device
    matrix = torch.from_numpy(seeded(c["seed"], (B, 1 << v)).astype(np.int64))
    points = torch.from_numpy(seeded(c["seed"] + 1, (B, v)).astype(np.int64)).to(dev)
    r = torch.from_numpy(seeded(c["seed"] + 2, 1).astype(np.int64)).to(dev)
    local = dist.shard_rows(group, matrix).contiguous().to(dev)
    t0 = time.perf_counter()
    evals, g0, g1, folded = dist.device_prove_step(local, points, r, group)
    synchronize(dev)
    seconds = time.perf_counter() - t0
    folded = dist.all_gather_last(group, folded.contiguous())
    want = dist.device_prove_step(matrix.to(dev), points, r)
    got = (evals, g0, g1, folded)
    out = {
        "equal_single": all(torch.equal(a, b) for a, b in zip(got, want)),
        "sha256": _sha(b"".join(_tensor_bytes(t) for t in got)),
        "seconds": seconds,
    }
    if c.get("return_data"):
        out.update(evals=evals.tolist(), g0=g0.tolist(), g1=g1.tolist(), folded=folded.tolist())
    return out


def _check_commit(group, c: dict) -> dict:
    """``commit_columns_mesh`` and ``MeshEncoded.gather`` against the
    unsharded ``sha3_columns_stream`` and ``StreamedEncoded.gather``."""
    from zigz_tpu_torch.ops.keccak import digests_to_bytes
    from zigz_tpu_torch.ops.ligero_dev import StreamedEncoded, sha3_columns_stream
    from zigz_tpu_torch.ops.ligero_mesh import MeshEncoded, commit_columns_mesh, mesh_commit_ok

    rows, n, n_e, dev = c["rows"], c["n"], c["n_e"], group.device
    mat = seeded(c["seed"], (rows, n)).astype(np.uint32)
    idx = np.random.default_rng(c["seed"] + 1).integers(0, n_e, size=c["n_gather"]).tolist()
    reset_counters()
    t0 = time.perf_counter()
    blob, mat_loc = commit_columns_mesh(group, mat, n_e)
    synchronize(dev)
    seconds = time.perf_counter() - t0
    launches = counters()
    cols = MeshEncoded(group, mat_loc, n_e, rows).gather(idx)
    out = {
        "ok_predicate": mesh_commit_ok(group, n_e, rows),
        "sha256": _sha(blob),
        "gather_sha256": _sha(np.ascontiguousarray(cols).tobytes()),
        "seconds": seconds,
        "launches": launches,
    }
    whole = torch.from_numpy(mat.view(np.int32)).to(dev)
    single = digests_to_bytes(sha3_columns_stream(whole, n_e))
    out["equal_single"] = blob == single and bool(np.array_equal(cols, StreamedEncoded(whole, n_e).gather(idx)))
    if c.get("return_data"):
        out.update(hex=blob.hex(), columns=cols.tolist())
    return out


def _mixed_columns(c: dict) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(c["seed"])
    return {name: rng.integers(0, P, size=1 << v, dtype=np.uint64)
            for name, v in zip("abcdefgh", c["log2_sizes"])}


def _check_mixed_commit(group, c: dict) -> dict:
    """The public mixed API under a group: commit, open at a transcript
    point, verify; against the same calls without a group."""
    from zigz_tpu_torch.commitments.ligero import (LigeroParams, choose_split_mixed, ligero_commit_mixed,
                                      ligero_prove_mixed, ligero_verify_mixed)
    from zigz_tpu_torch.core.ext4 import challenge_ext
    from zigz_tpu_torch.ops.ligero_mesh import MeshEncoded
    from zigz_tpu_torch.proofs.batch_eval import _mle_eval_tail, mixed_claim_from_rho

    cols = _mixed_columns(c)
    v_max = max(c["log2_sizes"])
    hash_mode = c.get("hash_mode", "sha3")
    state = ligero_commit_mixed(BabyBear, cols, hash_mode, device=group.device, group=group)
    single = ligero_commit_mixed(BabyBear, cols, hash_mode, device=group.device)
    t_point = FiatShamirTranscript()
    rho = [challenge_ext(t_point) for _ in range(v_max)]
    evals = {name: _mle_eval_tail(arr, rho[v_max - (len(arr).bit_length() - 1):]) for name, arr in cols.items()}
    cn = choose_split_mixed(sum(len(a) for a in cols.values()), 1, LigeroParams())
    claim = mixed_claim_from_rho(state.col_vars, cn, rho, evals)
    got = ligero_prove_mixed(state, [claim], FiatShamirTranscript())
    want = ligero_prove_mixed(single, [claim], FiatShamirTranscript())
    us = [u.c.tolist() for u in got.us]
    out = {
        "sharded": isinstance(state.encoded, MeshEncoded),
        "commit_path": state.commit_path,
        "single_commit_path": single.commit_path,
        "root": state.root.hex(),
        "columns_sha256": _sha(np.ascontiguousarray(got.columns).tobytes()),
        "us": us,
        "equal_single": state.root == single.root and bool(np.array_equal(got.columns, want.columns))
        and us == [u.c.tolist() for u in want.us] and got.nodes == want.nodes,
        "verified": bool(ligero_verify_mixed(BabyBear, state.root, dict(state.col_vars), [claim], got,
                                             FiatShamirTranscript(), hash_mode)),
        "device_column_resident": state.device_column(state.names[0]) is not None,
    }
    return out


def _batch_eval_inputs(c: dict):
    """(claims, columns) of the batch evaluation over seeded columns of
    ``c["log2_sizes"]`` variables: even ones carry an evaluation claim at a
    transcript point, odd ones a hypercube-sum claim."""
    from zigz_tpu_torch.core.ext4 import challenge_ext, ext_lift
    from zigz_tpu_torch.proofs.batch_eval import BatchClaim
    from zigz_tpu_torch.proofs.zerocheck import _eq_table_ext

    rng = np.random.default_rng(c["seed"])
    cols, claims = {}, []
    t0 = FiatShamirTranscript()
    for i, v in enumerate(c["log2_sizes"]):
        col = rng.integers(0, P, size=1 << v, dtype=np.uint64)
        cols[("data", f"c{i}")] = col
        if i % 2 == 0:
            pt = [challenge_ext(t0) for _ in range(v)]
            claims.append(BatchClaim("data", f"c{i}", v, pt, (_eq_table_ext(pt, P) * col).sum()))
        else:
            claims.append(BatchClaim("data", f"c{i}", v, None, ext_lift(int(col.sum() % P))))
    return claims, cols


def _batch_eval_summary(proof, transcript) -> dict:
    return {
        "round_evals": [[e.to_ints() for e in evals] for evals in proof.round_evals],
        "final_point": [r.to_ints() for r in proof.final_point],
        "column_evals": {"/".join(k): v.to_ints() for k, v in sorted(proof.column_evals.items())},
        "next_challenge": int(transcript.challenge(BabyBear).value),
    }


def _check_batch_eval(group, c: dict) -> dict:
    from zigz_tpu_torch.ops.batch_eval_dev import MESH_ROUNDS, mesh_rounds_ok
    from zigz_tpu_torch.proofs.batch_eval import prove_batch_eval

    claims, cols = _batch_eval_inputs(c)
    timings = {}
    MESH_ROUNDS["count"] = 0
    t1 = FiatShamirTranscript()
    t0 = time.perf_counter()
    got = _batch_eval_summary(prove_batch_eval(claims, cols, t1, group=group, timings=timings), t1)
    seconds = time.perf_counter() - t0
    t2 = FiatShamirTranscript()
    want = _batch_eval_summary(prove_batch_eval(claims, cols, t2), t2)
    out = {
        "ok_predicate": mesh_rounds_ok(group, max(c["log2_sizes"])),
        "sharded": timings["batch_eval_sharded"],
        "mesh_rounds": MESH_ROUNDS["count"],
        "equal_single": got == want,
        "sha256": _sha(repr(got).encode()),
        "seconds": seconds,
    }
    if c.get("return_data"):
        out.update(got)
    return out


def _forest_summary(forest, indices, points) -> dict:
    openings = forest.open_all(indices)
    return {
        "roots": [r.hex() for r in forest.roots()],
        "evals": forest.eval_backend(None, points).tolist(),
        "openings": [
            [o.index, int(o.value.value), [s.hex() for s in o.path.siblings], list(o.path.directions)]
            for o in openings
        ],
    }


def _check_forest(group, c: dict) -> dict:
    """The forest over this rank's leaf slice against the forest over the
    whole matrix, optionally under a forced memory plan."""
    from zigz_tpu_torch.commitments import device_forest
    from zigz_tpu_torch.ops import witness_dev

    B, v, dev = c["B"], c["v"], group.device
    matrix = seeded(c["seed"], (B, 1 << v)).astype(np.uint32)
    indices = np.random.default_rng(c["seed"] + 1).integers(0, 1 << v, size=B)
    points = seeded(c["seed"] + 2, (B, v))
    whole = device_forest.DeviceMerkleForest(BabyBear, lo=witness_dev.from_numpy(matrix, dev),
                                             hash_mode=c.get("hash_mode", "sha3"))
    want = _forest_summary(whole, indices, points)
    saved = device_forest.DISCARD_DIGESTS, device_forest.GROUP_LEAF_DIGESTS
    if "discard_digests" in c:
        device_forest.DISCARD_DIGESTS = c["discard_digests"]
        device_forest.GROUP_LEAF_DIGESTS = c["group_leaf_digests"]
    try:
        local = witness_dev.from_numpy(np.ascontiguousarray(dist.shard_rows(group, matrix)), dev)
        forest = device_forest.DeviceMerkleForest(BabyBear, lo=local, hash_mode=c.get("hash_mode", "sha3"),
                                                  group=group)
        got = _forest_summary(forest, indices, points)
    finally:
        device_forest.DISCARD_DIGESTS, device_forest.GROUP_LEAF_DIGESTS = saved
    out = {"equal_single": got == want, "plan": forest.plan(), "sha256": _sha(repr(got).encode())}
    if c.get("return_data"):
        out.update(got)
    return out


def _check_witness(group, c: dict) -> dict:
    """This rank's witness slice against the same columns of the whole
    device witness, for a program run on the native VM."""
    from zigz_tpu_torch.constraints.witness import num_vars_for_steps
    from zigz_tpu_torch.elf import is_elf, load
    from zigz_tpu_torch.ops import witness_dev
    from zigz_tpu_torch.runtime.native_vm import NativeVM, raise_for_status

    program = make_program(c["program"])
    nvm = NativeVM()
    entry_pc = 0x1000
    if is_elf(program):
        loaded = load(program)
        entry_pc = loaded.entry_pc
        for seg in loaded.segments:
            nvm.load_segment(seg.vaddr, seg.data)
    else:
        nvm.load_segment(entry_pc, program)
    result = nvm.run(entry_pc, c["max_steps"], None, c.get("input_tape"))
    raise_for_status(result["status"])
    trace = result["trace"]
    num_vars = num_vars_for_steps(trace.step_count())
    whole = witness_dev.build_witness(trace, trace.initial_regs, num_vars, group.device)
    local = witness_dev.build_witness(trace, trace.initial_regs, num_vars, group.device, group=group)
    gathered = dist.all_gather_last(group, local)
    return {
        "num_steps": trace.step_count(),
        "slice_shape": list(local.shape),
        "equal_single": bool(torch.equal(local, dist.shard_rows(group, whole))) and bool(torch.equal(gathered, whole)),
        "sha256": _sha(_tensor_bytes(gathered)),
    }


def _check_lasso_rounds(group, c: dict) -> dict:
    from zigz_tpu_torch.lookups.pipeline_lasso import _sumcheck_rounds_device

    evals = seeded(c["seed"], 1 << c["log2_n"])

    def run(g):
        rounds, point, final = _sumcheck_rounds_device(
            BabyBear, FiatShamirTranscript(), evals, group.device, c.get("host_tail"), g)
        return [[x.value for x in coeffs] for coeffs in rounds], [x.value for x in point], final.value

    before = dist.COLLECTIVES["all_reduce"]
    got = run(group)
    out = {"equal_single": got == run(None), "all_reduces": dist.COLLECTIVES["all_reduce"] - before,
           "sha256": _sha(repr(got).encode())}
    if c.get("return_data"):
        out.update(rounds=got[0], point=got[1], final=got[2])
    return out


def _zc_combiner(t, alphas, p):
    """eq-weighted a * b - c, with one alpha on a second vanishing term."""
    return (t["a"] * t["b"] - t["c"]) % p + alphas[0] * ((t["a"] - t["a"]) % p) % p


def _check_zerocheck_gen(group, c: dict) -> dict:
    from zigz_tpu_torch.ops.zerocheck_gen import GenericDeviceZerocheck

    n = 1 << c["log2_n"]
    a, b = seeded(c["seed"], n), seeded(c["seed"] + 1, n)
    columns = {"a": a, "b": b, "c": a * b % np.uint64(P)}

    def run(g):
        prover = GenericDeviceZerocheck(BabyBear, columns, _zc_combiner, 2, num_alphas=1,
                                        host_tail=c.get("host_tail"), device=group.device, group=g)
        t = FiatShamirTranscript()
        proof = prover.prove(t)
        return (proof.round_evals, proof.final_point, sorted(proof.column_evals.items()),
                int(t.challenge(BabyBear).value))

    got = run(group)
    out = {"equal_single": got == run(None), "sha256": _sha(repr(got).encode())}
    if c.get("return_data"):
        out.update(round_evals=got[0], final_point=got[1], column_evals=dict(got[2]), next_challenge=got[3])
    return out


_CHECKS = {
    "wrappers": _check_wrappers,
    "dist_sumcheck": _check_dist_sumcheck,
    "prove_step": _check_prove_step,
    "commit": _check_commit,
    "mixed_commit": _check_mixed_commit,
    "batch_eval": _check_batch_eval,
    "forest": _check_forest,
    "witness": _check_witness,
    "lasso_rounds": _check_lasso_rounds,
    "zerocheck_gen": _check_zerocheck_gen,
}


def checks(group, spec: dict, work_dir: str) -> dict:
    """Run ``spec["checks"]`` (each ``{"name", "kind", ...}``) in order;
    ``results[name]`` is the check's dictionary."""
    results = {}
    for c in spec["checks"]:
        t0 = time.perf_counter()
        results[c["name"]] = _CHECKS[c["kind"]](group, c)
        results[c["name"]]["check_s"] = time.perf_counter() - t0
    return {"rank": group.rank, "world_size": group.world_size, "device": str(group.device),
            "results": results}


def prove_lost_rank(group, spec: dict, work_dir: str) -> dict:
    if group.rank == spec["lost_rank"]:
        os.kill(os.getpid(), signal.SIGKILL)
    return jobs.prove(group, spec, work_dir)


def prove_forced_plan(group, spec: dict, work_dir: str) -> dict:
    from zigz_tpu_torch.commitments import device_forest

    device_forest.DISCARD_DIGESTS = spec["forest_plan"]["discard_digests"]
    device_forest.GROUP_LEAF_DIGESTS = spec["forest_plan"]["group_leaf_digests"]
    return jobs.prove(group, spec, work_dir)


FUNCTIONS = {"checks": checks, "prove_lost_rank": prove_lost_rank, "prove_forced_plan": prove_forced_plan}

if __name__ == "__main__":
    worker_main(sys.argv[1:], FUNCTIONS)
