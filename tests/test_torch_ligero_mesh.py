"""Sharded Ligero commits and batch-evaluation rounds of the port
(ops/ligero_mesh.py, ops/batch_eval_dev.py) on 2 and 4 gloo CPU ranks
against zigz_tpu's host path on the same seeded inputs: the cases of
tests/test_ligero_mesh.py at their shapes.  Bytes and canonical integers:
tolerance zero."""

import hashlib

import numpy as np
import pytest

from zigz_tpu.commitments.ligero import (
    LigeroParams,
    _hash_columns,
    choose_split_mixed,
    ligero_commit_mixed,
    ligero_prove_mixed,
    ligero_verify_mixed,
    ntt_pow2_u32,
)
from zigz_tpu.core.ext4 import challenge_ext, ext_lift
from zigz_tpu.core.field import BabyBear as F
from zigz_tpu.core.hash import FiatShamirTranscript
from zigz_tpu.proofs.batch_eval import BatchClaim, _mle_eval_tail, mixed_claim_from_rho, prove_batch_eval
from zigz_tpu.proofs.zerocheck import _eq_table_ext
from zigz_tpu_torch.parallel.jobs import seeded
from torch_group_checks import launch_checks

P = 2013265921
BLOB_SHAPES = ((37, 128), (344, 64), (8, 512))  # rows not divisible by the ranks
GATHER = {"rows": 53, "n": 128, "count": 23}
MIXED_SIZES = [12, 11, 8]
BATCH_SIZES = [10, 10, 8, 6]

CHECKS = [
    {"name": f"blob{rows}x{n}", "kind": "commit", "seed": 100 + i, "rows": rows, "n": n, "n_e": 4 * n,
     "n_gather": 4, "return_data": True}
    for i, (rows, n) in enumerate(BLOB_SHAPES)
] + [
    {"name": "gather", "kind": "commit", "seed": 1, "rows": GATHER["rows"], "n": GATHER["n"], "n_e": 4 * GATHER["n"],
     "n_gather": GATHER["count"], "return_data": True},
    {"name": "mixed", "kind": "mixed_commit", "seed": 2, "log2_sizes": MIXED_SIZES},
    {"name": "batch_eval", "kind": "batch_eval", "seed": 3, "log2_sizes": BATCH_SIZES, "return_data": True},
    {"name": "batch_eval_too_small", "kind": "batch_eval", "seed": 4, "log2_sizes": [2, 1]},
]
RANKS = (2, 4)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return {
        D: launch_checks(D, CHECKS, work_dir=str(tmp_path_factory.mktemp(f"ranks{D}")), device="cpu", timeout_s=300)
        for D in RANKS
    }


@pytest.mark.parametrize("D", RANKS)
@pytest.mark.parametrize("i", range(len(BLOB_SHAPES)))
def test_mesh_digest_blob_byte_identical(results, D, i):
    rows, n = BLOB_SHAPES[i]
    mat = seeded(100 + i, (rows, n))
    want = _hash_columns(ntt_pow2_u32(mat, 4 * n), "sha3")
    for res in results[D]:
        check = res["results"][f"blob{rows}x{n}"]
        assert check["ok_predicate"] and check["equal_single"]
        assert bytes.fromhex(check["hex"]) == want


@pytest.mark.parametrize("D", RANKS)
def test_mesh_gather_matches_host_encode(results, D):
    rows, n, count = GATHER["rows"], GATHER["n"], GATHER["count"]
    mat = seeded(1, (rows, n))
    idx = np.random.default_rng(2).integers(0, 4 * n, size=count).tolist()
    want = ntt_pow2_u32(mat, 4 * n)[:, idx].T.astype(np.uint64)
    for res in results[D]:
        check = res["results"]["gather"]
        assert check["equal_single"]
        got = np.array(check["columns"], dtype=np.uint64)
        assert got.shape == (count, rows) and np.array_equal(got, want)


@pytest.mark.parametrize("D", RANKS)
def test_mixed_commit_and_open_mesh_byte_identical(results, D):
    """Commit -> open -> verify through the public mixed API: the sharded
    commit's root and opened proof equal zigz_tpu's host path's, and
    zigz_tpu's verifier accepts."""
    rng = np.random.default_rng(2)
    cols = {name: rng.integers(0, P, size=1 << v, dtype=np.uint64) for name, v in zip("abc", MIXED_SIZES)}
    host = ligero_commit_mixed(F, cols, "sha3")
    v_max = max(MIXED_SIZES)
    t_point = FiatShamirTranscript()
    rho = [challenge_ext(t_point) for _ in range(v_max)]
    evals = {name: _mle_eval_tail(arr, rho[v_max - (len(arr).bit_length() - 1):]) for name, arr in cols.items()}
    cn = choose_split_mixed(sum(len(a) for a in cols.values()), 1, LigeroParams())
    claim = mixed_claim_from_rho(host.col_vars, cn, rho, evals)
    want = ligero_prove_mixed(host, [claim], FiatShamirTranscript())
    assert ligero_verify_mixed(F, host.root, dict(host.col_vars), [claim], want, FiatShamirTranscript())
    for res in results[D]:
        check = res["results"]["mixed"]
        assert check["sharded"] and check["commit_path"] == "mesh" and check["single_commit_path"] == "stream-dev"
        assert not check["device_column_resident"]  # no rank holds the whole matrix
        assert check["equal_single"] and check["verified"]
        assert bytes.fromhex(check["root"]) == host.root
        assert check["columns_sha256"] == hashlib.sha256(np.ascontiguousarray(want.columns).tobytes()).hexdigest()
        assert check["us"] == [u.c.tolist() for u in want.us]


@pytest.mark.parametrize("D", RANKS)
def test_batch_eval_mesh_rounds_byte_identical(results, D):
    rng = np.random.default_rng(3)
    cols, claims = {}, []
    t0 = FiatShamirTranscript()
    for i, v in enumerate(BATCH_SIZES):
        col = rng.integers(0, P, size=1 << v, dtype=np.uint64)
        cols[("data", f"c{i}")] = col
        if i % 2 == 0:
            pt = [challenge_ext(t0) for _ in range(v)]
            claims.append(BatchClaim("data", f"c{i}", v, pt, (_eq_table_ext(pt, P) * col).sum()))
        else:
            claims.append(BatchClaim("data", f"c{i}", v, None, ext_lift(int(col.sum() % P))))
    t1 = FiatShamirTranscript()
    want = prove_batch_eval(claims, cols, t1)
    next_challenge = int(t1.challenge(F).value)
    for res in results[D]:
        check = res["results"]["batch_eval"]
        assert check["ok_predicate"] and check["sharded"] and check["mesh_rounds"] == 2 and check["equal_single"]
        assert check["round_evals"] == [[list(e.to_ints()) for e in evals] for evals in want.round_evals]
        assert check["final_point"] == [list(r.to_ints()) for r in want.final_point]
        assert check["column_evals"] == {"/".join(k): list(v.to_ints()) for k, v in sorted(want.column_evals.items())}
        # the transcripts agree after the reduction: the same absorbs
        assert check["next_challenge"] == next_challenge


@pytest.mark.parametrize("D", RANKS)
def test_batch_eval_below_the_predicate_runs_the_native_rounds(results, D):
    """2^v_max < 4 D: ``mesh_rounds_ok`` is false and the host rounds run, as in zigz_tpu."""
    check = results[D][0]["results"]["batch_eval_too_small"]
    assert check["ok_predicate"] == (4 >= 4 * D) and not check["ok_predicate"]
    assert not check["sharded"] and check["mesh_rounds"] == 0 and check["equal_single"]


def test_predicates_are_the_jax_packages():
    import torch

    from zigz_tpu.ops.batch_eval_dev import mesh_rounds_ok as jax_rounds_ok
    from zigz_tpu.ops.ligero_mesh import mesh_commit_ok as jax_commit_ok
    from zigz_tpu.parallel.dist import make_trace_mesh
    from zigz_tpu_torch.ops.batch_eval_dev import mesh_rounds_ok
    from zigz_tpu_torch.ops.ligero_mesh import mesh_commit_ok
    from zigz_tpu_torch.parallel.multihost import TraceGroup

    for d in (2, 4, 8):
        mesh = make_trace_mesh(d)
        group = TraceGroup(rank=0, world_size=d, device=torch.device("cpu"), backend="gloo", pg=object())
        for n_e in (128, 256, 512, 1 << 19):
            assert mesh_commit_ok(group, n_e, 5) == jax_commit_ok(mesh, n_e, 5)
        for v_max in range(0, 7):
            assert mesh_rounds_ok(group, v_max) == jax_rounds_ok(mesh, v_max)
    assert not mesh_commit_ok(None, 512, 5) and not mesh_rounds_ok(None, 10)
    one = TraceGroup(rank=0, world_size=1, device=torch.device("cpu"), backend="gloo")
    assert not mesh_commit_ok(one, 512, 5) and not mesh_rounds_ok(one, 10)
