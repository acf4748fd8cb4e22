"""The port's distributed layer (parallel/dist.py, multihost.py, launch.py)
on gloo CPU ranks against zigz_tpu's mesh functions and the host prover.

The ranks are subprocesses started by ``parallel/launch.py``, each running
the checks of tests/torch_group_checks.py; inputs come
from numpy seeds that the ranks and this file share; the JAX side runs on the
virtual 8-device CPU mesh of tests/conftest.py.  Bytes and canonical
integers: tolerance zero."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zigz_tpu.core.field import BabyBear as F
from zigz_tpu.ops import babybear as jbb
from zigz_tpu.parallel.dist import DistSumcheckProver as JaxDistSumcheck
from zigz_tpu.parallel.dist import device_prove_step as jax_prove_step
from zigz_tpu.parallel.dist import make_trace_mesh
from zigz_tpu.parallel.dist import shard_rows as jax_shard_rows
from zigz_tpu.poly.multilinear import Multilinear
from zigz_tpu.proofs.sumcheck import SumcheckProver
from zigz_tpu_torch.core.field import BabyBear as TF
from zigz_tpu_torch.parallel import dist, multihost
from zigz_tpu_torch.parallel.jobs import seeded
from torch_group_checks import launch_checks

CHECKS = [
    {"name": "wrappers", "kind": "wrappers", "seed": 1},
    {"name": "sumcheck8", "kind": "dist_sumcheck", "seed": 7, "log2_n": 8, "return_data": True},
    {"name": "sumcheck10", "kind": "dist_sumcheck", "seed": 8, "log2_n": 10, "return_data": True},
    {"name": "sumcheck1", "kind": "dist_sumcheck", "seed": 9, "log2_n": 1, "return_data": True},
    {"name": "step", "kind": "prove_step", "seed": 3, "B": 43, "v": 8, "return_data": True},
    {"name": "lasso", "kind": "lasso_rounds", "seed": 9, "log2_n": 8, "host_tail": 4},
    {"name": "lasso_tail_below_ranks", "kind": "lasso_rounds", "seed": 10, "log2_n": 6, "host_tail": 1},
    {"name": "zerocheck", "kind": "zerocheck_gen", "seed": 11, "log2_n": 8, "host_tail": 8},
]
RANKS = (1, 2, 4)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """{D: the ranks' results of CHECKS on D gloo CPU ranks}."""
    return {
        D: launch_checks(D, CHECKS, work_dir=str(tmp_path_factory.mktemp(f"ranks{D}")), device="cpu", timeout_s=300)
        for D in RANKS
    }


def _fake_group(rank, world_size):
    """A group for the slicing functions, which issue no collective."""
    return multihost.TraceGroup(rank=rank, world_size=world_size, device=torch.device("cpu"),
                                backend="gloo", pg=object())


@pytest.mark.parametrize("D", RANKS)
def test_every_rank_reports(results, D):
    assert [r["rank"] for r in results[D]] == list(range(D))
    assert all(r["world_size"] == D and r["device"] == "cpu" for r in results[D])


@pytest.mark.parametrize("D", RANKS)
def test_collective_wrappers(results, D):
    total = sum(r + 1 for r in range(D))
    for res in results[D]:
        w, rank = res["results"]["wrappers"], res["rank"]
        assert w["all_reduce"] == [i * total for i in range(6)]
        assert w["all_gather"] == [[i + 10 * r for r in range(D) for i in range(3)]]
        assert w["rows_to_columns_ok"] and w["gather_cyclic_ok"] and w["gather_last_ok"]
        assert w["exchange_rows"] == [rank + 100 * s for s in range(D)]
        assert w["shard_rows_shape"] == [43, 256 // D] and w["shard_rows_axis0_shape"] == [8, 5]
        # cyclic: local index j of rank r is global index j * D + r
        values = seeded(2, (2, 8 * D))
        assert w["cyclic_first"] == [int(values[0, rank]), int(values[0, D + rank])]
        if D > 1:
            assert w["collectives"]["all_reduce"] >= 1 and w["collectives"]["all_to_all"] >= 2


def test_shard_rows_layout_is_the_jax_packages():
    """(43, 256) over 8 gives (43, 32) on every device, as tests/test_parallel.py fixes it."""
    x = np.arange(43 * 256, dtype=np.uint32).reshape(43, 256)
    shards = jax_shard_rows(make_trace_mesh(8), jnp.asarray(x)).addressable_shards
    assert len(shards) == 8
    for shard in shards:
        r = shard.index[1].start // 32
        mine = dist.shard_rows(_fake_group(r, 8), x)
        assert mine.shape == (43, 32)
        np.testing.assert_array_equal(mine, np.asarray(shard.data))


def test_cyclic_layout_and_un_interleave():
    """Index i lies on rank i mod D at local index i // D; the MSB pair
    (i, i + N/2) lies on one rank at local j and j + N/(2D); the gathered
    (D, w/D) stack un-interleaves to natural order."""
    D, n = 4, 32
    x = np.arange(3 * n).reshape(3, n)
    shards = [dist.shard_cyclic(_fake_group(r, D), x) for r in range(D)]
    for r, shard in enumerate(shards):
        assert shard.shape == (3, n // D)
        np.testing.assert_array_equal(shard[0], np.arange(r, n, D))
        half = n // (2 * D)
        np.testing.assert_array_equal(shard[0, half:] - shard[0, :half], np.full(half, n // 2))
    stacked = torch.from_numpy(np.stack(shards))  # what the all-gather of gather_cyclic returns
    natural = stacked.movedim(0, -1).reshape(3, n)
    np.testing.assert_array_equal(natural.numpy(), x)
    assert dist.shard_rows(None, x) is x and dist.shard_cyclic(None, x) is x
    with pytest.raises(ValueError):
        dist.shard_cyclic(_fake_group(0, 4), np.zeros(6))
    with pytest.raises(ValueError):
        dist.shard_rows(_fake_group(0, 4), np.zeros((2, 6)))


def test_collectives_refuse_other_types():
    group = _fake_group(0, 2)
    for fn in (dist.all_reduce_sum, lambda g, t: dist.all_gather_cat(g, t, 0)):
        with pytest.raises(ValueError, match="int32 and int64"):
            fn(group, torch.zeros(4, dtype=torch.float32))
    with pytest.raises(ValueError, match="divide"):
        dist.rows_to_columns(group, torch.zeros((2, 5), dtype=torch.int32))


def _jax_proof_bytes(vals, mesh):
    return JaxDistSumcheck(F, mesh=mesh).prove(vals).to_bytes()


@pytest.mark.parametrize("D", RANKS)
@pytest.mark.parametrize("name,seed,log2_n", [("sumcheck8", 7, 8), ("sumcheck10", 8, 10), ("sumcheck1", 9, 1)])
def test_dist_sumcheck_equals_jax_and_the_host_prover(results, D, name, seed, log2_n):
    vals = seeded(seed, 1 << log2_n)
    host = SumcheckProver.prove(Multilinear(F, vals.copy())).to_bytes()
    mesh = make_trace_mesh(8) if log2_n >= 4 else None
    assert _jax_proof_bytes(vals, mesh) == host
    for res in results[D]:
        check = res["results"][name]
        assert check["equal_single"] and check["num_vars"] == log2_n
        assert bytes.fromhex(check["hex"]) == host


def test_dist_sumcheck_without_a_group_is_the_single_device_case():
    vals = seeded(7, 1 << 8)
    host = SumcheckProver.prove(Multilinear(F, vals.copy()))
    port = dist.DistSumcheckProver(TF, group=None, device="cpu").prove(vals)
    assert port.to_bytes() == host.to_bytes() == _jax_proof_bytes(vals, None)
    one = dist.DistSumcheckProver(TF, multihost.single_process_group("cpu")).prove(vals)
    assert one.to_bytes() == host.to_bytes()
    with pytest.raises(ValueError):
        dist.DistSumcheckProver(TF, group=None, device="cpu").prove(vals[:3])


@pytest.mark.parametrize("D", RANKS)
def test_device_prove_step_equals_jax(results, D):
    B, v = 43, 8
    matrix, points, r = seeded(3, (B, 1 << v)), seeded(4, (B, v)), seeded(5, 1)
    matrix_m = jax_shard_rows(make_trace_mesh(8), jnp.asarray(jbb.np_to_mont(matrix)))
    out = jax_prove_step(matrix_m, jnp.asarray(jbb.np_to_mont(points)), jnp.asarray(jbb.np_to_mont(r)))
    evals, g0, g1, folded = (np.asarray(jbb.from_mont(x), dtype=np.uint64) for x in out)
    for res in results[D]:
        check = res["results"]["step"]
        assert check["equal_single"]
        assert check["evals"] == evals.tolist() and check["g0"] == g0.tolist() and check["g1"] == g1.tolist()
        assert check["folded"] == folded.tolist()
    # and against the host polynomial, row 0
    poly = Multilinear(F, matrix[0].copy())
    assert int(evals[0]) == poly.eval([F.from_reduced(int(x)) for x in points[0]]).value


def test_device_prove_step_without_a_group():
    B, v = 5, 6
    matrix, points, r = seeded(3, (B, 1 << v)), seeded(4, (B, v)), seeded(5, 1)
    as_t = lambda a: torch.from_numpy(a.astype(np.int64))  # noqa: E731
    evals, g0, g1, folded = dist.device_prove_step(as_t(matrix), as_t(points), as_t(r))
    half = 1 << (v - 1)
    for i in range(B):
        poly = Multilinear(F, matrix[i].copy())
        assert int(evals[i]) == poly.eval([F.from_reduced(int(x)) for x in points[i]]).value
        assert int(g0[i]) == int(matrix[i][:half].sum()) % F.MODULUS
        assert int(g1[i]) == int(matrix[i][half:].sum()) % F.MODULUS
        np.testing.assert_array_equal(folded[i].numpy(), poly.partial_eval(F.from_reduced(int(r[0]))).evals)


@pytest.mark.parametrize("D", (2, 4))
@pytest.mark.parametrize("name", ["lasso", "lasso_tail_below_ranks", "zerocheck"])
def test_sharded_sumchecks_equal_the_unsharded_ones(results, D, name):
    """The Lasso rounds and the base-field zerocheck under a group: cyclic
    shards, one all_reduce a round, a tail never below D."""
    digests = set()
    for res in results[D]:
        check = res["results"][name]
        assert check["equal_single"]
        digests.add(check["sha256"])
    assert len(digests) == 1
    if name == "lasso":
        assert results[D][0]["results"][name]["all_reduces"] == 6  # widths 256 .. 8, the tail at 4
    if name == "lasso_tail_below_ranks":
        # host_tail 1 is raised to D: rounds at widths 64 .. 2D
        assert results[D][0]["results"][name]["all_reduces"] == 6 - (D.bit_length() - 1)


def test_trace_group_and_initialize_reject_bad_arguments(tmp_path):
    with pytest.raises(ValueError, match="unknown backend"):
        multihost.initialize("mpi", 0, 1, device="cpu", rendezvous_file=str(tmp_path / "r"))
    with pytest.raises(ValueError, match="unknown backend"):
        multihost.single_process_group("cpu", backend="ucc")
    with pytest.raises(ValueError, match="power of two"):
        multihost.TraceGroup(rank=0, world_size=3, device=torch.device("cpu"), backend="gloo", pg=object())
    with pytest.raises(ValueError, match="needs a process group"):
        multihost.TraceGroup(rank=0, world_size=2, device=torch.device("cpu"), backend="gloo")
    with pytest.raises(ValueError, match="CUDA device"):
        multihost.single_process_group("cpu", backend="nccl")
    with pytest.raises(ValueError, match="exactly one"):
        multihost.initialize("gloo", 0, 1, device="cpu")
    with pytest.raises(RuntimeError, match="has not been called"):
        multihost.global_trace_group()
    assert multihost.is_coordinator() and multihost.is_coordinator(multihost.single_process_group("cpu"))
    multihost.sync_hosts(multihost.single_process_group("cpu"))  # a group of one: no peers to wait for
