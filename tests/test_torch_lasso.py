"""The MSB fold, the round sums and the pipeline Lasso's device round loop
(torch ops on canonical int64) == zigz_tpu's JAX functions and host loop.

``fold_msb``, ``round_poly_msb`` and ``sum_mod`` are held against
zigz_tpu/ops/mle.py (Montgomery uint32 lanes, on the CPU backend);
``_sumcheck_rounds_device`` against the host loop of
tests/test_pipeline_lasso.py ``test_device_rounds_bit_equal``, and
``prove_pipeline_lasso`` with a device against zigz_tpu's host proof.
Tolerance zero: canonical integers and transcript bytes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zigz_tpu.core.field import BabyBear as RefBabyBear
from zigz_tpu.core.hash import FiatShamirTranscript as RefTranscript
from zigz_tpu.lookups import pipeline_lasso as ref_pl
from zigz_tpu.ops import babybear as jbb
from zigz_tpu.ops import mle as jax_mle
from zigz_tpu_torch.core.field import BabyBear
from zigz_tpu_torch.core.hash import FiatShamirTranscript
from zigz_tpu_torch.lookups import pipeline_lasso as pl
from zigz_tpu_torch.ops import mle

P = BabyBear.MODULUS


def _canonical(shape, seed):
    vals = np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)
    flat = vals.reshape(-1)
    flat[: min(flat.size, 3)] = [0, 1, P - 1][: min(flat.size, 3)]
    return vals


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int64))


def _from_mont(x):
    return np.asarray(jbb.from_mont(x), dtype=np.uint64)


@pytest.mark.parametrize("r", [0, 1, P - 1, 1234567891])
def test_fold_msb_matches_jax(r):
    evals = _canonical((3, 64), seed=1)
    evals[1] = P - 1
    want = _from_mont(jax_mle.fold_msb(jnp.asarray(jbb.np_to_mont(evals)),
                                       jnp.asarray(jbb.np_to_mont(np.array([r], dtype=np.uint64)))))
    assert mle.fold_msb(_t(evals), r).numpy().astype(np.uint64).tolist() == want.tolist()
    # a tensor challenge broadcasts like an int
    assert torch.equal(mle.fold_msb(_t(evals), torch.tensor([r])), mle.fold_msb(_t(evals), r))


@pytest.mark.parametrize("n", [1, 2, 7, 64, 4096])
def test_sum_mod_and_round_poly_match_jax(n):
    evals = _canonical((2, n), seed=n)
    evals[0] = P - 1  # the largest sum the width allows
    em = jnp.asarray(jbb.np_to_mont(evals))
    assert mle.sum_mod(_t(evals)).numpy().astype(np.uint64).tolist() == _from_mont(jax_mle.sum_mod(em)).tolist()
    assert mle.sum_mod(_t(evals), dim=0).tolist() == [int(x) % P for x in evals.astype(object).sum(axis=0)]
    if n >= 2 and n % 2 == 0:
        g0, g1 = mle.round_poly_msb(_t(evals))
        j0, j1 = jax_mle.round_poly_msb(em)
        assert g0.numpy().astype(np.uint64).tolist() == _from_mont(j0).tolist()
        assert g1.numpy().astype(np.uint64).tolist() == _from_mont(j1).tolist()


def _rounds_as_ints(result):
    rounds, point, final = result
    return [[c.value for c in row] for row in rounds], [c.value for c in point], final.value


@pytest.mark.parametrize("log_n, host_tail", [(14, None), (10, 8), (6, 1), (3, 1 << 12), (0, 1)])
def test_device_rounds_bit_equal(log_n, host_tail):
    """The device round loop matches zigz_tpu's host loop exactly, the
    host-tail handoff included, wherever the tail starts."""
    evals = _canonical(1 << log_n, seed=31 + log_n)
    t_host = RefTranscript()
    host = ref_pl._sumcheck_rounds_host(RefBabyBear, t_host, evals.copy(), None)
    pl.DEVICE_ROUNDS["count"] = 0
    t_dev = FiatShamirTranscript()
    dev = pl._sumcheck_rounds_device(BabyBear, t_dev, evals.copy(), torch.device("cpu"), host_tail)
    tail = pl.HOST_TAIL if host_tail is None else host_tail
    assert pl.DEVICE_ROUNDS["count"] == sum(1 for k in range(log_n) if (1 << log_n) >> k > tail)
    assert _rounds_as_ints(host) == _rounds_as_ints(dev)
    assert t_host.challenge_value(P) == t_dev.challenge_value(P)


@pytest.mark.parametrize("device", [None, "cpu"])
def test_prove_pipeline_lasso_matches_zigz_tpu(device):
    """Two tables of different sizes through the port's loop (host, or the
    torch device with a small tail) against zigz_tpu's host proof."""
    rng = np.random.default_rng(41)
    queries = {
        3: (rng.integers(0, 1 << 32, size=(300, 2), dtype=np.uint64), rng.integers(0, 1 << 32, size=(300, 1), dtype=np.uint64)),
        7: (rng.integers(0, 1 << 16, size=(5, 2), dtype=np.uint64), rng.integers(0, 1 << 16, size=(5, 1), dtype=np.uint64)),
    }
    t_ref, t_port = RefTranscript(), FiatShamirTranscript()
    ref_proofs, ref_extras = ref_pl.prove_pipeline_lasso(RefBabyBear, t_ref, queries)
    proofs, extras = pl.prove_pipeline_lasso(BabyBear, t_port, queries, device=device, host_tail=4)
    assert extras == ref_extras
    for a, b in zip(ref_proofs, proofs):
        assert (a.table_id, a.num_lookups, a.multiset_proof.num_vars) == (b.table_id, b.num_lookups, b.multiset_proof.num_vars)
        sa, sb = a.multiset_proof, b.multiset_proof
        assert _rounds_as_ints((sa.round_polynomials, sa.final_point, sa.final_eval)) == _rounds_as_ints(
            (sb.round_polynomials, sb.final_point, sb.final_eval))
    assert t_ref.finalize() == t_port.finalize()
    assert pl.verify_pipeline_lasso(BabyBear, FiatShamirTranscript(), proofs, extras)
