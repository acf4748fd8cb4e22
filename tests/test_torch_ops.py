"""Port field ops and batched MLE evaluation == zigz_tpu, exactly.

Every value is a canonical BabyBear integer: tolerance zero."""

import numpy as np
import pytest
import torch

from zigz_tpu.core.field import BabyBear
from zigz_tpu.ops import mle as jax_mle
from zigz_tpu.prover.prover import Prover as ReferenceProver
from zigz_tpu_torch.ops import babybear as bb
from zigz_tpu_torch.ops import mle

P = BabyBear.MODULUS


def _canonical(shape, seed):
    vals = np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.int64)
    flat = vals.reshape(-1)
    flat[: min(flat.size, 3)] = [0, 1, P - 1][: min(flat.size, 3)]
    return vals


def test_modulus():
    assert bb.P == P


@pytest.mark.parametrize(
    "op, ref",
    [
        (bb.add, lambda a, b: a.add(b)),
        (bb.sub, lambda a, b: a.sub(b)),
        (bb.mul, lambda a, b: a.mul(b)),
    ],
    ids=["add", "sub", "mul"],
)
def test_binary_ops_match_field(op, ref):
    a = _canonical(200, seed=1)
    b = _canonical(200, seed=2)[::-1].copy()
    got = op(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = [ref(BabyBear(int(x)), BabyBear(int(y))).value for x, y in zip(a, b)]
    assert got.tolist() == want


def test_neg_pow_inv_match_field():
    a = _canonical(64, seed=3)
    t = torch.from_numpy(a)
    assert bb.neg(t).tolist() == [BabyBear(int(x)).neg().value for x in a]
    for e in (0, 1, 2, 7, P - 2, (1 << 40) + 3):
        assert bb.pow(t, e).tolist() == [BabyBear(int(x)).pow(e).value for x in a]
    nz = a[a != 0]
    assert bb.inv(torch.from_numpy(nz)).tolist() == [BabyBear(int(x)).inv().value for x in nz]
    assert (bb.mul(bb.inv(torch.from_numpy(nz)), torch.from_numpy(nz)) == 1).all()


@pytest.mark.parametrize("v", [0, 1, 10])
def test_batch_eval_lsb_matches_jax_and_host(v):
    B = 43
    matrix = _canonical((B, 1 << v), seed=10 + v)
    points = _canonical((B, v), seed=20 + v)
    got = mle.batch_eval_lsb(torch.from_numpy(matrix), torch.from_numpy(points)).numpy()
    m64, p64 = matrix.astype(np.uint64), points.astype(np.uint64)
    jax_vals = jax_mle.eval_backend(m64, p64)
    host_vals = ReferenceProver(BabyBear)._host_eval_backend(m64, p64)
    assert got.astype(np.uint64).tolist() == np.asarray(jax_vals).tolist() == host_vals.tolist()


def test_fold_lsb_pairs_adjacent_entries():
    evals = torch.tensor([[3, 5, 7, 11]], dtype=torch.int64)
    r = torch.tensor([[2]], dtype=torch.int64)
    # (1 - r) e0 + r e1 = -e0 + 2 e1
    assert mle.fold_lsb(evals, r).tolist() == [[7, 15]]
