"""ops/ext4_dev.py (canonical int64 torch tensors) == zigz_tpu's host Ext4
(core/ext4.py) == zigz_tpu's JAX ops/ext4_dev.py (Montgomery uint32 lanes,
on the CPU backend).

Inputs are numpy arrays from a seed, with 0 and p - 1 in every operand, so
that the int64 overflow discipline of the schoolbook product is exercised
at its extremes.  Tolerance zero: canonical integers are compared."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zigz_tpu.core.ext4 import Ext4 as RefExt4
from zigz_tpu.ops import babybear as jbb
from zigz_tpu.ops import ext4_dev as jext
from zigz_tpu.proofs.zerocheck import _eq_table_ext as ref_eq_table_ext
from zigz_tpu_torch.core.ext4 import Ext4
from zigz_tpu_torch.ops import ext4_dev

P = 2013265921
N = 64


def _coords(seed, n=N):
    """(4, n) canonical uint64: the first columns are the extreme elements
    (all 0, all p - 1, mixed), the rest random."""
    c = np.random.default_rng(seed).integers(0, P, size=(4, n), dtype=np.uint64)
    c[:, 0] = 0
    c[:, 1] = P - 1
    c[:, 2] = [P - 1, 0, P - 1, 0]
    c[:, 3] = [0, P - 1, 0, P - 1]
    return c


def _scalar(seed):
    return [int(x) for x in np.random.default_rng(seed).integers(0, P, size=4)]


SCALARS = [[0, 0, 0, 0], [1, 0, 0, 0], [P - 1] * 4, _scalar(5)]


def _t(c):
    return torch.from_numpy(np.ascontiguousarray(c).view(np.int64))


def _np(t):
    return t.numpy().astype(np.uint64)


def _jax(c):
    return jnp.asarray(jbb.np_to_mont(np.ascontiguousarray(c, dtype=np.uint64)))


def _from_jax(x):
    return jext.ext_from_device(x)


def test_conversions_round_trip():
    c = _coords(1)
    for x in (Ext4(c), c):
        dev = ext4_dev.ext_to_device(x, "cpu")
        assert dev.dtype == torch.int64 and tuple(dev.shape) == (4, N)
        assert np.array_equal(ext4_dev.ext_from_device(dev), c)
    s = Ext4.from_ints(_scalar(2))
    assert ext4_dev.ext_scalar_to_device(s, "cpu").tolist() == list(s.to_ints())


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_ring_ops(op):
    a, b = _coords(3), _coords(4)[:, ::-1].copy()
    got = _np({"add": ext4_dev.ext_add_dev, "sub": ext4_dev.ext_sub_dev, "mul": ext4_dev.ext_mul_dev}[op](_t(a), _t(b)))
    host = {"add": RefExt4(a) + RefExt4(b), "sub": RefExt4(a) - RefExt4(b), "mul": RefExt4(a) * RefExt4(b)}[op]
    jfn = {"add": jext.ext_add_dev, "sub": jext.ext_sub_dev, "mul": jext.ext_mul_dev}[op]
    assert np.array_equal(got, host.c)
    assert np.array_equal(got, _from_jax(jfn(_jax(a), _jax(b))))


@pytest.mark.parametrize("s", SCALARS)
def test_scale_by_an_extension_scalar(s):
    t = _coords(6)
    got = _np(ext4_dev.ext_scale_dev(_t(t), s))
    assert np.array_equal(got, (RefExt4.from_ints(s) * RefExt4(t)).c)
    assert np.array_equal(got, _from_jax(jext.ext_scale_dev(_jax(t), _jax(np.array(s, dtype=np.uint64)))))
    # the scalar may also come as a host Ext4 or a tensor
    assert np.array_equal(got, _np(ext4_dev.ext_scale_dev(_t(t), Ext4.from_ints(s))))
    assert np.array_equal(got, _np(ext4_dev.ext_scale_dev(_t(t), torch.tensor(s))))


def test_mul_base():
    a = _coords(7)
    b = _coords(8)[0]
    got = _np(ext4_dev.ext_mul_base_dev(_t(a), _t(b)))
    assert np.array_equal(got, (RefExt4(a) * b).c)
    assert np.array_equal(got, _from_jax(jext.ext_mul_base_dev(_jax(a), _jax(b))))


@pytest.mark.parametrize("r", SCALARS)
def test_fold_of_extension_and_base_tables(r):
    t = _coords(9)
    rr = RefExt4.from_ints(r)
    got = _np(ext4_dev.ext_fold_dev(_t(t), r))
    assert np.array_equal(got, ((1 - rr) * RefExt4(t[:, : N // 2]) + rr * RefExt4(t[:, N // 2 :])).c)
    assert np.array_equal(got, _from_jax(jext.ext_fold_dev(_jax(t), _jax(np.array(r, dtype=np.uint64)))))
    base = t[0]
    got = _np(ext4_dev.ext_fold_base_dev(_t(base), r))
    assert np.array_equal(got, ((1 - rr) * base[: N // 2] + rr * base[N // 2 :]).c)
    assert np.array_equal(got, _from_jax(jext.ext_fold_base_dev(_jax(base), _jax(np.array(r, dtype=np.uint64)))))


def test_fold_of_a_stack_of_tables():
    """Leading axes after the coordinate axis are batch axes."""
    stack = np.stack([_coords(20 + k) for k in range(3)], axis=1)  # (4, 3, N)
    r = _scalar(21)
    got = _np(ext4_dev.ext_fold_dev(_t(stack), r))
    for k in range(3):
        assert np.array_equal(got[:, k], _np(ext4_dev.ext_fold_dev(_t(stack[:, k]), r)))
    base = np.stack([_coords(30 + k)[0] for k in range(3)])  # (3, N)
    got = _np(ext4_dev.ext_fold_base_dev(_t(base), r))
    for k in range(3):
        assert np.array_equal(got[:, k], _np(ext4_dev.ext_fold_base_dev(_t(base[k]), r)))


@pytest.mark.parametrize("v", [0, 1, 5])
def test_eq_table(v):
    taus = [_scalar(40 + j) for j in range(v)]
    if v:
        taus[0] = [P - 1] * 4
    got = _np(ext4_dev.ext_eq_table_dev(taus, 1 << v, "cpu"))
    host = ref_eq_table_ext([RefExt4.from_ints(t) for t in taus], P)
    assert np.array_equal(got, host.c)
    jtaus = [_jax(np.array(t, dtype=np.uint64)) for t in taus]
    assert np.array_equal(got, _from_jax(jext.ext_eq_table_dev(jtaus, 1 << v)))
    with pytest.raises(ValueError, match="eq table"):
        ext4_dev.ext_eq_table_dev(taus, 1 << (v + 1), "cpu")


def test_sum():
    t = _coords(50)
    t[:, 4:] = P - 1  # the largest sum the width allows
    got = _np(ext4_dev.ext_sum_dev(_t(t)))
    assert np.array_equal(got, RefExt4(t).sum().c)
    assert np.array_equal(got, _from_jax(jext.ext_sum_dev(_jax(t))))


def test_inverse():
    a = _coords(60)
    got = _np(ext4_dev.ext_inv_dev(_t(a)))
    assert np.array_equal(got, _from_jax(jext.ext_inv_dev(_jax(a))))
    assert np.array_equal(got[:, 0], np.zeros(4, dtype=np.uint64))  # 0 maps to 0
    nonzero = np.arange(1, N)
    assert np.array_equal(got[:, nonzero], RefExt4(a[:, nonzero]).inv().c)
    one = _np(ext4_dev.ext_mul_dev(_t(a), _t(got)))[:, nonzero]
    assert np.array_equal(one, np.stack([np.ones(N - 1), *np.zeros((3, N - 1))]).astype(np.uint64))


def test_scalars_are_checked():
    with pytest.raises(ValueError, match="4 coordinates"):
        ext4_dev.ext_scale_dev(_t(_coords(70)), [1, 2, 3])
