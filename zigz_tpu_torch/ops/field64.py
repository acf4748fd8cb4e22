"""Multilinear folds over the two 64-bit fields, Goldilocks (p = 2^64 -
2^32 + 1) and Mersenne61 (p = 2^61 - 1): CUDA kernel E1 and its plain
PyTorch version.

The v1 openings evaluate the 43 witness MLEs, each at its own point.  Over
these fields a product of two values needs 128 bits, which no torch op
gives (int64 products wrap, and there is no u128), so ops/mle.py sends them
here.  zigz_tpu has no device code for them: it evaluates with object-dtype
Python integers on the host (zigz_tpu/poly/multilinear.py:45,53).

Values are int64 tensors holding the canonical value's u64 bits: a
Goldilocks value of 2^63 or more is a negative int64.  A fold is LSB
ordered, one challenge a row: new[b, k] = e[b, 2k] + r[b] (e[b, 2k+1] -
e[b, 2k]) mod p, equal to zigz_tpu's (1 - r) e[2k] + r e[2k+1].

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches E1
(csrc/field64_kernels.cu over csrc/field64.cuh) or raises.  There is no
fallback from one to the other.  ``LAUNCHES`` counts kernel launches.

The plain version works on 32-bit halves held in int64, each in [0, 2^32),
and multiplies in 16-bit limbs, so every partial product stays below 2^32
and every sum below 2^63: it never relies on int64 wrap-around and never
takes ``%`` of a value stored as a negative int64.
"""

from __future__ import annotations

import torch

from ..utils.profiling import counter_table
from . import _build

__all__ = [
    "GOLDILOCKS_P",
    "MERSENNE61_P",
    "MODULI",
    "check_modulus",
    "from_halves",
    "fold_lsb_u64",
    "batch_eval_lsb_u64",
    "LAUNCHES",
]

GOLDILOCKS_P = 0xFFFFFFFF00000001
MERSENNE61_P = (1 << 61) - 1
MODULI = (GOLDILOCKS_P, MERSENNE61_P)

# Kernel launches since the last reset; the plain version does not count.
LAUNCHES = counter_table("field64", ["fold"])

_M16 = 0xFFFF
_M32 = 0xFFFFFFFF
_GL_P = (GOLDILOCKS_P >> 32, GOLDILOCKS_P & _M32)  # a constant as (hi, lo) halves
_GL_EPS = (0, _M32)  # 2^64 mod p = 2^32 - 1
_ALIGN = 16  # E1 reads each pair (e[2k], e[2k+1]) as one 16-byte load


def check_modulus(p: int) -> int:
    """``p`` if it is one of the two 64-bit fields, else raise."""
    if p not in MODULI:
        raise ValueError(f"p = {p} is neither Goldilocks ({GOLDILOCKS_P}) nor Mersenne61 ({MERSENNE61_P})")
    return p


# -- the plain version -----------------------------------------------------------


def _halves(x: torch.Tensor):
    """int64 holding u64 bits -> (hi, lo), each in [0, 2^32)."""
    return (x >> 32) & _M32, x & _M32


def from_halves(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Halves in [0, 2^32) -> the int64 with the u64 bits hi 2^32 + lo.  The
    top half is taken signed, in [-2^31, 2^31), so the product stays in
    range."""
    return (hi - ((hi >> 31) << 32)) * (1 << 32) + lo


def _where(cond, a, b):
    return torch.where(cond, a[0], b[0]), torch.where(cond, a[1], b[1])


def _ge(a, b) -> torch.Tensor:
    return (a[0] > b[0]) | ((a[0] == b[0]) & (a[1] >= b[1]))


def _add64(a, b):
    """(a + b) mod 2^64 of two (hi, lo) values, and True where it carried."""
    lo = a[1] + b[1]
    hi = a[0] + b[0] + (lo >> 32)
    return (hi & _M32, lo & _M32), hi > _M32


def _sub64(a, b):
    """(a - b) mod 2^64 of two (hi, lo) values, and True where it borrowed."""
    lo = a[1] - b[1]
    lo_borrow = lo < 0
    lo = torch.where(lo_borrow, lo + (1 << 32), lo)
    hi = a[0] - b[0] - lo_borrow.to(lo.dtype)
    borrow = hi < 0
    return (torch.where(borrow, hi + (1 << 32), hi), lo), borrow


def _mul_words(a, b) -> list:
    """The 128-bit product of two (hi, lo) values as four 32-bit words, the
    low one first: 16-bit limbs, each column of partial products below
    4 x 2^32, carried into 16-bit limbs."""
    al = (a[1] & _M16, a[1] >> 16, a[0] & _M16, a[0] >> 16)
    bl = (b[1] & _M16, b[1] >> 16, b[0] & _M16, b[0] >> 16)
    limbs, carry = [], 0
    for k in range(7):
        col = carry
        for i in range(max(0, k - 3), min(k, 3) + 1):
            col = col + al[i] * bl[k - i]
        limbs.append(col & _M16)
        carry = col >> 16
    limbs.append(carry)  # < 2^16: the product is below 2^128
    return [limbs[2 * w] | (limbs[2 * w + 1] << 16) for w in range(4)]


def _gl_add(a, b):
    s, carry = _add64(a, b)
    # a + b < 2p: past 2^64 the sum less p is s + (2^32 - 1), and it fits.
    return _where(carry, _add64(s, _GL_EPS)[0], _where(_ge(s, _GL_P), _sub64(s, _GL_P)[0], s))


def _gl_sub(a, b):
    d, borrow = _sub64(a, b)
    # a - b + p = (a - b + 2^64) - (2^32 - 1), which cannot borrow again.
    return _where(borrow, _sub64(d, _GL_EPS)[0], d)


def _gl_mul(a, b):
    """With 2^64 = 2^32 - 1 and 2^96 = -1 mod p, the product x0 + x1 2^32 +
    x2 2^64 + x3 2^96 is (x1 2^32 + x0) - x3 + x2 (2^32 - 1): the steps of
    csrc/field64.cuh ``Goldilocks::reduce``."""
    x0, x1, x2, x3 = _mul_words(a, b)
    t0, borrow = _sub64((x1, x0), (torch.zeros_like(x3), x3))
    t0 = _where(borrow, _sub64(t0, _GL_EPS)[0], t0)
    nonzero = (x2 > 0).to(x2.dtype)
    t1 = (x2 - nonzero, nonzero * ((1 << 32) - x2))  # x2 (2^32 - 1) = (x2 - 1) 2^32 + 2^32 - x2
    t2, carry = _add64(t0, t1)
    t2 = _where(carry, _add64(t2, _GL_EPS)[0], t2)
    return _where(_ge(t2, _GL_P), _sub64(t2, _GL_P)[0], t2)


def _m61_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Values below 2^61 are non-negative int64; only the product needs
    limbs.  2^61 = 1 mod p, so x = (x mod 2^61) + (x >> 61), twice."""
    x0, x1, x2, x3 = _mul_words(_halves(a), _halves(b))
    low = ((x1 & ((1 << 29) - 1)) << 32) | x0
    high = (x3 << 35) | (x2 << 3) | (x1 >> 29)  # the product is below 2^122, so x3 < 2^26
    s = low + high  # < 2^62
    s = (s & MERSENNE61_P) + (s >> 61)
    return torch.where(s >= MERSENNE61_P, s - MERSENNE61_P, s)


def _fold_lsb_u64_plain(evals: torch.Tensor, r: torch.Tensor, p: int) -> torch.Tensor:
    """Plain version of E1: (B, N) int64 u64 bits, one challenge a row
    (B,) -> (B, N / 2)."""
    e0, e1, rr = evals[:, 0::2], evals[:, 1::2], r[:, None]
    if p == GOLDILOCKS_P:
        a = _halves(e0)
        return from_halves(*_gl_add(a, _gl_mul(_halves(rr), _gl_sub(_halves(e1), a))))
    check_modulus(p)
    d = torch.where(e1 >= e0, e1 - e0, e1 - e0 + MERSENNE61_P)
    s = e0 + _m61_mul(rr, d)  # < 2p < 2^63
    return torch.where(s >= MERSENNE61_P, s - MERSENNE61_P, s)


# -- the wrappers ----------------------------------------------------------------


def _on_card(t: torch.Tensor, name: str) -> bool:
    """False for a CPU tensor (the plain version), True for a CUDA one (the
    kernel); any other device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return True


def fold_lsb_u64(evals: torch.Tensor, r: torch.Tensor, p: int) -> torch.Tensor:
    """One LSB fold of B rows, each by its own challenge: ``evals`` (B, N)
    int64 u64 bits, N even, ``r`` (B,) int64 u64 bits, both canonical mod
    ``p`` -> (B, N / 2) int64.  One launch of E1 on the card."""
    check_modulus(p)
    if evals.dtype != torch.int64 or r.dtype != torch.int64:
        raise TypeError(f"fold_lsb_u64: expected int64 u64 bits, got {evals.dtype} and {r.dtype}")
    if evals.dim() != 2 or evals.shape[1] % 2 or r.shape != (evals.shape[0],):
        raise ValueError(f"fold_lsb_u64: expected (B, 2n) values and (B,) challenges, got "
                         f"{tuple(evals.shape)} and {tuple(r.shape)}")
    if r.device != evals.device:
        raise ValueError(f"fold_lsb_u64: values on {evals.device}, challenges on {r.device}")
    if not _on_card(evals, "fold_lsb_u64"):
        return _fold_lsb_u64_plain(evals, r, p)
    if not (evals.is_contiguous() and r.is_contiguous()) or evals.data_ptr() % _ALIGN:
        raise ValueError(f"fold_lsb_u64: expected contiguous tensors and values aligned to {_ALIGN} bytes")
    _build.load()  # build, or raise, before anything touches the card
    rows, n_out = evals.shape[0], evals.shape[1] // 2
    out = torch.empty((rows, n_out), dtype=torch.int64, device=evals.device)
    if out.numel():
        with torch.cuda.device(evals.device):
            stream = torch.cuda.current_stream(evals.device).cuda_stream
            _build.launch("zigz_mle_fold_u64", evals.data_ptr(), r.data_ptr(), out.data_ptr(), rows, n_out, p,
                          stream)
        LAUNCHES["fold"] += 1
    return out


def batch_eval_lsb_u64(matrix: torch.Tensor, points: torch.Tensor, p: int) -> torch.Tensor:
    """Evaluate B MLEs at B points: ``matrix`` (B, 2^v), ``points`` (B, v),
    both int64 u64 bits canonical mod ``p`` -> (B,) int64 u64 bits.  One
    fold a variable, point[j] binding bit j of the row index (v launches
    of E1 on the card; none for v = 0)."""
    check_modulus(p)
    if matrix.dtype != torch.int64 or points.dtype != torch.int64:
        raise TypeError(f"batch_eval_lsb_u64: expected int64 u64 bits, got {matrix.dtype} and {points.dtype}")
    if matrix.dim() != 2 or points.dim() != 2 or points.shape[0] != matrix.shape[0]:
        raise ValueError(f"bad shapes {tuple(matrix.shape)} / {tuple(points.shape)}")
    if matrix.shape[1] != 1 << points.shape[1]:
        raise ValueError(f"{matrix.shape[1]} columns do not match {points.shape[1]} variables")
    columns = points.t().contiguous()  # (v, B): challenge j of every row, contiguous
    cur = matrix
    for j in range(points.shape[1]):
        cur = fold_lsb_u64(cur, columns[j], p)
    return cur[:, 0]
