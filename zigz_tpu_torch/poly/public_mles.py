"""Verifier-computable multilinear extensions over the boolean hypercube.

The v2 PC-chain argument (constraints/v2.py) fingerprints trace entries as
``tau - beta*index - value`` and restricts the multisets with range
selectors.  Both the index function and the range indicators are PUBLIC
functions of the (public) step count, so the verifier evaluates their MLEs
directly at the zerocheck terminal point instead of trusting prover-
supplied evaluations — these never appear in ``column_evals``.

Bit convention (matches proofs/zerocheck.py and the reference's MSB-first
``partialEval`` fold, multilinear.zig:154-180): the j-th fold variable
r_j = rs[j] controls index bit v-1-j, so rs[0] is the MSB.

Also hosts the vectorized Fermat inversion the prover uses to build the
logUp inverse columns (2^v modular inversions as ~62 numpy passes).
"""

from __future__ import annotations

from typing import List

import numpy as np

__all__ = [
    "idx_eval",
    "le_indicator_eval",
    "eq_zero_eval",
    "idx_table",
    "le_table",
    "np_modpow",
    "np_inv",
]


def idx_eval(num_vars: int, rs: List[int], p: int) -> int:
    """MLE of f(x) = index(x) at rs: sum_j 2^(v-1-j) * rs[j] mod p."""
    acc = 0
    for j, r in enumerate(rs):
        acc = (acc + (1 << (num_vars - 1 - j)) * (r % p)) % p
    return acc


def le_indicator_eval(c: int, num_vars: int, rs: List[int], p: int) -> int:
    """MLE of f(x) = 1 if index(x) <= c else 0, evaluated at rs.

    Walk the bits MSB->LSB keeping the prefix-equality product; whenever
    c's bit is 1, an x-bit of 0 under an equal prefix makes x < c."""
    if c < 0:
        return 0
    if c >= (1 << num_vars) - 1:
        return 1
    acc = 0
    prefix = 1
    for j in range(num_vars):
        bit = (c >> (num_vars - 1 - j)) & 1
        r = rs[j] % p
        if bit == 1:
            acc = (acc + prefix * ((1 - r) % p)) % p
            prefix = prefix * r % p
        else:
            prefix = prefix * ((1 - r) % p) % p
    return (acc + prefix) % p


def eq_zero_eval(rs: List[int], p: int) -> int:
    """MLE of f(x) = 1 if index(x) == 0, i.e. prod_j (1 - rs[j])."""
    acc = 1
    for r in rs:
        acc = acc * ((1 - r) % p) % p
    return acc


def idx_table(num_vars: int, p: int) -> np.ndarray:
    """(2^v,) canonical index values (prover-side dense twin)."""
    return np.arange(1 << num_vars, dtype=np.uint64) % np.uint64(p)


def le_table(c: int, num_vars: int) -> np.ndarray:
    """(2^v,) dense 1[index <= c] (all zeros for c < 0)."""
    return (np.arange(1 << num_vars, dtype=np.int64) <= c).astype(np.uint64)


def np_modpow(base: np.ndarray, exponent: int, p: int) -> np.ndarray:
    """Vectorized square-and-multiply; exact for p < 2^31 (u64 products)."""
    pp = np.uint64(p)
    result = np.ones_like(base, dtype=np.uint64)
    acc = base.astype(np.uint64) % pp
    e = exponent
    while e:
        if e & 1:
            result = result * acc % pp
        acc = acc * acc % pp
        e >>= 1
    return result


_native_inv_state = "untested"


def np_inv(values: np.ndarray, p: int) -> np.ndarray:
    """Batched inversion; maps 0 to 0 (callers mask zeros).  Uses the
    native Montgomery batch-inverse (runtime/ntt.cpp, one modpow total)
    when available — self-tested against the Fermat path once — else
    vectorized square-and-multiply."""
    global _native_inv_state
    if _native_inv_state != "unavailable":
        try:
            from ..runtime import native_batch_inv
        except Exception:
            native_batch_inv = None
        if native_batch_inv is None:
            _native_inv_state = "unavailable"
        else:
            if _native_inv_state == "untested":
                probe = np.array([0, 1, 2, p - 1, 12345 % p], dtype=np.uint64)
                got = native_batch_inv(probe, p)
                if got is None or not np.array_equal(
                    got, np_modpow(probe, p - 2, p) * (probe != 0)
                ):
                    _native_inv_state = "unavailable"
                else:
                    _native_inv_state = "ok"
            if _native_inv_state == "ok":
                out = native_batch_inv(np.asarray(values, dtype=np.uint64), p)
                if out is not None:
                    return out
                _native_inv_state = "unavailable"
    return np_modpow(values, p - 2, p)
