"""Multilinear-extension evaluation on canonical int64 tensors.

Counterpart of zigz_tpu/ops/mle.py.  The JAX package computes these with
plain jnp, outside any Pallas kernel, so the port uses plain torch ops.

LSB ordering (``fold_lsb``, ``batch_eval_lsb``): a fold pairs adjacent
entries, new[i] = (1-r) e[2i] + r e[2i+1] (multilinear.zig:110-144), so
point[j] binds bit j of the row index.  MSB ordering (``fold_msb``,
``round_poly_msb``): a fold splits the table at its half, the ordering of
the sumcheck and zerocheck rounds.

``fold_lsb`` and ``batch_eval_lsb`` take the modulus ``p`` (BabyBear's by
default): the v1 path evaluates over any field below 2^31
(prover/prover.py), where a product of two canonical values stays below
p^2 < 2^62.  :func:`check_modulus` is that limit, for these folds and for
the device witness's u32 words (ops/witness_dev.py) alike.  The two 64-bit
fields of the port (``WIDE_MODULI``: Goldilocks and Mersenne61) need
128-bit products: ``batch_eval_lsb`` sends them to ops/field64.py (kernel
E1 on the card), and :func:`check_device_modulus` admits them beside the
fields below 2^31.
"""

from __future__ import annotations

import torch

from . import field64
from .babybear import P

__all__ = ["check_modulus", "check_device_modulus", "is_wide", "WIDE_MODULI", "fold_lsb", "fold_msb", "sum_mod",
           "round_poly_msb", "batch_eval_lsb"]

# The 64-bit fields whose v1 witness is u64 words and whose evaluations
# run on ops/field64.py (core/field.py Goldilocks and Mersenne61).
WIDE_MODULI = field64.MODULI


def check_modulus(p: int) -> int:
    """``p`` if the int32 witness words and the int64 torch-op folds can
    hold it (p < 2^31), else raise."""
    if not 2 <= p < 1 << 31:
        raise ValueError(f"p = {p} is not below 2^31: the int32 witness words and the int64 folds of "
                         "ops/mle.py reduce products below p^2 < 2^62, which cannot hold it")
    return p


def is_wide(p: int) -> bool:
    """True for the 64-bit fields of ``WIDE_MODULI``."""
    return p in WIDE_MODULI


def check_device_modulus(p: int) -> int:
    """``p`` if the v1 device path proves over it: below 2^31 (int32
    witness, int64 folds) or one of ``WIDE_MODULI`` (u64 witness, kernel
    E1); any other modulus raises with the reason."""
    if is_wide(p):
        return p
    if p >= 1 << 31:
        raise ValueError(f"p = {p} is not below 2^31 and is neither Goldilocks ({field64.GOLDILOCKS_P}) nor "
                         f"Mersenne61 ({field64.MERSENNE61_P}): the v1 device path has int32 witness words and "
                         "int64 folds below 2^31, and u64 words with 128-bit products for those two fields only")
    return check_modulus(p)


def fold_lsb(evals: torch.Tensor, r: torch.Tensor, p: int = P) -> torch.Tensor:
    """(..., N) -> (..., N/2); ``r`` broadcasts over the leading dims.

    Both products are < p^2 < 2^62 for p < 2^31, so their sum stays below
    2^63 and one ``% p`` reduces it exactly in int64."""
    e0 = evals[..., 0::2]
    e1 = evals[..., 1::2]
    return ((p + 1 - r) % p * e0 + r * e1) % p


def fold_msb(evals: torch.Tensor, r) -> torch.Tensor:
    """(..., N) -> (..., N/2), split at the half: (1-r) e[:N/2] + r e[N/2:];
    ``r`` is a canonical int or a tensor that broadcasts.  Exact in int64
    for the same reason as :func:`fold_lsb`."""
    half = evals.shape[-1] // 2
    return ((P + 1 - r) % P * evals[..., :half] + r * evals[..., half:]) % P


def sum_mod(evals: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Exact modular sum of canonical values along ``dim``.  Each value is
    below 2^31, so up to 2^32 of them sum below 2^63 and one ``% P``
    reduces the int64 total exactly (the JAX package halves pairwise to
    stay in uint32)."""
    if evals.shape[dim] > 1 << 32:
        raise ValueError(f"sum_mod: {evals.shape[dim]} values could overflow int64")
    return evals.sum(dim=dim) % P


def round_poly_msb(evals: torch.Tensor):
    """Sumcheck round sums with the half-split convention: (g0, g1) = (sum
    of the first half, sum of the second half)."""
    half = evals.shape[-1] // 2
    return sum_mod(evals[..., :half]), sum_mod(evals[..., half:])


def batch_eval_lsb(matrix: torch.Tensor, points: torch.Tensor, p: int = P) -> torch.Tensor:
    """Evaluate B MLEs at B points: matrix (B, 2^v), points (B, v), both
    canonical mod ``p`` int64 -> (B,) canonical int64.  Over a field of
    ``WIDE_MODULI`` both hold u64 bits, and the folds are
    :func:`field64.batch_eval_lsb_u64`'s."""
    if is_wide(p):
        return field64.batch_eval_lsb_u64(matrix, points, p)
    check_modulus(p)
    if matrix.dim() != 2 or points.dim() != 2 or points.shape[0] != matrix.shape[0]:
        raise ValueError(f"bad shapes {tuple(matrix.shape)} / {tuple(points.shape)}")
    if matrix.shape[1] != 1 << points.shape[1]:
        raise ValueError(f"{matrix.shape[1]} columns do not match {points.shape[1]} variables")
    cur = matrix
    for j in range(points.shape[1]):
        cur = fold_lsb(cur, points[:, j : j + 1], p)
    return cur[:, 0].to(torch.int64)  # an int32 matrix of one column has had no fold
