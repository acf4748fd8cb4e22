"""Multilinear-extension evaluation on canonical int64 tensors.

Counterpart of zigz_tpu/ops/mle.py.  The JAX package computes these with
plain jnp, outside any Pallas kernel, so the port uses plain torch ops.

LSB ordering (``fold_lsb``, ``batch_eval_lsb``): a fold pairs adjacent
entries, new[i] = (1-r) e[2i] + r e[2i+1] (multilinear.zig:110-144), so
point[j] binds bit j of the row index.  MSB ordering (``fold_msb``,
``round_poly_msb``): a fold splits the table at its half, the ordering of
the sumcheck and zerocheck rounds.
"""

from __future__ import annotations

import torch

from .babybear import P

__all__ = ["fold_lsb", "fold_msb", "sum_mod", "round_poly_msb", "batch_eval_lsb"]


def fold_lsb(evals: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """(..., N) -> (..., N/2); ``r`` broadcasts over the leading dims.

    Both products are < p^2 < 0.88 * 2^62, so their sum stays below 2^63
    and one ``% P`` reduces it exactly in int64."""
    e0 = evals[..., 0::2]
    e1 = evals[..., 1::2]
    return ((P + 1 - r) % P * e0 + r * e1) % P


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


def batch_eval_lsb(matrix: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Evaluate B MLEs at B points: matrix (B, 2^v), points (B, v), both
    canonical int64 -> (B,) canonical int64."""
    if matrix.dim() != 2 or points.dim() != 2 or points.shape[0] != matrix.shape[0]:
        raise ValueError(f"bad shapes {tuple(matrix.shape)} / {tuple(points.shape)}")
    if matrix.shape[1] != 1 << points.shape[1]:
        raise ValueError(f"{matrix.shape[1]} columns do not match {points.shape[1]} variables")
    cur = matrix
    for j in range(points.shape[1]):
        cur = fold_lsb(cur, points[:, j : j + 1])
    return cur[:, 0]
