"""Multilinear-extension evaluation on canonical int64 tensors.

Counterpart of zigz_tpu/ops/mle.py (``fold_lsb`` and ``batch_eval_lsb``).
The JAX package computes these with plain jnp, outside any Pallas kernel,
so the port uses plain torch ops.  ``fold_msb``, ``sum_mod`` and
``round_poly_msb`` come with the v2 prover rounds.

LSB ordering: a fold pairs adjacent entries, new[i] = (1-r) e[2i] + r e[2i+1]
(multilinear.zig:110-144), so point[j] binds bit j of the row index.
"""

from __future__ import annotations

import torch

from .babybear import P

__all__ = ["fold_lsb", "batch_eval_lsb"]


def fold_lsb(evals: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """(..., N) -> (..., N/2); ``r`` broadcasts over the leading dims.

    Both products are < p^2 < 0.88 * 2^62, so their sum stays below 2^63
    and one ``% P`` reduces it exactly in int64."""
    e0 = evals[..., 0::2]
    e1 = evals[..., 1::2]
    return ((P + 1 - r) % P * e0 + r * e1) % P


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
