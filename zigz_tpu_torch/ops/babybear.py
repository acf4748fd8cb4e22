"""BabyBear field ops on canonical int64 tensors.

Counterpart of zigz_tpu/ops/babybear.py.  The JAX package keeps Montgomery
uint32 lanes because the TPU vector unit has no 64-bit integer datapath; the
port's contract is canonical values only (0 <= x < P), stored as int32 and
computed in int64.

Bound: P < 2^31, so a product of two canonical values is below
P^2 < 0.88 * 2^62, and the sum of two such products stays below 2^63.  So
``a*b + c*d`` may be formed in int64 before a single ``% P``.  ``%`` on a
tensor takes the sign of the divisor, so it maps negative intermediates back
into [0, P).
"""

from __future__ import annotations

import torch

__all__ = ["P", "add", "sub", "neg", "mul", "pow", "inv"]

P = 2013265921  # 15 * 2^27 + 1


def add(a: torch.Tensor, b) -> torch.Tensor:
    return (a + b) % P


def sub(a: torch.Tensor, b) -> torch.Tensor:
    return (a - b) % P


def neg(a: torch.Tensor) -> torch.Tensor:
    return (-a) % P


def mul(a: torch.Tensor, b) -> torch.Tensor:
    return (a * b) % P


def pow(a: torch.Tensor, exponent: int) -> torch.Tensor:  # noqa: A001 - field op name
    """a^exponent by square-and-multiply; exponent is a Python int >= 0."""
    if exponent < 0:
        raise ValueError("exponent must be >= 0")
    result = torch.ones_like(a)
    base = a % P
    while exponent:
        if exponent & 1:
            result = mul(result, base)
        base = mul(base, base)
        exponent >>= 1
    return result


def inv(a: torch.Tensor) -> torch.Tensor:
    """Multiplicative inverse by Fermat (a^(P-2)); maps 0 to 0."""
    return pow(a, P - 2)
