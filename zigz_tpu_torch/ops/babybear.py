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

``mul_chain`` is the bench headline's multiply chain (bench_torch.py): a
CUDA kernel (csrc/field_kernels.cu) for a CUDA tensor and its plain version
``_mul_chain_plain`` for a CPU tensor, with no fallback from one to the
other.  ``LAUNCHES`` counts the kernel's launches.
"""

from __future__ import annotations

import torch

from . import _build

__all__ = ["P", "add", "sub", "neg", "mul", "pow", "inv", "mul_chain", "CHAIN", "LAUNCHES"]

P = 2013265921  # 15 * 2^27 + 1
CHAIN = 8  # dependent multiplies per element in mul_chain, as bench.py's chain

# Kernel launches since the last reset; the plain version does not count.
LAUNCHES = {"mul_chain": 0}


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


def _mul_chain_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain version of the multiply-chain kernel: ``x = (x * y) % P``,
    CHAIN times, in int64 torch ops.  int32 canonical values in and out."""
    acc, y64 = x.to(torch.int64), y.to(torch.int64)
    for _ in range(CHAIN):
        acc = (acc * y64) % P
    return acc.to(torch.int32)


def mul_chain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x * y^CHAIN mod P by CHAIN dependent multiplies, elementwise.

    x, y: (n,) int32 canonical values on one device.  A CPU tensor takes the
    plain version; a CUDA tensor launches ``zigz_field_mul_chain`` or raises
    (KernelBuildError, KernelLaunchError)."""
    for name, t in (("x", x), ("y", y)):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"mul_chain: {name} must be a contiguous (n,) int32 tensor, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if x.shape != y.shape or x.device != y.device:
        raise ValueError(f"mul_chain: x {tuple(x.shape)} on {x.device} and y {tuple(y.shape)} on {y.device} differ")
    if x.device.type == "cpu":
        return _mul_chain_plain(x, y)
    if x.device.type != "cuda":
        raise ValueError(f"mul_chain: unsupported device {x.device}")
    _build.load()  # build, or raise, before anything touches the card
    out = torch.empty_like(x)
    n = x.shape[0]
    if n:
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            _build.launch("zigz_field_mul_chain", x.data_ptr(), y.data_ptr(), n, out.data_ptr(), stream)
        LAUNCHES["mul_chain"] += 1
    return out
