"""64-bit -> 31-bit limb decomposition for sub-32-bit fields.

Reference: zigz src/core/decomposition.zig.  A u64 machine word is
split into low/middle 31-bit limbs plus a high 2-bit limb so that each limb
fits a BabyBear element; reconstruction is ``low | middle<<31 | high<<62``
(decomposition.zig:25-36).  Vectorized numpy twins feed the witness
pipeline.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = [
    "Decompose64to31",
    "decompose_i64",
    "babybear_fits_single",
    "babybear_decompose",
    "range_constraint_witness",
    "verify_range_constraint",
    "add_decomposed",
    "np_decompose64to31",
]

_MASK31 = (1 << 31) - 1
_M64 = (1 << 64) - 1
BABYBEAR_PRIME = 2013265921


@dataclass(frozen=True)
class Decompose64to31:
    low: int  # bits [0:30]
    middle: int  # bits [31:61]
    high: int  # bits [62:63]

    @staticmethod
    def from_u64(value: int) -> "Decompose64to31":
        value &= _M64
        return Decompose64to31(
            low=value & _MASK31,
            middle=(value >> 31) & _MASK31,
            high=(value >> 62) & 0x3,
        )

    def to_u64(self) -> int:
        return self.low | (self.middle << 31) | (self.high << 62)

    def is_valid(self) -> bool:
        return self.low < (1 << 31) and self.middle < (1 << 31) and self.high < 4

    def to_field_elements(self, F):
        return [F(self.low), F(self.middle), F(self.high)]

    @staticmethod
    def from_field_elements(F, elements) -> "Decompose64to31":
        return Decompose64to31(
            low=elements[0].to_int(),
            middle=elements[1].to_int(),
            high=elements[2].to_int(),
        )


def decompose_i64(value: int) -> Decompose64to31:
    """Signed variant — two's-complement bitcast (decomposition.zig:69-87)."""
    return Decompose64to31.from_u64(value & _M64)


def babybear_fits_single(value: int) -> bool:
    return 0 <= value < BABYBEAR_PRIME


def babybear_decompose(value: int):
    """Returns ('single', value) or ('triple', Decompose64to31)."""
    if babybear_fits_single(value):
        return ("single", value)
    return ("triple", Decompose64to31.from_u64(value))


def range_constraint_witness(value: int) -> Decompose64to31:
    return Decompose64to31.from_u64(value)


def verify_range_constraint(decomp: Decompose64to31, original: int) -> bool:
    return decomp.to_u64() == (original & _M64) and decomp.is_valid()


def add_decomposed(a: Decompose64to31, b: Decompose64to31):
    total = a.to_u64() + b.to_u64()
    return Decompose64to31.from_u64(total & _M64), total > _M64


def np_decompose64to31(values: np.ndarray):
    """Vectorized limb split: (low31, mid31, high2) uint64 arrays."""
    arr = np.asarray(values, dtype=np.uint64)
    return (
        arr & np.uint64(_MASK31),
        (arr >> np.uint64(31)) & np.uint64(_MASK31),
        (arr >> np.uint64(62)) & np.uint64(0x3),
    )
