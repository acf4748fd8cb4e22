"""Prime-field arithmetic with exact parity to the reference semantics.

Reference: zigz src/core/field.zig (Field(T, modulus), canonical
non-Montgomery representation) and field_presets.zig (BabyBear et al., all
instantiated with T=u64).

Two representations live side by side:

* ``Field(modulus)`` — a scalar element type used on consensus-critical host
  paths (transcripts, serialization, small polynomials).  Values are Python
  ints reduced mod p; every operation mirrors the reference exactly
  (field.zig:73-225).
* numpy ``uint64`` arrays + the helpers in this module — the vectorized host
  twin used by the witness generator and Merkle leaf encoders.  The TPU lanes
  live in :mod:`zigz_tpu.ops.babybear`.

All presets use a 64-bit limb (field_presets.zig:15-75), so canonical
serialization of any element is 8 little-endian bytes — this is what the
Fiat-Shamir transcript absorbs (hash.zig:279-283).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "Field",
    "F17",
    "BabyBear",
    "KoalaBear",
    "Goldilocks",
    "Mersenne31",
    "Mersenne61",
    "BABYBEAR_P",
    "field_name",
    "has_efficient_reduction",
    "batch_inv",
]

# BabyBear p = 2^31 - 2^27 + 1 (field_presets.zig:19); default proving field
# (reference src/main.zig:4).
BABYBEAR_P = 2013265921
_KOALABEAR_P = 2130706433
_GOLDILOCKS_P = 0xFFFFFFFF00000001
_MERSENNE31_P = 2147483647
_MERSENNE61_P = 2305843009213693951

_field_cache: dict[int, type] = {}


def Field(modulus: int, bits: int = 64) -> type:
    """Create (and cache) a field element class for the given modulus.

    ``bits`` is the width of the underlying integer type ``T`` in the
    reference; it controls canonical byte width (``nbytes``) and how many
    digest bytes a Fiat-Shamir challenge consumes (hash.zig:228-242).
    All reference presets use ``bits=64``.
    """
    if modulus <= 1:
        raise ValueError("Field modulus must be greater than 1")
    key = (modulus << 8) | bits
    cached = _field_cache.get(key)
    if cached is not None:
        return cached

    p = modulus

    class _F:
        __slots__ = ("value",)

        MODULUS = p
        BITS = bits
        NBYTES = bits // 8

        def __init__(self, value: int):
            # Mirrors F.init: reduce mod p (field.zig:36-38).
            self.value = value % p

        # -- constructors -------------------------------------------------
        @classmethod
        def from_reduced(cls, value: int) -> "_F":
            assert 0 <= value < p
            el = cls.__new__(cls)
            el.value = value
            return el

        @classmethod
        def zero(cls) -> "_F":
            return cls.from_reduced(0)

        @classmethod
        def one(cls) -> "_F":
            return cls.from_reduced(1 % p)

        # -- predicates ---------------------------------------------------
        def is_zero(self) -> bool:
            return self.value == 0

        def is_one(self) -> bool:
            return self.value == 1

        def eql(self, other: "_F") -> bool:
            return self.value == other.value

        __eq__ = eql

        def __hash__(self):
            return hash((p, self.value))

        # -- arithmetic (field.zig:73-225) --------------------------------
        def add(self, other: "_F") -> "_F":
            s = self.value + other.value
            if s >= p:
                s -= p
            return type(self).from_reduced(s)

        def sub(self, other: "_F") -> "_F":
            d = self.value - other.value
            if d < 0:
                d += p
            return type(self).from_reduced(d)

        def neg(self) -> "_F":
            if self.value == 0:
                return type(self).from_reduced(0)
            return type(self).from_reduced(p - self.value)

        def mul(self, other: "_F") -> "_F":
            return type(self).from_reduced((self.value * other.value) % p)

        def square(self) -> "_F":
            return self.mul(self)

        def inv(self) -> "_F":
            # Extended Euclid (field.zig:157-191); error on zero.
            if self.value == 0:
                raise ZeroDivisionError("NoInverse")
            return type(self).from_reduced(pow(self.value, -1, p))

        def div(self, other: "_F") -> "_F":
            if other.value == 0:
                raise ZeroDivisionError("DivisionByZero")
            return self.mul(other.inv())

        def pow(self, exp: int) -> "_F":
            return type(self).from_reduced(pow(self.value, exp, p))

        # -- conversions --------------------------------------------------
        def to_int(self) -> int:
            return self.value

        def to_bytes(self) -> bytes:
            """Canonical little-endian encoding of the u64 limb.

            This is ``std.mem.toBytes(element.toInt())`` for T=u64 — the
            exact byte string absorbed by transcripts and Merkle leaf
            hashes (hash.zig:139-141, merkle_tree.zig:246-252).
            """
            return self.value.to_bytes(self.NBYTES, "little")

        def __add__(self, other):
            return self.add(other)

        def __sub__(self, other):
            return self.sub(other)

        def __mul__(self, other):
            return self.mul(other)

        def __neg__(self):
            return self.neg()

        def __repr__(self):
            return f"F[{p}]({self.value})"

    _F.__name__ = f"Field_{p}"
    _field_cache[key] = _F
    return _F


F17 = Field(17)
BabyBear = Field(BABYBEAR_P)
KoalaBear = Field(_KOALABEAR_P)
Goldilocks = Field(_GOLDILOCKS_P)
Mersenne31 = Field(_MERSENNE31_P)
Mersenne61 = Field(_MERSENNE61_P)


def field_name(F: type) -> str:
    """field_presets.zig:82-90."""
    return {
        17: "F17 (test field)",
        BABYBEAR_P: "BabyBear",
        _KOALABEAR_P: "KoalaBear",
        _GOLDILOCKS_P: "Goldilocks",
        _MERSENNE31_P: "Mersenne31",
        _MERSENNE61_P: "Mersenne61",
    }.get(F.MODULUS, "Unknown field")


def has_efficient_reduction(F: type) -> bool:
    """field_presets.zig:93-106."""
    return F.MODULUS in (_GOLDILOCKS_P, _MERSENNE31_P, _MERSENNE61_P)


# ---------------------------------------------------------------------------
# Vectorized helpers (numpy twins of the scalar ops) — used by the witness
# generator and commitment layers for throughput; must agree bit-for-bit with
# the scalar class (property-tested in tests/test_field.py).
# ---------------------------------------------------------------------------

def np_reduce_u64(values: np.ndarray, modulus: int) -> np.ndarray:
    """Reduce raw u64 machine words into canonical field values (as uint64).

    Equivalent to mapping ``F.init(v)`` over the array (witness.zig:79 etc.);
    numpy uint64 ``%`` is exact for any 64-bit modulus.
    """
    return np.asarray(values, dtype=np.uint64) % np.uint64(modulus)


def np_addmod(a: np.ndarray, b: np.ndarray, modulus: int) -> np.ndarray:
    """Exact modular add for moduli < 2^63 (no wraparound in uint64)."""
    return (a + b) % np.uint64(modulus)


def np_mulmod_31(a: np.ndarray, b: np.ndarray, modulus: int) -> np.ndarray:
    """Exact modmul for sub-32-bit moduli via uint64 intermediates."""
    return (a.astype(np.uint64) * b.astype(np.uint64)) % np.uint64(modulus)


def batch_inv(values, F=BabyBear):
    """Batched inversion via Montgomery's trick (host-side utility)."""
    p = F.MODULUS
    vals = [v.value if hasattr(v, "value") else int(v) for v in values]
    n = len(vals)
    prefix = [1] * (n + 1)
    for i, v in enumerate(vals):
        if v == 0:
            raise ZeroDivisionError("NoInverse")
        prefix[i + 1] = (prefix[i] * v) % p
    inv_all = pow(prefix[n], -1, p)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = (prefix[i] * inv_all) % p
        inv_all = (inv_all * vals[i]) % p
    return [F.from_reduced(v) for v in out]
