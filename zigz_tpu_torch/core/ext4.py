"""BabyBear degree-4 extension field F_p[X]/(X^4 - 11), vectorized.

Soundness hardening for protocol v2+ (round-2 verdict item 1): every
Fiat-Shamir challenge that a forged multiset/zerocheck could grind against
— logUp fingerprints, zerocheck taus/alphas, sumcheck round challenges,
Ligero batching/proximity coefficients — is drawn from this ~2^124-element
extension instead of the ~2^31 base field.  The committed data stays in
the base field; only challenges and the algebra touching them live here.

The modulus X^4 - 11 matches Plonky3's BabyBear quartic extension (11 is a
quadratic non-residue mod p and p = 1 mod 4, so the binomial is
irreducible).  The reference itself squeezes single base-field limbs
(hash.zig:228-242); this module is where the TPU build goes beyond it.

Representation: an :class:`Ext4` wraps a canonical ``uint64`` numpy array
of shape ``(4,) + base_shape`` — coordinate axis FIRST so each base-field
lane stays contiguous for vector ops.  A scalar is shape ``(4,)``.

Operator overloading is the load-bearing design choice: ``__array_ufunc__
= None`` makes numpy defer mixed expressions to Ext4's reflected
operators, so the protocol combiners written in the generic
``(a + p - b) % p`` / ``a * b % p`` style work unchanged whether their
inputs are base arrays, base ints, or Ext4 values.  ``% p`` is a no-op on
an Ext4 (coordinates are kept canonical), and int/ndarray operands are
reduced mod p on coercion.

Inversion uses the Frobenius/norm method: phi(a) scales coordinate i by
sigma^i with sigma = 11^((p-1)/4) (a primitive 4th root of unity), so
b = phi(a) phi^2(a) phi^3(a) costs two multiplications, N(a) = (a b)_0 is
a base-field element, and a^-1 = b / N(a) — one base inversion per batch
via the existing vectorized Fermat/native path.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Union

import numpy as np

__all__ = [
    "P",
    "W",
    "SIGMA",
    "Ext4",
    "ext_zeros",
    "ext_lift",
    "ext_from_ints",
    "ext_from_coords",
    "ext_stack",
    "ext_linear_comb",
    "ext_where",
    "ext_pow_range",
    "ext_batch_inv",
    "challenge_ext",
    "MAX_NONCE",
]

P = 2013265921  # BabyBear
W = 11  # X^4 = W (Plonky3's BabyBear quartic extension constant)
SIGMA = pow(W, (P - 1) // 4, P)  # primitive 4th root of unity
_P64 = np.uint64(P)
_W64 = np.uint64(W)

# Verifier-enforced cap on every logUp/fingerprint nonce-retry counter.
# With extension-field challenges a zero denominator occurs with
# probability ~rows/p^4 (~2^-100 at 2^20 rows), so honest provers always
# land on nonce 0 (needing even one retry is a ~2^-100 event; exhausting
# the cap is ~2^-300).  The cap bounds the grinding surface a malicious
# prover gets from the retry loop to log2(MAX_NONCE+1) < 1.6 bits — see
# PROVER.md "Soundness budget".
MAX_NONCE = 2

_FROB = [
    np.array([pow(SIGMA, (k * i) % 4, P) for i in range(4)], dtype=np.uint64)
    for k in range(4)
]


def _reduce(x) -> np.ndarray:
    """Coerce an int / bool / uint64 ndarray to canonical mod-p form."""
    if isinstance(x, (int, np.integer)):
        return np.uint64(int(x) % P)
    arr = np.asarray(x, dtype=np.uint64)
    return arr % _P64


class Ext4:
    """One extension element or an array of them (coordinate axis first)."""

    __slots__ = ("c",)
    __array_ufunc__ = None  # numpy defers mixed ops to our reflected methods
    __array_priority__ = 1000

    def __init__(self, coords: np.ndarray, _trusted: bool = False):
        c = np.asarray(coords, dtype=np.uint64)
        assert c.shape[0] == 4, f"coordinate axis must be first, got {c.shape}"
        self.c = c if _trusted else c % _P64

    # -- constructors -------------------------------------------------------
    @staticmethod
    def zeros(shape=()) -> "Ext4":
        return Ext4(np.zeros((4,) + tuple(np.atleast_1d(shape)) if shape else (4,),
                             dtype=np.uint64), _trusted=True)

    @staticmethod
    def lift(base) -> "Ext4":
        b = _reduce(base)
        if np.ndim(b) == 0:
            c = np.zeros(4, dtype=np.uint64)
            c[0] = b
        else:
            c = np.zeros((4,) + b.shape, dtype=np.uint64)
            c[0] = b
        return Ext4(c, _trusted=True)

    @staticmethod
    def from_ints(vals: Sequence[int]) -> "Ext4":
        assert len(vals) == 4
        return Ext4(np.array([v % P for v in vals], dtype=np.uint64), _trusted=True)

    # -- shape / access -----------------------------------------------------
    @property
    def shape(self):
        return self.c.shape[1:]

    @property
    def is_scalar(self) -> bool:
        return self.c.ndim == 1

    def coords(self) -> List[np.ndarray]:
        return [self.c[e] for e in range(4)]

    def to_ints(self):
        assert self.is_scalar, "to_ints() is for scalar Ext4 values"
        return tuple(int(v) for v in self.c)

    def copy(self) -> "Ext4":
        return Ext4(self.c.copy(), _trusted=True)

    def __getitem__(self, key) -> "Ext4":
        if not isinstance(key, tuple):
            key = (key,)
        return Ext4(self.c[(slice(None),) + key], _trusted=True)

    def __len__(self) -> int:
        return self.c.shape[1]

    def __repr__(self) -> str:
        if self.is_scalar:
            return f"Ext4{self.to_ints()}"
        return f"Ext4<shape={self.shape}>"

    def __eq__(self, other) -> bool:
        if isinstance(other, Ext4):
            return np.array_equal(self.c, other.c)
        o = _coerce(other)
        return np.array_equal(self.c, o.c) if o is not None else NotImplemented

    def __hash__(self):
        assert self.is_scalar
        return hash(self.to_ints())

    def is_zero(self) -> np.ndarray:
        """Elementwise all-coordinates-zero mask (bool array / scalar)."""
        return np.all(self.c == 0, axis=0)

    # -- ring ops -----------------------------------------------------------
    def __add__(self, other) -> "Ext4":
        o = _coerce(other)
        if o is None:
            return NotImplemented
        out = _native_addsub(self.c, o.c, is_sub=False)
        if out is not None:
            return Ext4(out, _trusted=True)
        a, b = _align(self.c, o.c)
        return Ext4((a + b) % _P64, _trusted=True)

    __radd__ = __add__

    def __sub__(self, other) -> "Ext4":
        o = _coerce(other)
        if o is None:
            return NotImplemented
        out = _native_addsub(self.c, o.c, is_sub=True)
        if out is not None:
            return Ext4(out, _trusted=True)
        a, b = _align(self.c, o.c)
        return Ext4((a + _P64 - b) % _P64, _trusted=True)

    def __rsub__(self, other) -> "Ext4":
        o = _coerce(other)
        if o is None:
            return NotImplemented
        out = _native_addsub(o.c, self.c, is_sub=True)
        if out is not None:
            return Ext4(out, _trusted=True)
        a, b = _align(self.c, o.c)
        return Ext4((b + _P64 - a) % _P64, _trusted=True)

    def __neg__(self) -> "Ext4":
        return Ext4((_P64 - self.c) % _P64, _trusted=True)

    def __mod__(self, modulus) -> "Ext4":
        # Coordinates are kept canonical; (x % p) is the identity.  This
        # makes the shared `a * b % p` combiner idiom type-generic.
        return self

    def __mul__(self, other) -> "Ext4":
        if isinstance(other, Ext4):
            return _ext_mul(self, other)
        if isinstance(other, (int, np.integer)) or isinstance(other, np.ndarray) \
                or isinstance(other, (bool, np.bool_)):
            s = _reduce(other)
            if isinstance(s, np.ndarray) and s.ndim:
                # Native threaded kernels for the 1-D hot shapes (the
                # numpy path pays a u64 divide per coordinate element).
                if s.ndim == 1 and _native() is not None \
                        and s.shape[0] >= _NATIVE_MIN:
                    from ..runtime import (
                        native_ext4_mul_base,
                        native_ext4_scale_base,
                    )

                    col = np.ascontiguousarray(s)
                    if self.c.ndim == 1:  # scalar ext x base vector
                        out = native_ext4_scale_base(
                            np.ascontiguousarray(self.c), col
                        )
                        if out is not None:
                            return Ext4(out, _trusted=True)
                    elif self.c.ndim == 2 and self.c.shape[1] == s.shape[0]:
                        out = native_ext4_mul_base(
                            np.ascontiguousarray(self.c), col
                        )
                        if out is not None:
                            return Ext4(out, _trusted=True)
                a, b = _align(self.c, s[None, ...])
                return Ext4(a * b % _P64, _trusted=True)
            return Ext4(self.c * s % _P64, _trusted=True)
        return NotImplemented

    __rmul__ = __mul__

    def __pow__(self, e: int) -> "Ext4":
        assert isinstance(e, (int, np.integer)) and e >= 0
        result = Ext4.lift(np.ones(self.shape, dtype=np.uint64)) if self.shape \
            else Ext4.from_ints([1, 0, 0, 0])
        acc = self
        e = int(e)
        while e:
            if e & 1:
                result = result * acc
            acc = acc * acc
            e >>= 1
        return result

    # -- field ops ----------------------------------------------------------
    def frobenius(self, k: int = 1) -> "Ext4":
        """a -> a^(p^k): coordinate i scales by sigma^(k*i)."""
        tw = _FROB[k % 4]
        return Ext4(self.c * tw.reshape((4,) + (1,) * (self.c.ndim - 1)) % _P64,
                    _trusted=True)

    def inv(self) -> "Ext4":
        """Batched inverse via Frobenius/norm; maps 0 to 0 (callers mask)."""
        if self.c.ndim == 2 and _native() is not None \
                and self.c.shape[1] >= _NATIVE_MIN:
            from ..runtime import native_ext4_inv

            out = native_ext4_inv(np.ascontiguousarray(self.c), SIGMA)
            if out is not None:
                return Ext4(out, _trusted=True)
        from ..poly.public_mles import np_inv

        b = self.frobenius(1) * self.frobenius(2)
        b = b * self.frobenius(3)
        n = (self * b).c[0]  # norm: base-field element (other coords vanish)
        n_inv = np_inv(np.atleast_1d(n), P)
        if self.is_scalar:
            n_inv = n_inv[0]
        return Ext4(b.c * n_inv % _P64, _trusted=True)

    def sum(self) -> "Ext4":
        """Hypercube sum over the trailing axes -> scalar Ext4.  Exact:
        canonical coords < 2^31, so uint64 sums hold for <= 2^33 terms."""
        if self.is_scalar:
            return self
        flat = self.c.reshape(4, -1)
        return Ext4(flat.sum(axis=1, dtype=np.uint64) % _P64, _trusted=True)


def _align(a: np.ndarray, b: np.ndarray):
    """Broadcast two coordinate arrays with the coordinate axis FIRST:
    pad the lower-rank operand with trailing singleton axes so numpy's
    trailing-axis broadcasting lines the base shapes up."""
    if a.ndim < b.ndim:
        a = a.reshape(a.shape + (1,) * (b.ndim - a.ndim))
    elif b.ndim < a.ndim:
        b = b.reshape(b.shape + (1,) * (a.ndim - b.ndim))
    return a, b


def _coerce(other) -> Union[Ext4, None]:
    if isinstance(other, Ext4):
        return other
    if isinstance(other, (int, np.integer, bool, np.bool_)):
        return Ext4.lift(int(other))
    if isinstance(other, np.ndarray):
        return Ext4.lift(other)
    return None


_NATIVE_MIN = 4096  # below this, ctypes + thread overhead beats the win
_NATIVE_STATE = {"checked": False, "fn": None}


def _native_addsub(ac: np.ndarray, bc: np.ndarray, is_sub: bool):
    """Native a +/- b for the hot 1-D shapes ((4, n) op (4, n) / (4,));
    None -> numpy fallback."""
    if _native() is None:
        return None
    if ac.ndim == 2 and ac.shape[1] >= _NATIVE_MIN:
        from ..runtime import native_ext4_addsub

        if bc.ndim == 2 and bc.shape == ac.shape:
            return native_ext4_addsub(
                np.ascontiguousarray(ac), np.ascontiguousarray(bc), False, is_sub
            )
        if bc.ndim == 1:
            return native_ext4_addsub(
                np.ascontiguousarray(ac), np.ascontiguousarray(bc), True, is_sub
            )
    elif bc.ndim == 2 and bc.shape[1] >= _NATIVE_MIN and ac.ndim == 1:
        from ..runtime import native_ext4_addsub

        # scalar + array, or scalar - array (reversed-sub kernel mode 2).
        return native_ext4_addsub(
            np.ascontiguousarray(bc), np.ascontiguousarray(ac), True,
            2 if is_sub else 0,
        )
    return None


def _native():
    """runtime module when the native ext4 kernels are available."""
    if not _NATIVE_STATE["checked"]:
        _NATIVE_STATE["checked"] = True
        try:
            from .. import runtime

            if runtime.native_ext4_available():
                _NATIVE_STATE["fn"] = runtime
        except Exception:
            _NATIVE_STATE["fn"] = None
    return _NATIVE_STATE["fn"]


def _ext_mul(a: Ext4, b: Ext4) -> Ext4:
    """Schoolbook product with X^4 = W.  Each partial product is reduced
    before accumulation, so coordinate sums stay far below 2^64."""
    if _native() is not None:
        from ..runtime import native_ext4_mul

        # 1-D array x array (same width) or array x scalar: threaded C++.
        if a.c.ndim == 2 and a.c.shape[1] >= _NATIVE_MIN:
            if b.c.ndim == 2 and b.c.shape == a.c.shape:
                out = native_ext4_mul(
                    np.ascontiguousarray(a.c), np.ascontiguousarray(b.c), False
                )
                if out is not None:
                    return Ext4(out, _trusted=True)
            elif b.c.ndim == 1:
                out = native_ext4_mul(
                    np.ascontiguousarray(a.c), np.ascontiguousarray(b.c), True
                )
                if out is not None:
                    return Ext4(out, _trusted=True)
        elif (b.c.ndim == 2 and b.c.shape[1] >= _NATIVE_MIN
              and a.c.ndim == 1):
            out = native_ext4_mul(
                np.ascontiguousarray(b.c), np.ascontiguousarray(a.c), True
            )
            if out is not None:
                return Ext4(out, _trusted=True)
    ac, bc = a.c, b.c
    t = [[ac[i] * bc[j] % _P64 for j in range(4)] for i in range(4)]
    c0 = (t[0][0] + _W64 * ((t[1][3] + t[2][2] + t[3][1]) % _P64)) % _P64
    c1 = (t[0][1] + t[1][0] + _W64 * ((t[2][3] + t[3][2]) % _P64)) % _P64
    c2 = (t[0][2] + t[1][1] + t[2][0] + _W64 * t[3][3]) % _P64
    c3 = (t[0][3] + t[1][2] + t[2][1] + t[3][0]) % _P64
    return Ext4(np.stack([c0, c1, c2, c3]), _trusted=True)


# ---------------------------------------------------------------------------
# Module-level helpers


def ext_zeros(shape=()) -> Ext4:
    if shape == () or shape is None:
        return Ext4(np.zeros(4, dtype=np.uint64), _trusted=True)
    if isinstance(shape, (int, np.integer)):
        shape = (int(shape),)
    return Ext4(np.zeros((4,) + tuple(shape), dtype=np.uint64), _trusted=True)


def ext_lift(base) -> Ext4:
    return Ext4.lift(base)


def ext_from_ints(vals: Sequence[int]) -> Ext4:
    return Ext4.from_ints(vals)


# Basis monomials X^0..X^3 (multiplying by X^e rotates coordinates with a
# W-scaled wraparound).
_BASIS = [Ext4.from_ints([1 if i == e else 0 for i in range(4)]) for e in range(4)]


# Set by ops/symtrace.py at import: routes symbolic (traced) coordinate
# values to the SymExt stacker so combiners recombine unchanged under the
# native Ext4 zerocheck's DAG tracing.
_SYMEXT_HOOK = None


def ext_from_coords(coords: Sequence) -> Ext4:
    """Recombine an extension value from its 4 coordinate parts.

    Two shapes occur in the protocol: BASE coordinate columns (the
    committed representation of an ext-valued logUp column) stack directly
    into an Ext4 array; Ext4 coordinate values (the same columns after
    extension-point folding/evaluation) recombine as sum_e coord_e * X^e.
    """
    assert len(coords) == 4
    if _SYMEXT_HOOK is not None and any(
        not isinstance(c, (Ext4, int, np.integer, bool, np.bool_, np.ndarray))
        for c in coords
    ):
        return _SYMEXT_HOOK(coords)
    if any(isinstance(c, Ext4) for c in coords):
        acc = None
        for e, part in enumerate(coords):
            term = _coerce(part) * _BASIS[e]
            acc = term if acc is None else acc + term
        return acc
    return Ext4(np.stack([_reduce(np.asarray(c)) for c in coords]))


def ext_stack(values: Iterable[Ext4]) -> Ext4:
    """Stack scalar Ext4 values into an Ext4 array (last axis = entries)."""
    vals = list(values)
    return Ext4(np.stack([v.c for v in vals], axis=-1), _trusted=True)


def ext_concat(parts: Sequence[Ext4]) -> Ext4:
    """Concatenate Ext4 arrays along the last (base) axis."""
    return Ext4(np.concatenate([p.c for p in parts], axis=-1), _trusted=True)


def ext_linear_comb(coeffs: Sequence[Ext4], arrays: Sequence[np.ndarray],
                    length: int = None) -> Ext4:
    """sum_i coeffs[i] * arrays[i] for scalar Ext4 coefficients and base
    uint64 arrays (canonical values), in one fused native pass
    (zigz_ext4_scale_base_multi) — the logUp fingerprint-combination hot
    loop.  Falls back to the operator path when the runtime is missing."""
    assert len(coeffs) == len(arrays) and arrays
    n = length if length is not None else len(arrays[0])
    cols = [np.ascontiguousarray(np.asarray(a, dtype=np.uint64)[:n])
            for a in arrays]
    rt = _native()
    if rt is not None and n >= 1024:
        cf = np.stack([np.asarray(c.c, dtype=np.uint64).reshape(4)
                       for c in coeffs])
        out = ext_zeros((n,))
        if rt.native_ext4_scale_base_multi(cf, cols, out.c) is not None:
            return out
    acc = None
    for c, col in zip(coeffs, cols):
        term = c * (col % _P64)
        acc = term if acc is None else acc + term
    return acc


def ext_where(mask, a, b) -> Ext4:
    ae, be = _coerce(a), _coerce(b)
    m = np.asarray(mask, dtype=bool)
    return Ext4(np.where(m[None, ...], ae.c, be.c), _trusted=True)


def ext_pow_range(base: Ext4, count: int) -> Ext4:
    """[base^1, ..., base^count] as an Ext4 array — vectorized doubling
    (log2(count) masked multiplies), the extension twin of the Ligero
    _pow_range helper."""
    assert base.is_scalar
    if count == 0:
        return ext_zeros((0,))
    ks = np.arange(1, count + 1, dtype=np.uint64)
    out = Ext4.lift(np.ones(count, dtype=np.uint64))
    sq = Ext4(np.repeat(base.c[:, None], count, axis=1), _trusted=True)
    bit = np.uint64(1)
    for _ in range(int(count).bit_length() + 1):
        mask = (ks & bit) != 0
        if mask.any():
            prod = out * sq
            out = Ext4(np.where(mask[None, :], prod.c, out.c), _trusted=True)
        sq = sq * sq
        bit <<= np.uint64(1)
    return out


def ext_batch_inv(values: Ext4) -> Ext4:
    return values.inv()


def high_coords_nonzero(x: Ext4) -> bool:
    """True when any of the X^1..X^3 coordinates is nonzero — such a value
    can never equal a lifted base-field element, so fingerprint
    denominators tau - base_key are automatically nonzero (the extension
    twin of the round-2 ``tau_r >= 2^16`` trick).  A fresh extension draw
    fails this with probability ~2^-93."""
    return bool(np.any(x.c[1:]))


def challenge_ext(transcript) -> Ext4:
    """Four successive base-field squeezes form one extension challenge.
    Each squeeze re-absorbs its digest (hash.zig:301-316), so the four
    limbs are domain-separated by construction."""
    return Ext4.from_ints([transcript.challenge_value(P) for _ in range(4)])
