"""BabyBear^4 = F_p[X]/(X^4 - 11) in plain Python integers, and the v2
transcript's squeezes.

An element is a tuple of its four coordinates (c0, c1, c2, c3), canonical
mod p. Protocol v2 draws every algebraic challenge from this field: four
successive base-field squeezes of the transcript, one a coordinate. A
column position is a squeeze's low bits instead (`Transcript.index`).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from .proof import Transcript as _Transcript

P = 2013265921
W = 11  # X^4 = W
Ext = Tuple[int, int, int, int]
ZERO: Ext = (0, 0, 0, 0)


def add(a: Ext, b: Ext) -> Ext:
    return tuple((x + y) % P for x, y in zip(a, b))


def sub(a: Ext, b: Ext) -> Ext:
    return tuple((x - y) % P for x, y in zip(a, b))


def mul(a: Ext, b: Ext) -> Ext:
    c = [0] * 7
    for i in range(4):
        for j in range(4):
            c[i + j] += a[i] * b[j]
    return tuple((c[k] + W * (c[k + 4] if k < 3 else 0)) % P for k in range(4))


def lift(x: int) -> Ext:
    return (x % P, 0, 0, 0)


def interpolate(ys: Sequence[Ext], x: Ext) -> Ext:
    """The polynomial of degree len(ys) - 1 through (i, ys[i]), i = 0..d, at x."""
    d = len(ys) - 1
    acc = ZERO
    for i in range(d + 1):
        num = lift(1)
        den = 1
        for j in range(d + 1):
            if j != i:
                num = mul(num, sub(x, lift(j)))
                den = den * (i - j) % P
        acc = add(acc, mul(mul(ys[i], num), lift(pow(den, P - 2, P))))
    return acc


class Transcript(_Transcript):
    """The streaming SHA3-256 transcript of `proof.Transcript`, with the raw
    absorbs and the squeezes protocol v2 adds."""

    def u64(self, value: int) -> None:
        self.absorb(int(value).to_bytes(8, "little"))

    def u64s(self, values) -> None:
        self.absorb(np.ascontiguousarray(values, dtype="<u8").tobytes())

    def ext(self, x: Ext) -> None:
        self.u64s(list(x))

    def challenge_ext(self) -> Ext:
        return tuple(self.challenge(P) for _ in range(4))

    def challenges_ext(self, n: int) -> List[Ext]:
        return [self.challenge_ext() for _ in range(n)]

    def index(self, n: int) -> int:
        """A column position in [0, n), n a power of two: the low bits of
        the squeeze's first 8 digest bytes."""
        digest = self._h.copy().digest()
        self._h.update(digest)
        return int.from_bytes(digest[:8], "little") & (n - 1)


def basis(e: int) -> Ext:
    return tuple(int(k == e) for k in range(4))


def from_coords(coords: Sequence[Ext]) -> Ext:
    """An extension value from the evaluations of its four coordinate
    columns: sum_e coords[e] X^e."""
    acc = ZERO
    for e, c in enumerate(coords):
        acc = add(acc, mul(c, basis(e)))
    return acc


def eq(taus: Sequence[Ext], rs: Sequence[Ext]) -> Ext:
    """prod_j ((1 - tau_j)(1 - r_j) + tau_j r_j)."""
    one, acc = lift(1), lift(1)
    for t, r in zip(taus, rs):
        acc = mul(acc, add(mul(sub(one, t), sub(one, r)), mul(t, r)))
    return acc


def index_mle(rs: Sequence[Ext]) -> Ext:
    """The multilinear extension of a row's index at rs, the first
    coordinate binding the most significant bit."""
    v, acc = len(rs), ZERO
    for j, r in enumerate(rs):
        acc = add(acc, mul(lift(1 << (v - 1 - j)), r))
    return acc


def le_mle(c: int, rs: Sequence[Ext]) -> Ext:
    """The multilinear extension of 1[index <= c] at rs (most significant
    bit first)."""
    v = len(rs)
    if c < 0:
        return ZERO
    if c >= (1 << v) - 1:
        return lift(1)
    one, acc, prefix = lift(1), ZERO, lift(1)
    for j, r in enumerate(rs):
        if (c >> (v - 1 - j)) & 1:
            acc = add(acc, mul(prefix, sub(one, r)))
            prefix = mul(prefix, r)
        else:
            prefix = mul(prefix, sub(one, r))
    return add(acc, prefix)


def mul_np(a: np.ndarray, b) -> np.ndarray:
    """Coordinate-wise products of (4, N) extension arrays (or a (4, N)
    array and one scalar Ext), reduced after every product."""
    b = np.asarray(b, dtype=np.uint64).reshape(4, -1)
    p = np.uint64(P)
    out = np.zeros((4, max(a.shape[1], b.shape[1])), dtype=np.uint64)
    for i in range(4):
        for j in range(4):
            term = a[i] * b[j] % p
            if i + j < 4:
                out[i + j] += term
            else:
                out[i + j - 4] += term * np.uint64(W) % p
    return out % p


def eq_table(taus: Sequence[Ext]) -> np.ndarray:
    """eq(taus, x) for every x of the hypercube, (4, 2^len) with the first
    tau binding the most significant bit of x."""
    table = np.array([[1], [0], [0], [0]], dtype=np.uint64)
    for t in reversed(taus):
        table = np.concatenate([mul_np(table, sub(lift(1), t)), mul_np(table, t)], axis=1)
    return table


def inv(a: Ext) -> Ext:
    """a^(p^4 - 2), the inverse of a non-zero a."""
    e, acc, base = P ** 4 - 2, lift(1), a
    while e:
        if e & 1:
            acc = mul(acc, base)
        base = mul(base, base)
        e >>= 1
    return acc


def powers(x: Ext, count: int) -> List[Ext]:
    """x^0 .. x^(count - 1)."""
    out = [lift(1)]
    while len(out) < count:
        out.append(mul(out[-1], x))
    return out


def esum(xs) -> Ext:
    out = ZERO
    for x in xs:
        out = add(out, x)
    return out


def lin(weights, values) -> Ext:
    """sum_i weights[i] values[i], each an int or an extension element."""
    def ext(x):
        return lift(x) if isinstance(x, int) else x
    return esum(mul(ext(w), ext(x)) for w, x in zip(weights, values))


def fraction(ds: Sequence[Ext], g: Ext, nums=None) -> Ext:
    """g prod(ds) - sum_j nums[j] prod_(l != j) ds[l]: zero where g is the
    sum of the fractions nums[j] / ds[j] (each 1 where not given)."""
    nums = nums or [lift(1)] * len(ds)
    prod, num = lift(1), ZERO
    for d, n in zip(ds, nums):
        num = add(mul(num, d), mul(n, prod))
        prod = mul(prod, d)
    return sub(mul(g, prod), num)


def combination(terms: Sequence[Ext], alphas: Sequence[Ext]) -> Ext:
    """sum_i alphas[i] terms[i]; KeyError where the zerocheck drew fewer
    challenges than it has constraints."""
    if len(alphas) < len(terms):
        raise KeyError(f"{len(alphas)} challenges for {len(terms)} constraints")
    return esum(mul(a, c) for a, c in zip(alphas, terms))
