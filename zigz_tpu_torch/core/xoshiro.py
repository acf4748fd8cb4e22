"""Bit-exact replica of Zig's ``std.Random.DefaultPrng`` (Xoshiro256++).

The reference prover seeds one of these (seed=0 from the CLI,
prover.zig:44-47 / main.zig:148) for the placeholder Lasso round-polynomial
filler (prover.zig:334-349).  Because pipeline Lasso proofs always have
``num_vars = log2_ceil(1) = 0`` the stream is never actually consumed by the
v1 pipeline, but the generator is part of the reference's public surface and
a consensus hazard if that ever changes — so we replicate it exactly:

* seeding expands the u64 seed through SplitMix64 into 4 state words;
* ``next()`` is xoshiro256++ (rotl(s0 + s3, 23) + s0);
* ``Random.int(u64)`` consumes exactly one ``next()`` (Xoshiro256.fill
  writes whole little-endian u64s).
"""

from __future__ import annotations

__all__ = ["SplitMix64", "Xoshiro256", "DefaultPrng"]

_M64 = (1 << 64) - 1


def _rotl(x: int, k: int) -> int:
    return ((x << k) | (x >> (64 - k))) & _M64


class SplitMix64:
    __slots__ = ("s",)

    def __init__(self, seed: int):
        self.s = seed & _M64

    def next(self) -> int:
        self.s = (self.s + 0x9E3779B97F4A7C15) & _M64
        z = self.s
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
        return z ^ (z >> 31)


class Xoshiro256:
    """xoshiro256++ with SplitMix64 seeding — Zig std.Random.Xoshiro256."""

    __slots__ = ("s",)

    def __init__(self, seed: int):
        gen = SplitMix64(seed)
        self.s = [gen.next(), gen.next(), gen.next(), gen.next()]

    def next(self) -> int:
        s = self.s
        r = (_rotl((s[0] + s[3]) & _M64, 23) + s[0]) & _M64
        t = (s[1] << 17) & _M64
        s[2] ^= s[0]
        s[3] ^= s[1]
        s[1] ^= s[2]
        s[0] ^= s[3]
        s[2] ^= t
        s[3] = _rotl(s[3], 45)
        return r

    def int_u64(self) -> int:
        """``rng.int(u64)`` — one whole-word draw."""
        return self.next()


DefaultPrng = Xoshiro256
