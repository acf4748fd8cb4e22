"""Dense multilinear polynomials over the boolean hypercube.

Reference: zigz src/poly/multilinear.zig.  Stores the 2^v
evaluations on {0,1}^v; index bit i is variable i.

Ordering quirk inherited from the reference (and replicated exactly because
commitment openings depend on it):

* ``eval(point)`` assigns ``point[j]`` to index bit j, i.e. point[0] pairs
  with the LEAST-significant index bit (multilinear.zig:110-144).
* ``partial_eval(r)`` / ``round_polynomial()`` split the table at half, i.e.
  they fix the MOST-significant index bit (multilinear.zig:154-232).

The two orderings are mutually reversed; each consumer in the reference is
internally consistent, and we mirror both.

Storage is a numpy ``uint64`` array of canonical values for sub-32-bit
moduli (vectorized hot path, exact because products < 2^62 fit u64); larger
moduli (Goldilocks) fall back to object-dtype exact integer math.
"""

from __future__ import annotations

import numpy as np

__all__ = ["Multilinear"]


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


class Multilinear:
    __slots__ = ("F", "evals", "num_vars")

    def __init__(self, F, evaluations):
        """``evaluations`` — sequence of field elements, ints, or uint64 array
        of canonical values; length must be a power of two
        (multilinear.zig:36-54)."""
        if isinstance(evaluations, np.ndarray):
            vals = evaluations
            n = vals.shape[0]
        else:
            n = len(evaluations)
            vals = np.empty(n, dtype=np.uint64 if F.MODULUS < (1 << 32) else object)
            for i, e in enumerate(evaluations):
                vals[i] = e.value if hasattr(e, "value") else int(e) % F.MODULUS
        if n == 0:
            raise ValueError("EmptyEvaluations")
        if not _is_pow2(n):
            raise ValueError("LengthNotPowerOfTwo")
        self.F = F
        self.evals = vals.astype(np.uint64) if F.MODULUS < (1 << 32) else np.asarray(vals, dtype=object)
        self.num_vars = n.bit_length() - 1

    # -- constructors -----------------------------------------------------
    @classmethod
    def zero(cls, F, num_vars: int) -> "Multilinear":
        return cls(F, np.zeros(1 << num_vars, dtype=np.uint64))

    @classmethod
    def constant(cls, F, num_vars: int, value) -> "Multilinear":
        v = value.value if hasattr(value, "value") else int(value) % F.MODULUS
        return cls(F, np.full(1 << num_vars, v, dtype=np.uint64))

    @classmethod
    def from_canonical_array(cls, F, arr: np.ndarray) -> "Multilinear":
        """Zero-copy wrap of an already-reduced uint64 array."""
        return cls(F, np.asarray(arr, dtype=np.uint64))

    # -- helpers ----------------------------------------------------------
    def _p(self) -> int:
        return self.F.MODULUS

    def element(self, idx: int):
        return self.F.from_reduced(int(self.evals[idx]))

    def is_zero(self) -> bool:
        return not np.any(self.evals)

    # -- evaluation (multilinear.zig:110-144; LSB-first point ordering) ---
    def eval(self, point) -> object:
        """Evaluate at an arbitrary point; point[0] pairs with index bit 0.

        Implemented as successive LSB folds — algebraically identical to the
        reference's chi-product sum and O(2^v) like it.
        """
        if len(point) != self.num_vars:
            raise ValueError("WrongNumberOfVariables")
        p = self._p()
        rs = [r.value if hasattr(r, "value") else int(r) % p for r in point]
        if p < (1 << 32):
            cur = self.evals
            for r in rs:
                r_ = np.uint64(r)
                one_minus = np.uint64((1 - r) % p)
                e0 = cur[0::2]
                e1 = cur[1::2]
                cur = (one_minus * e0 + r_ * e1) % np.uint64(p)
            return self.F.from_reduced(int(cur[0]))
        # Exact big-int fallback
        cur = [int(v) for v in self.evals]
        for r in rs:
            om = (1 - r) % p
            cur = [(om * cur[2 * i] + r * cur[2 * i + 1]) % p for i in range(len(cur) // 2)]
        return self.F.from_reduced(cur[0])

    # -- partial evaluation (multilinear.zig:154-180; fixes the MSB) ------
    def partial_eval(self, r) -> "Multilinear":
        if self.num_vars == 0:
            raise ValueError("NoVariablesToFix")
        p = self._p()
        rv = r.value if hasattr(r, "value") else int(r) % p
        half = len(self.evals) // 2
        if p < (1 << 32):
            om = np.uint64((1 - rv) % p)
            rr = np.uint64(rv)
            new = (om * self.evals[:half] + rr * self.evals[half:]) % np.uint64(p)
            return Multilinear(self.F, new)
        om = (1 - rv) % p
        new = np.array(
            [(om * int(self.evals[i]) + rv * int(self.evals[i + half])) % p for i in range(half)],
            dtype=object,
        )
        return Multilinear(self.F, new)

    # -- hypercube sum (multilinear.zig:188-194) --------------------------
    def sum_over_hypercube(self):
        p = self._p()
        if p < (1 << 32):
            # Chunked sum to stay exact in uint64 (each value < 2^31).
            total = 0
            arr = self.evals
            for i in range(0, len(arr), 1 << 20):
                total = (total + int(np.sum(arr[i : i + (1 << 20)], dtype=np.uint64) % np.uint64(p))) % p
            return self.F.from_reduced(total)
        return self.F.from_reduced(sum(int(v) for v in self.evals) % p)

    # -- sumcheck round polynomial (multilinear.zig:205-232) --------------
    def round_polynomial(self):
        """Return [g(0), g(1)-g(0)] with the half-split (MSB) convention."""
        if self.num_vars == 0:
            raise ValueError("NoVariables")
        p = self._p()
        half = len(self.evals) // 2
        if p < (1 << 32):
            s0 = int(np.sum(self.evals[:half].astype(object))) % p
            s1 = int(np.sum(self.evals[half:].astype(object))) % p
        else:
            s0 = sum(int(v) for v in self.evals[:half]) % p
            s1 = sum(int(v) for v in self.evals[half:]) % p
        return [self.F.from_reduced(s0), self.F.from_reduced((s1 - s0) % p)]

    # -- linear ops (multilinear.zig:235-264) -----------------------------
    def add(self, other: "Multilinear") -> "Multilinear":
        if self.num_vars != other.num_vars:
            raise ValueError("DifferentNumberOfVariables")
        p = self._p()
        if p < (1 << 32):
            return Multilinear(self.F, (self.evals + other.evals) % np.uint64(p))
        new = np.array(
            [(int(a) + int(b)) % p for a, b in zip(self.evals, other.evals)], dtype=object
        )
        return Multilinear(self.F, new)

    def scalar_mul(self, scalar) -> "Multilinear":
        p = self._p()
        s = scalar.value if hasattr(scalar, "value") else int(scalar) % p
        if p < (1 << 32):
            return Multilinear(self.F, (self.evals * np.uint64(s)) % np.uint64(p))
        return Multilinear(self.F, np.array([(int(v) * s) % p for v in self.evals], dtype=object))

    def __repr__(self):
        head = ", ".join(str(int(v)) for v in self.evals[:4])
        more = ", ..." if len(self.evals) > 4 else ""
        return f"MLE({self.num_vars} vars, {len(self.evals)} evals: [{head}{more}])"
