"""Dense univariate polynomials (coefficient form).

Reference: zigz src/poly/univariate.zig — Horner evaluation,
add/sub/scalar-mul/neg/naive-mul/compose.
"""

from __future__ import annotations

__all__ = ["Univariate", "eval_univariate_coeffs"]


def eval_univariate_coeffs(F, coeffs, x):
    """Horner over a coefficient list (sumcheck_protocol.zig:113-123)."""
    if len(coeffs) == 0:
        return F.zero()
    p = F.MODULUS
    xv = x.value if hasattr(x, "value") else int(x) % p
    acc = coeffs[-1].value
    for c in reversed(coeffs[:-1]):
        acc = (acc * xv + c.value) % p
    return F.from_reduced(acc)


class Univariate:
    __slots__ = ("F", "coefficients")

    def __init__(self, F, coeffs):
        if len(coeffs) == 0:
            raise ValueError("EmptyCoefficients")
        self.F = F
        self.coefficients = [c if hasattr(c, "value") else F(int(c)) for c in coeffs]

    @classmethod
    def zero(cls, F):
        return cls(F, [F.zero()])

    @classmethod
    def constant(cls, F, value):
        return cls(F, [value])

    @classmethod
    def identity(cls, F):
        return cls(F, [F.zero(), F.one()])

    def degree(self) -> int:
        deg = 0
        for i, c in enumerate(self.coefficients):
            if not c.is_zero():
                deg = i
        return deg

    def is_zero(self) -> bool:
        return all(c.is_zero() for c in self.coefficients)

    def is_constant(self) -> bool:
        return self.degree() == 0

    def eval(self, x):
        return eval_univariate_coeffs(self.F, self.coefficients, x)

    def eval_many(self, points):
        return [self.eval(x) for x in points]

    def add(self, other: "Univariate") -> "Univariate":
        F = self.F
        n = max(len(self.coefficients), len(other.coefficients))
        out = []
        for i in range(n):
            a = self.coefficients[i] if i < len(self.coefficients) else F.zero()
            b = other.coefficients[i] if i < len(other.coefficients) else F.zero()
            out.append(a.add(b))
        return Univariate(F, out)

    def sub(self, other: "Univariate") -> "Univariate":
        F = self.F
        n = max(len(self.coefficients), len(other.coefficients))
        out = []
        for i in range(n):
            a = self.coefficients[i] if i < len(self.coefficients) else F.zero()
            b = other.coefficients[i] if i < len(other.coefficients) else F.zero()
            out.append(a.sub(b))
        return Univariate(F, out)

    def scalar_mul(self, scalar) -> "Univariate":
        return Univariate(self.F, [c.mul(scalar) for c in self.coefficients])

    def neg(self) -> "Univariate":
        return Univariate(self.F, [c.neg() for c in self.coefficients])

    def mul(self, other: "Univariate") -> "Univariate":
        F = self.F
        if self.is_zero() or other.is_zero():
            return Univariate.zero(F)
        out = [F.zero()] * (len(self.coefficients) + len(other.coefficients) - 1)
        for i, a in enumerate(self.coefficients):
            for j, b in enumerate(other.coefficients):
                out[i + j] = out[i + j].add(a.mul(b))
        return Univariate(F, out)

    def compose(self, inner: "Univariate") -> "Univariate":
        """p(q(x)) via Horner (univariate.zig:235-261)."""
        F = self.F
        result = Univariate.constant(F, self.coefficients[-1])
        for c in reversed(self.coefficients[:-1]):
            result = result.mul(inner).add(Univariate.constant(F, c))
        return result

    def __repr__(self):
        return f"Univariate({[c.value for c in self.coefficients]})"
