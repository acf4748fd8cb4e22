"""Lagrange interpolation + barycentric evaluation.

Reference: zigz src/poly/lagrange.zig — O(n^2) interpolation,
basis polynomials, vanishing polynomial, and the O(n)-per-eval barycentric
form.  Utility layer; not on the prover pipeline.
"""

from __future__ import annotations

from .univariate import Univariate

__all__ = ["interpolate", "lagrange_basis", "eval_lagrange_basis", "vanishing_polynomial", "BarycentricForm"]


def lagrange_basis(F, xs, i: int) -> Univariate:
    """L_i(x) = prod_{j != i} (x - x_j) / (x_i - x_j)."""
    num = Univariate.constant(F, F.one())
    denom = F.one()
    for j, xj in enumerate(xs):
        if j == i:
            continue
        num = num.mul(Univariate(F, [xj.neg(), F.one()]))
        denom = denom.mul(xs[i].sub(xj))
    return num.scalar_mul(denom.inv())


def interpolate(F, xs, ys) -> Univariate:
    """Unique degree-<n polynomial through the points (lagrange.zig:38-86)."""
    if len(xs) != len(ys):
        raise ValueError("MismatchedLengths")
    if len(xs) == 0:
        raise ValueError("EmptyPoints")
    seen = set()
    for x in xs:
        if x.value in seen:
            raise ValueError("DuplicatePoints")
        seen.add(x.value)
    result = Univariate.zero(F)
    for i in range(len(xs)):
        result = result.add(lagrange_basis(F, xs, i).scalar_mul(ys[i]))
    return result


def eval_lagrange_basis(F, xs, i: int, point):
    num = F.one()
    denom = F.one()
    for j, xj in enumerate(xs):
        if j == i:
            continue
        num = num.mul(point.sub(xj))
        denom = denom.mul(xs[i].sub(xj))
    return num.mul(denom.inv())


def vanishing_polynomial(F, xs) -> Univariate:
    """Z(x) = prod (x - x_i) (lagrange.zig:177-205)."""
    result = Univariate.constant(F, F.one())
    for x in xs:
        result = result.mul(Univariate(F, [x.neg(), F.one()]))
    return result


class BarycentricForm:
    """Precomputed weights for O(n) repeated evaluation (lagrange.zig:210-270)."""

    def __init__(self, F, xs, ys):
        if len(xs) != len(ys) or len(xs) == 0:
            raise ValueError("InvalidPoints")
        self.F = F
        self.xs = list(xs)
        self.ys = list(ys)
        self.weights = []
        for i in range(len(xs)):
            w = F.one()
            for j, xj in enumerate(xs):
                if j == i:
                    continue
                w = w.mul(xs[i].sub(xj))
            self.weights.append(w.inv())

    def eval(self, point):
        F = self.F
        # Exact hit on a node returns the stored value.
        for x, y in zip(self.xs, self.ys):
            if x.eql(point):
                return y
        num = F.zero()
        denom = F.zero()
        for x, y, w in zip(self.xs, self.ys, self.weights):
            term = w.div(point.sub(x))
            num = num.add(term.mul(y))
            denom = denom.add(term)
        return num.div(denom)
