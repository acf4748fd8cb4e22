"""Symbolic tracing of zerocheck combiners onto device field ops.

Every logUp/constraint argument in the package (constraints/bytecode.py,
regcheck.py, memcheck.py, lookups/validity.py, constraints/linkage.py)
expresses its constraint combination as a *combiner*: a pure function over a
dict of equally-shaped canonical uint64 numpy arrays, built exclusively from
mod-p ring operations (+, -, * and explicit ``% p`` reductions).  The host
ZerocheckProver sweeps these combiners ``degree+1`` times per round — the
dominant v2 prover cost at scale.

Instead of hand-porting each combiner to a device kernel (the approach of
the removed round-2 fixed v2 device combiner), this module runs the
combiner ONCE with symbolic operands and records the expression DAG, then
lowers the DAG to canonical int64 torch ops (ops/babybear).  The same
Python definition therefore serves as both the host reference and the
device sweep — bit-equality is structural, not re-implemented.

Two properties make this sound:

* Combiners only need congruence mod p: the zerocheck prover reduces every
  emitted value, so evaluating the DAG with any schedule of exact mod-p
  reductions yields the same canonical integers as numpy's exact-uint64
  delayed-reduction schedule.
* Combiner *control flow* never depends on challenge values (loops run over
  static gadget structure), so re-tracing with fresh Fiat-Shamir challenges
  yields the same DAG structure with different constants.  Every constant
  occurrence is therefore interned as a PARAMETER slot — the program's
  structure is the same across proofs, only the (K,) constant vector changes.
  (For the same reason no value-based simplification is performed: a
  challenge that happens to equal 0 or 1 must not change the program.)

The only non-ring numpy API combiners use is ``np.zeros_like`` (accumulator
seeds); it is intercepted via __array_function__ as a structural zero.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

__all__ = ["TraceError", "trace_combiner", "compile_dag", "CombinerTrace"]

P = 2013265921  # BabyBear

# Node opcodes.
_COL, _CONST, _ZERO, _ADD, _SUB, _MUL = range(6)


class TraceError(Exception):
    """The combiner used an operation outside the traced ring algebra."""


class _Trace:
    __slots__ = ("nodes", "cse", "col_names", "consts", "_zero_id")

    def __init__(self):
        self.nodes: List[tuple] = []
        self.cse: Dict[tuple, int] = {}
        self.col_names: List[str] = []
        self.consts: List[int] = []
        self._zero_id = None  # structural-zero singleton (SymExt lowering)

    def node(self, op: int, a, b=None) -> int:
        key = (op, a, b)
        if op in (_ADD, _SUB, _MUL):
            # Structural CSE (value-independent: operands are node ids).
            hit = self.cse.get(key)
            if hit is not None:
                return hit
        self.nodes.append(key)
        nid = len(self.nodes) - 1
        if op in (_ADD, _SUB, _MUL):
            self.cse[key] = nid
        return nid

    def col(self, name: str) -> int:
        if name not in self.col_names:
            self.col_names.append(name)
            return self.node(_COL, name)
        # One COL node per name: reuse via CSE-like lookup.
        for i, (op, a, _b) in enumerate(self.nodes):
            if op == _COL and a == name:
                return i
        raise AssertionError("unreachable")

    def const(self, value) -> int:
        """Fresh parameter slot per constant OCCURRENCE (no value dedup —
        structure must not depend on challenge values)."""
        self.consts.append(int(value) % P)
        return self.node(_CONST, len(self.consts) - 1)


_INT_TYPES = (int, np.integer)


class SymExpr:
    """Operand wrapper recording ring operations into a _Trace."""

    __slots__ = ("t", "i")
    # Win the numpy binary-op dispatch so np.uint64(c) * sym routes here.
    __array_priority__ = 1000

    def __init__(self, t: _Trace, i: int):
        self.t = t
        self.i = i

    # -- helpers -----------------------------------------------------------
    def _coerce(self, other) -> int:
        if isinstance(other, SymExpr):
            if other.t is not self.t:
                raise TraceError("mixed traces")
            return other.i
        if isinstance(other, _INT_TYPES):
            return self.t.const(other)
        raise TraceError(f"unsupported operand type {type(other)!r}")

    def _bin(self, op: int, other, reflected: bool = False):
        # Extension operands promote the whole expression to SymExt
        # (BabyBear^4 lowering — see the SymExt section below).
        if isinstance(other, SymExt):
            return NotImplemented  # SymExt's reflected op handles it
        from ..core.ext4 import Ext4

        if isinstance(other, Ext4):
            t = self.t
            z = _trace_zero(t)
            lifted = SymExt(t, (self.i, z, z, z))
            return lifted._bin_ext(op, other, reflected=reflected)
        j = self._coerce(other)
        a, b = (j, self.i) if reflected else (self.i, j)
        return SymExpr(self.t, self.t.node(op, a, b))

    # -- ring operators ------------------------------------------------------
    def __add__(self, other):
        return self._bin(_ADD, other)

    def __radd__(self, other):
        return self._bin(_ADD, other, reflected=True)

    def __sub__(self, other):
        return self._bin(_SUB, other)

    def __rsub__(self, other):
        return self._bin(_SUB, other, reflected=True)

    def __mul__(self, other):
        return self._bin(_MUL, other)

    def __rmul__(self, other):
        return self._bin(_MUL, other, reflected=True)

    def __mod__(self, modulus):
        if int(modulus) != P:
            raise TraceError(f"reduction by {modulus} != BabyBear p")
        return self  # every traced op already reduces mod p

    def __neg__(self):
        return SymExpr(self.t, self.t.node(_SUB, self.t.const(0), self.i))

    def copy(self):
        return self

    # -- numpy protocol ------------------------------------------------------
    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        if method != "__call__" or kwargs.get("out") is not None:
            raise TraceError(f"unsupported ufunc usage {ufunc.__name__}.{method}")
        if ufunc is np.add:
            a, b = inputs
            return a + b if isinstance(a, SymExpr) else self.__radd__(a)
        if ufunc is np.subtract:
            a, b = inputs
            return a - b if isinstance(a, SymExpr) else self.__rsub__(a)
        if ufunc is np.multiply:
            a, b = inputs
            return a * b if isinstance(a, SymExpr) else self.__rmul__(a)
        if ufunc in (np.remainder, np.mod):
            a, b = inputs
            if isinstance(b, SymExpr):
                raise TraceError("symbolic modulus")
            return a.__mod__(b)
        if ufunc is np.positive:
            return inputs[0]
        if ufunc is np.negative:
            return -inputs[0]
        raise TraceError(f"unsupported ufunc {ufunc.__name__}")

    def __array_function__(self, func, types, args, kwargs):
        if func is np.zeros_like:
            return SymExpr(self.t, self.t.node(_ZERO, None))
        if func is np.ones_like:
            return SymExpr(self.t, self.t.const(1))
        if func is np.full_like:
            fill = args[1]
            if isinstance(fill, SymExpr):
                raise TraceError("np.full_like with a symbolic fill value")
            return SymExpr(self.t, self.t.const(fill))
        raise TraceError(f"unsupported numpy function {func.__name__}")

    # Anything value-dependent must fail loudly.
    def __bool__(self):
        raise TraceError("combiner control flow depends on a symbolic value")

    def __int__(self):
        raise TraceError("symbolic value cannot be converted to int")

    def __index__(self):
        raise TraceError("symbolic value cannot be used as an index")


class _TraceDict(dict):
    """cols mapping handed to the combiner: materializes a COL per name."""

    def __init__(self, trace: _Trace, names):
        super().__init__()
        self._trace = trace
        for name in names:
            super().__setitem__(name, SymExpr(trace, trace.col(name)))


class CombinerTrace:
    """Result of tracing: structural signature + per-proof constant vector."""

    __slots__ = ("nodes", "out", "col_names", "consts", "signature")

    def __init__(self, nodes, out, col_names, consts):
        self.nodes = nodes
        self.out = out
        self.col_names = col_names
        self.consts = consts  # canonical ints, proof-specific
        self.signature = (tuple(nodes), out, tuple(col_names))


def trace_combiner(combiner, column_names, alphas: List[int], p: int) -> CombinerTrace:
    """Run ``combiner(cols, alphas, p)`` symbolically.

    ``column_names`` is the full set of available columns; only those the
    combiner actually reads appear in the trace (the zerocheck still folds
    unread columns for its terminal evaluations).  ``alphas`` are passed
    through as plain ints — their uses are captured as constant slots like
    every other challenge-derived value.
    """
    if p != P:
        raise TraceError("symbolic tracing is BabyBear-only")
    t = _Trace()
    cols = _TraceDict(t, column_names)
    out = combiner(cols, list(alphas), p)
    if not isinstance(out, SymExpr):
        raise TraceError(f"combiner returned {type(out)!r}, not a traced value")
    return CombinerTrace(t.nodes, out.i, t.col_names, t.consts)


# ---------------------------------------------------------------------------
# Device lowering
# ---------------------------------------------------------------------------

# |value| bound under which int64 sums and differences are left unreduced.
_LAZY_CAP = 1 << 62
_MUL_CAP = 1 << 63


def compile_dag(nodes, outs, row_of: Dict[str, int], consts):
    """Lower a traced DAG to torch ops: -> ``run(planes)`` with ``planes`` a
    (C, n) canonical int64 tensor, returning one (n,) canonical int64
    tensor per entry of ``outs``.

    ``consts`` are this proof's constants as canonical Python ints; they
    enter the ops as immediate scalars, so nothing is uploaded for them and
    a constant-only subexpression is folded on the host.

    The JAX package traces the same loop under ``jit`` and lets XLA fuse
    the DAG and free the intermediates.  Eager torch runs one launch per
    op and keeps every tensor that is still referenced, so the plan built
    here does two things about that:

    * *Lazy reduction.*  Each node carries a static interval that bounds
      its values.  A sum or difference stays unreduced while its bound
      fits int64 comfortably; a product reduces an operand first only when
      the raw product could pass 2^63, and is itself reduced once.  A
      value is reduced at most once, so the plan never costs more launches
      than reducing after every op, and an add/sub chain costs half.
      ``%`` on a tensor takes the divisor's sign, so negative
      intermediates map back into [0, p).
    * *Freeing.*  One pass gives every node's last use; ``run`` drops a
      value right after it, so the peak is the DAG's widest live set, not
      its node count.
    """
    n_nodes = len(nodes)
    binary = (_ADD, _SUB, _MUL)
    live = [False] * n_nodes
    for o in outs:
        live[o] = True
    for i in range(n_nodes - 1, -1, -1):
        op, a, b = nodes[i]
        if live[i] and op in binary:
            live[a] = live[b] = True
    last_use = [-1] * n_nodes
    for i, (op, a, b) in enumerate(nodes):
        if live[i] and op in binary:
            last_use[a] = i
            last_use[b] = i
    for o in outs:
        last_use[o] = n_nodes  # outputs survive the whole pass

    # Static plan: (kind, i, a, b) steps; bounds[i] = (lo, hi) of node i;
    # const_val[i] is the host value of a constant-only node.
    bounds: List[Tuple[int, int]] = [None] * n_nodes
    const_val: List[object] = [None] * n_nodes
    steps: List[tuple] = []

    def mag(i: int) -> int:
        lo, hi = bounds[i]
        return max(abs(lo), abs(hi))

    def reduce_node(i: int) -> None:
        if bounds[i] != (0, P - 1):
            steps.append(("red", i, None, None))
            bounds[i] = (0, P - 1)

    for i, (op, a, b) in enumerate(nodes):
        if not live[i]:
            continue
        if op == _COL:
            steps.append(("col", i, row_of[a], None))
            bounds[i] = (0, P - 1)
        elif op == _CONST:
            const_val[i] = int(consts[a]) % P
            bounds[i] = (const_val[i], const_val[i])
        elif op == _ZERO:
            const_val[i] = 0
            bounds[i] = (0, 0)
        elif const_val[a] is not None and const_val[b] is not None:
            x, y = const_val[a], const_val[b]
            v = (x + y if op == _ADD else x - y if op == _SUB else x * y) % P
            const_val[i] = v
            bounds[i] = (v, v)
        elif op in (_ADD, _SUB):
            for x in (a, b):
                if mag(x) >= _LAZY_CAP // 2 and const_val[x] is None:
                    reduce_node(x)
            (la, ha), (lb, hb) = bounds[a], bounds[b]
            bounds[i] = (la + lb, ha + hb) if op == _ADD else (la - hb, ha - lb)
            steps.append(("add" if op == _ADD else "sub", i, a, b))
        else:  # _MUL
            for x in sorted((a, b), key=mag, reverse=True):
                if mag(a) * mag(b) >= _MUL_CAP and const_val[x] is None:
                    reduce_node(x)
            steps.append(("mul", i, a, b))  # the product is reduced in the step
            bounds[i] = (0, P - 1)
        for x in ({a, b} if op in binary else ()):
            if last_use[x] == i and const_val[x] is None:
                steps.append(("free", x, None, None))
    for o in set(outs):
        if const_val[o] is None:
            reduce_node(o)

    def run(planes):
        vals: List[object] = list(const_val)
        for kind, i, a, b in steps:
            if kind == "col":
                vals[i] = planes[a]
            elif kind == "mul":
                vals[i] = (vals[a] * vals[b]).remainder_(P)
            elif kind == "add":
                vals[i] = vals[a] + vals[b]
            elif kind == "sub":
                vals[i] = vals[a] - vals[b]
            elif kind == "red":
                vals[i] = vals[i] % P
            else:  # free
                vals[i] = None
        n = planes.shape[-1]
        return [
            vals[o] if const_val[o] is None
            else torch.full((n,), const_val[o], dtype=torch.int64, device=planes.device)
            for o in outs
        ]

    run.num_ops = sum(1 for s in steps if s[0] in ("mul", "add", "sub", "red"))
    run.num_launches = run.num_ops + sum(1 for s in steps if s[0] == "mul")
    return run


# ---------------------------------------------------------------------------
# Extension-field (BabyBear^4) lowering — round-3 native Ext4 zerocheck
# ---------------------------------------------------------------------------
#
# The v2+ zerochecks draw every challenge from BabyBear^4 (core/ext4.py), so
# their combiners mix base columns with Ext4 scalars and ext-recombined
# advice columns.  SymExt lowers that algebra onto the SAME 6-opcode base
# DAG: an extension value is 4 coordinate nodes; ext x ext multiplication is
# the schoolbook product with X^4 = 11 (16 base muls); an Ext4 constant is 4
# positional const slots (never value-inspected, so the structural signature
# stays challenge-independent).  Structural-zero folding (the _zero_id
# singleton) keeps base-only subexpressions at base cost in the round-1 DAG,
# where most columns still have zero high coordinates.

_W_EXT = 11  # X^4 = 11 (core/ext4.py W)


def _trace_zero(t: _Trace) -> int:
    zid = getattr(t, "_zero_id", None)
    if zid is None:
        zid = t.node(_ZERO, None)
        t._zero_id = zid
    return zid


def _fadd(t: _Trace, a: int, b: int) -> int:
    z = getattr(t, "_zero_id", None)
    if a == z:
        return b
    if b == z:
        return a
    return t.node(_ADD, a, b)


def _fsub(t: _Trace, a: int, b: int) -> int:
    z = getattr(t, "_zero_id", None)
    if b == z:
        return a
    return t.node(_SUB, a, b)


def _fmul(t: _Trace, a: int, b: int) -> int:
    z = getattr(t, "_zero_id", None)
    if a == z or b == z:
        return _trace_zero(t)
    return t.node(_MUL, a, b)


class SymExt:
    """An extension element as 4 coordinate SymExpr node ids."""

    __slots__ = ("t", "c")
    __array_priority__ = 1000

    def __init__(self, t: _Trace, coords):
        assert len(coords) == 4
        self.t = t
        self.c = tuple(coords)

    # -- coercion ------------------------------------------------------------
    def _ext_coords(self, other):
        """-> 4 coordinate node ids, or None if not coercible."""
        t = self.t
        if isinstance(other, SymExt):
            if other.t is not t:
                raise TraceError("mixed traces")
            return other.c
        if isinstance(other, SymExpr):
            if other.t is not t:
                raise TraceError("mixed traces")
            z = _trace_zero(t)
            return (other.i, z, z, z)
        if isinstance(other, _INT_TYPES) or isinstance(other, (bool, np.bool_)):
            z = _trace_zero(t)
            return (t.const(int(other)), z, z, z)
        # Scalar Ext4 (challenges closed over by the combiner).
        from ..core.ext4 import Ext4

        if isinstance(other, Ext4) and other.is_scalar:
            return tuple(t.const(int(v)) for v in other.c)
        return None

    def _bin_ext(self, op, other, reflected=False):
        oc = self._ext_coords(other)
        if oc is None:
            return NotImplemented
        t = self.t
        a, b = (oc, self.c) if reflected else (self.c, oc)
        if op == _ADD:
            return SymExt(t, [_fadd(t, a[e], b[e]) for e in range(4)])
        if op == _SUB:
            return SymExt(t, [_fsub(t, a[e], b[e]) for e in range(4)])
        # MUL: schoolbook with X^4 = W (matches core/ext4.py _ext_mul mod p).
        m = [[_fmul(t, a[i], b[j]) for j in range(4)] for i in range(4)]
        z = getattr(t, "_zero_id", None)

        def wmul(n):
            if n == z:
                return n
            return t.node(_MUL, t.const(_W_EXT), n)

        c0 = _fadd(t, m[0][0], wmul(_fadd(t, _fadd(t, m[1][3], m[2][2]), m[3][1])))
        c1 = _fadd(t, _fadd(t, m[0][1], m[1][0]), wmul(_fadd(t, m[2][3], m[3][2])))
        c2 = _fadd(t, _fadd(t, m[0][2], m[1][1]), _fadd(t, m[2][0], wmul(m[3][3])))
        c3 = _fadd(t, _fadd(t, m[0][3], m[1][2]), _fadd(t, m[2][1], m[3][0]))
        return SymExt(t, [c0, c1, c2, c3])

    # -- operators -------------------------------------------------------------
    def __add__(self, other):
        return self._bin_ext(_ADD, other)

    def __radd__(self, other):
        return self._bin_ext(_ADD, other, reflected=True)

    def __sub__(self, other):
        return self._bin_ext(_SUB, other)

    def __rsub__(self, other):
        return self._bin_ext(_SUB, other, reflected=True)

    def __mul__(self, other):
        return self._bin_ext(_MUL, other)

    __rmul__ = __mul__

    def __neg__(self):
        t = self.t
        z = _trace_zero(t)
        return SymExt(t, [_fsub(t, z, c) if c != z else z for c in self.c])

    def __mod__(self, modulus):
        if int(modulus) != P:
            raise TraceError(f"reduction by {modulus} != BabyBear p")
        return self

    def copy(self):
        return self

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        if method != "__call__" or kwargs.get("out") is not None:
            raise TraceError(f"unsupported ufunc usage {ufunc.__name__}.{method}")
        if ufunc is np.add:
            a, b = inputs
            return a + b if isinstance(a, SymExt) else self.__radd__(a)
        if ufunc is np.subtract:
            a, b = inputs
            return a - b if isinstance(a, SymExt) else self.__rsub__(a)
        if ufunc is np.multiply:
            a, b = inputs
            return a * b if isinstance(a, SymExt) else self.__rmul__(a)
        if ufunc in (np.remainder, np.mod):
            a, b = inputs
            if isinstance(b, (SymExt, SymExpr)):
                raise TraceError("symbolic modulus")
            return a.__mod__(b)
        if ufunc is np.positive:
            return inputs[0]
        if ufunc is np.negative:
            return -inputs[0]
        raise TraceError(f"unsupported ufunc {ufunc.__name__}")

    def __array_function__(self, func, types, args, kwargs):
        if func is np.zeros_like:
            z = _trace_zero(self.t)
            return SymExt(self.t, (z, z, z, z))
        raise TraceError(f"unsupported numpy function {func.__name__}")

    def __bool__(self):
        raise TraceError("combiner control flow depends on a symbolic value")


def symext_from_coords(coords) -> SymExt:
    """ext_from_coords for symbolic coordinate values: base coordinate
    columns (SymExpr) stack directly into a SymExt (the tracing twin of
    core/ext4.py ext_from_coords' array-stacking path)."""
    t = None
    for c in coords:
        if isinstance(c, (SymExpr, SymExt)):
            t = c.t
            break
    if t is None:
        raise TraceError("symext_from_coords without symbolic coords")
    if any(isinstance(c, SymExt) for c in coords):
        # Ext-valued coordinates (columns already folded by extension
        # challenges): recombine as sum_e coord_e * X^e, where
        # multiplication by X rotates coordinates with a W-scaled wrap.
        def as_ext(c) -> SymExt:
            if isinstance(c, SymExt):
                return c
            z = _trace_zero(t)
            if isinstance(c, SymExpr):
                return SymExt(t, (c.i, z, z, z))
            if isinstance(c, _INT_TYPES) or isinstance(c, (bool, np.bool_)):
                return SymExt(t, (t.const(int(c)), z, z, z))
            raise TraceError(f"unsupported ext coordinate {type(c)!r}")

        def mul_x(cc):
            z = getattr(t, "_zero_id", None)
            w = cc[3] if cc[3] == z else t.node(_MUL, t.const(_W_EXT), cc[3])
            return (w, cc[0], cc[1], cc[2])

        acc = None
        for e, part in enumerate(coords):
            cc = as_ext(part).c
            for _ in range(e):
                cc = mul_x(cc)
            acc = cc if acc is None else tuple(
                _fadd(t, acc[k], cc[k]) for k in range(4)
            )
        return SymExt(t, acc)
    out = []
    for c in coords:
        if isinstance(c, SymExpr):
            if c.t is not t:
                raise TraceError("mixed traces")
            out.append(c.i)
        elif isinstance(c, _INT_TYPES) or isinstance(c, (bool, np.bool_)):
            out.append(t.const(int(c)))
        else:
            raise TraceError(f"unsupported ext coordinate {type(c)!r}")
    return SymExt(t, out)


# Register the tracing hook with core/ext4.py (late-bound so core never
# imports ops).
from ..core import ext4 as _ext4_mod  # noqa: E402

_ext4_mod._SYMEXT_HOOK = symext_from_coords


class CombinerTraceExt:
    """Result of ext tracing: 4 output node ids + shared structure."""

    __slots__ = ("nodes", "outs", "col_names", "consts", "signature")

    def __init__(self, nodes, outs, col_names, consts):
        self.nodes = nodes
        self.outs = tuple(outs)
        self.col_names = col_names
        self.consts = consts
        self.signature = (tuple(nodes), self.outs, tuple(col_names))


def trace_combiner_ext(combiner, base_names, ext_names, alphas, p: int,
                       lift_base: bool) -> CombinerTraceExt:
    """Trace ``eq * combiner(cols, alphas, p)`` with BabyBear^4 semantics.

    ``base_names`` columns appear as plain base SymExpr reading COL
    "name#0" when ``lift_base`` is False (the round-1 DAG: high
    coordinates are structurally zero), or as full 4-coordinate SymExt
    when True (the rounds-2+ DAG, after the first extension fold).
    ``ext_names`` columns are always 4-coordinate SymExt.  ``alphas`` are
    Ext4 scalars (interned as positional const slots on use).  The eq
    table is the SymExt column "__eq__"; the returned DAG has 4 outputs:
    the coordinates of eq * C."""
    if p != P:
        raise TraceError("symbolic tracing is BabyBear-only")
    t = _Trace()
    cols = {}
    for name in base_names:
        if lift_base:
            cols[name] = SymExt(t, [t.col(f"{name}#{e}") for e in range(4)])
        else:
            z = _trace_zero(t)
            cols[name] = SymExpr(t, t.col(f"{name}#0"))
    for name in ext_names:
        cols[name] = SymExt(t, [t.col(f"{name}#{e}") for e in range(4)])
    eq = SymExt(t, [t.col(f"__eq__#{e}") for e in range(4)])
    out = combiner(cols, list(alphas), p)
    if isinstance(out, SymExpr):
        z = _trace_zero(t)
        out = SymExt(t, (out.i, z, z, z))
    if not isinstance(out, SymExt):
        raise TraceError(f"combiner returned {type(out)!r}, not a traced value")
    prod = eq * out
    return CombinerTraceExt(t.nodes, prod.c, t.col_names, t.consts)
