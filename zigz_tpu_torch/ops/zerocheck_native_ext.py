"""Native host EXTENSION zerocheck: BabyBear^4 combiner DAGs in C++.

The v2+ zerochecks (proofs/zerocheck.py ZerocheckExtProver) draw every
challenge from BabyBear^4, so after the first fold every table is an Ext4
array and the numpy prover pays ~16 u64-divide multiplications per
extension product — the dominant v2 prover cost after the round-3 unified
commitment refactor.  This twin lowers the SAME combiner onto the base
6-opcode DAG (ops/symtrace.py SymExt: an extension value is 4 coordinate
nodes, ext x ext = schoolbook with X^4 = 11) and executes rounds through
runtime/dag.cpp zigz_dag_round_multi / zigz_dag_fold_ext.

Two DAGs are traced per zerocheck: the ROUND-1 DAG, where base columns
read only their #0 coordinate row (high coordinates structurally zero, so
base-only subexpressions keep base cost), and the rounds-2+ DAG, where
every column reads all 4 coordinate rows (tables are fully extension
after the first fold).  Storage is one (4*(C+1), n) canonical uint32
matrix: 4-row coordinate groups per column, plus the eq group.

Transcript bytes, round evaluations, challenges, and terminal column
evaluations are identical to the numpy ZerocheckExtProver
(tests/test_zerocheck_native.py ext suite); dispatch + fallback live in
proofs/zerocheck.py.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..core.ext4 import Ext4, challenge_ext, ext_from_ints
from .symtrace import TraceError, trace_combiner_ext
from .zerocheck_native import native_available

__all__ = ["NativeZerocheckExtProver", "native_available"]

P = 2013265921

_COL, _CONST, _ZERO, _ADD, _SUB, _MUL = range(6)


def _schedule_slots_multi(nodes, outs) -> Tuple[np.ndarray, int]:
    """schedule_slots with several protected outputs (the 4 coordinates)."""
    last_use = {}
    for i, (op, a, b) in enumerate(nodes):
        if op in (_ADD, _SUB, _MUL):
            last_use[a] = i
            last_use[b] = i
    for o in outs:
        last_use[o] = len(nodes)
    slots = np.empty(len(nodes), dtype=np.int32)
    free: List[int] = []
    next_slot = 0
    for i, (op, a, b) in enumerate(nodes):
        if free:
            slots[i] = free.pop()
        else:
            slots[i] = next_slot
            next_slot += 1
        if op in (_ADD, _SUB, _MUL):
            for operand in {a, b}:
                if last_use.get(operand) == i:
                    free.append(slots[operand])
    return slots, next_slot


def _dag_spec(tr, row_of: Dict[str, int]):
    nodes = tr.signature[0]
    outs = tr.signature[1]
    ops = np.array([op for op, _a, _b in nodes], dtype=np.int32)
    arga = np.array(
        [a if isinstance(a, int) else 0 for _op, a, _b in nodes], dtype=np.int32
    )
    argb = np.array(
        [b if isinstance(b, int) else 0 for _op, _a, b in nodes], dtype=np.int32
    )
    colrow = np.array(
        [row_of[a] if op == _COL else -1 for op, a, _b in nodes], dtype=np.int32
    )
    slots, num_slots = _schedule_slots_multi(nodes, outs)
    consts = np.asarray(tr.consts, dtype=np.uint64).astype(np.uint32)
    spec = (ops, arga, argb, slots, colrow, num_slots)
    out_slots = [int(slots[o]) for o in outs]
    return spec, out_slots, consts


class NativeZerocheckExtProver:
    """Drop-in C++ twin of proofs.zerocheck.ZerocheckExtProver.

    Construction traces the combiner twice (round-1 and rest DAGs);
    TraceError propagates BEFORE the transcript is touched so callers can
    fall back to the numpy prover."""

    def __init__(self, F, columns: Dict[str, np.ndarray], combiner, degree: int,
                 num_alphas: int = None):
        assert F.MODULUS == P, "native ext zerocheck is BabyBear-only"
        self.F = F
        self.combiner = combiner
        self.degree = degree
        self.num_alphas = num_alphas if num_alphas is not None else len(columns)
        self.columns = columns
        self.base_names = sorted(
            n for n, c in columns.items() if not isinstance(c, Ext4)
        )
        self.ext_names = sorted(n for n, c in columns.items() if isinstance(c, Ext4))
        widths = [
            (c.shape[-1] if isinstance(c, Ext4) else len(c))
            for c in columns.values()
        ]
        n = widths[0]
        assert all(w == n for w in widths), "zerocheck tables must be equal width"
        assert n & (n - 1) == 0 and n >= 2, "zerocheck tables must be power-of-two"
        self.n = n
        probe = [ext_from_ints([1, 0, 0, 0])] * self.num_alphas
        self._probe1 = trace_combiner_ext(
            combiner, self.base_names, self.ext_names, probe, P, lift_base=False
        )
        self._probe2 = trace_combiner_ext(
            combiner, self.base_names, self.ext_names, probe, P, lift_base=True
        )

    def prove(self, transcript):
        from ..proofs.zerocheck import (
            ZerocheckProof,
            _eq_table_ext,
            _interp_eval_ext,
            absorb_ext,
        )
        from ..runtime import native_dag_fold_ext, native_dag_round_multi

        p = P
        n = self.n
        num_vars = n.bit_length() - 1

        taus = [challenge_ext(transcript) for _ in range(num_vars)]
        alphas = [challenge_ext(transcript) for _ in range(self.num_alphas)]

        tr1 = trace_combiner_ext(
            self.combiner, self.base_names, self.ext_names, alphas, p,
            lift_base=False,
        )
        tr2 = trace_combiner_ext(
            self.combiner, self.base_names, self.ext_names, alphas, p,
            lift_base=True,
        )
        if (tr1.signature != self._probe1.signature
                or tr2.signature != self._probe2.signature):
            raise TraceError("combiner structure depends on challenge values")

        from ..runtime import native_dag_fold_hybrid

        names = self.base_names + self.ext_names
        B, E = len(self.base_names), len(self.ext_names)
        # Round-1 layout: one row per base column (high coordinates are
        # structurally zero — tr1 never reads them, and the hybrid fold
        # never touches them), 4-row groups for ext-input columns and eq.
        row_of1: Dict[str, int] = {}
        for i, name in enumerate(self.base_names):
            row_of1[f"{name}#0"] = i
        for j, name in enumerate(self.ext_names):
            for e in range(4):
                row_of1[f"{name}#{e}"] = B + 4 * j + e
        for e in range(4):
            row_of1[f"__eq__#{e}"] = B + 4 * E + e
        # Rounds-2+ layout: 4-row groups for every column, eq last.
        row_of2: Dict[str, int] = {}
        for i, name in enumerate(names):
            for e in range(4):
                row_of2[f"{name}#{e}"] = 4 * i + e
        for e in range(4):
            row_of2[f"__eq__#{e}"] = 4 * len(names) + e

        spec1, outs1, consts1 = _dag_spec(tr1, row_of1)
        spec2, outs2, consts2 = _dag_spec(tr2, row_of2)

        r1mat = np.zeros((B + 4 * E + 4, n), dtype=np.uint32)
        for i, name in enumerate(self.base_names):
            arr = np.asarray(self.columns[name], dtype=np.uint64)
            if int(arr.max(initial=0)) >= p:
                arr = arr % np.uint64(p)
            r1mat[i] = arr.astype(np.uint32)
        for j, name in enumerate(self.ext_names):
            r1mat[B + 4 * j : B + 4 * j + 4] = self.columns[name].c
        r1mat[B + 4 * E : B + 4 * E + 4] = _eq_table_ext(taus, p).c

        stacked2 = None
        round_evals: List[List[Ext4]] = []
        rs: List[Ext4] = []
        claim = Ext4.zeros()
        width = n
        for rnd in range(num_vars):
            if rnd == 0:
                vals = native_dag_round_multi(
                    r1mat, width, spec1, consts1, outs1, self.degree
                )
            else:
                vals = native_dag_round_multi(
                    stacked2, width, spec2, consts2, outs2, self.degree
                )
            if vals is None:  # runtime unavailable mid-proof: cannot happen
                raise TraceError("native DAG runtime unavailable")
            g0 = ext_from_ints(vals[0])
            evals_this_round = [g0, claim - g0]
            for t in range(2, self.degree + 1):
                evals_this_round.append(ext_from_ints(vals[t - 1]))
            round_evals.append(evals_this_round)

            for g in evals_this_round:
                absorb_ext(transcript, g)
            r = challenge_ext(transcript)
            rs.append(r)
            claim = _interp_eval_ext(evals_this_round, r, p)
            if rnd == 0:
                stacked2 = np.zeros(
                    (4 * (len(names) + 1), max(1, n // 2)), dtype=np.uint32
                )
                if not native_dag_fold_hybrid(
                    r1mat[:B], r1mat[B:], stacked2, width, r.to_ints()
                ):
                    # Mid-proof native failure: the transcript is already
                    # partially advanced, so a silent numpy fallback would
                    # emit corrupt bytes — fail loudly instead (advisor
                    # finding, round 3).
                    raise TraceError("native DAG fold unavailable mid-proof")
                r1mat = None  # free the full-width matrix
            else:
                if not native_dag_fold_ext(stacked2, width, r.to_ints()):
                    raise TraceError("native DAG fold unavailable mid-proof")
            width //= 2

        column_evals: Dict[str, Ext4] = {}
        for i, name in enumerate(names):
            if name.startswith("__"):
                continue
            column_evals[name] = ext_from_ints(
                [int(stacked2[4 * i + e, 0]) for e in range(4)]
            )
        for name in sorted(column_evals):
            absorb_ext(transcript, column_evals[name])
        return ZerocheckProof(
            num_vars=num_vars,
            degree=self.degree,
            round_evals=round_evals,
            final_point=rs,
            column_evals=column_evals,
        )
