"""Native host zerocheck: traced combiner DAGs executed in threaded C++.

The host ZerocheckProver (proofs/zerocheck.py) evaluates its combiner as
dozens of full-width single-threaded numpy temporaries; this twin traces
the combiner once (ops/symtrace.py) and runs each round's sweeps through
runtime/dag.cpp — chunk-resident intermediates across all cores.  It is
the default host path for every logUp/constraint zerocheck when the
native toolchain is available (dispatch in proofs/zerocheck.py
make_zerocheck_prover); the numpy prover remains the reference twin and
the fallback.

Round evaluations, challenges, terminal column evals, and transcript
bytes are identical to the numpy prover's (tests/test_zerocheck_native.py):
both produce the same canonical residues, and the schedule (g(1) derived
from the running claim, "__"-prefixed columns unreported) is mirrored
statement for statement.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..core.hash import FiatShamirTranscript
from .symtrace import TraceError, trace_combiner

__all__ = ["NativeZerocheckProver", "native_available", "schedule_slots"]

P = 2013265921

_COL, _CONST, _ZERO, _ADD, _SUB, _MUL = range(6)


def native_available() -> bool:
    try:
        from ..runtime import native_dag_available

        return native_dag_available()
    except Exception:
        return False


def schedule_slots(nodes, out: int) -> Tuple[np.ndarray, int]:
    """Linear-scan slot assignment for the DAG's chunk buffers: each node
    writes one slot; operand slots are recycled after their last use.
    Returns (slot array, num_slots)."""
    last_use = {}
    for i, (op, a, b) in enumerate(nodes):
        if op in (_ADD, _SUB, _MUL):
            last_use[a] = i
            last_use[b] = i
    last_use[out] = len(nodes)  # the output must survive the whole pass
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


class NativeZerocheckProver:
    """Drop-in C++ twin of proofs.zerocheck.ZerocheckProver.

    Construction traces the combiner; TraceError propagates BEFORE the
    transcript is touched so callers can fall back."""

    def __init__(self, F, columns: Dict[str, np.ndarray], combiner, degree: int,
                 num_alphas: int = None):
        assert F.MODULUS == P, "native zerocheck is BabyBear-only"
        self.F = F
        self.combiner = combiner
        self.degree = degree
        self.num_alphas = num_alphas if num_alphas is not None else len(columns)
        self.names = sorted(columns)
        self.columns = columns
        n = columns[self.names[0]].shape[-1]
        assert n & (n - 1) == 0, "zerocheck tables must be power-of-two"
        self.n = n
        self._probe = trace_combiner(combiner, self.names, [1] * self.num_alphas, P)

    def prove(self, transcript: FiatShamirTranscript):
        from ..proofs.zerocheck import ZerocheckProof, _eq_table, _interp_eval
        from ..runtime import native_dag_fold, native_dag_round

        p = P
        n = self.n
        num_vars = n.bit_length() - 1

        taus = [transcript.challenge_value(p) for _ in range(num_vars)]
        alphas = [transcript.challenge_value(p) for _ in range(self.num_alphas)]

        tr = trace_combiner(self.combiner, self.names, alphas, p)
        if tr.signature != self._probe.signature:
            raise TraceError("combiner structure depends on challenge values")
        nodes = tr.signature[0]
        out_node = tr.signature[1]
        row_of = {name: i for i, name in enumerate(self.names)}
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
        slots, num_slots = schedule_slots(nodes, out_node)
        consts = np.asarray(tr.consts, dtype=np.uint64).astype(np.uint32)
        spec = (ops, arga, argb, slots, colrow, num_slots)
        out_slot = int(slots[out_node])

        # One contiguous (C+1, n) canonical uint32 matrix; last row = eq.
        # dag.cpp folds it in place with a fixed stride.
        nrows = len(self.names) + 1
        stacked = np.empty((nrows, n), dtype=np.uint32)
        for i, name in enumerate(self.names):
            arr = np.asarray(self.columns[name], dtype=np.uint64)
            # Columns are canonical in every call site; the division pass
            # (numpy % by a runtime modulus) costs more than this check.
            if int(arr.max(initial=0)) >= p:
                arr = arr % np.uint64(p)
            stacked[i] = arr
        eq_row = nrows - 1
        stacked[eq_row] = _eq_table(taus, p)

        round_evals: List[List[int]] = []
        rs: List[int] = []
        claim = 0
        width = n
        for _ in range(num_vars):
            dev = native_dag_round(
                stacked, width, spec, consts, out_slot, eq_row, self.degree
            )
            if dev is None:
                raise RuntimeError("native DAG runtime vanished mid-proof")
            g0 = dev[0]
            evals_this_round = [g0, (claim - g0) % p] + dev[1:]
            round_evals.append(evals_this_round)
            for g in evals_this_round:
                transcript.append_u64(g)
            r = transcript.challenge_value(p)
            rs.append(r)
            claim = _interp_eval(evals_this_round, r, p)
            native_dag_fold(stacked, width, r)
            width //= 2

        column_evals = {
            name: int(stacked[i, 0]) for i, name in enumerate(self.names)
            if not name.startswith("__")
        }
        for name in sorted(column_evals):
            transcript.append_u64(column_evals[name])

        return ZerocheckProof(
            num_vars=num_vars,
            degree=self.degree,
            round_evals=round_evals,
            final_point=rs,
            column_evals=column_evals,
        )
