"""v2 constraint set: real polynomial constraints for the zerocheck.

The v1 pipeline's constraint sumcheck is a structural placeholder
(reference prover.zig:267-288); v2 implements the "complete
implementation" the reference's comments describe, scoped to constraints
expressible over the committed columns plus two auxiliary columns:

    c1: x0(x)                                  = 0   (x0 hardwired zero)
    c2: is_read(x) * (1 - is_read(x))          = 0   (booleanity)
    c3: seq(x) * (1 - seq(x))                  = 0   (booleanity)
    c4: seq(x) * (next_pc(x) - pc(x) - 4)      = 0   (sequential PC step)
    c5: g1(x) * fp1(x) - sel1(x)               = 0   (logUp inverse, LHS)
    c6: g2(x) * fp2(x) - sel2(x)               = 0   (logUp inverse, RHS)

``seq`` marks steps whose instruction always advances pc by 4 (everything
except BRANCH/JAL/JALR/SYSTEM); ``next_pc`` is the recorded next program
counter.  Both are committed columns of the v2 Ligero PCS (padding:
next_pc repeats the last value like pc, seq pads with 0 so c3/c4 hold on
padding).

c5/c6 are the PC-CHAIN SHIFT ARGUMENT (the reference leaves pc chaining
entirely unconstrained): with

    fp1(x) = tau - beta*(idx(x)+1) - next_pc(x)
    fp2(y) = tau - beta*idx(y)     - pc(y)
    sel1   = 1[idx <= n-2],   sel2 = 1[1 <= idx <= n-1]      (n = num_steps)

the zerocheck forces g1 = sel1/fp1 and g2 = sel2/fp2 pointwise, and the
Ligero sum queries force sum(g1) == sum(g2); by the logUp identity this
means the multisets {(x+1, next_pc(x)) : x <= n-2} and {(y, pc(y)) :
1 <= y <= n-1} coincide w.h.p. over (tau, beta).  Since the index keys are
injective, this is exactly pc(x+1) = next_pc(x) for every consecutive pair
— branches and jumps included.  idx/sel are PUBLIC MLEs of the public step
count (poly/public_mles.py): the verifier evaluates them itself; only g1
and g2 are committed (their own Ligero commitment, made after tau/beta).

SOUNDNESS (round-3 hardening): tau and beta are BabyBear^4 extension
challenges (core/ext4.py), so a forged PC chain collides with probability
~2n/p^4 ~ 2^-100 instead of the grindable ~2^-10 of a base-field draw.
g1/g2 are therefore extension-valued, committed as 4 base coordinate
columns each (g1#0..g1#3, g2#0..g2#3) and recombined inside the combiner.
The zerocheck itself runs with extension taus/alphas/round challenges
(proofs/zerocheck.py ZerocheckExt*).

C(x) = sum a_j c_j has degree 2; with the eq factor the zerocheck rounds
have degree <= 3 (4 evaluations per round).

The combiner below is written against the generic mod-p idioms, so ONE
function serves the vectorized prover (base/Ext4 numpy columns) and the
scalar verifier (Ext4 terminal evaluations) — the public idx/sel values
arrive via the "__"-prefixed entries (dense tables at prove time,
closed-form MLE evaluations at the extension point at verify time).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..core.ext4 import Ext4, ext_from_coords
from ..isa.rv64i import Opcode
from ..poly.public_mles import (
    eq_zero_eval,
    idx_eval,
    idx_table,
    le_indicator_eval,
    le_table,
)

__all__ = [
    "NUM_V2_CONSTRAINTS",
    "NUM_V2_ALPHAS",
    "V2_DEGREE",
    "V2_G_COLUMNS",
    "build_aux_columns",
    "build_logup_columns",
    "logup_public_tables",
    "make_v2_combiner",
    "v2_public_evals",
    "v2_columns",
]

NUM_V2_CONSTRAINTS = 4  # base execution constraints (c1-c4)
NUM_V2_ALPHAS = 6  # c1-c4 + the two logUp inverse constraints
V2_DEGREE = 3  # deg(eq * C) per variable
V2_G_COLUMNS = tuple(f"g{i}#{e}" for i in (1, 2) for e in range(4))

_NONSEQ_OPCODES = (Opcode.BRANCH, Opcode.JAL, Opcode.JALR, Opcode.SYSTEM)


def build_aux_columns(trace, num_vars: int, p: int) -> Dict[str, np.ndarray]:
    """(seq, next_pc) canonical uint64 columns over the padded domain."""
    n = trace.step_count()
    padded = 1 << num_vars
    native_cols = getattr(trace, "columns", None)

    if native_cols is not None:
        opcodes = native_cols["opcode"]
        next_pcs = native_cols["next_pc"]
    else:
        opcodes = np.fromiter((i.opcode for i in trace.instructions), dtype=np.uint64, count=n)
        next_pcs = np.fromiter(trace.next_pcs, dtype=np.uint64, count=n)

    seq = np.ones(padded, dtype=np.uint64)
    nonseq = np.isin(opcodes, np.array(_NONSEQ_OPCODES, dtype=opcodes.dtype))
    seq[:n] = (~nonseq).astype(np.uint64)
    seq[n:] = 0  # padding: c3, c4 hold trivially

    next_pc = np.zeros(padded, dtype=np.uint64)
    next_pc[:n] = next_pcs % np.uint64(p)
    next_pc[n:] = next_pc[n - 1] if n > 0 else 0  # pad-with-last, like pc

    return {"seq": seq, "next_pc": next_pc}


def v2_columns(witness, aux: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The named columns the zerocheck runs over.

    When the trace is native-columnar the three witness columns are built
    directly from it (x0 is identically zero, is_read from mem_flag, pc
    with the pad-last rule) — identical to witness.matrix rows 1/42/0 but
    without materializing the full 43-row host matrix."""
    trace = getattr(witness, "_trace", None)
    cols = getattr(trace, "columns", None) if trace is not None else None
    if cols is not None:
        p = np.uint64(witness.F.MODULUS) if hasattr(witness, "F") else None
    if cols is not None and p is not None:
        n = trace.step_count()
        padded = 1 << witness.num_vars
        pc = np.zeros(padded, dtype=np.uint64)
        pc[:n] = cols["pc"] % p
        if padded > n and n > 0:
            pc[n:] = pc[n - 1]
        is_read = np.zeros(padded, dtype=np.uint64)
        is_read[:n] = (cols["mem_flag"] == 1).astype(np.uint64)
        return {
            "x0": np.zeros(padded, dtype=np.uint64),
            "is_read": is_read,
            "pc": pc,
            "seq": aux["seq"],
            "next_pc": aux["next_pc"],
        }
    return {
        "x0": witness.matrix[1],
        "is_read": witness.matrix[42],
        "pc": witness.matrix[0],
        "seq": aux["seq"],
        "next_pc": aux["next_pc"],
    }


# ---------------------------------------------------------------------------
# PC-chain logUp (the shift argument)


def logup_public_tables(num_steps: int, num_vars: int, p: int) -> Dict[str, np.ndarray]:
    """Prover-side dense twins of the verifier-computable MLEs.

    Names carry the ``__`` prefix: the zerocheck folds them like any other
    table but never emits terminal evaluations for them (the verifier
    computes idx(r)/sel(r) itself — prover values are never trusted)."""
    sel2 = le_table(num_steps - 1, num_vars)
    if num_steps >= 1:
        sel2[0] = 0  # sel2 = 1[1 <= idx <= n-1]
    return {
        "__idx__": idx_table(num_vars, p),
        "__sel1__": le_table(num_steps - 2, num_vars),
        "__sel2__": sel2,
    }


def build_logup_columns(pc: np.ndarray, next_pc: np.ndarray, num_steps: int,
                        num_vars: int, tau: Ext4, beta: Ext4, p: int):
    """(g1, g2, shared_sum) extension inverse columns, or None on a zero
    active denominator (caller retries with the next transcript nonce;
    probability ~2n/p^4 per attempt — effectively never for honest runs)."""
    pub = logup_public_tables(num_steps, num_vars, p)
    idx = pub["__idx__"]
    sel1 = pub["__sel1__"]
    sel2 = pub["__sel2__"]

    fp1 = tau - beta * ((idx + np.uint64(1)) % np.uint64(p)) - next_pc
    fp2 = tau - beta * idx - pc
    if np.any(fp1.is_zero() & (sel1 == 1)) or np.any(fp2.is_zero() & (sel2 == 1)):
        return None
    g1 = sel1 * fp1.inv()
    g2 = sel2 * fp2.inv()
    s1 = g1.sum()
    s2 = g2.sum()
    if s1 != s2:
        raise AssertionError("PC chain broken in honest trace (VM bug?)")
    return g1, g2, s1


def make_v2_combiner(tau: Ext4, beta: Ext4):
    """Full 6-constraint combiner, generic over base/Ext4 inputs: the
    prover passes (partially folded) columns incl. the g1/g2 coordinate
    tables; the verifier passes terminal Ext4 evaluations plus the public
    values from :func:`v2_public_evals`."""

    def combiner(cols, alphas: List, p: int):
        one = 1
        x0 = cols["x0"]
        is_read = cols["is_read"]
        seq = cols["seq"]
        pc = cols["pc"]
        next_pc = cols["next_pc"]
        idx = cols["__idx__"]
        sel1 = cols["__sel1__"]
        sel2 = cols["__sel2__"]

        c1 = x0
        c2 = is_read * ((one + p - is_read) % p) % p
        c3 = seq * ((one + p - seq) % p) % p
        delta = (next_pc + p + p - pc - 4) % p
        c4 = seq * delta % p

        g1 = ext_from_coords([cols[f"g1#{e}"] for e in range(4)])
        g2 = ext_from_coords([cols[f"g2#{e}"] for e in range(4)])
        fp1 = tau - beta * ((idx + 1) % p) - next_pc
        fp2 = tau - beta * idx - pc
        c5 = g1 * fp1 - sel1
        c6 = g2 * fp2 - sel2

        acc = alphas[0] * c1
        for a, t in zip(alphas[1:], (c2, c3, c4, c5, c6)):
            acc = acc + a * t
        return acc

    return combiner


def v2_public_evals(num_steps: int, num_vars: int, p: int):
    """Verifier-side public values at the extension final point."""

    def fn(rs):
        idx_r = idx_eval(num_vars, rs, p)
        sel1 = le_indicator_eval(num_steps - 2, num_vars, rs, p)
        sel2 = (le_indicator_eval(num_steps - 1, num_vars, rs, p)
                - eq_zero_eval(rs, p)) % p
        return {"__idx__": idx_r, "__sel1__": sel1, "__sel2__": sel2}

    return fn
