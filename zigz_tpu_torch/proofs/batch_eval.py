"""Batch-evaluation reduction: many (column, point, value) claims -> one.

Protocol v2+ (round 3) runs one zerocheck per argument domain, each ending
with per-column evaluation claims at ITS OWN terminal point, plus the
logUp hypercube-sum claims.  Opening a Ligero commitment per claim point
would pay the extension query row (4 * n words) once per point; this
module instead runs the standard multi-point batching sumcheck

    sum_i delta^i * value_i  ==  sum_x  sum_i delta^i * w_i(x) * f_i(x)

over the common zero-padded domain {0,1}^v_max, where w_i is the
multilinear weight of claim i — eq(point_i, .) for an evaluation claim,
the constant 1 for a hypercube-sum claim — zero-extended to v_max vars.
After v_max rounds every claim collapses to the SINGLE point rho: the
prover absorbs each involved column's evaluation at (the tail of) rho,
and the caller opens each commitment ONCE with a LigeroMixedClaim whose
row/column weights the verifier derives from rho itself.

Zero-padding semantics (MSB-first fold order, matching the zerocheck): a
v_k-variable column occupies indices 0..2^{v_k}-1 of the 2^{v_max}
domain, so its padded multilinear extension is
prod_{j=1..v_max-v_k}(1 - x_j) * f~(x_tail); the weight pads the same
way, so claim i's terminal factor is

    W_i(rho) = prod_{j<=v_max-v_k}(1 - rho_j)^2 * eq(point_i, rho_tail)

(or * 1 for sum claims).  The prover never materializes the padding:
inactive groups contribute (1-x)^2 * partial_sum per round and a scalar
(1-r)^2 scale until their width is reached.

Soundness: the delta combination adds <= num_claims/|K| (~2^-117 for
hundreds of claims), the sumcheck rounds 2*v_max/|K| — both Ext4 terms.

All challenges (delta, round challenges) are BabyBear^4; round
evaluations and terminal column evaluations are absorbed as 4 LE u64
limbs (coordinate order c0..c3), like proofs/zerocheck.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.ext4 import Ext4, challenge_ext, ext_lift, ext_zeros
from .zerocheck import _eq_table_ext, _interp_eval_ext, absorb_ext, eq_eval_ext

__all__ = [
    "BatchClaim",
    "BatchEvalProof",
    "prove_batch_eval",
    "verify_batch_eval",
    "claim_weight_at",
    "mixed_claim_from_rho",
]

P = 2013265921


@dataclass
class BatchClaim:
    """One pre-reduction claim: column ``name`` of ``commitment`` (a
    registry key, e.g. "data"/"advice") evaluates to ``value`` at
    ``point`` (length-num_vars Ext4 list), or sums to ``value`` over its
    hypercube when ``point`` is None.  ``value`` must already be
    transcript-bound by the issuing argument (zerocheck terminal evals
    are absorbed by the zerocheck; logUp sums by their argument)."""

    commitment: str
    name: str
    num_vars: int
    point: Optional[List[Ext4]]
    value: Ext4


@dataclass
class BatchEvalProof:
    num_vars: int
    round_evals: List[List[Ext4]]  # 3 evals (degree 2) per round
    final_point: List[Ext4]
    # (commitment, column) -> evaluation at the tail of final_point.
    column_evals: Dict[Tuple[str, str], Ext4]


def _group_key(claim: BatchClaim):
    if claim.point is None:
        return ("sum", claim.num_vars)
    return ("pt", claim.num_vars, tuple(x.to_ints() for x in claim.point))


def _at_t(tab: Ext4, t: int) -> Ext4:
    half = tab.shape[-1] // 2
    lo = tab[..., :half]
    hi = tab[..., half:]
    if t == 0:
        return lo
    if t == 1:
        return hi
    return (1 - t) * lo + t * hi


def _fold(tab: Ext4, r: Ext4) -> Ext4:
    half = tab.shape[-1] // 2
    return (1 - r) * tab[..., :half] + r * tab[..., half:]


def claim_weight_at(claim: BatchClaim, rho: List[Ext4], p: int = P) -> Ext4:
    """W_i(rho): the zero-padded weight polynomial of claim i at the
    reduced point — verifier-computable."""
    v_max = len(rho)
    pad = v_max - claim.num_vars
    acc = ext_lift(1)
    for j in range(pad):
        om = 1 - rho[j]
        acc = acc * om * om
    if claim.point is not None:
        acc = acc * eq_eval_ext(claim.point, rho[pad:], p)
    return acc


def _mle_eval_tail(col: np.ndarray, rho_tail: List[Ext4], p: int = P) -> Ext4:
    """f~(rho_tail) for a base column of 2^len(rho_tail) values."""
    if not rho_tail:
        return ext_lift(int(col[0]) % p)
    eq = _eq_table_ext(rho_tail, p)
    return (eq * (np.asarray(col, dtype=np.uint64) % np.uint64(p))).sum()


_NATIVE_TRACES: Dict[int, tuple] = {}


def _native_rounds_available() -> bool:
    try:
        from ..ops.zerocheck_native import native_available

        return native_available()
    except Exception:
        return False


def _native_spec(n_active: int):
    """Cached DAG computing sum_g F_g * w_g over the active prefix of the
    stacked group matrix (8 rows per group: 4 F coords then 4 w coords)."""
    spec = _NATIVE_TRACES.get(n_active)
    if spec is not None:
        return spec
    from ..ops.symtrace import SymExt, _Trace
    from ..ops.zerocheck_native_ext import _dag_spec

    t = _Trace()
    acc = None
    row_of = {}
    for g in range(n_active):
        f = SymExt(t, [t.col(f"f{g}#{e}") for e in range(4)])
        w = SymExt(t, [t.col(f"w{g}#{e}") for e in range(4)])
        for e in range(4):
            row_of[f"f{g}#{e}"] = 8 * g + e
            row_of[f"w{g}#{e}"] = 8 * g + 4 + e
        prod = f * w
        acc = prod if acc is None else acc + prod

    class _Tr:
        signature = (tuple(t.nodes), tuple(acc.c), ())
        consts = t.consts

    spec = _dag_spec(_Tr, row_of)
    _NATIVE_TRACES[n_active] = spec
    return spec


def _native_round(stacked: np.ndarray, n_active: int, width: int,
                  claim_running: Ext4, inactive_sum: Ext4, p: int):
    """[g(0), g(1), g(2)] via runtime/dag.cpp, or None to fall back.
    g(1) = claim - g(0) (standard sumcheck identity; the inactive groups'
    (1-1)^2 factor vanishes at t=1); g(0)/g(2) add the inactive scalar
    with factors (1-0)^2 = (1-2)^2 = 1."""
    from ..runtime import native_dag_round_multi

    spec, out_slots, consts = _native_spec(n_active)
    vals = native_dag_round_multi(stacked, width, spec, consts, out_slots, 2)
    if vals is None:
        return None
    from ..core.ext4 import ext_from_ints

    g0 = ext_from_ints(vals[0]) + inactive_sum
    g2 = ext_from_ints(vals[1]) + inactive_sum
    return [g0, claim_running - g0, g2]


def prove_batch_eval(claims: List[BatchClaim],
                     columns: Dict[Tuple[str, str], np.ndarray],
                     transcript, group=None, timings: dict = None) -> BatchEvalProof:
    """``columns`` maps (commitment, column) to the committed base array.
    Claim order is part of the protocol (both sides build the same list).

    With a ``group`` (parallel/multihost.py ``TraceGroup``) for which
    ``mesh_rounds_ok`` holds, the round loop runs sharded over the group's
    devices (ops/batch_eval_dev.py): the same round evaluations, their sums
    all-reduced.  Without one, or below that size, the native C++ rounds
    run on the host.  ``timings["batch_eval_sharded"]`` says which ran."""
    p = P
    assert claims, "batch-eval needs at least one claim"
    v_max = max(c.num_vars for c in claims)
    # Claims referencing the same committed column must agree on its width:
    # the prover evaluates each column once at the tail of rho, and the
    # verifier weights every claim by its own num_vars against that single
    # evaluation (ADVICE r3: inconsistent widths would silently misbind).
    widths: Dict[Tuple[str, str], int] = {}
    for c in claims:
        key = (c.commitment, c.name)
        assert widths.setdefault(key, c.num_vars) == c.num_vars, \
            f"conflicting num_vars for column {key}"

    delta = challenge_ext(transcript)

    # Group claims by (weight table): same point + same width share one
    # combined column F_j = sum_i delta^i f_i.
    groups: Dict[tuple, dict] = {}
    dpow = ext_lift(1)
    combined_claim = ext_zeros()
    for claim in claims:
        key = _group_key(claim)
        g = groups.get(key)
        if g is None:
            g = groups[key] = {
                "v": claim.num_vars,
                "point": claim.point,
                "coeffs": [],  # (delta_power, column array)
            }
        g["coeffs"].append((dpow, columns[(claim.commitment, claim.name)]))
        combined_claim = combined_claim + dpow * claim.value
        dpow = dpow * delta

    # Materialize per-group tables: one fused C++ pass per GROUP
    # (runtime zigz_ext4_scale_base_multi) — hundreds of per-claim
    # scale-accumulate calls collapse into a single read of each column
    # and a single write of the combined table.
    from ..core.ext4 import _native

    rt = _native()
    for g in groups.values():
        F = ext_zeros((1 << g["v"],))
        cols = [np.ascontiguousarray(col, dtype=np.uint64)
                for _c, col in g["coeffs"]]
        fused = None
        if rt is not None and cols and len(cols[0]) >= 1024:
            coeffs = np.stack([np.asarray(c.c, dtype=np.uint64).reshape(4)
                               for c, _col in g["coeffs"]])
            fused = rt.native_ext4_scale_base_multi(coeffs, cols, F.c)
        if fused is None:
            for (coeff, _col), col in zip(g["coeffs"], cols):
                F = F + coeff * (col % np.uint64(p))
        g["F"] = F
        if g["point"] is None:
            g["w"] = Ext4.lift(np.ones(1 << g["v"], dtype=np.uint64))
        else:
            g["w"] = _eq_table_ext(g["point"], p)
        g["scale"] = ext_lift(1)  # prod (1-r)^2 over pre-activation rounds
        g["inactive_sum"] = (g["w"] * g["F"]).sum()

    glist = sorted(groups.values(), key=lambda g: -g["v"])  # activation order
    round_evals: List[List[Ext4]] = []
    rs: List[Ext4] = []
    claim_running = combined_claim
    mesh_ran = False
    if group is not None:
        from ..ops.batch_eval_dev import mesh_rounds_ok, prove_rounds_mesh

        if mesh_rounds_ok(group, v_max):
            round_evals, rs, claim_running = prove_rounds_mesh(
                glist, v_max, combined_claim, transcript, group
            )
            mesh_ran = True
    if timings is not None:
        timings["batch_eval_sharded"] = mesh_ran
    native = (not mesh_ran) and _native_rounds_available()
    one = ext_lift(1)
    stacked = None
    if native:
        # One (8G, 2^v_max) canonical uint32 matrix: per group 4 F rows +
        # 4 w rows, written at activation (runtime/dag.cpp folds operate
        # on it in place; rows of not-yet-active groups hold garbage the
        # per-round DAG never reads).
        stacked = np.zeros((8 * len(glist), 1 << v_max), dtype=np.uint32)
    for rnd in range(0 if mesh_ran else v_max):
        v_cur = v_max - rnd  # vars remaining INCLUDING this round's
        for gi, g in enumerate(glist):
            # Group activates this round: fold its accumulated pad scale
            # (prod (1-r)^2 over the head rounds) into the weight table.
            if g["v"] == v_cur:
                if g["scale"] != one:
                    g["w"] = g["scale"] * g["w"]
                    g["scale"] = one
                if native:
                    w_cur = 1 << v_cur
                    stacked[8 * gi : 8 * gi + 4, :w_cur] = g["F"].c
                    stacked[8 * gi + 4 : 8 * gi + 8, :w_cur] = g["w"].c
        n_active = sum(1 for g in glist if g["v"] >= v_cur)
        inactive_sum = ext_zeros()
        for g in glist[n_active:]:
            inactive_sum = inactive_sum + g["scale"] * g["inactive_sum"]
        if native:
            evals = _native_round(stacked, n_active, 1 << v_cur,
                                  claim_running, inactive_sum, p)
            # The numpy g["F"]/g["w"] tables are NOT folded on the native
            # path (folds happen in `stacked` only), so falling back
            # mid-proof would read stale tables and emit a wrong proof —
            # fail loudly instead (the runtime was load-checked up front,
            # so this is unreachable outside memory exhaustion).
            if evals is None:
                raise RuntimeError("native batch-eval round failed mid-proof")
        else:
            evals = None
        if evals is None:
            evals = []
            for t in (0, 1, 2):
                total = ext_zeros()
                for g in groups.values():
                    if g["v"] < v_cur:
                        # Zero-padded: value (1-t)^2 * scale * partial sum.
                        om = (1 - t) % p
                        total = total + (om * om % p) * (g["scale"] * g["inactive_sum"])
                    else:
                        w_t = _at_t(g["w"], t)
                        F_t = _at_t(g["F"], t)
                        total = total + (w_t * F_t).sum()
                evals.append(total)
        round_evals.append(evals)
        for e in evals:
            absorb_ext(transcript, e)
        r = challenge_ext(transcript)
        rs.append(r)
        claim_running = _interp_eval_ext(evals, r, p)
        om_r = 1 - r
        if native:
            from ..runtime import native_dag_fold_ext

            if not native_dag_fold_ext(stacked, 1 << v_cur, r.to_ints()):
                raise RuntimeError("native batch-eval fold failed mid-proof")
        for g in groups.values():
            if g["v"] < v_cur:
                g["scale"] = g["scale"] * om_r * om_r
            elif not native:
                g["w"] = _fold(g["w"], r)
                g["F"] = _fold(g["F"], r)

    # Terminal column evaluations at the tail of rho, deduped per
    # (commitment, column), absorbed in sorted order.  The eq table is
    # shared by every column of the same width; all same-width columns
    # evaluate in ONE fused native pass (zigz_ext4_dot_base_multi).
    by_width: Dict[int, List[Tuple[str, str]]] = {}
    column_evals: Dict[Tuple[str, str], Ext4] = {}
    for claim in claims:
        key = (claim.commitment, claim.name)
        if key in column_evals:
            continue
        if claim.num_vars == 0:
            column_evals[key] = ext_lift(int(columns[key][0]) % p)
        elif key not in (g := by_width.setdefault(claim.num_vars, [])):
            g.append(key)
    from ..core.ext4 import ext_from_ints

    for v_k, keys in by_width.items():
        eq = _eq_table_ext(rs[v_max - v_k :], p)
        cols = [np.ascontiguousarray(columns[key], dtype=np.uint64)
                for key in keys]
        dots = None
        if rt is not None and (1 << v_k) >= 1024:
            dots = rt.native_ext4_dot_base_multi(np.ascontiguousarray(eq.c), cols)
        if dots is not None:
            for key, row in zip(keys, dots):
                column_evals[key] = ext_from_ints([int(x) for x in row])
        else:
            for key, col in zip(keys, cols):
                column_evals[key] = (eq * (col % np.uint64(p))).sum()
    for key in sorted(column_evals):
        absorb_ext(transcript, column_evals[key])

    return BatchEvalProof(
        num_vars=v_max,
        round_evals=round_evals,
        final_point=rs,
        column_evals=column_evals,
    )


def mixed_claim_from_rho(col_vars: Dict[str, int], cn: int, rho: List[Ext4],
                         evals: Dict[str, Ext4], p: int = P):
    """Build the single LigeroMixedClaim opening a mixed commitment at the
    batch-eval point: shared b = eq(rho[-cn:]); per-column row weights
    a_k = eq(rho[-v_k:-cn]); columns shorter than one matrix row carry the
    zero-padding factor prod(1-rho_j) on their claimed value.  Both sides
    call this with the same public inputs, so the weights never ride the
    proof."""
    from ..commitments.ligero import LigeroMixedClaim

    b = _eq_table_ext(rho[len(rho) - cn :], p)
    entries = {}
    # a_k / the padding factor depend only on v_k — memoize per width
    # (hundreds of columns share a handful of widths).
    a_cache: Dict[int, object] = {}
    f_cache: Dict[int, Ext4] = {}
    for name, v_k in col_vars.items():
        if name not in evals:
            continue
        e = evals[name]
        if v_k >= cn:
            a_k = a_cache.get(v_k)
            if a_k is None:
                head = rho[len(rho) - v_k : len(rho) - cn]
                a_k = _eq_table_ext(head, p)
                a_cache[v_k] = a_k
            entries[name] = (a_k, e)
        else:
            factor = f_cache.get(v_k)
            if factor is None:
                factor = ext_lift(1)
                for r in rho[len(rho) - cn : len(rho) - v_k]:
                    factor = factor * (1 - r)
                f_cache[v_k] = factor
            a_k = _eq_table_ext([], p)  # shape (1,) == [1]
            entries[name] = (a_k, factor * e)
    return LigeroMixedClaim(b=b, entries=entries)


def verify_batch_eval(claims: List[BatchClaim], proof: BatchEvalProof,
                      transcript) -> bool:
    """Round-consistency + terminal check: the running claim must equal
    sum_i delta^i * W_i(rho) * e_{col(i)} with every e absorbed."""
    p = P
    if not claims:
        return False
    v_max = max(c.num_vars for c in claims)
    if proof.num_vars != v_max:
        return False
    if len(proof.round_evals) != v_max or len(proof.final_point) != v_max:
        return False

    delta = challenge_ext(transcript)
    dpow = ext_lift(1)
    combined_claim = ext_zeros()
    dpows = []
    for claim in claims:
        dpows.append(dpow)
        combined_claim = combined_claim + dpow * claim.value
        dpow = dpow * delta

    claim_running = combined_claim
    rs: List[Ext4] = []
    for evals in proof.round_evals:
        if len(evals) != 3:
            return False
        if not all(isinstance(e, Ext4) and e.is_scalar for e in evals):
            return False
        if evals[0] + evals[1] != claim_running:
            return False
        for e in evals:
            absorb_ext(transcript, e)
        r = challenge_ext(transcript)
        rs.append(r)
        claim_running = _interp_eval_ext(evals, r, p)
    if rs != proof.final_point:
        return False

    expected_keys = {(c.commitment, c.name) for c in claims}
    if set(proof.column_evals) != expected_keys:
        return False
    for key in sorted(proof.column_evals):
        val = proof.column_evals[key]
        if not (isinstance(val, Ext4) and val.is_scalar):
            return False
        absorb_ext(transcript, val)

    # W_i(rho) only depends on the claim's GROUP (shared zerocheck point +
    # width): memoize per group — typically ~10 distinct groups for ~600
    # claims, turning the dominant scalar-Ext4 cost of verification into a
    # handful of eq evaluations (round-3 verify profile: 0.7 s -> ~0.05 s).
    weight_cache: Dict[tuple, Ext4] = {}
    terminal = ext_zeros()
    for claim, dp in zip(claims, dpows):
        gk = _group_key(claim)
        w = weight_cache.get(gk)
        if w is None:
            w = claim_weight_at(claim, rs, p)
            weight_cache[gk] = w
        e = proof.column_evals[(claim.commitment, claim.name)]
        terminal = terminal + dp * (w * e)
    return terminal == claim_running
