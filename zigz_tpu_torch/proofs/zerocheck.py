"""Zerocheck: prove a constraint combination vanishes on the hypercube.

This is the v2 "complete implementation" the reference's own comments
sketch (prover.zig:281-286): instead of all-zero placeholder round
polynomials, run a REAL sumcheck over

    Z(x) = eq(tau, x) * C(x),        C(x) = sum_j alpha_j * constraint_j(x)

where tau and the alpha_j are Fiat-Shamir challenges.  sum_x Z(x) = 0 iff
C vanishes everywhere on {0,1}^v (w.h.p. over tau) — the standard
eq-polynomial zerocheck.  Round polynomials have degree <= DEGREE (the
maximal constraint degree + 1 for the eq factor) and are sent as DEGREE+1
evaluations g(0..DEGREE); the verifier folds claims through barycentric
interpolation and finishes with an algebraic check: it computes
eq(tau, r) itself (closed form) and combines the prover's claimed terminal
evaluations of each constraint column.

The fold convention is MSB-first (reference partialEval ordering), matching
the wire-compatible sumcheck; the terminal per-column evaluations are
therefore at the fold-ordered point (bit v-1 <- r_1, ..., bit 0 <- r_v).

Hot path: all tables are canonical uint64 numpy rows; every operation is a
vectorized fold/product with mod-p reductions after each multiply.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List

import numpy as np

from ..core.hash import FiatShamirTranscript

__all__ = [
    "ZerocheckProof",
    "ZerocheckProver",
    "ZerocheckVerifier",
    "make_zerocheck_prover",
    "ZerocheckExtProver",
    "ZerocheckExtVerifier",
    "eq_eval",
    "eq_eval_ext",
    "absorb_ext",
    "count_zerocheck_proofs",
    "unified_dev_columns",
    "unified_device",
]


def _fold_msb(table: np.ndarray, r: int, p: int) -> np.ndarray:
    half = table.shape[-1] // 2
    om = (1 - r) % p
    return (np.uint64(om) * table[..., :half] + np.uint64(r) * table[..., half:]) % np.uint64(p)


def _eval_at_t(table: np.ndarray, t: int, p: int) -> np.ndarray:
    """Table restricted to current-var = t (static small t)."""
    half = table.shape[-1] // 2
    if t == 0:
        return table[..., :half]
    if t == 1:
        return table[..., half:]
    # (1-t)*e0 + t*e1 mod p with t small.
    om = (1 - t) % p
    return (np.uint64(om) * table[..., :half] + np.uint64(t) * table[..., half:]) % np.uint64(p)


def eq_eval(taus: List[int], rs: List[int], p: int) -> int:
    """eq(tau, r) = prod_j ((1-tau_j)(1-r_j) + tau_j r_j) mod p."""
    acc = 1
    for t, r in zip(taus, rs):
        term = ((1 - t) % p) * ((1 - r) % p) % p
        term = (term + t * r) % p
        acc = acc * term % p
    return acc


def _eq_table(taus: List[int], p: int) -> np.ndarray:
    """Dense eq(tau, .) over the hypercube, MSB-first variable order: the
    j-th fold variable (tau_j) controls index bit v-j."""
    table = np.array([1], dtype=np.uint64)
    # Each concat step adds a new MOST-significant bit, so process taus in
    # reverse: the last appended (tau_1) lands on the MSB — matching the
    # MSB-first fold that consumes r_1 first.
    for t in reversed(taus):
        om = np.uint64((1 - t) % p)
        tv = np.uint64(t % p)
        table = np.concatenate([om * table % np.uint64(p), tv * table % np.uint64(p)])
    return table


@dataclass
class ZerocheckProof:
    num_vars: int
    degree: int
    round_evals: List[List[int]]  # per round: g(0..degree)
    final_point: List[int]  # challenges r_1..r_v
    column_evals: Dict[str, int]  # terminal evaluation per named column


def count_zerocheck_proofs(obj) -> int:
    """Distinct :class:`ZerocheckProof` objects reachable from ``obj`` (a
    proof, one of its sections, or a container of them): what a run's
    count of device zerochecks is held against."""
    seen, found, stack = set(), 0, [obj]
    while stack:
        x = stack.pop()
        if x is None or isinstance(x, (int, str, bytes, float, np.ndarray)) or id(x) in seen:
            continue
        seen.add(id(x))
        if isinstance(x, ZerocheckProof):
            found += 1
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif hasattr(x, "__dict__"):
            stack.extend(vars(x).values())
    return found


class ZerocheckProver:
    """Generic zerocheck prover over named constraint columns.

    ``combiner(cols, alphas, p)`` evaluates C pointwise from a dict of
    equally-shaped numpy arrays (vectorized); DEGREE bounds deg(eq*C) per
    variable.
    """

    def __init__(self, F, columns: Dict[str, np.ndarray], combiner: Callable, degree: int,
                 num_alphas: int = None):
        self.F = F
        self.columns = columns
        self.combiner = combiner
        self.degree = degree
        # One combination challenge per CONSTRAINT (not per column).
        self.num_alphas = num_alphas if num_alphas is not None else len(columns)

    # Chunk width for combiner evaluation: sliced inputs keep every
    # intermediate term L2-resident instead of streaming dozens of
    # full-width temporaries through memory (the combiners are pure
    # elementwise expressions, so chunking is exact).
    COMBINE_CHUNK = 1 << 16

    def _combined_sum(self, at: Dict[str, np.ndarray], alphas, p: int) -> int:
        P64 = np.uint64(p)
        n = at["__eq__"].shape[-1]
        if n <= self.COMBINE_CHUNK:
            c_vals = self.combiner(at, alphas, p)
            # z < p < 2^31: u64 sum exact for any n <= 2^33.
            return int((at["__eq__"] * c_vals % P64).sum(dtype=np.uint64)) % p
        total = 0
        for lo in range(0, n, self.COMBINE_CHUNK):
            sl = {name: a[..., lo : lo + self.COMBINE_CHUNK] for name, a in at.items()}
            c_vals = self.combiner(sl, alphas, p)
            total += int((sl["__eq__"] * c_vals % P64).sum(dtype=np.uint64))
        return total % p

    def round_values(self, tables: Dict[str, np.ndarray], alphas, claim: int, p: int) -> List[int]:
        """g(0..degree) of one round over ``tables`` (the columns and
        ``__eq__``, canonical uint64).  Also the host tail of the device
        prover (ops/zerocheck_gen.py)."""
        # g(0) from the lo-half slices; g(1) DERIVED from the sumcheck
        # identity g(0) + g(1) = claim (skips one full combiner sweep
        # per round); g(2..d) built incrementally from per-column
        # deltas: at_t = at_{t-1} + (hi - lo)  == (1-t)*lo + t*hi mod p.
        # All identical values to the direct evaluation, so the
        # transcript and proof bytes are unchanged.
        P64 = np.uint64(p)
        at0 = {name: _eval_at_t(tab, 0, p) for name, tab in tables.items()}
        g0 = self._combined_sum(at0, alphas, p)
        evals_this_round = [g0, (claim - g0) % p]
        if self.degree >= 2:
            deltas = {
                name: (tab[..., tab.shape[-1] // 2 :] + P64
                       - tab[..., : tab.shape[-1] // 2]) % P64
                for name, tab in tables.items()
            }
            cur = {name: _eval_at_t(tab, 1, p).copy() for name, tab in tables.items()}
            for _t in range(2, self.degree + 1):
                for name in cur:
                    cur[name] = (cur[name] + deltas[name]) % P64
                evals_this_round.append(self._combined_sum(cur, alphas, p))
        return evals_this_round

    def prove(self, transcript: FiatShamirTranscript) -> ZerocheckProof:
        F = self.F
        p = F.MODULUS
        # Precondition for the exact-uint64 arithmetic below: canonical
        # values < p < 2^31 keep every product < 2^62 and every hypercube
        # sum (n <= 2^33 terms) inside uint64.
        assert p < (1 << 31), "zerocheck requires a field modulus < 2^31"
        any_col = next(iter(self.columns.values()))
        n = any_col.shape[-1]
        num_vars = n.bit_length() - 1

        # Challenges: tau (zerocheck randomizer) then alphas (combination).
        taus = [transcript.challenge_value(p) for _ in range(num_vars)]
        alphas = [transcript.challenge_value(p) for _ in range(self.num_alphas)]

        tables = {name: col.astype(np.uint64) % np.uint64(p) for name, col in self.columns.items()}
        tables["__eq__"] = _eq_table(taus, p)

        round_evals: List[List[int]] = []
        rs: List[int] = []
        claim = 0  # zerocheck total; updated to g(r) after each round
        for _ in range(num_vars):
            evals_this_round = self.round_values(tables, alphas, claim, p)
            round_evals.append(evals_this_round)

            for g in evals_this_round:
                transcript.append_u64(g)
            r = transcript.challenge_value(p)
            rs.append(r)
            claim = _interp_eval(evals_this_round, r, p)
            tables = {name: _fold_msb(tab, r, p) for name, tab in tables.items()}

        # "__"-prefixed tables (eq, and the public idx/selector MLEs of the
        # PC-chain argument) are verifier-computable: no terminal evals are
        # emitted or absorbed for them.
        column_evals = {
            name: int(tab[0]) for name, tab in tables.items()
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


def make_zerocheck_prover(F, columns: Dict[str, np.ndarray], combiner: Callable,
                          degree: int, num_alphas: int = None, device=None, group=None):
    """The base-field zerocheck prover for ``device``: a torch device (or
    its name) gives the device prover (ops/zerocheck_gen.py), sharded over
    ``group`` where one is given, and whatever
    fails there raises, a combiner that does not trace included; None gives
    the host's native C++ prover (ops/zerocheck_native.py) when the runtime
    built and the combiner traces, else the numpy prover.  All three emit
    identical transcript bytes and proofs (tests/test_torch_zerocheck_gen.py).

    zigz_tpu's function chooses by an environment variable, a width gate
    and a bandwidth probe and swallows the device prover's failures; none
    of that is carried over.  Like zigz_tpu's, it has no caller in the v2
    to v4 pipelines, whose challenges are drawn from the extension field
    (``ZerocheckExtProver``)."""
    if device is not None:
        from ..ops.zerocheck_gen import GenericDeviceZerocheck

        return GenericDeviceZerocheck(F, columns, combiner, degree, num_alphas=num_alphas, device=device,
                                      group=group)
    if group is not None:
        raise ValueError("a group needs a device: the host provers are not sharded")
    n = next(iter(columns.values())).shape[-1]
    if F.MODULUS == 2013265921 and n >= 2:
        from ..ops.symtrace import TraceError
        from ..ops.zerocheck_native import NativeZerocheckProver, native_available

        if native_available():
            try:
                return NativeZerocheckProver(F, columns, combiner, degree, num_alphas=num_alphas)
            except TraceError:
                pass  # the numpy prover evaluates any combiner
    return ZerocheckProver(F, columns, combiner, degree, num_alphas=num_alphas)


def _interp_eval(ys: List[int], x: int, p: int) -> int:
    """Evaluate the degree-d polynomial through (0..d, ys) at x (Lagrange)."""
    d = len(ys) - 1
    acc = 0
    for i in range(d + 1):
        num, den = 1, 1
        for j in range(d + 1):
            if i == j:
                continue
            num = num * ((x - j) % p) % p
            den = den * ((i - j) % p) % p
        acc = (acc + ys[i] * num % p * pow(den, -1, p)) % p
    return acc


class ZerocheckVerifier:
    """Round-consistency + terminal algebraic check."""

    def __init__(self, F, combiner_scalar: Callable, num_columns: int, degree: int):
        self.F = F
        self.combiner_scalar = combiner_scalar  # (col_evals: dict, alphas, p) -> int
        self.num_columns = num_columns
        self.degree = degree

    def verify(self, proof: ZerocheckProof, transcript: FiatShamirTranscript) -> bool:
        p = self.F.MODULUS
        # Shape checks BEFORE the round loop: a proof with zero rounds and
        # empty final_point would otherwise pass vacuously (eq over an
        # empty challenge list is 1 and the claim stays 0).
        if len(proof.round_evals) != proof.num_vars:
            return False
        if len(proof.final_point) != proof.num_vars:
            return False
        taus = [transcript.challenge_value(p) for _ in range(proof.num_vars)]
        alphas = [transcript.challenge_value(p) for _ in range(self.num_columns)]

        claim = 0  # zerocheck: total must be zero
        rs: List[int] = []
        for evals in proof.round_evals:
            if len(evals) != self.degree + 1:
                return False
            if (evals[0] + evals[1]) % p != claim:
                return False
            for g in evals:
                transcript.append_u64(g % p)
            r = transcript.challenge_value(p)
            rs.append(r)
            claim = _interp_eval(evals, r, p)

        if rs != proof.final_point:
            return False

        for name in sorted(proof.column_evals):
            transcript.append_u64(proof.column_evals[name] % p)

        eq_r = eq_eval(taus, rs, p)
        c_final = self.combiner_scalar(proof.column_evals, alphas, p)
        return (eq_r * c_final) % p == claim


# ===========================================================================
# Extension-field zerocheck (protocol v2+ soundness hardening)
#
# Same protocol as ZerocheckProver/Verifier, with every challenge — the
# eq randomizer taus, the constraint-combination alphas, and the per-round
# fold challenges — drawn from BabyBear^4 (core/ext4.py) instead of the
# base field.  Committed columns stay base-field; they become Ext4 arrays
# after the first extension-point fold.  Round evaluations, the final
# point, and the terminal column evaluations are Ext4 scalars, absorbed as
# 4 LE u64 limbs each (coordinate order c0..c3).
#
# Soundness: round error <= degree * num_vars / p^4 and batching error
# <= 1/p^4 per alpha — ~2^-124-scale terms instead of the base field's
# grindable ~2^-26 (round-2 verdict item 1).
# ===========================================================================

from ..core.ext4 import Ext4, challenge_ext, ext_zeros  # noqa: E402


def absorb_ext(transcript: FiatShamirTranscript, x: Ext4) -> None:
    """Absorb a scalar Ext4 as 4 canonical LE u64 limbs (c0..c3)."""
    transcript.append_u64s(x.c)


def _is_ext(tab) -> bool:
    return isinstance(tab, Ext4)


def _width(tab) -> int:
    return tab.shape[-1] if _is_ext(tab) else tab.shape[-1]


def _at_t_g(tab, t: int, p: int):
    """Table restricted to current-var = t; generic over base/ext tables."""
    half = _width(tab) // 2
    lo = tab[..., :half]
    hi = tab[..., half:]
    if t == 0:
        return lo
    if t == 1:
        return hi
    om = (1 - t) % p
    if _is_ext(tab):
        return om * lo + t * hi
    return (np.uint64(om) * lo + np.uint64(t) * hi) % np.uint64(p)


def _delta_g(tab, p: int):
    """hi - lo (the per-step increment for t = 2..degree sweeps)."""
    half = _width(tab) // 2
    lo = tab[..., :half]
    hi = tab[..., half:]
    if _is_ext(tab):
        return hi - lo
    return (hi + np.uint64(p) - lo) % np.uint64(p)


def _add_g(a, b, p: int):
    if _is_ext(a) or _is_ext(b):
        return a + b
    return (a + b) % np.uint64(p)


def _fold_ext(tab, r: Ext4, p: int) -> Ext4:
    """(1-r)*lo + r*hi with an EXTENSION challenge: base tables become
    Ext4 arrays on their first fold."""
    half = _width(tab) // 2
    return (1 - r) * tab[..., :half] + r * tab[..., half:]


def _eq_table_ext(taus: List[Ext4], p: int) -> Ext4:
    """Dense eq(tau, .) over the hypercube for extension taus; same
    MSB-first concat order as _eq_table."""
    from ..core.ext4 import ext_from_ints

    table = ext_from_ints([1, 0, 0, 0]).c.reshape(4, 1)
    table = Ext4(table)
    for t in reversed(taus):
        om_part = (1 - t) * table
        t_part = t * table
        table = Ext4(np.concatenate([om_part.c, t_part.c], axis=-1), _trusted=True)
    return table


def eq_eval_ext(taus: List[Ext4], rs: List[Ext4], p: int) -> Ext4:
    from ..core.ext4 import ext_from_ints

    acc = ext_from_ints([1, 0, 0, 0])
    for t, r in zip(taus, rs):
        acc = acc * ((1 - t) * (1 - r) + t * r)
    return acc


def _interp_eval_ext(ys: List[Ext4], x: Ext4, p: int) -> Ext4:
    """Lagrange evaluation through (0..d, ys) at an extension point."""
    d = len(ys) - 1
    acc = ext_zeros()
    for i in range(d + 1):
        num = None
        den = 1
        for j in range(d + 1):
            if i == j:
                continue
            term = x - j
            num = term if num is None else num * term
            den = den * ((i - j) % p) % p
        coeff = ys[i] * pow(den, -1, p)
        acc = acc + (coeff * num if num is not None else coeff)
    return acc


class ZerocheckExtProver:
    """ZerocheckProver with extension-field challenges.

    ``columns`` values may be base canonical uint64 arrays OR Ext4 arrays
    (e.g. a logUp inverse column's coordinate representation recombined by
    the combiner).  ``combiner(cols, alphas, p)`` receives base-or-Ext4
    values and Ext4 alphas and must use the generic mod-p idioms
    ((a + p - b) % p, a * b % p) so it evaluates on both."""

    COMBINE_CHUNK = 1 << 16

    def __init__(self, F, columns: Dict[str, np.ndarray], combiner: Callable,
                 degree: int, num_alphas: int = None, dev_columns=None, device=None):
        self.F = F
        self.columns = columns
        self.combiner = combiner
        self.degree = degree
        self.num_alphas = num_alphas if num_alphas is not None else len(columns)
        # ``device``: a torch device (or its name) sends the zerocheck to
        # GenericDeviceZerocheckExt (ops/zerocheck_dev_ext.py); None runs
        # it on the host.  ``dev_columns``: DeviceColumnRef slices of a
        # commitment's matrix on that device, for (some) base columns.
        self.dev_columns = dev_columns
        self.device = device

    def _combined_sum(self, at: Dict[str, object], alphas, p: int) -> Ext4:
        n = _width(at["__eq__"])
        if n <= self.COMBINE_CHUNK:
            c_vals = self.combiner(at, alphas, p)
            return (at["__eq__"] * c_vals).sum()
        total = ext_zeros()
        for lo in range(0, n, self.COMBINE_CHUNK):
            sl = {name: a[..., lo: lo + self.COMBINE_CHUNK] for name, a in at.items()}
            c_vals = self.combiner(sl, alphas, p)
            total = total + (sl["__eq__"] * c_vals).sum()
        return total

    def prove(self, transcript: FiatShamirTranscript) -> ZerocheckProof:
        F = self.F
        p = F.MODULUS
        assert p == 2013265921, "extension zerocheck is BabyBear-only"
        any_col = next(iter(self.columns.values()))
        n = _width(any_col)
        num_vars = n.bit_length() - 1

        # Backend dispatch.  All backends emit byte-identical transcripts
        # and proofs.  With a device there is no width gate and no way back
        # to the host: a TraceError or a failed launch raises.
        if self.device is not None and n >= 2:
            from ..ops.zerocheck_dev_ext import GenericDeviceZerocheckExt

            return GenericDeviceZerocheckExt(
                F, self.columns, self.combiner, self.degree,
                num_alphas=self.num_alphas, dev_columns=self.dev_columns,
                device=self.device,
            ).prove(transcript)

        # Host: the native C++ twin (ops/zerocheck_native_ext.py) when the
        # runtime built and the combiner traces (tracing happens before the
        # transcript is touched), else the numpy rounds below.
        if n >= 2:
            from ..ops.symtrace import TraceError
            from ..ops.zerocheck_native import native_available

            if native_available():
                from ..ops.zerocheck_native_ext import NativeZerocheckExtProver

                try:
                    native = NativeZerocheckExtProver(
                        F, self.columns, self.combiner, self.degree,
                        num_alphas=self.num_alphas,
                    )
                except TraceError:
                    native = None
                if native is not None:
                    return native.prove(transcript)

        taus = [challenge_ext(transcript) for _ in range(num_vars)]
        alphas = [challenge_ext(transcript) for _ in range(self.num_alphas)]

        tables: Dict[str, object] = {}
        for name, col in self.columns.items():
            if _is_ext(col):
                tables[name] = col
            else:
                tables[name] = col.astype(np.uint64) % np.uint64(p)
        tables["__eq__"] = _eq_table_ext(taus, p)

        round_evals: List[List[Ext4]] = []
        rs: List[Ext4] = []
        claim = ext_zeros()
        for _ in range(num_vars):
            at0 = {name: _at_t_g(tab, 0, p) for name, tab in tables.items()}
            g0 = self._combined_sum(at0, alphas, p)
            evals_this_round = [g0, claim - g0]
            if self.degree >= 2:
                deltas = {name: _delta_g(tab, p) for name, tab in tables.items()}
                cur = {name: _at_t_g(tab, 1, p) for name, tab in tables.items()}
                for _t in range(2, self.degree + 1):
                    for name in cur:
                        cur[name] = _add_g(cur[name], deltas[name], p)
                    evals_this_round.append(self._combined_sum(cur, alphas, p))
            round_evals.append(evals_this_round)

            for g in evals_this_round:
                absorb_ext(transcript, g)
            r = challenge_ext(transcript)
            rs.append(r)
            claim = _interp_eval_ext(evals_this_round, r, p)
            tables = {name: _fold_ext(tab, r, p) for name, tab in tables.items()}

        column_evals: Dict[str, Ext4] = {}
        for name, tab in tables.items():
            if name.startswith("__"):
                continue
            val = tab[..., 0] if _is_ext(tab) else Ext4.lift(int(tab[0]))
            if _is_ext(val):
                column_evals[name] = Ext4(val.c.reshape(4))
            else:
                column_evals[name] = val
        for name in sorted(column_evals):
            absorb_ext(transcript, column_evals[name])

        return ZerocheckProof(
            num_vars=num_vars,
            degree=self.degree,
            round_evals=round_evals,
            final_point=rs,
            column_evals=column_evals,
        )


def unified_dev_columns(arg, names, rename=None, locmap=None):
    """Device-resident column refs for an argument's zerocheck inputs.

    ``prove_unified`` stores the data/advice LigeroCommitState pair on each
    argument as ``_unified_states``; this maps the argument's LOCAL column
    names through its locmap to :class:`DeviceColumnRef` views of the
    resident commit matrices (None when the argument runs outside
    ``prove_unified`` and has no commit states).
    ``rename`` translates a zerocheck-local name to the locmap key (some
    zerochecks address committed columns under shorter local names);
    unresolvable names are simply uploaded by the device prover."""
    states = getattr(arg, "_unified_states", None)
    if not states:
        return None
    lm = locmap if locmap is not None else arg.locmap
    out = {}
    for name in names:
        ent = lm.get(rename(name) if rename else name)
        if ent is None:
            continue
        ck, fn, _v = ent
        st = states.get(ck)
        if st is None:
            continue
        ref = st.device_column(fn)
        if ref is not None:
            out[name] = ref
    return out or None


def unified_device(arg):
    """The torch device ``prove_unified`` handed to an argument next to
    ``_unified_states`` (None outside it: the zerocheck runs on the host)."""
    return getattr(arg, "_unified_device", None)


class ZerocheckExtVerifier:
    """Round-consistency + terminal algebraic check, extension challenges.

    ``public_evals(rs) -> dict`` (optional) supplies the verifier-computed
    "__"-prefixed values (selector/idx MLEs at the extension final point),
    merged into the evaluation dict the shared combiner consumes — so one
    combiner serves prover and verifier."""

    def __init__(self, F, combiner: Callable, num_alphas: int, degree: int,
                 public_evals: Callable = None):
        self.F = F
        self.combiner = combiner
        self.num_alphas = num_alphas
        self.degree = degree
        self.public_evals = public_evals

    def verify(self, proof: ZerocheckProof, transcript: FiatShamirTranscript) -> bool:
        p = self.F.MODULUS
        if len(proof.round_evals) != proof.num_vars:
            return False
        if len(proof.final_point) != proof.num_vars:
            return False
        taus = [challenge_ext(transcript) for _ in range(proof.num_vars)]
        alphas = [challenge_ext(transcript) for _ in range(self.num_alphas)]

        claim = ext_zeros()
        rs: List[Ext4] = []
        for evals in proof.round_evals:
            if len(evals) != self.degree + 1:
                return False
            if not all(isinstance(g, Ext4) and g.is_scalar for g in evals):
                return False
            if evals[0] + evals[1] != claim:
                return False
            for g in evals:
                absorb_ext(transcript, g)
            r = challenge_ext(transcript)
            rs.append(r)
            claim = _interp_eval_ext(evals, r, p)

        if rs != proof.final_point:
            return False

        for name in sorted(proof.column_evals):
            val = proof.column_evals[name]
            if not (isinstance(val, Ext4) and val.is_scalar):
                return False
            absorb_ext(transcript, val)

        ev = dict(proof.column_evals)
        if self.public_evals is not None:
            ev.update(self.public_evals(rs))
        eq_r = eq_eval_ext(taus, rs, p)
        c_final = self.combiner(ev, alphas, p)
        return eq_r * c_final == claim
