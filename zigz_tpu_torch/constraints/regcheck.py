"""Register-file consistency: offline memory checking over the trace.

The reference constrains register dataflow only as metadata
("register_updates", builder.zig:77-149 TODO); protocol v2 proves it for
real with a Spice-style offline memory check (the standard zkVM read/
write-set argument) over the 32-cell register file:

* Every step performs THREE accesses, each modeled read-then-write:
    access 1 (ts 3i+1): read cell rs1(i)  -> value rv1, write rv1 back
    access 2 (ts 3i+2): read cell rs2(i)  -> value rv2, write rv2 back
    access 3 (ts 3i+3): read cell wr(i)   -> old value ov, write wv
  where wr is the trace's authoritative per-step write register
  (reg_write_idx — NOT always the decoded rd: ECALL_READ writes a0,
  state.py:_exec_system) and wv its post-step value (0 for x0 — the
  file hardwires it, state.py:_wr).
* Committed advice per step: the three cell indices, the four values
  (as 4 x 16-bit range-checked limbs each), and the three read
  timestamps (range-decomposed, with the lag ts_w - 1 - ts_r also
  range-decomposed so every read strictly precedes its write).  Write
  timestamps are the PUBLIC 3*idx+m — the verifier evaluates the idx
  MLE itself (poly/public_mles.py).
* logUp multiset equation (drawn after the advice commitment):

      RS + FINAL == WS + INIT          over tuples (cell, value, ts)

  fingerprinted as kappa = a + g*l0 + g^2*l1 + g^3*l2 + g^4*l3 + g^5*ts.
  INIT tuples are (r, initial_regs[r], 0) — public; FINAL tuples are
  (r, final_regs[r], final_ts[r]) with final_regs from PublicIO (public)
  and final_ts explicit in the proof, so the verifier computes both
  sums itself.  The committed sides live in inverse columns g_r*/g_w*
  whose hypercube sums are pinned by Ligero sum claims, and whose
  pointwise correctness (g * (tau - kappa) = sel over the real rows) is
  a zerocheck constraint.  Uniqueness of write timestamps + per-access
  read-before-write ordering then force every read to return the last
  written value (Blum et al.; Spice; Jolt's memory argument).

SOUNDNESS (round-3 hardening): tau_m, tau_r, and gamma are BabyBear^4
extension draws (core/ext4.py), so a forged multiset collides with
probability ~rows/p^4 ~ 2^-100 instead of the grindable ~2^-10 of the
round-2 base-field draws; the retry nonce is verifier-capped at
MAX_NONCE.  The inverse columns are extension-valued, committed as 4
base coordinate columns each ("g_r1#0".."gr_wv_3#3") and recombined
inside the shared combiner; their hypercube sums are Ext4 values whose
coordinates the Ligero sum claims pin individually.

Together with the public anchoring at BOTH ends (initial_regs, the
final_regs the verifier already checks against the VM claim), this makes
the committed rv/wv dataflow the unique register history consistent with
the public register state — the "register_updates" constraint, for real.

Range checks reuse the RANGE16 logUp pattern from lookups/validity.py
(multiplicity column over the 2^16 domain, closed-form key MLE); the
extension tau_r keeps every range denominator nonzero by construction
(high_coords_nonzero — the extension twin of the old tau_r >= 2^16
trick).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from ..core.ext4 import (
    MAX_NONCE,
    Ext4,
    challenge_ext,
    ext_from_coords,
    ext_lift,
    ext_stack,
    high_coords_nonzero,
)
from ..poly.public_mles import idx_eval, idx_table, le_indicator_eval, le_table
from ..proofs.zerocheck import (
    ZerocheckExtProver,
    ZerocheckExtVerifier,
    ZerocheckProof,
    absorb_ext,
    unified_dev_columns,
    unified_device,
)

__all__ = [
    "RegCheckProof",
    "RegCheckStandalone",
    "RegAccessColumns",
    "RegcheckArgument",
    "RegcheckVerify",
    "extract_access_columns",
    "prove_regcheck",
    "verify_regcheck",
    "REGCHECK_DEGREE",
]

_M16 = np.uint64(0xFFFF)

# (column, coefficient) pairs whose scaled values are RANGE16-checked.
# tl1/dl1 carry coefficient 16: 16*x < 2^16 bounds x < 2^12, so every
# reconstructed timestamp/lag is < 2^28.  That bound is deliberately
# tighter than "< p": a negative integer lag maps mod p into
# (p - 2^28, p), which is DISJOINT from the representable [0, 2^28)
# because p - 2^28 > 2^28 — so the decomposition constraint holds over
# the integers and rt <= ts_w - 1 is genuinely enforced (with p ~ 2^31
# and 2^30-bounded limbs the two windows would overlap).
_VALUE_COLS = tuple(f"{pre}_{k}" for pre in ("rv1", "rv2", "ov", "wv") for k in range(4))
_RANGED = tuple((c, 1) for c in _VALUE_COLS) + tuple(
    (f"{pre}{m}", coef) for m in (1, 2, 3)
    for pre, coef in (("tl0_", 1), ("tl1_", 16), ("dl0_", 1), ("dl1_", 16))
)

COLUMNS = (
    ("a1", "a2", "a3", "rt1", "rt2", "rt3")
    + _VALUE_COLS
    + tuple(f"{pre}{m}" for m in (1, 2, 3) for pre in ("tl0_", "tl1_", "dl0_", "dl1_"))
    # x0 hardwiring: z0 = 1[a3 == 0] via the inverse gadget ia3, and
    # z0 forces every cell-0 write value limb to 0 — without this, a
    # forged trace could transiently write x0 and have later reads
    # observe it (restoring 0 before the public final-state anchor).
    + ("z0", "ia3")
)
G_MEM = tuple(f"g_{side}{m}" for side in ("r", "w") for m in (1, 2, 3))
# RANGE16 fractions are committed MERGED, _RANGE_MERGE per advice column
# (round 4): gq_i = sum_{(c,coef) in group i} 1/(tau_r - coef*c), pinned
# per row by the degree-(k+1) constraint gq * prod_j d_j = sum_j
# prod_{l!=j} d_l (all denominators are nonzero by construction — tau_r
# has nonzero high coordinates and the keys are base-field — so gq is
# forced to the exact fraction sum; the grand range equation
# sum_i sum(gq_i) == h_sum is unchanged in value).  This quarters the
# committed range-advice data and the per-column sum claims.
_RANGE_MERGE = 4
_RANGE_GROUPS = tuple(
    tuple(_RANGED[i : i + _RANGE_MERGE])
    for i in range(0, len(_RANGED), _RANGE_MERGE)
)
G_RNG = tuple(f"gq{i}" for i in range(len(_RANGE_GROUPS)))
G_ALL = G_MEM + G_RNG
# logUp, ts-decomp, lag-decomp, x0 gadget (3 + 4 wv limbs), range groups.
NUM_CONSTRAINTS = 6 + 3 + 3 + 7 + len(_RANGE_GROUPS)
# deg(eq * C): the merged range constraint has degree 1 + _RANGE_MERGE.
REGCHECK_DEGREE = _RANGE_MERGE + 2


def _fraction_sum_parts(ds: List):
    """(prod_all, numerator) of sum_j 1/d_j = numerator / prod_all for
    k <= 4 denominators — shared by the advice builder and the combiner
    (which needs both as polynomial expressions in the columns)."""
    k = len(ds)
    if k == 1:
        return ds[0], 1
    if k == 2:
        return ds[0] * ds[1], ds[0] + ds[1]
    if k == 3:
        d01 = ds[0] * ds[1]
        return d01 * ds[2], (ds[0] + ds[1]) * ds[2] + d01
    d01 = ds[0] * ds[1]
    d23 = ds[2] * ds[3]
    return d01 * d23, (ds[0] + ds[1]) * d23 + (ds[2] + ds[3]) * d01


def g_coord_names(g_names) -> List[str]:
    """Committed coordinate-column names of extension inverse columns."""
    return [f"{g}#{e}" for g in g_names for e in range(4)]


def pack_g_coords(g_cols: Dict[str, Ext4]) -> Dict[str, np.ndarray]:
    return {f"{name}#{e}": g.c[e] for name, g in g_cols.items() for e in range(4)}


def g_eval_from_coords(evals: Dict[str, object], name: str) -> Ext4:
    return ext_from_coords([evals[f"{name}#{e}"] for e in range(4)])


def sum_claim_values(g_sums: Dict[str, Ext4], g_names) -> Dict[str, int]:
    """Per-coordinate-column hypercube sums for the Ligero sum claim."""
    return {f"{g}#{e}": int(g_sums[g].c[e]) for g in g_names for e in range(4)}


@dataclass
class RegAccessColumns:
    """Per-step access data (length n, unpadded, canonical uint64)."""

    cells: np.ndarray      # (3, n) rs1/rs2/rd indices
    values: np.ndarray     # (4, n) rv1/rv2/ov/wv as u64
    read_ts: np.ndarray    # (3, n)
    final_ts: List[int]    # per register, ts of last access (0 = untouched)


def extract_access_columns(rs1, rs2, rd, rv1, rv2, ov, wv) -> RegAccessColumns:
    """Derive read timestamps by replaying the deterministic access
    schedule (ts 3i+1, 3i+2, 3i+3), vectorized via a stable sort."""
    n = len(rs1)
    cells = np.stack([
        np.asarray(rs1, dtype=np.uint64),
        np.asarray(rs2, dtype=np.uint64),
        np.asarray(rd, dtype=np.uint64),
    ])
    values = np.stack([
        np.asarray(rv1, dtype=np.uint64),
        np.asarray(rv2, dtype=np.uint64),
        np.asarray(ov, dtype=np.uint64),
        np.asarray(wv, dtype=np.uint64),
    ])
    flat_cells = cells.T.reshape(-1)               # access order: step-major
    ts = np.arange(1, 3 * n + 1, dtype=np.uint64)
    order = np.argsort(flat_cells, kind="stable")  # groups cells, keeps ts order
    prev_ts = np.zeros(3 * n, dtype=np.uint64)
    same = flat_cells[order][1:] == flat_cells[order][:-1]
    prev_ts[order[1:]] = np.where(same, ts[order[:-1]], np.uint64(0))
    read_ts = prev_ts.reshape(n, 3).T
    final_ts = [0] * 32
    if n:
        last = np.zeros(32, dtype=np.uint64)
        np.maximum.at(last, flat_cells.astype(np.int64), ts)
        final_ts = [int(x) for x in last]
    return RegAccessColumns(cells=cells, values=values, read_ts=read_ts,
                            final_ts=final_ts)


# ---------------------------------------------------------------------------
# Proof structure


@dataclass
class RegCheckProof:
    """Round-3 slim form: the per-argument Ligero roots/openings moved to
    the shared unified commitment (prover/unified.py); what remains is
    the argument-specific transcript content."""

    nonce: int
    num_vars: int
    final_ts: List[int]          # 32 entries
    zc: ZerocheckProof           # trace-domain zerocheck
    zc_table: ZerocheckProof     # RANGE16-domain zerocheck
    g_sums: Dict[str, Ext4]      # per g column (mem + range), Ext4
    h_sum: Ext4


# ---------------------------------------------------------------------------
# Fingerprints and the shared (prover/verifier) combiner


def _gamma_powers(gamma: Ext4) -> List[Ext4]:
    gs = [ext_lift(1)]
    for _ in range(5):
        gs.append(gs[-1] * gamma)
    return gs


def _kappa_parts(m: int, side: str):
    """(addr_col, value_col_prefix) spec for access m and side r/w."""
    val_prefix = {1: "rv1", 2: "rv2", 3: ("ov" if side == "r" else "wv")}[m]
    return f"a{m}", val_prefix


def _make_combiner(tau_m: Ext4, tau_r: Ext4, gamma: Ext4, p: int):
    """One generic combiner: the prover passes (partially folded) columns
    plus the g coordinate tables; the verifier passes terminal Ext4
    evaluations plus public __sel__/__idx__ values."""
    gp = _gamma_powers(gamma)

    def combiner(cols, alphas: List, p_: int):
        one = 1
        sel = cols["__sel__"]
        idx = cols["__idx__"]
        terms = []
        for m in (1, 2, 3):
            for side in ("r", "w"):
                a_name, vpre = _kappa_parts(m, side)
                kappa = gp[0] * cols[a_name]
                for k in range(4):
                    kappa = kappa + gp[k + 1] * cols[f"{vpre}_{k}"]
                if side == "r":
                    ts = cols[f"rt{m}"]
                else:
                    ts = (3 * idx + m) % p
                kappa = kappa + gp[5] * ts
                g = g_eval_from_coords(cols, f"g_{side}{m}")
                terms.append(g * (tau_m - kappa) - sel)
        for m in (1, 2, 3):
            # rt = tl0 + 2^16 tl1  and  3 idx + m - 1 - rt = dl0 + 2^16 dl1.
            recon = (cols[f"tl0_{m}"] + (1 << 16) * cols[f"tl1_{m}"]) % p
            terms.append((cols[f"rt{m}"] + p - recon) % p)
            lag = (3 * idx + (m - 1)) % p
            recon_d = (cols[f"dl0_{m}"] + (1 << 16) * cols[f"dl1_{m}"]) % p
            terms.append((lag + p + p - cols[f"rt{m}"] - recon_d) % p)
        terms.append((cols["a3"] * cols["ia3"] % p + cols["z0"] + p - one) % p)
        terms.append(cols["z0"] * cols["a3"] % p)
        terms.append(cols["z0"] * ((one + p - cols["z0"]) % p) % p)
        for k in range(4):
            terms.append(cols["z0"] * cols[f"wv_{k}"] % p)
        for i, group in enumerate(_RANGE_GROUPS):
            ds = [tau_r - coef * cols[c] for c, coef in group]
            prod_all, num = _fraction_sum_parts(ds)
            gq = g_eval_from_coords(cols, f"gq{i}")
            terms.append(gq * prod_all - num)
        acc = alphas[0] * terms[0]
        for alpha, t in zip(alphas[1:], terms[1:]):
            acc = acc + alpha * t
        return acc

    return combiner


def _public_evals(num_steps: int, num_vars: int, p: int):
    def fn(rs):
        return {
            "__sel__": le_indicator_eval(num_steps - 1, num_vars, rs, p),
            "__idx__": idx_eval(num_vars, rs, p),
        }

    return fn


def _make_table_combiner(tau_r: Ext4):
    def combiner(cols, alphas: List, p: int):
        h = g_eval_from_coords(cols, "h")
        return alphas[0] * (h * (tau_r - cols["__key__"]) - cols["m"])

    return combiner


def _table_public_evals(p: int):
    def fn(rs):
        return {"__key__": idx_eval(16, rs, p)}

    return fn


def _boundary_sum(tau_m: Ext4, gamma: Ext4, regs: List[int], ts: List[int],
                  p: int) -> Optional[Ext4]:
    """sum_r 1/(tau - kappa(r, regs[r], ts[r])) — computed by BOTH sides,
    in the extension."""
    gp = _gamma_powers(gamma)
    kappas = []
    for r in range(32):
        v = regs[r] if r < len(regs) else 0
        kappa = ext_lift(r)
        for k in range(4):
            kappa = kappa + gp[k + 1] * ((v >> (16 * k)) & 0xFFFF)
        kappa = kappa + gp[5] * (ts[r] % p)
        kappas.append(kappa)
    d = tau_m - ext_stack(kappas)
    if np.any(d.is_zero()):
        return None  # nonce retry
    return d.inv().sum()


# ---------------------------------------------------------------------------
# Prover


def _limb(v: np.ndarray, k: int) -> np.ndarray:
    return (v >> np.uint64(16 * k)) & _M16


class RegcheckArgument:
    """Prover-side phased argument (prover/unified.py harness)."""

    ns = "rc"

    def __init__(self, F, access: RegAccessColumns, num_vars: int,
                 initial_regs: Optional[List[int]], final_regs: List[int],
                 forge_hook=None, unsafe_skip_self_checks=False):
        self.F = F
        self.access = access
        self.num_vars = num_vars
        self.init = list(initial_regs) if initial_regs is not None else [0] * 32
        self.final_regs = final_regs
        self._forge_hook = forge_hook
        self._unsafe = unsafe_skip_self_checks
        self.locmap = {}
        self.proof: Optional[RegCheckProof] = None

    def data_phase(self, transcript) -> Dict[str, np.ndarray]:
        F, access, num_vars = self.F, self.access, self.num_vars
        from ..poly.public_mles import np_inv

        p = F.MODULUS
        if p != 2013265921:
            raise ValueError("regcheck requires BabyBear (extension challenges)")
        n = access.cells.shape[1]
        padded = 1 << num_vars
        ts_w_max = 3 * padded + 3
        assert ts_w_max < (1 << 30), "trace too long for the 2-limb ts decomposition"

        cols: Dict[str, np.ndarray] = {}

        def _pad(a):
            b = np.zeros(padded, dtype=np.uint64)
            b[:n] = a
            return b

        for m in (1, 2, 3):
            cols[f"a{m}"] = _pad(access.cells[m - 1])
            cols[f"rt{m}"] = _pad(access.read_ts[m - 1])
        for j, pre in enumerate(("rv1", "rv2", "ov", "wv")):
            for k in range(4):
                cols[f"{pre}_{k}"] = _pad(_limb(access.values[j], k))
        idx = np.arange(padded, dtype=np.uint64)
        for m in (1, 2, 3):
            rt = cols[f"rt{m}"]
            cols[f"tl0_{m}"] = rt & _M16
            cols[f"tl1_{m}"] = rt >> np.uint64(16)
            lag = 3 * idx + np.uint64(m - 1) - rt  # >= 0 for honest advice
            cols[f"dl0_{m}"] = lag & _M16
            cols[f"dl1_{m}"] = lag >> np.uint64(16)
        # x0 hardwiring gadget: z0 = 1[a3 == 0] (padding rows are cell-0
        # zero-writes, so the global constraints hold there too).
        cols["z0"] = (cols["a3"] == 0).astype(np.uint64)
        cols["ia3"] = np_inv(cols["a3"], p)

        if self._forge_hook is not None:
            self._forge_hook(cols)

        # Multiplicities over RANGE16 for every ranged (scaled) column.
        m_col = np.zeros(1 << 16, dtype=np.uint64)
        for c, coef in _RANGED:
            scaled = np.uint64(coef) * cols[c]
            if np.any(scaled > _M16):
                if not self._unsafe:
                    raise AssertionError(f"regcheck violated: column {c} out of range")
                scaled = scaled & _M16
            m_col += np.bincount(scaled.astype(np.int64), minlength=1 << 16).astype(np.uint64)

        transcript.append_bytes(b"RC_BEGIN")
        transcript.append_u64(n)
        for r in range(32):
            transcript.append_u64(self.final_regs[r] if r < len(self.final_regs) else 0)
        for r in range(32):
            transcript.append_u64(access.final_ts[r])

        self.n = n
        self.idx = idx
        self.cols = cols
        self.m_col = m_col
        return {**cols, "m": m_col}

    def advice_phase(self, transcript) -> Dict[str, np.ndarray]:
        F, cols, idx = self.F, self.cols, self.idx
        p = F.MODULUS
        n, num_vars = self.n, self.num_vars
        sel = le_table(n - 1, num_vars)

        nonce = 0
        while True:
            trial = transcript.fork()
            trial.append_bytes(b"RC_CHAL")
            trial.append_u64(nonce)
            tau_m = challenge_ext(trial)
            tau_r = challenge_ext(trial)
            gamma = challenge_ext(trial)
            gp = _gamma_powers(gamma)
            # A tau_r with a nonzero high coordinate can never hit a lifted
            # base key, so the range/table denominators are nonzero for free.
            ok = high_coords_nonzero(tau_r)
            denoms: Dict[str, Ext4] = {}
            if ok:
                for m in (1, 2, 3):
                    for side in ("r", "w"):
                        a_name, vpre = _kappa_parts(m, side)
                        if side == "r":
                            ts = cols[f"rt{m}"]
                        else:
                            ts = (np.uint64(3) * idx + np.uint64(m)) % np.uint64(p)
                        from ..core.ext4 import ext_linear_comb

                        kappa = ext_linear_comb(
                            gp[:6],
                            [cols[a_name]] + [cols[f"{vpre}_{k}"] for k in range(4)]
                            + [ts],
                        )
                        d = tau_m - kappa
                        if np.any(d.is_zero() & (sel == 1)):
                            ok = False
                            break
                        denoms[f"g_{side}{m}"] = d
                    if not ok:
                        break
            init_sum = final_sum = None
            if ok:
                init_sum = _boundary_sum(tau_m, gamma, self.init, [0] * 32, p)
                final_sum = _boundary_sum(tau_m, gamma, self.final_regs,
                                          self.access.final_ts, p)
                ok = init_sum is not None and final_sum is not None
            if ok:
                break
            nonce += 1
            assert nonce <= MAX_NONCE, "regcheck nonce overflow"
        transcript.append_bytes(b"RC_CHAL")
        transcript.append_u64(nonce)
        assert challenge_ext(transcript) == tau_m
        assert challenge_ext(transcript) == tau_r
        assert challenge_ext(transcript) == gamma

        g_cols: Dict[str, Ext4] = {}
        for name, d in denoms.items():
            g_cols[name] = sel * d.inv()
        for i, group in enumerate(_RANGE_GROUPS):
            ds = [tau_r - np.uint64(coef) * cols[c] % np.uint64(p)
                  for c, coef in group]
            prod_all, num = _fraction_sum_parts(ds)
            g_cols[f"gq{i}"] = num * prod_all.inv()
        h_col = (tau_r - idx_table(16, p)).inv() * self.m_col

        g_sums = {name: col.sum() for name, col in g_cols.items()}
        h_sum = h_col.sum()
        transcript.append_bytes(b"RC_G")
        for name in sorted(g_sums):
            absorb_ext(transcript, g_sums[name])
        transcript.append_bytes(b"RC_H")
        absorb_ext(transcript, h_sum)

        if not self._unsafe:
            lhs = sum(g_sums[f"g_r{m}"] for m in (1, 2, 3)) + final_sum
            rhs = sum(g_sums[f"g_w{m}"] for m in (1, 2, 3)) + init_sum
            if lhs != rhs:
                raise AssertionError("regcheck violated: register multiset mismatch")
            rng_lhs = sum(g_sums[g] for g in G_RNG)
            if rng_lhs != h_sum:
                raise AssertionError("regcheck violated: range multiset mismatch")

        self.sel = sel
        self.tau_m, self.tau_r, self.gamma = tau_m, tau_r, gamma
        self.nonce = nonce
        self.g_cols = g_cols
        self.g_coords = pack_g_coords(g_cols)
        self.h_coords = pack_g_coords({"h": h_col})
        self.g_sums = g_sums
        self.h_sum = h_sum
        return {**self.g_coords, **self.h_coords}

    def zerocheck_phase(self, transcript, sink) -> None:
        F = self.F
        p = F.MODULUS
        all_cols = dict(self.cols)
        all_cols.update(self.g_coords)
        all_cols["__sel__"] = self.sel
        all_cols["__idx__"] = self.idx % np.uint64(p)
        zc = ZerocheckExtProver(
            F, all_cols, _make_combiner(self.tau_m, self.tau_r, self.gamma, p),
            REGCHECK_DEGREE, num_alphas=NUM_CONSTRAINTS,
            device=unified_device(self),
            dev_columns=unified_dev_columns(self, all_cols),
        ).prove(transcript)

        table_cols = {"m": self.m_col, "__key__": idx_table(16, p)}
        table_cols.update(self.h_coords)
        zc_t = ZerocheckExtProver(
            F, table_cols, _make_table_combiner(self.tau_r), REGCHECK_DEGREE,
            num_alphas=1,
            device=unified_device(self),
            dev_columns=unified_dev_columns(self, table_cols),
        ).prove(transcript)

        self.proof = RegCheckProof(
            nonce=self.nonce, num_vars=self.num_vars,
            final_ts=list(self.access.final_ts), zc=zc, zc_table=zc_t,
            g_sums=self.g_sums, h_sum=self.h_sum,
        )
        register_claims(self, sink, zc, zc_t, self.g_sums, self.h_sum)


def register_claims(arg, sink, zc, zc_table, g_sums, h_sum) -> None:
    """Shared prover/verifier claim schedule for the regcheck shape (one
    trace-domain zerocheck + one RANGE16 zerocheck + per-column sums)."""
    for name in sorted(zc.column_evals):
        ck, fn, v = arg.locmap[name]
        sink.eval_claim(ck, fn, v, zc.final_point, zc.column_evals[name])
    for name in sorted(zc_table.column_evals):
        ck, fn, v = arg.locmap[name]
        sink.eval_claim(ck, fn, v, zc_table.final_point, zc_table.column_evals[name])
    from ..core.ext4 import ext_lift

    for g in sorted(g_sums):
        for e in range(4):
            ck, fn, v = arg.locmap[f"{g}#{e}"]
            sink.sum_claim(ck, fn, v, ext_lift(int(g_sums[g].c[e])))
    for e in range(4):
        ck, fn, v = arg.locmap[f"h#{e}"]
        sink.sum_claim(ck, fn, v, ext_lift(int(h_sum.c[e])))


def prove_regcheck(F, transcript, access: RegAccessColumns, num_vars: int,
                   initial_regs: Optional[List[int]], final_regs: List[int],
                   hash_mode: str = "sha3", _forge_hook=None,
                   _unsafe_skip_self_checks=False, *, device) -> "RegCheckStandalone":
    """Standalone entry point: the phased argument under a private
    unified harness (its own data/advice commitments + batch opening)."""
    from ..prover.unified import prove_unified

    arg = RegcheckArgument(F, access, num_vars, initial_regs, final_regs,
                           forge_hook=_forge_hook,
                           unsafe_skip_self_checks=_unsafe_skip_self_checks)
    unified = prove_unified(F, transcript, [arg], hash_mode, device=device)
    return RegCheckStandalone(rc=arg.proof, unified=unified)


class RegCheckStandalone:
    """Wrapper pairing the argument subproof with its private unified
    commitment proof; forwards field access so callers (and tamper
    tests) treat it like the subproof itself."""

    def __init__(self, rc: RegCheckProof, unified):
        self.rc = rc
        self.unified = unified

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "rc"), name)

    @property
    def root_cols(self):
        return self.unified.data_root

    @root_cols.setter
    def root_cols(self, value):
        self.unified.data_root = value


# ---------------------------------------------------------------------------
# Verifier


class RegcheckVerify:
    """Verifier-side phased argument (prover/unified.py harness)."""

    ns = "rc"

    def __init__(self, F, rc: RegCheckProof, num_steps: int, num_vars: int,
                 initial_regs: Optional[List[int]], final_regs: List[int]):
        self.F = F
        self.rc = rc
        self.num_steps = num_steps
        self.num_vars = num_vars
        self.init = list(initial_regs) if initial_regs is not None else [0] * 32
        self.final_regs = final_regs
        self.locmap = {}

    def data_phase(self, transcript) -> Optional[Dict[str, int]]:
        rc = self.rc
        if not isinstance(rc, RegCheckProof):
            return None
        if rc.num_vars != self.num_vars or len(rc.final_ts) != 32:
            return None
        if not (0 <= rc.nonce <= MAX_NONCE):
            return None
        if any(not (0 <= t <= 3 * self.num_steps) for t in rc.final_ts):
            return None
        # x0 is architecturally zero at both public anchors (the committed
        # side is pinned by the z0 write gadget).
        if self.init[0] != 0 or (self.final_regs and self.final_regs[0] != 0):
            return None

        transcript.append_bytes(b"RC_BEGIN")
        transcript.append_u64(self.num_steps)
        for r in range(32):
            transcript.append_u64(self.final_regs[r] if r < len(self.final_regs) else 0)
        for r in range(32):
            transcript.append_u64(rc.final_ts[r])
        shape = {name: self.num_vars for name in COLUMNS}
        shape["m"] = 16
        return shape

    def advice_phase(self, transcript) -> Optional[Dict[str, int]]:
        rc = self.rc
        transcript.append_bytes(b"RC_CHAL")
        transcript.append_u64(rc.nonce)
        tau_m = challenge_ext(transcript)
        tau_r = challenge_ext(transcript)
        gamma = challenge_ext(transcript)
        if not high_coords_nonzero(tau_r):
            return None

        g_names = sorted(G_ALL)
        if set(rc.g_sums) != set(g_names):
            return None
        if not all(isinstance(v, Ext4) and v.is_scalar for v in rc.g_sums.values()):
            return None
        if not (isinstance(rc.h_sum, Ext4) and rc.h_sum.is_scalar):
            return None
        transcript.append_bytes(b"RC_G")
        for name in g_names:
            absorb_ext(transcript, rc.g_sums[name])
        transcript.append_bytes(b"RC_H")
        absorb_ext(transcript, rc.h_sum)

        # Grand equations: the register multiset and the range multiset.
        p = self.F.MODULUS
        init_sum = _boundary_sum(tau_m, gamma, self.init, [0] * 32, p)
        final_sum = _boundary_sum(tau_m, gamma, self.final_regs, rc.final_ts, p)
        if init_sum is None or final_sum is None:
            return None
        lhs = sum(rc.g_sums[f"g_r{m}"] for m in (1, 2, 3)) + final_sum
        rhs = sum(rc.g_sums[f"g_w{m}"] for m in (1, 2, 3)) + init_sum
        if lhs != rhs:
            return None
        if sum(rc.g_sums[g] for g in G_RNG) != rc.h_sum:
            return None

        self.tau_m, self.tau_r, self.gamma = tau_m, tau_r, gamma
        shape = {gc: self.num_vars for gc in g_coord_names(g_names)}
        for e in range(4):
            shape[f"h#{e}"] = 16
        return shape

    def zerocheck_phase(self, transcript, sink) -> bool:
        F, rc = self.F, self.rc
        p = F.MODULUS
        col_names = sorted(COLUMNS)
        gc_names = sorted(g_coord_names(sorted(G_ALL)))
        if set(rc.zc.column_evals) != set(col_names) | set(gc_names):
            return False
        if rc.zc.num_vars != self.num_vars or rc.zc.degree != REGCHECK_DEGREE:
            return False
        if not ZerocheckExtVerifier(
            F, _make_combiner(self.tau_m, self.tau_r, self.gamma, p),
            NUM_CONSTRAINTS, REGCHECK_DEGREE,
            public_evals=_public_evals(self.num_steps, self.num_vars, p),
        ).verify(rc.zc, transcript):
            return False

        hc_names = sorted(g_coord_names(["h"]))
        if set(rc.zc_table.column_evals) != {"m"} | set(hc_names):
            return False
        if rc.zc_table.num_vars != 16 or rc.zc_table.degree != REGCHECK_DEGREE:
            return False
        if not ZerocheckExtVerifier(
            F, _make_table_combiner(self.tau_r), 1, REGCHECK_DEGREE,
            public_evals=_table_public_evals(p),
        ).verify(rc.zc_table, transcript):
            return False

        register_claims(self, sink, rc.zc, rc.zc_table, rc.g_sums, rc.h_sum)
        return True


def verify_regcheck(F, transcript, proof: "RegCheckStandalone", num_steps: int,
                    num_vars: int, initial_regs: Optional[List[int]],
                    final_regs: List[int], hash_mode: str = "sha3") -> bool:
    from ..prover.unified import verify_unified

    arg = RegcheckVerify(F, proof.rc, num_steps, num_vars, initial_regs,
                         final_regs)
    return verify_unified(F, transcript, [arg], proof.unified, hash_mode) is None
