"""Core v2 argument: execution constraints + PC-chain logUp, phased.

This is the v2 constraint set of constraints/v2.py (c1-c6) packaged as a
prover/unified.py Argument, sharing the unified data/advice commitments
with the lookup-validity / regcheck / memcheck / bytecode arguments:

* DATA    — the five zerocheck columns (x0, is_read, pc, seq, next_pc);
            under protocol v4 additionally ALL 43 witness MLEs (names
            ``w:{poly}``), replacing the v1-style Merkle forest +
            point-to-index openings entirely.
* ADVICE  — the PC-chain logUp inverse columns g1/g2 (BabyBear^4,
            committed as coordinate columns) with the shared sum
            absorbed ("V2_LOGUP_NONCE" nonce + "V2_LOGUP_SUM").
* ZEROCHECK — the 6-constraint extension zerocheck; claims for every
            column at its terminal point, per-coordinate sum claims for
            g1/g2 (both pinned to the shared logup_sum), and — under
            v4 — the 43 witness evaluations at the same point, absorbed
            as "V4_WITNESS_EVALS" and cross-checked against the
            overlapping zerocheck columns (pc / x0 / mem_is_read).

Reference anchors: prover.zig:250-288 (the placeholder this replaces),
builder.zig:77-149 (the constraint metadata proven for real here).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..core.ext4 import MAX_NONCE, Ext4, challenge_ext, ext_lift
from ..proofs.zerocheck import (
    ZerocheckExtProver,
    ZerocheckExtVerifier,
    ZerocheckProof,
    _eq_table_ext,
    absorb_ext,
    unified_dev_columns,
    unified_device,
)
from . import v2 as v2mod
from .v2 import (
    NUM_V2_ALPHAS,
    V2_DEGREE,
    V2_G_COLUMNS,
    logup_public_tables,
    make_v2_combiner,
    v2_columns,
    v2_public_evals,
)

__all__ = ["CoreV2Argument", "CoreV2Verify", "CORE_COLUMNS"]

CORE_COLUMNS = ("is_read", "next_pc", "pc", "seq", "x0")


class CoreV2Argument:
    ns = "v2"

    def __init__(self, F, witness, trace, protocol_version: int = 2):
        self.F = F
        self.witness = witness
        self.trace = trace
        self.protocol_version = protocol_version
        self.locmap = {}
        self.zc: Optional[ZerocheckProof] = None
        self.logup_nonce = 0
        self.logup_sum: Optional[Ext4] = None
        self.witness_evals: Optional[Dict[str, Ext4]] = None

    def data_phase(self, transcript) -> Dict[str, np.ndarray]:
        F, witness = self.F, self.witness
        if F.MODULUS != 2013265921:
            raise ValueError(
                f"protocol_version>=2 is BabyBear-only (got modulus "
                f"{F.MODULUS}); use protocol_version=1 for this field"
            )
        num_vars = witness.num_vars
        transcript.append_bytes(b"SUMCHECK_BEGIN")
        transcript.append_field_element(F, F(witness.num_steps))
        transcript.append_field_element(F, F(num_vars))

        # Late-bound through the module so tests can monkeypatch the
        # builders (forged-trace adversarial suites).
        aux = v2mod.build_aux_columns(self.trace, num_vars, F.MODULUS)
        self.columns = v2_columns(witness, aux)
        out = dict(self.columns)
        if self.protocol_version >= 4:
            from .witness import WITNESS_POLY_NAMES

            mat = witness.matrix
            self.wit_cols = {name: mat[i]
                             for i, name in enumerate(WITNESS_POLY_NAMES)}
            for name, col in self.wit_cols.items():
                out[f"w:{name}"] = col
        return out

    def advice_phase(self, transcript) -> Dict[str, np.ndarray]:
        F = self.F
        p = F.MODULUS
        witness = self.witness
        num_vars, num_steps = witness.num_vars, witness.num_steps
        # tau/beta are BabyBear^4 extension draws AFTER the pc/next_pc data
        # is bound (unified data root); the nonce keeps the draw retryable
        # on a zero fingerprint denominator (~2n/p^4 per attempt — honest
        # provers land on nonce 0; the verifier caps it at MAX_NONCE).
        nonce = 0
        while True:
            trial = transcript.fork()
            trial.append_bytes(b"V2_LOGUP_NONCE")
            trial.append_u64(nonce)
            tau_lu = challenge_ext(trial)
            beta_lu = challenge_ext(trial)
            logup = v2mod.build_logup_columns(
                self.columns["pc"], self.columns["next_pc"], num_steps,
                num_vars, tau_lu, beta_lu, p,
            )
            if logup is not None:
                break
            nonce += 1
            assert nonce <= MAX_NONCE, "logUp nonce overflow (VM bug?)"
        transcript.append_bytes(b"V2_LOGUP_NONCE")
        transcript.append_u64(nonce)
        assert challenge_ext(transcript) == tau_lu
        assert challenge_ext(transcript) == beta_lu
        g1, g2, logup_sum = logup
        transcript.append_bytes(b"V2_LOGUP_SUM")
        absorb_ext(transcript, logup_sum)

        self.tau_lu, self.beta_lu = tau_lu, beta_lu
        self.logup_nonce = nonce
        self.logup_sum = logup_sum
        self.g_coords = {f"g{i}#{e}": g.c[e] for i, g in ((1, g1), (2, g2))
                         for e in range(4)}
        return dict(self.g_coords)

    def zerocheck_phase(self, transcript, sink) -> None:
        F, witness = self.F, self.witness
        p = F.MODULUS
        num_vars, num_steps = witness.num_vars, witness.num_steps
        columns = dict(self.columns)
        columns.update(self.g_coords)
        columns.update(logup_public_tables(num_steps, num_vars, p))
        zc = ZerocheckExtProver(
            F, columns, make_v2_combiner(self.tau_lu, self.beta_lu),
            V2_DEGREE, num_alphas=NUM_V2_ALPHAS,
            device=unified_device(self),
            dev_columns=unified_dev_columns(self, columns),
        ).prove(transcript)
        self.zc = zc

        for name in sorted(zc.column_evals):
            ck, fn, v = self.locmap[name]
            sink.eval_claim(ck, fn, v, zc.final_point, zc.column_evals[name])
        for g in ("g1", "g2"):
            for e in range(4):
                ck, fn, v = self.locmap[f"{g}#{e}"]
                sink.sum_claim(ck, fn, v, ext_lift(int(self.logup_sum.c[e])))

        if self.protocol_version >= 4:
            # v4: witness evaluations at the zerocheck terminal point —
            # absorbed, cross-checked against the overlapping zerocheck
            # columns by the verifier, and PCS-bound via the unified
            # opening (each one becomes a claim below).
            eq = _eq_table_ext(zc.final_point, p)
            wev: Dict[str, Ext4] = {}
            for name in sorted(self.wit_cols):
                wev[name] = (eq * (self.wit_cols[name] % np.uint64(p))).sum()
            transcript.append_bytes(b"V4_WITNESS_EVALS")
            for name in sorted(wev):
                absorb_ext(transcript, wev[name])
            for name in sorted(wev):
                ck, fn, v = self.locmap[f"w:{name}"]
                sink.eval_claim(ck, fn, v, zc.final_point, wev[name])
            self.witness_evals = wev


class CoreV2Verify:
    ns = "v2"

    def __init__(self, F, v2_section, num_steps: int, num_vars: int,
                 protocol_version: int = 2):
        self.F = F
        self.v2 = v2_section
        self.num_steps = num_steps
        self.num_vars = num_vars
        self.protocol_version = protocol_version
        self.locmap = {}

    def data_phase(self, transcript) -> Optional[Dict[str, int]]:
        F = self.F
        transcript.append_bytes(b"SUMCHECK_BEGIN")
        transcript.append_field_element(F, F(self.num_steps))
        transcript.append_field_element(F, F(self.num_vars))
        shape = {name: self.num_vars for name in CORE_COLUMNS}
        if self.protocol_version >= 4:
            from .witness import WITNESS_POLY_NAMES

            for name in WITNESS_POLY_NAMES:
                shape[f"w:{name}"] = self.num_vars
        return shape

    def advice_phase(self, transcript) -> Optional[Dict[str, int]]:
        v2 = self.v2
        if not (0 <= v2.logup_nonce <= MAX_NONCE):
            return None
        if not (isinstance(v2.logup_sum, Ext4) and v2.logup_sum.is_scalar):
            return None
        transcript.append_bytes(b"V2_LOGUP_NONCE")
        transcript.append_u64(v2.logup_nonce)
        self.tau_lu = challenge_ext(transcript)
        self.beta_lu = challenge_ext(transcript)
        transcript.append_bytes(b"V2_LOGUP_SUM")
        absorb_ext(transcript, v2.logup_sum)
        return {name: self.num_vars for name in V2_G_COLUMNS}

    def zerocheck_phase(self, transcript, sink) -> bool:
        F, v2 = self.F, self.v2
        p = F.MODULUS
        zc = v2.zerocheck
        if zc is None or zc.num_vars != self.num_vars or zc.degree != V2_DEGREE:
            return False
        required = set(CORE_COLUMNS) | set(V2_G_COLUMNS)
        if set(zc.column_evals) != required:
            return False
        if not ZerocheckExtVerifier(
            F, make_v2_combiner(self.tau_lu, self.beta_lu), NUM_V2_ALPHAS,
            V2_DEGREE,
            public_evals=v2_public_evals(self.num_steps, self.num_vars, p),
        ).verify(zc, transcript):
            return False

        for name in sorted(zc.column_evals):
            ck, fn, v = self.locmap[name]
            sink.eval_claim(ck, fn, v, zc.final_point, zc.column_evals[name])
        for g in ("g1", "g2"):
            for e in range(4):
                ck, fn, v = self.locmap[f"{g}#{e}"]
                sink.sum_claim(ck, fn, v, ext_lift(int(v2.logup_sum.c[e])))

        if self.protocol_version >= 4:
            from .witness import WITNESS_POLY_NAMES

            wit_names = sorted(WITNESS_POLY_NAMES)
            wev = v2.witness_evals
            if wev is None or set(wev) != set(wit_names):
                return False
            if not all(isinstance(x, Ext4) and x.is_scalar for x in wev.values()):
                return False
            cev = zc.column_evals
            # The witness commitment and the core columns must describe
            # ONE witness: the overlapping evals agree.
            if (wev["pc"] != cev["pc"] or wev["x0"] != cev["x0"]
                    or wev["mem_is_read"] != cev["is_read"]):
                return False
            transcript.append_bytes(b"V4_WITNESS_EVALS")
            for name in wit_names:
                absorb_ext(transcript, wev[name])
            for name in wit_names:
                ck, fn, v = self.locmap[f"w:{name}"]
                sink.eval_claim(ck, fn, v, zc.final_point, wev[name])
        return True
