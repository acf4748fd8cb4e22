"""Proof verifier — exact transcript replay semantics.

Reference: zigz src/verifier/verifier.zig.  The verifier's
transcript schedule intentionally differs from the prover's (it binds
"SUMCHECK_BEGIN"+F(num_vars) only, squeezes challenges WITHOUT absorbing the
round coefficients, and absorbs the per-round evaluation instead,
:182-238); it never compares its challenges with the proof's, so the
checks that actually bite are:

* SHA-256(program) == proof.program_hash, else ProgramHashMismatch (:100-107);
* round-0 g(0)+g(1) == claimed_sum, where claimed_sum is taken from
  proof.final_eval (:190-214) — all-zero placeholder rounds pass with 0;
* per-opening: claim == proof.value AND the Merkle path verifies (:269-294).

Soundness of the v1 scheme rests on transcript divergence + Merkle binding
(SURVEY.md §2.9); the real constraint verifier is the v2 protocol in
zigz_tpu/proofs/.  Replicated bit-for-bit so both stacks accept each
other's proofs.
"""

from __future__ import annotations

from ..commitments.commit import CommitmentScheme, PolynomialCommitment
from ..core.hash import FiatShamirTranscript, sha256
from ..prover.proof import (
    PipelineLassoProof,
    PipelineSumcheckProof,
    Proof,
    PublicIO,
    VerificationResult,
)

__all__ = ["Verifier", "ProgramHashMismatch"]


class ProgramHashMismatch(Exception):
    pass


class Verifier:
    """Verifier(F) twin (verifier.zig:26-301)."""

    def __init__(self, F):
        self.F = F
        self.transcript = FiatShamirTranscript()

    def verify(self, proof: Proof, program: bytes) -> str:
        if proof.metadata.version in (3, 4):
            raise NotImplementedError(
                f"protocol v{proof.metadata.version} is not ported yet (Poseidon2 "
                "commitments, the Ligero witness PCS): v1 and v2 only"
            )
        if proof.metadata.version == 2:
            return self.verify_v2(proof, program)

        # Fresh transcript (verifier.zig:55).
        self.transcript = FiatShamirTranscript()

        # PHASE 1: public inputs (must match prover order).
        self._bind_public_inputs(proof.public_io, program)

        # PHASE 2: commitment roots.
        self._bind_polynomial_commitments(proof.witness_commitments)

        # PHASE 3: burn opening-point challenges + bind claims (Jolt pull request 981).
        self._derive_and_bind_opening_claims(proof.witness_commitments)

        # PHASE 4: constraint sumcheck.
        if self._verify_sumcheck_proof(proof.constraint_proof) != VerificationResult.Accept:
            return VerificationResult.RejectInvalidSumcheck

        # PHASE 5: Lasso proofs.
        from ..prover.proof import CompactLassoList

        if isinstance(proof.lookup_proofs, CompactLassoList):
            self._verify_lasso_proofs_compact(proof.lookup_proofs)
        else:
            for lasso in proof.lookup_proofs:
                if self._verify_lasso_proof(lasso) != VerificationResult.Accept:
                    return VerificationResult.RejectInvalidLookup

        # PHASE 6: openings.
        for opening in proof.witness_commitments:
            if self._verify_opening(opening) != VerificationResult.Accept:
                return VerificationResult.RejectInvalidCommitment

        return VerificationResult.Accept

    # ------------------------------------------------------------------
    def verify_v2(self, proof: Proof, program: bytes) -> str:
        """Protocol v2+ (round 3): replay the unified argument pipeline —
        per-argument public blocks, the two mixed Ligero roots, the
        per-argument challenge draws and logUp sums, the zerochecks, the
        batch-evaluation reduction, and the two openings — then the
        pipeline Lasso sumchecks and (v2/v3) the v1-style witness forest
        checks.

        Version 3 is the same protocol with Poseidon2-over-BabyBear as the
        Merkle hasher (commitment forests + Ligero column hashing; the
        Fiat-Shamir transcript stays SHA3)."""
        from ..commitments.merkle import SimpleMerkleTree, hasher_for_mode
        from ..constraints.bytecode import BytecodeVerify
        from ..constraints.core_arg import CoreV2Verify
        from ..constraints.memcheck import MemcheckVerify, initial_memory_map
        from ..constraints.regcheck import RegcheckVerify
        from ..lookups.validity import LookupValidityProof, ValidityVerify
        from ..prover.unified import verify_unified

        hasher = hasher_for_mode(
            "poseidon2" if proof.metadata.version == 3 else "sha3"
        )
        hash_mode = "poseidon2" if proof.metadata.version == 3 else "sha3"

        F = self.F
        if proof.v2 is None:
            return VerificationResult.RejectInvalidSumcheck
        self.transcript = FiatShamirTranscript()
        transcript = self.transcript

        # Public inputs (prover order).
        self._bind_public_inputs(proof.public_io, program)

        io = proof.public_io
        num_steps = proof.metadata.num_steps
        num_vars = proof.metadata.num_vars
        if proof.v2.zerocheck is None:
            return VerificationResult.RejectInvalidSumcheck
        if proof.v2.column_evals is not proof.v2.zerocheck.column_evals:
            if proof.v2.column_evals != proof.v2.zerocheck.column_evals:
                return VerificationResult.RejectInvalidSumcheck

        core = CoreV2Verify(F, proof.v2, num_steps, num_vars,
                            proof.metadata.version)
        lasso_counts = {l.table_id: l.num_lookups for l in proof.lookup_proofs}
        lv = proof.v2.lookup_validity
        if lv is None:
            lv = LookupValidityProof(nonce=0, tables=[], table_side=None)
        validity = ValidityVerify(F, lv, lasso_counts)
        reg = RegcheckVerify(F, proof.v2.regcheck, num_steps, num_vars,
                             io.initial_regs, io.final_regs or [0] * 32)
        init_mem = initial_memory_map(program, io.initial_pc)
        mem = MemcheckVerify(F, proof.v2.memcheck, num_steps, init_mem)
        bc = BytecodeVerify(F, proof.v2.bytecode, program, io.initial_pc,
                            num_steps, num_vars, reg, core, validity, mem,
                            outputs=io.outputs, final_pc=io.final_pc)

        failed = verify_unified(F, transcript, [core, validity, reg, mem, bc],
                                proof.v2.unified, hash_mode)
        if failed is not None:
            return {
                "v2": VerificationResult.RejectInvalidSumcheck,
                "lv": VerificationResult.RejectInvalidLookup,
                "rc": VerificationResult.RejectInvalidRegisterAccess,
                "mc": VerificationResult.RejectInvalidMemoryAccess,
                "bc": VerificationResult.RejectInvalidBytecode,
            }.get(failed, VerificationResult.RejectInvalidCommitment)

        # Lasso phase: real per-table sumchecks (lookups/pipeline_lasso.py).
        from ..lookups.pipeline_lasso import verify_pipeline_lasso

        transcript.append_bytes(b"LASSO_BEGIN")
        if not verify_pipeline_lasso(
            F, transcript, proof.lookup_proofs, proof.v2.lasso_extras or {}
        ):
            return VerificationResult.RejectInvalidLookup
        if proof.metadata.version < 4:
            # Commitment phase: bind roots, re-derive points, CHECK them.
            # (v4 has no per-column Merkle forest — the Ligero witness PCS
            # above replaces this phase entirely.)
            if len(proof.witness_commitments) != 43:
                return VerificationResult.RejectInvalidCommitment
            transcript.append_bytes(b"POLY_COMMITMENTS")
            for c in proof.witness_commitments:
                transcript.append_bytes(c.commitment)
            for c in proof.witness_commitments:
                point = [transcript.challenge(F) for _ in range(num_vars)]
                # v2 tightening: the proof's point and opened index must
                # match the re-derived challenges (v1 never checks these).
                if [x.value for x in c.point] != [x.value for x in point]:
                    return VerificationResult.RejectInvalidCommitment
                expected_index = point[0].value % (1 << num_vars) if num_vars else 0
                if c.proof.merkle_proof.index != expected_index:
                    return VerificationResult.RejectInvalidCommitment
            transcript.append_bytes(b"OPENING_CLAIMS")
            for c in proof.witness_commitments:
                transcript.append_field_element(F, c.value)

            # Opening checks — v2 tightening: the Merkle walk derives
            # direction bits from the CHECKED index and requires a
            # full-height path (merkle.verify_at_index), so proof-supplied
            # directions cannot authenticate a different leaf.
            for opening in proof.witness_commitments:
                if not opening.value.eql(opening.proof.value):
                    return VerificationResult.RejectInvalidCommitment
                if not SimpleMerkleTree.verify_at_index(
                    F, opening.commitment, opening.proof.merkle_proof, num_vars,
                    hasher=hasher,
                ):
                    return VerificationResult.RejectInvalidCommitment

        return VerificationResult.Accept

    def _bind_public_inputs(self, public_io: PublicIO, program: bytes) -> None:
        """verifier.zig:95-122."""
        F = self.F
        program_hash = sha256(program)
        if program_hash != public_io.program_hash:
            raise ProgramHashMismatch()
        self.transcript.append_bytes(program_hash)
        self.transcript.append_field_element(F, F(public_io.initial_pc))
        if public_io.initial_regs:
            for reg_val in public_io.initial_regs:
                self.transcript.append_field_element(F, F(reg_val))

    def _bind_polynomial_commitments(self, commitments) -> None:
        """verifier.zig:126-137."""
        self.transcript.append_bytes(b"POLY_COMMITMENTS")
        for c in commitments:
            self.transcript.append_bytes(c.commitment)

    def _derive_and_bind_opening_claims(self, commitments) -> None:
        """verifier.zig:146-179 — burn 43*v challenges, then bind claims."""
        F = self.F
        for c in commitments:
            for _ in c.point:
                self.transcript.challenge(F)
        self.transcript.append_bytes(b"OPENING_CLAIMS")
        for c in commitments:
            self.transcript.append_field_element(F, c.value)

    def _verify_sumcheck_proof(self, sc: PipelineSumcheckProof) -> str:
        """verifier.zig:182-238 — round-0 check vs proof.final_eval;
        challenge + per-round eval absorbed (NOT the coefficients)."""
        F = self.F
        self.transcript.append_bytes(b"SUMCHECK_BEGIN")
        self.transcript.append_field_element(F, F(sc.num_vars))

        claimed_sum = sc.final_eval

        for rnd, round_poly in enumerate(sc.round_polynomials):
            g0 = round_poly[0]
            g1 = F.zero()
            for coeff in round_poly:
                g1 = g1.add(coeff)

            if rnd == 0:
                if not g0.add(g1).eql(claimed_sum):
                    return VerificationResult.RejectInvalidSumcheck

            challenge = self.transcript.challenge(F)

            ev = F.zero()
            power = F.one()
            for coeff in round_poly:
                ev = ev.add(coeff.mul(power))
                power = power.mul(challenge)
            self.transcript.append_field_element(F, ev)

        return VerificationResult.Accept

    def _verify_lasso_proof(self, lasso: PipelineLassoProof) -> str:
        """verifier.zig:240-267."""
        F = self.F
        self.transcript.append_bytes(b"LASSO_BEGIN")
        self.transcript.append_bytes(b"LASSO_TABLE")
        self.transcript.append_field_element(F, F(lasso.table_id))

        if self._verify_sumcheck_proof(lasso.multiset_proof) != VerificationResult.Accept:
            return VerificationResult.RejectInvalidLookup

        if lasso.subtable_proofs:
            for sub in lasso.subtable_proofs:
                if self._verify_sumcheck_proof(sub) != VerificationResult.Accept:
                    return VerificationResult.RejectInvalidLookup

        return VerificationResult.Accept

    def _verify_lasso_proofs_compact(self, proofs) -> None:
        """Batched transcript absorption for uniform filler proofs.

        Per proof the verifier absorbs "LASSO_BEGIN" + "LASSO_TABLE" +
        LE64(table_id mod p) + "SUMCHECK_BEGIN" + LE64(0) and runs zero
        rounds (always Accept) — one update() replaces len(proofs) Python
        iterations, byte-identical to the slow path (verifier.zig:240-267
        semantics preserved)."""
        import numpy as np

        n = len(proofs)
        if n == 0:
            return
        F = self.F
        head = b"LASSO_BEGINLASSO_TABLE"
        tail = b"SUMCHECK_BEGIN" + b"\x00" * 8
        stride = len(head) + 8 + len(tail)
        ids = np.arange(n, dtype=np.uint64) % np.uint64(F.MODULUS)
        stream = np.empty((n, stride), dtype=np.uint8)
        stream[:, : len(head)] = np.frombuffer(head, dtype=np.uint8)
        stream[:, len(head) : len(head) + 8] = np.frombuffer(
            np.ascontiguousarray(ids, dtype="<u8").tobytes(), dtype=np.uint8
        ).reshape(n, 8)
        stream[:, len(head) + 8 :] = np.frombuffer(tail, dtype=np.uint8)
        self.transcript.append_bytes(stream.tobytes())

    def _verify_opening(self, opening) -> str:
        """verifier.zig:269-294."""
        if not opening.value.eql(opening.proof.value):
            return VerificationResult.RejectInvalidCommitment
        poly_commit = PolynomialCommitment(opening.commitment, len(opening.point))
        if not CommitmentScheme.verify(self.F, poly_commit, opening.proof):
            return VerificationResult.RejectInvalidCommitment
        return VerificationResult.Accept
