"""The sumcheck protocol: proof structure, prover, verifier.

Reference: zigz src/proofs/{sumcheck_protocol,sumcheck_prover,
sumcheck_verifier}.zig.  This is the *real* protocol used by the standalone
examples and the Lasso module (the v1 pipeline's constraint sumcheck is a
structural placeholder — see prover/prover.py).

Semantics mirrored exactly:

* round polynomials are [g(0), g(1)-g(0)] coefficient pairs from the
  half-split (MSB) convention (multilinear.zig:205-232);
* ``SumcheckState`` owns a FRESH Fiat-Shamir transcript
  (sumcheck_protocol.zig:149-163); ``generate_challenge`` absorbs the round
  coefficients then squeezes (:176-184);
* the verifier checks g(0)+g(1) == claim each round, folds the claim through
  g(challenge), and finally calls the oracle at ``final_point``
  (sumcheck_verifier.zig:48-108).  NOTE (inherited quirk): the oracle is
  ``Multilinear.eval`` whose point ordering is the reverse of the fold
  ordering, so the full-oracle check only passes for bit-reversal-symmetric
  polynomials; ``verify_rounds`` (used by Lasso) has no oracle and is always
  consistent.  Both behaviors are preserved bit-for-bit.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import List

from ..core.hash import FiatShamirTranscript
from ..poly.multilinear import Multilinear
from ..poly.univariate import eval_univariate_coeffs

__all__ = [
    "SumcheckProof",
    "SumcheckState",
    "SumcheckProver",
    "SumcheckVerifier",
    "VerificationResult",
    "eval_univariate_coeffs",
]


@dataclass
class SumcheckProof:
    """sumcheck_protocol.zig:24-108 (degree-1 rounds: [a0, a1] pairs)."""

    round_polynomials: List[List[object]]
    final_point: List[object]
    final_eval: object
    num_vars: int

    def to_bytes(self) -> bytes:
        """sumcheck_protocol.zig:76-107 — u64 LE concatenation."""
        out = bytearray()
        out += self.num_vars.to_bytes(8, "little")
        for poly in self.round_polynomials:
            for coeff in poly:
                out += coeff.to_bytes()
        for el in self.final_point:
            out += el.to_bytes()
        out += self.final_eval.to_bytes()
        return bytes(out)


@dataclass
class SumcheckState:
    """Round/claim/challenge tracker with its own transcript
    (sumcheck_protocol.zig:128-192)."""

    num_rounds: int
    current_claim: object
    current_round: int = 0
    challenges: List[object] = dc_field(default_factory=list)
    transcript: FiatShamirTranscript = dc_field(default_factory=FiatShamirTranscript)

    def is_complete(self) -> bool:
        return self.current_round >= self.num_rounds

    def generate_challenge(self, F, round_poly):
        for coeff in round_poly:
            self.transcript.append_field_element(F, coeff)
        return self.transcript.challenge(F)

    def advance(self, challenge, new_claim) -> None:
        self.challenges.append(challenge)
        self.current_claim = new_claim
        self.current_round += 1


class SumcheckProver:
    """sumcheck_prover.zig:16-145."""

    @staticmethod
    def prove(poly: Multilinear) -> SumcheckProof:
        if poly.num_vars == 0:
            raise ValueError("NoVariables")
        F = poly.F
        claimed_sum = poly.sum_over_hypercube()
        state = SumcheckState(num_rounds=poly.num_vars, current_claim=claimed_sum)

        current = poly
        round_polys: List[List[object]] = []
        for _ in range(poly.num_vars):
            coeffs = current.round_polynomial()
            round_polys.append(coeffs)
            challenge = state.generate_challenge(F, coeffs)
            eval_at_challenge = eval_univariate_coeffs(F, coeffs, challenge)
            state.advance(challenge, eval_at_challenge)
            current = current.partial_eval(challenge)

        assert current.num_vars == 0, "ProtocolError"
        return SumcheckProof(
            round_polynomials=round_polys,
            final_point=list(state.challenges),
            final_eval=current.element(0),
            num_vars=poly.num_vars,
        )

    @staticmethod
    def prove_interactive(poly: Multilinear, challenges) -> SumcheckProof:
        if poly.num_vars == 0:
            raise ValueError("NoVariables")
        if len(challenges) != poly.num_vars:
            raise ValueError("WrongNumberOfChallenges")
        current = poly
        round_polys = []
        for r in challenges:
            round_polys.append(current.round_polynomial())
            current = current.partial_eval(r)
        return SumcheckProof(
            round_polynomials=round_polys,
            final_point=list(challenges),
            final_eval=current.element(0),
            num_vars=poly.num_vars,
        )


@dataclass
class VerificationResult:
    is_valid: bool
    final_point: List[object]
    expected_eval: object
    claimed_eval: object


class SumcheckVerifier:
    """sumcheck_verifier.zig:19-206."""

    @staticmethod
    def verify(F, proof: SumcheckProof, claimed_sum, oracle) -> VerificationResult:
        if proof.num_vars == 0:
            raise ValueError("NoVariables")
        state = SumcheckState(num_rounds=proof.num_vars, current_claim=claimed_sum)

        for round_poly in proof.round_polynomials:
            g0 = eval_univariate_coeffs(F, round_poly, F.zero())
            g1 = eval_univariate_coeffs(F, round_poly, F.one())
            total = g0.add(g1)
            if not total.eql(state.current_claim):
                return VerificationResult(False, proof.final_point, state.current_claim, total)
            challenge = state.generate_challenge(F, round_poly)
            state.advance(challenge, eval_univariate_coeffs(F, round_poly, challenge))

        oracle_eval = oracle(proof.final_point)
        matches = oracle_eval.eql(state.current_claim) and oracle_eval.eql(proof.final_eval)
        return VerificationResult(matches, proof.final_point, state.current_claim, proof.final_eval)

    @staticmethod
    def verify_interactive(F, proof: SumcheckProof, claimed_sum, challenges, oracle) -> VerificationResult:
        if proof.num_vars == 0:
            raise ValueError("NoVariables")
        if len(challenges) != proof.num_vars:
            raise ValueError("WrongNumberOfChallenges")
        current_claim = claimed_sum
        for round_poly, challenge in zip(proof.round_polynomials, challenges):
            g0 = eval_univariate_coeffs(F, round_poly, F.zero())
            g1 = eval_univariate_coeffs(F, round_poly, F.one())
            total = g0.add(g1)
            if not total.eql(current_claim):
                return VerificationResult(False, proof.final_point, current_claim, total)
            current_claim = eval_univariate_coeffs(F, round_poly, challenge)
        oracle_eval = oracle(proof.final_point)
        matches = oracle_eval.eql(current_claim) and oracle_eval.eql(proof.final_eval)
        return VerificationResult(matches, proof.final_point, current_claim, proof.final_eval)

    @staticmethod
    def verify_rounds(F, proof: SumcheckProof, claimed_sum):
        """Rounds-only check, returns (is_valid, final_claim)
        (sumcheck_verifier.zig:172-205)."""
        state = SumcheckState(num_rounds=proof.num_vars, current_claim=claimed_sum)
        for round_poly in proof.round_polynomials:
            g0 = eval_univariate_coeffs(F, round_poly, F.zero())
            g1 = eval_univariate_coeffs(F, round_poly, F.one())
            if not g0.add(g1).eql(state.current_claim):
                return False, F.zero()
            challenge = state.generate_challenge(F, round_poly)
            state.advance(challenge, eval_univariate_coeffs(F, round_poly, challenge))
        return True, state.current_claim
