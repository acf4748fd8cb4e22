"""Lasso lookup argument (standalone module, real sumcheck).

Reference: zigz src/lookups/{lasso_prover,lasso_verifier}.zig.
This is the reference's working "simplified Lasso": each table entry and
query is hash-encoded to one field element via an XXH3-64 chain
(lasso_prover.zig:208-239 — the exact xxhash stream, via the python
``xxhash`` module), the query polynomial's hypercube sum is proven with the
real sumcheck prover, and both polynomials are SHA3-committed.  The full
multiplicity/grand-product Lasso (the reference's roadmap comment,
prover.zig:351-357) is the v2 protocol (lookups/pipeline_lasso.py,
lookups/validity.py).

The verifier recomputes the table commitment, replays the sumcheck rounds
(``verify_rounds``), and oracle-checks the table MLE at the final point
(lasso_verifier.zig:56-107).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import hashlib

import numpy as np
import xxhash

from ..poly.multilinear import Multilinear
from ..proofs.sumcheck import SumcheckProof, SumcheckProver, SumcheckVerifier
from .table_builder import DenseTable

__all__ = [
    "LassoProof",
    "LookupQuery",
    "LassoProver",
    "LassoVerifier",
    "VerificationResult",
    "hash_entry_chain",
]

_M64 = (1 << 64) - 1


def _xxh3_chain(h: int, value: int) -> int:
    h ^= value
    return xxhash.xxh3_64_intdigest((h & _M64).to_bytes(8, "little"), seed=0)


def hash_entry_chain(F, inputs: List[int], outputs: List[int]):
    """The XXH3 fold: h ^= v; h = XXH3(le64(h)) per value, inputs then
    outputs; reduce mod p (lasso_prover.zig:208-222)."""
    h = 0
    for v in inputs:
        h = _xxh3_chain(h, v)
    for v in outputs:
        h = _xxh3_chain(h, v)
    return F(h % F.MODULUS)


def _hash_rows(F, inputs: np.ndarray, outputs: np.ndarray) -> np.ndarray:
    out = np.empty(inputs.shape[0], dtype=np.uint64)
    p = F.MODULUS
    for i in range(inputs.shape[0]):
        h = 0
        for v in inputs[i]:
            h = _xxh3_chain(h, int(v))
        for v in outputs[i]:
            h = _xxh3_chain(h, int(v))
        out[i] = h % p
    return out


def _commit_evals(evals: np.ndarray) -> bytes:
    """SHA3 over the canonical 8-byte LE limbs (lasso_prover.zig:242-252)."""
    return hashlib.sha3_256(np.ascontiguousarray(evals, dtype="<u8").tobytes()).digest()


@dataclass
class LookupQuery:
    """lasso_prover.zig:65-86."""

    inputs: List[object]
    expected_outputs: List[object]

    def input_values(self):
        return [x.value for x in self.inputs]

    def output_values(self):
        return [x.value for x in self.expected_outputs]


@dataclass
class LassoProof:
    """lasso_prover.zig:27-62."""

    sumcheck_proof: SumcheckProof
    query_commitment: bytes
    table_commitment: bytes
    num_lookups: int


@dataclass
class VerificationResult:
    is_valid: bool
    reason: str

    @staticmethod
    def accept():
        return VerificationResult(True, "Proof verified successfully")

    @staticmethod
    def reject(reason: str):
        return VerificationResult(False, reason)


def _ceil_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


class LassoProver:
    """lasso_prover.zig:88-269."""

    @staticmethod
    def prove(F, table: DenseTable, queries: List[LookupQuery]) -> LassoProof:
        if len(queries) == 0:
            raise ValueError("NoQueries")

        # Table MLE: hash-encode every entry.
        table_evals = _hash_rows(F, table.inputs, table.outputs)

        # Query MLE: hash-encode queries, zero-pad to a power of two.
        padded = _ceil_pow2(len(queries))
        query_evals = np.zeros(padded, dtype=np.uint64)
        for j, q in enumerate(queries):
            query_evals[j] = hash_entry_chain(F, q.input_values(), q.output_values()).value

        query_poly = Multilinear(F, query_evals)

        # Real sumcheck over the query polynomial (lasso_prover.zig:160).
        sumcheck_proof = SumcheckProver.prove(query_poly)

        return LassoProof(
            sumcheck_proof=sumcheck_proof,
            query_commitment=_commit_evals(query_evals),
            table_commitment=_commit_evals(table_evals),
            num_lookups=len(queries),
        )

    @staticmethod
    def prove_with_mapping(F, table: DenseTable, queries, mapping) -> LassoProof:
        """Pre-validate query->table mapping, then prove
        (lasso_prover.zig:179-205)."""
        if len(queries) != len(mapping):
            raise ValueError("MappingLengthMismatch")
        for q, idx in zip(queries, mapping):
            if idx >= len(table):
                raise ValueError("InvalidMapping")
            entry = table.entry(idx)
            if [x.value for x in entry.inputs] != q.input_values() or [
                x.value for x in entry.outputs
            ] != q.output_values():
                raise ValueError("QueryTableMismatch")
        return LassoProver.prove(F, table, queries)


class LassoVerifier:
    """lasso_verifier.zig:41-226."""

    @staticmethod
    def verify(F, proof: LassoProof, table: DenseTable, expected_num_queries: int) -> VerificationResult:
        if proof.num_lookups != expected_num_queries:
            return VerificationResult.reject("Number of lookups mismatch")

        table_evals = _hash_rows(F, table.inputs, table.outputs)
        if proof.table_commitment != _commit_evals(table_evals):
            return VerificationResult.reject("Table commitment mismatch")

        table_poly = Multilinear(F, table_evals)

        claimed_sum = proof.sumcheck_proof.final_eval
        ok, _final_claim = SumcheckVerifier.verify_rounds(F, proof.sumcheck_proof, claimed_sum)
        if not ok:
            return VerificationResult.reject("Sumcheck verification failed")

        oracle_eval = table_poly.eval(proof.sumcheck_proof.final_point)
        if not oracle_eval.eql(proof.sumcheck_proof.final_eval):
            return VerificationResult.reject("Oracle check failed")

        return VerificationResult.accept()

    @staticmethod
    def verify_with_queries(F, proof: LassoProof, table: DenseTable, queries) -> VerificationResult:
        if proof.query_commitment != LassoVerifier._query_commitment(F, queries):
            return VerificationResult.reject("Query commitment mismatch")
        return LassoVerifier.verify(F, proof, table, len(queries))

    @staticmethod
    def verify_fast(F, proof: LassoProof, table_commitment: bytes, expected_num_queries: int, claimed_sum) -> VerificationResult:
        """Commitment/shape-only check (lasso_verifier.zig:133-162)."""
        if proof.table_commitment != table_commitment:
            return VerificationResult.reject("Table commitment mismatch")
        if proof.num_lookups != expected_num_queries:
            return VerificationResult.reject("Number of lookups mismatch")
        if proof.sumcheck_proof.num_vars == 0:
            return VerificationResult.reject("Invalid sumcheck proof structure")
        if not proof.sumcheck_proof.final_eval.eql(claimed_sum):
            return VerificationResult.reject("Final evaluation mismatch")
        return VerificationResult.accept()

    @staticmethod
    def _query_commitment(F, queries) -> bytes:
        """Query hashes + zero-pad words (lasso_verifier.zig:183-208)."""
        h = hashlib.sha3_256()
        padded = _ceil_pow2(len(queries))
        for q in queries:
            for v in q.input_values():
                h.update(int(v).to_bytes(8, "little"))
            for v in q.output_values():
                h.update(int(v).to_bytes(8, "little"))
        for _ in range(len(queries), padded):
            h.update(b"\x00" * 8)
        return h.digest()
