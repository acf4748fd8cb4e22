"""Merkle polynomial-commitment scheme.

Reference: zigz src/commitments/polynomial_commit.zig.
``commit`` Merkle-hashes the 2^v evaluations into a 32-byte root
(:69-81); ``open`` evaluates at the point and opens one leaf whose index is
``point[0].value mod 2^v`` (the reference's simplified ``pointToIndex``,
:178-183 — replicated for wire parity; see SURVEY.md §2.9.4); ``verify``
checks the point dimension and the Merkle path (:118-129).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from ..poly.multilinear import Multilinear
from .merkle import OpeningProof as MerkleOpening, SimpleMerkleTree

__all__ = ["PolynomialCommitment", "OpeningProof", "CommitmentScheme", "CommitmentStats"]


@dataclass
class PolynomialCommitment:
    commitment: bytes  # 32-byte Merkle root
    num_vars: int


@dataclass
class OpeningProof:
    point: List[object]
    value: object
    merkle_proof: MerkleOpening


class CommitmentScheme:
    """CommitmentSchemeSHA3 twin; generic over F via arguments."""

    @staticmethod
    def commit(poly: Multilinear, hash_mode: str = "sha3"):
        tree = SimpleMerkleTree.build(poly.F, poly.evals, hash_mode)
        return PolynomialCommitment(tree.get_root(), poly.num_vars), tree

    @staticmethod
    def point_to_index(point) -> int:
        """polynomial_commit.zig:178-183 — point[0].value mod 2^v."""
        if len(point) == 0:
            return 0
        return point[0].value % (1 << len(point))

    @classmethod
    def open(cls, poly: Multilinear, tree: SimpleMerkleTree, point) -> OpeningProof:
        if len(point) != poly.num_vars:
            raise ValueError("PointDimensionMismatch")
        value = poly.eval(point)
        index = cls.point_to_index(point)
        merkle_proof = tree.open(index)
        return OpeningProof(point=list(point), value=value, merkle_proof=merkle_proof)

    @staticmethod
    def verify(F, commitment: PolynomialCommitment, proof: OpeningProof) -> bool:
        if len(proof.point) != commitment.num_vars:
            return False
        return SimpleMerkleTree.verify(F, commitment.commitment, proof.merkle_proof)

    @classmethod
    def batch_commit(cls, polys):
        commitments, trees = [], []
        for poly in polys:
            c, t = cls.commit(poly)
            commitments.append(c)
            trees.append(t)
        return commitments, trees

    @classmethod
    def batch_verify(cls, F, commitments, proofs) -> bool:
        if len(commitments) != len(proofs):
            return False
        return all(cls.verify(F, c, pr) for c, pr in zip(commitments, proofs))


@dataclass
class CommitmentStats:
    """polynomial_commit.zig:208-225."""

    num_polynomials: int
    total_evaluations: int
    commitment_size_bytes: int
    proof_size_bytes: int

    @staticmethod
    def analyze(F, num_vars: int) -> "CommitmentStats":
        return CommitmentStats(
            num_polynomials=1,
            total_evaluations=1 << num_vars,
            commitment_size_bytes=32,
            proof_size_bytes=32 * num_vars + F.NBYTES,
        )
