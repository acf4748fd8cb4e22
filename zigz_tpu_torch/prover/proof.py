"""Pipeline proof structures.

Reference: zigz src/prover/proof.zig.  Shapes are wire-relevant:

* ``PipelineSumcheckProof`` has configurable degree — the constraint proof
  uses degree 3 (4 coefficients/round, proof.zig:228), Lasso multiset proofs
  degree 2 (proof.zig:123);
* ``Proof.init`` computes ``num_vars = log2_int_ceil(num_steps)`` (0 for a
  single step) and allocates 43 commitment openings (proof.zig:224-261);
* pipeline Lasso proofs carry ``table_id``/``num_lookups`` plus a multiset
  sumcheck proof with ``num_vars = log2_int_ceil(num_lookups)`` — the
  prover always passes num_lookups=1, hence 0 rounds (prover.zig:304-322).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import List, Optional

from ..commitments.commit import OpeningProof
from ..commitments.merkle import MerklePath, OpeningProof as MerkleOpening
from ..constraints.witness import num_vars_for_steps

__all__ = [
    "PublicIO",
    "PipelineSumcheckProof",
    "PipelineLassoProof",
    "CommitmentOpening",
    "Proof",
    "ProofMetadata",
    "VerificationResult",
]


@dataclass
class PublicIO:
    """proof.zig:18-49."""

    program_hash: bytes  # 32 bytes (SHA-256 of program)
    initial_pc: int
    initial_regs: Optional[List[int]]
    final_pc: int
    final_regs: Optional[List[int]]
    num_steps: int
    initial_memory: Optional[dict] = None
    outputs: Optional[List[int]] = None


@dataclass
class PipelineSumcheckProof:
    """proof.zig:53-98 — [num_vars][degree+1] coefficient rows."""

    num_vars: int
    round_polynomials: List[List[object]]
    final_point: List[object]
    final_eval: object

    @classmethod
    def create(cls, F, num_vars: int, degree: int) -> "PipelineSumcheckProof":
        return cls(
            num_vars=num_vars,
            round_polynomials=[[F.zero() for _ in range(degree + 1)] for _ in range(num_vars)],
            final_point=[F.zero() for _ in range(num_vars)],
            final_eval=F.zero(),
        )


@dataclass
class PipelineLassoProof:
    """proof.zig:102-143."""

    table_id: int
    num_lookups: int
    multiset_proof: PipelineSumcheckProof
    subtable_proofs: Optional[List[PipelineSumcheckProof]] = None

    @classmethod
    def create(cls, F, table_id: int, num_lookups: int, num_vars: int) -> "PipelineLassoProof":
        return cls(
            table_id=table_id,
            num_lookups=num_lookups,
            multiset_proof=PipelineSumcheckProof.create(F, num_vars, 2),
        )


@dataclass
class CommitmentOpening:
    """proof.zig:147-190 — ``point`` aliases ``proof.point`` after opening."""

    commitment: bytes  # 32-byte Merkle root
    point: List[object]
    value: object
    proof: OpeningProof

    @classmethod
    def create(cls, F, num_vars: int) -> "CommitmentOpening":
        point = [F.zero() for _ in range(num_vars)]
        empty = OpeningProof(
            point=point,
            value=F.zero(),
            merkle_proof=MerkleOpening(index=0, value=F.zero(), path=MerklePath()),
        )
        return cls(commitment=b"\x00" * 32, point=point, value=F.zero(), proof=empty)


@dataclass
class V2Section:
    """Protocol-v2 extension: real constraint zerocheck artifacts.

    Round 3: the constraint zerocheck runs entirely over BabyBear^4
    challenges (proofs/zerocheck.py ZerocheckExt*), so its round
    evaluations, final point, and terminal column evaluations are Ext4
    values carried HERE (the v1 constraint_proof rows stay zeroed for v2+
    and are not serialized).  The round-2 aux Merkle forest is gone: the
    seq/next_pc columns are bound through the v2 Ligero PCS commitment."""

    zerocheck: object  # ZerocheckProof with Ext4 entries
    column_evals: dict  # name -> Ext4 (terminal zerocheck evaluations)
    # Real per-table Lasso metadata (lookups/pipeline_lasso.py):
    # table_id -> {"claimed_sum": int, "query_commitment": 32B}
    lasso_extras: dict = None
    # PC-chain logUp (shift argument, constraints/v2.py c5/c6):
    logup_nonce: int = 0  # transcript retry nonce for the tau/beta draw
    logup_sum: int = 0  # shared value of sum(g1) == sum(g2)
    # Lookup validity argument (lookups/validity.py): proves every
    # gadget-covered query is a genuine table entry.
    lookup_validity: object = None  # LookupValidityProof
    # Register-file offline memory check (constraints/regcheck.py): the
    # reference's "register_updates" metadata TODO (builder.zig:77-149),
    # proven for real under protocol v2.
    regcheck: object = None  # RegCheckProof
    # RAM byte-level offline memory check (constraints/memcheck.py):
    # loads must return last-stored bytes, anchored at the public
    # initial image (the reference's memory.zig is execution-only).
    memcheck: object = None  # MemCheckProof
    # Bytecode fetch+decode argument (constraints/bytecode.py): every
    # step's decoded tuple is proven to equal the public program's decode
    # at its pc (Jolt-style bytecode memory check).
    bytecode: object = None  # BytecodeProof
    # Protocol v4: the 43 witness MLEs inside the unified data
    # commitment, claimed at the zerocheck terminal point (replaces the
    # v1-style 43 Merkle trees + point-to-index openings entirely;
    # closes the reference's known gap at polynomial_commit.zig:178-183
    # for every witness column, not just the zerocheck's).
    witness_evals: dict = None  # name -> Ext4, at the zerocheck point
    # Round 3: the unified commitment proof (prover/unified.py) — two
    # mixed Ligero roots (data + advice), the batch-evaluation reduction,
    # and the two openings that replace the round-2 per-argument ones.
    unified: object = None  # UnifiedProof


class CompactLassoList:
    """Memory-efficient stand-in for the pipeline's list of Lasso filler
    proofs, which are structurally uniform: proof i has table_id == i,
    num_lookups == 1, num_vars == 0, final_eval == 0 (prover.zig:302-349
    with log2_ceil(1)==0).  At 2^20 steps that is ~1M proofs; storing them
    as one count instead of objects keeps the Proof in O(1) memory.
    Materializes real PipelineLassoProof views on indexing."""

    __slots__ = ("F", "count")

    def __init__(self, F, count: int):
        self.F = F
        self.count = count

    def __len__(self) -> int:
        return self.count

    def __iter__(self):
        for i in range(self.count):
            yield self[i]

    def __getitem__(self, i: int) -> "PipelineLassoProof":
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(self.count))]
        if i < 0:
            i += self.count
        if not 0 <= i < self.count:
            raise IndexError(i)
        return PipelineLassoProof.create(self.F, table_id=i, num_lookups=1, num_vars=0)

    def append(self, lasso: "PipelineLassoProof") -> None:
        # Appending the next uniform filler proof keeps the compact form.
        if (
            lasso.table_id == self.count
            and lasso.num_lookups == 1
            and lasso.multiset_proof.num_vars == 0
            and lasso.multiset_proof.final_eval.is_zero()
            and lasso.subtable_proofs is None
        ):
            self.count += 1
        else:
            raise ValueError("non-uniform Lasso proof; use a plain list")


@dataclass
class ProofMetadata:
    """proof.zig:317-329."""

    num_steps: int
    num_vars: int
    field_modulus: int
    version: int = 1


class VerificationResult:
    Accept = "Accept"
    RejectInvalidSumcheck = "RejectInvalidSumcheck"
    RejectInvalidLookup = "RejectInvalidLookup"
    RejectInvalidCommitment = "RejectInvalidCommitment"
    RejectInvalidPublicIO = "RejectInvalidPublicIO"
    # v2-only extensions (no counterpart in verifier.zig): the register-file
    # offline memory check (constraints/regcheck.py) failed, or the RAM
    # byte-level memory check (constraints/memcheck.py) failed.
    RejectInvalidRegisterAccess = "RejectInvalidRegisterAccess"
    RejectInvalidMemoryAccess = "RejectInvalidMemoryAccess"
    # The bytecode fetch/decode argument (constraints/bytecode.py) failed.
    RejectInvalidBytecode = "RejectInvalidBytecode"


@dataclass
class Proof:
    """proof.zig:194-312."""

    F: type
    public_io: Optional[PublicIO]
    constraint_proof: PipelineSumcheckProof
    lookup_proofs: List[PipelineLassoProof]
    witness_commitments: List[CommitmentOpening]
    metadata: ProofMetadata
    v2: Optional[V2Section] = None

    @classmethod
    def create(cls, F, num_steps: int) -> "Proof":
        num_vars = num_vars_for_steps(num_steps)
        return cls(
            F=F,
            public_io=None,
            constraint_proof=PipelineSumcheckProof.create(F, num_vars, 3),
            lookup_proofs=[],
            witness_commitments=[CommitmentOpening.create(F, num_vars) for _ in range(43)],
            metadata=ProofMetadata(
                num_steps=num_steps,
                num_vars=num_vars,
                field_modulus=F.MODULUS,
                version=1,
            ),
        )

    def estimate_size(self) -> int:
        """proof.zig:279-312."""
        size = 32 + 8 + 8 + 8
        io = self.public_io
        if io is not None:
            if io.initial_regs:
                size += len(io.initial_regs) * 8
            if io.final_regs:
                size += len(io.final_regs) * 8
        field_size = 8
        size += self.metadata.num_vars * 4 * field_size
        size += self.metadata.num_vars * field_size
        size += field_size
        for lasso in self.lookup_proofs:
            size += 4 + 8
            size += lasso.multiset_proof.num_vars * 3 * field_size
        size += len(self.witness_commitments) * 32
        size += len(self.witness_commitments) * 20 * 32
        return size
