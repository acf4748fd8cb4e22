"""zigz_tpu_torch: the zigz_tpu zkVM on PyTorch and CUDA (NVIDIA Hopper).

A package of its own beside the JAX package ``zigz_tpu``, which stays the
reference: it imports ``torch`` and numpy, never JAX and nothing of
``zigz_tpu``.  It carries its own host layers (the field and transcript,
the native VM and C++ runtime, the v2 arguments, the proof format,
serialization, the verifier, the CLI) under the JAX package's sub-package
and module names, and owns the device work of the proves of protocols v1
to v4: the witness build, the SHA3-256 Merkle forest and the Ligero column
sponges (hand-written CUDA kernels, csrc/), the Poseidon2 forest and column
sponge of v3, the Reed-Solomon row encode, the batched MLE evaluation, the
device advice columns, the extension-field zerochecks and the Lasso
sumcheck rounds.  ``Prover`` runs on the card unless it is given
``device="cpu"``, which runs the kernels' plain PyTorch versions.

    import zigz_tpu_torch as zt
    proof = zt.Prover(zt.BabyBear, protocol_version=2).prove(program, 0x1000, None, 1 << 20, None, None)
    data = zt.serialization.BinarySerializer(zt.BabyBear).serialize(proof)
    assert zt.Verifier(zt.BabyBear).verify(proof, program) == "Accept"
"""

from . import elf as elf
from .core import field as field
from .core.field import (
    BabyBear,
    F17,
    Field,
    Goldilocks,
    KoalaBear,
    Mersenne31,
    Mersenne61,
)
from .core.hash import FiatShamirTranscript, SHA3Hasher
from .core import xoshiro as xoshiro
from .poly.multilinear import Multilinear
from .poly.univariate import Univariate
from .vm.state import VMState
from .vm.memory import Memory
from .vm.registers import RegisterFile
from .vm.trace import ExecutionTrace
from .constraints.witness import Witness, WitnessGenerator
from .constraints.builder import ConstraintSystem
from .proofs.sumcheck import SumcheckProof, SumcheckProver, SumcheckVerifier
from .commitments.merkle import SimpleMerkleTree
from .commitments.commit import CommitmentScheme
from .prover.prover import Prover
from .prover.proof import Proof, PublicIO, VerificationResult
from .prover import serialization as serialization
from .verifier.verifier import Verifier

# The names zigz_tpu exports, from the port's own modules.
__all__ = [
    "BabyBear", "F17", "Field", "Goldilocks", "KoalaBear", "Mersenne31",
    "Mersenne61", "FiatShamirTranscript", "SHA3Hasher", "Multilinear",
    "Univariate", "elf", "VMState", "Memory", "RegisterFile",
    "ExecutionTrace", "Witness", "WitnessGenerator", "ConstraintSystem",
    "SumcheckProof", "SumcheckProver", "SumcheckVerifier",
    "SimpleMerkleTree", "CommitmentScheme", "Prover", "Proof", "PublicIO",
    "VerificationResult", "serialization", "Verifier", "field", "xoshiro",
]
