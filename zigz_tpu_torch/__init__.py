"""zigz_tpu_torch: the zigz_tpu zkVM on PyTorch and CUDA (NVIDIA Hopper).

A package of its own beside the JAX package ``zigz_tpu``, which stays the
reference: it imports ``torch`` and numpy, never JAX and nothing of
``zigz_tpu``.  It carries its own host layers (the field and transcript,
the native VM and C++ runtime, the v2 arguments, the proof format,
serialization, the verifier, the CLI) under the JAX package's sub-package
and module names, and owns the device work of the v1 and v2 proves: the
witness build, the SHA3-256 Merkle forest and the Ligero column sponges
(hand-written CUDA kernels, csrc/), the Reed-Solomon row encode, the
batched MLE evaluation, the extension-field zerochecks and the Lasso
sumcheck rounds.

    import zigz_tpu_torch as zt
    proof = zt.Prover(zt.BabyBear, device="cuda").prove(program, 0x1000, None, 1 << 20, None, None)
    data = zt.serialization.BinarySerializer(zt.BabyBear).serialize(proof)
    assert zt.Verifier(zt.BabyBear).verify(proof, program) == "Accept"
"""

from . import elf
from .core.field import BabyBear
from .prover import serialization
from .prover.prover import Prover
from .verifier.verifier import Verifier

__all__ = ["Prover", "BabyBear", "Verifier", "serialization", "elf"]
