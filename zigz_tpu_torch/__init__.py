"""zigz_tpu_torch: the zigz_tpu zkVM prover on PyTorch and CUDA (NVIDIA Hopper).

The port owns the device work of the v1 prove: the witness build, the
SHA3-256 Merkle forest (hand-written CUDA kernels, csrc/) and the batched
MLE evaluation.  It reuses by import, without copying, zigz_tpu's host
layers, which load no JAX: the native VM, the transcript, the proof format,
serialization and the verifier.  It imports no JAX.

    import zigz_tpu_torch as zt
    proof = zt.Prover(zt.BabyBear, device="cuda").prove(program, 0x1000, None, 1 << 20, None, None)
    data = zt.serialization.BinarySerializer(zt.BabyBear).serialize(proof)
"""

from zigz_tpu import elf
from zigz_tpu.core.field import BabyBear
from zigz_tpu.prover import serialization
from zigz_tpu.verifier.verifier import Verifier

from .prover.prover import Prover

__all__ = ["Prover", "BabyBear", "Verifier", "serialization", "elf"]
