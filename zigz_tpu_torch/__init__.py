"""zigz_tpu_torch: the zigz_tpu zkVM prover on PyTorch and CUDA (NVIDIA Hopper).

The port owns the device work of the v1 and v2 proves: the witness build,
the SHA3-256 Merkle forest and the Ligero column sponges (hand-written CUDA
kernels, csrc/), the Reed-Solomon row encode and the batched MLE
evaluation.  It reuses by import, without copying, zigz_tpu's host layers,
which load no JAX: the native VM, the transcript, the v2 arguments and
their zerochecks, the proof format, serialization and the verifier.  It
imports no JAX.

    import zigz_tpu_torch as zt
    proof = zt.Prover(zt.BabyBear, device="cuda").prove(program, 0x1000, None, 1 << 20, None, None)
    data = zt.serialization.BinarySerializer(zt.BabyBear).serialize(proof)
"""

from ._jaxfree import register_reference_ops

register_reference_ops()  # before anything imports zigz_tpu.ops

from zigz_tpu import elf  # noqa: E402
from zigz_tpu.core.field import BabyBear  # noqa: E402
from zigz_tpu.prover import serialization  # noqa: E402
from zigz_tpu.verifier.verifier import Verifier  # noqa: E402

from .prover.prover import Prover  # noqa: E402

__all__ = ["Prover", "BabyBear", "Verifier", "serialization", "elf"]
