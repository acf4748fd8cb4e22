#!/usr/bin/env python3
"""Run only the witness kernel's part of chip_smoke.py: W1 against its plain
version and one launch a ``build_witness`` (phase 2e).

    python3 scripts/torch_witness_kernel.py   (from the root of a checkout; needs one CUDA device)

Builds the CUDA kernels as chip_smoke.py does, then runs
``chip_smoke.witness_kernel_phase`` over BabyBear, Goldilocks and
Mersenne61 at 777 steps in 2^10 rows and at the v1-fib-2e22 cell's shape,
4,190,000 steps in 2^22, with W1's, its plain version's and the register
fill's CUDA-event times there.  The card's nvidia-smi line comes first, one
JSON line of the results last.  It imports nothing of JAX or of the JAX
package (chip_smoke.py blocks both on import)."""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (blocks jax and zigz_tpu from import)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_witness_kernel: an NVIDIA GPU is required", file=sys.stderr)
        return 2
    from zigz_tpu_torch.device import card_info
    from zigz_tpu_torch.ops import _build

    info = card_info()
    chip_smoke.log(info["nvidia_smi"])
    kernels = _build.load()
    chip_smoke.log(f"kernels built in {kernels.build_s:.1f} s")
    results = {"nvidia_smi": info["nvidia_smi"],
               "w1": chip_smoke.witness_kernel_phase(torch.device("cuda", 0), kernels.log)}
    chip_smoke.log(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
