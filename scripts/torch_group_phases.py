#!/usr/bin/env python3
"""Run only the sharded-prover phases of chip_smoke.py (14 and 15): two ranks
that share one NVIDIA GPU, gloo as the transport.

    python3 scripts/torch_group_phases.py        (from the root of a checkout; needs one CUDA device)

Builds the CUDA kernels and the host runtime as chip_smoke.py does, prints
the card's nvidia-smi line, then the lines of the two phases (phase 14 ends
with the collective wrappers under a one-rank "nccl" group).  It imports
nothing of JAX or of the JAX package (chip_smoke.py blocks both on import).
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (blocks jax and zigz_tpu from import)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_group_phases: an NVIDIA GPU is required", file=sys.stderr)
        return 2
    from zigz_tpu_torch import runtime
    from zigz_tpu_torch.device import card_info
    from zigz_tpu_torch.ops import _build

    info = card_info()
    chip_smoke.log(f"card: {info['nvidia_smi']}; torch {info['torch']}, CUDA {info['cuda']}")
    kernels = _build.load()
    chip_smoke.log(f"kernels built in {kernels.build_s:.1f} s; host runtime native: {runtime.NATIVE_AVAILABLE}")
    with open(os.path.join(ROOT, "zigz_tpu_torch", "testdata", "proof_digests.json")) as f:
        pinned = json.load(f)["proofs"]
    t0 = time.perf_counter()
    launches = chip_smoke.group_phases(pinned)
    chip_smoke.log(f"phases 14-15 took {time.perf_counter() - t0:.1f} s; launches per rank {json.dumps(launches)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
