#!/usr/bin/env python3
"""Run only the Poseidon2 kernels' part of chip_smoke.py phase 2: P1-P3
against their plain versions and core/poseidon2.py on the card, with their
times and bounds.

    python3 scripts/torch_poseidon2_kernels.py        (from the root of a checkout; needs one CUDA device)

Builds the CUDA kernels as chip_smoke.py does, prints ptxas's registers and
spills of P1-P3 and the instructions of one permutation (P1 built once more
with P0's round loops unrolled, ``chip_smoke.poseidon2_unrolled_count``),
then runs ``chip_smoke.poseidon2_kernel_phase`` at the shapes of the
2^20-step v3 prove and at one resident wave of P3, bounds from that count
(the first version's yardstick logged beside them).  Run from a
parent's checkout and from this one in turns, it compares two versions of
the kernels inside one call.  The card's nvidia-smi line comes first, one JSON
line of the three kernels' entries last.  It imports nothing of JAX or of
the JAX package (chip_smoke.py blocks both on import)."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (blocks jax and zigz_tpu from import)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_poseidon2_kernels: an NVIDIA GPU is required", file=sys.stderr)
        return 2
    from zigz_tpu_torch.device import card_info
    from zigz_tpu_torch.ops import _build

    info = card_info()
    chip_smoke.log(info["nvidia_smi"])
    kernels = _build.load()
    chip_smoke.log(f"kernels built in {kernels.build_s:.1f} s")
    ptxas = chip_smoke.kernel_ptxas(kernels.log, ("p2_leaves_kernel", "p2_merge_kernel", "p2_absorb_kernel"))
    chip_smoke.log(f"ptxas: {ptxas}")
    max_sm_mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                                      capture_output=True, text=True, check=True).stdout.split()[0])
    count = chip_smoke.poseidon2_unrolled_count(info["nvcc"])
    chip_smoke.log(f"one permutation (P1 unrolled): {count}")
    results = chip_smoke.poseidon2_kernel_phase(torch.device("cuda", 0), max_sm_mhz, count)
    chip_smoke.log(json.dumps({"nvidia_smi": info["nvidia_smi"], "max_sm_mhz": max_sm_mhz,
                               "permutation": {k: v for k, v in count.items() if k != "opcodes"},
                               "ptxas": ptxas, "kernels": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
