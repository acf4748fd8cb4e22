#!/usr/bin/env python3
"""Run only the Reed-Solomon encode's part of chip_smoke.py: N1 and N2
against their plain version (phase 2d), with the instruction counts their
bound and the column sponges' bounds are taken from.

    python3 scripts/torch_ntt_kernels.py   (from the root of a checkout; needs one CUDA device)

Builds the CUDA kernels as chip_smoke.py does, counts the instructions of
one butterfly and of one rate block of K4 and K5 and a column's own code
(``chip_smoke.bound_chain_counts``) and those one thread issues in N1, N2,
K2, K4, K5 and the multiply chain (``chip_smoke.issue_count`` over
``cuobjdump -sass``), then runs ``chip_smoke.ntt_kernel_phase``.  The
card's nvidia-smi line comes first, one JSON line of the results last.  It
imports nothing of JAX or of the JAX package (chip_smoke.py blocks both on
import)."""

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
        print("torch_ntt_kernels: an NVIDIA GPU is required", file=sys.stderr)
        return 2
    from zigz_tpu_torch.device import card_info
    from zigz_tpu_torch.ops import _build

    info = card_info()
    chip_smoke.log(info["nvidia_smi"])
    kernels = _build.load()
    chip_smoke.log(f"kernels built in {kernels.build_s:.1f} s")
    max_sm_mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                                      capture_output=True, text=True, check=True).stdout.split()[0])
    cuobjdump = os.path.join(os.path.dirname(info["nvcc"]), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", kernels.path], capture_output=True, text=True, check=True).stdout
    counts = {name: chip_smoke.issue_count(sass, name)
              for name in (*chip_smoke.NTT_KERNELS.values(), "sha3_merge_kernel", "sha3_columns_kernel",
                           "sha3_absorb_kernel", "field_mul_chain_kernel")}
    chains = chip_smoke.bound_chain_counts(info["nvcc"])
    counts.update((k, v) for k, v in chains.items() if k != "nvcc_s")
    for name, count in counts.items():
        chip_smoke.log(f"{name}: {count}")
    dev = torch.device("cuda", 0)
    results = {"nvidia_smi": info["nvidia_smi"], "max_sm_mhz": max_sm_mhz,
               "counts": {k: {x: v for x, v in c.items() if not x.startswith("opcodes")} for k, c in counts.items()},
               "ntt": chip_smoke.ntt_kernel_phase(dev, max_sm_mhz, chains["butterfly"], kernels.log)}
    chip_smoke.log(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
