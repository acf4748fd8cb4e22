#!/usr/bin/env python3
"""Run only this slice's parts of chip_smoke.py: E1 against its plain
version (phase 2c) and, with ``--proves``, the v1 proves over Goldilocks
and Mersenne61 (phases 4c and 5b).

    python3 scripts/torch_field64_kernels.py [--proves]   (from the root of a checkout; needs one CUDA device)

Builds the CUDA kernels as chip_smoke.py does, counts the instructions one
thread issues in E1's two instantiations and in K1 and K2
(``chip_smoke.issue_count`` over ``cuobjdump -sass``), then runs
``chip_smoke.field64_kernel_phase`` at the shapes of the v1 2^22 openings
and, with ``--proves``, ``chip_smoke.wide_field_phases`` against the pins
of zigz_tpu_torch/testdata/proof_digests.json.  Run from a parent's
checkout and from this one in turns, it compares two versions of E1 inside
one call.  The card's nvidia-smi line comes first, one JSON line of the
results last.  It imports nothing of JAX or of the JAX package
(chip_smoke.py blocks both on import)."""

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
        print("torch_field64_kernels: an NVIDIA GPU is required", file=sys.stderr)
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
    counts = {name: chip_smoke.issue_count(sass, "mle_fold_u64_kernel", name) for name in ("Goldilocks", "Mersenne61")}
    counts.update(K1=chip_smoke.issue_count(sass, "sha3_leaves_kernel"),
                  K2=chip_smoke.issue_count(sass, "sha3_merge_kernel"))
    for name, count in counts.items():
        chip_smoke.log(f"{name}: {count}")
    dev = torch.device("cuda", 0)
    results = {"nvidia_smi": info["nvidia_smi"], "max_sm_mhz": max_sm_mhz,
               "counts": {k: {x: v for x, v in c.items() if x != "opcodes"} for k, c in counts.items()},
               "e1": chip_smoke.field64_kernel_phase(dev, max_sm_mhz, counts, kernels.log)}
    if "--proves" in sys.argv[1:]:
        with open(os.path.join(ROOT, "zigz_tpu_torch", "testdata", "proof_digests.json")) as f:
            pinned = json.load(f)["proofs"]
        results["proves"] = chip_smoke.wide_field_phases(dev, pinned)
    chip_smoke.log(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
