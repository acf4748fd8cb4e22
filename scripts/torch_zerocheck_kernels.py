#!/usr/bin/env python3
"""Run only the zerocheck kernels' phase of chip_smoke.py (9b): Z1 and Z2
against their plain versions on the card, with their times and bounds.

    python3 scripts/torch_zerocheck_kernels.py        (from the root of a checkout; needs one CUDA device)

Builds the CUDA kernels as chip_smoke.py does and prints nvcc's register
report of Z2; builds Z1's generated kernels as chip_smoke.py phase 1 does
(the v2 programs captured from a 16-step prove on the CPU, all nvcc
processes started together) and prints each one's nvcc seconds, registers
and spills; proves v2 at 2^16 NOP steps on the card (equal to its pinned
digest; its ``dag_build_s`` is 0, the kernels being built) to capture its
extension zerochecks' combiners, then runs
``chip_smoke.zerocheck_kernel_phase`` at the widths of the 2^20 prove.  The
card's nvidia-smi line comes first.  It imports nothing of JAX or of the JAX
package (chip_smoke.py blocks both on import)."""

import hashlib
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (blocks jax and zigz_tpu from import)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_zerocheck_kernels: an NVIDIA GPU is required", file=sys.stderr)
        return 2
    import zigz_tpu_torch as zt
    from zigz_tpu_torch.device import card_info
    from zigz_tpu_torch.ops import _build, babybear, dag_dev, zerocheck_dev_ext
    from zigz_tpu_torch.verifier.benchmarks import nop_program

    info = card_info()
    chip_smoke.log(info["nvidia_smi"])
    kernels = _build.load()
    chip_smoke.log(f"kernels built in {kernels.build_s:.1f} s")
    for line in kernels.log.splitlines():
        if any(k in line for k in ("ext_fold", "registers", "spill")):
            chip_smoke.log(f"  ptxas: {line.strip()}")
    t0 = chip_smoke.time.perf_counter()
    builds = {}
    for spec in chip_smoke.capture_zerocheck_specs(2):
        for program in spec["programs"]:
            builds.setdefault(dag_dev.prepare(program).key, program)
    for program in sorted(builds.values(), key=lambda pr: len(pr.code)):
        chip_smoke.log(f"  Z1 generated, {len(program.code)} instructions: {chip_smoke.build_report(program.kernel)}")
    chip_smoke.log(f"Z1: {len(builds)} generated kernels built in {chip_smoke.time.perf_counter() - t0:.1f} s")
    max_sm_mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                                      capture_output=True, text=True, check=True).stdout.split()[0])
    sass = subprocess.run([os.path.join(os.path.dirname(info["nvcc"]), "cuobjdump"), "-sass", kernels.path],
                          capture_output=True, text=True, check=True).stdout
    part = next(p for p in sass.split("Function :")[1:] if "field_mul_chain" in p.splitlines()[0])
    chain_instr = sum(1 for op in re.findall(chip_smoke.SASS_OPCODE, part, flags=re.M) if op in chip_smoke.INT_OPCODES)

    specs = []
    prove = zerocheck_dev_ext.GenericDeviceZerocheckExt.prove

    def watched(self, transcript):
        specs.append(chip_smoke.zerocheck_spec(self))
        return prove(self, transcript)

    zerocheck_dev_ext.GenericDeviceZerocheckExt.prove = watched
    with open(os.path.join(ROOT, "zigz_tpu_torch", "testdata", "proof_digests.json")) as f:
        pinned = json.load(f)["proofs"]["v2-nop-2^16"]
    zerocheck_dev_ext.reset_counters()
    prover = zt.Prover(zt.BabyBear, seed=0, protocol_version=2)
    proof = prover.prove(nop_program(1 << 16), 0x1000, None, pinned["max_steps"], None, None)
    data = zt.serialization.BinarySerializer(zt.BabyBear).serialize(proof)
    if hashlib.sha256(data).hexdigest() != pinned["sha256"]:
        raise AssertionError("v2-nop-2^16 differs from its pinned digest")
    want = sum(chip_smoke.card_zerocheck_launches(s["n"], s["host_tail"]) for s in specs)
    t = prover.last_timings
    chip_smoke.log(f"v2-nop-2^16 == pinned; zerochecks_s={t['zerochecks_s']} dag_build_s={t['dag_build_s']} "
                   f"zerocheck_host_s={t['zerocheck_host_s']} zerocheck_start_s={t['zerocheck_start_s']} "
                   f"{zerocheck_dev_ext.DEVICE_PROVES} "
                   f"(the kernels imply {want} launches)")
    if zerocheck_dev_ext.DEVICE_PROVES["sweep_launches"] != want:
        raise AssertionError("the sweep's launches are not those the kernels imply")
    results = chip_smoke.zerocheck_kernel_phase(specs, torch.device("cuda", 0), max_sm_mhz,
                                                chain_instr / (babybear.CHAIN + 1), 3)
    chip_smoke.log(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
