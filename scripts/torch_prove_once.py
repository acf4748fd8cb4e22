#!/usr/bin/env python3
"""One prove of N NOP steps on the card, its phase timings as one JSON line.

    python scripts/torch_prove_once.py [--version 2] [--log2-steps 20] [--repeat 1] [--host-tail N]

Run it from the root of a checkout: it imports the ``zigz_tpu_torch`` of the
current directory, so the same script times two checkouts in turns
(parent, change, change, parent) inside one call on one card.  The card's
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` line comes
first.  ``--host-tail N`` sets the width at which the extension zerochecks
finish on the host (``zerocheck_dev_ext.HOST_TAIL_EXT``); each line carries
their counters (``DEVICE_PROVES``: zerochecks and the zerocheck kernels'
launches), the Poseidon2 kernels' launches and plain permutations, the
Reed-Solomon encode's kernel launches (N1/N2), the proof's sha256 and the
port's verdict on the serialized proof with its seconds (after the prove,
outside its timings).  Needs a CUDA device."""

import argparse
import hashlib
import json
import os
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--version", type=int, default=2)
    ap.add_argument("--log2-steps", type=int, default=20)
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--host-tail", type=int, default=None,
                    help="width at which the extension zerochecks finish on the host (default: the module's)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_prove_once: a CUDA device is required", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import zigz_tpu_torch as zt
    from zigz_tpu_torch.device import card_info
    from zigz_tpu_torch.ops import ntt_dev, poseidon2, zerocheck_dev_ext
    from zigz_tpu_torch.verifier.benchmarks import nop_program, timed_prove

    print(card_info()["nvidia_smi"], flush=True)
    if args.host_tail is not None:
        zerocheck_dev_ext.HOST_TAIL_EXT = args.host_tail
    program = nop_program(1 << args.log2_steps)
    for _ in range(args.repeat):
        zerocheck_dev_ext.reset_counters()
        poseidon2.LAUNCHES.update(leaves=0, merge=0, absorb=0)
        poseidon2.PERMUTATIONS["count"] = 0
        ntt_dev.LAUNCHES.update(dict.fromkeys(ntt_dev.LAUNCHES, 0))
        prover = zt.Prover(zt.BabyBear, seed=0, device="cuda", protocol_version=args.version)
        proof, wall, peaks = timed_prove(prover, program, 2 << args.log2_steps)
        timings = {k: v for k, v in prover.last_timings.items() if isinstance(v, (int, float, str))}
        ser = zt.serialization.BinarySerializer(zt.BabyBear)
        data = ser.serialize(proof)
        t0 = time.perf_counter()
        verdict = str(zt.Verifier(zt.BabyBear).verify(ser.deserialize(data), program))
        verify_s = time.perf_counter() - t0
        print(json.dumps({"tree": os.getcwd(), "version": args.version, "wall_s": wall,
                          "peak_device_memory_B": peaks["max_memory_allocated_B"],
                          "peak_device_reserved_B": peaks["max_memory_reserved_B"],
                          "host_tail": zerocheck_dev_ext.HOST_TAIL_EXT,
                          "zerocheck_device": dict(zerocheck_dev_ext.DEVICE_PROVES),
                          "p2_launches": dict(poseidon2.LAUNCHES),
                          "p2_permutations": poseidon2.PERMUTATIONS["count"], "ntt_launches": dict(ntt_dev.LAUNCHES),
                          "proof_bytes": len(data), "sha256": hashlib.sha256(data).hexdigest(),
                          "verdict": verdict, "verify_s": verify_s, **timings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
