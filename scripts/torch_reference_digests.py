#!/usr/bin/env python3
"""Pin the reference proofs that the PyTorch port is held to.

    JAX_PLATFORMS=cpu python scripts/torch_reference_digests.py [--only small|large|NAME ...]

Proves every case below with the JAX package's HOST path (``zigz_tpu``'s
``Prover`` with ``ZIGZ_TPU_COMMITMENTS=host``: native VM, C++ SHA3 forest,
C++ NTT and column hashing, native zerochecks) and writes the byte length
and sha256 of each serialized proof to
``zigz_tpu_torch/testdata/proof_digests.json``.  The port reads that file
as data (``chip_smoke.py``, tests/test_torch_selfcontained.py) and must
reproduce every digest; it never imports this script, which is a tool
beside the port and the only place where the port's pinned bytes meet
``zigz_tpu``.  Each case runs in a process of its own, so the large ones
(2^22 v1 steps, 2^20 v2 steps: minutes and several GiB each on a CPU) give
their memory back.  ``--only`` refreshes some entries and keeps the rest.

A case names its program as data: ``{"kind": "nop", "count": N}`` is N
NOP instructions at 0x1000; ``{"kind": "fixture", "name": ..., "tape":
[...]}`` is a guest ELF under tests/fixtures/ with its input tape.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "zigz_tpu_torch", "testdata", "proof_digests.json")
FIB = {"kind": "fixture", "name": "fibonacci_program.bin"}

# name -> (protocol version, program, max_steps, size class)
CASES = {
    "v1-nop-2^10": (1, {"kind": "nop", "count": 1 << 10}, 1 << 11, "small"),
    "v2-nop-2^10": (2, {"kind": "nop", "count": 1 << 10}, 1 << 11, "small"),
    "v2-fibonacci-10": (2, {**FIB, "tape": [10]}, 1 << 16, "small"),
    "v1-nop-2^16": (1, {"kind": "nop", "count": 1 << 16}, 1 << 17, "large"),
    "v1-nop-2^20": (1, {"kind": "nop", "count": 1 << 20}, 1 << 21, "large"),
    "v1-nop-2^22": (1, {"kind": "nop", "count": 1 << 22}, 1 << 23, "large"),
    "v1-fibonacci-150000": (1, {**FIB, "tape": [150_000]}, 1 << 21, "large"),
    "v2-nop-2^16": (2, {"kind": "nop", "count": 1 << 16}, 1 << 17, "large"),
    "v2-fibonacci-10000": (2, {**FIB, "tape": [10_000]}, 1 << 17, "large"),
    "v2-nop-2^20": (2, {"kind": "nop", "count": 1 << 20}, 1 << 21, "large"),
}


def prove_case(name: str) -> dict:
    os.environ["ZIGZ_TPU_COMMITMENTS"] = "host"
    sys.path.insert(0, ROOT)
    import zigz_tpu as z

    version, program_spec, max_steps, size = CASES[name]
    entry, segments, tape = 0x1000, None, program_spec.get("tape")
    if program_spec["kind"] == "nop":
        program = bytes([0x13, 0x00, 0x00, 0x00]) * program_spec["count"]
    else:
        with open(os.path.join(ROOT, "tests", "fixtures", program_spec["name"]), "rb") as f:
            program = f.read()
        loaded = z.elf.load(program)
        entry, segments = loaded.entry_pc, loaded.segments
    proof = z.Prover(z.BabyBear, seed=0, protocol_version=version).prove(
        program, entry, None, max_steps, segments, tape)
    data = z.serialization.BinarySerializer(z.BabyBear).serialize(proof)
    return {
        "protocol_version": version,
        "program": program_spec,
        "max_steps": max_steps,
        "size": size,
        "num_steps": proof.metadata.num_steps,
        "bytes": len(data),
        "sha256": hashlib.sha256(data).hexdigest(),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="+", default=None,
                    help="case names, or the size classes 'small' and 'large'")
    ap.add_argument("--case", help="(internal) prove one case and print its entry as JSON")
    args = ap.parse_args()
    if args.case:
        print(json.dumps(prove_case(args.case)))
        return 0
    names = [n for n, c in CASES.items()
             if args.only is None or n in args.only or c[3] in args.only]
    entries = {}
    if os.path.exists(OUT):
        with open(OUT) as f:
            entries = json.load(f)["proofs"]
    for name in names:
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--case", name],
                             capture_output=True, text=True)
        if res.returncode != 0:
            sys.stderr.write(res.stderr)
            print(f"{name}: failed (rc {res.returncode})", file=sys.stderr)
            return 1
        entries[name] = json.loads(res.stdout.strip().splitlines()[-1])
        print(f"{name}: {entries[name]}", flush=True)
        os.makedirs(os.path.dirname(OUT), exist_ok=True)
        with open(OUT, "w") as f:
            json.dump({"made_by": "scripts/torch_reference_digests.py",
                       "proofs": {k: entries[k] for k in CASES if k in entries}}, f, indent=1)
            f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
