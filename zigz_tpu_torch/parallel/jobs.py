"""What a rank of parallel/launch.py can be asked to run.

Every function takes ``(group, spec, work_dir)``: the rank's
:class:`~.multihost.TraceGroup`, the job's JSON spec and the job directory,
and returns a JSON-serialisable result.

* ``prove``: one ``Prover(..., group=group)`` prove of the spec's program;
* ``sumcheck``: one ``DistSumcheckProver(group)`` proof of
  ``2^spec["log2_n"]`` values made from ``spec["seed"]`` with numpy, the same
  on every rank and in whoever launched the job.

A caller with functions of its own hands them to ``launch.worker_main``
through its own rank command (``launch(..., command=...)``).
"""

from __future__ import annotations

import hashlib
import os
import time

import numpy as np
import torch

from ..core.field import BabyBear
from ..device import synchronize
from . import dist

__all__ = ["JOBS", "make_program", "seeded", "reset_counters", "counters"]

P = BabyBear.MODULUS


def seeded(seed: int, shape) -> np.ndarray:
    """Canonical uint64 values from a numpy seed."""
    return np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)


def make_program(spec: dict) -> bytes:
    """``{"kind": "nop", "count": n}``: n NOPs; ``{"kind": "arith", "adds":
    n}``: ADDI x1,x0,3; ADDI x2,x0,4; n x ADD x3,x1,x2; EBREAK (n + 3
    steps); ``{"kind": "file", "path": ...}``: a raw program or an ELF."""
    kind = spec["kind"]
    if kind == "nop":
        return bytes([0x13, 0, 0, 0] * spec["count"])
    if kind == "arith":
        return (bytes([0x93, 0x00, 0x30, 0x00, 0x13, 0x01, 0x40, 0x00])
                + bytes([0xB3, 0x81, 0x20, 0x00]) * spec["adds"]
                + bytes([0x73, 0x00, 0x10, 0x00]))
    if kind == "file":
        with open(spec["path"], "rb") as f:
            return f.read()
    raise ValueError(f"unknown program kind {kind!r}")


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def reset_counters() -> None:
    """Zero the kernels' launch counts and the collectives' counts."""
    from ..ops import keccak, ligero_dev

    for counter in (keccak.LAUNCHES, ligero_dev.LAUNCHES, dist.COLLECTIVES):
        for key in counter:
            counter[key] = 0


def counters() -> dict:
    """The kernels' launches and the collectives since the last reset."""
    from ..ops import keccak, ligero_dev

    return {
        "K1": keccak.LAUNCHES["leaves"], "K2": keccak.LAUNCHES["merge"],
        "K4": ligero_dev.LAUNCHES["columns"], "K5": ligero_dev.LAUNCHES["absorb"],
        "collectives": dict(dist.COLLECTIVES),
    }


def _jsonable(value):
    if isinstance(value, (bool, int, float, str)) or value is None:
        return value
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    if isinstance(value, dict):
        return {str(k): _jsonable(v) for k, v in value.items()}
    return str(value)


# -- a whole prove ------------------------------------------------------------

def prove(group, spec: dict, work_dir: str) -> dict:
    """Prove ``spec["program"]`` under the group.  Rank 0 writes the proof
    to ``proof.bin`` in the job directory when ``spec["write_proof"]``."""
    from ..elf import is_elf, load
    from ..prover.prover import Prover
    from ..prover.serialization import BinarySerializer
    from ..verifier.verifier import Verifier

    program = make_program(spec["program"])
    entry_pc, segments = 0x1000, None
    if is_elf(program):
        loaded = load(program)
        entry_pc, segments = loaded.entry_pc, loaded.segments
    version = spec.get("protocol_version", 1)
    cuda = group.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(group.device)
    reset_counters()
    t0 = time.perf_counter()
    prover = Prover(BabyBear, seed=0, device=group.device, group=group, protocol_version=version)
    proof = prover.prove(program, entry_pc, None, spec["max_steps"], segments, spec.get("input_tape"))
    synchronize(group.device)
    prove_s = time.perf_counter() - t0
    launches = counters()
    data = BinarySerializer(BabyBear).serialize(proof)
    result = {
        "rank": group.rank,
        "world_size": group.world_size,
        "device": str(group.device),
        "sha256": _sha(data),
        "bytes": len(data),
        "num_steps": proof.metadata.num_steps,
        "prove_s": prove_s,
        "timings": _jsonable(prover.last_timings),
        "launches": launches,
        "verify": Verifier(BabyBear).verify(proof, program),
    }
    if cuda:
        result["max_memory_allocated"] = torch.cuda.max_memory_allocated(group.device)
        result["max_memory_reserved"] = torch.cuda.max_memory_reserved(group.device)
    if spec.get("write_proof") and group.rank == 0:
        tmp = os.path.join(work_dir, "proof.bin.tmp")
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, os.path.join(work_dir, "proof.bin"))
    return result


def sumcheck(group, spec: dict, work_dir: str) -> dict:
    """The distributed sumcheck of seeded values: the proof's bytes as hex."""
    proof = dist.DistSumcheckProver(BabyBear, group).prove(seeded(spec["seed"], 1 << spec["log2_n"]))
    data = proof.to_bytes()
    return {"rank": group.rank, "world_size": group.world_size, "device": str(group.device),
            "num_vars": proof.num_vars, "sha256": _sha(data), "hex": data.hex()}


JOBS = {"prove": prove, "sumcheck": sumcheck}
