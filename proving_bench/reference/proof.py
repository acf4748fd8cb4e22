"""The pieces of the zigz wire format that every protocol's reference shares.

The Fiat-Shamir transcript is one streaming SHA3-256; a field element
enters it as its canonical value's 8 little-endian bytes, and a challenge is
the first 8 bytes of the digest of the stream so far, little-endian, mod p,
after which that digest is absorbed. What a protocol absorbs, and in which
order, is its own (`v1.py`).

The header: "ZIGZ", u32 version, u64 p, u64 steps, u32 variables, u32 0.
The public IO: program hash, initial and final pc, register counts and
values, steps, outputs.
"""

from __future__ import annotations

import hashlib
import struct

import numpy as np

from . import rv64

MAGIC = b"ZIGZ"


class Transcript:
    def __init__(self):
        self._h = hashlib.sha3_256()

    def absorb(self, data: bytes) -> None:
        self._h.update(data)

    def element(self, value: int, p: int) -> None:
        self._h.update((value % p).to_bytes(8, "little"))

    def challenge(self, p: int) -> int:
        digest = self._h.copy().digest()
        self._h.update(digest)
        return int.from_bytes(digest[:8], "little") % p


def public_io(program: bytes, ex: rv64.Execution) -> bytes:
    out = [hashlib.sha256(program).digest(), struct.pack("<QQI", ex.entry_pc, ex.final_pc, 0)]
    out.append(struct.pack("<I", 32) + np.array(ex.final_regs, dtype="<u8").tobytes())
    out.append(struct.pack("<Q", ex.steps))
    out.append(struct.pack("<I", len(ex.outputs)) + np.array(ex.outputs, dtype="<u8").tobytes())
    return b"".join(out)


def header(version: int, p: int, steps: int, num_vars: int) -> bytes:
    return MAGIC + struct.pack("<IQQII", version, p, steps, num_vars, 0)
