"""The reference's protocol-v1 proof, and a reader of its bytes.

Protocol v1 is the zigz reference's wire format. Its Fiat-Shamir transcript
is one streaming SHA3-256; a field element enters it as its canonical value's
8 little-endian bytes, and a challenge is the first 8 bytes of the digest of
the stream so far, little-endian, mod p, after which that digest is absorbed.
The schedule:

1. SHA-256 of the program's bytes, then the entry pc;
2. "SUMCHECK_BEGIN", the step count, the variable count; a round absorbs
   four zero coefficients (32 zero bytes) and draws one challenge;
3. "LASSO_BEGIN", then "LASSO_TABLE" and the index i for the i-th step that
   carries a lookup;
4. "POLY_COMMITMENTS" and the 43 roots; 43 points of one challenge a
   variable; each column is evaluated at its point and opened at row
   point[0] mod 2^v;
5. "OPENING_CLAIMS" and the 43 values.

The bytes: "ZIGZ", u32 version, u64 p, u64 steps, u32 variables, u32 0; the
public IO (program hash, initial and final pc, register counts and values,
steps, outputs); the v1 sumcheck rows; a u32 count of lookup records, each
u32 index | u64 1 | u32 0 | u64 0; then per column the root, the point,
the value and the opening (value, index, leaf value, u32 height, siblings,
one byte a direction).
"""

from __future__ import annotations

import hashlib
import struct
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from . import forest, rv64

MAGIC = b"ZIGZ"
VERSION = 1
COLUMNS = 43


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


@dataclass
class Expected:
    """What the reference works out for one prove."""

    execution: rv64.Execution
    num_vars: int
    roots: List[bytes]
    forest: Optional[forest.Forest]
    matrix: np.ndarray
    proof: bytes


def public_io(program: bytes, ex: rv64.Execution) -> bytes:
    out = [hashlib.sha256(program).digest(), struct.pack("<QQI", ex.entry_pc, ex.final_pc, 0)]
    out.append(struct.pack("<I", 32) + np.array(ex.final_regs, dtype="<u8").tobytes())
    out.append(struct.pack("<Q", ex.steps))
    out.append(struct.pack("<I", len(ex.outputs)) + np.array(ex.outputs, dtype="<u8").tobytes())
    return b"".join(out)


def header(version: int, p: int, steps: int, num_vars: int) -> bytes:
    return MAGIC + struct.pack("<IQQII", version, p, steps, num_vars, 0)


def expect(program: bytes, input_tape, max_steps: int, p: int, device, lazy: bool = False) -> Expected:
    """Execute the guest, build its witness, the forest and the whole proof.
    `lazy` is the control: evaluations without the reduction after each fold."""
    entry, segments = rv64.parse_elf(program)
    ex = rv64.execute(entry, segments, input_tape, max_steps)
    v = rv64.num_vars(ex.steps)
    matrix = rv64.witness_matrix(ex, p)
    trees = forest.build(matrix, device)
    exp = Expected(ex, v, trees.roots(), trees, matrix, b"")
    exp.proof = _prove_v1(program, exp, p, device, lazy)
    return exp


def _prove_v1(program: bytes, exp: Expected, p: int, device, lazy: bool):
    ex, v = exp.execution, exp.num_vars
    t = Transcript()
    t.absorb(hashlib.sha256(program).digest())
    t.element(ex.entry_pc, p)
    t.absorb(b"SUMCHECK_BEGIN")
    t.element(ex.steps, p)
    t.element(v, p)
    sum_point = []
    for _ in range(v):
        t.absorb(bytes(32))
        sum_point.append(t.challenge(p))
    lookups = rv64.lookup_count(ex)
    ids = np.arange(lookups, dtype=np.uint64) % np.uint64(p)
    stream = np.zeros(lookups, dtype=[("tag", "S11"), ("id", "<u8")])
    stream["tag"] = b"LASSO_TABLE"
    stream["id"] = ids
    t.absorb(b"LASSO_BEGIN")
    t.absorb(stream.tobytes())
    t.absorb(b"POLY_COMMITMENTS")
    for root in exp.roots:
        t.absorb(root)
    points = np.array([[t.challenge(p) for _ in range(v)] for _ in range(COLUMNS)],
                      dtype=np.uint64).reshape(COLUMNS, v)
    values = forest.evaluate(exp.matrix, points, p, device, lazy=lazy)
    index = points[:, 0] % np.uint64(1 << v) if v else np.zeros(COLUMNS, dtype=np.uint64)
    siblings = exp.forest.siblings(index.astype(np.int64))

    parts = [header(1, p, ex.steps, v), public_io(program, ex),
             bytes(32 * v) + np.array(sum_point, dtype="<u8").tobytes() + bytes(8)]
    rec = np.zeros(lookups, dtype=[("id", "<u4"), ("nl", "<u8"), ("nv", "<u4"), ("fe", "<u8")])
    rec["id"] = np.arange(lookups, dtype=np.uint32)
    rec["nl"] = 1
    parts.append(struct.pack("<I", lookups) + rec.tobytes())
    for i in range(COLUMNS):
        idx = int(index[i])
        parts.append(exp.roots[i] + points[i].astype("<u8").tobytes())
        parts.append(struct.pack("<QQQQI", int(values[i]), int(values[i]), idx, int(exp.matrix[i, idx]), v))
        parts.append(siblings[i].tobytes())
        parts.append(bytes((idx >> k) & 1 for k in range(v)))
    return b"".join(parts)


@dataclass
class Opening:
    root: bytes
    point: np.ndarray  # (v,) uint64
    value: int
    proof_value: int
    at: int  # offset of `value` in the bytes; `proof_value` follows it
    index: int
    leaf: int
    siblings: bytes
    directions: bytes


@dataclass
class Parsed:
    version: int
    modulus: int
    steps: int
    num_vars: int
    program_hash: bytes
    initial_pc: int
    final_pc: int
    initial_regs: List[int]
    final_regs: List[int]
    io_steps: int
    outputs: List[int]
    openings: List[Opening]


class ParseError(Exception):
    pass


def parse(data: bytes) -> Parsed:
    """Read the header, the public IO and the 43 column openings (the
    sumcheck rows and the lookup records are skipped)."""
    pos = 0

    def take(n):
        nonlocal pos
        if pos + n > len(data):
            raise ParseError(f"the proof ends at {len(data)}, {n} more bytes wanted at {pos}")
        out = data[pos:pos + n]
        pos += n
        return out

    def u(fmt):
        return struct.unpack("<" + fmt, take(struct.calcsize("<" + fmt)))

    if take(4) != MAGIC:
        raise ParseError("no magic")
    version, modulus, steps, v, _ = u("IQQII")
    program_hash = take(32)
    initial_pc, final_pc = u("QQ")
    initial = list(np.frombuffer(take(8 * u("I")[0]), dtype="<u8"))
    final = list(np.frombuffer(take(8 * u("I")[0]), dtype="<u8"))
    io_steps, = u("Q")
    outputs = [int(x) for x in np.frombuffer(take(8 * u("I")[0]), dtype="<u8")]
    take(8 * (5 * v + 1))
    count, = u("I")
    take(24 * count)  # one 24-byte record a lookup
    openings = []
    for _ in range(COLUMNS):
        root = take(32)
        point = np.frombuffer(take(8 * v), dtype="<u8").astype(np.uint64)
        at = pos
        value, proof_value, index, leaf = u("QQQQ")
        height, = u("I")
        openings.append(Opening(root, point, value, proof_value, at, index, leaf,
                                take(32 * height), take(height)))
    return Parsed(version, modulus, steps, v, program_hash, initial_pc, final_pc,
                  [int(x) for x in initial], [int(x) for x in final], io_steps, outputs, openings)
