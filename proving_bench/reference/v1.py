"""The plain reference of protocol v1: its whole proof, a reader of its
bytes, the comparison that decides `correct`, and its control.

Protocol v1 is the zigz reference's wire format. Its transcript schedule
(`proof.Transcript`):

1. SHA-256 of the program's bytes, then the entry pc;
2. "SUMCHECK_BEGIN", the step count, the variable count; a round absorbs
   four zero coefficients (32 zero bytes) and draws one challenge;
3. "LASSO_BEGIN", then "LASSO_TABLE" and the index i for the i-th step that
   carries a lookup;
4. "POLY_COMMITMENTS" and the 43 roots; 43 points of one challenge a
   variable; each column is evaluated at its point and opened at row
   point[0] mod 2^v;
5. "OPENING_CLAIMS" and the 43 values.

The bytes: the header and the public IO (`proof.header`, `proof.public_io`);
the v1 sumcheck rows; a u32 count of lookup records, each
u32 index | u64 1 | u32 0 | u64 0; then per column the root, the point,
the value and the opening (value, index, leaf value, u32 height, siblings,
one byte a direction).

For each proof the reference executes the same guest on the same input,
builds the 43 witness columns and their Merkle forest, and counts what the
proof says differently:

* `execution`: header and public IO against the reference's run (step
  count, variables, program hash, pcs, the 32 final registers, the output
  tape), one count a field that differs;
* `roots`: the 43 witness roots, one count a root that differs;
* `openings`: the 43 openings (index = point[0] mod 2^v, leaf value,
  siblings, directions, and the value against the column's multilinear
  extension at the proof's point), one count an opening with any fault;
* `proof_bytes`: the bytes that differ from the reference's whole proof
  (its transcript and placeholder sections included), length difference
  included.

Every number is a count whose limit is 0: the proof is exact. The control
is the reference's whole proof with the reduction after each fold of an
evaluation left out.
"""

from __future__ import annotations

import hashlib
import struct
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from . import forest, rv64
from .proof import MAGIC, Transcript, header, public_io

VERSION = 1
COLUMNS = 43

NAMES = ("execution", "roots", "openings", "proof_bytes")
LIMITS = {name: 0 for name in NAMES}


@dataclass
class Expected:
    """What the reference works out for one prove."""

    execution: rv64.Execution
    num_vars: int
    roots: List[bytes]
    forest: Optional[forest.Forest]
    matrix: np.ndarray
    proof: bytes


def expect(program: bytes, input_tape, max_steps: int, config: dict, device, lazy: bool = False) -> Expected:
    """Execute the guest, build its witness, the forest and the whole proof.
    `lazy` is the control: evaluations without the reduction after each fold."""
    p = config["modulus"]
    entry, segments = rv64.parse_elf(program)
    ex = rv64.execute(entry, segments, input_tape, max_steps)
    v = rv64.num_vars(ex.steps)
    matrix = rv64.witness_matrix(ex, p)
    trees = forest.build(matrix, device)
    exp = Expected(ex, v, trees.roots(), trees, matrix, b"")
    exp.proof = _prove_v1(program, exp, p, device, lazy)
    return exp


def control(program: bytes, input_tape, max_steps: int, config: dict, device) -> bytes:
    """The control in the program's place: the reference's whole proof with
    the reduction after each fold of an evaluation left out (a shortcut that
    breaks the exactness the configuration states)."""
    return expect(program, input_tape, max_steps, config, device, lazy=True).proof


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


def compare(data: bytes, exp: Expected, program: bytes, config: dict, device) -> Dict[str, int]:
    """The counts for one proof's bytes against the reference's `exp`."""
    p = config["modulus"]
    out = {name: 0 for name in NAMES}
    ref = exp.proof
    size = min(len(data), len(ref))
    diff = np.frombuffer(data[:size], np.uint8) != np.frombuffer(ref[:size], np.uint8)
    out["proof_bytes"] = int(diff.sum()) + abs(len(data) - len(ref))
    try:
        got = parse(data)
    except (ParseError, ValueError) as exc:
        out.update(execution=1, roots=COLUMNS, openings=COLUMNS)
        out["unreadable"] = str(exc)
        return out
    ex, v = exp.execution, exp.num_vars
    want = dict(version=VERSION, modulus=p, steps=ex.steps, num_vars=v, io_steps=ex.steps,
                program_hash=hashlib.sha256(program).digest(), initial_pc=ex.entry_pc,
                final_pc=ex.final_pc, initial_regs=[])
    out["execution"] = sum(getattr(got, k) != w for k, w in want.items())
    out["execution"] += sum(a != b for a, b in zip(got.final_regs, ex.final_regs)) + abs(len(got.final_regs) - 32)
    out["execution"] += sum(a != b for a, b in zip(got.outputs, ex.outputs)) + abs(len(got.outputs) - len(ex.outputs))
    out["roots"] = sum(o.root != r for o, r in zip(got.openings, exp.roots))
    if got.num_vars != v:
        out["openings"] = COLUMNS
        return out
    points = np.stack([o.point for o in got.openings]) if v else np.zeros((COLUMNS, 0), np.uint64)
    values = forest.evaluate(exp.matrix, points, p, device)
    index = np.array([o.index for o in got.openings], dtype=np.int64)
    bad = (index < 0) | (index >= 1 << v)
    siblings = exp.forest.siblings(np.where(bad, 0, index))
    for i, o in enumerate(got.openings):
        ok = not bad[i] and o.index == (int(o.point[0]) % (1 << v) if v else 0)
        ok = ok and o.leaf == int(exp.matrix[i, o.index]) and o.value == int(values[i]) == o.proof_value
        ok = ok and o.siblings == siblings[i].tobytes()
        ok = ok and o.directions == bytes((o.index >> k) & 1 for k in range(v))
        out["openings"] += not ok
    return out


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
