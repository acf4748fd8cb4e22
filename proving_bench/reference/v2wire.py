"""A reader of the protocol v2 wire format, written from its layout.

Every integer is little-endian. The proof is, in order:

* the header and the public IO (`proof.header`, `proof.public_io`);
* the Lasso records: u32 count, then per table (ids ascending) u32 id |
  u64 lookups | u32 variables | per round three u64 coefficients | the
  point (one u64 a variable) | u64 final value;
* the 43 witness openings, as in protocol v1: 32-byte root | point | u64
  value | u64 value | u64 index | u64 leaf | u32 height | siblings | one
  byte a direction;
* the v2 section: the core zerocheck | Lasso extras (u32 count; per table
  u32 id, u64 claimed sum, 32-byte query commitment) | u64 logUp nonce,
  ext logUp sum | lookup validity | register check | memory check |
  bytecode | the unified commitments.

An extension value (BabyBear^4) is four u64 coordinates. A zerocheck is
u8 kind (1: extension) | u32 variables | u32 degree | per round degree + 1
values | the point | its terminal column evaluations in sorted-name
order. The number of those evaluations is not on the wire: it is fixed by
the argument the zerocheck belongs to, and the constants below hold it,
with the number of constraint-combination challenges the zerocheck draws
(which the transcript replay needs).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

P = 2013265921
WITNESS_COLUMNS = 43

# Per argument: (terminal evaluations, combination challenges) of each of
# its zerochecks. The core argument's columns are is_read, next_pc, pc,
# seq, x0 and two logUp inverse columns of four coordinates each.
CORE = (13, 6)
REGCHECK = ((36 + 4 * 13, 26), (1 + 4, 1))
MEMCHECK = ((21 + 4 * 6, 18), (1 + 4, 1))
BYTECODE = ((71 + 4 * 19 + 15 + 3, 93), (1 + 4, 1), (1 + 4, 1), (4 + 7, 1))
RC_SUMS, MC_SUMS, BC_RANGE_SUMS, BC_BYTE_SUMS = 13, 6, 8, 4
# Lookup validity gadgets by table id: (committed columns, logUp inverse
# columns, constraints). A table's zerocheck evaluates the columns and four
# coordinates of each inverse column, and draws one challenge a constraint.
GADGETS = {
    0: (16, 3, 11), 1: (16, 3, 11), 2: (24, 2, 2), 3: (24, 2, 2), 4: (24, 2, 2), 5: (47, 7, 40),
    6: (56, 7, 51), 7: (62, 8, 58), 8: (21, 4, 17), 9: (17, 3, 12), 10: (41, 4, 38), 13: (16, 3, 11),
    14: (16, 3, 11), 15: (35, 5, 30), 16: (42, 5, 39), 17: (44, 5, 41), 18: (47, 12, 28), 19: (67, 17, 45),
    20: (65, 16, 42), 21: (47, 12, 28), 22: (49, 12, 30), 23: (134, 23, 168), 24: (65, 14, 58),
    25: (134, 23, 168), 26: (65, 14, 58), 27: (82, 14, 95), 28: (45, 10, 38), 29: (82, 14, 95),
    30: (45, 10, 38),
}


class ParseError(Exception):
    pass


@dataclass
class Zerocheck:
    num_vars: int
    degree: int
    rounds: List[List[Tuple[int, ...]]]  # per round: degree + 1 extension values
    point: List[Tuple[int, ...]]
    evals: List[Tuple[int, ...]]
    alphas: int  # combination challenges it draws (from the schema)
    start: int  # its offset in the proof


@dataclass
class LassoRecord:
    table_id: int
    lookups: int
    num_vars: int
    rounds: List[Tuple[int, int, int]]
    point: List[int]
    final: int


@dataclass
class Opening:
    root: bytes
    point: List[int]
    value: int
    proof_value: int
    index: int
    leaf: int
    siblings: bytes
    directions: bytes


@dataclass
class Ligero:
    n: int
    us: List[List[int]]  # extension rows, four coordinate rows of n each, coordinate-major
    ws: List[bytes]
    t: int
    rows: int
    columns: List[bytes]  # each opened column's rows as u32 LE
    column_values: List[List[int]]
    nodes: List[bytes]


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
    lasso: List[LassoRecord]
    openings: List[Opening]
    core: Zerocheck = None
    extras: List[Tuple[int, int, bytes]] = field(default_factory=list)
    logup_nonce: int = 0
    logup_sum: Tuple[int, ...] = ()
    lv_nonce: int = 0
    lv_tables: List[dict] = field(default_factory=list)  # id, queries, vars, zc, g_sums
    lv_side: Optional[dict] = None  # names, zc, h_sums
    rc: Optional[dict] = None
    mc: Optional[dict] = None
    bc: Optional[dict] = None
    data_root: Optional[bytes] = None
    advice_root: Optional[bytes] = None
    batch: Optional[dict] = None  # num_vars, rounds, point, evals [(kind, name, value)]
    data_open: Optional[Ligero] = None
    advice_open: Optional[Ligero] = None
    sections: Dict[str, Tuple[int, int]] = field(default_factory=dict)  # name -> byte span
    end: int = 0


class Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            raise ParseError(f"the proof ends at {len(self.data)}, {n} more bytes wanted at {self.pos}")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u(self, fmt: str):
        return struct.unpack("<" + fmt, self.take(struct.calcsize("<" + fmt)))

    def u8(self) -> int:
        return self.u("B")[0]

    def u16(self) -> int:
        return self.u("H")[0]

    def u32(self) -> int:
        return self.u("I")[0]

    def u64(self) -> int:
        return self.u("Q")[0]

    def ext(self) -> Tuple[int, ...]:
        x = self.u("4Q")
        if any(c >= P for c in x):
            raise ParseError(f"an extension coordinate is not canonical at {self.pos - 32}")
        return x

    def exts(self, n: int) -> List[Tuple[int, ...]]:
        return [self.ext() for _ in range(n)]


def _zerocheck(r: Reader, evals: int, alphas: int) -> Zerocheck:
    start = r.pos
    if r.u8() != 1:
        raise ParseError(f"a zerocheck at {start} is not over the extension field")
    v, d = r.u32(), r.u32()
    if d > 64 or v > 40:
        raise ParseError(f"a zerocheck at {start} states {v} variables of degree {d}")
    rounds = [r.exts(d + 1) for _ in range(v)]
    point = r.exts(v)
    return Zerocheck(v, d, rounds, point, r.exts(evals), alphas, start)


def _ligero(r: Reader) -> Ligero:
    n = r.u32()
    if n > 1 << 28:
        raise ParseError("a Ligero row longer than 2^28")
    us = [list(struct.unpack(f"<{4 * n}I", r.take(16 * n))) for _ in range(r.u32())]
    ws = [r.take(16 * n) for _ in range(r.u32())]
    t, rows = r.u32(), r.u32()
    columns = [r.take(4 * rows) for _ in range(t)]
    values = [list(struct.unpack(f"<{rows}I", c)) for c in columns]
    if any(x >= P for vals in values for x in vals) or any(x >= P for u in us for x in u):
        raise ParseError("a Ligero value is not canonical")
    count = r.u32()
    if count > 1 << 24:
        raise ParseError("too many Merkle nodes")
    return Ligero(n, us, ws, t, rows, columns, values, [r.take(32) for _ in range(count)])


def parse(data: bytes) -> Parsed:
    """Read the whole v2 proof; `ParseError` where it cannot be read."""
    r = Reader(data)
    if r.take(4) != b"ZIGZ":
        raise ParseError("no magic")
    version, modulus, steps, v, _ = r.u("IQQII")
    program_hash = r.take(32)
    initial_pc, final_pc = r.u("QQ")
    initial = [r.u64() for _ in range(r.u32())]
    final = [r.u64() for _ in range(r.u32())]
    io_steps = r.u64()
    outputs = [r.u64() for _ in range(r.u32())]
    sections = {"head": (0, r.pos)}

    start = r.pos
    lasso = []
    for _ in range(r.u32()):
        tid, lookups, nv = r.u32(), r.u64(), r.u32()
        if nv > 40:
            raise ParseError(f"a Lasso record of {nv} variables")
        rounds = [r.u("3Q") for _ in range(nv)]
        lasso.append(LassoRecord(tid, lookups, nv, rounds, [r.u64() for _ in range(nv)], r.u64()))
    sections["lasso"] = (start, r.pos)

    start = r.pos
    openings = []
    for _ in range(WITNESS_COLUMNS):
        root = r.take(32)
        point = [r.u64() for _ in range(v)]
        value, proof_value, index, leaf = r.u("QQQQ")
        height = r.u32()
        if height > 64:
            raise ParseError(f"an opening of height {height}")
        openings.append(Opening(root, point, value, proof_value, index, leaf, r.take(32 * height), r.take(height)))
    sections["witness"] = (start, r.pos)
    out = Parsed(version, modulus, steps, v, program_hash, initial_pc, final_pc, initial, final, io_steps, outputs,
                 lasso, openings, sections=sections)

    start = r.pos
    out.core = _zerocheck(r, *CORE)
    ext_start = r.pos
    out.extras = [(r.u32(), r.u64(), r.take(32)) for _ in range(r.u32())]
    sections["extras"] = (ext_start, r.pos)
    out.logup_nonce, out.logup_sum = r.u64(), r.ext()

    out.lv_nonce = r.u64()
    for _ in range(r.u32()):
        tid, queries, nv = r.u32(), r.u64(), r.u32()
        if tid not in GADGETS:
            raise ParseError(f"no validity gadget for table {tid}")
        cols, gs, alphas = GADGETS[tid]
        zc = _zerocheck(r, cols + 4 * gs, alphas)
        out.lv_tables.append(dict(id=tid, queries=queries, vars=nv, zc=zc, g_sums=r.exts(gs)))
    if r.u8():
        names = [r.take(r.u8()).decode("ascii", "replace") for _ in range(r.u32())]
        zc = _zerocheck(r, 5 * len(names), len(names))
        out.lv_side = dict(names=names, zc=zc, h_sums=r.exts(len(names)))

    if not r.u8():
        raise ParseError("no register check")
    rc = dict(nonce=r.u64(), vars=r.u32(), final_ts=[r.u64() for _ in range(32)])
    rc["zc"], rc["zc_table"] = _zerocheck(r, *REGCHECK[0]), _zerocheck(r, *REGCHECK[1])
    rc["g_sums"], rc["h_sum"] = r.exts(RC_SUMS), r.ext()
    out.rc = rc

    if not r.u8():
        raise ParseError("no memory check")
    mc = dict(nonce=r.u64(), vars=r.u32(), accesses=r.u64())
    mc["touched"] = [r.u("QQQ") for _ in range(r.u32())]
    mc["zc"], mc["zc_table"] = _zerocheck(r, *MEMCHECK[0]), _zerocheck(r, *MEMCHECK[1])
    mc["g_sums"], mc["h_sum"] = r.exts(MC_SUMS), r.ext()
    out.mc = mc

    if not r.u8():
        raise ParseError("no bytecode argument")
    bc = dict(nonce=r.u64(), vars=r.u32(), table_vars=r.u32())
    bc["zcs"] = [_zerocheck(r, *s) for s in BYTECODE]
    for name in ("g", "h", "gc1", "gc2", "gout"):
        bc[name] = r.ext()
    bc["gr"], bc["hr"], bc["gm"] = r.exts(BC_RANGE_SUMS), r.ext(), r.exts(BC_BYTE_SUMS)
    for name in ("gb1", "gb2", "wg", "glk"):
        bc[name] = r.ext()
    bc["links"] = []
    for _ in range(r.u32()):
        tid, queries, nv = r.u32(), r.u64(), r.u32()
        if tid not in GADGETS:
            raise ParseError(f"no link gadget for table {tid}")
        zc = _zerocheck(r, GADGETS[tid][0] + 4, 1)
        bc["links"].append(dict(id=tid, queries=queries, vars=nv, zc=zc, g_sum=r.ext()))
    out.bc = bc
    sections["arguments"] = (start, r.pos)

    start = r.pos
    flags = r.u8()
    if flags != 31:
        raise ParseError(f"unified flags {flags}: a v2 proof has both roots, a batch and both openings")
    out.data_root, out.advice_root = r.take(32), r.take(32)
    nv = r.u32()
    if nv > 40:
        raise ParseError(f"a batch evaluation of {nv} variables")
    batch = dict(num_vars=nv, rounds=[r.exts(3) for _ in range(nv)])
    batch["point"] = r.exts(nv)
    evals = []
    for _ in range(r.u32()):
        kind = r.u8()
        name = r.take(r.u16()).decode("utf-8", "replace")
        evals.append((kind, name, r.ext()))
    batch["evals"] = evals
    out.batch = batch
    sections["batch"] = (start, r.pos)
    start = r.pos
    out.data_open, out.advice_open = _ligero(r), _ligero(r)
    sections["ligero"] = (start, r.pos)
    out.end = r.pos
    return out
