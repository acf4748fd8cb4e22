"""Protocol v2's Lasso records, recomputed from the reference's own run.

Each step of an ALU, word, multiply or divide instruction, a load, a
store or a branch is one query of one table (table ids: ADD SUB AND OR XOR
SLL SRL SRA SLT SLTU BEQ LOAD STORE, then ADDW SUBW SLLW SRLW SRAW, MUL
MULH MULHSU MULHU MULW, DIV DIVU REM REMU DIVW DIVUW REMW REMUW). Its
inputs are the two source operands (rs1 and rs2, or rs1 and the
immediate; for a load or store the address and the value; a branch adds
its funct3), its output the value the step wrote (the operation's result
where it writes x0; for a branch 1 if it jumped; for a memory access the
value). All values are the full 64 bits.

A query row hashes to one field element by an XXH3-64 chain (seed 0): h =
0, and for each input and then the output, h = XXH3(h ^ value as 8 LE
bytes), the result mod p. A table's record is a sumcheck over those
elements, zero-padded to a power of two: claimed sum, a SHA3-256 of the
padded elements as u64 LE (the query commitment), then per round the
coefficients g0 (the lower half's sum), g1 - g0 and 0, absorbed as field
elements before the challenge that folds the lower half by 1 - r and the
upper half by r.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from . import rv64

P = 2013265921
M64 = (1 << 64) - 1
LOAD_T, STORE_T, BRANCH_T = 11, 12, 10
ALU = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9)
ADD, SUB, AND, OR, XOR, SLL, SRL, SRA, SLT, SLTU = ALU
ADDW, SUBW, SLLW, SRLW, SRAW = 13, 14, 15, 16, 17
MULS = {0: 18, 1: 19, 2: 20, 3: 21, 4: 23, 5: 24, 6: 25, 7: 26}  # OP, funct7 = 1, by funct3
MULWS = {0: 22, 4: 27, 5: 28, 6: 29, 7: 30}  # OP-32, funct7 = 1

# XXH3-64 of an 8-byte input (its 4-to-8-byte path) with seed 0: bytes 8-23
# of the default secret.
_SECRET_8 = 0x1CAD21F72C81017C
_SECRET_16 = 0xDB979083E96DD4DE
_PRIME_MX2 = 0x9FB21C651E98DF25


def _u(x: int) -> np.uint64:
    return np.uint64(x & M64)


def xxh3_u64(values: np.ndarray) -> np.ndarray:
    """XXH3-64 (seed 0) of each value's 8 little-endian bytes."""
    x = np.asarray(values, dtype=np.uint64)
    lo, hi = x & _u(0xFFFFFFFF), x >> _u(32)
    keyed = (hi + (lo << _u(32))) ^ _u(_SECRET_8 ^ _SECRET_16)
    with np.errstate(over="ignore"):
        h = keyed ^ ((keyed << _u(49)) | (keyed >> _u(15))) ^ ((keyed << _u(24)) | (keyed >> _u(40)))
        h = h * _u(_PRIME_MX2)
        h = h ^ ((h >> _u(35)) + _u(8))
        h = h * _u(_PRIME_MX2)
    return h ^ (h >> _u(28))


def table_ids(op, f3, f7) -> np.ndarray:
    """Each step's table, -1 for none, from its decoded fields."""
    out = np.full(op.shape, -1, dtype=np.int64)
    alt = (f7 & 0x20) != 0
    by_f3 = np.array([ADD, SLL, SLT, SLTU, XOR, SRL, OR, AND])[f3]
    base = np.where((f3 == 0) & alt, SUB, np.where((f3 == 5) & alt, SRA, by_f3))
    out = np.where((op == rv64.OP) & ((f7 == 0) | (f7 == 0x20)), base, out)
    out = np.where(op == rv64.OP_IMM, np.where((f3 == 5) & alt, SRA, by_f3), out)
    muls = np.array([MULS[k] for k in range(8)])[f3]
    out = np.where((op == rv64.OP) & (f7 == 1), muls, out)
    mulws = np.array([MULWS.get(k, -1) for k in range(8)])[f3]
    out = np.where((op == rv64.OP_32) & (f7 == 1), mulws, out)
    words = np.where(f3 == 0, ADDW, np.where(f3 == 1, SLLW, np.where(alt, SRAW, SRLW)))
    words = np.where((op == rv64.OP_32) & (f3 == 0) & alt, SUBW, words)
    is_word = ((op == rv64.OP_32) & ((f7 == 0) | (f7 == 0x20))) | (op == rv64.OP_IMM_32)
    out = np.where(is_word & np.isin(f3, (0, 1, 5)), words, out)
    out = np.where(op == rv64.LOAD, LOAD_T, out)
    out = np.where(op == rv64.STORE, STORE_T, out)
    return np.where(op == rv64.BRANCH, BRANCH_T, out)


def _sext32(v: int) -> int:
    return rv64._sext(v & rv64.M32, 32) & M64


def semantics(tid: int, a: int, b: int) -> int:
    """A table's result for operands a and b (u64), from the RV64IM
    definitions."""
    if tid in ALU:
        f3, alt = {ADD: (0, False), SUB: (0, True), SLL: (1, False), SLT: (2, False), SLTU: (3, False),
                   XOR: (4, False), SRL: (5, False), SRA: (5, True), OR: (6, False), AND: (7, False)}[tid]
        return rv64._alu(f3, alt, a, b)
    if tid in MULS.values():
        return rv64._mul_div(next(k for k, t in MULS.items() if t == tid), a, b, 64)
    if tid in MULWS.values():
        return _sext32(rv64._mul_div(next(k for k, t in MULWS.items() if t == tid), a, b, 32))
    s = b & 31
    return {ADDW: lambda: _sext32(a + b), SUBW: lambda: _sext32(a - b), SLLW: lambda: _sext32(a << s),
            SRLW: lambda: _sext32((a & rv64.M32) >> s),
            SRAW: lambda: _sext32(rv64._sext(a & rv64.M32, 32) >> s)}[tid]()


def step_columns(ex: rv64.Execution) -> Dict[str, np.ndarray]:
    """Per step: the decoded fields, the source registers' values before
    the step, the destination's after it, the memory access and the next pc."""
    n = ex.steps
    pcs = sorted(ex.decoded)
    table = np.array([ex.decoded[pc] for pc in pcs], dtype=np.int64)
    fields = table[np.searchsorted(np.array(pcs, dtype=np.uint64), ex.pcs)]
    op, rd, f3, rs1, rs2, f7, imm = (fields[:, k] for k in range(7))
    rs1v, rs2v, rdv = (np.zeros(n, dtype=np.uint64) for _ in range(3))
    for r in range(1, 32):
        sel = ex.write_reg == r
        if not sel.any():
            continue
        last = np.full(n, -1, dtype=np.int64)
        last[ex.write_step[sel]] = np.flatnonzero(sel)
        np.maximum.accumulate(last, out=last)
        after = np.where(last >= 0, ex.write_val[np.maximum(last, 0)], np.uint64(0))
        before = np.concatenate([np.zeros(1, np.uint64), after[:-1]])
        rs1v[rs1 == r] = before[rs1 == r]
        rs2v[rs2 == r] = before[rs2 == r]
        rdv[rd == r] = after[rd == r]
    addr, val = np.zeros(n, dtype=np.uint64), np.zeros(n, dtype=np.uint64)
    addr[ex.mem_step], val[ex.mem_step] = ex.mem_addr, ex.mem_val
    next_pc = np.append(ex.pcs[1:], np.uint64(ex.final_pc))
    return dict(op=op, rd=rd, f3=f3, rs1=rs1, rs2=rs2, f7=f7, imm=imm.astype(np.uint64), rs1v=rs1v, rs2v=rs2v,
                rdv=rdv, addr=addr, val=val, pc=ex.pcs, next_pc=next_pc)


def queries(ex: rv64.Execution) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    """table id -> (inputs (k, 2 or 3), outputs (k,)) u64, in step order."""
    c = step_columns(ex)
    tids = table_ids(c["op"], c["f3"], c["f7"])
    out = {}
    for tid in sorted(set(tids.tolist()) - {-1}):
        m = tids == tid
        op = c["op"][m]
        is_mem = (op == rv64.LOAD) | (op == rv64.STORE)
        is_imm = (op == rv64.OP_IMM) | (op == rv64.OP_IMM_32)
        in0 = np.where(is_mem, c["addr"][m], c["rs1v"][m])
        in1 = np.where(is_mem, c["val"][m], np.where(is_imm, c["imm"][m], c["rs2v"][m]))
        if tid == BRANCH_T:
            res = (c["next_pc"][m] != c["pc"][m] + np.uint64(4)).astype(np.uint64)
            out[tid] = (np.stack([in0, in1, c["f3"][m].astype(np.uint64)], axis=1), res)
            continue
        res = np.where(is_mem, c["val"][m], c["rdv"][m])
        if tid not in (LOAD_T, STORE_T):
            for k in np.flatnonzero(c["rd"][m] == 0):  # a write to x0 is dropped; the query keeps the result
                res[k] = semantics(tid, int(in0[k]), int(in1[k]))
        out[tid] = (np.stack([in0, in1], axis=1), res)
    return out


def hash_rows(inputs: np.ndarray, outputs: np.ndarray) -> np.ndarray:
    h = np.zeros(inputs.shape[0], dtype=np.uint64)
    for k in range(inputs.shape[1]):
        h = xxh3_u64(h ^ inputs[:, k])
    return xxh3_u64(h ^ outputs) % np.uint64(P)


@dataclass
class Table:
    table_id: int
    lookups: int
    evals: np.ndarray  # the padded query elements
    claimed: int
    commitment: bytes


def tables(ex: rv64.Execution) -> List[Table]:
    out = []
    for tid, (inputs, outputs) in queries(ex).items():
        k = inputs.shape[0]
        evals = np.zeros(1 if k <= 1 else 1 << (k - 1).bit_length(), dtype=np.uint64)
        evals[:k] = hash_rows(inputs, outputs)
        out.append(Table(tid, k, evals, int(evals.sum()) % P,
                         hashlib.sha3_256(evals.astype("<u8").tobytes()).digest()))
    return out


def sumcheck(evals: np.ndarray, challenge) -> Tuple[List[Tuple[int, int, int]], List[int], int]:
    """(round coefficients, point, final value) of one table's record;
    `challenge(coefficients)` absorbs a round's coefficients and returns
    its challenge."""
    cur = evals.astype(np.uint64)
    rounds, point = [], []
    p = np.uint64(P)
    while cur.shape[0] > 1:
        half = cur.shape[0] // 2
        g0, g1 = int(cur[:half].sum()) % P, int(cur[half:].sum()) % P
        coeffs = (g0, (g1 - g0) % P, 0)
        rounds.append(coeffs)
        r = challenge(coeffs)
        point.append(r)
        cur = (np.uint64((1 - r) % P) * cur[:half] % p + np.uint64(r) * cur[half:] % p) % p
    return rounds, point, int(cur[0])
