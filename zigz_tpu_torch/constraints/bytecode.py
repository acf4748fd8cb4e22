"""Bytecode (fetch + decode) argument: every executed step runs the
instruction the PUBLIC program stores at its pc.

The reference never constrains fetch or decode — the witness's
opcode/funct/rs/imm columns are unchecked advice (witness.zig:134-215),
and our round-2 regcheck/validity arguments inherited that gap: the
committed access cells (a1/a2/a3) and query/selector columns were advice
too.  This module closes it with a Jolt-style *bytecode memory check*
(Jolt's read-only bytecode argument, built here as a logUp):

* The verifier DECODES THE PROGRAM ITSELF.  Every address whose 4-byte
  little-endian window (over the initial memory image; unmapped bytes
  read 0, memory.zig:35-37) has a nonzero opcode field is a table entry
  carrying the full static decode tuple: read cells (rs1, rs2), the
  static write cell, funct3, the v2 lookup-table id, the sequential-pc
  flag, the 4x16-bit limbs of the u64-bitcast immediate, and the
  per-class selector flags the other v2 arguments consume.  A step can
  only execute a decodable word (decode(0) rejects and the VM halts
  without recording, state.py:step), so every traced pc IS in the table.

* Per step, the prover commits the SAME tuple as columns over the trace
  domain, and a logUp multiset inclusion (committed multiplicities over
  the program domain; fingerprints drawn after both commitments) forces
  every step's tuple to equal the table row at its pc:

      sum_steps sel(x)/(tau - kappa(x)) == sum_addrs m(j)/(tau - kappa_j)

  kappa combines the slots with powers of gamma; the pc slot makes the
  tuple injective per address.  pc itself is the Ligero-committed v2
  zerocheck column, anchored at PublicIO.initial_pc here (eq_0
  constraint) and chained by the c5/c6 shift argument — so the pc
  stream, and with it every decoded field, is grounded in the public
  program.

* SYSTEM steps additionally expose the syscall state: their table rows
  read cells (17, 10) = (a7, a0) — the regcheck extraction mirrors this
  — and committed c_read/c_commit flags select the ECALL kind from the
  PROVEN a7 value (rv1), with the write cell tied to
  a3 = (1-fsys)*wrs + 10*fsys*c_read: exactly ECALL_READ writes a0
  (state.py:_exec_system), everything else writes the static cell.

Output-tape binding (built here, on top of the proven c_commit flag):
a committed commit-counter column cnt with cnt(0) = 0 and
cnt(x+1) = cnt(x) + c_commit(x) (the same index-shift logUp as the
v2 PC chain, over public idx/selector MLEs), plus a logUp equating
the multiset {(cnt, a0-value limbs) at commit steps} with the PUBLIC
{(j, outputs[j] limbs)} — the j-th committed output IS the a0 value
(= the regcheck-proven rv2 read) at the j-th ECALL_COMMIT.  The
public side is small, so the verifier evaluates its logUp sum
directly (no table commitment); counter keys are injective and the
value limbs are 16-bit (regcheck RANGE16), so multiset equality
pins order, count, and every value exactly.

Beyond fetch/decode, this module's step-domain zerocheck is the hub for
the remaining execution semantics (all over PROVEN columns):

* CONTROL FLOW — branch targets pc+imm*taken+4*(1-taken) with the
  table-linked taken bit, JAL targets, ECALL pc+4, EBREAK halt-in-place,
  link-register values via fetch-proven pc limbs, LUI/AUIPC write
  values, and JALR/AUIPC/memory addressing through a 4-limb mod-2^64
  adder whose output limbs are checked by an in-argument RANGE16 logUp.
* WITNESS LINKAGE — a logUp multiset equality between per-step
  (table, in0, in1, out) tuples and the lookup-validity argument's
  committed queries (constraints/linkage.py), with result limbs tied to
  the regcheck write value whenever rd != 0.
* MEMORY LINKAGE — per-byte tuples (position from a committed byte
  counter, adder-output base limbs, offset, value byte, store flag)
  equated with the memcheck byte rows; store bytes tied to rs2, loaded
  values tied to the rd write via per-funct3 sign/zero extension.
* COMPLETENESS — every ALU-class/load/store word must decode onto
  exactly one valid gadget table, so invalid encodings (which trap in
  the VM) have no satisfying assignment.
* PUBLIC ANCHORS — entry pc, final pc, and the output tape binding
  described above.

Soundness preconditions (asserted at prove time, verifier-enforced
where public): program addresses < 2^29 (ADDR_BOUND — keeps the mod-p
control-flow target equations exact) and no self-modifying code (the
table decodes the INITIAL image; stores that overwrite later-executed
code would make honest proving fail, never unsound verification).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from ..core.ext4 import (
    MAX_NONCE,
    Ext4,
    challenge_ext,
    ext_lift,
    high_coords_nonzero,
)
from ..isa.rv64i import Opcode
from ..lookups.pipeline_lasso import TABLE_IDS, v2_lookup_ids
from ..poly.public_mles import (
    eq_zero_eval,
    idx_eval,
    idx_table,
    le_indicator_eval,
    le_table,
    np_inv,
)
from ..proofs.zerocheck import (
    ZerocheckExtProver,
    ZerocheckExtVerifier,
    ZerocheckProof,
    absorb_ext,
    unified_dev_columns,
    unified_device,
)
from .regcheck import g_coord_names, g_eval_from_coords, pack_g_coords, sum_claim_values

__all__ = [
    "BYTECODE_SLOTS",
    "BytecodeProof",
    "BytecodeArgument",
    "BytecodeVerify",
    "build_bytecode_table",
    "step_static_columns",
    "BYTECODE_DEGREE",
]

_M16 = np.uint64(0xFFFF)
_M64 = np.uint64(0xFFFFFFFFFFFFFFFF)
_int64_mask = (1 << 64) - 1
# Program addresses must stay below 2^29 (verifier-enforced): with branch
# offsets < 2^13 and JAL offsets < 2^21, every pc + simm stays inside
# (-2^21, 2^29 + 2^21), a window where mod-p congruence to a table
# address (< 2^29) pins the integer value exactly.
ADDR_BOUND = 1 << 29
# Step columns RANGE16-checked inside this argument: (column, coefficient)
# — the scaled value must lie in [0, 2^16).  jt limbs make the adder
# exact; 2*jh bounds jh < 2^15 so t_0 = 2*jh + jlsb is a true bit split.
MEMLINK_DEGREE = 3  # deg(eq * g_lnk * kappa) on the byte domain
RANGED = (("jt_0", 1), ("jt_1", 1), ("jt_2", 1), ("jt_3", 1), ("jh", 2),
          ("vb_0", 256), ("vb_1", 256), ("vb_2", 256), ("vb_3", 256),
          ("vb_4", 256), ("vb_5", 256), ("vb_6", 256), ("vb_7", 256),
          ("vhi0", 256), ("rl", 512))
# RANGE16 fractions and the 8 per-byte memcheck-link fractions are
# committed MERGED in pairs (round 4): one advice column carries
# 1/d_a + 1/d_b (resp. sel_a/d_a + sel_b/d_b), pinned per row by
# gq * d_a * d_b == d_b + d_a (resp. sel_a*d_b + sel_b*d_a) — degree 3,
# within the existing BYTECODE_DEGREE budget.  Grand equations consume
# only the TOTAL fraction sums, so they are unchanged in value; this
# halves the range/mem-link advice data and sum claims.
RANGE_GROUPS = tuple(tuple(RANGED[i : i + 2]) for i in range(0, len(RANGED), 2))
GR_NAMES = tuple(f"grp{i}" for i in range(len(RANGE_GROUPS)))
GM_GROUPS = tuple((2 * i, 2 * i + 1) for i in range(4))
GM_NAMES = tuple(f"gmp{i}" for i in range(len(GM_GROUPS)))

# Fingerprint slot order (gamma^1..gamma^len assigned in this order; the
# pc slot is gamma^1).  "a1"/"a2" are the regcheck read cells; all other
# slots are columns of the linkage commitment (step side) / public decode
# outputs (table side).
BYTECODE_SLOTS = (
    "pc", "a1", "a2", "wrs", "f3", "tbl1", "seqb",
    "imm_0", "imm_1", "imm_2", "imm_3",
    "fsys", "fecall", "fimm", "frs2", "fwr",
    "fbr", "fjal", "fjalr", "fneg", "flk",
    # Control-flow slots: the pc's 16-bit limbs (table side: address
    # limbs, free range proof since the verifier builds the table), the
    # EBREAK/LUI/AUIPC class flags, and rd != 0 (gates write-value
    # semantics; x0 writes are architecturally discarded).
    "pcl0", "pcl1", "febrk", "flui", "faui", "fnz",
    # Memory-op decode flags for the LOAD/STORE linkage: raw class flags
    # plus per-funct3 one-hots (completeness constraints force every
    # executed mem word onto exactly one valid funct3).
    "fload", "fstore",
    "flb", "flbu", "flh", "flhu", "flw", "flwu", "fld",
    "fsb", "fsh", "fsw", "fsd",
    # ALU-class flag: OP/OP_32/OP_IMM/OP_IMM_32 steps MUST be
    # gadget-covered (falucls * (1 - flk) = 0) — otherwise a word with a
    # garbage funct7 (never executable: the VM traps) would be a free
    # register write in a forged trace.
    "falucls",
)
# Step-side committed columns (the linkage commitment): every slot that
# is not already committed elsewhere (pc lives in the v2 PCS; a1/a2 in
# the regcheck commitment) plus the syscall-kind machinery.
LINK_COLUMNS = tuple(s for s in BYTECODE_SLOTS if s not in ("pc", "a1", "a2")) + (
    "c_read", "c_commit", "inv_r", "inv_c", "cnt",
    # Witness-linkage slots (constraints/linkage.py): the lookup result
    # limbs (tied to the regcheck write value whenever fwr = 1) and the
    # branch taken bit (tied to the branch table's proven output).
    "res_0", "res_1", "res_2", "res_3", "taken_b",
    # pc+4 carry bit for the JAL/JALR link-register value.
    "pc4c",
    # JALR/AUIPC/LOAD/STORE 4-limb adder: t = (x + imm) mod 2^64 with
    # x = pc (AUIPC) or rv1 (JALR/mem address); jt limbs are
    # RANGE16-checked, carries are boolean, and jh/jlsb split t_0 for
    # JALR's &~1 target.
    "jt_0", "jt_1", "jt_2", "jt_3", "jc_0", "jc_1", "jc_2", "jc_3",
    "jh", "jlsb",
    # LOAD/STORE linkage: cumulative byte counter, the access value's
    # bytes, the SB high-byte split, and the load sign-byte split.
    "bcnt", "vb_0", "vb_1", "vb_2", "vb_3", "vb_4", "vb_5", "vb_6", "vb_7",
    "vhi0", "sgn", "rl",
)
# Referenced external columns (prefixed in the zerocheck column dict).
# rv2 is the a0 value at SYSTEM steps (system_read_override) — the
# committed output the tape binding consumes.
_REG_REFS = ("a1", "a2", "a3", "rv1_0", "rv1_1", "rv1_2", "rv1_3",
             "rv2_0", "rv2_1", "rv2_2", "rv2_3",
             "wv_0", "wv_1", "wv_2", "wv_3")
_PCS_REFS = ("pc", "seq", "next_pc")

BYTECODE_DEGREE = 4  # deg(eq * C); the ECALL completeness gadgets are deg 3
NUM_BC_CONSTRAINTS = 93

# Opcode classes that architecturally write rd (state.py:_exec_*).
_WRITES_RD = (
    Opcode.OP, Opcode.OP_32, Opcode.OP_IMM, Opcode.OP_IMM_32,
    Opcode.LOAD, Opcode.LUI, Opcode.AUIPC, Opcode.JAL, Opcode.JALR,
)
_NONSEQ = (Opcode.BRANCH, Opcode.JAL, Opcode.JALR, Opcode.SYSTEM)
# Gadget-covered v2 tables (lookups/validity.py GADGETS): the ten 64-bit
# ALU tables, the shared branch table, and the five word-op tables.
_GADGET_IDS = (tuple(range(10)) + (TABLE_IDS["BEQ"],)
               + tuple(TABLE_IDS[n] for n in ("ADDW", "SUBW", "SLLW",
                                              "SRLW", "SRAW",
                                              "MUL", "MULH", "MULHSU",
                                              "MULHU", "MULW",
                                              "DIV", "DIVU", "REM", "REMU",
                                              "DIVW", "DIVUW", "REMW",
                                              "REMUW")))


def decode_fields(words: np.ndarray):
    """Vectorized twin of isa/rv64i.decode for uint32 word arrays.

    Returns (op, rd, f3, rs1, rs2, f7, imm_u64) with imm the u64 bitcast
    of the per-format sign-extended immediate; callers must pre-filter
    opcode-0 words (decode() raises InvalidInstruction there)."""
    w = words.astype(np.uint64)
    op = (w & np.uint64(0x7F)).astype(np.int64)
    rd = ((w >> np.uint64(7)) & np.uint64(0x1F)).astype(np.int64)
    f3 = ((w >> np.uint64(12)) & np.uint64(0x07)).astype(np.int64)
    rs1 = ((w >> np.uint64(15)) & np.uint64(0x1F)).astype(np.int64)
    rs2 = ((w >> np.uint64(20)) & np.uint64(0x1F)).astype(np.int64)
    f7 = ((w >> np.uint64(25)) & np.uint64(0x7F)).astype(np.int64)

    def sext(v, sign_mask, width_mask):
        v = v.astype(np.int64)
        return np.where(v & sign_mask, v - (width_mask + 1), v)

    imm_i = sext((w >> np.uint64(20)) & np.uint64(0xFFF), 0x800, 0xFFF)
    imm_s = sext((((w >> np.uint64(25)) & np.uint64(0x7F)) << np.uint64(5))
                 | ((w >> np.uint64(7)) & np.uint64(0x1F)), 0x800, 0xFFF)
    imm_b = sext(
        (((w >> np.uint64(31)) & np.uint64(1)) << np.uint64(12))
        | (((w >> np.uint64(7)) & np.uint64(1)) << np.uint64(11))
        | (((w >> np.uint64(25)) & np.uint64(0x3F)) << np.uint64(5))
        | (((w >> np.uint64(8)) & np.uint64(0x0F)) << np.uint64(1)),
        0x1000, 0x1FFF,
    )
    imm_u = sext(w & np.uint64(0xFFFFF000), 0x80000000, 0xFFFFFFFF)
    imm_j = sext(
        (((w >> np.uint64(31)) & np.uint64(1)) << np.uint64(20))
        | (((w >> np.uint64(12)) & np.uint64(0xFF)) << np.uint64(12))
        | (((w >> np.uint64(20)) & np.uint64(1)) << np.uint64(11))
        | (((w >> np.uint64(21)) & np.uint64(0x3FF)) << np.uint64(1)),
        0x100000, 0x1FFFFF,
    )

    # Format per opcode (rv64i.instruction_format; unknown -> R, imm=0).
    fmt_i = np.isin(op, (Opcode.OP_IMM, Opcode.OP_IMM_32, Opcode.JALR,
                         Opcode.LOAD, Opcode.LOAD_FP, Opcode.MISC_MEM,
                         Opcode.SYSTEM))
    fmt_s = np.isin(op, (Opcode.STORE, Opcode.STORE_FP))
    fmt_b = op == Opcode.BRANCH
    fmt_u = np.isin(op, (Opcode.LUI, Opcode.AUIPC))
    fmt_j = op == Opcode.JAL
    imm = np.zeros_like(imm_i)
    imm = np.where(fmt_i, imm_i, imm)
    imm = np.where(fmt_s, imm_s, imm)
    imm = np.where(fmt_b, imm_b, imm)
    imm = np.where(fmt_u, imm_u, imm)
    imm = np.where(fmt_j, imm_j, imm)
    return op, rd, f3, rs1, rs2, f7, imm.view(np.uint64)


def step_static_columns(op, rd, f3, rs1, rs2, f7, imm_u64) -> Dict[str, np.ndarray]:
    """The static decode tuple (all BYTECODE_SLOTS except pc), shared by
    the table builder and the step-side extraction so both sides use one
    formula set."""
    op = np.asarray(op, dtype=np.int64)
    rd = np.asarray(rd, dtype=np.int64)
    imm_u64 = np.asarray(imm_u64, dtype=np.uint64)
    tbl = v2_lookup_ids(op, np.asarray(f3), np.asarray(f7), imm_u64)
    is_sys = op == Opcode.SYSTEM
    writes = np.isin(op, _WRITES_RD)
    flk = np.isin(tbl, _GADGET_IDS)
    is_alu = flk & (tbl != TABLE_IDS["BEQ"])

    cols = {
        # SYSTEM reads (a7, a0) — mirrored by the regcheck extraction.
        "a1": np.where(is_sys, np.int64(17), np.asarray(rs1, dtype=np.int64)).astype(np.uint64),
        "a2": np.where(is_sys, np.int64(10), np.asarray(rs2, dtype=np.int64)).astype(np.uint64),
        "wrs": np.where(writes, rd, np.int64(0)).astype(np.uint64),
        "f3": np.asarray(f3, dtype=np.uint64),
        "tbl1": (tbl + 1).astype(np.uint64),
        "seqb": (~np.isin(op, _NONSEQ)).astype(np.uint64),
        "fsys": is_sys.astype(np.uint64),
        "fecall": (is_sys & (imm_u64 == 0) & (np.asarray(f3) == 0)).astype(np.uint64),
        "fimm": (np.isin(op, (Opcode.OP_IMM, Opcode.OP_IMM_32)) & flk).astype(np.uint64),
        "frs2": ((np.isin(op, (Opcode.OP, Opcode.OP_32)) & flk)
                 | (op == Opcode.BRANCH)).astype(np.uint64),
        "fwr": (is_alu & (rd != 0)).astype(np.uint64),
        "fbr": (op == Opcode.BRANCH).astype(np.uint64),
        "fjal": (op == Opcode.JAL).astype(np.uint64),
        "fjalr": (op == Opcode.JALR).astype(np.uint64),
        "fneg": (imm_u64 >> np.uint64(63)).astype(np.uint64),
        "flk": flk.astype(np.uint64),
        "febrk": (is_sys & (imm_u64 == 1) & (np.asarray(f3) == 0)).astype(np.uint64),
        "flui": (op == Opcode.LUI).astype(np.uint64),
        "faui": (op == Opcode.AUIPC).astype(np.uint64),
        "fnz": (rd != 0).astype(np.uint64),
        "fload": (op == Opcode.LOAD).astype(np.uint64),
        "fstore": (op == Opcode.STORE).astype(np.uint64),
        "falucls": np.isin(op, (Opcode.OP, Opcode.OP_32, Opcode.OP_IMM,
                                Opcode.OP_IMM_32)).astype(np.uint64),
    }
    f3a = np.asarray(f3, dtype=np.int64)
    for name, enc in (("flb", 0), ("flbu", 4), ("flh", 1), ("flhu", 5),
                      ("flw", 2), ("flwu", 6), ("fld", 3)):
        cols[name] = ((op == Opcode.LOAD) & (f3a == enc)).astype(np.uint64)
    for name, enc in (("fsb", 0), ("fsh", 1), ("fsw", 2), ("fsd", 3)):
        cols[name] = ((op == Opcode.STORE) & (f3a == enc)).astype(np.uint64)
    for k in range(4):
        cols[f"imm_{k}"] = (imm_u64 >> np.uint64(16 * k)) & _M16
    return cols


@dataclass
class BytecodeTable:
    """Public decode table over the initial memory image."""

    addrs: np.ndarray  # (t,) instruction addresses (uint64, < p)
    cols: Dict[str, np.ndarray]  # slot -> (t,) values, incl. "pc" = addrs
    num_vars: int  # table domain: 2^num_vars >= t

    @property
    def size(self) -> int:
        return len(self.addrs)

    def padded(self, name: str) -> np.ndarray:
        out = np.zeros(1 << self.num_vars, dtype=np.uint64)
        out[: self.size] = self.cols[name]
        return out

    def kappa(self, gamma, p: int):
        """(2^u,) padded Ext4 fingerprint key table (padding rows combine
        to 0, which stays distinct from any tau with nonzero high
        coordinates).  Verifier-computable: public decode + gamma."""
        from ..core.ext4 import ext_linear_comb, ext_zeros

        acc = ext_zeros((1 << self.num_vars,))
        gp = _gammas(gamma, p)
        real = ext_linear_comb(gp, [self.cols[slot] for slot in BYTECODE_SLOTS],
                               length=self.size)
        acc.c[:, : self.size] = real.c
        return acc


def build_bytecode_table(program: bytes, entry_pc: int,
                         segments=None, p: int = 2013265921) -> BytecodeTable:
    """Decode every address of the initial image whose word has a nonzero
    opcode field (candidates: [seg_start-3, seg_end) per segment — a
    fetch window must overlap a segment to contain a nonzero byte)."""
    if segments is None and program[:4] == b"\x7fELF":
        from .. import elf

        segments = elf.load(program).segments
    ranges = []
    if segments is not None:
        for seg in segments:
            ranges.append((seg.vaddr - 3, seg.vaddr + len(seg.data)))
    else:
        ranges.append((entry_pc - 3, entry_pc + len(program)))

    cand = np.unique(np.concatenate([
        np.arange(max(lo, 0), hi, dtype=np.uint64) for lo, hi in ranges
    ])) if ranges else np.zeros(0, dtype=np.uint64)

    # Fetch 4 LE bytes per candidate.  Dense fast path: one contiguous
    # image spanning the segments (vectorized gather); the sparse dict is
    # only for pathological >64 MB address spreads.
    if len(cand):
        lo_a = int(cand.min())
        hi_a = int(cand.max()) + 4
        if hi_a - lo_a <= (1 << 26):
            dense = np.zeros(hi_a - lo_a, dtype=np.uint64)
            if segments is not None:
                for seg in segments:
                    data = np.frombuffer(bytes(seg.data), dtype=np.uint8)
                    s = seg.vaddr - lo_a
                    dense[s : s + len(data)] = data
            else:
                data = np.frombuffer(program, dtype=np.uint8)
                dense[entry_pc - lo_a : entry_pc - lo_a + len(data)] = data
            off = (cand - np.uint64(lo_a)).astype(np.int64)
            byte_arr = np.stack([dense[off + k] for k in range(4)], axis=1)
        else:
            from .memcheck import initial_memory_map

            mem = initial_memory_map(program, entry_pc, segments)
            byte_arr = np.zeros((len(cand), 4), dtype=np.uint64)
            for k in range(4):
                byte_arr[:, k] = [mem.get(int(a) + k, 0) for a in cand]
    else:
        byte_arr = np.zeros((0, 4), dtype=np.uint64)
    words = (byte_arr[:, 0] | (byte_arr[:, 1] << np.uint64(8))
             | (byte_arr[:, 2] << np.uint64(16)) | (byte_arr[:, 3] << np.uint64(24)))
    keep = (words & np.uint64(0x7F)) != 0
    addrs = cand[keep]
    words = words[keep]
    assert addrs.size == 0 or int(addrs.max()) < ADDR_BOUND, (
        "bytecode argument requires program addresses < 2^29 (keeps the "
        "mod-p control-flow target equations exact)"
    )

    cols = step_static_columns(*decode_fields(words.astype(np.uint32)))
    cols["pc"] = addrs % np.uint64(p)
    # Address limbs: a free, exact range proof for the step-side pc limb
    # columns (the verifier computes these itself and checks the 2^29
    # address bound that makes the mod-p target equations exact).
    cols["pcl0"] = addrs & _M16
    cols["pcl1"] = (addrs >> np.uint64(16)) & _M16
    num_vars = max(1, int(max(addrs.size, 1) - 1).bit_length())
    return BytecodeTable(addrs=addrs, cols=cols, num_vars=num_vars)


# ---------------------------------------------------------------------------
# Combiners


def _gammas(gamma: Ext4, p: int) -> List[Ext4]:
    out = []
    g = ext_lift(1)
    for _ in BYTECODE_SLOTS:
        g = g * gamma
        out.append(g)
    return out


def _kappa_step(cols, gp: List[Ext4], p: int) -> Ext4:
    """Step-side fetch fingerprint, generic over arrays / Ext4 evals."""
    arrs = [cols[f"ref_{slot}"] if slot in ("pc", "a1", "a2") else cols[slot]
            for slot in BYTECODE_SLOTS]
    if all(isinstance(a, np.ndarray) for a in arrs):
        from ..core.ext4 import ext_linear_comb

        return ext_linear_comb(gp, arrs)
    acc = None
    for g, arr in zip(gp, arrs):
        term = g * arr
        acc = term if acc is None else acc + term
    return acc


def _rv1_combined(get, p: int):
    acc = get("ref_rv1_0")
    for k in range(1, 4):
        acc = (acc + ((1 << (16 * k)) % p) * get(f"ref_rv1_{k}")) % p
    return acc


def _out_betas(beta_o: Ext4, p: int) -> List[Ext4]:
    """beta_o^1..beta_o^5: counter slot then the four 16-bit value limbs."""
    out, g = [], ext_lift(1)
    for _ in range(5):
        g = g * beta_o
        out.append(g)
    return out


def _make_step_combiner(tau: Ext4, gamma: Ext4, entry_pc: int, num_steps: int,
                        num_vars: int, p: int,
                        tau_c: Ext4, beta_c: Ext4, tau_o: Ext4, beta_o: Ext4,
                        tau_l: Ext4, delta: Ext4, tau_r: Ext4,
                        tau_w: Ext4, eps: Ext4, final_pc: int):
    """One generic combiner (base/Ext4 arrays at prove time, Ext4 terminal
    evaluations at verify time); challenges are BabyBear^4.  Returned with
    the public-evals callback that supplies the __sel/__eq0/__idx values
    at the extension final point."""
    from .linkage import link_deltas

    gp = _gammas(gamma, p)
    ob = _out_betas(beta_o, p)
    dl = link_deltas(delta, p)
    ep = _eps_powers(eps, p)
    FF = (1 << 16) - 1  # 0xFFFF sign-fill limb

    def combiner(cols, alphas: List, p_: int):
        P = np.uint64(p)
        one = np.uint64(1)
        sel = cols["__sel__"]
        eq0 = cols["__eq0__"]
        idx = cols["__idx__"]
        sel1 = cols["__sel1__"]
        sel2 = cols["__sel2__"]
        kappa = _kappa_step(cols, gp, p)
        rv1c = _rv1_combined(lambda n: cols[n], p) % P
        key_out = ob[0] * cols["cnt"]
        for k in range(4):
            key_out = key_out + ob[k + 1] * cols[f"ref_rv2_{k}"]
        den_c1 = tau_c - beta_c * ((idx + one) % P) - cols["cnt"] - cols["c_commit"]
        den_c2 = tau_c - beta_c * idx - cols["cnt"]
        g_bc = g_eval_from_coords(cols, "g_bc")
        g_c1 = g_eval_from_coords(cols, "g_c1")
        g_c2 = g_eval_from_coords(cols, "g_c2")
        g_out = g_eval_from_coords(cols, "g_out")
        g_lk_s = g_eval_from_coords(cols, "g_lk_s")
        terms = [
            g_bc * (tau - kappa) - sel,
            eq0 * ((cols["ref_pc"] + P - np.uint64(entry_pc % p)) % P) % P,
            (cols["ref_a3"]
             + P - ((one + P - cols["fsys"]) % P) * cols["wrs"] % P
             + P - np.uint64(10) * cols["fsys"] % P * cols["c_read"] % P) % P,
            cols["c_read"] * ((one + P - cols["c_read"]) % P) % P,
            cols["c_commit"] * ((one + P - cols["c_commit"]) % P) % P,
            cols["c_read"] * ((rv1c + P - np.uint64(2)) % P) % P,
            cols["c_commit"] * ((rv1c + P - one) % P) % P,
            ((one + P - cols["fecall"]) % P) * cols["c_read"] % P,
            ((one + P - cols["fecall"]) % P) * cols["c_commit"] % P,
            cols["fecall"] * ((cols["c_read"] + P - one
                               + ((rv1c + P - np.uint64(2)) % P) * cols["inv_r"] % P) % P) % P,
            cols["fecall"] * ((cols["c_commit"] + P - one
                               + ((rv1c + P - one) % P) * cols["inv_c"] % P) % P) % P,
            ((one + P - sel) % P) * cols["c_read"] % P,
            ((one + P - sel) % P) * cols["c_commit"] % P,
            # Commit-counter chain (index-shift logUp) + anchor + tape logUp.
            g_c1 * den_c1 - sel1,
            g_c2 * den_c2 - sel2,
            eq0 * cols["cnt"] % P,
            g_out * (tau_o - key_out) - cols["c_commit"],
        ]
        # Witness linkage: fingerprint the step's (tbl, in0, in1, s)
        # tuple from PROVEN columns; g_lk_s matches the query side.
        falu = (cols["flk"] + P - cols["fbr"]) % P
        kappa_lk = dl[0] * cols["tbl1"]
        for k in range(4):
            kappa_lk = kappa_lk + dl[1 + k] * cols[f"ref_rv1_{k}"]
            in1k = (cols["fimm"] * cols[f"imm_{k}"]
                    + cols["frs2"] * cols[f"ref_rv2_{k}"]) % P
            kappa_lk = kappa_lk + dl[5 + k] * in1k
        s0 = (falu * cols["res_0"] + cols["fbr"] * cols["f3"]) % P
        s1 = (falu * cols["res_1"] + cols["fbr"] * cols["taken_b"]) % P
        s2 = falu * cols["res_2"] % P
        s3 = falu * cols["res_3"] % P
        for k, sk in enumerate((s0, s1, s2, s3)):
            kappa_lk = kappa_lk + dl[9 + k] * sk
        terms.append(g_lk_s * (tau_l - kappa_lk) - cols["flk"])
        for k in range(4):
            terms.append(
                cols["fwr"] * ((cols[f"res_{k}"] + P - cols[f"ref_wv_{k}"]) % P) % P
            )
        # Control flow: next_pc per instruction class, link-register and
        # LUI write values (pcl0/pcl1 are the fetch-proven pc limbs).
        r64 = np.uint64(((1 << 64) % p))
        immc = cols["imm_0"].copy()
        for k in range(1, 4):
            immc = (immc + np.uint64((1 << (16 * k)) % p) * cols[f"imm_{k}"]) % P
        simm = (immc + P - r64 * cols["fneg"] % P) % P
        dnp = (cols["ref_next_pc"] + P - cols["ref_pc"]) % P
        jw = (cols["fjal"] + cols["fjalr"]) % P
        four = np.uint64(4)
        sixt = np.uint64(1 << 16)
        terms += [
            cols["fsys"] * ((one + P - cols["fecall"] + P - cols["febrk"]) % P) % P,
            cols["febrk"] * dnp % P,
            cols["fecall"] * ((dnp + P - four) % P) % P,
            (cols["ref_seq"] + P - cols["seqb"]) % P,
            cols["fbr"] * ((dnp + P - simm * cols["taken_b"] % P
                            + P - four * ((one + P - cols["taken_b"]) % P) % P) % P) % P,
            cols["fjal"] * ((dnp + P - simm) % P) % P,
            jw * (cols["fnz"] * ((cols["ref_wv_0"] + P - cols["pcl0"] + P - four
                                  + sixt * cols["pc4c"] % P) % P) % P) % P,
            jw * (cols["fnz"] * ((cols["ref_wv_1"] + P - cols["pcl1"]
                                  + P - cols["pc4c"]) % P) % P) % P,
            jw * (cols["fnz"] * cols["ref_wv_2"] % P) % P,
            jw * (cols["fnz"] * cols["ref_wv_3"] % P) % P,
            cols["pc4c"] * ((one + P - cols["pc4c"]) % P) % P,
        ]
        for k in range(4):
            terms.append(
                cols["flui"] * (cols["fnz"]
                                * ((cols[f"ref_wv_{k}"] + P - cols[f"imm_{k}"]) % P)
                                % P) % P
            )
        # JALR/AUIPC/LOAD/STORE 4-limb adder (+ JALR target, AUIPC
        # write value, memory base address).
        rvsel = (cols["fjalr"] + cols["fload"] + cols["fstore"]) % P
        gate = (cols["faui"] + rvsel) % P
        xs = [
            (cols["faui"] * cols["pcl0"] + rvsel * cols["ref_rv1_0"]) % P,
            (cols["faui"] * cols["pcl1"] + rvsel * cols["ref_rv1_1"]) % P,
            rvsel * cols["ref_rv1_2"] % P,
            rvsel * cols["ref_rv1_3"] % P,
        ]
        for k in range(4):
            cin = cols[f"jc_{k-1}"] if k else 0
            terms.append(
                gate * ((xs[k] + cols[f"imm_{k}"] + cin
                         + P - cols[f"jt_{k}"]
                         + P - sixt * cols[f"jc_{k}"] % P) % P) % P
            )
        for k in range(4):
            terms.append(cols[f"jc_{k}"] * ((one + P - cols[f"jc_{k}"]) % P) % P)
        for k in range(4):
            terms.append(
                cols["faui"] * (cols["fnz"]
                                * ((cols[f"jt_{k}"] + P - cols[f"ref_wv_{k}"]) % P)
                                % P) % P
            )
        two = np.uint64(2)
        terms.append(
            cols["fjalr"] * ((cols["jt_0"] + P - two * cols["jh"] % P
                              + P - cols["jlsb"]) % P) % P
        )
        terms.append(cols["jlsb"] * ((one + P - cols["jlsb"]) % P) % P)
        tgt = (two * cols["jh"]
               + np.uint64((1 << 16) % p) * cols["jt_1"]
               + np.uint64((1 << 32) % p) * cols["jt_2"]
               + np.uint64((1 << 48) % p) * cols["jt_3"]) % P
        terms.append(
            cols["fjalr"] * ((cols["ref_next_pc"] + P - tgt) % P) % P
        )
        for i, group in enumerate(RANGE_GROUPS):
            ds = [tau_r - np.uint64(coef) * cols[name] % P for name, coef in group]
            gr = g_eval_from_coords(cols, f"grp{i}")
            if len(ds) == 2:
                terms.append(gr * (ds[0] * ds[1]) - (ds[0] + ds[1]))
            else:
                terms.append(gr * ds[0] - one)
        # LOAD/STORE linkage: per-byte tuples vs the memcheck rows,
        # pair-merged fractions with selector numerators.
        sels = _mem_sel_exprs(lambda f: cols[f], p)
        mbase = ep[0] * cols["bcnt"]
        for j in range(4):
            mbase = mbase + ep[1 + j] * cols[f"jt_{j}"]
        mbase = mbase + ep[7] * cols["fstore"]
        mds = []
        for k in range(8):
            kap = mbase + (ep[0] * k + ep[5] * k) + ep[6] * cols[f"vb_{k}"]
            mds.append(tau_w - kap)
        for i, (ka, kb) in enumerate(GM_GROUPS):
            gm = g_eval_from_coords(cols, f"gmp{i}")
            terms.append(gm * (mds[ka] * mds[kb])
                         - (sels[ka] * mds[kb] + sels[kb] * mds[ka]))
        nb = sum(sels) % P
        den_b1 = tau_c - beta_c * ((idx + one) % P) - cols["bcnt"] - nb
        den_b2 = tau_c - beta_c * idx - cols["bcnt"]
        terms.append(g_eval_from_coords(cols, "g_b1") * den_b1 - sel1)
        terms.append(g_eval_from_coords(cols, "g_b2") * den_b2 - sel2)
        terms.append(eq0 * cols["bcnt"] % P)
        # STORE value ties (size-gated 16-bit pairings against rv2).
        pr = [(cols[f"vb_{2*j}"] + np.uint64(256) * cols[f"vb_{2*j+1}"]) % P
              for j in range(4)]
        terms.append(
            cols["fsb"] * ((cols["vb_0"] + np.uint64(256) * cols["vhi0"]
                            + P - cols["ref_rv2_0"]) % P) % P
        )
        terms.append(
            ((cols["fsh"] + cols["fsw"] + cols["fsd"]) % P)
            * ((pr[0] + P - cols["ref_rv2_0"]) % P) % P
        )
        terms.append(
            ((cols["fsw"] + cols["fsd"]) % P)
            * ((pr[1] + P - cols["ref_rv2_1"]) % P) % P
        )
        terms.append(cols["fsd"] * ((pr[2] + P - cols["ref_rv2_2"]) % P) % P)
        terms.append(cols["fsd"] * ((pr[3] + P - cols["ref_rv2_3"]) % P) % P)
        # LOAD write-value ties (per wv limb, one-hot over funct3).
        ldsum = sum(cols[f] for f in _LOAD_FLAGS) % P
        fill = np.uint64(FF % p) * cols["sgn"] % P
        ex0 = (((cols["fld"] + cols["flw"] + cols["flwu"]
                 + cols["flh"] + cols["flhu"]) % P) * pr[0]
               + cols["flb"] * ((cols["vb_0"] + np.uint64(0xFF00) * cols["sgn"]) % P)
               + cols["flbu"] * cols["vb_0"]) % P
        ex1 = (((cols["fld"] + cols["flw"] + cols["flwu"]) % P) * pr[1]
               + ((cols["flh"] + cols["flb"]) % P) * fill) % P
        ex2 = (cols["fld"] * pr[2]
               + ((cols["flw"] + cols["flh"] + cols["flb"]) % P) * fill) % P
        ex3 = (cols["fld"] * pr[3]
               + ((cols["flw"] + cols["flh"] + cols["flb"]) % P) * fill) % P
        for k, ex in enumerate((ex0, ex1, ex2, ex3)):
            terms.append(
                cols["fnz"] * ((ldsum * cols[f"ref_wv_{k}"] % P + P - ex) % P) % P
            )
        # Load sign split: sign byte = 128*sgn + rl (rl < 128 ranged).
        sb_src = (cols["flb"] * cols["vb_0"] + cols["flh"] * cols["vb_1"]
                  + cols["flw"] * cols["vb_3"]) % P
        sgate = (cols["flb"] + cols["flh"] + cols["flw"]) % P
        terms.append(
            (sb_src + P - sgate * ((np.uint64(128) * cols["sgn"]
                                    + cols["rl"]) % P) % P) % P
        )
        terms.append(cols["sgn"] * ((one + P - cols["sgn"]) % P) % P)
        # Decode completeness: every executed mem word is a valid funct3.
        terms.append(cols["fload"] * ((ldsum + P - one) % P) % P)
        stsum = sum(cols[f] for f in _STORE_FLAGS) % P
        terms.append(cols["fstore"] * ((stsum + P - one) % P) % P)
        terms.append(cols["falucls"] * ((one + P - cols["flk"]) % P) % P)
        # Public final pc: the last step's next_pc IS PublicIO.final_pc.
        terms.append(
            ((sel + P - sel1) % P)
            * ((cols["ref_next_pc"] + P - np.uint64(final_pc % p)) % P) % P
        )
        acc = alphas[0] * terms[0]
        for alpha, t in zip(alphas[1:], terms[1:]):
            acc = acc + alpha * t
        return acc

    def public_evals(rs):
        eq0 = eq_zero_eval(rs, p)
        sel_all = le_indicator_eval(num_steps - 1, num_vars, rs, p)
        return {
            "__sel__": sel_all,
            "__eq0__": eq0,
            "__idx__": idx_eval(num_vars, rs, p),
            "__sel1__": le_indicator_eval(num_steps - 2, num_vars, rs, p),
            "__sel2__": (sel_all - eq0) % p,
        }

    return combiner, public_evals


def _step_link_denoms(lk, reg_cols, tau_l: Ext4, dl: List[Ext4], p: int) -> Ext4:
    """Step-side linkage denominators tau_l - kappa_lk (dense twin of the
    combiner's fingerprint, for inverse-column construction)."""
    P = np.uint64(p)
    falu = (lk["flk"] + P - lk["fbr"]) % P
    kappa = dl[0] * lk["tbl1"]
    for k in range(4):
        kappa = kappa + dl[1 + k] * reg_cols[f"rv1_{k}"]
        in1k = (lk["fimm"] * lk[f"imm_{k}"]
                + lk["frs2"] * reg_cols[f"rv2_{k}"]) % P
        kappa = kappa + dl[5 + k] * in1k
    s = [
        (falu * lk["res_0"] + lk["fbr"] * lk["f3"]) % P,
        (falu * lk["res_1"] + lk["fbr"] * lk["taken_b"]) % P,
        falu * lk["res_2"] % P,
        falu * lk["res_3"] % P,
    ]
    for k in range(4):
        kappa = kappa + dl[9 + k] * s[k]
    return tau_l - kappa


def _eps_powers(eps: Ext4, p: int) -> List[Ext4]:
    """eps^1..eps^8: position, 4 base-address limbs, byte offset, byte
    value, store flag — the step<->byte-row linkage fingerprint."""
    out, g = [], ext_lift(1)
    for _ in range(8):
        g = g * eps
        out.append(g)
    return out


_LOAD_FLAGS = ("flb", "flbu", "flh", "flhu", "flw", "flwu", "fld")
_STORE_FLAGS = ("fsb", "fsh", "fsw", "fsd")


def _mem_sel_exprs(get, p: int):
    """sel_k = 1 iff the step is a valid mem op with nbytes > k, as a
    LINEAR combination of the decode one-hot flags (k = 0..7)."""
    s1 = sum(get(f) for f in _LOAD_FLAGS + _STORE_FLAGS) % p
    s2 = (get("flh") + get("flhu") + get("flw") + get("flwu") + get("fld")
          + get("fsh") + get("fsw") + get("fsd")) % p
    s4 = (get("flw") + get("flwu") + get("fld") + get("fsw") + get("fsd")) % p
    s8 = (get("fld") + get("fsd")) % p
    return [s1, s2, s4, s4, s8, s8, s8, s8]


def _mem_step_denoms(lk, tau_w: Ext4, ep: List[Ext4], p: int) -> List[Ext4]:
    """Per-k (k = 0..7) linkage denominators tau_w - kappa_k over the
    step domain (dense twin of the combiner terms)."""
    base = ep[0] * lk["bcnt"]
    for j in range(4):
        base = base + ep[1 + j] * lk[f"jt_{j}"]
    base = base + ep[7] * lk["fstore"]
    out = []
    for k in range(8):
        kap = base + (ep[0] * k + ep[5] * k) + ep[6] * lk[f"vb_{k}"]
        out.append(tau_w - kap)
    return out


def _make_memlink_combiner(tau_w: Ext4, ep: List[Ext4], num_rows: int,
                           num_vars: int, p: int):
    """Byte-domain zerocheck: g_lnk * (tau_w - kappa) = sel pointwise,
    kappa over the memcheck row's (idx, base limbs, offset, byte, st).
    One generic combiner + the public-evals callback."""

    def combiner(cols, alphas: List, p_: int):
        kap = ep[0] * cols["__idx__"]
        for j in range(4):
            kap = kap + ep[1 + j] * cols[f"ref_ba{j}"]
        kap = (kap + ep[5] * cols["ref_bk"] + ep[6] * cols["ref_vw"]
               + ep[7] * cols["ref_st"])
        g = g_eval_from_coords(cols, "g_lnk")
        return alphas[0] * (g * (tau_w - kap) - cols["__sel__"])

    def public_evals(rs):
        return {
            "__sel__": le_indicator_eval(num_rows - 1, num_vars, rs, p),
            "__idx__": idx_eval(num_vars, rs, p),
        }

    return combiner, public_evals


def _make_table_combiner(tau: Ext4, kappa_table, p: int):
    """Program/RANGE16-domain logUp zerocheck: h * (tau - key) = m, with
    the (possibly Ext4-valued) key table a public function the verifier
    folds itself at the extension final point."""

    def combiner(cols, alphas: List, p_: int):
        h = g_eval_from_coords(cols, "h")
        return alphas[0] * (h * (tau - cols["__key__"]) - cols["m"])

    def public_evals(rs):
        # Public key MLE: fold the dense table (verifier-computable).
        tab = kappa_table
        if not isinstance(tab, Ext4):
            tab = np.asarray(tab, dtype=np.uint64) % np.uint64(p)
        for r in rs:
            half = tab.shape[-1] // 2
            tab = (1 - r) * tab[..., :half] + r * tab[..., half:]
        key = tab[..., 0] if isinstance(tab, Ext4) else Ext4.lift(int(tab[0]))
        if isinstance(key, Ext4) and key.c.ndim > 1:
            key = Ext4(key.c.reshape(4))
        return {"__key__": key}

    return combiner, public_evals


# ---------------------------------------------------------------------------
# Proof structure


@dataclass
class BytecodeProof:
    """Round-3 slim form: Ligero roots/openings (and the external
    regcheck/PCS/memcheck reference claims) moved to the shared unified
    commitment (prover/unified.py) — the ref_* terminal evaluations of
    the zerochecks below ARE the cross-argument claims now."""

    nonce: int
    num_vars: int  # step domain
    table_vars: int  # program-table domain
    zc: ZerocheckProof  # step-domain zerocheck
    zc_table: ZerocheckProof  # program-domain zerocheck
    zc_range: ZerocheckProof  # RANGE16 domain (JALR/AUIPC adder limbs)
    zc_mem: ZerocheckProof  # memcheck byte-row domain (LOAD/STORE linkage)
    g_sum: object
    h_sum: object
    # Output-tape binding: commit-counter chain sums (must be equal) and
    # the step-side tape logUp sum (must equal the verifier's own sum
    # over the public outputs list).
    gc1_sum: object
    gc2_sum: object
    gout_sum: object
    # Witness linkage: step-side g sum and per-table query-side records
    # (constraints/linkage.py).
    glk_sum: object
    links: list
    gr_sums: Dict[str, object]
    hr_sum: object
    # LOAD/STORE linkage sums: per-byte-slot, byte-counter chain, and the
    # memcheck byte-row side.
    gm_sums: list
    gb1_sum: object
    gb2_sum: object
    wg_sum: object


# ---------------------------------------------------------------------------
# Prover


def _trace_decode_arrays(trace):
    n = trace.step_count()
    cols = getattr(trace, "columns", None)
    if cols is not None:
        return (
            cols["opcode"].astype(np.int64), cols["rd"].astype(np.int64),
            cols["funct3"].astype(np.int64), cols["rs1"].astype(np.int64),
            cols["rs2"].astype(np.int64), cols["funct7"].astype(np.int64),
            cols["imm"].astype(np.int64).view(np.uint64),
        )
    insts = trace.instructions
    mk = lambda f, dt: np.fromiter((f(i) for i in insts), dtype=dt, count=n)
    return (
        mk(lambda i: i.opcode, np.int64), mk(lambda i: i.rd, np.int64),
        mk(lambda i: i.funct3, np.int64), mk(lambda i: i.rs1, np.int64),
        mk(lambda i: i.rs2, np.int64), mk(lambda i: i.funct7, np.int64),
        mk(lambda i: i.imm & ((1 << 64) - 1), np.uint64),
    )


class BytecodeArgument:
    """Prover-side phased argument (prover/unified.py harness): the
    fetch/decode argument, control-flow/output-tape/linkage chains, the
    LOAD/STORE memcheck linkage, and the per-table query links — sharing
    the unified data/advice commitments with every other argument.

    Cross-argument references: ``reg_arg`` (RegcheckArgument) supplies
    the proven operand columns, ``core_arg`` the v2 PCS columns (pc /
    next_pc / flags), ``validity_info`` the validity argument's per-table
    committed query columns, ``mem_arg`` (MemcheckArgument) the byte-row
    columns; claims against them route through their locmaps."""

    ns = "bc"

    def __init__(self, F, trace, program: bytes, entry_pc: int, segments,
                 num_vars: int, reg_arg, core_arg, validity_arg, mem_arg,
                 outputs=None, final_pc: int = 0, forge_hook=None,
                 unsafe_skip_self_checks=False):
        self.F = F
        self.trace = trace
        self.program = program
        self.entry_pc = entry_pc
        self.segments = segments
        self.num_vars = num_vars
        self.reg_arg = reg_arg
        self.core_arg = core_arg
        self.validity_arg = validity_arg
        self.mem_arg = mem_arg
        self.outputs = outputs
        self.final_pc = final_pc
        self._forge_hook = forge_hook
        self._unsafe = unsafe_skip_self_checks
        self.locmap = {}
        self.proof: Optional[BytecodeProof] = None

    def data_phase(self, transcript) -> Dict[str, np.ndarray]:
        return _bc_data_phase(self, transcript)

    def advice_phase(self, transcript) -> Dict[str, np.ndarray]:
        return _bc_advice_phase(self, transcript)

    def zerocheck_phase(self, transcript, sink) -> None:
        _bc_zerocheck_phase(self, transcript, sink)


def _bc_data_phase(self: BytecodeArgument, transcript) -> Dict[str, np.ndarray]:
    F, trace = self.F, self.trace
    program, entry_pc, segments = self.program, self.entry_pc, self.segments
    num_vars = self.num_vars
    reg_cols = self.reg_arg.cols
    # Per-table committed query columns retained by the validity argument
    # (its data phase ran first in the harness order).
    validity_info = self.validity_info = self.validity_arg.linkage_info()
    _forge_hook = self._forge_hook
    _unsafe_skip_self_checks = self._unsafe
    outputs = self.outputs

    p = F.MODULUS
    if p >= (1 << 31):
        raise ValueError("bytecode argument requires a field modulus < 2^31")
    n = trace.step_count()
    padded = 1 << num_vars

    table = build_bytecode_table(program, entry_pc, segments, p)

    # Step-side static tuple + syscall flags.
    op, rd, f3, rs1, rs2, f7, imm_u = _trace_decode_arrays(trace)
    step_cols = step_static_columns(op, rd, f3, rs1, rs2, f7, imm_u)

    def _pad(a):
        out = np.zeros(padded, dtype=np.uint64)
        out[:n] = a
        return out

    lk: Dict[str, np.ndarray] = {}
    for name in LINK_COLUMNS:
        if name in step_cols:
            lk[name] = _pad(step_cols[name])

    P64 = np.uint64(p)
    rv1c = reg_cols["rv1_0"].copy()
    for k in range(1, 4):
        rv1c = (rv1c + np.uint64((1 << (16 * k)) % p) * reg_cols[f"rv1_{k}"]) % P64
    fecall = lk["fecall"]
    lk["c_read"] = ((fecall == 1) & (rv1c == 2)).astype(np.uint64)
    lk["c_commit"] = ((fecall == 1) & (rv1c == 1)).astype(np.uint64)
    lk["inv_r"] = np_inv((rv1c + P64 - np.uint64(2)) % P64, p) * fecall % P64
    lk["inv_c"] = np_inv((rv1c + P64 - np.uint64(1)) % P64, p) * fecall % P64
    # Commit counter: number of ECALL_COMMITs strictly before step x
    # (padding rows continue the final count; only idx <= n-2 is chained).
    cnt = np.zeros(padded, dtype=np.uint64)
    np.cumsum(lk["c_commit"][: max(n - 1, 0)], out=cnt[1:n])
    if n:
        cnt[n:] = cnt[n - 1] + lk["c_commit"][n - 1]
    lk["cnt"] = cnt % P64

    # Witness-linkage step columns: the lookup result limbs and branch
    # taken bit, scattered from the validity argument's committed query
    # representation (constraints/linkage.py slot reconstruction), in
    # step order per table.
    from .linkage import (
        gadget_linkage_arrays,
        link_deltas,
        link_denominators,
        prove_query_links,
    )

    validity_info = validity_info or []
    tbl_ids = v2_lookup_ids(np.asarray(op), np.asarray(f3), np.asarray(f7),
                            np.asarray(imm_u, dtype=np.uint64))
    for k in range(4):
        lk[f"res_{k}"] = np.zeros(padded, dtype=np.uint64)
    lk["taken_b"] = np.zeros(padded, dtype=np.uint64)
    for info in validity_info:
        rows = np.nonzero(tbl_ids == info["tid"])[0]
        if len(rows) != info["nq"] and not _unsafe_skip_self_checks:
            raise AssertionError(
                f"bytecode argument violated: table {info['tid']} has "
                f"{len(rows)} steps but {info['nq']} queries"
            )
        slots = gadget_linkage_arrays(info["tid"], info["cols"], p)
        nr = min(len(rows), info["nq"])
        if info["tid"] == TABLE_IDS["BEQ"]:
            lk["taken_b"][rows[:nr]] = slots["s_1"][:nr]
        else:
            for k in range(4):
                lk[f"res_{k}"][rows[:nr]] = slots[f"s_{k}"][:nr]

    # Control-flow step columns: pc limbs (fetch-proven against the
    # table's address limbs) and the pc+4 carry for link registers.
    pcs_arr = np.asarray(
        trace.columns["pc"] if getattr(trace, "columns", None) is not None
        else np.fromiter(trace.pcs, dtype=np.uint64, count=n),
        dtype=np.uint64,
    )
    lk["pcl0"] = _pad(pcs_arr & _M16)
    lk["pcl1"] = _pad((pcs_arr >> np.uint64(16)) & _M16)
    lk["pc4c"] = _pad(((pcs_arr & _M16) + np.uint64(4)) >> np.uint64(16))
    # JALR/AUIPC adder advice: t = (x + imm) mod 2^64, x = pc or rv1.
    rv1_u64 = np.zeros(n, dtype=np.uint64)
    for k in range(4):
        rv1_u64 |= reg_cols[f"rv1_{k}"][:n].astype(np.uint64) << np.uint64(16 * k)
    gate_n = ((lk["faui"][:n] == 1) | (lk["fjalr"][:n] == 1)
              | (lk["fload"][:n] == 1) | (lk["fstore"][:n] == 1))
    x64 = np.where(lk["faui"][:n] == 1, pcs_arr, rv1_u64)
    t64 = np.where(gate_n, x64 + np.asarray(imm_u, dtype=np.uint64), np.uint64(0))
    carry = np.zeros(n, dtype=np.uint64)
    for k in range(4):
        sh = np.uint64(16 * k)
        s = ((x64 >> sh) & _M16) + ((np.asarray(imm_u, dtype=np.uint64) >> sh) & _M16) + carry
        carry = s >> np.uint64(16)
        lk[f"jt_{k}"] = _pad(((t64 >> sh) & _M16))
        lk[f"jc_{k}"] = _pad(np.where(gate_n, carry, np.uint64(0)))
    lk["jh"] = _pad((lk["jt_0"][:n] >> np.uint64(1)) * lk["fjalr"][:n])
    lk["jlsb"] = _pad((lk["jt_0"][:n] & np.uint64(1)) * lk["fjalr"][:n])
    for k in range(4):
        lk[f"jt_{k}"][:n] *= gate_n

    # LOAD/STORE linkage advice: access-value bytes, SB high-byte split,
    # load sign split, and the cumulative byte counter.
    cols_t = getattr(trace, "columns", None)
    if cols_t is not None:
        mv = cols_t["mem_val"].astype(np.uint64)[:n]
    else:
        mv = np.array([a.value if a else 0 for a in trace.memory_accesses],
                      dtype=np.uint64)[:n]
    is_mem_n = ((lk["fload"][:n] == 1) | (lk["fstore"][:n] == 1)).astype(np.uint64)
    for k in range(8):
        lk[f"vb_{k}"] = _pad(((mv >> np.uint64(8 * k)) & np.uint64(0xFF)) * is_mem_n)
    lk["vhi0"] = _pad((reg_cols["rv2_0"][:n] >> np.uint64(8)) * lk["fsb"][:n])
    sb = (lk["flb"][:n] * lk["vb_0"][:n] + lk["flh"][:n] * lk["vb_1"][:n]
          + lk["flw"][:n] * lk["vb_3"][:n])
    lk["sgn"] = _pad(sb >> np.uint64(7))
    lk["rl"] = _pad(sb & np.uint64(0x7F))
    f3_n = np.asarray(f3, dtype=np.uint64)[:n]
    nb_n = (np.uint64(1) << (f3_n & np.uint64(3))) * is_mem_n
    bcnt = np.zeros(padded, dtype=np.uint64)
    np.cumsum(nb_n[: max(n - 1, 0)], out=bcnt[1:n])
    if n:
        bcnt[n:] = bcnt[n - 1] + nb_n[n - 1]
    lk["bcnt"] = bcnt % P64
    if not _unsafe_skip_self_checks and n:
        # Honest-trace precondition for the mod-p target equations: no
        # branch/JAL target may wrap around 0 or 2^64 (the VM computes
        # (pc + simm) mod 2^64; such programs cannot occur within the
        # verifier-enforced 2^29 address bound unless malformed).
        simm_i = imm_u.astype(np.int64)
        cf = (lk["fbr"][:n] * lk["taken_b"][:n] + lk["fjal"][:n]) == 1
        tgt = pcs_arr.astype(np.int64) + simm_i
        if np.any(cf & ((tgt < 0) | (tgt >= int(ADDR_BOUND) + (1 << 21)))):
            raise AssertionError(
                "bytecode argument: branch/JAL target outside the provable "
                "address window"
            )

    outs = [int(v) & _int64_mask for v in (outputs or [])]
    if not _unsafe_skip_self_checks:
        commit_rows = np.nonzero(lk["c_commit"][:n] == 1)[0]
        got = [
            sum(int(reg_cols[f"rv2_{k}"][r]) << (16 * k) for k in range(4))
            for r in commit_rows
        ]
        if got != outs:
            raise AssertionError(
                "bytecode argument violated: output tape mismatch "
                f"(trace commits {got}, public claims {outs})"
            )

    if _forge_hook is not None:
        _forge_hook(lk, table)

    # Multiplicities over the program domain.
    m_col = np.zeros(1 << table.num_vars, dtype=np.uint64)
    if n:
        pcs = np.asarray(
            trace.columns["pc"] if getattr(trace, "columns", None) is not None
            else np.fromiter(trace.pcs, dtype=np.uint64, count=n),
            dtype=np.uint64,
        )
        pos = np.searchsorted(table.addrs, pcs)
        ok = (pos < table.size) & (table.addrs[np.minimum(pos, table.size - 1)] == pcs)
        if not ok.all() and not _unsafe_skip_self_checks:
            bad = int(np.nonzero(~ok)[0][0])
            raise AssertionError(
                f"bytecode argument violated: step {bad} fetches pc={pcs[bad]:#x} "
                f"outside the decoded program image (self-modifying code?)"
            )
        np.add.at(m_col, pos[ok], 1)

    transcript.append_bytes(b"BC_BEGIN")
    transcript.append_u64(n)
    transcript.append_u64(table.num_vars)
    # RANGE16 multiplicities for the adder limbs (full padded domain).
    m_r = np.zeros(1 << 16, dtype=np.uint64)
    for name, coef in RANGED:
        m_r += np.bincount((np.uint64(coef) * lk[name]).astype(np.int64),
                           minlength=1 << 16).astype(np.uint64)

    self.n = n
    self.table = table
    self.lk = lk
    self.m_col = m_col
    self.m_r = m_r
    self.outs = outs
    return {**lk, "m_prog": m_col, "m_r16": m_r}


def _bc_advice_phase(self: BytecodeArgument, transcript) -> Dict[str, np.ndarray]:
    F, trace = self.F, self.trace
    entry_pc, num_vars = self.entry_pc, self.num_vars
    n, table, lk = self.n, self.table, self.lk
    m_col, m_r, outs = self.m_col, self.m_r, self.outs
    reg_cols = self.reg_arg.cols
    pcs_cols = self.core_arg.columns
    validity_info = self.validity_info
    memcheck_info = dict(
        cols=self.mem_arg.cols, num_accesses=self.mem_arg.A,
        num_vars=self.mem_arg.num_vars,
    )
    _unsafe_skip_self_checks = self._unsafe
    p = F.MODULUS
    P64 = np.uint64(p)
    from .linkage import link_deltas, link_denominators

    # Fingerprint challenges (nonce retry on zero denominators).
    sel = le_table(n - 1, num_vars)
    sel1 = le_table(n - 2, num_vars)
    sel2 = le_table(n - 1, num_vars)
    sel2[0] = 0
    idx = idx_table(num_vars, p)
    out_limbs = np.array(
        [[(v >> (16 * k)) & 0xFFFF for k in range(4)] for v in outs],
        dtype=np.uint64,
    ).reshape(len(outs), 4)
    nonce = 0
    while True:
        trial = transcript.fork()
        trial.append_bytes(b"BC_CHAL")
        trial.append_u64(nonce)
        tau = challenge_ext(trial)
        gamma = challenge_ext(trial)
        tau_c = challenge_ext(trial)
        beta_c = challenge_ext(trial)
        tau_o = challenge_ext(trial)
        beta_o = challenge_ext(trial)
        tau_l = challenge_ext(trial)
        delta = challenge_ext(trial)
        tau_r = challenge_ext(trial)
        tau_w = challenge_ext(trial)
        eps = challenge_ext(trial)
        gp = _gammas(gamma, p)
        kap_t = table.kappa(gamma, p)  # keys only (tau unused)
        denom_t = tau - kap_t
        ok = high_coords_nonzero(tau_r) and not np.any(denom_t.is_zero())
        if ok:
            ref = {
                "ref_pc": pcs_cols["pc"] % P64,
                "ref_a1": reg_cols["a1"],
                "ref_a2": reg_cols["a2"],
            }
            kap_s = _kappa_step({**lk, **ref}, gp, p)
            ok = not np.any((tau - kap_s).is_zero() & (sel == 1))
        if ok:
            den_c1 = tau_c - beta_c * ((idx + np.uint64(1)) % P64) - lk["cnt"] - lk["c_commit"]
            den_c2 = tau_c - beta_c * idx - lk["cnt"]
            ob = _out_betas(beta_o, p)
            key_out = ob[0] * lk["cnt"]
            for k in range(4):
                key_out = key_out + ob[k + 1] * reg_cols[f"rv2_{k}"]
            den_out = tau_o - key_out
            pub_key = ob[0] * (np.arange(len(outs), dtype=np.uint64) % P64)
            for k in range(4):
                pub_key = pub_key + ob[k + 1] * out_limbs[:, k]
            den_pub = tau_o - pub_key
            ok = (not np.any(den_c1.is_zero() & (sel1 == 1))
                  and not np.any(den_c2.is_zero() & (sel2 == 1))
                  and not np.any(den_out.is_zero() & (lk["c_commit"] == 1))
                  and not np.any(den_pub.is_zero()))
        if ok:
            dl = link_deltas(delta, p)
            den_lk = _step_link_denoms(lk, reg_cols, tau_l, dl, p)
            ok = not np.any(den_lk.is_zero() & (lk["flk"] == 1))
            for info in validity_info:
                if not ok:
                    break
                dq = link_denominators(info["tid"], info["cols"], info["nq"],
                                       tau_l, dl, p)
                ok = not np.any(dq.is_zero()[: info["nq"]])
        if ok:
            # Memory linkage: step-side per-k denominators, the memcheck
            # byte-row denominators, and the byte-counter chain.
            ep = _eps_powers(eps, p)
            mem_dens = _mem_step_denoms(lk, tau_w, ep, p)
            mem_sels = _mem_sel_exprs(lambda f: lk[f], p)
            for k in range(8):
                if np.any(mem_dens[k].is_zero() & (mem_sels[k] == 1)):
                    ok = False
                    break
            if ok and memcheck_info is not None:
                mcc = memcheck_info["cols"]
                kap_w = ep[0] * (np.arange(len(mcc["vw"]), dtype=np.uint64) % P64)
                for j in range(4):
                    kap_w = kap_w + ep[1 + j] * mcc[f"ba{j}"]
                kap_w = (kap_w + ep[5] * mcc["bk"] + ep[6] * mcc["vw"]
                         + ep[7] * mcc["st"])
                den_w = tau_w - kap_w
                sel_w = le_table(memcheck_info["num_accesses"] - 1,
                                 memcheck_info["num_vars"])
                ok = not np.any(den_w.is_zero() & (sel_w == 1))
            if ok:
                nb_full = sum(mem_sels) % P64
                den_b1 = tau_c - beta_c * ((idx + np.uint64(1)) % P64) - lk["bcnt"] - nb_full
                den_b2 = tau_c - beta_c * idx - lk["bcnt"]
                ok = (not np.any(den_b1.is_zero() & (sel1 == 1))
                      and not np.any(den_b2.is_zero() & (sel2 == 1)))
        if ok:
            break
        nonce += 1
        assert nonce <= MAX_NONCE, "bytecode nonce overflow"
    transcript.append_bytes(b"BC_CHAL")
    transcript.append_u64(nonce)
    assert challenge_ext(transcript) == tau
    for expect in (gamma, tau_c, beta_c, tau_o, beta_o, tau_l, delta, tau_r,
                   tau_w, eps):
        assert challenge_ext(transcript) == expect

    # Extension inverse columns, committed as coordinate columns.
    g_bc = sel * (tau - kap_s).inv()
    h_col = denom_t.inv() * (m_col % P64)
    g_c1 = sel1 * den_c1.inv()
    g_c2 = sel2 * den_c2.inv()
    g_out = lk["c_commit"] * den_out.inv()
    g_lk_s = lk["flk"] * den_lk.inv()
    g_cols_all = {"g_bc": g_bc, "g_c1": g_c1, "g_c2": g_c2, "g_out": g_out,
                  "g_lk_s": g_lk_s}
    for i, group in enumerate(RANGE_GROUPS):
        ds = [tau_r - np.uint64(coef) * lk[name] % P64 for name, coef in group]
        if len(ds) == 2:
            g_cols_all[f"grp{i}"] = (ds[0] + ds[1]) * (ds[0] * ds[1]).inv()
        else:
            g_cols_all[f"grp{i}"] = ds[0].inv()
    for i, (ka, kb) in enumerate(GM_GROUPS):
        da, db = mem_dens[ka], mem_dens[kb]
        g_cols_all[f"gmp{i}"] = (mem_sels[ka] * db + mem_sels[kb] * da) \
            * (da * db).inv()
    g_cols_all["g_b1"] = sel1 * den_b1.inv()
    g_cols_all["g_b2"] = sel2 * den_b2.inv()
    h_r = (tau_r - idx_table(16, p)).inv() * (m_r % P64)
    g_sum = g_bc.sum()
    h_sum = h_col.sum()
    gc1_sum = g_c1.sum()
    gc2_sum = g_c2.sum()
    gout_sum = g_out.sum()
    glk_sum = g_lk_s.sum()
    gr_sums = {name: g_cols_all[name].sum() for name in GR_NAMES}
    hr_sum = h_r.sum()
    gm_sums = [g_cols_all[name].sum() for name in GM_NAMES]
    gb1_sum = g_cols_all["g_b1"].sum()
    gb2_sum = g_cols_all["g_b2"].sum()
    transcript.append_bytes(b"BC_G")
    absorb_ext(transcript, g_sum)
    absorb_ext(transcript, gc1_sum)
    absorb_ext(transcript, gc2_sum)
    absorb_ext(transcript, gout_sum)
    absorb_ext(transcript, glk_sum)
    for name in GR_NAMES:
        absorb_ext(transcript, gr_sums[name])
    for s in gm_sums:
        absorb_ext(transcript, s)
    absorb_ext(transcript, gb1_sum)
    absorb_ext(transcript, gb2_sum)
    transcript.append_bytes(b"BC_H")
    absorb_ext(transcript, h_sum)
    transcript.append_bytes(b"BC_HR")
    absorb_ext(transcript, hr_sum)
    if not _unsafe_skip_self_checks:
        if sum(gr_sums.values()) != hr_sum:
            raise AssertionError(
                "bytecode argument violated: adder limb out of RANGE16"
            )
        if gb1_sum != gb2_sum:
            raise AssertionError(
                "bytecode argument violated: byte-counter chain mismatch"
            )
        if g_sum != h_sum:
            raise AssertionError("bytecode argument violated: fetch multiset mismatch")
        if gc1_sum != gc2_sum:
            raise AssertionError("bytecode argument violated: counter chain mismatch")
        pub_sum = den_pub.inv().sum() if len(outs) else ext_lift(0)
        if gout_sum != pub_sum:
            raise AssertionError("bytecode argument violated: output tape mismatch")

    # Memory-side linkage advice: one inverse column over the memcheck
    # byte-row domain (proven against the memcheck columns in the
    # zerocheck phase).
    mcc = memcheck_info["cols"]
    A = memcheck_info["num_accesses"]
    mvv = memcheck_info["num_vars"]
    idx_A = np.arange(1 << mvv, dtype=np.uint64) % P64
    kap_w = ep[0] * idx_A
    for j in range(4):
        kap_w = kap_w + ep[1 + j] * mcc[f"ba{j}"]
    kap_w = kap_w + ep[5] * mcc["bk"] + ep[6] * mcc["vw"] + ep[7] * mcc["st"]
    sel_w = le_table(A - 1, mvv)
    g_lnk = sel_w * (tau_w - kap_w).inv()
    wg_sum = g_lnk.sum()
    transcript.append_bytes(b"BC_WLNK")
    absorb_ext(transcript, wg_sum)
    if sum(gm_sums) != wg_sum and not _unsafe_skip_self_checks:
        raise AssertionError(
            "bytecode argument violated: memory access/step multiset mismatch"
        )

    # Query-side linkage advice (constraints/linkage.py): per-table g_lk
    # inverse columns over the validity query domains.
    from .linkage import build_query_link_advice

    lk_advice, link_total = build_query_link_advice(
        F, transcript, validity_info, tau_l, delta
    )
    if link_total != glk_sum and not _unsafe_skip_self_checks:
        raise AssertionError(
            "bytecode argument violated: lookup-queries/steps multiset mismatch"
        )

    self.sel, self.sel1, self.sel2, self.idx = sel, sel1, sel2, idx
    self.nonce = nonce
    self.challenges = (tau, gamma, tau_c, beta_c, tau_o, beta_o, tau_l,
                       delta, tau_r, tau_w, eps)
    self.ep = ep
    self.kap_t = kap_t
    self.g_cols_all = g_cols_all
    self.g_coords = pack_g_coords(g_cols_all)
    self.h_col, self.h_r = h_col, h_r
    self.g_lnk, self.sel_w, self.idx_A = g_lnk, sel_w, idx_A
    self.A, self.mvv, self.mcc = A, mvv, mcc
    self.sums = dict(
        g_sum=g_sum, h_sum=h_sum, gc1_sum=gc1_sum, gc2_sum=gc2_sum,
        gout_sum=gout_sum, glk_sum=glk_sum, gr_sums=gr_sums, hr_sum=hr_sum,
        gm_sums=gm_sums, gb1_sum=gb1_sum, gb2_sum=gb2_sum, wg_sum=wg_sum,
    )
    out = dict(self.g_coords)
    out.update(pack_g_coords({"h_prog": h_col, "h_r16": h_r,
                              "g_lnk": g_lnk}))
    out.update(lk_advice)
    return out


def _bc_zerocheck_phase(self: BytecodeArgument, transcript, sink) -> None:
    F, trace = self.F, self.trace
    entry_pc, num_vars = self.entry_pc, self.num_vars
    padded = 1 << num_vars
    final_pc = self.final_pc
    n, table, lk = self.n, self.table, self.lk
    m_col, m_r = self.m_col, self.m_r
    reg_cols = self.reg_arg.cols
    pcs_cols = self.core_arg.columns
    validity_info = self.validity_info
    p = F.MODULUS
    P64 = np.uint64(p)
    (tau, gamma, tau_c, beta_c, tau_o, beta_o, tau_l, delta, tau_r,
     tau_w, eps) = self.challenges
    ep, kap_t = self.ep, self.kap_t
    sel, sel1, sel2, idx = self.sel, self.sel1, self.sel2, self.idx
    g_cols_all, h_col, h_r = self.g_cols_all, self.h_col, self.h_r
    s = self.sums

    # Step-domain zerocheck (extension challenges throughout).
    zc_cols = dict(lk)
    zc_cols.update(pack_g_coords(g_cols_all))
    for name in _REG_REFS:
        zc_cols[f"ref_{name}"] = reg_cols[name]
    for name in _PCS_REFS:
        zc_cols[f"ref_{name}"] = pcs_cols[name] % P64
    zc_cols["__sel__"] = sel
    zc_cols["__eq0__"] = np.zeros(padded, dtype=np.uint64)
    zc_cols["__eq0__"][0] = 1
    zc_cols["__idx__"] = idx
    zc_cols["__sel1__"] = sel1
    zc_cols["__sel2__"] = sel2
    combiner, _pub = _make_step_combiner(
        tau, gamma, entry_pc % p, n, num_vars, p, tau_c, beta_c, tau_o, beta_o,
        tau_l, delta, tau_r, tau_w, eps, final_pc,
    )
    zc = ZerocheckExtProver(
        F, zc_cols, combiner, BYTECODE_DEGREE, num_alphas=NUM_BC_CONSTRAINTS,
        device=unified_device(self),
        dev_columns=unified_dev_columns(self, zc_cols),
    ).prove(transcript)

    # Program-domain zerocheck (public Ext4 key MLE).
    t_combiner, _ = _make_table_combiner(tau, kap_t, p)
    t_cols = {"m": m_col, "__key__": kap_t}
    t_cols.update(pack_g_coords({"h": h_col}))
    zc_t = ZerocheckExtProver(
        F, t_cols, t_combiner, BYTECODE_DEGREE, num_alphas=1,
        device=unified_device(self),
        dev_columns=unified_dev_columns(
            self, t_cols,
            rename=lambda n: ("m_prog" if n == "m"
                              else n.replace("h", "h_prog", 1)
                              if n.startswith("h#") else n),
        ),
    ).prove(transcript)

    # RANGE16-domain zerocheck (public key = index).
    key16 = idx_table(16, p)
    r_combiner, _ = _make_table_combiner(tau_r, key16, p)
    r_cols = {"m": m_r, "__key__": key16}
    r_cols.update(pack_g_coords({"h": h_r}))
    zc_r = ZerocheckExtProver(
        F, r_cols, r_combiner, BYTECODE_DEGREE, num_alphas=1,
        device=unified_device(self),
        dev_columns=unified_dev_columns(
            self, r_cols,
            rename=lambda n: ("m_r16" if n == "m"
                              else n.replace("h", "h_r16", 1)
                              if n.startswith("h#") else n),
        ),
    ).prove(transcript)

    # Claims at the step-zerocheck point: own lk/g columns via this
    # argument's locmap, ref_* columns via the regcheck / v2-core maps.
    register_bc_step_claims(self, sink, zc)

    # Table-side claims (program domain): local zc names "m"/"h#e" map to
    # the committed "m_prog"/"h_prog#e" columns.
    register_bc_table_claims(self, sink, zc_t, "m_prog", "h_prog")
    register_bc_table_claims(self, sink, zc_r, "m_r16", "h_r16")

    # Witness linkage, query side (constraints/linkage.py): per-table
    # zerochecks proving the g_lk inverse columns against the validity
    # argument's committed query representation.
    from .linkage import prove_query_links

    links = prove_query_links(F, transcript, sink, validity_info,
                              tau_l, delta, self.locmap)

    # Memory-side linkage zerocheck over the memcheck byte-row domain.
    wl_combiner, _ = _make_memlink_combiner(tau_w, ep, self.A, self.mvv, p)
    wl_cols = {"__sel__": self.sel_w, "__idx__": self.idx_A}
    wl_cols.update(pack_g_coords({"g_lnk": self.g_lnk}))
    for name in ("ba0", "ba1", "ba2", "ba3", "bk", "vw", "st"):
        wl_cols[f"ref_{name}"] = self.mcc[name]
    zc_mem = ZerocheckExtProver(
        F, wl_cols, wl_combiner, MEMLINK_DEGREE, num_alphas=1,
        device=unified_device(self),
        dev_columns=unified_dev_columns(self, wl_cols),
    ).prove(transcript)
    register_bc_memlink_claims(self, sink, zc_mem)

    self.proof = BytecodeProof(
        nonce=self.nonce, num_vars=num_vars, table_vars=table.num_vars,
        zc=zc, zc_table=zc_t, zc_range=zc_r, zc_mem=zc_mem,
        g_sum=s["g_sum"], h_sum=s["h_sum"], gc1_sum=s["gc1_sum"],
        gc2_sum=s["gc2_sum"], gout_sum=s["gout_sum"], glk_sum=s["glk_sum"],
        links=links, gr_sums=s["gr_sums"], hr_sum=s["hr_sum"],
        gm_sums=s["gm_sums"], gb1_sum=s["gb1_sum"], gb2_sum=s["gb2_sum"],
        wg_sum=s["wg_sum"],
    )


def register_bc_step_claims(arg, sink, zc) -> None:
    """Shared prover/verifier claim schedule for the step zerocheck: own
    columns via arg.locmap; ref_* via the regcheck / v2-core locmaps."""
    reg_locmap = arg.reg_arg.locmap
    pcs_locmap = arg.core_arg.locmap
    reg_refs = {f"ref_{n}": n for n in _REG_REFS}
    pcs_refs = {f"ref_{n}": n for n in _PCS_REFS}
    for name in sorted(zc.column_evals):
        if name in reg_refs:
            ck, fn, v = reg_locmap[reg_refs[name]]
        elif name in pcs_refs:
            ck, fn, v = pcs_locmap[pcs_refs[name]]
        else:
            ck, fn, v = arg.locmap[name]
        sink.eval_claim(ck, fn, v, zc.final_point, zc.column_evals[name])
    from ..core.ext4 import ext_lift as _lift

    s = arg.sums
    g_sums = {
        "g_bc": s["g_sum"], "g_c1": s["gc1_sum"], "g_c2": s["gc2_sum"],
        "g_out": s["gout_sum"], "g_lk_s": s["glk_sum"],
        "g_b1": s["gb1_sum"], "g_b2": s["gb2_sum"],
    }
    for name in GR_NAMES:
        g_sums[name] = s["gr_sums"][name]
    for i, name in enumerate(GM_NAMES):
        g_sums[name] = s["gm_sums"][i]
    for g in sorted(g_sums):
        for e in range(4):
            ck, fn, v = arg.locmap[f"{g}#{e}"]
            sink.sum_claim(ck, fn, v, _lift(int(g_sums[g].c[e])))


def register_bc_table_claims(arg, sink, zc_t, m_name: str, h_name: str) -> None:
    from ..core.ext4 import ext_lift as _lift

    for name in sorted(zc_t.column_evals):
        if name == "m":
            ck, fn, v = arg.locmap[m_name]
        else:  # "h#e"
            ck, fn, v = arg.locmap[f"{h_name}{name[1:]}"]
        sink.eval_claim(ck, fn, v, zc_t.final_point, zc_t.column_evals[name])
    h_sum = arg.sums["h_sum"] if h_name == "h_prog" else arg.sums["hr_sum"]
    for e in range(4):
        ck, fn, v = arg.locmap[f"{h_name}#{e}"]
        sink.sum_claim(ck, fn, v, _lift(int(h_sum.c[e])))


def register_bc_memlink_claims(arg, sink, zc_mem) -> None:
    from ..core.ext4 import ext_lift as _lift

    mc_locmap = arg.mem_arg.locmap
    wl_refs = {f"ref_{n}": n for n in ("ba0", "ba1", "ba2", "ba3", "bk", "vw", "st")}
    for name in sorted(zc_mem.column_evals):
        if name in wl_refs:
            ck, fn, v = mc_locmap[wl_refs[name]]
        else:  # "g_lnk#e"
            ck, fn, v = arg.locmap[name]
        sink.eval_claim(ck, fn, v, zc_mem.final_point, zc_mem.column_evals[name])
    wg_sum = arg.sums["wg_sum"]
    for e in range(4):
        ck, fn, v = arg.locmap[f"g_lnk#{e}"]
        sink.sum_claim(ck, fn, v, _lift(int(wg_sum.c[e])))


def _mle_eval(col: np.ndarray, rs: List[Ext4], p: int) -> Ext4:
    """Base column folded at an extension point -> Ext4 evaluation."""
    tab = col.astype(np.uint64) % np.uint64(p)
    for r in rs:
        half = tab.shape[-1] // 2
        tab = (1 - r) * tab[..., :half] + r * tab[..., half:]
    if isinstance(tab, Ext4):
        return Ext4(tab.c.reshape(4))
    return Ext4.lift(int(tab[0]))  # num_vars == 0: no folds happened


# ---------------------------------------------------------------------------
# Verifier


BC_G_NAMES = (["g_bc", "g_c1", "g_c2", "g_out", "g_lk_s", "g_b1", "g_b2"]
              + list(GR_NAMES) + list(GM_NAMES))


class BytecodeVerify:
    """Verifier-side phased argument (prover/unified.py harness).  Needs
    the regcheck / v2-core / validity / memcheck verify-args for their
    locmaps (cross-argument reference claims)."""

    ns = "bc"

    def __init__(self, F, bc: BytecodeProof, program: bytes, entry_pc: int,
                 num_steps: int, num_vars: int, reg_arg, core_arg,
                 validity_arg, mem_arg, outputs=None, final_pc: int = 0):
        self.F = F
        self.bc = bc
        self.program = program
        self.entry_pc = entry_pc
        self.num_steps = num_steps
        self.num_vars = num_vars
        self.reg_arg = reg_arg
        self.core_arg = core_arg
        self.validity_arg = validity_arg
        self.mem_arg = mem_arg
        self.outputs = outputs
        self.final_pc = final_pc
        self.locmap = {}

    def data_phase(self, transcript):
        bc = self.bc
        if not isinstance(bc, BytecodeProof):
            return None
        p = self.F.MODULUS
        if bc.num_vars != self.num_vars:
            return None
        table = build_bytecode_table(self.program, self.entry_pc, None, p)
        if bc.table_vars != table.num_vars:
            return None
        if table.addrs.size and int(table.addrs.max()) >= ADDR_BOUND:
            return None  # protocol rule: addresses < 2^29 (see ADDR_BOUND)
        if not (0 <= bc.nonce <= MAX_NONCE):
            return None

        transcript.append_bytes(b"BC_BEGIN")
        transcript.append_u64(self.num_steps)
        transcript.append_u64(table.num_vars)
        self.table = table
        shape = {name: self.num_vars for name in sorted(LINK_COLUMNS)}
        shape["m_prog"] = table.num_vars
        shape["m_r16"] = 16
        return shape

    def advice_phase(self, transcript):
        from .linkage import verify_query_link_sums

        bc, F = self.bc, self.F
        p = F.MODULUS
        transcript.append_bytes(b"BC_CHAL")
        transcript.append_u64(bc.nonce)
        tau = challenge_ext(transcript)
        gamma = challenge_ext(transcript)
        tau_c = challenge_ext(transcript)
        beta_c = challenge_ext(transcript)
        tau_o = challenge_ext(transcript)
        beta_o = challenge_ext(transcript)
        tau_l = challenge_ext(transcript)
        delta = challenge_ext(transcript)
        tau_r = challenge_ext(transcript)
        tau_w = challenge_ext(transcript)
        eps = challenge_ext(transcript)
        if not high_coords_nonzero(tau_r):
            return None
        ep = _eps_powers(eps, p)
        kap_t = self.table.kappa(gamma, p)
        if np.any((tau - kap_t).is_zero()):
            return None
        # Public side of the output-tape logUp: the verifier sums it itself.
        outs = [int(v) & _int64_mask for v in (self.outputs or [])]
        ob = _out_betas(beta_o, p)
        pub_sum = ext_lift(0)
        for j, v in enumerate(outs):
            key = ob[0] * (j % p)
            for k in range(4):
                key = key + ob[k + 1] * ((v >> (16 * k)) & 0xFFFF)
            den = tau_o - key
            if bool(den.is_zero()):
                return None
            pub_sum = pub_sum + den.inv()

        gr_sums_in = bc.gr_sums or {}
        gm_in = list(bc.gm_sums or [])
        ext_sums = ([bc.g_sum, bc.gc1_sum, bc.gc2_sum, bc.gout_sum, bc.glk_sum,
                     bc.h_sum, bc.hr_sum, bc.gb1_sum, bc.gb2_sum, bc.wg_sum]
                    + list(gr_sums_in.values()) + gm_in)
        if not all(isinstance(v, Ext4) and v.is_scalar for v in ext_sums):
            return None
        if set(gr_sums_in) != set(GR_NAMES):
            return None
        if len(gm_in) != len(GM_GROUPS):
            return None
        transcript.append_bytes(b"BC_G")
        absorb_ext(transcript, bc.g_sum)
        absorb_ext(transcript, bc.gc1_sum)
        absorb_ext(transcript, bc.gc2_sum)
        absorb_ext(transcript, bc.gout_sum)
        absorb_ext(transcript, bc.glk_sum)
        for name in GR_NAMES:
            absorb_ext(transcript, gr_sums_in[name])
        for v in gm_in:
            absorb_ext(transcript, v)
        absorb_ext(transcript, bc.gb1_sum)
        absorb_ext(transcript, bc.gb2_sum)
        transcript.append_bytes(b"BC_H")
        absorb_ext(transcript, bc.h_sum)
        transcript.append_bytes(b"BC_HR")
        absorb_ext(transcript, bc.hr_sum)
        # Grand equations.
        if bc.g_sum != bc.h_sum:
            return None
        if bc.gc1_sum != bc.gc2_sum:
            return None
        if bc.gout_sum != pub_sum:
            return None
        if sum(gr_sums_in.values()) != bc.hr_sum:
            return None
        if bc.gb1_sum != bc.gb2_sum:
            return None
        if sum(gm_in) != bc.wg_sum:
            return None

        # Memory-side linkage sum, then per-table query-link sums.
        transcript.append_bytes(b"BC_WLNK")
        absorb_ext(transcript, bc.wg_sum)
        lv_tables = self.validity_arg.lv.tables
        ok, link_total = verify_query_link_sums(transcript, bc.links or [],
                                                lv_tables)
        if not ok or link_total != bc.glk_sum:
            return None

        self.challenges = (tau, gamma, tau_c, beta_c, tau_o, beta_o, tau_l,
                           delta, tau_r, tau_w, eps)
        self.ep = ep
        self.kap_t = kap_t
        # Reconstruct the sums dict the shared claim helpers consume.
        self.sums = dict(
            g_sum=bc.g_sum, h_sum=bc.h_sum, gc1_sum=bc.gc1_sum,
            gc2_sum=bc.gc2_sum, gout_sum=bc.gout_sum, glk_sum=bc.glk_sum,
            gr_sums=gr_sums_in, hr_sum=bc.hr_sum, gm_sums=gm_in,
            gb1_sum=bc.gb1_sum, gb2_sum=bc.gb2_sum, wg_sum=bc.wg_sum,
        )
        mvv = self.mem_arg.mc.num_vars
        shape = {gc: self.num_vars for gc in g_coord_names(BC_G_NAMES)}
        for e in range(4):
            shape[f"h_prog#{e}"] = self.table.num_vars
            shape[f"h_r16#{e}"] = 16
            shape[f"g_lnk#{e}"] = mvv
        for link in bc.links or []:
            for e in range(4):
                shape[f"lk{link.table_id}:g_lk#{e}"] = link.num_vars
        return shape

    def zerocheck_phase(self, transcript, sink) -> bool:
        from .linkage import verify_query_links

        bc, F = self.bc, self.F
        p = F.MODULUS
        (tau, gamma, tau_c, beta_c, tau_o, beta_o, tau_l, delta, tau_r,
         tau_w, eps) = self.challenges
        num_vars = self.num_vars
        table = self.table

        lk_names = sorted(LINK_COLUMNS)
        expected_cols = (set(lk_names) | set(g_coord_names(BC_G_NAMES))
                         | {f"ref_{n}" for n in _REG_REFS}
                         | {f"ref_{n}" for n in _PCS_REFS})
        if set(bc.zc.column_evals) != expected_cols:
            return False
        if bc.zc.num_vars != num_vars or bc.zc.degree != BYTECODE_DEGREE:
            return False
        combiner, step_public = _make_step_combiner(
            tau, gamma, self.entry_pc % p, self.num_steps, num_vars, p,
            tau_c, beta_c, tau_o, beta_o, tau_l, delta, tau_r, tau_w, eps,
            self.final_pc,
        )
        if not ZerocheckExtVerifier(F, combiner, NUM_BC_CONSTRAINTS,
                                    BYTECODE_DEGREE,
                                    public_evals=step_public).verify(bc.zc, transcript):
            return False

        if bc.zc_table.num_vars != table.num_vars or bc.zc_table.degree != BYTECODE_DEGREE:
            return False
        if set(bc.zc_table.column_evals) != {"m"} | set(g_coord_names(["h"])):
            return False
        t_combiner, t_public = _make_table_combiner(tau, self.kap_t, p)
        if not ZerocheckExtVerifier(F, t_combiner, 1, BYTECODE_DEGREE,
                                    public_evals=t_public).verify(
            bc.zc_table, transcript
        ):
            return False

        if bc.zc_range is None or bc.zc_range.num_vars != 16:
            return False
        if bc.zc_range.degree != BYTECODE_DEGREE:
            return False
        if set(bc.zc_range.column_evals) != {"m"} | set(g_coord_names(["h"])):
            return False
        key16 = idx_table(16, p)
        r_combiner, r_public = _make_table_combiner(tau_r, key16, p)
        if not ZerocheckExtVerifier(F, r_combiner, 1, BYTECODE_DEGREE,
                                    public_evals=r_public).verify(
            bc.zc_range, transcript
        ):
            return False

        register_bc_step_claims(self, sink, bc.zc)
        register_bc_table_claims(self, sink, bc.zc_table, "m_prog", "h_prog")
        register_bc_table_claims(self, sink, bc.zc_range, "m_r16", "h_r16")

        # Witness linkage, query side: every gadget-covered validity table
        # must carry a link record (counts already matched in advice).
        if not verify_query_links(F, transcript, sink, bc.links or [],
                                  tau_l, delta, self.validity_arg.locmap,
                                  self.locmap):
            return False

        # Memory-side linkage over the memcheck byte-row domain.
        mc = self.mem_arg.mc
        A, mvv = mc.num_accesses, mc.num_vars
        wl_refs = ("ba0", "ba1", "ba2", "ba3", "bk", "vw", "st")
        wg_names = sorted(g_coord_names(["g_lnk"]))
        if bc.zc_mem is None:
            return False
        if bc.zc_mem.num_vars != mvv or bc.zc_mem.degree != MEMLINK_DEGREE:
            return False
        if set(bc.zc_mem.column_evals) != set(wg_names) | {f"ref_{n}" for n in wl_refs}:
            return False
        wl_combiner, wl_public = _make_memlink_combiner(tau_w, self.ep, A, mvv, p)
        if not ZerocheckExtVerifier(F, wl_combiner, 1, MEMLINK_DEGREE,
                                    public_evals=wl_public).verify(
            bc.zc_mem, transcript
        ):
            return False
        register_bc_memlink_claims(self, sink, bc.zc_mem)
        return True
