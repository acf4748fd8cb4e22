"""A plain RV64IM interpreter: the reference's execution of a guest.

Written from the RISC-V unprivileged specification (RV64I + M) and the
zkVM's documented guest interface, not from the program under test:

* memory is byte-addressed, little-endian, zero where no segment was loaded;
* an instruction word whose low 7 bits are 0 is not an instruction: the run
  stops before it, and it is not a step;
* ECALL with a7 = 1 appends a0 to the output tape; with a7 = 2 it pops the
  input tape into a0 (0 once the tape is empty); any other a7 does nothing;
* EBREAK is the last step: the pc stays where it is and the run stops.

It records, per step, the pc and the register write and memory access it
made; `witness_matrix` turns that into the columns a proof commits to.
"""

from __future__ import annotations

import struct
from array import array
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

M64 = (1 << 64) - 1
M32 = (1 << 32) - 1

# Major opcodes (bits 6:0).
LOAD, MISC_MEM, OP_IMM, AUIPC, OP_IMM_32 = 0x03, 0x0F, 0x13, 0x17, 0x1B
STORE, OP, LUI, OP_32 = 0x23, 0x33, 0x37, 0x3B
BRANCH, JALR, JAL, SYSTEM = 0x63, 0x67, 0x6F, 0x73

# Opcodes whose steps each carry one lookup (the ALU, memory and branch
# instructions), in the zkVM's wire format.
LOOKUP_OPCODES = (OP, OP_IMM, LOAD, STORE, BRANCH)


class GuestError(Exception):
    """The guest did something the reference does not execute."""


def parse_elf(data: bytes) -> Tuple[int, List[Tuple[int, bytes]]]:
    """(entry pc, [(vaddr, bytes)] of the PT_LOAD segments) of a 64-bit
    little-endian ELF file."""
    if data[:4] != b"\x7fELF" or data[4] != 2 or data[5] != 1:
        raise GuestError("not a 64-bit little-endian ELF file")
    entry, phoff = struct.unpack_from("<QQ", data, 0x18)
    phentsize, phnum = struct.unpack_from("<HH", data, 0x36)
    segments = []
    for i in range(phnum):
        off = phoff + i * phentsize
        p_type, = struct.unpack_from("<I", data, off)
        if p_type != 1:  # PT_LOAD
            continue
        p_offset, p_vaddr = struct.unpack_from("<QQ", data, off + 8)
        p_filesz, = struct.unpack_from("<Q", data, off + 32)
        segments.append((p_vaddr, data[p_offset:p_offset + p_filesz]))
    return entry, segments


def _sext(value: int, bits: int) -> int:
    sign = 1 << (bits - 1)
    return (value & (sign - 1)) - (value & sign)


def _signed(u: int) -> int:
    return u - (1 << 64) if u >> 63 else u


def decode(word: int) -> Tuple[int, int, int, int, int, int, int]:
    """(opcode, rd, funct3, rs1, rs2, funct7, imm): the raw bit fields, and
    the immediate of the opcode's format, sign-extended (0 for R-type)."""
    op = word & 0x7F
    rd = (word >> 7) & 0x1F
    f3 = (word >> 12) & 0x7
    rs1 = (word >> 15) & 0x1F
    rs2 = (word >> 20) & 0x1F
    f7 = word >> 25
    if op in (OP_IMM, OP_IMM_32, LOAD, JALR, SYSTEM, MISC_MEM):
        imm = _sext(word >> 20, 12)
    elif op == STORE:
        imm = _sext((f7 << 5) | rd, 12)
    elif op == BRANCH:
        imm = _sext(((word >> 31) << 12) | (((word >> 7) & 1) << 11)
                    | (((word >> 25) & 0x3F) << 5) | (((word >> 8) & 0xF) << 1), 13)
    elif op in (LUI, AUIPC):
        imm = _sext(word & 0xFFFFF000, 32)
    elif op == JAL:
        imm = _sext(((word >> 31) << 20) | (((word >> 12) & 0xFF) << 12)
                    | (((word >> 20) & 1) << 11) | (((word >> 21) & 0x3FF) << 1), 21)
    else:
        imm = 0
    return op, rd, f3, rs1, rs2, f7, imm


def _alu(f3: int, alt: bool, a: int, b: int) -> int:
    """RV64I register-register / register-immediate operation on u64s."""
    if f3 == 0:
        return (a - b) & M64 if alt else (a + b) & M64
    if f3 == 1:
        return (a << (b & 63)) & M64
    if f3 == 2:
        return int(_signed(a) < _signed(b))
    if f3 == 3:
        return int(a < b)
    if f3 == 4:
        return a ^ b
    if f3 == 5:
        return (_signed(a) >> (b & 63)) & M64 if alt else a >> (b & 63)
    if f3 == 6:
        return a | b
    return a & b


def _div(a: int, b: int) -> int:
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def _mul_div(f3: int, a: int, b: int, width: int) -> int:
    """RV64M (width 64) or the *W forms (width 32) on unsigned operands."""
    mask = (1 << width) - 1
    a &= mask
    b &= mask
    sa, sb = _sext(a, width), _sext(b, width)
    if f3 == 0:
        return a * b & mask
    if f3 == 1:
        return (sa * sb >> width) & mask
    if f3 == 2:
        return (sa * b >> width) & mask
    if f3 == 3:
        return a * b >> width
    if f3 == 4:
        if b == 0:
            return mask
        if sa == -(1 << (width - 1)) and sb == -1:
            return a
        return _div(sa, sb) & mask
    if f3 == 5:
        return mask if b == 0 else a // b
    if f3 == 6:
        if b == 0:
            return a
        if sa == -(1 << (width - 1)) and sb == -1:
            return 0
        return (sa - _div(sa, sb) * sb) & mask
    return a if b == 0 else a % b


@dataclass
class Execution:
    """What a run did: per-step arrays and the final state."""

    entry_pc: int
    steps: int
    pcs: np.ndarray  # (steps,) uint64
    write_step: np.ndarray  # steps that wrote a register other than x0
    write_reg: np.ndarray
    write_val: np.ndarray  # uint64
    mem_step: np.ndarray  # steps that loaded or stored
    mem_addr: np.ndarray  # uint64
    mem_val: np.ndarray  # uint64
    mem_is_read: np.ndarray
    decoded: Dict[int, Tuple[int, ...]]  # pc -> decode()
    final_pc: int
    final_regs: List[int]
    outputs: List[int] = field(default_factory=list)


def execute(entry_pc: int, segments, input_tape: Optional[List[int]], max_steps: int) -> Execution:
    """Run the guest from `entry_pc` until EBREAK, a word that is not an
    instruction, or `max_steps` steps."""
    mem = bytearray()
    base = min(v for v, _ in segments) if segments else 0
    for vaddr, data in segments:
        end = vaddr - base + len(data)
        if end > len(mem):
            mem.extend(bytes(end - len(mem)))
        mem[vaddr - base:end] = data
    image = dict()  # sparse bytes written outside the loaded image

    def load(addr: int, size: int) -> int:
        out = 0
        for k in range(size):
            a = (addr + k) & M64
            if a in image:
                byte = image[a]
            elif 0 <= a - base < len(mem):
                byte = mem[a - base]
            else:
                byte = 0
            out |= byte << (8 * k)
        return out

    def store(addr: int, value: int, size: int) -> None:
        for k in range(size):
            image[(addr + k) & M64] = (value >> (8 * k)) & 0xFF

    regs = [0] * 32
    tape = list(input_tape or [])
    outputs: List[int] = []
    decoded: Dict[int, Tuple[int, ...]] = {}
    pcs = array("Q")
    w_step, w_reg, w_val = array("q"), array("b"), array("Q")
    m_step, m_addr, m_val, m_read = array("q"), array("Q"), array("Q"), array("b")
    pc = entry_pc & M64
    step = 0
    while step < max_steps:
        inst = decoded.get(pc)
        if inst is None:
            word = load(pc, 4)
            if word & 0x7F == 0:
                break
            inst = decoded[pc] = decode(word)
        op, rd, f3, rs1, rs2, f7, imm = inst
        pcs.append(pc)
        value = None
        nxt = (pc + 4) & M64
        if op == OP_IMM:
            b = imm & M64
            alt = f7 == 0x20 and f3 == 5
            value = _alu(f3, alt, regs[rs1], (b & 63) if f3 in (1, 5) else b)
        elif op == OP:
            if f7 == 1:
                value = _mul_div(f3, regs[rs1], regs[rs2], 64)
            else:
                value = _alu(f3, f7 == 0x20, regs[rs1], regs[rs2])
        elif op == BRANCH:
            a, b = regs[rs1], regs[rs2]
            taken = (a == b, a != b, None, None, _signed(a) < _signed(b),
                     _signed(a) >= _signed(b), a < b, a >= b)[f3]
            if taken is None:
                raise GuestError(f"branch funct3 {f3} at {pc:#x}")
            if taken:
                nxt = (pc + imm) & M64
        elif op == JAL:
            value = (pc + 4) & M64
            nxt = (pc + imm) & M64
        elif op == JALR:
            value = (pc + 4) & M64
            nxt = ((regs[rs1] + imm) & M64) & ~1
        elif op == LUI:
            value = imm & M64
        elif op == AUIPC:
            value = (pc + imm) & M64
        elif op in (OP_IMM_32, OP_32):
            a = regs[rs1] & M32
            if op == OP_32 and f7 == 1:
                if f3 in (1, 2, 3):
                    raise GuestError(f"OP-32 M funct3 {f3} at {pc:#x}")
                r = _mul_div(f3, a, regs[rs2], 32)
            else:
                b = (imm if op == OP_IMM_32 else regs[rs2]) & 31
                if f3 == 0:
                    b = (imm & M32) if op == OP_IMM_32 else regs[rs2] & M32
                    r = (a - b) & M32 if (op == OP_32 and f7 == 0x20) else (a + b) & M32
                elif f3 == 1:
                    r = (a << b) & M32
                elif f3 == 5:
                    r = (_sext(a, 32) >> b) & M32 if f7 == 0x20 else a >> b
                else:
                    raise GuestError(f"word op funct3 {f3} at {pc:#x}")
            value = _sext(r, 32) & M64
        elif op == LOAD:
            addr = (regs[rs1] + imm) & M64
            size = 1 << (f3 & 3)
            if f3 == 7:
                raise GuestError(f"load funct3 7 at {pc:#x}")
            raw = load(addr, size)
            value = raw if (f3 & 4 or size == 8) else _sext(raw, 8 * size) & M64
            m_step.append(step); m_addr.append(addr); m_val.append(value); m_read.append(1)
        elif op == STORE:
            if f3 > 3:
                raise GuestError(f"store funct3 {f3} at {pc:#x}")
            addr = (regs[rs1] + imm) & M64
            store(addr, regs[rs2], 1 << f3)
            m_step.append(step); m_addr.append(addr); m_val.append(regs[rs2]); m_read.append(0)
        elif op == SYSTEM:
            if f3 != 0 or imm not in (0, 1):
                raise GuestError(f"system instruction at {pc:#x}")
            if imm == 1:  # EBREAK: the last step
                step += 1
                break
            if regs[17] == 1:
                outputs.append(regs[10])
            elif regs[17] == 2:
                value = tape.pop(0) & M64 if tape else 0
                rd = 10
        elif op == MISC_MEM:
            pass
        else:
            raise GuestError(f"opcode {op:#x} at {pc:#x}")
        if value is not None and rd != 0:
            regs[rd] = value
            w_step.append(step); w_reg.append(rd); w_val.append(value)
        pc = nxt
        step += 1

    def np_(a, dtype):
        return np.frombuffer(a, dtype=dtype).copy() if len(a) else np.zeros(0, dtype=dtype)

    return Execution(
        entry_pc=entry_pc & M64, steps=step, pcs=np_(pcs, np.uint64),
        write_step=np_(w_step, np.int64), write_reg=np_(w_reg, np.int8), write_val=np_(w_val, np.uint64),
        mem_step=np_(m_step, np.int64), mem_addr=np_(m_addr, np.uint64), mem_val=np_(m_val, np.uint64),
        mem_is_read=np_(m_read, np.int8), decoded=decoded, final_pc=pc, final_regs=list(regs),
        outputs=outputs,
    )


def num_vars(steps: int) -> int:
    """ceil(log2(steps)), 0 for one step."""
    return max(steps - 1, 0).bit_length()


def witness_matrix(ex: Execution, p: int) -> np.ndarray:
    """The 43 witness columns over 2^num_vars rows, canonical mod p (uint64):
    pc, x0..x31 after each step, opcode, rd, rs1, rs2, funct3, funct7, imm,
    memory address, value and is-read. The pc and register columns repeat
    their last value over the padding; the others are 0 there."""
    n = ex.steps
    size = 1 << num_vars(n)
    out = np.zeros((43, size), dtype=np.uint64)
    pu = np.uint64(p)
    out[0, :n] = ex.pcs % pu
    out[0, n:] = out[0, n - 1]
    for r in range(1, 32):  # each register's value after each step: its last write so far, or 0
        sel = ex.write_reg == r
        if not sel.any():
            continue
        last = np.full(n, -1, dtype=np.int64)
        last[ex.write_step[sel]] = np.flatnonzero(sel)
        np.maximum.accumulate(last, out=last)
        col = np.where(last >= 0, ex.write_val[np.maximum(last, 0)] % pu, np.uint64(0))
        out[1 + r, :n] = col
        out[1 + r, n:] = col[-1]
    pcs = sorted(ex.decoded)
    table = np.array([ex.decoded[pc] for pc in pcs], dtype=np.int64)  # (k, 7)
    idx = np.searchsorted(np.array(pcs, dtype=np.uint64), ex.pcs)
    fields = table[idx]  # opcode, rd, f3, rs1, rs2, f7, imm
    for row, col in zip((33, 34, 35, 36, 37, 38, 39), (0, 1, 3, 4, 2, 5, 6)):
        out[row, :n] = fields[:, col].astype(np.uint64) % pu  # imm: two's complement, then mod p
    out[40, ex.mem_step] = ex.mem_addr % pu
    out[41, ex.mem_step] = ex.mem_val % pu
    out[42, ex.mem_step] = ex.mem_is_read.astype(np.uint64)
    return out


def lookup_count(ex: Execution) -> int:
    ops = np.array([ex.decoded[int(pc)][0] for pc in sorted(ex.decoded)], dtype=np.int64)
    carries = np.isin(ops, LOOKUP_OPCODES)
    pcs = np.array(sorted(ex.decoded), dtype=np.uint64)
    return int(carries[np.searchsorted(pcs, ex.pcs)].sum())
