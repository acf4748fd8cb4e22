"""RV64IM virtual machine with trace recording (consensus-critical).

Reference: zigz src/vm/state.zig.  This interpreter feeds the
Fiat-Shamir transcript through the witness, so every semantic edge is
replicated bit-for-bit:

* fetch via 4 byte-granular loads; decode failure (opcode 0) sets ``halted``
  and raises :class:`InvalidInstruction` (state.zig:136-140);
* full RV64I + RV64M with RISC-V div-by-zero / INT_MIN//-1 semantics
  (state.zig:221-317) and word-op sign extension (:319-397);
* ECALL protocol: a7=1 commits a0 to the output tape, a7=2 pops the input
  tape into a0 (0 on underflow), unknown syscalls no-op (:564-587);
  EBREAK halts with ``next_pc == pc`` (:588-592);
* unimplemented opcodes raise (they do NOT halt) — matching the reference
  where only decode failures are caught by run/prove loops (:172-184).
"""

from __future__ import annotations

from typing import List, Optional

from ..elf import Segment
from ..isa import instruction_table, rv64i
from ..isa.rv64i import InvalidInstruction, Opcode
from .memory import LoadSize, Memory
from .registers import RegisterFile
from .trace import AccessType, ExecutionTrace, MemoryAccess

__all__ = [
    "VMState",
    "ECALL_COMMIT",
    "ECALL_READ",
    "VMHalted",
    "InvalidInstruction",
    "UnimplementedInstruction",
    "UnimplementedSYSTEM",
    "VMError",
    "MaxStepsExceeded",
]

ECALL_COMMIT = 1
ECALL_READ = 2

_M64 = (1 << 64) - 1
_M32 = (1 << 32) - 1
_I64_MIN = -(1 << 63)
_I32_MIN = -(1 << 31)


class VMError(Exception):
    pass


class VMHalted(VMError):
    pass


class UnimplementedInstruction(VMError):
    pass


class UnimplementedSYSTEM(VMError):
    pass


class MaxStepsExceeded(VMError):
    pass


def _to_i64(u: int) -> int:
    return u - (1 << 64) if u & (1 << 63) else u


def _to_u64(s: int) -> int:
    return s & _M64


def _to_i32(u: int) -> int:
    u &= _M32
    return u - (1 << 32) if u & (1 << 31) else u


def _sext32(u32: int) -> int:
    """Sign-extend a 32-bit value to u64 (the *W result rule)."""
    u32 &= _M32
    return u32 | 0xFFFFFFFF00000000 if u32 & 0x80000000 else u32


def _div_trunc(a: int, b: int) -> int:
    """Zig @divTrunc — truncation toward zero."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def _rem_trunc(a: int, b: int) -> int:
    """Zig @rem — remainder with the sign of the dividend."""
    return a - _div_trunc(a, b) * b


class VMState:
    def __init__(self, program: Optional[bytes], start_pc: int, input_tape=None, segments=None):
        self.memory = Memory()
        if segments is not None:
            for seg in segments:
                self.memory.load_program(seg.vaddr, seg.data)
        elif program is not None:
            self.memory.load_program(start_pc, program)
        self.pc = start_pc & _M64
        self.regs = RegisterFile()
        self.trace = ExecutionTrace()
        self.step_count = 0
        self.halted = False
        self.input_tape: List[int] = list(input_tape) if input_tape else []
        self.input_pos = 0
        self.output_tape: List[int] = []
        self._last_write = None  # (reg, value) recorded per step

    # -- constructors matching the reference ------------------------------
    @classmethod
    def init(cls, program: bytes, start_pc: int, input_tape=None) -> "VMState":
        return cls(program, start_pc, input_tape)

    @classmethod
    def init_from_segments(cls, segments: List[Segment], entry_pc: int, input_tape=None) -> "VMState":
        return cls(None, entry_pc, input_tape, segments=segments)

    # -- register write capture -------------------------------------------
    def _wr(self, reg: int, value: int) -> None:
        if reg != 0:
            value &= _M64
            self.regs.regs[reg] = value
            self._last_write = (reg, value)

    # -- main loop ---------------------------------------------------------
    def step(self) -> None:
        if self.halted:
            raise VMHalted()

        pc_before = self.pc
        inst_word = self.memory.load_word(self.pc)
        try:
            inst = rv64i.decode(inst_word)
        except InvalidInstruction:
            self.halted = True
            raise

        self._last_write = None
        memory_access = [None]
        next_pc = self._execute(inst, memory_access)

        lookup = instruction_table.get_table_metadata(inst)

        self.trace.add_step(
            pc=pc_before,
            instruction=inst,
            reg_write=self._last_write,
            memory_access=memory_access[0],
            next_pc=next_pc,
            lookup_table=lookup,
        )

        self.pc = next_pc
        self.step_count += 1

    def run(self, max_steps: int) -> None:
        """state.zig:172-184 — InvalidInstruction is a normal halt."""
        steps = 0
        while not self.halted and steps < max_steps:
            try:
                self.step()
            except InvalidInstruction:
                return
            steps += 1
        if steps >= max_steps and not self.halted:
            raise MaxStepsExceeded()

    # -- dispatch (state.zig:188-215) --------------------------------------
    def _execute(self, inst, mem_access) -> int:
        op = inst.opcode
        if op == Opcode.OP:
            return self._exec_op(inst)
        if op == Opcode.OP_32:
            return self._exec_op32(inst)
        if op == Opcode.OP_IMM:
            return self._exec_opimm(inst)
        if op == Opcode.OP_IMM_32:
            return self._exec_opimm32(inst)
        if op == Opcode.LOAD:
            return self._exec_load(inst, mem_access)
        if op == Opcode.STORE:
            return self._exec_store(inst, mem_access)
        if op == Opcode.BRANCH:
            return self._exec_branch(inst)
        if op == Opcode.JAL:
            return self._exec_jal(inst)
        if op == Opcode.JALR:
            return self._exec_jalr(inst)
        if op == Opcode.LUI:
            return self._exec_lui(inst)
        if op == Opcode.AUIPC:
            return self._exec_auipc(inst)
        if op == Opcode.SYSTEM:
            return self._exec_system(inst)
        if op == Opcode.MISC_MEM:
            return self.pc + 4  # FENCE no-op
        raise UnimplementedInstruction(f"opcode {op:#04x}")

    # -- OP (state.zig:221-317) --------------------------------------------
    def _exec_op(self, inst) -> int:
        rs1 = self.regs.read(inst.rs1)
        rs2 = self.regs.read(inst.rs2)
        f3 = inst.funct3

        if inst.funct7 == 0b0000001:  # RV64M
            if f3 == 0b000:  # MUL
                result = (rs1 * rs2) & _M64
            elif f3 == 0b001:  # MULH
                result = ((_to_i64(rs1) * _to_i64(rs2)) >> 64) & _M64
            elif f3 == 0b010:  # MULHSU
                result = ((_to_i64(rs1) * rs2) >> 64) & _M64
            elif f3 == 0b011:  # MULHU
                result = (rs1 * rs2) >> 64
            elif f3 == 0b100:  # DIV
                a, b = _to_i64(rs1), _to_i64(rs2)
                if b == 0:
                    result = _M64  # -1
                elif a == _I64_MIN and b == -1:
                    result = _to_u64(a)
                else:
                    result = _to_u64(_div_trunc(a, b))
            elif f3 == 0b101:  # DIVU
                result = _M64 if rs2 == 0 else rs1 // rs2
            elif f3 == 0b110:  # REM
                a, b = _to_i64(rs1), _to_i64(rs2)
                if b == 0:
                    result = rs1
                elif a == _I64_MIN and b == -1:
                    result = 0
                else:
                    result = _to_u64(_rem_trunc(a, b))
            else:  # REMU
                result = rs1 if rs2 == 0 else rs1 % rs2
            self._wr(inst.rd, result)
            return self.pc + 4

        if f3 == 0b000:
            result = (rs1 - rs2) & _M64 if inst.funct7 == 0b0100000 else (rs1 + rs2) & _M64
        elif f3 == 0b001:  # SLL
            result = (rs1 << (rs2 & 0x3F)) & _M64
        elif f3 == 0b010:  # SLT
            result = 1 if _to_i64(rs1) < _to_i64(rs2) else 0
        elif f3 == 0b011:  # SLTU
            result = 1 if rs1 < rs2 else 0
        elif f3 == 0b100:  # XOR
            result = rs1 ^ rs2
        elif f3 == 0b101:  # SRL / SRA
            shamt = rs2 & 0x3F
            if inst.funct7 == 0b0100000:
                result = _to_u64(_to_i64(rs1) >> shamt)
            else:
                result = rs1 >> shamt
        elif f3 == 0b110:  # OR
            result = rs1 | rs2
        else:  # AND
            result = rs1 & rs2

        self._wr(inst.rd, result)
        return self.pc + 4

    # -- OP_32 (state.zig:319-397) ------------------------------------------
    def _exec_op32(self, inst) -> int:
        rs1 = self.regs.read(inst.rs1) & _M32
        rs2 = self.regs.read(inst.rs2) & _M32
        f3 = inst.funct3

        if inst.funct7 == 0b0000001:  # RV64M word ops
            if f3 == 0b000:  # MULW
                r32 = (rs1 * rs2) & _M32
            elif f3 == 0b100:  # DIVW
                a, b = _to_i32(rs1), _to_i32(rs2)
                if b == 0:
                    r32 = _M32  # -1
                elif a == _I32_MIN and b == -1:
                    r32 = a & _M32
                else:
                    r32 = _div_trunc(a, b) & _M32
            elif f3 == 0b101:  # DIVUW
                r32 = _M32 if rs2 == 0 else rs1 // rs2
            elif f3 == 0b110:  # REMW
                a, b = _to_i32(rs1), _to_i32(rs2)
                if b == 0:
                    r32 = rs1
                elif a == _I32_MIN and b == -1:
                    r32 = 0
                else:
                    r32 = _rem_trunc(a, b) & _M32
            elif f3 == 0b111:  # REMUW
                r32 = rs1 if rs2 == 0 else rs1 % rs2
            else:
                raise VMError("InvalidOP32M")
            self._wr(inst.rd, _sext32(r32))
            return self.pc + 4

        if f3 == 0b000:
            r32 = (rs1 - rs2) & _M32 if inst.funct7 == 0b0100000 else (rs1 + rs2) & _M32
        elif f3 == 0b001:  # SLLW
            r32 = (rs1 << (rs2 & 0x1F)) & _M32
        elif f3 == 0b101:  # SRLW / SRAW
            shamt = rs2 & 0x1F
            if inst.funct7 == 0b0100000:
                r32 = (_to_i32(rs1) >> shamt) & _M32
            else:
                r32 = rs1 >> shamt
        else:
            raise VMError("InvalidOP32")

        self._wr(inst.rd, _sext32(r32))
        return self.pc + 4

    # -- OP_IMM (state.zig:399-425) -------------------------------------------
    def _exec_opimm(self, inst) -> int:
        rs1 = self.regs.read(inst.rs1)
        imm = _to_u64(inst.imm)
        f3 = inst.funct3

        if f3 == 0b000:  # ADDI
            result = (rs1 + imm) & _M64
        elif f3 == 0b001:  # SLLI
            result = (rs1 << (imm & 0x3F)) & _M64
        elif f3 == 0b010:  # SLTI
            result = 1 if _to_i64(rs1) < inst.imm else 0
        elif f3 == 0b011:  # SLTIU
            result = 1 if rs1 < imm else 0
        elif f3 == 0b100:  # XORI
            result = rs1 ^ imm
        elif f3 == 0b101:  # SRLI / SRAI
            shamt = imm & 0x3F
            if inst.funct7 == 0b0100000:
                result = _to_u64(_to_i64(rs1) >> shamt)
            else:
                result = rs1 >> shamt
        elif f3 == 0b110:  # ORI
            result = rs1 | imm
        else:  # ANDI
            result = rs1 & imm

        self._wr(inst.rd, result)
        return self.pc + 4

    # -- OP_IMM_32 (state.zig:427-450) ------------------------------------------
    def _exec_opimm32(self, inst) -> int:
        rs1 = self.regs.read(inst.rs1) & _M32
        imm = _to_u64(inst.imm)
        f3 = inst.funct3

        if f3 == 0b000:  # ADDIW
            r32 = (rs1 + (imm & _M32)) & _M32
        elif f3 == 0b001:  # SLLIW
            r32 = (rs1 << (imm & 0x1F)) & _M32
        elif f3 == 0b101:  # SRLIW / SRAIW
            shamt = imm & 0x1F
            if inst.funct7 == 0b0100000:
                r32 = (_to_i32(rs1) >> shamt) & _M32
            else:
                r32 = rs1 >> shamt
        else:
            raise VMError("InvalidOPIMM32")

        self._wr(inst.rd, _sext32(r32))
        return self.pc + 4

    # -- LOAD / STORE (state.zig:452-507) -----------------------------------------
    def _exec_load(self, inst, mem_access) -> int:
        base = self.regs.read(inst.rs1)
        addr = (base + inst.imm) & _M64
        f3 = inst.funct3

        if f3 == 0b000:  # LB
            result = _to_u64(self.memory.load_sign_extended(addr, LoadSize.Byte))
        elif f3 == 0b001:  # LH
            result = _to_u64(self.memory.load_sign_extended(addr, LoadSize.Halfword))
        elif f3 == 0b010:  # LW
            result = _to_u64(self.memory.load_sign_extended(addr, LoadSize.Word))
        elif f3 == 0b011:  # LD
            result = self.memory.load_doubleword(addr)
        elif f3 == 0b100:  # LBU
            result = self.memory.load_zero_extended(addr, LoadSize.Byte)
        elif f3 == 0b101:  # LHU
            result = self.memory.load_zero_extended(addr, LoadSize.Halfword)
        elif f3 == 0b110:  # LWU
            result = self.memory.load_zero_extended(addr, LoadSize.Word)
        else:
            raise VMError("InvalidLoadFunct3")

        size = {0: LoadSize.Byte, 4: LoadSize.Byte, 1: LoadSize.Halfword, 5: LoadSize.Halfword,
                2: LoadSize.Word, 6: LoadSize.Word, 3: LoadSize.Doubleword}[f3]
        mem_access[0] = MemoryAccess(AccessType.Load, addr, result, size)
        self._wr(inst.rd, result)
        return self.pc + 4

    def _exec_store(self, inst, mem_access) -> int:
        base = self.regs.read(inst.rs1)
        addr = (base + inst.imm) & _M64
        value = self.regs.read(inst.rs2)
        f3 = inst.funct3

        if f3 > 0b011:
            raise VMError("InvalidStoreFunct3")
        size = (LoadSize.Byte, LoadSize.Halfword, LoadSize.Word, LoadSize.Doubleword)[f3]
        self.memory.store(addr, value, size)
        mem_access[0] = MemoryAccess(AccessType.Store, addr, value, size)
        return self.pc + 4

    # -- control flow (state.zig:509-562) -------------------------------------------
    def _exec_branch(self, inst) -> int:
        rs1 = self.regs.read(inst.rs1)
        rs2 = self.regs.read(inst.rs2)
        f3 = inst.funct3

        if f3 == 0b000:
            taken = rs1 == rs2
        elif f3 == 0b001:
            taken = rs1 != rs2
        elif f3 == 0b100:
            taken = _to_i64(rs1) < _to_i64(rs2)
        elif f3 == 0b101:
            taken = _to_i64(rs1) >= _to_i64(rs2)
        elif f3 == 0b110:
            taken = rs1 < rs2
        elif f3 == 0b111:
            taken = rs1 >= rs2
        else:
            raise VMError("InvalidBranchFunct3")

        if taken:
            return (self.pc + inst.imm) & _M64
        return self.pc + 4

    def _exec_jal(self, inst) -> int:
        self._wr(inst.rd, self.pc + 4)
        return (self.pc + inst.imm) & _M64

    def _exec_jalr(self, inst) -> int:
        base = self.regs.read(inst.rs1)
        self._wr(inst.rd, self.pc + 4)
        return ((base + inst.imm) & _M64) & ~1

    def _exec_lui(self, inst) -> int:
        self._wr(inst.rd, _to_u64(inst.imm))
        return self.pc + 4

    def _exec_auipc(self, inst) -> int:
        self._wr(inst.rd, (self.pc + inst.imm) & _M64)
        return self.pc + 4

    # -- SYSTEM (state.zig:564-597) ----------------------------------------------
    def _exec_system(self, inst) -> int:
        if inst.funct3 == 0:
            if inst.imm == 0:  # ECALL
                syscall = self.regs.read(17)  # a7
                if syscall == ECALL_COMMIT:
                    self.output_tape.append(self.regs.read(10))
                elif syscall == ECALL_READ:
                    if self.input_pos < len(self.input_tape):
                        self._wr(10, self.input_tape[self.input_pos])
                        self.input_pos += 1
                    else:
                        self._wr(10, 0)
                # unknown syscall: no-op
                return self.pc + 4
            if inst.imm == 1:  # EBREAK
                self.halted = True
                return self.pc
        raise UnimplementedSYSTEM()
