"""RV32I legacy decoder with encode() round-trip and mnemonics.

Reference: zigz src/isa/rv32i.zig — the 32-bit twin kept for the
isa test tier.  ``decode`` rejects any opcode not in the enumerated set
(``std.meta.intToEnum`` fails — rv32i.zig:146-148), unlike the RV64I decoder
which only rejects opcode 0.
"""

from __future__ import annotations

from .rv64i import InstructionFormat, Opcode, _sign_extend

__all__ = ["Instruction", "decode", "InvalidOpcode"]


class InvalidOpcode(Exception):
    """error.InvalidOpcode."""


_VALID_OPCODES = {
    v for k, v in vars(Opcode).items() if not k.startswith("_")
}

_FORMAT32 = {
    Opcode.OP: InstructionFormat.R,
    Opcode.OP_32: InstructionFormat.R,
    Opcode.OP_IMM: InstructionFormat.I,
    Opcode.OP_IMM_32: InstructionFormat.I,
    Opcode.JALR: InstructionFormat.I,
    Opcode.LOAD: InstructionFormat.I,
    Opcode.MISC_MEM: InstructionFormat.I,
    Opcode.SYSTEM: InstructionFormat.I,
    Opcode.STORE: InstructionFormat.S,
    Opcode.STORE_FP: InstructionFormat.S,
    Opcode.BRANCH: InstructionFormat.B,
    Opcode.LUI: InstructionFormat.U,
    Opcode.AUIPC: InstructionFormat.U,
    Opcode.JAL: InstructionFormat.J,
}


class Instruction:
    __slots__ = ("raw", "format", "opcode", "rd", "funct3", "rs1", "rs2", "funct7", "imm")

    def __init__(self, raw, fmt, opcode, rd, funct3, rs1, rs2, funct7, imm):
        self.raw = raw
        self.format = fmt
        self.opcode = opcode
        self.rd = rd
        self.funct3 = funct3
        self.rs1 = rs1
        self.rs2 = rs2
        self.funct7 = funct7
        self.imm = imm  # signed 32-bit

    def encode(self) -> int:
        """rv32i.zig:176-198 — reassemble the R-type field layout."""
        word = self.opcode
        word |= self.rd << 7
        word |= self.funct3 << 12
        word |= self.rs1 << 15
        word |= self.rs2 << 20
        word |= self.funct7 << 25
        return word & 0xFFFFFFFF

    def name(self) -> str:
        """rv32i.zig:201-254."""
        op, f3, f7 = self.opcode, self.funct3, self.funct7
        if op == Opcode.OP:
            if f3 == 0:
                return "add" if f7 == 0 else "sub"
            if f3 == 0b101:
                return "srl" if f7 == 0 else "sra"
            return ("add", "sll", "slt", "sltu", "xor", "srl", "or", "and")[f3]
        if op == Opcode.OP_IMM:
            if f3 == 0b101:
                return "srli" if f7 == 0 else "srai"
            return ("addi", "slli", "slti", "sltiu", "xori", "srli", "ori", "andi")[f3]
        if op == Opcode.LOAD:
            return {0: "lb", 1: "lh", 2: "lw", 4: "lbu", 5: "lhu"}.get(f3, "load?")
        if op == Opcode.STORE:
            return {0: "sb", 1: "sh", 2: "sw"}.get(f3, "store?")
        if op == Opcode.BRANCH:
            return {0: "beq", 1: "bne", 4: "blt", 5: "bge", 6: "bltu", 7: "bgeu"}.get(f3, "branch?")
        return {
            Opcode.LUI: "lui",
            Opcode.AUIPC: "auipc",
            Opcode.JAL: "jal",
            Opcode.JALR: "jalr",
            Opcode.SYSTEM: "ecall/ebreak",
        }.get(op, "unknown")


def decode(word: int) -> Instruction:
    opcode = word & 0x7F
    if opcode not in _VALID_OPCODES:
        raise InvalidOpcode()
    fmt = _FORMAT32.get(opcode, InstructionFormat.R)

    rd = (word >> 7) & 0x1F
    funct3 = (word >> 12) & 0x07
    rs1 = (word >> 15) & 0x1F
    rs2 = (word >> 20) & 0x1F
    funct7 = (word >> 25) & 0x7F

    if fmt == InstructionFormat.I:
        imm = _sign_extend((word >> 20) & 0xFFF, 0x800, 0xFFF)
    elif fmt == InstructionFormat.S:
        imm = _sign_extend((((word >> 25) & 0x7F) << 5) | ((word >> 7) & 0x1F), 0x800, 0xFFF)
    elif fmt == InstructionFormat.B:
        imm_u = (
            (((word >> 31) & 0x1) << 12)
            | (((word >> 7) & 0x1) << 11)
            | (((word >> 25) & 0x3F) << 5)
            | (((word >> 8) & 0xF) << 1)
        )
        imm = _sign_extend(imm_u, 0x1000, 0x1FFF)
    elif fmt == InstructionFormat.U:
        imm = _sign_extend(word & 0xFFFFF000, 0x80000000, 0xFFFFFFFF)
    elif fmt == InstructionFormat.J:
        imm_u = (
            (((word >> 31) & 0x1) << 20)
            | (((word >> 12) & 0xFF) << 12)
            | (((word >> 20) & 0x1) << 11)
            | (((word >> 21) & 0x3FF) << 1)
        )
        imm = _sign_extend(imm_u, 0x100000, 0x1FFFFF)
    else:
        imm = 0

    return Instruction(word, fmt, opcode, rd, funct3, rs1, rs2, funct7, imm)


Instruction.decode = staticmethod(decode)
