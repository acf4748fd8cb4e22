"""RV64I instruction decoder (consensus-critical; feeds the witness).

Reference: zigz src/isa/rv64i.zig.  Field extraction, per-format
immediate sign extension, and the opcode-0 rejection (:128) are replicated
exactly.  Unknown (non-enumerated) opcodes decode successfully with R-format
(imm=0) and fail later at execution with ``UnimplementedInstruction`` —
matching the reference's non-exhaustive-enum behavior (rv64i.zig:58,71).
"""

from __future__ import annotations

__all__ = [
    "Opcode",
    "OPCODE_NAMES",
    "InstructionFormat",
    "Instruction",
    "decode",
    "InvalidInstruction",
    "FUNCT3_LD",
    "FUNCT3_LWU",
    "FUNCT3_SD",
    "FUNCT3_LW",
]


class InvalidInstruction(Exception):
    """error.InvalidInstruction (decode of opcode 0)."""


class Opcode:
    LOAD = 0b0000011
    LOAD_FP = 0b0000111
    MISC_MEM = 0b0001111
    OP_IMM = 0b0010011
    AUIPC = 0b0010111
    OP_IMM_32 = 0b0011011
    STORE = 0b0100011
    STORE_FP = 0b0100111
    AMO = 0b0101111
    OP = 0b0110011
    LUI = 0b0110111
    OP_32 = 0b0111011
    MADD = 0b1000011
    MSUB = 0b1000111
    NMSUB = 0b1001011
    NMADD = 0b1001111
    OP_FP = 0b1010011
    BRANCH = 0b1100011
    JALR = 0b1100111
    JAL = 0b1101111
    SYSTEM = 0b1110011


OPCODE_NAMES = {
    v: k for k, v in vars(Opcode).items() if not k.startswith("_")
}

FUNCT3_LD = 0b011
FUNCT3_LWU = 0b110
FUNCT3_SD = 0b011
FUNCT3_LW = 0b010


class InstructionFormat:
    R, I, S, B, U, J = range(6)


_FORMAT_BY_OPCODE = {
    Opcode.OP: InstructionFormat.R,
    Opcode.OP_32: InstructionFormat.R,
    Opcode.AMO: InstructionFormat.R,
    Opcode.OP_IMM: InstructionFormat.I,
    Opcode.OP_IMM_32: InstructionFormat.I,
    Opcode.JALR: InstructionFormat.I,
    Opcode.LOAD: InstructionFormat.I,
    Opcode.LOAD_FP: InstructionFormat.I,
    Opcode.MISC_MEM: InstructionFormat.I,
    Opcode.SYSTEM: InstructionFormat.I,
    Opcode.STORE: InstructionFormat.S,
    Opcode.STORE_FP: InstructionFormat.S,
    Opcode.BRANCH: InstructionFormat.B,
    Opcode.LUI: InstructionFormat.U,
    Opcode.AUIPC: InstructionFormat.U,
    Opcode.JAL: InstructionFormat.J,
    Opcode.MADD: InstructionFormat.R,
    Opcode.MSUB: InstructionFormat.R,
    Opcode.NMSUB: InstructionFormat.R,
    Opcode.NMADD: InstructionFormat.R,
    Opcode.OP_FP: InstructionFormat.R,
}


def instruction_format(opcode: int) -> int:
    """rv64i.zig:61-73 — unknown opcodes default to R-type."""
    return _FORMAT_BY_OPCODE.get(opcode, InstructionFormat.R)


class Instruction:
    __slots__ = ("opcode", "rd", "funct3", "rs1", "rs2", "funct7", "imm")

    def __init__(self, opcode, rd, funct3, rs1, rs2, funct7, imm):
        self.opcode = opcode
        self.rd = rd
        self.funct3 = funct3
        self.rs1 = rs1
        self.rs2 = rs2
        self.funct7 = funct7
        self.imm = imm  # signed 64-bit Python int

    def is_rv64i_only(self) -> bool:
        op = self.opcode
        if op in (Opcode.OP_IMM_32, Opcode.OP_32):
            return True
        if op == Opcode.LOAD:
            return self.funct3 in (FUNCT3_LD, FUNCT3_LWU)
        if op == Opcode.STORE:
            return self.funct3 == FUNCT3_SD
        return False

    def is_word_operation(self) -> bool:
        op = self.opcode
        if op in (Opcode.OP_IMM_32, Opcode.OP_32):
            return True
        if op == Opcode.LOAD:
            return self.funct3 == FUNCT3_LW
        return False

    def name(self) -> str:
        """Human-readable mnemonic (superset of rv32i.zig:201-254)."""
        op, f3, f7 = self.opcode, self.funct3, self.funct7
        if op == Opcode.OP:
            if f7 == 0b0000001:
                return ("mul", "mulh", "mulhsu", "mulhu", "div", "divu", "rem", "remu")[f3]
            base = ("add", "sll", "slt", "sltu", "xor", "srl", "or", "and")[f3]
            if f3 == 0 and f7 == 0b0100000:
                return "sub"
            if f3 == 0b101 and f7 == 0b0100000:
                return "sra"
            return base
        if op == Opcode.OP_32:
            if f7 == 0b0000001:
                return {0: "mulw", 4: "divw", 5: "divuw", 6: "remw", 7: "remuw"}.get(f3, "op32?")
            if f3 == 0:
                return "subw" if f7 == 0b0100000 else "addw"
            if f3 == 0b001:
                return "sllw"
            if f3 == 0b101:
                return "sraw" if f7 == 0b0100000 else "srlw"
            return "op32?"
        if op == Opcode.OP_IMM:
            base = ("addi", "slli", "slti", "sltiu", "xori", "srli", "ori", "andi")[f3]
            if f3 == 0b101 and f7 == 0b0100000:
                return "srai"
            return base
        if op == Opcode.OP_IMM_32:
            return {0: "addiw", 1: "slliw", 5: "sraiw" if f7 == 0b0100000 else "srliw"}.get(f3, "opimm32?")
        if op == Opcode.LOAD:
            return {0: "lb", 1: "lh", 2: "lw", 3: "ld", 4: "lbu", 5: "lhu", 6: "lwu"}.get(f3, "load?")
        if op == Opcode.STORE:
            return {0: "sb", 1: "sh", 2: "sw", 3: "sd"}.get(f3, "store?")
        if op == Opcode.BRANCH:
            return {0: "beq", 1: "bne", 4: "blt", 5: "bge", 6: "bltu", 7: "bgeu"}.get(f3, "branch?")
        return {
            Opcode.LUI: "lui",
            Opcode.AUIPC: "auipc",
            Opcode.JAL: "jal",
            Opcode.JALR: "jalr",
            Opcode.SYSTEM: "ecall/ebreak",
            Opcode.MISC_MEM: "fence",
        }.get(op, "unknown")

    def __repr__(self):
        return (
            f"Instruction({self.name()} op={self.opcode:#04x} rd={self.rd} "
            f"f3={self.funct3} rs1={self.rs1} rs2={self.rs2} f7={self.funct7} imm={self.imm})"
        )


def _sign_extend(value: int, sign_bit_mask: int, width_mask: int) -> int:
    if value & sign_bit_mask:
        return value - (width_mask + 1)
    return value


def decode(word: int) -> Instruction:
    """rv64i.zig:124-151 — rejects opcode 0, sign-extends per format."""
    opcode = word & 0x7F
    if opcode == 0:
        raise InvalidInstruction()

    rd = (word >> 7) & 0x1F
    funct3 = (word >> 12) & 0x07
    rs1 = (word >> 15) & 0x1F
    rs2 = (word >> 20) & 0x1F
    funct7 = (word >> 25) & 0x7F

    fmt = instruction_format(opcode)
    if fmt == InstructionFormat.I:
        imm_u = (word >> 20) & 0xFFF
        imm = _sign_extend(imm_u, 0x800, 0xFFF)
    elif fmt == InstructionFormat.S:
        imm_u = (((word >> 25) & 0x7F) << 5) | ((word >> 7) & 0x1F)
        imm = _sign_extend(imm_u, 0x800, 0xFFF)
    elif fmt == InstructionFormat.B:
        imm_u = (
            (((word >> 31) & 0x1) << 12)
            | (((word >> 7) & 0x1) << 11)
            | (((word >> 25) & 0x3F) << 5)
            | (((word >> 8) & 0x0F) << 1)
        )
        imm = _sign_extend(imm_u, 0x1000, 0x1FFF)
    elif fmt == InstructionFormat.U:
        imm_u = word & 0xFFFFF000
        imm = _sign_extend(imm_u, 0x80000000, 0xFFFFFFFF)
    elif fmt == InstructionFormat.J:
        imm_u = (
            (((word >> 31) & 0x1) << 20)
            | (((word >> 12) & 0xFF) << 12)
            | (((word >> 20) & 0x1) << 11)
            | (((word >> 21) & 0x3FF) << 1)
        )
        imm = _sign_extend(imm_u, 0x100000, 0x1FFFFF)
    else:  # R-type
        imm = 0

    return Instruction(opcode, rd, funct3, rs1, rs2, funct7, imm)


Instruction.decode = staticmethod(decode)
