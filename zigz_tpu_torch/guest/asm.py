"""RV64IM assembler + ELF64 writer for zkVM guest programs.

The reference cross-compiles guests with the Zig toolchain
(build.zig:82-110); this framework ships a self-contained assembler so
guests need no external toolchain.  Emits the instruction subset the VM
executes (RV64I + M + ECALL/EBREAK) and wraps the code in a minimal
ELF64 with one PT_LOAD segment, loadable by zigz_tpu.elf (and by the
reference's loader — same header layout it parses, elf.zig:57-79).

The SP1-style I/O idiom (reference src/io.zig):

    read(a0)   = [li(a7, 2), ecall()]   # a0 <- next input-tape word
    commit(a0) = [li(a7, 1), ecall()]   # append a0 to the output tape
"""

from __future__ import annotations

import struct
from typing import List

__all__ = ["Assembler", "write_elf64", "ECALL_COMMIT", "ECALL_READ"]

ECALL_COMMIT = 1
ECALL_READ = 2

# ABI register aliases.
REG = {
    "zero": 0, "ra": 1, "sp": 2, "gp": 3, "tp": 4,
    "t0": 5, "t1": 6, "t2": 7, "s0": 8, "fp": 8, "s1": 9,
    "a0": 10, "a1": 11, "a2": 12, "a3": 13, "a4": 14, "a5": 15,
    "a6": 16, "a7": 17,
    "s2": 18, "s3": 19, "s4": 20, "s5": 21, "s6": 22, "s7": 23,
    "s8": 24, "s9": 25, "s10": 26, "s11": 27,
    "t3": 28, "t4": 29, "t5": 30, "t6": 31,
}
for _i in range(32):
    REG[f"x{_i}"] = _i


def _r(reg) -> int:
    return REG[reg] if isinstance(reg, str) else int(reg)


def _fit(value: int, bits: int, signed: bool = True) -> int:
    lo = -(1 << (bits - 1)) if signed else 0
    hi = (1 << (bits - 1)) - 1 if signed else (1 << bits) - 1
    if not (lo <= value <= hi):
        raise ValueError(f"immediate {value} does not fit in {bits} bits")
    return value & ((1 << bits) - 1)


class Assembler:
    """Two-pass assembler with labels and pc-relative branches/jumps."""

    def __init__(self, base: int = 0x1000):
        self.base = base
        self.items: List[object] = []  # ints (words) or ("label", name) / pending
        self.labels = {}

    # -- layout ------------------------------------------------------------
    def label(self, name: str) -> "Assembler":
        self.labels[name] = len([i for i in self.items if not isinstance(i, tuple) or i[0] != "label"])
        self.items.append(("label", name))
        return self

    def _emit(self, word: int) -> "Assembler":
        self.items.append(word & 0xFFFFFFFF)
        return self

    def _emit_pending(self, kind: str, *args) -> "Assembler":
        self.items.append((kind,) + args)
        return self

    # -- encoders ----------------------------------------------------------
    @staticmethod
    def _rtype(opcode, rd, f3, rs1, rs2, f7):
        return opcode | (rd << 7) | (f3 << 12) | (rs1 << 15) | (rs2 << 20) | (f7 << 25)

    @staticmethod
    def _itype(opcode, rd, f3, rs1, imm12):
        return opcode | (rd << 7) | (f3 << 12) | (rs1 << 15) | (imm12 << 20)

    @staticmethod
    def _stype(opcode, f3, rs1, rs2, imm12):
        return (
            opcode
            | ((imm12 & 0x1F) << 7)
            | (f3 << 12)
            | (rs1 << 15)
            | (rs2 << 20)
            | ((imm12 >> 5) << 25)
        )

    @staticmethod
    def _btype(opcode, f3, rs1, rs2, imm13):
        return (
            opcode
            | (((imm13 >> 11) & 1) << 7)
            | (((imm13 >> 1) & 0xF) << 8)
            | (f3 << 12)
            | (rs1 << 15)
            | (rs2 << 20)
            | (((imm13 >> 5) & 0x3F) << 25)
            | (((imm13 >> 12) & 1) << 31)
        )

    @staticmethod
    def _utype(opcode, rd, imm32):
        return opcode | (rd << 7) | (imm32 & 0xFFFFF000)

    @staticmethod
    def _jtype(opcode, rd, imm21):
        return (
            opcode
            | (rd << 7)
            | (((imm21 >> 12) & 0xFF) << 12)
            | (((imm21 >> 11) & 1) << 20)
            | (((imm21 >> 1) & 0x3FF) << 21)
            | (((imm21 >> 20) & 1) << 31)
        )

    # -- RV64I -------------------------------------------------------------
    def addi(self, rd, rs1, imm):
        return self._emit(self._itype(0x13, _r(rd), 0, _r(rs1), _fit(imm, 12)))

    def slti(self, rd, rs1, imm):
        return self._emit(self._itype(0x13, _r(rd), 2, _r(rs1), _fit(imm, 12)))

    def sltiu(self, rd, rs1, imm):
        return self._emit(self._itype(0x13, _r(rd), 3, _r(rs1), _fit(imm, 12)))

    def xori(self, rd, rs1, imm):
        return self._emit(self._itype(0x13, _r(rd), 4, _r(rs1), _fit(imm, 12)))

    def ori(self, rd, rs1, imm):
        return self._emit(self._itype(0x13, _r(rd), 6, _r(rs1), _fit(imm, 12)))

    def andi(self, rd, rs1, imm):
        return self._emit(self._itype(0x13, _r(rd), 7, _r(rs1), _fit(imm, 12)))

    def slli(self, rd, rs1, shamt):
        return self._emit(self._itype(0x13, _r(rd), 1, _r(rs1), shamt & 0x3F))

    def srli(self, rd, rs1, shamt):
        return self._emit(self._itype(0x13, _r(rd), 5, _r(rs1), shamt & 0x3F))

    def srai(self, rd, rs1, shamt):
        return self._emit(self._itype(0x13, _r(rd), 5, _r(rs1), (shamt & 0x3F) | 0x400))

    def addiw(self, rd, rs1, imm):
        return self._emit(self._itype(0x1B, _r(rd), 0, _r(rs1), _fit(imm, 12)))

    def slliw(self, rd, rs1, shamt):
        return self._emit(self._itype(0x1B, _r(rd), 1, _r(rs1), shamt & 31))

    def srliw(self, rd, rs1, shamt):
        return self._emit(self._itype(0x1B, _r(rd), 5, _r(rs1), shamt & 31))

    def sraiw(self, rd, rs1, shamt):
        return self._emit(self._itype(0x1B, _r(rd), 5, _r(rs1), (shamt & 31) | 0x400))

    def _opw(self, f3, f7):
        def fn(rd, rs1, rs2):
            return self._emit(self._rtype(0x3B, _r(rd), f3, _r(rs1), _r(rs2), f7))

        return fn

    def addw(self, rd, rs1, rs2):
        return self._opw(0, 0)(rd, rs1, rs2)

    def subw(self, rd, rs1, rs2):
        return self._opw(0, 0x20)(rd, rs1, rs2)

    def sllw(self, rd, rs1, rs2):
        return self._opw(1, 0)(rd, rs1, rs2)

    def srlw(self, rd, rs1, rs2):
        return self._opw(5, 0)(rd, rs1, rs2)

    def sraw(self, rd, rs1, rs2):
        return self._opw(5, 0x20)(rd, rs1, rs2)

    def lui(self, rd, imm20):
        return self._emit(self._utype(0x37, _r(rd), imm20 << 12))

    def auipc(self, rd, imm20):
        return self._emit(self._utype(0x17, _r(rd), imm20 << 12))

    def _op(self, f3, f7):
        def fn(rd, rs1, rs2):
            return self._emit(self._rtype(0x33, _r(rd), f3, _r(rs1), _r(rs2), f7))

        return fn

    def add(self, rd, rs1, rs2):
        return self._op(0, 0)(rd, rs1, rs2)

    def sub(self, rd, rs1, rs2):
        return self._op(0, 0x20)(rd, rs1, rs2)

    def sll(self, rd, rs1, rs2):
        return self._op(1, 0)(rd, rs1, rs2)

    def slt(self, rd, rs1, rs2):
        return self._op(2, 0)(rd, rs1, rs2)

    def sltu(self, rd, rs1, rs2):
        return self._op(3, 0)(rd, rs1, rs2)

    def xor(self, rd, rs1, rs2):
        return self._op(4, 0)(rd, rs1, rs2)

    def srl(self, rd, rs1, rs2):
        return self._op(5, 0)(rd, rs1, rs2)

    def sra(self, rd, rs1, rs2):
        return self._op(5, 0x20)(rd, rs1, rs2)

    def or_(self, rd, rs1, rs2):
        return self._op(6, 0)(rd, rs1, rs2)

    def and_(self, rd, rs1, rs2):
        return self._op(7, 0)(rd, rs1, rs2)

    # -- RV64M -------------------------------------------------------------
    def mul(self, rd, rs1, rs2):
        return self._op(0, 1)(rd, rs1, rs2)

    def mulh(self, rd, rs1, rs2):
        return self._op(1, 1)(rd, rs1, rs2)

    def mulhsu(self, rd, rs1, rs2):
        return self._op(2, 1)(rd, rs1, rs2)

    def mulw(self, rd, rs1, rs2):
        return self._opw(0, 1)(rd, rs1, rs2)

    def divw(self, rd, rs1, rs2):
        return self._opw(4, 1)(rd, rs1, rs2)

    def divuw(self, rd, rs1, rs2):
        return self._opw(5, 1)(rd, rs1, rs2)

    def remw(self, rd, rs1, rs2):
        return self._opw(6, 1)(rd, rs1, rs2)

    def remuw(self, rd, rs1, rs2):
        return self._opw(7, 1)(rd, rs1, rs2)

    def mulhu(self, rd, rs1, rs2):
        return self._op(3, 1)(rd, rs1, rs2)

    def div(self, rd, rs1, rs2):
        return self._op(4, 1)(rd, rs1, rs2)

    def divu(self, rd, rs1, rs2):
        return self._op(5, 1)(rd, rs1, rs2)

    def rem(self, rd, rs1, rs2):
        return self._op(6, 1)(rd, rs1, rs2)

    def remu(self, rd, rs1, rs2):
        return self._op(7, 1)(rd, rs1, rs2)

    # -- loads/stores --------------------------------------------------------
    def _load(self, f3):
        def fn(rd, rs1, imm=0):
            return self._emit(self._itype(0x03, _r(rd), f3, _r(rs1), _fit(imm, 12)))

        return fn

    def _store(self, f3):
        def fn(rs2, rs1, imm=0):
            return self._emit(self._stype(0x23, f3, _r(rs1), _r(rs2), _fit(imm, 12)))

        return fn

    def lb(self, rd, rs1, imm=0):
        return self._load(0)(rd, rs1, imm)

    def lh(self, rd, rs1, imm=0):
        return self._load(1)(rd, rs1, imm)

    def lw(self, rd, rs1, imm=0):
        return self._load(2)(rd, rs1, imm)

    def ld(self, rd, rs1, imm=0):
        return self._load(3)(rd, rs1, imm)

    def lbu(self, rd, rs1, imm=0):
        return self._load(4)(rd, rs1, imm)

    def lhu(self, rd, rs1, imm=0):
        return self._load(5)(rd, rs1, imm)

    def lwu(self, rd, rs1, imm=0):
        return self._load(6)(rd, rs1, imm)

    def sb(self, rs2, rs1, imm=0):
        return self._store(0)(rs2, rs1, imm)

    def sh(self, rs2, rs1, imm=0):
        return self._store(1)(rs2, rs1, imm)

    def sw(self, rs2, rs1, imm=0):
        return self._store(2)(rs2, rs1, imm)

    def sd(self, rs2, rs1, imm=0):
        return self._store(3)(rs2, rs1, imm)

    # -- control flow --------------------------------------------------------
    def _branch(self, f3):
        def fn(rs1, rs2, target: str):
            return self._emit_pending("branch", f3, _r(rs1), _r(rs2), target)

        return fn

    def beq(self, rs1, rs2, target):
        return self._branch(0)(rs1, rs2, target)

    def bne(self, rs1, rs2, target):
        return self._branch(1)(rs1, rs2, target)

    def blt(self, rs1, rs2, target):
        return self._branch(4)(rs1, rs2, target)

    def bge(self, rs1, rs2, target):
        return self._branch(5)(rs1, rs2, target)

    def bltu(self, rs1, rs2, target):
        return self._branch(6)(rs1, rs2, target)

    def bgeu(self, rs1, rs2, target):
        return self._branch(7)(rs1, rs2, target)

    def jal(self, rd, target):
        return self._emit_pending("jal", _r(rd), target)

    def jalr(self, rd, rs1, imm=0):
        return self._emit(self._itype(0x67, _r(rd), 0, _r(rs1), _fit(imm, 12)))

    def j(self, target):
        return self.jal(0, target)

    # -- system --------------------------------------------------------------
    def ecall(self):
        return self._emit(0x00000073)

    def ebreak(self):
        return self._emit(0x00100073)

    # -- pseudo-instructions --------------------------------------------------
    def li(self, rd, value: int):
        """Load any 64-bit immediate: ADDI / LUI+ADDIW for 32-bit-signed
        values, otherwise recursive 11-bit shift-or chunks (each trailing
        ADDI immediate stays non-negative, so no sign corrections)."""
        value &= (1 << 64) - 1
        signed = value - (1 << 64) if value >= (1 << 63) else value
        if -2048 <= signed <= 2047:
            return self.addi(rd, 0, signed)
        if -(1 << 31) <= signed < (1 << 31):
            upper = (signed + 0x800) >> 12
            lower = signed - (upper << 12)
            self.lui(rd, upper & 0xFFFFF)
            if lower:
                self.addiw(rd, rd, lower)
            return self
        high = signed >> 11  # arithmetic shift
        low = signed - (high << 11)  # in [0, 2047]
        self.li(rd, high)
        self.slli(rd, rd, 11)
        if low:
            self.addi(rd, rd, low)
        return self

    def mv(self, rd, rs):
        return self.addi(rd, rs, 0)

    def nop(self):
        return self.addi(0, 0, 0)

    # -- guest I/O idiom (mirrors zigz_io, reference src/io.zig) -------------
    def io_read(self, rd="a0"):
        """a0 <- next input word; moves into rd if different."""
        self.li("a7", ECALL_READ)
        self.ecall()
        if _r(rd) != REG["a0"]:
            self.mv(rd, "a0")
        return self

    def io_commit(self, rs="a0"):
        """Append rs to the public output tape."""
        if _r(rs) != REG["a0"]:
            self.mv("a0", rs)
        self.li("a7", ECALL_COMMIT)
        self.ecall()
        return self

    # -- procedures and structured loops (guest SDK ergonomics) --------------
    # The reference's guest story is a full Zig cross-compile
    # (build.zig:82-110); this DSL grows the idioms hand-written guests
    # actually need: call/ret with a real stack, and counted loops.
    def _fresh_label(self, prefix: str) -> str:
        n = getattr(self, "_label_counter", 0)
        self._label_counter = n + 1
        return f"__{prefix}_{n}"

    def call(self, target: str):
        """jal ra, target — pair with :meth:`ret` inside the procedure."""
        return self.jal("ra", target)

    def ret(self):
        return self.jalr(0, "ra", 0)

    def push(self, reg):
        """Push reg on the downward stack at sp (caller must li sp first)."""
        self.addi("sp", "sp", -8)
        return self.sd(reg, "sp", 0)

    def pop(self, reg):
        self.ld(reg, "sp", 0)
        return self.addi("sp", "sp", 8)

    def for_range(self, reg, count, bound_reg="t6"):
        """Counted loop: ``with a.for_range("t0", n): <body>`` runs the
        body with reg = 0..n-1.  ``count`` may be an int (loaded into
        bound_reg) or a register name holding the bound; the body must
        not clobber reg or bound_reg."""
        asm = self

        class _ForRange:
            def __enter__(self_inner):
                if isinstance(count, int):
                    asm.li(bound_reg, count)
                    self_inner.bound = bound_reg
                else:
                    self_inner.bound = count
                asm.li(reg, 0)
                self_inner.top = asm._fresh_label("for")
                self_inner.done = asm._fresh_label("endfor")
                asm.label(self_inner.top)
                asm.bge(reg, self_inner.bound, self_inner.done)
                return self_inner

            def __exit__(self_inner, exc_type, exc, tb):
                if exc_type is not None:
                    return False
                asm.addi(reg, reg, 1)
                asm.j(self_inner.top)
                asm.label(self_inner.done)
                return False

        return _ForRange()

    # -- assembly ------------------------------------------------------------
    def assemble(self) -> bytes:
        # Pass 1: assign addresses.
        addr = {}
        pc = 0
        for item in self.items:
            if isinstance(item, tuple) and item[0] == "label":
                addr[item[1]] = pc
            else:
                pc += 4
        # Pass 2: resolve.
        out = bytearray()
        pc = 0
        for item in self.items:
            if isinstance(item, tuple):
                if item[0] == "label":
                    continue
                if item[0] == "branch":
                    _, f3, rs1, rs2, target = item
                    offset = addr[target] - pc
                    word = self._btype(0x63, f3, rs1, rs2, _fit(offset, 13))
                elif item[0] == "jal":
                    _, rd, target = item
                    offset = addr[target] - pc
                    word = self._jtype(0x6F, rd, _fit(offset, 21))
                else:
                    raise ValueError(item[0])
            else:
                word = item
            out += struct.pack("<I", word)
            pc += 4
        return bytes(out)

    def to_elf(self) -> bytes:
        return write_elf64(self.assemble(), self.base)


def write_elf64(code: bytes, vaddr: int, entry: int = None) -> bytes:
    """Minimal ELF64 (little-endian, RISC-V) with one PT_LOAD segment."""
    if entry is None:
        entry = vaddr
    ehsize, phentsize = 64, 56
    phoff = ehsize
    code_off = ehsize + phentsize

    ehdr = struct.pack(
        "<4sBBBBB7xHHIQQQIHHHHHH",
        b"\x7fELF",
        2,  # ELFCLASS64
        1,  # ELFDATA2LSB
        1,  # EV_CURRENT
        0,  # ELFOSABI_NONE
        0,  # ABI version
        2,  # ET_EXEC
        0xF3,  # EM_RISCV
        1,  # e_version
        entry,
        phoff,
        0,  # e_shoff
        0,  # e_flags
        ehsize,
        phentsize,
        1,  # e_phnum
        0, 0, 0,  # shentsize/shnum/shstrndx
    )
    phdr = struct.pack(
        "<IIQQQQQQ",
        1,  # PT_LOAD
        5,  # PF_R | PF_X
        code_off,
        vaddr,
        vaddr,
        len(code),
        len(code),
        0x1000,
    )
    return ehdr + phdr + code
