"""RV64I register file: 32 x u64, x0 hardwired to zero.

Reference: zigz src/vm/registers.zig (x0 behavior at :38-48).
"""

from __future__ import annotations

__all__ = ["RegisterFile", "register_name"]

_M64 = (1 << 64) - 1

_ABI_NAMES = (
    "zero", "ra", "sp", "gp", "tp", "t0", "t1", "t2",
    "s0/fp", "s1", "a0", "a1", "a2", "a3", "a4", "a5",
    "a6", "a7", "s2", "s3", "s4", "s5", "s6", "s7",
    "s8", "s9", "s10", "s11", "t3", "t4", "t5", "t6",
)


def register_name(reg: int) -> str:
    return _ABI_NAMES[reg]


class RegisterFile:
    __slots__ = ("regs",)

    def __init__(self, regs=None):
        self.regs = list(regs) if regs is not None else [0] * 32

    def read(self, reg: int) -> int:
        if reg == 0:
            return 0
        return self.regs[reg]

    def write(self, reg: int, value: int) -> None:
        if reg == 0:
            return  # x0 is hardwired to zero
        self.regs[reg] = value & _M64

    def snapshot(self) -> "RegisterFile":
        return RegisterFile(self.regs)

    def __eq__(self, other):
        return self.regs == other.regs
