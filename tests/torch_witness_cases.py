"""Traces at the edges of the device witness's padding and masking, and
random raw trace columns for kernel W1 and its plain version.

``EDGE_CASES`` maps a name to a function that returns ``dict(program=...,
initial_regs=...)``, a program at 0x1000 for the native VM: a trace of
exactly 2^v steps, of one step, of 2^v - 1 steps ending in memory steps, a
negative immediate on every kind of step, and a store and a load as the
last two steps.  A program with no ``ebreak`` falls off into zero words,
which ends the trace after its last instruction.

``raw_columns(n_real, seed)`` gives the columns as the native VM lays them
out (u64 pc, reg_write_val, mem_addr, mem_val; int64 imm; u8 the rest),
with the values that break a careless reduction among them: 0, p and p - 1
of each field, 2^31, 2^32 - 1, 2^63 and 2^64 - 1, negative immediates, u8
values up to 255, and addresses and values left as garbage where
``mem_flag`` is 0.  Imports neither JAX nor the JAX package."""

import numpy as np

from zigz_tpu_torch.guest.asm import Assembler

EDGE_U64 = (0, 1, (1 << 31) - 1, 1 << 31, (1 << 32) - 1, 1 << 32, 2013265921, 2013265920, 2130706433,
            (1 << 31) - 1, 17, (1 << 61) - 1, 1 << 61, 0xFFFFFFFF00000001, 0xFFFFFFFF00000000, 1 << 63,
            (1 << 64) - 1, (1 << 64) - 5)


def _pow2_steps():
    a = Assembler()
    for k in range(15):  # 15 steps + ebreak = 16 = 2^4: no padding
        a.addi("t0", "t0", k - 7)
    a.ebreak()
    return dict(program=a.assemble(), initial_regs=None)


def _one_step():
    a = Assembler()
    a.ebreak()  # one step, 2^0 rows
    return dict(program=a.assemble(), initial_regs=None)


def _memory_at_the_end():
    a = Assembler()
    a.li("t1", 0x3000)
    a.li("t0", 0xDEADBEEF)
    for _ in range(5):
        a.addi("t2", "t2", 3)
    a.sd("t0", "t1", 0)
    a.sb("t0", "t1", 9)
    a.lw("t3", "t1", 0)  # sign-extended: above 2^63 as a u64
    a.lbu("t4", "t1", 9)
    a.ld("t5", "t1", 0)  # 2^4 - 1 steps, the last five memory steps
    regs = [0] * 32
    regs[7] = (1 << 64) - 1
    return dict(program=a.assemble(), initial_regs=regs)


def _negative_immediates():
    a = Assembler()
    a.li("t1", 0x3000)
    a.lui("t0", 0x80000)  # imm = -2^31
    a.addi("t0", "t0", -2048)
    a.sd("t0", "t1", -8)
    a.ld("t2", "t1", -8)
    a.lw("t3", "t1", -4)
    a.ebreak()
    return dict(program=a.assemble(), initial_regs=None)


def _store_and_load_last():
    a = Assembler()
    a.li("t1", 0x3000)
    a.li("t0", -7)
    a.addi("t2", "t0", 1)
    a.sd("t0", "t1", 16)
    a.ld("t2", "t1", 16)  # the last step a load, the one before it a store
    regs = [0] * 32
    regs[6] = 1 << 63
    return dict(program=a.assemble(), initial_regs=regs)


EDGE_CASES = {
    "pow2_steps": _pow2_steps,
    "one_step": _one_step,
    "memory_at_2^v-1": _memory_at_the_end,
    "negative_immediates": _negative_immediates,
    "store_and_load_last": _store_and_load_last,
}


def raw_columns(n_real: int, seed: int) -> dict:
    """Seeded raw columns of ``n_real`` steps, the edge values first."""
    rng = np.random.default_rng(seed)

    def u64():
        col = rng.integers(0, 1 << 64, size=n_real, dtype=np.uint64)
        col[: len(EDGE_U64)] = np.array(EDGE_U64, dtype=np.uint64)[:n_real]
        return col

    cols = {key: u64() for key in ("pc", "reg_write_val", "mem_addr", "mem_val")}
    if n_real:
        cols["pc"][-1] = (1 << 64) - 3  # the padding's pc: 2^63 and more, and p or more in every field
    imm = rng.integers(-(1 << 31), 1 << 31, size=n_real, dtype=np.int64)
    imm[:6] = np.array([0, -1, -5, -2048, -(1 << 31), (1 << 31) - 1], dtype=np.int64)[:n_real]
    cols["imm"] = imm
    for key in ("opcode", "rd", "rs1", "rs2", "funct3", "funct7"):
        col = rng.integers(0, 256, size=n_real, dtype=np.uint8)
        col[:3] = np.array([0, 16, 255], dtype=np.uint8)[:n_real]
        cols[key] = col
    cols["reg_write_idx"] = rng.integers(0, 32, size=n_real, dtype=np.uint8)
    flag = rng.integers(0, 3, size=n_real, dtype=np.uint8)
    if n_real >= 2:
        flag[-2:] = [2, 1]  # a store, then a load, last
    cols["mem_flag"] = flag
    return cols
