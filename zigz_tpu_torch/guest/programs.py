"""Prebuilt guest programs (the examples' guest side).

``fibonacci_guest()`` mirrors the reference's fibonacci_guest
(examples/fibonacci_guest/src/main.zig:16-35): read n from the input tape,
iterate fib, commit fib(n) and fib(n+1), halt — the SP1-style guest/host
flow (docs/SP1_COMPARISON.md).
"""

from __future__ import annotations

from .asm import Assembler

__all__ = [
    "fibonacci_guest", "mul_stress_guest", "echo_guest", "nop_guest",
    "sort_guest",
]


def fibonacci_guest(base: int = 0x1000) -> bytes:
    """ELF64 guest: n = io.read(); a,b = 0,1; loop n times: a,b = b,a+b;
    io.commit(a); io.commit(b); ebreak."""
    a = Assembler(base)
    a.io_read("t0")          # t0 = n
    a.li("t1", 0)            # t1 = a = fib(0)
    a.li("t2", 1)            # t2 = b = fib(1)
    a.label("loop")
    a.beq("t0", "zero", "done")
    a.add("t3", "t1", "t2")  # t3 = a + b
    a.mv("t1", "t2")         # a = b
    a.mv("t2", "t3")         # b = a + b
    a.addi("t0", "t0", -1)
    a.j("loop")
    a.label("done")
    a.io_commit("t1")        # fib(n)
    a.io_commit("t2")        # fib(n+1)
    a.ebreak()
    return a.to_elf()


def mul_stress_guest(base: int = 0x1000) -> bytes:
    """RV64M-heavy guest (BASELINE.md config 4): n = io.read();
    accumulate mul/div/rem chains n times; commit the accumulator."""
    a = Assembler(base)
    a.io_read("t0")          # n iterations
    a.li("t1", 0x12345)      # x
    a.li("t2", 0x6789B)      # y
    a.li("t3", 0)            # acc
    a.label("loop")
    a.beq("t0", "zero", "done")
    a.mul("t4", "t1", "t2")
    a.mulhu("t5", "t1", "t2")
    a.xor("t4", "t4", "t5")
    a.li("t5", 1000003)
    a.remu("t4", "t4", "t5")
    a.div("t6", "t4", "t5")
    a.add("t3", "t3", "t4")
    a.add("t1", "t1", "t4")
    a.addi("t0", "t0", -1)
    a.j("loop")
    a.label("done")
    a.io_commit("t3")
    a.ebreak()
    return a.to_elf()


def echo_guest(count: int, base: int = 0x1000) -> bytes:
    """Reads `count` words and commits each back (I/O tape test)."""
    a = Assembler(base)
    for _ in range(count):
        a.io_read("t0")
        a.io_commit("t0")
    a.ebreak()
    return a.to_elf()


def sort_guest(base: int = 0x1000) -> bytes:
    """Insertion-sort guest exercising the SDK's procedures and loops:
    n = io.read(); read n words into memory; call sort; commit the
    sorted values.  Stresses LOAD/STORE (the byte-level memory check),
    data-dependent branches, call/ret, and the counted-loop idiom."""
    a = Assembler(base)
    buf = 0x100000          # data region, away from code
    a.li("sp", 0x200000)    # downward stack for call frames
    a.li("s0", buf)
    a.io_read("s1")         # s1 = n
    # read loop: buf[i] = io.read()
    with a.for_range("s2", "s1"):
        a.slli("t0", "s2", 3)
        a.add("t0", "t0", "s0")
        a.io_read("t1")
        a.sd("t1", "t0", 0)
    a.call("sort")
    # commit loop
    with a.for_range("s2", "s1"):
        a.slli("t0", "s2", 3)
        a.add("t0", "t0", "s0")
        a.ld("t1", "t0", 0)
        a.io_commit("t1")
    a.ebreak()

    # sort(s0=base, s1=n): insertion sort, clobbers t*, preserves s*.
    a.label("sort")
    a.push("ra")
    with a.for_range("t2", "s1", bound_reg="t3"):  # i = 0..n-1
        # key = buf[i]; j = i-1; while j >= 0 and buf[j] > key: shift
        a.slli("t0", "t2", 3)
        a.add("t0", "t0", "s0")
        a.ld("t4", "t0", 0)            # t4 = key
        a.mv("t5", "t2")               # t5 = j+1
        a.label("shift")
        a.beq("t5", "zero", "place")
        a.addi("t5", "t5", -1)
        a.slli("t0", "t5", 3)
        a.add("t0", "t0", "s0")
        a.ld("t1", "t0", 0)            # t1 = buf[j]
        a.bgeu("t4", "t1", "undo")     # key >= buf[j]: stop (stable)
        a.sd("t1", "t0", 8)            # buf[j+1] = buf[j]
        a.j("shift")
        a.label("undo")
        a.addi("t5", "t5", 1)
        a.label("place")
        a.slli("t0", "t5", 3)
        a.add("t0", "t0", "s0")
        a.sd("t4", "t0", 0)            # buf[j+1] = key
    a.pop("ra")
    a.ret()
    return a.to_elf()


def nop_guest(num_instructions: int, base: int = 0x1000) -> bytes:
    """num_instructions NOPs then EBREAK, as an ELF."""
    a = Assembler(base)
    for _ in range(num_instructions):
        a.nop()
    a.ebreak()
    return a.to_elf()
