"""The wide-value guest: a v1 program whose witness rows hold values of p
and above and of 2^63 and above in every field of the port.

Built with the port's assembler (``zigz_tpu_torch.guest.asm``).  For each
value v of ``WIDE_VALUES`` (-1, 2^63, 2^63 - 1, and p - 1, p and p + 1 of
the six fields) it loads v into a register (``li``), stores it at the
address v rounded down to 8 and loads it back (``sd``, ``ld``, ``lw``),
and adds a negative immediate (``addi -2048``) whose result it stores below
that address (a negative store offset): the register, imm, memory-address
and memory-value rows all carry such values.  ``program()`` is the raw code
at 0x1000; scripts/torch_reference_digests.py pins it as the case
``v1-<field>-wide-values`` with its bytes in the entry, which chip_smoke.py
proves from the pin alone.
"""

from zigz_tpu_torch.core import field
from zigz_tpu_torch.guest.asm import Assembler

FIELDS = ("BabyBear", "KoalaBear", "Mersenne31", "F17", "Goldilocks", "Mersenne61")
_M64 = (1 << 64) - 1
WIDE_VALUES = [_M64, 1 << 63, (1 << 63) - 1] + [
    (getattr(field, name).MODULUS + d) & _M64 for name in FIELDS for d in (-1, 0, 1)]
ENTRY = 0x1000


def program() -> bytes:
    a = Assembler(ENTRY)
    for i, v in enumerate(WIDE_VALUES):
        value, addr, low = ("s2", "s3", "s4") if i % 2 else ("t0", "t1", "t2")
        a.li(value, v)
        a.li(addr, v & ~7)
        a.sd(value, addr, 0)
        a.ld("a0", addr, 0)
        a.lw("a1", addr, 0)  # sign-extended: -1 or a value above 2^63 for half of them
        a.addi(low, value, -2048)
        a.sd(low, addr, -8)
        a.ld("a2", addr, -8)
    a.ebreak()
    return a.assemble()
