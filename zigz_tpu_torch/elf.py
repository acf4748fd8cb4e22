"""Minimal ELF parser: entry point + PT_LOAD segments (LE, ELF32/ELF64).

Reference: zigz src/elf.zig.  ``p_memsz > p_filesz`` (BSS) is
intentionally ignored, matching the reference (elf.zig:75,98) — harmless
because unmapped VM memory reads zero (vm/memory.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

__all__ = ["PT_LOAD", "Segment", "LoadResult", "ElfError", "is_elf", "load"]

PT_LOAD = 1


class ElfError(Exception):
    pass


@dataclass
class Segment:
    vaddr: int
    data: bytes


@dataclass
class LoadResult:
    entry_pc: int
    segments: List[Segment]


def is_elf(data: bytes) -> bool:
    return len(data) >= 4 and data[0] == 0x7F and data[1:4] == b"ELF"


def _u16(data: bytes, off: int) -> int:
    return int.from_bytes(data[off : off + 2], "little")


def _u32(data: bytes, off: int) -> int:
    return int.from_bytes(data[off : off + 4], "little")


def _u64(data: bytes, off: int) -> int:
    return int.from_bytes(data[off : off + 8], "little")


def load(data: bytes) -> LoadResult:
    """elf.zig:45-116."""
    if not is_elf(data) or len(data) < 64:
        raise ElfError("NotElf")

    elf_class = data[4]  # 1 = 32-bit, 2 = 64-bit
    data_enc = data[5]  # 1 = LE
    if data_enc != 1:
        raise ElfError("UnsupportedData")

    segments: List[Segment] = []

    if elf_class == 2:
        entry_pc = _u64(data, 0x18)
        e_phoff = _u64(data, 0x20)
        e_phentsize = _u16(data, 0x36)
        e_phnum = _u16(data, 0x38)
        if e_phentsize != 56:
            raise ElfError("InvalidPhdr")
        for i in range(e_phnum):
            phoff = e_phoff + e_phentsize * i
            if phoff + 56 > len(data):
                raise ElfError("InvalidPhdr")
            if _u32(data, phoff) != PT_LOAD:
                continue
            p_offset = _u64(data, phoff + 8)
            p_vaddr = _u64(data, phoff + 16)
            p_filesz = _u64(data, phoff + 32)
            if p_offset > len(data) or p_offset + p_filesz > len(data):
                raise ElfError("InvalidPhdr")
            segments.append(Segment(vaddr=p_vaddr, data=data[p_offset : p_offset + p_filesz]))
    elif elf_class == 1:
        if len(data) < 0x30:
            raise ElfError("InvalidPhdr")
        entry_pc = _u32(data, 0x18)
        e_phoff = _u32(data, 0x1C)
        e_phentsize = _u16(data, 0x2A)
        e_phnum = _u16(data, 0x2C)
        if e_phentsize != 32:
            raise ElfError("InvalidPhdr")
        for i in range(e_phnum):
            phoff = e_phoff + e_phentsize * i
            if phoff + 32 > len(data):
                raise ElfError("InvalidPhdr")
            if _u32(data, phoff) != PT_LOAD:
                continue
            p_offset = _u32(data, phoff + 4)
            p_vaddr = _u32(data, phoff + 8)
            p_filesz = _u32(data, phoff + 16)
            if p_offset > len(data) or p_offset + p_filesz > len(data):
                raise ElfError("InvalidPhdr")
            segments.append(Segment(vaddr=p_vaddr, data=data[p_offset : p_offset + p_filesz]))
    else:
        raise ElfError("UnsupportedClass")

    if not segments:
        raise ElfError("NoLoadSegments")

    return LoadResult(entry_pc=entry_pc, segments=segments)
