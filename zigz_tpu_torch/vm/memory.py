"""Sparse byte-addressable memory.

Reference: zigz src/vm/memory.zig.  Semantics mirrored exactly:
unmapped bytes read 0 (:35-37); storing a zero byte deletes the entry to
keep storage sparse (:41-47); multi-byte accesses compose little-endian
bytes (:50-90); signed loads sign-extend from the access width (:93-112).

Implementation note: a Python dict keyed by address replaces the Zig
AutoHashMap; the semantics (not the layout) are the contract.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["Memory", "LoadSize", "MemoryStats"]

_M64 = (1 << 64) - 1


class LoadSize:
    Byte = 0
    Halfword = 1
    Word = 2
    Doubleword = 3

    NBYTES = {Byte: 1, Halfword: 2, Word: 4, Doubleword: 8}


@dataclass
class MemoryStats:
    allocated_bytes: int
    hash_map_capacity: int


class Memory:
    __slots__ = ("data",)

    def __init__(self):
        self.data = {}

    def load_byte(self, addr: int) -> int:
        return self.data.get(addr & _M64, 0)

    def store_byte(self, addr: int, value: int) -> None:
        addr &= _M64
        value &= 0xFF
        if value == 0:
            self.data.pop(addr, None)
        else:
            self.data[addr] = value

    def load_halfword(self, addr: int) -> int:
        g = self.data.get
        return g(addr & _M64, 0) | (g((addr + 1) & _M64, 0) << 8)

    def store_halfword(self, addr: int, value: int) -> None:
        self.store_byte(addr, value)
        self.store_byte(addr + 1, value >> 8)

    def load_word(self, addr: int) -> int:
        g = self.data.get
        return (
            g(addr & _M64, 0)
            | (g((addr + 1) & _M64, 0) << 8)
            | (g((addr + 2) & _M64, 0) << 16)
            | (g((addr + 3) & _M64, 0) << 24)
        )

    def store_word(self, addr: int, value: int) -> None:
        self.store_byte(addr, value)
        self.store_byte(addr + 1, value >> 8)
        self.store_byte(addr + 2, value >> 16)
        self.store_byte(addr + 3, value >> 24)

    def load_doubleword(self, addr: int) -> int:
        return self.load_word(addr) | (self.load_word(addr + 4) << 32)

    def store_doubleword(self, addr: int, value: int) -> None:
        self.store_word(addr, value)
        self.store_word(addr + 4, value >> 32)

    def load_sign_extended(self, addr: int, size: int) -> int:
        """Returns a signed Python int (memory.zig:93-112)."""
        if size == LoadSize.Byte:
            v = self.load_byte(addr)
            return v - 0x100 if v & 0x80 else v
        if size == LoadSize.Halfword:
            v = self.load_halfword(addr)
            return v - 0x10000 if v & 0x8000 else v
        if size == LoadSize.Word:
            v = self.load_word(addr)
            return v - 0x100000000 if v & 0x80000000 else v
        v = self.load_doubleword(addr)
        return v - (1 << 64) if v & (1 << 63) else v

    def load_zero_extended(self, addr: int, size: int) -> int:
        if size == LoadSize.Byte:
            return self.load_byte(addr)
        if size == LoadSize.Halfword:
            return self.load_halfword(addr)
        if size == LoadSize.Word:
            return self.load_word(addr)
        return self.load_doubleword(addr)

    def store(self, addr: int, value: int, size: int) -> None:
        if size == LoadSize.Byte:
            self.store_byte(addr, value)
        elif size == LoadSize.Halfword:
            self.store_halfword(addr, value)
        elif size == LoadSize.Word:
            self.store_word(addr, value)
        else:
            self.store_doubleword(addr, value)

    def load_program(self, start_addr: int, program: bytes) -> None:
        for i, byte in enumerate(program):
            self.store_byte(start_addr + i, byte)

    def stats(self) -> MemoryStats:
        return MemoryStats(allocated_bytes=len(self.data), hash_map_capacity=len(self.data))

    def snapshot(self) -> "Memory":
        copy = Memory()
        copy.data = dict(self.data)
        return copy
