"""Large-table decomposition into chunked subtables.

Reference: zigz src/lookups/table_decomposition.zig.  The
reference enumerates its ADD16-with-carry subtable naively (2^33 heap
entries, :86-128 — infeasible in practice); the device-first redesign makes
such subtables PROCEDURAL: a vectorized generator yields any index range of
the subtable's evaluations on demand, so device kernels can stream subtable
MLE chunks without materializing the table (strategy ``Procedural``,
instruction_table.zig:84-85).  Small subtables (XOR8) are materialized
columnar.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List

import numpy as np

from .table_builder import DenseTable

__all__ = [
    "DecompositionStrategy",
    "chunk_u32_16bit",
    "chunk_u32_8bit",
    "unchunk_u32_16bit",
    "unchunk_u32_8bit",
    "Subtable",
    "ProceduralSubtable",
    "build_xor8_subtable",
    "add16_carry_procedural",
    "DecomposedTable",
    "DecompositionAnalysis",
]


class DecompositionStrategy:
    Chunk16 = "Chunk16"
    Chunk8 = "Chunk8"
    Sparse = "Sparse"
    Procedural = "Procedural"


# -- chunk codecs (table_decomposition.zig:28-70) ---------------------------

def chunk_u32_16bit(value: int):
    return [value & 0xFFFF, (value >> 16) & 0xFFFF]


def chunk_u32_8bit(value: int):
    return [(value >> (8 * i)) & 0xFF for i in range(4)]


def unchunk_u32_16bit(chunks) -> int:
    return (chunks[0] | (chunks[1] << 16)) & 0xFFFFFFFF


def unchunk_u32_8bit(chunks) -> int:
    return sum((chunks[i] & 0xFF) << (8 * i) for i in range(4)) & 0xFFFFFFFF


# -- subtables ---------------------------------------------------------------

@dataclass
class Subtable:
    name: str
    chunk_bits: int
    entries: DenseTable


@dataclass
class ProceduralSubtable:
    """A subtable defined by its generator instead of storage.

    ``eval_range(lo, hi)`` returns (inputs (n, k), outputs (n, m)) uint64
    arrays for entry indices [lo, hi) in the reference's enumeration order —
    bit-exact with what the naive materialization would contain.
    """

    name: str
    chunk_bits: int
    size: int
    num_inputs: int
    num_outputs: int
    eval_range: Callable[[int, int], tuple]

    def materialize(self, F, limit: int = 1 << 22) -> DenseTable:
        if self.size > limit:
            raise MemoryError(f"{self.name}: {self.size} entries > limit {limit}")
        inputs, outputs = self.eval_range(0, self.size)
        p = np.uint64(F.MODULUS)
        return DenseTable(F, inputs % p, outputs % p)


def build_xor8_subtable(F) -> Subtable:
    """(a, b) -> a^b over 8-bit chunks, 2^16 entries, materialized
    (table_decomposition.zig:130-164)."""
    n = 256
    a = np.repeat(np.arange(n, dtype=np.uint64), n)
    b = np.tile(np.arange(n, dtype=np.uint64), n)
    out = a ^ b
    p = np.uint64(F.MODULUS)
    return Subtable(
        name="XOR8",
        chunk_bits=8,
        entries=DenseTable(F, np.stack([a, b], axis=1) % p, (out % p)[:, None]),
    )


def add16_carry_procedural() -> ProceduralSubtable:
    """(a16, b16, cin) -> (sum16, cout): the reference's 2^33-entry subtable
    (table_decomposition.zig:86-127), as a procedural generator in its exact
    enumeration order (a outer, b middle, carry inner)."""

    size = (1 << 16) * (1 << 16) * 2

    def eval_range(lo: int, hi: int):
        idx = np.arange(lo, hi, dtype=np.uint64)
        carry_in = idx & np.uint64(1)
        b = (idx >> np.uint64(1)) & np.uint64(0xFFFF)
        a = idx >> np.uint64(17)
        total = a + b + carry_in
        sum_chunk = total & np.uint64(0xFFFF)
        carry_out = (total >> np.uint64(16)) & np.uint64(1)
        inputs = np.stack([a, b, carry_in], axis=1)
        outputs = np.stack([sum_chunk, carry_out], axis=1)
        return inputs, outputs

    return ProceduralSubtable(
        name="ADD16_CARRY",
        chunk_bits=16,
        size=size,
        num_inputs=3,
        num_outputs=2,
        eval_range=eval_range,
    )


@dataclass
class DecomposedTable:
    """table_decomposition.zig:169-227."""

    operation: str
    strategy: str
    subtables: List[object]

    @staticmethod
    def create_add32_chunk16() -> "DecomposedTable":
        return DecomposedTable(
            operation="ADD32",
            strategy=DecompositionStrategy.Chunk16,
            subtables=[add16_carry_procedural()],
        )

    @staticmethod
    def create_xor32_chunk8(F) -> "DecomposedTable":
        return DecomposedTable(
            operation="XOR32",
            strategy=DecompositionStrategy.Chunk8,
            subtables=[build_xor8_subtable(F)],
        )

    def memory_usage(self, field_bytes: int = 8) -> int:
        total = 0
        for sub in self.subtables:
            if isinstance(sub, ProceduralSubtable):
                continue  # procedural: zero storage
            t = sub.entries
            total += len(t) * (t.num_inputs + t.num_outputs) * field_bytes
        return total


@dataclass
class DecompositionAnalysis:
    """table_decomposition.zig:230-... size math."""

    original_size: int
    decomposed_size: int
    num_subtables: int
    space_savings_factor: float

    @staticmethod
    def analyze(original_bits: int, strategy: str) -> "DecompositionAnalysis":
        original_size = (1 << original_bits) * (1 << original_bits)
        if strategy == DecompositionStrategy.Chunk16:
            decomposed = 1 << 33
            n = 1
        elif strategy == DecompositionStrategy.Chunk8:
            decomposed = 1 << 16
            n = 4
        elif strategy == DecompositionStrategy.Procedural:
            decomposed = 0
            n = 1
        else:  # Sparse
            decomposed = original_size // 100
            n = 1
        return DecompositionAnalysis(
            original_size=original_size,
            decomposed_size=decomposed,
            num_subtables=n,
            space_savings_factor=(original_size / decomposed) if decomposed else float("inf"),
        )
