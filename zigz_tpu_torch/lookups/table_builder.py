"""Lookup table construction (Lasso inputs).

Reference: zigz src/lookups/table_builder.zig.  Tables are stored
columnar (numpy uint64 matrices) instead of per-entry heap objects — the
semantics (entry order, lookup-by-scan, sparse key scheme) match the
reference exactly while staying vectorization-friendly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

__all__ = [
    "TableEntry",
    "DenseTable",
    "SparseTable",
    "build_add_table",
    "build_xor_table",
    "build_and_table",
    "build_sparse_conditional_table",
]


@dataclass
class TableEntry:
    inputs: list
    outputs: list


class DenseTable:
    """Columnar dense table: inputs (n, num_inputs), outputs (n, num_outputs)."""

    def __init__(self, F, inputs: np.ndarray, outputs: np.ndarray):
        self.F = F
        self.inputs = np.asarray(inputs, dtype=np.uint64)
        self.outputs = np.asarray(outputs, dtype=np.uint64)
        self.num_inputs = self.inputs.shape[1]
        self.num_outputs = self.outputs.shape[1]

    def __len__(self):
        return self.inputs.shape[0]

    def entry(self, i: int) -> TableEntry:
        F = self.F
        return TableEntry(
            inputs=[F.from_reduced(int(v)) for v in self.inputs[i]],
            outputs=[F.from_reduced(int(v)) for v in self.outputs[i]],
        )

    def lookup(self, inputs) -> Optional[list]:
        """Linear-scan lookup (table_builder.zig:65-82)."""
        vals = np.array([x.value if hasattr(x, "value") else int(x) for x in inputs], dtype=np.uint64)
        if len(vals) != self.num_inputs:
            return None
        matches = np.all(self.inputs == vals[None, :], axis=1)
        idx = np.flatnonzero(matches)
        if len(idx) == 0:
            return None
        return [self.F.from_reduced(int(v)) for v in self.outputs[idx[0]]]


class SparseTable:
    """u64-keyed sparse table (table_builder.zig:87-123)."""

    def __init__(self, F, num_inputs: int, num_outputs: int):
        self.F = F
        self.num_inputs = num_inputs
        self.num_outputs = num_outputs
        self.map = {}

    def insert(self, key: int, entry: TableEntry) -> None:
        self.map[key] = entry

    def lookup(self, key: int) -> Optional[TableEntry]:
        return self.map.get(key)


def _grid(F, bits: int):
    max_val = 1 << bits
    a = np.repeat(np.arange(max_val, dtype=np.uint64), max_val)
    b = np.tile(np.arange(max_val, dtype=np.uint64), max_val)
    return a, b


def build_add_table(F, bits: int) -> DenseTable:
    """(a, b) -> (a + b) mod 2^bits, row-major over a then b
    (table_builder.zig:126-153)."""
    a, b = _grid(F, bits)
    out = (a + b) % np.uint64(1 << bits)
    p = np.uint64(F.MODULUS)
    return DenseTable(F, np.stack([a % p, b % p], axis=1), (out % p)[:, None])


def build_xor_table(F, bits: int) -> DenseTable:
    a, b = _grid(F, bits)
    out = a ^ b
    p = np.uint64(F.MODULUS)
    return DenseTable(F, np.stack([a % p, b % p], axis=1), (out % p)[:, None])


def build_and_table(F, bits: int) -> DenseTable:
    a, b = _grid(F, bits)
    out = a & b
    p = np.uint64(F.MODULUS)
    return DenseTable(F, np.stack([a % p, b % p], axis=1), (out % p)[:, None])


def build_sparse_conditional_table(F) -> SparseTable:
    """BEQ-taken entries (a, a) -> 1, keyed (a<<8)|a
    (table_builder.zig:216-239)."""
    table = SparseTable(F, 2, 1)
    for a in range(256):
        key = (a << 8) | a
        table.insert(
            key,
            TableEntry(inputs=[F(a), F(a)], outputs=[F(1)]),
        )
    return table
