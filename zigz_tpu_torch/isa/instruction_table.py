"""Instruction -> Lasso lookup-table metadata catalog.

Reference: zigz src/isa/instruction_table.zig.  Consensus
relevance: ``get_table_metadata`` decides which traced steps produce a
pipeline Lasso proof (prover.zig:302), so its opcode/funct3 coverage must
match exactly: OP, OP_IMM, LOAD, STORE, BRANCH map to tables; everything
else (incl. OP_32/OP_IMM_32/JAL/JALR/LUI/AUIPC/SYSTEM) maps to None.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from .rv64i import Instruction, Opcode

__all__ = [
    "DecompositionStrategy",
    "LookupTable",
    "InstructionTables",
    "get_table_metadata",
    "estimate_memory_usage",
]

_USIZE_MAX = (1 << 64) - 1


class DecompositionStrategy:
    Chunk16 = "Chunk16"
    Chunk8 = "Chunk8"
    Sparse = "Sparse"
    Procedural = "Procedural"


@dataclass(frozen=True)
class LookupTable:
    name: str
    num_inputs: int
    num_outputs: int
    input_widths: Tuple[int, ...]
    output_widths: Tuple[int, ...]
    table_size: int
    needs_decomposition: bool
    decomposition: Optional[str]

    @staticmethod
    def compute_size(input_widths) -> int:
        """instruction_table.zig:45-62 — usize-max sentinel at >= 64 bits."""
        total_bits = sum(input_widths)
        if total_bits >= 64:
            return _USIZE_MAX
        return 1 << total_bits

    @staticmethod
    def is_feasible(table_size: int) -> bool:
        """Threshold 2^24 entries (instruction_table.zig:66-68)."""
        return table_size <= (1 << 24)


def _tbl(name, inputs, outputs, strategy):
    return LookupTable(
        name=name,
        num_inputs=len(inputs),
        num_outputs=len(outputs),
        input_widths=tuple(inputs),
        output_widths=tuple(outputs),
        table_size=LookupTable.compute_size(inputs),
        needs_decomposition=True,
        decomposition=strategy,
    )


class InstructionTables:
    """instruction_table.zig:91-240."""

    ADD = _tbl("ADD", (32, 32), (32,), DecompositionStrategy.Chunk16)
    SUB = _tbl("SUB", (32, 32), (32,), DecompositionStrategy.Chunk16)
    AND = _tbl("AND", (32, 32), (32,), DecompositionStrategy.Chunk8)
    OR = _tbl("OR", (32, 32), (32,), DecompositionStrategy.Chunk8)
    XOR = _tbl("XOR", (32, 32), (32,), DecompositionStrategy.Chunk8)
    SLL = _tbl("SLL", (32, 5), (32,), DecompositionStrategy.Chunk16)
    SRL = _tbl("SRL", (32, 5), (32,), DecompositionStrategy.Chunk16)
    SRA = _tbl("SRA", (32, 5), (32,), DecompositionStrategy.Chunk16)
    SLT = _tbl("SLT", (32, 32), (1,), DecompositionStrategy.Chunk16)
    SLTU = _tbl("SLTU", (32, 32), (1,), DecompositionStrategy.Chunk16)
    BEQ = _tbl("BEQ", (32, 32), (1,), DecompositionStrategy.Chunk16)
    LOAD = _tbl("LOAD", (32, 32), (32,), DecompositionStrategy.Sparse)
    STORE = _tbl("STORE", (32, 32, 32), (32,), DecompositionStrategy.Sparse)


def get_table_metadata(inst: Instruction) -> Optional[LookupTable]:
    """instruction_table.zig:243-274."""
    T = InstructionTables
    op = inst.opcode
    if op == Opcode.OP:
        return {
            0b000: T.ADD if inst.funct7 == 0 else T.SUB,
            0b001: T.SLL,
            0b010: T.SLT,
            0b011: T.SLTU,
            0b100: T.XOR,
            0b101: T.SRL if inst.funct7 == 0 else T.SRA,
            0b110: T.OR,
            0b111: T.AND,
        }[inst.funct3]
    if op == Opcode.OP_IMM:
        return {
            0b000: T.ADD,
            0b001: T.SLL,
            0b010: T.SLT,
            0b011: T.SLTU,
            0b100: T.XOR,
            0b101: T.SRL if inst.funct7 == 0 else T.SRA,
            0b110: T.OR,
            0b111: T.AND,
        }[inst.funct3]
    if op == Opcode.LOAD:
        return T.LOAD
    if op == Opcode.STORE:
        return T.STORE
    if op == Opcode.BRANCH:
        return T.BEQ  # all branch variants share the BEQ table (ref :267-271)
    return None


def estimate_memory_usage(table: LookupTable, bytes_per_entry: int) -> int:
    """instruction_table.zig:277-302."""
    if not table.needs_decomposition:
        return table.table_size * bytes_per_entry
    if table.decomposition == DecompositionStrategy.Chunk16:
        return (1 << 32) * bytes_per_entry * 2
    if table.decomposition == DecompositionStrategy.Chunk8:
        return (1 << 16) * bytes_per_entry * 4
    if table.decomposition == DecompositionStrategy.Sparse:
        return (table.table_size // 100) * bytes_per_entry
    return 0  # Procedural
