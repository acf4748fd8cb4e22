"""Constraint system: metadata-level arithmetic constraints + per-step lookups.

Reference: zigz src/constraints/builder.zig.  The reference's
arithmetic constraints are name/description records with TODO bodies
(builder.zig:77-149) — replicated as such for capability parity (the real
polynomial constraint system is the v2 protocol; see
zigz_tpu/proofs/constraint_sumcheck.py).  What IS consensus-critical here is
``extract_lookup_constraints``: one LookupConstraint per traced step whose
instruction has table metadata (builder.zig:253-267) — that list drives the
pipeline's per-lookup "LASSO_TABLE" transcript bindings (prover.zig:302-312).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from ..vm.trace import ExecutionTrace

__all__ = [
    "ConstraintType",
    "Constraint",
    "ConstraintBuilder",
    "LookupConstraint",
    "ConstraintSystem",
    "ConstraintStats",
    "SystemStats",
]


class ConstraintType:
    Arithmetic = "Arithmetic"
    Lookup = "Lookup"


@dataclass
class Constraint:
    name: str
    constraint_type: str
    description: str


@dataclass
class ConstraintStats:
    total: int
    arithmetic: int
    lookup: int


@dataclass
class SystemStats:
    total_constraints: int
    arithmetic_constraints: int
    lookup_constraints: int


@dataclass
class LookupConstraint:
    table_name: str
    step_num: int
    pc: int


class ConstraintBuilder:
    def __init__(self):
        self.constraints: List[Constraint] = []

    def add_constraint(self, c: Constraint) -> None:
        self.constraints.append(c)

    def build_all(self, F, witness) -> None:
        """builder.zig:51-67 — four named arithmetic constraints."""
        self.add_constraint(Constraint(
            "PC_progression", ConstraintType.Arithmetic,
            "PC increments by 4 or jumps to branch target"))
        self.add_constraint(Constraint(
            "x0_zero", ConstraintType.Arithmetic,
            "Register x0 is hardwired to zero"))
        self.add_constraint(Constraint(
            "register_updates", ConstraintType.Arithmetic,
            "Registers update correctly based on instruction writes"))
        self.add_constraint(Constraint(
            "memory_consistency", ConstraintType.Arithmetic,
            "Memory reads return last written value"))

    def stats(self) -> ConstraintStats:
        arith = sum(1 for c in self.constraints if c.constraint_type == ConstraintType.Arithmetic)
        lookup = len(self.constraints) - arith
        return ConstraintStats(total=len(self.constraints), arithmetic=arith, lookup=lookup)


class ConstraintSystem:
    def __init__(self):
        self.builder = ConstraintBuilder()
        self.lookup_tables: List[LookupConstraint] = []

    def build(self, F, witness, trace: ExecutionTrace) -> None:
        self.builder.build_all(F, witness)
        self._extract_lookup_constraints(trace)

    def _extract_lookup_constraints(self, trace: ExecutionTrace) -> None:
        """builder.zig:253-267 — one record per step with table metadata."""
        for i, table in enumerate(trace.lookup_tables):
            if table is not None:
                self.lookup_tables.append(
                    LookupConstraint(table_name=table.name, step_num=i, pc=trace.pcs[i])
                )

    def constraint_count(self) -> int:
        return len(self.builder.constraints) + len(self.lookup_tables)

    def stats(self) -> SystemStats:
        b = self.builder.stats()
        return SystemStats(
            total_constraints=self.constraint_count(),
            arithmetic_constraints=b.arithmetic,
            lookup_constraints=len(self.lookup_tables),
        )
