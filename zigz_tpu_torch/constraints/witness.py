"""Trace -> 43 multilinear witness polynomials (consensus-critical).

Reference: zigz src/constraints/witness.zig.  Exact rules:

* ``num_vars = ceil(log2(num_steps))`` with ``log2_int_ceil(1) == 0``
  (witness.zig:38-41, Zig std.math semantics);
* PC and the 32 register polynomials pad with their LAST value
  (witness.zig:79-91, :113-123); instruction and memory polynomials pad
  with ZERO (:173-182, :248-253);
* every raw u64 machine word maps through ``F.init`` (reduce mod p); the
  immediate is the two's-complement bitcast of the signed i64
  (``@bitCast`` at witness.zig:170);
* ``is_read`` is 1 for loads, 0 for stores and non-memory steps (:239-245).

The generator is fully vectorized over the columnar trace; output is a
(43, 2^v) canonical uint64 matrix plus Multilinear views, in the exact
commitment order used by the prover (prover.zig:376-390):
index 0 = pc, 1..32 = x0..x31, 33..39 = opcode/rd/rs1/rs2/funct3/funct7/imm,
40..42 = mem addr/value/is_read.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from ..poly.multilinear import Multilinear
from ..vm.trace import AccessType, ExecutionTrace

__all__ = ["Witness", "WitnessGenerator", "WITNESS_POLY_NAMES", "num_vars_for_steps"]

_M64 = (1 << 64) - 1

WITNESS_POLY_NAMES = (
    ["pc"]
    + [f"x{i}" for i in range(32)]
    + ["opcode", "rd", "rs1", "rs2", "funct3", "funct7", "imm", "mem_addr", "mem_value", "mem_is_read"]
)


def num_vars_for_steps(num_steps: int) -> int:
    """Zig std.math.log2_int_ceil: 0 for 1, ceil(log2(n)) otherwise."""
    if num_steps == 0:
        return 0
    if num_steps == 1:
        return 0
    return (num_steps - 1).bit_length()


@dataclass
class Witness:
    num_vars: int
    num_steps: int
    F: type
    matrix: np.ndarray  # (43, 2^v) canonical uint64

    # -- structured accessors (match the reference layout) ----------------
    @property
    def pc(self) -> Multilinear:
        return Multilinear.from_canonical_array(self.F, self.matrix[0])

    def register(self, i: int) -> Multilinear:
        return Multilinear.from_canonical_array(self.F, self.matrix[1 + i])

    @property
    def registers(self) -> List[Multilinear]:
        return [self.register(i) for i in range(32)]

    def instruction_poly(self, name: str) -> Multilinear:
        idx = {"opcode": 33, "rd": 34, "rs1": 35, "rs2": 36, "funct3": 37, "funct7": 38, "imm": 39}[name]
        return Multilinear.from_canonical_array(self.F, self.matrix[idx])

    def memory_poly(self, name: str) -> Multilinear:
        idx = {"address": 40, "value": 41, "is_read": 42}[name]
        return Multilinear.from_canonical_array(self.F, self.matrix[idx])

    def polynomials(self) -> List[Multilinear]:
        """All 43 MLEs in commitment order (prover.zig:376-390)."""
        return [Multilinear.from_canonical_array(self.F, row) for row in self.matrix]

    def size(self) -> int:
        return (1 << self.num_vars) * 43


class WitnessGenerator:
    @staticmethod
    def generate(F, trace: ExecutionTrace) -> Witness:
        num_steps = trace.step_count()
        num_vars = num_vars_for_steps(num_steps)
        padded = 1 << num_vars
        p = np.uint64(F.MODULUS)

        matrix = np.zeros((43, padded), dtype=np.uint64)
        if num_steps == 0:
            return Witness(num_vars=0, num_steps=0, F=F, matrix=matrix)

        n = num_steps
        native_cols = getattr(trace, "columns", None)

        # PC — pad with last value (witness.zig:79-91).
        pcs = (
            native_cols["pc"]
            if native_cols is not None
            else np.fromiter(trace.pcs, dtype=np.uint64, count=n)
        )
        matrix[0, :n] = pcs % p
        matrix[0, n:] = matrix[0, n - 1]

        # Registers — regs_after per step, pad with last (witness.zig:105-127).
        regs = trace.regs_matrix()  # (32, n) uint64
        reduced = regs % p
        matrix[1:33, :n] = reduced
        if padded > n:
            matrix[1:33, n:] = reduced[:, n - 1 : n]

        # Instruction fields — pad with zero (witness.zig:162-182).
        if native_cols is not None:
            opc = native_cols["opcode"].astype(np.uint64)
            f3 = native_cols["funct3"].astype(np.uint64)
            f7 = native_cols["funct7"].astype(np.uint64)
            rd = native_cols["rd"].astype(np.uint64)
            rs1 = native_cols["rs1"].astype(np.uint64)
            rs2 = native_cols["rs2"].astype(np.uint64)
            imm = native_cols["imm"].astype(np.uint64)  # two's-complement bitcast
        else:
            insts = trace.instructions
            opc = np.fromiter((i.opcode for i in insts), dtype=np.uint64, count=n)
            f3 = np.fromiter((i.funct3 for i in insts), dtype=np.uint64, count=n)
            f7 = np.fromiter((i.funct7 for i in insts), dtype=np.uint64, count=n)
            rd = np.fromiter((i.rd for i in insts), dtype=np.uint64, count=n)
            rs1 = np.fromiter((i.rs1 for i in insts), dtype=np.uint64, count=n)
            rs2 = np.fromiter((i.rs2 for i in insts), dtype=np.uint64, count=n)
            imm = np.fromiter((i.imm & _M64 for i in insts), dtype=np.uint64, count=n)
        matrix[33, :n] = opc % p
        matrix[34, :n] = rd % p
        matrix[35, :n] = rs1 % p
        matrix[36, :n] = rs2 % p
        matrix[37, :n] = f3 % p
        matrix[38, :n] = f7 % p
        matrix[39, :n] = imm % p

        # Memory access columns — pad with zero (witness.zig:235-253).
        if native_cols is not None:
            flag = native_cols["mem_flag"]
            has = flag != 0
            addr = np.where(has, native_cols["mem_addr"], np.uint64(0))
            val = np.where(has, native_cols["mem_val"], np.uint64(0))
            is_read = (flag == 1).astype(np.uint64)
        else:
            accesses = trace.memory_accesses
            addr = np.zeros(n, dtype=np.uint64)
            val = np.zeros(n, dtype=np.uint64)
            is_read = np.zeros(n, dtype=np.uint64)
            for i, acc in enumerate(accesses):
                if acc is not None:
                    addr[i] = acc.address
                    val[i] = acc.value
                    is_read[i] = 1 if acc.access_type == AccessType.Load else 0
        matrix[40, :n] = addr % p
        matrix[41, :n] = val % p
        matrix[42, :n] = is_read  # already 0/1 < p

        return Witness(num_vars=num_vars, num_steps=num_steps, F=F, matrix=matrix)
