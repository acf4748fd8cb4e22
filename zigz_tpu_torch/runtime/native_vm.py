"""ctypes wrapper for the native RV64IM interpreter (vm.cpp).

Exposes ``NativeVM.run_program(...)`` returning a :class:`NativeTrace` —
a columnar, numpy-backed stand-in for zigz_tpu.vm.trace.ExecutionTrace that
the witness generator and prover consume through fast paths.  Equivalence
with the Python VM (same trace columns, same final state, same proof
bytes) is enforced by tests/test_native_vm.py.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional

import numpy as np

from ..isa.instruction_table import InstructionTables
from ..isa.rv64i import Instruction, InvalidInstruction
from ..vm.state import UnimplementedInstruction, UnimplementedSYSTEM, VMError
from ..vm.trace import AccessType, MemoryAccess

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "vm.cpp")
_LIB = os.path.join(_HERE, "libzigz_vm.so")

STATUS_OK = 0
STATUS_HALTED = 1
STATUS_INVALID = 2
STATUS_UNIMPLEMENTED = 3
STATUS_UNIMPL_SYSTEM = 4
STATUS_INVALID_VARIANT = 5

# LookupId enum (vm.cpp) -> table metadata objects.
_LOOKUP_TABLES = [
    InstructionTables.ADD, InstructionTables.SUB, InstructionTables.AND,
    InstructionTables.OR, InstructionTables.XOR, InstructionTables.SLL,
    InstructionTables.SRL, InstructionTables.SRA, InstructionTables.SLT,
    InstructionTables.SLTU, InstructionTables.BEQ, InstructionTables.LOAD,
    InstructionTables.STORE,
]

# Size enum used by vm.cpp matches vm.memory.LoadSize ordering.


class _TraceColumns(ctypes.Structure):
    _fields_ = [
        ("pc", ctypes.c_void_p),
        ("next_pc", ctypes.c_void_p),
        ("inst_word", ctypes.c_void_p),
        ("opcode", ctypes.c_void_p),
        ("rd", ctypes.c_void_p),
        ("rs1", ctypes.c_void_p),
        ("rs2", ctypes.c_void_p),
        ("funct3", ctypes.c_void_p),
        ("funct7", ctypes.c_void_p),
        ("imm", ctypes.c_void_p),
        ("reg_write_idx", ctypes.c_void_p),
        ("reg_write_val", ctypes.c_void_p),
        ("mem_flag", ctypes.c_void_p),
        ("mem_addr", ctypes.c_void_p),
        ("mem_val", ctypes.c_void_p),
        ("mem_size", ctypes.c_void_p),
        ("lookup_id", ctypes.c_void_p),
    ]


_lib = None


def _build() -> bool:
    try:
        if os.path.exists(_LIB) and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC):
            return True
        from . import _compile

        return _compile([], _SRC, _LIB)
    except Exception:
        return False


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not _build():
        return None
    try:
        lib = ctypes.CDLL(_LIB)
    except OSError:
        return None
    lib.zigz_vm_create.restype = ctypes.c_void_p
    lib.zigz_vm_run.restype = ctypes.c_uint64
    lib.zigz_vm_run.argtypes = [
        ctypes.c_void_p,
        ctypes.c_uint64,
        ctypes.POINTER(_TraceColumns),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.zigz_vm_get_pc.restype = ctypes.c_uint64
    lib.zigz_vm_get_reg.restype = ctypes.c_uint64
    lib.zigz_vm_output_len.restype = ctypes.c_size_t
    lib.zigz_vm_input_pos.restype = ctypes.c_size_t
    lib.zigz_vm_load_byte.restype = ctypes.c_uint8
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


class NativeTrace:
    """Columnar trace with the ExecutionTrace interface (duck-typed)."""

    def __init__(self, columns: dict, num_steps: int, initial_regs):
        self.columns = {k: v[:num_steps] for k, v in columns.items()}
        self.num_steps = num_steps
        self.initial_regs = list(initial_regs)
        self._regs_matrix_cache = None

    # -- fast accessors ----------------------------------------------------
    @property
    def pcs(self):
        return self.columns["pc"]

    @property
    def next_pcs(self):
        return self.columns["next_pc"]

    @property
    def lookup_ids(self):
        return self.columns["lookup_id"]

    def step_count(self) -> int:
        return self.num_steps

    def num_lookups(self) -> int:
        return int(np.count_nonzero(self.columns["lookup_id"] >= 0))

    # -- compatibility views ----------------------------------------------
    @property
    def instructions(self):
        c = self.columns
        return [
            Instruction(
                int(c["opcode"][i]), int(c["rd"][i]), int(c["funct3"][i]),
                int(c["rs1"][i]), int(c["rs2"][i]), int(c["funct7"][i]),
                int(c["imm"][i]),
            )
            for i in range(self.num_steps)
        ]

    @property
    def memory_accesses(self):
        c = self.columns
        out: List[Optional[MemoryAccess]] = []
        for i in range(self.num_steps):
            flag = c["mem_flag"][i]
            if flag == 0:
                out.append(None)
            else:
                out.append(
                    MemoryAccess(
                        AccessType.Load if flag == 1 else AccessType.Store,
                        int(c["mem_addr"][i]),
                        int(c["mem_val"][i]),
                        int(c["mem_size"][i]),
                    )
                )
        return out

    @property
    def lookup_tables(self):
        ids = self.columns["lookup_id"]
        return [(_LOOKUP_TABLES[i] if i >= 0 else None) for i in ids]

    @property
    def reg_writes(self):
        c = self.columns
        return list(zip(c["reg_write_idx"].tolist(), c["reg_write_val"].tolist()))

    def regs_matrix(self) -> np.ndarray:
        """(32, n) regs_after matrix via vectorized forward fill."""
        if self._regs_matrix_cache is not None:
            return self._regs_matrix_cache
        n = self.num_steps
        idx = self.columns["reg_write_idx"].astype(np.int64)
        vals = self.columns["reg_write_val"]
        mat = np.empty((32, n), dtype=np.uint64)
        arange = np.arange(n)
        for r in range(32):
            col = np.full(n, np.uint64(self.initial_regs[r]), dtype=np.uint64)
            if r != 0:
                mask = idx == r
                if mask.any():
                    fill = np.zeros(n, dtype=np.uint64)
                    fill[mask] = vals[mask]
                    seg = np.maximum.accumulate(np.where(mask, arange, -1))
                    has_prev = seg >= 0
                    col[has_prev] = fill[seg[has_prev]]
            mat[r] = col
        mat[0] = 0
        self._regs_matrix_cache = mat
        return mat

    def stats(self):
        from ..vm.trace import TraceStats

        insts = self.instructions
        counts: dict = {}
        for inst in insts:
            name = inst.name()
            counts[name] = counts.get(name, 0) + 1
        return TraceStats(
            total_steps=self.num_steps,
            total_memory_accesses=int(np.count_nonzero(self.columns["mem_flag"])),
            instruction_counts=counts,
        )


class NativeVM:
    """One-shot native execution producing a NativeTrace + final state."""

    def __init__(self):
        lib = _load()
        if lib is None:
            raise RuntimeError("native VM unavailable")
        self.lib = lib
        self.handle = lib.zigz_vm_create()
        self._input_arr = None
        self._output_arr = None

    def __del__(self):
        try:
            if getattr(self, "handle", None):
                self.lib.zigz_vm_destroy(ctypes.c_void_p(self.handle))
                self.handle = None
        except Exception:
            pass  # interpreter shutdown may have torn down ctypes already

    def load_segment(self, vaddr: int, data: bytes) -> None:
        buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
        self.lib.zigz_vm_load_segment(
            ctypes.c_void_p(self.handle), ctypes.c_uint64(vaddr), buf, ctypes.c_size_t(len(data))
        )

    def run(self, entry_pc: int, max_steps: int, initial_regs=None, input_tape=None):
        lib, h = self.lib, ctypes.c_void_p(self.handle)
        lib.zigz_vm_set_pc(h, ctypes.c_uint64(entry_pc))
        init_regs = [0] * 32
        if initial_regs is not None:
            for i, v in enumerate(initial_regs):
                if i < 32:
                    lib.zigz_vm_set_reg(h, i, ctypes.c_uint64(v))
                    if i != 0:
                        init_regs[i] = v & ((1 << 64) - 1)

        self._input_arr = np.ascontiguousarray(input_tape or [], dtype=np.uint64)
        lib.zigz_vm_set_input(
            h,
            self._input_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            ctypes.c_size_t(len(self._input_arr)),
        )
        self._output_arr = np.zeros(max(max_steps, 16), dtype=np.uint64)
        lib.zigz_vm_set_output_buffer(
            h,
            self._output_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            ctypes.c_size_t(len(self._output_arr)),
        )

        cols = {
            "pc": np.empty(max_steps, dtype=np.uint64),
            "next_pc": np.empty(max_steps, dtype=np.uint64),
            "inst_word": np.empty(max_steps, dtype=np.uint32),
            "opcode": np.empty(max_steps, dtype=np.uint8),
            "rd": np.empty(max_steps, dtype=np.uint8),
            "rs1": np.empty(max_steps, dtype=np.uint8),
            "rs2": np.empty(max_steps, dtype=np.uint8),
            "funct3": np.empty(max_steps, dtype=np.uint8),
            "funct7": np.empty(max_steps, dtype=np.uint8),
            "imm": np.empty(max_steps, dtype=np.int64),
            "reg_write_idx": np.empty(max_steps, dtype=np.uint8),
            "reg_write_val": np.empty(max_steps, dtype=np.uint64),
            "mem_flag": np.empty(max_steps, dtype=np.uint8),
            "mem_addr": np.empty(max_steps, dtype=np.uint64),
            "mem_val": np.empty(max_steps, dtype=np.uint64),
            "mem_size": np.empty(max_steps, dtype=np.uint8),
            "lookup_id": np.empty(max_steps, dtype=np.int8),
        }
        struct = _TraceColumns(
            **{name: arr.ctypes.data_as(ctypes.c_void_p) for name, arr in cols.items()}
        )
        status = ctypes.c_int32(0)
        num_steps = lib.zigz_vm_run(
            h, ctypes.c_uint64(max_steps), ctypes.byref(struct), ctypes.byref(status)
        )
        status = status.value

        trace = NativeTrace(cols, int(num_steps), init_regs)
        final_regs = np.empty(32, dtype=np.uint64)
        lib.zigz_vm_get_regs(h, final_regs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
        out_len = lib.zigz_vm_output_len(h)
        result = {
            "trace": trace,
            "status": status,
            "final_pc": int(lib.zigz_vm_get_pc(h)),
            "final_regs": final_regs.tolist(),
            "output_tape": self._output_arr[:out_len].tolist(),
            "halted": bool(lib.zigz_vm_is_halted(h)),
        }
        return result


def raise_for_status(status: int) -> None:
    """Map error statuses to the Python VM's exceptions (InvalidInstruction
    is NOT raised here — batch execution treats it as the clean halt the
    prover loop would produce)."""
    if status == STATUS_UNIMPLEMENTED:
        raise UnimplementedInstruction()
    if status == STATUS_UNIMPL_SYSTEM:
        raise UnimplementedSYSTEM()
    if status == STATUS_INVALID_VARIANT:
        raise VMError("InvalidVariant")
