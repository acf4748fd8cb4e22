"""CUDA C++ source of Z1, the zerocheck round-sum kernel, for one DAG program.

Counterpart of what XLA does for the JAX package: zigz_tpu keeps jit caches
keyed by (DAG signature, layout, degree, width), and XLA compiles each entry
at first use.  Here ``generate`` writes a program (ops/symtrace.py
``DagProgram``) as the body of one kernel, and ops/_build.py compiles it
with nvcc into a library of its own.  The hand-written parts of the kernel
(point formation, the reduction epilogue, the launcher's checks, the CPU
tests' entry) are csrc/dag_round.cuh; the source emitted here is the
program's body and the definitions that header reads.

The body is straight-line SSA: each instruction becomes
``const auto vN = mul(vA, c[K]);`` over earlier values, so there are no
slots and the compiler allocates registers.  A plane row becomes a value,
read where the program (or a segment) first uses it and reused by every
later instruction that reads it.  Constants stay runtime inputs (``c[K]``,
this prove's table), so the source depends only on the program, and
structurally equal programs give one source and one library.

The body is cut into ``__noinline__`` functions of ``SEGMENT``
instructions each: ptxas is far worse than linear in the size of one
function (a whole body of 11,738 instructions did not build in 24 minutes
on an H100's host; cut every 250 it builds in under a minute, and runs
faster: PERF.md, PR 9).  The values live across a cut pass through a
per-thread array indexed by the program's own slots (a slot is reused only
after its value's last use, so no cut overwrites a value still to be
read).

Host Python: imports neither torch, JAX nor anything of the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .symtrace import KIND_CONST, KIND_ROW, KIND_SLOT, OP_ADD, OP_MUL, OP_SUB, DagProgram

__all__ = ["MAX_CONSTS", "SEGMENT", "generate"]

# A launch's parameters may hold 32,764 bytes (CUDA 12.1 and later on
# Volta and later); the constant table takes all but a few dozen of them.
MAX_CONSTS = 8000
# Instructions a segment of the body.
SEGMENT = 250
_OPNAME = {OP_ADD: "add", OP_SUB: "sub", OP_MUL: "mul"}


def _operand(opd: int):
    return opd & 3, opd >> 2


def generate(program: DagProgram, segment: Optional[int] = SEGMENT) -> str:
    """The generated unit of ``program``: the ZIGZ_DAG_* definitions, the
    include of csrc/dag_round.cuh, and ``zigz_dag::body``, cut every
    ``segment`` instructions (None: one body; the tests build both).
    Deterministic: equal programs give equal text."""
    n_out = len(program.outs)
    n_consts = len(program._table_nodes)
    if not 1 <= n_out <= 4:
        raise ValueError(f"the round-sum kernel takes 1 to 4 outputs, the program has {n_out}")
    if n_consts > MAX_CONSTS:
        raise ValueError(f"the program's {n_consts} constants exceed the launch parameters' {MAX_CONSTS}")
    if segment is not None and segment < 1:
        raise ValueError(f"a segment holds at least one instruction, not {segment}")
    code = program.code.tolist()
    # SSA: instruction i defines v{i}; uses[i] (and out_defs) name the
    # instruction that defined each slot operand, None for a row or constant.
    slot_def: Dict[int, int] = {}
    uses: List[tuple] = []
    for i, (_op, dst, a, b) in enumerate(code):
        uses.append(tuple(slot_def[idx] if kind == KIND_SLOT else None
                          for kind, idx in (_operand(a), _operand(b))))
        slot_def[dst] = i
    out_defs = [slot_def[idx] if kind == KIND_SLOT else None for kind, idx in map(_operand, program.outs.tolist())]

    seg = segment or max(len(code), 1)
    bounds = [(s, min(s + seg, len(code))) for s in range(0, len(code), seg)] or [(0, 0)]
    segment_of = [i // seg for i in range(len(code))]
    segmented = len(bounds) > 1
    # Values that a later segment (or the outputs) read, kept across the cut.
    live_out = set()
    if segmented:
        for i, pair in enumerate(uses):
            for d in pair:
                if d is not None and segment_of[d] != segment_of[i]:
                    live_out.add(d)
        live_out.update(d for d in out_defs if d is not None)

    lines = [
        "// Z1 for one DAG program, generated by zigz_tpu_torch/ops/dag_codegen.py from",
        f"// {len(code)} instructions ({program.counts['mul']} mul, {program.counts['add']} add, "
        f"{program.counts['sub']} sub, {program.counts['row_reads']} row reads), {program.n_rows} rows,",
        f"// {n_consts} constants, {n_out} outputs, " + (f"cut every {segment} instructions." if segmented
                                                          else "one body.") + "  The kernel",
        "// and its launcher are csrc/dag_round.cuh.",
        f"#define ZIGZ_DAG_N_OUT {n_out}",
        f"#define ZIGZ_DAG_N_CONSTS {n_consts}",
        '#include "dag_round.cuh"',
        "",
        "namespace zigz_dag {",
        "",
    ]

    def emit_range(start: int, end: int) -> List[str]:
        """The lines of instructions start..end, rows formed where read."""
        body: List[str] = []
        rows: Dict[int, str] = {}  # row -> the name of its value
        loaded = set()

        def value(kind: int, idx: int, at: int, d) -> str:
            if kind == KIND_CONST:
                return f"c[{idx}]"
            if kind == KIND_ROW:
                name = rows.get(idx)
                if name is None:
                    name = rows[idx] = f"r{idx}"
                    body.append(f"  const auto {name} = row({idx});")
                return name
            if segmented and segment_of[d] < segment_of[start] and d not in loaded:
                loaded.add(d)
                body.append(f"  const auto v{d} = s[{code[d][1]}];")
            return f"v{d}"

        for i in range(start, end):
            op, dst, a, b = code[i]
            x = value(*_operand(a), i, uses[i][0])
            y = value(*_operand(b), i, uses[i][1])
            body.append(f"  const auto v{i} = {_OPNAME[op]}({x}, {y});")
            if i in live_out:
                body.append(f"  s[{dst}] = v{i};")
        return body

    if segmented:
        for k, (start, end) in enumerate(bounds):
            lines.append(f"ZIGZ_DAG_SEGMENT void segment{k}(const PointRows row, const uint32_t* __restrict__ c, "
                         "uint32_t* __restrict__ s) {")
            lines += emit_range(start, end)
            lines.append("}")
            lines.append("")
    lines.append("ZIGZ_DAG_BODY void body(const PointRows& row, const uint32_t* __restrict__ c, "
                 "uint32_t* __restrict__ out) {")
    if segmented:
        lines.append(f"  uint32_t s[{max(program.n_slots, 1)}];")
        lines += [f"  segment{k}(row, c, s);" for k in range(len(bounds))]
    else:
        lines += emit_range(0, len(code))
    for o, opd in enumerate(program.outs.tolist()):
        kind, idx = _operand(opd)
        if kind == KIND_CONST:
            lines.append(f"  out[{o}] = c[{idx}];")
        elif kind == KIND_ROW:
            lines.append(f"  out[{o}] = row({idx});")
        elif segmented:
            lines.append(f"  out[{o}] = s[{code[out_defs[o]][1]}];")
        else:
            lines.append(f"  out[{o}] = v{out_defs[o]};")
    if n_consts == 0:
        lines.append("  (void)c;")
    lines.append("}")
    lines.append("")
    lines.append("}  // namespace zigz_dag")
    lines.append("")
    return "\n".join(lines)
