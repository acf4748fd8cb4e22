"""The zerocheck round's DAG sweep: kernel Z1 and its plain version.

Counterpart of the jitted round of zigz_tpu (ops/symtrace.py
``compile_device`` under ops/zerocheck_dev_ext.py ``_round_sums`` and
ops/zerocheck_gen.py ``_round_fn``), which XLA compiles once per DAG
signature.  Here a traced DAG is lowered to a program (ops/symtrace.py
``compile_device``), ops/dag_codegen.py writes the program's own kernel,
ops/_build.py compiles it with nvcc (``build/zigz_tpu_torch/dag/``), and
one launch gives a round's sums at every point over the whole width.

``program`` lowers a traced DAG once per process, keyed by its signature
and row map, and on a CUDA device starts its kernel's build without
waiting (the zerocheck provers ask for their programs when they are
constructed, and prover/unified.py constructs them right after each
argument's advice phase, so every build of a prove starts before the
first zerocheck); ``round_sums`` waits for the build, adding the wait to
``WAITED["build_s"]``, and launches it for a CUDA tensor, and runs the
plain version, ``plain_round_sums`` (``_round_sums_plain`` over
``compile_dag``'s torch ops), for a CPU tensor; it never falls back from
one to the other.  ``LAUNCHES`` counts Z1's launches.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..utils.profiling import counter_table
from . import _build, dag_codegen
from .babybear import P
from .symtrace import R_MONT_INV, DagProgram, ProgramConstants, compile_device

__all__ = ["round_sums", "plain_round_sums", "program", "prepare", "SWEEP_CHUNK", "LAUNCHES", "WAITED"]

# Widest slice of the half-tables that one DAG pass of the plain version
# evaluates (at all its ``degree`` points at once); wider rounds run in
# chunks, so the sweep's transient stays bounded.
SWEEP_CHUNK = 1 << 19

# Kernel launches since the last reset; the plain version does not count.
LAUNCHES = counter_table("dag", ["round_sums"])
# Seconds spent waiting on nvcc for generated kernels, since the last reset.
WAITED = counter_table("dag_wait", ["build_s"])
MAX_OUTPUTS = 4

# Every program lowered in this process, by (DAG signature, row map).
_PROGRAMS: Dict[tuple, DagProgram] = {}


def program(trace, outs, row_of: Dict[str, int], device: torch.device) -> DagProgram:
    """The program of ``trace`` (ops/symtrace.py, its ``nodes``) with
    outputs ``outs`` under ``row_of``: lowered on first use in this process
    and found by the trace's signature after that, so a later prove skips
    ``compile_device``, the generator and the hash.  On a CUDA ``device``
    its kernel's build is started (or found: a structurally equal program
    shares it) without waiting; raises KernelBuildError where nvcc is
    missing."""
    key = (trace.signature, tuple(outs), tuple(sorted(row_of.items())))
    prog = _PROGRAMS.get(key)
    if prog is None:
        prog = _PROGRAMS[key] = compile_device(trace.nodes, outs, row_of)
    if device.type == "cuda":
        prepare(prog)
    return prog


def prepare(program: DagProgram) -> _build.GeneratedBuild:
    """Start the build of ``program``'s generated kernel, or find it (a
    structurally equal program shares it); does not wait.  Raises
    KernelBuildError where nvcc is missing."""
    if program.kernel is None:
        program.kernel = _build.start_generated(dag_codegen.generate(program))
    return program.kernel


def _round_sums_plain(dag, planes: torch.Tensor, degree: int):
    """g(0), g(2..degree) coordinate sums of eq * C over the current
    variable's half-split: ((degree, 4) canonical int64, DAG passes made).
    g(1) follows from the sumcheck identity on the host.  A base-field DAG
    (ops/zerocheck_gen.py) has one output and gives (degree, 1).

    The ``degree`` evaluation points are laid side by side along the width
    and go through the DAG in ONE pass: the sweep is bound by the number of
    launches, not by their width, so this divides its cost by ``degree``."""
    half = planes.shape[-1] // 2
    total, passes = None, 0
    for s in range(0, half, SWEEP_CHUNK):
        lo = planes[:, s : min(s + SWEEP_CHUNK, half)]
        hi = planes[:, half + s : half + min(s + SWEEP_CHUNK, half)]
        points = [lo]
        if degree >= 2:
            delta = (hi - lo) % P
            cur = hi
            for _t in range(2, degree + 1):
                cur = (cur + delta) % P
                points.append(cur)
        out = torch.stack(dag(torch.cat(points, dim=-1)))  # (4, degree * chunk)
        # a width below 2^32 sums below 2^63
        part = out.view(out.shape[0], len(points), -1).sum(dim=-1).t() % P
        total = part if total is None else (total + part) % P
        passes += 1
    return total, passes


def plain_round_sums(program: DagProgram, consts: ProgramConstants, planes: torch.Tensor, degree: int,
                     eq: int = None) -> torch.Tensor:
    """Plain version of Z1 on ``planes``' own device: ``compile_dag``'s torch
    ops under ``_round_sums_plain``, the eq row's product added for a
    base-field DAG.  (degree, n_out) canonical int64 on that device."""
    run = consts.plain_run()
    dag = run if eq is None else (lambda pl: [(run(pl)[0] * pl[eq]).remainder_(P)])
    return _round_sums_plain(dag, planes, degree)[0]


def round_sums(program: DagProgram, consts: ProgramConstants, planes: torch.Tensor, degree: int,
               eq: int = None) -> torch.Tensor:
    """The round sums at t = 0, 2, .., degree of the DAG's outputs over the
    half-split ``planes`` (rows, width) canonical int64, as a (degree,
    n_out) canonical int64 tensor on the host: on a card, the round's one
    read-back.  ``eq``: a plane row that multiplies the single output (the
    base-field zerocheck's eq table, which its DAG leaves out).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    program's generated kernel or raises (KernelBuildError,
    KernelLaunchError)."""
    if consts.program is not program:
        raise ValueError("round_sums: the constants are bound to another program")
    if planes.dtype != torch.int64 or planes.dim() != 2 or not planes.is_contiguous():
        raise ValueError(f"round_sums: expected a contiguous (rows, width) int64 tensor, "
                         f"got {planes.dtype} {tuple(planes.shape)}")
    rows, width = planes.shape
    if width < 2 or width % 2 or width > 1 << 33:  # 2^32 lanes of u32 values sum below 2^63
        raise ValueError(f"round_sums: the width must be even and in [2, 2^33], got {width}")
    n_out = len(program.outs)
    if not 1 <= n_out <= MAX_OUTPUTS or degree < 1:
        raise ValueError(f"round_sums: {n_out} outputs at degree {degree}")
    if program.n_rows > rows or (eq is not None and not 0 <= eq < rows):
        raise ValueError(f"round_sums: the program reads {program.n_rows} rows (eq {eq}), the planes have {rows}")
    if eq is not None and n_out != 1:
        raise ValueError("round_sums: an eq row multiplies a single-output DAG only")
    if planes.device.type == "cpu":
        return plain_round_sums(program, consts, planes, degree, eq)
    if planes.device.type != "cuda":
        raise ValueError(f"round_sums: unsupported device {planes.device}")
    build = prepare(program)
    _build.load()  # build, or raise, before anything touches the card
    waited = build.waited_s
    lib = build.wait()
    WAITED["build_s"] += build.waited_s - waited
    dev = planes.device
    sums = torch.empty((degree, n_out), dtype=torch.int64, device=dev)
    table = consts.montgomery  # host u32, copied into the launch's parameters
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(lib.zigz_dag_round_sums(planes.data_ptr(), width, degree, -1 if eq is None else eq,
                                             table.ctypes.data, len(table), sums.data_ptr(), stream),
                     "zigz_dag_round_sums")
    LAUNCHES["round_sums"] += 1
    raw = sums.cpu()  # Montgomery sums below 2^63
    return raw % P * R_MONT_INV % P
