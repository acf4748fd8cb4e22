"""The zerocheck round's DAG sweep: kernel Z1 and its plain version.

Counterpart of the jitted round of zigz_tpu (ops/symtrace.py
``compile_device`` under ops/zerocheck_dev_ext.py ``_round_sums`` and
ops/zerocheck_gen.py ``_round_fn``), which XLA fuses into a few kernels.
Here a traced DAG is lowered once per prove to a program
(ops/symtrace.py ``compile_device``) and one launch of
``dag_round_sums_kernel`` (csrc/zerocheck_kernels.cu) gives a round's sums
at every point over the whole width.

``round_sums`` launches Z1 for a CUDA tensor and runs the plain version,
``plain_round_sums`` (``_round_sums_plain`` over ``compile_dag``'s torch
ops), for a CPU tensor; it never falls back from one to the other.
``LAUNCHES`` counts Z1's launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .babybear import P
from .symtrace import R_MONT_INV, DagProgram, ProgramConstants

__all__ = ["round_sums", "plain_round_sums", "block_threads", "SWEEP_CHUNK", "LAUNCHES"]

# Widest slice of the half-tables that one DAG pass evaluates (at all its
# ``degree`` points at once); wider rounds run in chunks, so the sweep's
# transient stays bounded.
SWEEP_CHUNK = 1 << 19

# Kernel launches since the last reset; the plain version does not count.
LAUNCHES = {"round_sums": 0}

# The kernel's shared memory: a chunk of the program (csrc kChunk int4),
# the constant table, then n_slots u32 slots for every thread of the block.
SMEM_BYTES = 232448  # 227 KB, the most one block of an H100 may use
CODE_CHUNK = 256
MAX_THREADS = 256
MAX_OUTPUTS = 4


def block_threads(program: DagProgram, n_consts: int) -> int:
    """Z1's block size for ``program``: the most threads, a multiple of 32
    up to 256, whose slots fit in shared memory beside the staged program
    and the constant table.  Raises where not even 32 threads fit."""
    room = SMEM_BYTES - 16 * CODE_CHUNK - 4 * n_consts
    per_thread = 4 * program.n_slots
    threads = MAX_THREADS if per_thread == 0 else min(MAX_THREADS, room // per_thread // 32 * 32)
    if threads < 32:
        raise ValueError(f"the DAG program needs {program.n_slots} slots a thread (and {n_consts} constants): "
                         f"32 threads of them do not fit in {SMEM_BYTES} B of shared memory")
    return threads


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

    A CPU tensor takes the plain version; a CUDA tensor launches
    ``zigz_dag_round_sums`` or raises (KernelBuildError, KernelLaunchError)."""
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
    _build.load()  # build, or raise, before anything touches the card
    dev = planes.device
    n_consts = len(consts.table)
    threads = block_threads(program, n_consts)
    code, table = program.on(dev), consts.on(dev)
    sums = torch.empty((degree, n_out), dtype=torch.int64, device=dev)
    outs = (ctypes.c_int * n_out)(*program.outs.tolist())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.launch("zigz_dag_round_sums", planes.data_ptr(), width, code.data_ptr(), len(program.code),
                      table.data_ptr(), n_consts, outs, n_out, -1 if eq is None else eq, program.n_slots, degree,
                      threads, sums.data_ptr(), stream)
    LAUNCHES["round_sums"] += 1
    raw = sums.cpu()  # Montgomery sums below 2^52
    return raw % P * R_MONT_INV % P
