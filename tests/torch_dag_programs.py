"""The zerocheck DAGs of a real prove, and the checks that hold the round-sum
kernel's program (ops/symtrace.py ``compile_device``) and its generated body
(ops/dag_codegen.py) to the plain lowering and to the JAX package, for
tests/test_torch_dag_kernels*.py and tests/test_torch_dag_codegen.py.

``prove_dags(version)`` runs a small port prove on the CPU with every
extension zerocheck recorded and stops right after the zerocheck phase
(the batch evaluation and the openings do not change a DAG).  Each record
holds both DAGs of a zerocheck, the round-0 one and the later-round one,
with their row maps.  The DAG's structure does not depend on the
challenges, so the checks trace the same combiner again with random ones.
"""

from __future__ import annotations

import ctypes
import hashlib
import subprocess

import numpy as np
import pytest
import torch
from hypothesis import strategies as st

import zigz_tpu_torch as zt
from zigz_tpu.ops import symtrace as ref_symtrace
from zigz_tpu.ops.babybear import np_from_mont, np_to_mont
from zigz_tpu_torch.ops import _build, dag_codegen, dag_dev, symtrace, zerocheck_dev_ext
from zigz_tpu_torch.prover import unified

P = symtrace.P
NOP = bytes([0x13, 0x00, 0x00, 0x00])


class _ZerochecksDone(Exception):
    pass


def prove_dags(version: int) -> list:
    """[(label, nodes, outs, row_of, degree, n_consts)] of every extension
    zerocheck DAG of a 16-step NOP prove of ``version``, in prove order."""
    dags = []
    prove = zerocheck_dev_ext.GenericDeviceZerocheckExt.prove

    def watched(self, transcript):
        for lift, trace, row_of in zip((False, True), (self._probe1, self._probe2), self._row_maps()):
            dags.append((f"v{version} zerocheck {len(dags) // 2} {'later rounds' if lift else 'round 0'}",
                         trace.nodes, trace.outs, row_of, self.degree, len(trace.consts)))
        return prove(self, transcript)

    def stop(*_args, **_kwargs):
        raise _ZerochecksDone

    with pytest.MonkeyPatch.context() as m:
        m.setattr(zerocheck_dev_ext.GenericDeviceZerocheckExt, "prove", watched)
        m.setattr(unified, "prove_batch_eval", stop)
        try:
            zt.Prover(zt.BabyBear, seed=0, device="cpu", protocol_version=version).prove(
                NOP * 16, 0x1000, None, 1 << 12, None, None)
        except _ZerochecksDone:
            pass
    return dags


def random_planes(rng, rows: int, width: int) -> np.ndarray:
    """(rows, width) canonical uint64 with 0 and p - 1 among lo and hi."""
    planes = rng.integers(0, P, size=(rows, width), dtype=np.uint64)
    half = width // 2
    planes[:, 0], planes[:, half] = 0, P - 1
    if half > 1:
        planes[:, 1], planes[:, half + 1] = P - 1, 0
    return planes


def check_program(nodes, outs, row_of, degree, consts, planes, eq_row=None):
    """The program's reference interpreter against the plain lowering, at
    every point and lane; returns (program, bound constants, reference sums)."""
    program = symtrace.compile_device(nodes, outs, row_of)
    bound = program.constants(consts)
    dag_codegen.generate(program)  # the kernel's limits: raises where the program does not fit
    lanes, sums = symtrace._run_program_reference(program, bound, planes, degree, eq_row)
    half = planes.shape[1] // 2
    run = bound.plain_run()
    lo = torch.from_numpy(planes[:, :half].view(np.int64))
    plain = torch.stack(run(lo)).numpy().astype(np.uint64)
    if eq_row is not None:
        plain = plain * planes[eq_row, :half] % np.uint64(P)
    np.testing.assert_array_equal(lanes[0], plain)  # t = 0, lane by lane
    got = dag_dev.round_sums(program, bound, torch.from_numpy(planes.view(np.int64)), degree, eq=eq_row)
    np.testing.assert_array_equal(got.numpy().astype(np.uint64), sums)  # every point, summed
    return program, bound, sums


def jax_lanes(nodes, outs, row_of, consts, planes_lo: np.ndarray) -> np.ndarray:
    """zigz_tpu's ``compile_device`` of each output, run by JAX on the CPU
    over Montgomery planes and constants, converted out: (n_out, n).  Op by
    op (``jax.disable_jit``): the same jnp ops, without XLA's compile of
    each DAG, which costs seconds a hundred nodes on the CPU."""
    import jax
    import jax.numpy as jnp

    planes_m = jnp.asarray(np_to_mont(planes_lo))
    consts_m = jnp.asarray(np_to_mont(np.asarray(consts, dtype=np.uint64)))
    col_names = tuple(sorted(row_of))
    with jax.disable_jit():
        return np.stack([np_from_mont(np.asarray(ref_symtrace.compile_device((tuple(nodes), o, col_names), row_of)(
            planes_m, consts_m))).astype(np.uint64) for o in outs])



# -- random DAGs -----------------------------------------------------------------

_C = symtrace._COL, symtrace._CONST, symtrace._ZERO, symtrace._ADD, symtrace._SUB, symtrace._MUL


@st.composite
def random_dags(draw):
    """(nodes, outs, n_cols, n_consts): columns, constants and the zero,
    then up to 40 ring ops on earlier nodes (constant-only ones among
    them), and one to four outputs of any kind."""
    col, const, zero, add, sub, mul = _C
    n_cols = draw(st.integers(1, 4))
    n_consts = draw(st.integers(0, 4))
    nodes = [(col, f"c{i}", None) for i in range(n_cols)]
    nodes += [(const, k, None) for k in range(n_consts)] + [(zero, None, None)]
    for _ in range(draw(st.integers(0, 40))):
        op = draw(st.sampled_from((add, sub, mul)))
        a = draw(st.integers(0, len(nodes) - 1))
        b = draw(st.integers(0, len(nodes) - 1))
        nodes.append((op, a, b))
    outs = tuple(draw(st.lists(st.integers(0, len(nodes) - 1), min_size=1, max_size=4)))
    return nodes, outs, n_cols, n_consts


# -- the generated body, built by a host compiler ----------------------------------

_HOST_LIBS = {}


def host_library(source: str, build_dir) -> ctypes.CDLL:
    """A generated unit compiled with ``g++ -O0`` as plain C++ (the header's
    host entry ``zigz_dag_host``), once per source in this process."""
    key = hashlib.sha256(source.encode()).hexdigest()[:20]
    lib = _HOST_LIBS.get(key)
    if lib is None:
        src, out = build_dir / f"{key}.cpp", build_dir / f"{key}.so"
        src.write_text(source)
        subprocess.run(["g++", "-O0", "-std=c++17", "-shared", "-fPIC", "-x", "c++", "-I", str(_build.CSRC),
                        "-o", str(out), str(src)], check=True, capture_output=True, timeout=300)
        lib = _HOST_LIBS[key] = ctypes.CDLL(str(out))
    return lib


def run_host(lib, bound, planes: np.ndarray, degree: int, eq_row=None):
    """The host entry over ``planes`` (rows, width) canonical: ((degree,
    n_out, width / 2) Montgomery u32 lanes, (degree, n_out) raw u64 sums)."""
    half, n_out = planes.shape[1] // 2, len(bound.program.outs)
    lanes = np.zeros((degree, n_out, half), dtype=np.uint32)
    sums = np.zeros((degree, n_out), dtype=np.uint64)
    pl = np.ascontiguousarray(planes.astype(np.int64))
    table = bound.montgomery
    rc = lib.zigz_dag_host(ctypes.c_void_p(pl.ctypes.data), ctypes.c_int64(planes.shape[1]), ctypes.c_int(degree),
                           ctypes.c_int(-1 if eq_row is None else eq_row), ctypes.c_void_p(table.ctypes.data),
                           ctypes.c_int(len(table)), ctypes.c_void_p(lanes.ctypes.data),
                           ctypes.c_void_p(sums.ctypes.data))
    assert rc == 0, "the host entry refused the arguments"
    return lanes, sums


def check_generated(program, bound, planes, degree, build_dir, segment=dag_codegen.SEGMENT, eq_row=None):
    """The generated body of ``program``, cut every ``segment``
    instructions (None: one body), built for the host, equals ``_run_program_reference`` lane by lane and sum by sum
    (tolerance zero); its lanes are canonical Montgomery values and its u64
    sums are the exact sums of its lanes.  Returns the canonical lanes."""
    lib = host_library(dag_codegen.generate(program, segment), build_dir)
    lanes, sums = run_host(lib, bound, planes, degree, eq_row)
    assert int(lanes.max(initial=0)) < P  # every value REDC-reduced to canonical
    np.testing.assert_array_equal(sums, lanes.astype(np.uint64).sum(axis=-1, dtype=np.uint64))
    want_lanes, want_sums = symtrace._run_program_reference(program, bound, planes, degree, eq_row)
    canon = symtrace._redc_np(lanes.astype(np.uint64))
    np.testing.assert_array_equal(canon, want_lanes)
    np.testing.assert_array_equal(sums % np.uint64(P) * np.uint64(symtrace.R_MONT_INV) % np.uint64(P), want_sums)
    return canon
