"""Z1's generated kernel on the CPU: ops/dag_codegen.py's source for each DAG
program, and its body compiled by a host compiler.

csrc/dag_round.cuh compiles under g++ as plain C++ (the ZIGZ_HD macro of
csrc/babybear.cuh), with a host entry that runs the generated body with the
kernel's point formation and u64 sums.  Each generated body, built with
``g++ -O0``, is held to ``symtrace._run_program_reference`` (the numpy
statement of the algorithm) lane by lane and sum by sum, with tolerance
zero: every DAG of a v2 prove but the 11,738-instruction one (which the
card runs, chip_smoke.py phase 9b), at their degrees 3, 4 and 6, as one
body and cut into segments; a base-field program with its eq row; random
DAGs; and against zigz_tpu's ``compile_device`` lanes on the DAGs of up to
JAX_NODES nodes.  ops/dag_dev.py lowers a DAG once per signature, and a
prove makes every zerocheck (so starts every build) before the first one
proves.  tests/test_torch_nofallback.py holds the wrapper's
build without nvcc, with a failing nvcc and with a library that does not
load.

Inputs come from numpy with fixed seeds, with 0 and p - 1 among every
row's lo and hi."""

import ast
import re

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from torch_dag_programs import (P, check_generated, host_library, jax_lanes, prove_dags, random_dags, random_planes,
                               run_host)
import zigz_tpu_torch as zt
from zigz_tpu_torch.ops import _build, dag_codegen, dag_dev, symtrace, zerocheck_dev_ext
from zigz_tpu_torch.prover import unified

JAX_NODES = 300  # the real DAGs zigz_tpu's compile_device is run on, by size
HOST_LIMIT = 10_000  # instructions: the largest program is left to the card
# Where the body is cut: one body, every instruction, every 40, as shipped.
SEGMENTS = {"whole": None, "cut_everywhere": 1, "segments": 40, "shipped": dag_codegen.SEGMENT}


@pytest.fixture(scope="module")
def build_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("dag_host")


@pytest.fixture(scope="module")
def dags():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs several pytest workers on a few cores
    try:
        yield {version: prove_dags(version) for version in (2, 4)}
    finally:
        torch.set_num_threads(threads)


def _distinct(found):
    """The distinct programs of a prove, smallest first: (label, program,
    degree, n_consts)."""
    seen, out = set(), []
    for label, nodes, outs, row_of, degree, n_consts in found:
        program = symtrace.compile_device(nodes, outs, row_of)
        key = (dag_codegen.generate(program), degree)
        if key not in seen:
            seen.add(key)
            out.append((label, program, degree, n_consts))
    return sorted(out, key=lambda d: len(d[1].code))


def _bound(program, n_consts, rng):
    return program.constants([int(x) for x in rng.integers(0, P, size=n_consts)])


def _tiny(combiner, names, consts):
    t = symtrace.trace_combiner(combiner, names, consts, P)
    program = symtrace.compile_device(t.nodes, [t.out], {name: i for i, name in enumerate(names)})
    return t, program


# -- the generator ------------------------------------------------------------------


def test_generation_is_deterministic_and_equal_programs_share_a_key():
    """The source depends on the program's structure and its cut only: two
    traces with other constants give one source and one build key."""
    def comb(c, a, p):
        return (c["x"] * a[0] + c["y"] * (c["x"] - a[1])) % p

    (t1, p1), (t2, p2) = _tiny(comb, ["x", "y"], [3, 5]), _tiny(comb, ["x", "y"], [7, 11])
    assert t1.consts != t2.consts
    src = dag_codegen.generate(p1)
    assert src == dag_codegen.generate(p1) == dag_codegen.generate(p2)
    assert _build._generated_hash(src) == _build._generated_hash(dag_codegen.generate(p2))
    other = dag_codegen.generate(p1, segment=1)
    assert other != src and _build._generated_hash(other) != _build._generated_hash(src)
    assert '#include "dag_round.cuh"' in src and "ZIGZ_DAG_N_CONSTS 2" in src


def test_the_build_key_covers_source_headers_and_flags(monkeypatch):
    _t, program = _tiny(lambda c, a, p: (c["x"] * a[0]) % p, ["x"], [3])
    src = dag_codegen.generate(program)
    key = _build._generated_hash(src)
    assert _build._generated_hash(src + "\n") != key
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build._generated_hash(src) != key


def test_the_generator_refuses_what_the_kernel_cannot_take():
    _t, program = _tiny(lambda c, a, p: (c["x"] * a[0]) % p, ["x"], [3])
    with pytest.raises(ValueError, match="segment"):
        dag_codegen.generate(program, segment=0)
    wide = symtrace.compile_device([(symtrace._COL, "x", None)], [0] * 5, {"x": 0})
    with pytest.raises(ValueError, match="outputs"):
        dag_codegen.generate(wide)
    n = dag_codegen.MAX_CONSTS + 1
    _t, many = _tiny(lambda c, a, p: sum(c["x"] * a[i] for i in range(n)) % p, ["x"], list(range(1, n + 1)))
    with pytest.raises(ValueError, match="constants"):
        dag_codegen.generate(many)


def test_the_generator_is_host_python():
    """ops/dag_codegen.py imports the standard library and the port's
    symtrace only: no torch, no JAX, nothing of zigz_tpu."""
    tree = ast.parse(open(dag_codegen.__file__).read())
    absolute = {alias.name.split(".")[0] for node in ast.walk(tree) if isinstance(node, ast.Import)
                for alias in node.names}
    absolute |= {node.module.split(".")[0] for node in ast.walk(tree)
                 if isinstance(node, ast.ImportFrom) and node.level == 0}
    relative = {node.module for node in ast.walk(tree) if isinstance(node, ast.ImportFrom) and node.level == 1}
    assert absolute <= {"__future__", "typing"} and relative == {"symtrace"}


@pytest.mark.parametrize("version", [2, 4])
def test_every_dag_of_a_prove_reads_its_rows_and_writes_its_outputs(dags, version):
    """Every DAG of the prove generates a body that forms each row the
    program reads, and no other, and writes each of its outputs."""
    assert len(dags[version]) == 24
    for label, nodes, outs, row_of, degree, _n in dags[version]:
        program = symtrace.compile_device(nodes, outs, row_of)
        src = dag_codegen.generate(program)
        read = {int(opd) >> 2 for opd in program.code[:, 2:].ravel() if int(opd) & 3 == symtrace.KIND_ROW}
        read |= {int(opd) >> 2 for opd in program.outs if int(opd) & 3 == symtrace.KIND_ROW}
        formed = {int(part.split(")")[0]) for part in src.split("row(")[1:]}
        assert formed == read and max(read) + 1 == program.n_rows, label
        assert all(f"out[{o}]" in src for o in range(len(outs))), label
        assert src.count(" = mul(") == program.counts["mul"], label


def test_a_row_is_formed_once_a_function(dags):
    """A row value is formed where its function (the body, or a segment
    of it) first reads it and reused after that: no function forms a row
    twice, and a cut body forms each row in every segment that reads it."""
    for label, nodes, outs, row_of, _degree, _n in dags[2][:8]:
        program = symtrace.compile_device(nodes, outs, row_of)
        n = len(program.code)
        for cut in (None, 40):
            seg = cut or n
            src = dag_codegen.generate(program, cut)
            functions = src.split("ZIGZ_DAG_SEGMENT")[1:] if n > seg else [src]
            formed = [re.findall(r"const auto r(\d+) = row\(\1\);", f) for f in functions]
            assert all(len(rows) == len(set(rows)) for rows in formed), (label, cut)
            reads = [{int(opd) >> 2 for opd in program.code[i:i + seg, 2:].ravel() if int(opd) & 3 == symtrace.KIND_ROW}
                     for i in range(0, n, seg)]
            assert [set(map(int, rows)) for rows in formed] == reads, (label, cut)


# -- the generated body against the reference ---------------------------------------


@pytest.mark.parametrize("cut", list(SEGMENTS))
def test_real_dags_equal_the_reference(dags, build_dir, cut):
    """The distinct programs of a v2 prove (95 to 4,629 instructions; cut
    as shipped, all of them; otherwise the smallest five, the smallest of
    each degree and the 2,297-instruction one; cut at every instruction,
    the smallest of those), built for the host, equal the reference at
    their own degree, width 8."""
    rng = np.random.default_rng(1)
    found = [d for d in _distinct(dags[2]) if len(d[1].code) < HOST_LIMIT]
    if cut != "shipped":
        first = {}
        for d in found:
            first.setdefault(d[2], d)
        found = [d for d in found if d in found[:5] or d in first.values() or len(d[1].code) == 2297]
        if cut == "cut_everywhere":  # a function an instruction: the smallest of them
            found = found[:5] + [d for d in first.values() if d not in found[:5]]
    assert len(found) >= 6 and {d[2] for d in found} == {3, 4, 6}
    for label, program, degree, n_consts in found:
        check_generated(program, _bound(program, n_consts, rng), random_planes(rng, program.n_rows, 8),
                        degree, build_dir, SEGMENTS[cut])


@pytest.mark.parametrize("degree", [1, 2, 3, 4, 5, 6])
def test_a_real_dag_at_every_degree(dags, build_dir, degree):
    """The kernel takes the degree at launch: one program at degrees 1 to
    6, width 32 (16 lanes), as one body and cut at every instruction."""
    rng = np.random.default_rng(degree)
    label, program, _degree, n_consts = _distinct(dags[2])[2]
    bound = _bound(program, n_consts, rng)
    planes = random_planes(rng, program.n_rows, 32)
    whole = check_generated(program, bound, planes, degree, build_dir, None)
    cut = check_generated(program, bound, planes, degree, build_dir, 1)
    np.testing.assert_array_equal(whole, cut)


def _grand_product(tau, gamma):
    def combiner(cols, alphas, p):
        sel, idx = cols["__sel__"], cols["__idx__"]
        a, b, g = cols["a"], cols["b"], cols["g"]
        fp = (tau + p - (a + gamma * b) % p) % p
        c1 = (g * fp + p - sel) % p
        c2 = sel * ((1 + p - sel) % p) % p
        c3 = sel * b % p * ((idx + a) % p) % p
        return (alphas[0] * c1 + alphas[1] * c2 + alphas[2] * c3) % p

    return combiner


@pytest.mark.parametrize("cut", ["shipped", "segments", "cut_everywhere"])
def test_base_field_program_with_its_eq_row(build_dir, cut):
    """The base-field zerocheck's one-output program, the eq row passed
    beside it (ops/zerocheck_gen.py), at degree 4, as one body and cut."""
    rng = np.random.default_rng(12)
    names = ["__idx__", "__sel__", "a", "b", "g"]
    tr = symtrace.trace_combiner(_grand_product(*(int(x) for x in rng.integers(1, P, size=2))), names,
                                 [int(x) for x in rng.integers(0, P, size=3)], P)
    row_of = {name: i for i, name in enumerate(names)}
    row_of["__eq__"] = len(names)
    program = symtrace.compile_device(tr.nodes, [tr.out], row_of)
    planes = random_planes(rng, len(names) + 1, 64)
    segment = {"shipped": dag_codegen.SEGMENT, "segments": 3, "cut_everywhere": 1}[cut]
    check_generated(program, program.constants(tr.consts), planes, 4, build_dir, segment, eq_row=len(names))


@settings(max_examples=12, deadline=None, suppress_health_check=[HealthCheck.too_slow,
                                                                    HealthCheck.function_scoped_fixture])
@given(dag=random_dags(), seed=st.integers(0, 2**32 - 1), degree=st.integers(1, 6))
def test_random_dags_equal_the_reference(build_dir, dag, seed, degree):
    """Random DAGs (outputs that are rows or constants among them), with
    an eq row where there is one output, cut as shipped and every three
    instructions."""
    nodes, outs, n_cols, n_consts = dag
    rng = np.random.default_rng(seed)
    program = symtrace.compile_device(nodes, outs, {f"c{i}": i for i in range(n_cols)})
    bound = program.constants([int(x) for x in rng.integers(0, P, size=n_consts)])
    planes = random_planes(rng, n_cols + 1, 8)
    for cut in (dag_codegen.SEGMENT, 3):
        check_generated(program, bound, planes, degree, build_dir, cut)
        if len(outs) == 1:
            check_generated(program, bound, planes, degree, build_dir, cut, eq_row=n_cols)


def test_small_real_dags_equal_zigz_tpu_compile_device(dags, build_dir):
    """The real DAGs of up to JAX_NODES nodes: the generated body's lanes at
    t = 0 equal zigz_tpu's compile_device (op by op, Montgomery in,
    converted out)."""
    rng = np.random.default_rng(7)
    seen, checked = set(), 0
    for label, nodes, outs, row_of, degree, n_consts in dags[2]:
        if len(nodes) > JAX_NODES or tuple(nodes) in seen:
            continue
        seen.add(tuple(nodes))
        consts = [int(x) for x in rng.integers(0, P, size=n_consts)]
        planes = random_planes(rng, max(row_of.values()) + 1, 8)
        program = symtrace.compile_device(nodes, outs, row_of)
        lanes = check_generated(program, program.constants(consts), planes, 1, build_dir)
        np.testing.assert_array_equal(jax_lanes(nodes, outs, row_of, consts, planes[:, :4]), lanes[0], label)
        checked += 1
    assert checked >= 3


def test_sums_are_exact_below_2_52_and_convert_once(build_dir):
    """2^21 lanes of two outputs: the u64 sums are the exact sums of the
    Montgomery lanes and stay below 2^52, and one conversion after the sum
    equals the sum of the converted lanes mod p (the sum is linear)."""
    col, const, add, sub, mul = symtrace._COL, symtrace._CONST, symtrace._ADD, symtrace._SUB, symtrace._MUL
    nodes = [(col, "x", None), (col, "y", None), (const, 0, None), (mul, 0, 2), (add, 3, 1), (sub, 0, 1)]
    program = symtrace.compile_device(nodes, (4, 5), {"x": 0, "y": 1})
    bound = program.constants([P - 1])
    planes = random_planes(np.random.default_rng(21), 2, 1 << 22)
    lanes, sums = run_host(host_library(dag_codegen.generate(program), build_dir), bound, planes, 2)
    assert (1 << 50) < int(sums.min()) and int(sums.max()) < 1 << 52
    np.testing.assert_array_equal(sums, lanes.astype(np.uint64).sum(axis=-1, dtype=np.uint64))
    canon = symtrace._redc_np(lanes.astype(np.uint64))
    want_lanes, want_sums = symtrace._run_program_reference(program, bound, planes, 2)
    np.testing.assert_array_equal(canon, want_lanes)
    converted = sums % np.uint64(P) * np.uint64(symtrace.R_MONT_INV) % np.uint64(P)
    np.testing.assert_array_equal(converted, canon.sum(axis=-1, dtype=np.uint64) % np.uint64(P))
    np.testing.assert_array_equal(converted, want_sums)


def test_a_dag_is_lowered_once_per_signature():
    """ops/dag_dev.py ``program``: a trace with other constants finds the
    program lowered first (no second compile_device, generation or hash);
    another row map is another program; on the CPU no build starts."""
    def comb(c, a, p):
        return (c["x"] * a[0] + c["y"] * (c["x"] - a[1])) % p

    cpu = torch.device("cpu")
    t1, t2 = (symtrace.trace_combiner(comb, ["x", "y"], consts, P) for consts in ([3, 5], [7, 11]))
    first = dag_dev.program(t1, [t1.out], {"x": 0, "y": 1}, cpu)
    assert dag_dev.program(t2, [t2.out], {"y": 1, "x": 0}, cpu) is first and first.kernel is None
    other = dag_dev.program(t1, [t1.out], {"x": 1, "y": 0}, cpu)
    assert other is not first and other.code.tolist() != first.code.tolist()


class _Stop(Exception):
    pass


def test_a_prove_makes_every_zerocheck_before_the_first_one_proves(monkeypatch):
    """prover/unified.py makes each argument's zerochecks right after its
    advice phase, so on a card every program's build has started before
    the first zerocheck waits for its own: a 16-step v2 prove on the CPU
    has made all 12 of its device provers when the first one proves, and
    proves with those same 12."""
    cls = zerocheck_dev_ext.GenericDeviceZerocheckExt
    made, at_first = [], []
    init, prove = cls.__init__, cls.prove

    def counted(self, *args, **kwargs):
        init(self, *args, **kwargs)
        made.append(self)

    def watched(self, transcript):
        at_first.append(len(made))
        return prove(self, transcript)

    def stop(*_args, **_kwargs):
        raise _Stop

    monkeypatch.setattr(cls, "__init__", counted)
    monkeypatch.setattr(cls, "prove", watched)
    monkeypatch.setattr(unified, "prove_batch_eval", stop)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.raises(_Stop):
            zt.Prover(zt.BabyBear, seed=0, device="cpu", protocol_version=2).prove(
                bytes([0x13, 0, 0, 0]) * 16, 0x1000, None, 1 << 12, None, None)
    finally:
        torch.set_num_threads(threads)
    assert len(made) == 12 and at_first == [12] * 12


def test_the_ptxas_report_sums_spills_over_functions():
    log = """ptxas info    : Compiling entry function '_Z26zigz_dag_round_sums_kernelPKll' for 'sm_90a'
ptxas info    : Function properties for _Z26zigz_dag_round_sums_kernelPKll
    48 bytes stack frame, 16 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 255 registers, 8216 bytes cmem[0]
ptxas info    : Function properties for _ZN8zigz_dag8segment1
    96 bytes stack frame, 40 bytes spill stores, 24 bytes spill loads
ptxas info    : Used 181 registers
"""
    assert _build.ptxas_report(log) == {"registers": 255, "functions": 2, "stack_frame_B": 96,
                                         "spill_stores_B": 56, "spill_loads_B": 32}
    assert _build.ptxas_report("")["registers"] is None
