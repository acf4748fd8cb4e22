"""The port's standalone modules == their zigz_tpu counterparts on the same
seeded inputs: the sumcheck and Lasso provers and verifiers, the table
builders and decompositions, the Lagrange, univariate and limb helpers, the
RV32I decoder, the guest programs, the host Merkle forest, the verifier
benchmark and the profiling helpers.

They are host code (the port's own copies); bytes and integers are
compared: tolerance zero.  The two packages have classes of their own, so
values cross between them as ints and bytes."""

import os

import numpy as np
import pytest
import torch

import zigz_tpu as z
from zigz_tpu.commitments import host_forest as ref_host_forest
from zigz_tpu.core import decomposition as ref_decomposition
from zigz_tpu.guest import programs as ref_programs
from zigz_tpu.isa import rv32i as ref_rv32i
from zigz_tpu.lookups import lasso as ref_lasso
from zigz_tpu.lookups import table_builder as ref_tables
from zigz_tpu.lookups import table_decomposition as ref_table_decomposition
from zigz_tpu.poly import lagrange as ref_lagrange
from zigz_tpu.utils import profiling as ref_profiling
import zigz_tpu_torch as zt
from zigz_tpu_torch.commitments import host_forest
from zigz_tpu_torch.commitments.device_forest import DeviceMerkleForest
from zigz_tpu_torch.core import decomposition
from zigz_tpu_torch.guest import programs
from zigz_tpu_torch.isa import rv32i
from zigz_tpu_torch.lookups import lasso, pipeline_lasso
from zigz_tpu_torch.lookups import table_builder as tables
from zigz_tpu_torch.lookups import table_decomposition
from zigz_tpu_torch.ops import witness_dev
from zigz_tpu_torch.poly import lagrange
from zigz_tpu_torch.utils import profiling
from zigz_tpu_torch.verifier import benchmarks

P = z.BabyBear.MODULUS
FIELDS = {"BabyBear": (zt.BabyBear, z.BabyBear), "F17": (zt.F17, z.F17), "Goldilocks": (zt.Goldilocks, z.Goldilocks)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several pytest workers on a few cores: torch's own
    intra-op thread pool would oversubscribe them (tens of times slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ints(elements):
    return [int(e.value) for e in elements]


# -- the package surface -------------------------------------------------------

def test_the_port_exports_what_zigz_tpu_exports():
    assert sorted(zt.__all__) == sorted(z.__all__)
    for name in z.__all__:
        obj = getattr(zt, name)  # a class or function names its module, a module itself
        assert (getattr(obj, "__module__", None) or obj.__name__).startswith("zigz_tpu_torch."), name


# -- poly/univariate.py, poly/lagrange.py --------------------------------------

@pytest.mark.parametrize("field", sorted(FIELDS))
def test_univariate_arithmetic(field):
    F, R = FIELDS[field]
    rng = np.random.default_rng(1)
    a, b = ([int(x) for x in rng.integers(0, min(F.MODULUS, 1 << 62), size=n)] for n in (5, 3))
    x = int(rng.integers(0, min(F.MODULUS, 1 << 62)))
    pa, pb = zt.Univariate(F, [F(c) for c in a]), zt.Univariate(F, [F(c) for c in b])
    ra, rb = z.Univariate(R, [R(c) for c in a]), z.Univariate(R, [R(c) for c in b])
    for op in ("add", "sub", "mul", "compose"):
        assert _ints(getattr(pa, op)(pb).coefficients) == _ints(getattr(ra, op)(rb).coefficients), op
    assert _ints(pa.scalar_mul(F(x)).coefficients) == _ints(ra.scalar_mul(R(x)).coefficients)
    assert _ints(pa.neg().coefficients) == _ints(ra.neg().coefficients)
    assert pa.eval(F(x)).value == ra.eval(R(x)).value
    assert _ints(pa.eval_many([F(x), F(0), F(1)])) == _ints(ra.eval_many([R(x), R(0), R(1)]))
    assert (pa.degree(), pa.is_zero(), pa.is_constant()) == (ra.degree(), ra.is_zero(), ra.is_constant())
    assert zt.Univariate.zero(F).is_zero() and zt.Univariate.identity(F).degree() == 1
    assert zt.Univariate.constant(F, F(3)).is_constant()


@pytest.mark.parametrize("field", ["BabyBear", "F17"])
def test_lagrange_interpolation(field):
    F, R = FIELDS[field]
    rng = np.random.default_rng(2)
    xs = [int(x) for x in rng.choice(min(F.MODULUS, 1000), size=6, replace=False)]
    ys = [int(y) for y in rng.integers(0, F.MODULUS, size=6)]
    point = int(rng.integers(0, F.MODULUS))
    fx, fy = [F(x) for x in xs], [F(y) for y in ys]
    rx, ry = [R(x) for x in xs], [R(y) for y in ys]
    poly = lagrange.interpolate(F, fx, fy)
    assert _ints(poly.coefficients) == _ints(ref_lagrange.interpolate(R, rx, ry).coefficients)
    assert [poly.eval(x).value for x in fx] == ys
    assert _ints(lagrange.lagrange_basis(F, fx, 2).coefficients) == _ints(ref_lagrange.lagrange_basis(R, rx, 2).coefficients)
    assert lagrange.eval_lagrange_basis(F, fx, 3, F(point)).value == \
        ref_lagrange.eval_lagrange_basis(R, rx, 3, R(point)).value
    assert _ints(lagrange.vanishing_polynomial(F, fx).coefficients) == _ints(ref_lagrange.vanishing_polynomial(R, rx).coefficients)
    assert lagrange.BarycentricForm(F, fx, fy).eval(F(point)).value == \
        ref_lagrange.BarycentricForm(R, rx, ry).eval(R(point)).value == poly.eval(F(point)).value


# -- core/decomposition.py -----------------------------------------------------

def test_limb_decomposition():
    rng = np.random.default_rng(3)
    values = [0, 1, P - 1, P, (1 << 31) - 1, 1 << 31, (1 << 62) - 1, 1 << 62, (1 << 64) - 1,
              *(int(v) for v in rng.integers(0, 1 << 63, size=16, dtype=np.uint64))]
    for v in values:
        got, want = decomposition.Decompose64to31.from_u64(v), ref_decomposition.Decompose64to31.from_u64(v)
        assert (got.low, got.middle, got.high) == (want.low, want.middle, want.high)
        assert got.to_u64() == v and got.is_valid()
        assert decomposition.verify_range_constraint(decomposition.range_constraint_witness(v), v)
        assert decomposition.babybear_fits_single(v) == ref_decomposition.babybear_fits_single(v)
        assert decomposition.babybear_decompose(v)[0] == ref_decomposition.babybear_decompose(v)[0]
        assert _ints(got.to_field_elements(zt.BabyBear)) == _ints(want.to_field_elements(z.BabyBear))
        back = decomposition.Decompose64to31.from_field_elements(zt.BabyBear, got.to_field_elements(zt.BabyBear))
        ref_back = ref_decomposition.Decompose64to31.from_field_elements(z.BabyBear, want.to_field_elements(z.BabyBear))
        assert back.to_u64() == ref_back.to_u64()  # == v where every limb is below p
    assert decomposition.decompose_i64(-5).to_u64() == ref_decomposition.decompose_i64(-5).to_u64() == (1 << 64) - 5
    total, carry = decomposition.add_decomposed(decomposition.Decompose64to31.from_u64(values[8]),
                                                decomposition.Decompose64to31.from_u64(2))
    assert (total.to_u64(), carry) == (1, True)
    arr = np.array(values, dtype=np.uint64)
    for got, want in zip(decomposition.np_decompose64to31(arr), ref_decomposition.np_decompose64to31(arr)):
        assert got.tolist() == want.tolist()


# -- proofs/sumcheck.py --------------------------------------------------------

@pytest.mark.parametrize("field, num_vars", [("BabyBear", 1), ("BabyBear", 6), ("BabyBear", 10), ("F17", 3),
                                             ("Goldilocks", 4)])
def test_sumcheck_proof_bytes(field, num_vars):
    F, R = FIELDS[field]
    rng = np.random.default_rng(40 + num_vars)
    evals = [int(v) for v in rng.integers(0, min(F.MODULUS, 1 << 62), size=1 << num_vars)]
    poly, ref_poly = zt.Multilinear(F, [F(v) for v in evals]), z.Multilinear(R, [R(v) for v in evals])
    proof, ref_proof = zt.SumcheckProver.prove(poly), z.SumcheckProver.prove(ref_poly)
    assert proof.to_bytes() == ref_proof.to_bytes()
    claimed = poly.sum_over_hypercube()
    ok, final_claim = zt.SumcheckVerifier.verify_rounds(F, proof, claimed)
    assert ok and final_claim.value == proof.final_eval.value == ref_proof.final_eval.value
    assert not zt.SumcheckVerifier.verify_rounds(F, proof, claimed.add(F.one()))[0]
    # the interactive form, on the proof's own challenges
    again = zt.SumcheckProver.prove_interactive(poly, proof.final_point)
    ref_again = z.SumcheckProver.prove_interactive(ref_poly, ref_proof.final_point)
    assert again.to_bytes() == ref_again.to_bytes() == proof.to_bytes()


def test_sumcheck_full_verify_and_refusals():
    F = zt.BabyBear
    poly = zt.Multilinear(F, [F(7)] * 8)  # symmetric: the oracle's ordering does not matter
    proof = zt.SumcheckProver.prove(poly)
    oracle = lambda point: poly.eval(point)
    assert zt.SumcheckVerifier.verify(F, proof, poly.sum_over_hypercube(), oracle).is_valid
    assert not zt.SumcheckVerifier.verify(F, proof, F(1), oracle).is_valid
    with pytest.raises(ValueError, match="NoVariables"):
        zt.SumcheckProver.prove(zt.Multilinear(F, [F(1)]))
    with pytest.raises(ValueError, match="WrongNumberOfChallenges"):
        zt.SumcheckProver.prove_interactive(poly, [F(1)])


# -- lookups/table_builder.py, table_decomposition.py, lasso.py ----------------

@pytest.mark.parametrize("builder, bits", [("build_add_table", 3), ("build_xor_table", 4), ("build_and_table", 4)])
def test_table_builders(builder, bits):
    table, ref = getattr(tables, builder)(zt.BabyBear, bits), getattr(ref_tables, builder)(z.BabyBear, bits)
    assert table.inputs.tolist() == ref.inputs.tolist() and table.outputs.tolist() == ref.outputs.tolist()
    assert len(table) == len(ref) == 1 << (2 * bits)
    entry, ref_entry = table.entry(5), ref.entry(5)
    assert (_ints(entry.inputs), _ints(entry.outputs)) == (_ints(ref_entry.inputs), _ints(ref_entry.outputs))
    assert _ints(table.lookup([3, 2])) == _ints(ref.lookup([3, 2]))
    assert table.lookup([1 << bits, 0]) is None


def test_sparse_table():
    sparse, ref = tables.build_sparse_conditional_table(zt.BabyBear), ref_tables.build_sparse_conditional_table(z.BabyBear)
    assert sorted(sparse.map) == sorted(ref.map) and len(sparse.map) == 256
    for key in sparse.map:
        got, want = sparse.lookup(key), ref.lookup(key)
        assert (_ints(got.inputs), _ints(got.outputs)) == (_ints(want.inputs), _ints(want.outputs))
    assert sparse.lookup(max(sparse.map) + 1) is None


def test_table_decomposition():
    for v in (0, 1, 0xDEADBEEF, 0xFFFFFFFF):
        assert table_decomposition.chunk_u32_16bit(v) == ref_table_decomposition.chunk_u32_16bit(v)
        assert table_decomposition.chunk_u32_8bit(v) == ref_table_decomposition.chunk_u32_8bit(v)
        assert table_decomposition.unchunk_u32_16bit(table_decomposition.chunk_u32_16bit(v)) == v
        assert table_decomposition.unchunk_u32_8bit(table_decomposition.chunk_u32_8bit(v)) == v
    xor8, ref_xor8 = table_decomposition.build_xor8_subtable(zt.BabyBear), ref_table_decomposition.build_xor8_subtable(z.BabyBear)
    assert xor8.entries.outputs.tolist() == ref_xor8.entries.outputs.tolist()
    add16, ref_add16 = table_decomposition.add16_carry_procedural(), ref_table_decomposition.add16_carry_procedural()
    lo, hi = (1 << 32) - 40, (1 << 32) + 40  # across the carry-in boundary
    for got, want in zip(add16.eval_range(lo, hi), ref_add16.eval_range(lo, hi)):
        assert got.tolist() == want.tolist()
    assert (add16.size, add16.num_inputs, add16.num_outputs) == (ref_add16.size, ref_add16.num_inputs, ref_add16.num_outputs)
    assert table_decomposition.DecomposedTable.create_add32_chunk16().memory_usage() == 0
    assert table_decomposition.DecomposedTable.create_xor32_chunk8(zt.BabyBear).memory_usage() == \
        ref_table_decomposition.DecomposedTable.create_xor32_chunk8(z.BabyBear).memory_usage()
    for strategy in ("Chunk16", "Chunk8", "Procedural", "Sparse"):
        got = table_decomposition.DecompositionAnalysis.analyze(32, getattr(table_decomposition.DecompositionStrategy, strategy))
        want = ref_table_decomposition.DecompositionAnalysis.analyze(32, getattr(ref_table_decomposition.DecompositionStrategy, strategy))
        assert (got.original_size, got.decomposed_size, got.num_subtables) == \
            (want.original_size, want.decomposed_size, want.num_subtables)


def test_hash_entry_chain_and_rows():
    rng = np.random.default_rng(5)
    inputs = rng.integers(0, 1 << 63, size=(9, 2), dtype=np.uint64)
    outputs = rng.integers(0, 1 << 63, size=(9, 1), dtype=np.uint64)
    chain = [lasso.hash_entry_chain(zt.BabyBear, [int(v) for v in i], [int(v) for v in o]).value
             for i, o in zip(inputs, outputs)]
    assert chain == [ref_lasso.hash_entry_chain(z.BabyBear, [int(v) for v in i], [int(v) for v in o]).value
                     for i, o in zip(inputs, outputs)]
    # the v2 pipeline's row hasher (native or numpy) is the same chain
    assert pipeline_lasso.hash_query_rows(zt.BabyBear, inputs, outputs).tolist() == chain
    assert lasso._hash_rows(zt.BabyBear, inputs, outputs).tolist() == chain


def _lasso_queries(F, table, picks):
    return [lasso.LookupQuery(inputs=table.entry(i).inputs, expected_outputs=table.entry(i).outputs) for i in picks] \
        if F is zt.BabyBear else \
        [ref_lasso.LookupQuery(inputs=table.entry(i).inputs, expected_outputs=table.entry(i).outputs) for i in picks]


@pytest.mark.parametrize("count", [1, 5, 16])
def test_lasso_proofs(count):
    table, ref_table = tables.build_xor_table(zt.BabyBear, 3), ref_tables.build_xor_table(z.BabyBear, 3)
    picks = [int(i) for i in np.random.default_rng(count).integers(0, len(table), size=count)]
    queries, ref_queries = _lasso_queries(zt.BabyBear, table, picks), _lasso_queries(z.BabyBear, ref_table, picks)
    if count == 1:  # a single query pads to one evaluation: no variable to sum over, in both packages
        for prover, F, t, q in ((lasso.LassoProver, zt.BabyBear, table, queries),
                                (ref_lasso.LassoProver, z.BabyBear, ref_table, ref_queries)):
            with pytest.raises(ValueError, match="NoVariables"):
                prover.prove(F, t, q)
        return
    proof, ref_proof = lasso.LassoProver.prove(zt.BabyBear, table, queries), ref_lasso.LassoProver.prove(z.BabyBear, ref_table, ref_queries)
    assert proof.sumcheck_proof.to_bytes() == ref_proof.sumcheck_proof.to_bytes()
    assert (proof.query_commitment, proof.table_commitment, proof.num_lookups) == \
        (ref_proof.query_commitment, ref_proof.table_commitment, ref_proof.num_lookups)
    mapped = lasso.LassoProver.prove_with_mapping(zt.BabyBear, table, queries, picks)
    assert mapped.sumcheck_proof.to_bytes() == proof.sumcheck_proof.to_bytes()
    # The rounds verify against the queries' hypercube sum, and the shape check accepts.
    total = zt.BabyBear(sum(lasso.hash_entry_chain(zt.BabyBear, q.input_values(), q.output_values()).value
                            for q in queries) % P)
    ok, final_claim = zt.SumcheckVerifier.verify_rounds(zt.BabyBear, proof.sumcheck_proof, total)
    assert ok and final_claim.value == proof.sumcheck_proof.final_eval.value
    assert lasso.LassoVerifier.verify_fast(zt.BabyBear, proof, ref_proof.table_commitment, count,
                                           proof.sumcheck_proof.final_eval).is_valid
    # The reference's full verifier takes final_eval for the claimed sum: whatever it says, both say it.
    for check in ("verify", "verify_with_queries"):
        arg, ref_arg = (count, count) if check == "verify" else (queries, ref_queries)
        got = getattr(lasso.LassoVerifier, check)(zt.BabyBear, proof, table, arg)
        want = getattr(ref_lasso.LassoVerifier, check)(z.BabyBear, ref_proof, ref_table, ref_arg)
        assert (got.is_valid, got.reason) == (want.is_valid, want.reason)
    wrong = lasso.LassoVerifier.verify(zt.BabyBear, proof, table, count + 1)
    assert not wrong.is_valid and "lookups mismatch" in wrong.reason
    other = lasso.LassoVerifier.verify(zt.BabyBear, proof, tables.build_and_table(zt.BabyBear, 3), count)
    assert not other.is_valid and "Table commitment" in other.reason
    with pytest.raises(ValueError, match="QueryTableMismatch"):
        lasso.LassoProver.prove_with_mapping(zt.BabyBear, table, queries, [(i + 1) % len(table) for i in picks])


# -- isa/rv32i.py, guest/programs.py -------------------------------------------

def test_rv32i_decode_tables():
    assert rv32i._VALID_OPCODES == ref_rv32i._VALID_OPCODES and rv32i._FORMAT32 == ref_rv32i._FORMAT32
    rng = np.random.default_rng(6)
    words = [0x00000013, 0x00A00093, 0xFE000EE3, 0x0000006F, 0xFFFFF0B7, 0x00112623, 0x00100073,
             *(int(w) for w in rng.integers(0, 1 << 32, size=400, dtype=np.uint64))]
    decoded = 0
    for word in words:
        try:
            want = ref_rv32i.decode(word)
        except ref_rv32i.InvalidOpcode:
            with pytest.raises(rv32i.InvalidOpcode):
                rv32i.decode(word)
            continue
        got = rv32i.decode(word)
        decoded += 1
        for field in ("raw", "format", "opcode", "rd", "funct3", "rs1", "rs2", "funct7", "imm"):
            assert getattr(got, field) == getattr(want, field), (hex(word), field)
        assert (got.name(), got.encode()) == (want.name(), want.encode())
    assert decoded > 20


@pytest.mark.parametrize("guest, args", [("fibonacci_guest", ()), ("mul_stress_guest", ()), ("echo_guest", (3,)),
                                         ("sort_guest", ()), ("nop_guest", (17,))])
def test_guest_programs(guest, args):
    program = getattr(programs, guest)(*args)
    assert program == getattr(ref_programs, guest)(*args)
    assert program == getattr(programs, guest)(*args, base=0x1000) and len(program) % 4 == 0


def test_a_guest_program_runs_on_the_ports_vm():
    loaded, ref_loaded = zt.elf.load(programs.echo_guest(2)), z.elf.load(ref_programs.echo_guest(2))
    vm = zt.VMState.init_from_segments(loaded.segments, loaded.entry_pc, [11, 22])
    vm.run(1000)
    ref = z.VMState.init_from_segments(ref_loaded.segments, ref_loaded.entry_pc, [11, 22])
    ref.run(1000)
    assert list(vm.output_tape) == list(ref.output_tape) == [11, 22]


# -- commitments/host_forest.py ------------------------------------------------

@pytest.mark.parametrize("shape", [(9, 128), (4, 1), (43, 16)])
def test_host_forest(shape):
    if not (host_forest.available() and ref_host_forest.available()):
        pytest.skip("no native forest (needs a C++ compiler)")
    B, N = shape
    rng = np.random.default_rng(B + N)
    matrix = rng.integers(0, P, size=shape, dtype=np.uint64)
    forest, ref = host_forest.HostMerkleForest(zt.BabyBear, matrix), ref_host_forest.HostMerkleForest(z.BabyBear, matrix)
    device = DeviceMerkleForest(zt.BabyBear, lo=witness_dev.from_numpy(matrix.astype(np.uint32), "cpu"))
    assert forest.roots() == ref.roots() == device.roots()
    indices = rng.integers(0, N, size=B)
    for got, want, dev in zip(forest.open_all(indices), ref.open_all(indices), device.open_all(indices)):
        assert got.index == want.index == dev.index and got.value.value == want.value.value == dev.value.value
        assert got.path.siblings == want.path.siblings == dev.path.siblings
        assert got.path.directions == want.path.directions == dev.path.directions
    for i, opening in enumerate(forest.open_all(indices)):
        assert zt.SimpleMerkleTree.verify(zt.BabyBear, forest.roots()[i], opening)


# -- verifier/benchmarks.py ----------------------------------------------------

def test_verifier_benchmark_on_the_cpu(capsys):
    suite = benchmarks.BenchmarkSuite(verify_iters=1, device="cpu")
    results = suite.run(sizes=(16, 64))
    assert [r.num_steps for r in results] == [16, 64]
    ser = z.serialization.BinarySerializer(z.BabyBear)
    for r in results:  # the proof sizes of zigz_tpu's prover at the same sizes
        program = bytes([0x13, 0, 0, 0] * r.num_steps)
        ref = z.Prover(z.BabyBear, seed=0).prove(program, 0x1000, None, max(2 * r.num_steps, 1 << 10), None, None)
        assert r.proof_size_bytes == len(ser.serialize(ref))
        assert r.prove_s > 0 and r.verify_s > 0 and r.steps_per_s > 0
    assert suite.analyze_scaling()
    suite.print_results()
    assert "steps/s" in capsys.readouterr().out


def test_verifier_benchmark_defaults_to_the_card():
    suite = benchmarks.BenchmarkSuite()
    assert suite.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            suite.run(sizes=(16,))


# -- utils/profiling.py --------------------------------------------------------

def test_phase_timer():
    timer, ref = profiling.PhaseTimer(), ref_profiling.PhaseTimer()
    for t in (timer, ref):
        with t.phase("a"):
            pass
        with t.phase("b"):
            pass
        with t.phase("a"):
            pass
    assert list(timer.timings) == list(ref.timings) == ["a", "b"]
    assert [line.split()[0] for line in timer.report().splitlines()] == ["a", "b", "total"]


def test_device_trace_leaves_a_trace_file(tmp_path):
    log_dir = tmp_path / "trace"
    with profiling.device_trace(str(log_dir)) as prof:
        torch.arange(1 << 10).sum()
    trace = log_dir / profiling.TRACE_FILE
    assert trace.is_file() and trace.stat().st_size > 0
    assert any("sum" in ev.key for ev in prof.key_averages())
    with profiling.maybe_trace_env(None) as nothing:
        assert nothing is None
    with profiling.maybe_trace_env(str(tmp_path / "second")):
        torch.ones(4).sum()
    assert os.path.isfile(tmp_path / "second" / profiling.TRACE_FILE)
