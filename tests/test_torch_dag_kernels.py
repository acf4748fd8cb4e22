"""The zerocheck kernels' programs and plain versions on the CPU: the
round-sum kernel Z1's program (ops/symtrace.py ``compile_device``) and its
reference interpreter against ``compile_dag`` and zigz_tpu's
``compile_device``, ``dag_dev.round_sums`` against zigz_tpu's
``_round_sums``, and the fold kernel Z2's wrapper ``ext4_dev.fold_planes``
against zigz_tpu's ``ext_fold_dev`` / ``ext_fold_base_dev``.

The kernels themselves run only on a card (tests/test_torch_cuda.py,
chip_smoke.py phase 9b); Z1's generated body is held on the host in
tests/test_torch_dag_codegen.py.  Here every wrapper takes its plain
version, and the reference interpreter runs the kernel's steps in numpy:
Montgomery u32 values, u64 products, the column at each point formed where
it is read.

Inputs are made with numpy from fixed seeds; values are exact field
elements, compared whole (tolerance zero).  zigz_tpu's ``compile_device``
runs op by op here, at about 1.5 ms a node and output on the CPU (its jit
of the 14,399-node DAG of a v2 prove takes minutes), so it is held to the
real DAGs of up to 300 nodes and to the random ones; the reference and ``compile_dag`` are held to every
DAG of the proves (v3's in tests/test_torch_dag_kernels_v3.py)."""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from torch_dag_programs import P, check_program, jax_lanes, prove_dags, random_dags, random_planes
from zigz_tpu.ops import ext4_dev as ref_ext4_dev
from zigz_tpu.ops import zerocheck_dev_ext as ref_zerocheck_dev_ext
from zigz_tpu.ops.babybear import np_from_mont, np_to_mont
from zigz_tpu_torch.ops import dag_dev, ext4_dev, symtrace, zerocheck_dev_ext

JAX_NODES = 300  # the real DAGs zigz_tpu's compile_device is run on, by size


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several pytest workers on a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def dags(_one_torch_thread):
    """The DAGs of a v2 and a v4 prove (both traced: v4's differ in what
    the witness columns are committed under, not in a combiner)."""
    return {version: prove_dags(version) for version in (2, 4)}


def test_every_zerocheck_of_a_prove_gives_two_dags(dags):
    for version, found in dags.items():
        assert len(found) == 24, version  # 12 zerochecks x (round 0, later rounds)
        assert max(len(nodes) for _l, nodes, *_ in found) > 10_000  # the core argument's later rounds


@pytest.mark.parametrize("version", [2, 4])
def test_program_of_every_dag_matches_compile_dag(dags, version):
    """Every DAG of the prove: the encoded program, run step for step as the
    kernel runs it, equals compile_dag's torch ops lane by lane at t = 0 and
    the plain round sums at every point; and the generator takes it."""
    rng = np.random.default_rng(version)
    seen = set()
    for label, nodes, outs, row_of, degree, n_consts in dags[version]:
        key = (tuple(nodes), outs, tuple(sorted(row_of.items())))
        if key in seen:
            continue
        seen.add(key)
        planes = random_planes(rng, max(row_of.values()) + 1, 16)
        check_program(nodes, outs, row_of, degree, [int(x) for x in rng.integers(0, P, size=n_consts)], planes)


def test_small_real_dags_match_zigz_tpu_compile_device(dags):
    """The real DAGs of up to JAX_NODES nodes: zigz_tpu's jitted
    compile_device (Montgomery in, converted out) equals the program's
    reference and compile_dag."""
    rng = np.random.default_rng(7)
    seen, checked = set(), 0
    for label, nodes, outs, row_of, degree, n_consts in dags[2]:
        if len(nodes) > JAX_NODES or tuple(nodes) in seen:
            continue
        seen.add(tuple(nodes))
        consts = [int(x) for x in rng.integers(0, P, size=n_consts)]
        planes = random_planes(rng, max(row_of.values()) + 1, 8)
        program = symtrace.compile_device(nodes, outs, row_of)
        lanes, _sums = symtrace._run_program_reference(program, program.constants(consts), planes, 1)
        np.testing.assert_array_equal(jax_lanes(nodes, outs, row_of, consts, planes[:, :4]), lanes[0], label)
        checked += 1
    assert checked >= 3


def test_round_sums_match_zigz_tpu_round_sums(dags):
    """dag_dev.round_sums on the CPU == zigz_tpu's _round_sums over its
    jitted multi-output DAG, for the smallest real extension DAG."""
    label, nodes, outs, row_of, degree, n_consts = min(dags[2], key=lambda d: len(d[1]))
    rng = np.random.default_rng(11)
    consts = [int(x) for x in rng.integers(0, P, size=n_consts)]
    planes = random_planes(rng, max(row_of.values()) + 1, 32)
    dag = ref_zerocheck_dev_ext._compile_dag_multi((tuple(nodes), tuple(outs), ()), row_of)
    want = np_from_mont(np.asarray(ref_zerocheck_dev_ext._round_sums(
        dag, np_to_mont(planes), np_to_mont(np.asarray(consts, dtype=np.uint64)), degree))).astype(np.uint64)
    program = symtrace.compile_device(nodes, outs, row_of)
    got = dag_dev.round_sums(program, program.constants(consts), torch.from_numpy(planes.view(np.int64)), degree)
    assert got.shape == (degree, 4)
    np.testing.assert_array_equal(got.numpy().astype(np.uint64), want)


# -- random DAGs ---------------------------------------------------------------

@settings(max_examples=12, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(dag=random_dags(), seed=st.integers(0, 2**32 - 1), degree=st.integers(1, 5))
def test_random_dags_three_ways(dag, seed, degree):
    """Random DAGs: the reference interpreter, compile_dag (lanes and round
    sums) and zigz_tpu's compile_device agree; a one-output DAG also with an
    eq row, as the base-field zerocheck runs it."""
    nodes, outs, n_cols, n_consts = dag
    rng = np.random.default_rng(seed)
    row_of = {f"c{i}": i for i in range(n_cols)}
    consts = [int(x) for x in rng.integers(0, P, size=n_consts)]
    planes = random_planes(rng, n_cols + 1, 8)
    program, bound, _sums = check_program(nodes, outs, row_of, degree, consts, planes)
    lanes, _ = symtrace._run_program_reference(program, bound, planes, 1)
    np.testing.assert_array_equal(jax_lanes(nodes, outs, row_of, consts, planes[:, :4]), lanes[0])
    if len(outs) == 1:
        check_program(nodes, outs, row_of, degree, consts, planes, eq_row=n_cols)


def test_constant_only_nodes_fold_on_the_host():
    """A subexpression of constants alone is one table entry, computed on
    the host from this prove's constants; the program depends on the DAG
    only."""
    def combiner(cols, alphas, p):
        return (cols["x"] * (alphas[0] * alphas[1] + 3) + alphas[0]) % p

    traces = [symtrace.trace_combiner(combiner, ["x"], alphas, P) for alphas in ([2, 5], [7, 11])]
    programs = [symtrace.compile_device(t.nodes, [t.out], {"x": 0}) for t in traces]
    np.testing.assert_array_equal(programs[0].code, programs[1].code)
    assert programs[0].counts == {"mul": 1, "add": 1, "sub": 0, "row_reads": 1}
    assert programs[0].constants(traces[0].consts).table == [13, 2]
    assert programs[1].constants(traces[1].consts).table == [80, 7]


def test_slots_are_reused_after_their_last_use():
    """A chain needs one slot, whatever its length: each step reads the
    previous value and writes over it (columns are read where they are used)."""
    def chain(cols, alphas, p):
        acc = cols["x"]
        for _ in range(50):
            acc = (acc * cols["y"] + cols["x"]) % p
        return acc

    t = symtrace.trace_combiner(chain, ["x", "y"], [], P)
    program = symtrace.compile_device(t.nodes, [t.out], {"x": 0, "y": 1})
    assert len(program.code) == 100 and program.n_slots == 1


# -- the wrappers' checks --------------------------------------------------------

def _tiny_program():
    t = symtrace.trace_combiner(lambda c, a, p: (c["x"] * a[0]) % p, ["x"], [3], P)
    program = symtrace.compile_device(t.nodes, [t.out], {"x": 0})
    return program, program.constants(t.consts)


def test_round_sums_checks_its_inputs():
    program, consts = _tiny_program()
    planes = torch.zeros((1, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="int64"):
        dag_dev.round_sums(program, consts, planes.to(torch.int32), 2)
    with pytest.raises(ValueError, match="contiguous"):
        dag_dev.round_sums(program, consts, torch.zeros((8, 2), dtype=torch.int64).t(), 2)
    with pytest.raises(ValueError, match="even"):
        dag_dev.round_sums(program, consts, torch.zeros((1, 7), dtype=torch.int64), 2)
    with pytest.raises(ValueError, match="rows"):
        dag_dev.round_sums(program, consts, torch.zeros((0, 8), dtype=torch.int64), 2)
    with pytest.raises(ValueError, match="another program"):
        dag_dev.round_sums(program, _tiny_program()[1], planes, 2)
    with pytest.raises(ValueError, match="eq"):
        dag_dev.round_sums(program, consts, planes, 2, eq=3)
    with pytest.raises(ValueError, match="device"):
        dag_dev.round_sums(program, consts, planes.to("meta"), 2)
    before = dict(dag_dev.LAUNCHES)
    assert dag_dev.round_sums(program, consts, planes, 2).tolist() == [[0], [0]]
    assert dag_dev.LAUNCHES == before  # the plain version launches nothing


# -- Z2: the fold of a whole plane stack -------------------------------------------

def _r4(rng):
    return [int(x) for x in rng.integers(0, P, size=4)]


@pytest.mark.parametrize("B, E, width", [(3, 2, 16), (1, 0, 2), (0, 1, 8), (5, 3, 64)])
def test_fold_planes_matches_zigz_tpu_from_both_layouts(B, E, width):
    """fold_planes from the round-0 layout (B base rows, then E extension
    tables and eq coordinate-major) and from the all-extension layout, with
    the extension zerocheck's group tables (zerocheck_dev_ext.fold_groups),
    equals zigz_tpu's ext_fold_base_dev / ext_fold_dev table by table."""
    import jax.numpy as jnp

    rng = np.random.default_rng(B * 100 + E * 10 + width)
    G = B + E + 1
    half = width // 2
    r4 = _r4(rng)
    r4_m = jnp.asarray(np_to_mont(np.asarray(r4, dtype=np.uint64)))
    planes0 = random_planes(rng, B + 4 * (E + 1), width)
    first, ext = zerocheck_dev_ext.fold_groups(B, E)
    got = ext4_dev.fold_planes(torch.from_numpy(planes0.view(np.int64)), r4, first).numpy().astype(np.uint64)
    assert got.shape == (4 * G, half)
    want = [np_from_mont(np.asarray(ref_ext4_dev.ext_fold_base_dev(jnp.asarray(np_to_mont(planes0[i])), r4_m)))
            for i in range(B)]
    want += [np_from_mont(np.asarray(ref_ext4_dev.ext_fold_dev(
        jnp.asarray(np_to_mont(planes0[[B + e * (E + 1) + j for e in range(4)]])), r4_m))) for j in range(E + 1)]
    np.testing.assert_array_equal(got.reshape(4, G, half), np.stack(want, axis=1))

    planes1 = random_planes(rng, 4 * G, width)
    got = ext4_dev.fold_planes(torch.from_numpy(planes1.view(np.int64)), r4, ext).numpy().astype(np.uint64)
    want = np_from_mont(np.asarray(ref_ext4_dev.ext_fold_dev(
        jnp.asarray(np_to_mont(planes1.reshape(4, G, width))), r4_m)))
    np.testing.assert_array_equal(got.reshape(4, G, half), want)


def test_fold_planes_in_the_kernel_arithmetic():
    """Z2's steps in numpy: r and W r in Montgomery form, two canonical x
    Montgomery products a REDC, as csrc/zerocheck_kernels.cu computes them,
    equal the plain fold (extreme values among the inputs)."""
    rng = np.random.default_rng(5)
    planes = random_planes(rng, 5, 16)
    r4 = [P - 1, 0, 1, int(rng.integers(0, P))]
    groups = ext4_dev.FoldGroups([(0, 4, 0, 0, 0), (1, 0, 1, 2, 3)])
    plain = ext4_dev.fold_planes(torch.from_numpy(planes.view(np.int64)), r4, groups).numpy().astype(np.uint64)
    redc = symtrace._redc_np
    R = np.uint64((1 << 32) % P)
    r_m = [np.uint64(v) * R % np.uint64(P) for v in r4]
    wr_m = [np.uint64(11 * v % P) * R % np.uint64(P) for v in r4]
    lo, hi = planes[:, :8], planes[:, 8:]
    d = np.where(hi >= lo, hi - lo, hi + np.uint64(P) - lo)
    base = [(lo[4] + redc(d[4] * r_m[0])) % np.uint64(P)] + [redc(d[4] * r_m[e]) for e in range(1, 4)]
    ext = []
    for k in range(4):
        m = [r_m[k - i] if i <= k else wr_m[k - i + 4] for i in range(4)]
        a, b = redc(d[0] * m[0] + d[1] * m[1]), redc(d[2] * m[2] + d[3] * m[3])
        ext.append((lo[k] + (a + b) % np.uint64(P)) % np.uint64(P))
    np.testing.assert_array_equal(plain.reshape(4, 2, 8), np.stack([np.stack(base), np.stack(ext)], axis=1))


def test_fold_groups_and_fold_planes_check_their_inputs():
    with pytest.raises(ValueError, match="kind"):
        ext4_dev.FoldGroups([(2, 0, 0, 0, 0)])
    with pytest.raises(ValueError, match="negative"):
        ext4_dev.FoldGroups([(1, 0, 1, -1, 3)])
    with pytest.raises(ValueError, match=r"\(G, 5\)"):
        ext4_dev.FoldGroups([(0, 1)])
    groups = ext4_dev.FoldGroups([(1, 0, 1, 2, 3)])
    assert groups.n_rows == 4
    with pytest.raises(ValueError, match="rows"):
        ext4_dev.fold_planes(torch.zeros((3, 8), dtype=torch.int64), [1, 0, 0, 0], groups)
    with pytest.raises(ValueError, match="even"):
        ext4_dev.fold_planes(torch.zeros((4, 7), dtype=torch.int64), [1, 0, 0, 0], groups)
    with pytest.raises(ValueError, match="int64"):
        ext4_dev.fold_planes(torch.zeros((4, 8), dtype=torch.int32), [1, 0, 0, 0], groups)
    before = dict(ext4_dev.LAUNCHES)
    planes = torch.arange(32, dtype=torch.int64).reshape(4, 8)
    assert torch.equal(ext4_dev.fold_planes(planes, [1, 0, 0, 0], groups), planes[:, 4:])  # r = 1 takes hi
    assert ext4_dev.LAUNCHES == before
