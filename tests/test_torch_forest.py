"""Port DeviceMerkleForest == zigz_tpu's DeviceMerkleForest == SimpleMerkleTree.

Roots, siblings, directions and leaf values are bytes and integers:
tolerance zero."""

import numpy as np
import pytest
import torch

import zigz_tpu  # noqa: F401  (installs the native hashing backend)
from zigz_tpu.commitments.device_forest import DeviceMerkleForest as JaxForest
from zigz_tpu.commitments.merkle import SimpleMerkleTree
from zigz_tpu.constraints.witness import WitnessGenerator
from zigz_tpu.core.field import BabyBear as F
from zigz_tpu.ops.witness_dev import build_witness_device
from zigz_tpu.runtime import native_vm
from zigz_tpu_torch.commitments.device_forest import DeviceMerkleForest
from zigz_tpu_torch.ops import witness_dev


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several pytest workers on a few cores: torch's own
    intra-op thread pool would oversubscribe them (tens of times slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _assert_same(port, jax_forest, matrix, indices):
    B = matrix.shape[0]
    roots = port.roots()
    assert roots == jax_forest.roots()
    openings = port.open_all(indices)
    ref_openings = jax_forest.open_all(indices)
    for i in range(B):
        tree = SimpleMerkleTree.build(F, matrix[i])
        assert roots[i] == tree.get_root()
        host_open = tree.open(int(indices[i]))
        for ref in (ref_openings[i], host_open):
            assert openings[i].index == ref.index
            assert openings[i].value.eql(ref.value)
            assert openings[i].path.siblings == ref.path.siblings
            assert openings[i].path.directions == ref.path.directions
        assert SimpleMerkleTree.verify(F, roots[i], openings[i])


@pytest.mark.parametrize("shape", [(7, 64), (3, 1)])
def test_forest_matches_jax_and_host(shape):
    B, N = shape
    rng = np.random.default_rng(B * 1000 + N)
    matrix = rng.integers(0, F.MODULUS, size=shape, dtype=np.uint64)
    matrix[0, 0], matrix[-1, -1] = F.MODULUS - 1, 0
    port = DeviceMerkleForest(F, lo=witness_dev.from_numpy(matrix.astype(np.uint32), "cpu"))
    assert port.height == N.bit_length() - 1
    indices = rng.integers(0, N, size=B)
    _assert_same(port, JaxForest(F, matrix), matrix, indices)


def test_single_leaf_tree_has_empty_path():
    matrix = np.array([[5], [0], [F.MODULUS - 1]], dtype=np.uint64)
    port = DeviceMerkleForest(F, lo=witness_dev.from_numpy(matrix.astype(np.uint32), "cpu"))
    assert port.height == 0
    for opening in port.open_all(np.zeros(3, dtype=np.int64)):
        assert opening.path.siblings == [] and opening.path.directions == []


def test_forest_of_the_jax_witness_carried_in():
    """(43, 2^10): a NOP trace's witness built by the JAX package, carried
    into the port with from_numpy, then both forests and their evals."""
    if not native_vm.available():
        pytest.skip("no native VM (needs a C++ compiler)")
    n = 1 << 10
    nvm = native_vm.NativeVM()
    nvm.load_segment(0x1000, bytes([0x13, 0, 0, 0] * n))
    trace = nvm.run(0x1000, 2 * n, None, None)["trace"]
    host = WitnessGenerator.generate(F, trace)
    assert host.matrix.shape == (43, n)
    jax_lo = build_witness_device(trace, trace.initial_regs, host.num_vars)
    port = DeviceMerkleForest(F, lo=witness_dev.from_numpy(np.asarray(jax_lo), "cpu"))
    jax_forest = JaxForest(F, lo=jax_lo)
    indices = np.random.default_rng(43).integers(0, n, size=43)
    _assert_same(port, jax_forest, host.matrix, indices)

    points = np.random.default_rng(44).integers(0, F.MODULUS, size=(43, 10), dtype=np.uint64)
    assert port.eval_backend(None, points).tolist() == np.asarray(jax_forest.eval_backend(None, points)).tolist()


@pytest.mark.parametrize(
    "lo",
    [
        torch.zeros((2, 6), dtype=torch.int32),  # not a power of two
        torch.zeros((2, 4), dtype=torch.int64),  # not int32
    ],
)
def test_forest_rejects_bad_witness(lo):
    with pytest.raises(ValueError):
        DeviceMerkleForest(F, lo=lo)


# -- the memory plan: levels freed, trees in groups ---------------------------
# (B, N) = (5, 64): the level widths of the whole forest are 320, 160, 80, ...

def _forced(monkeypatch, discard, group):
    """The same thresholds on both packages (the JAX forest also folds its
    top levels on the host below HOST_TOP_THRESHOLD)."""
    from zigz_tpu.commitments import device_forest as jax_df
    from zigz_tpu_torch.commitments import device_forest as port_df

    for df in (jax_df, port_df):
        monkeypatch.setattr(df, "DISCARD_DIGESTS", discard)
        monkeypatch.setattr(df, "GROUP_LEAF_DIGESTS", group)
    monkeypatch.setattr(jax_df, "HOST_TOP_THRESHOLD", 1 << 3)


@pytest.mark.parametrize("hash_mode", ["sha3", "poseidon2"])
@pytest.mark.parametrize(
    "discard, group, want_freed, want_group",
    [
        (1 << 9, 1 << 7, 0, 2),  # nothing freed, groups of 2, 2 and 1 trees
        (1 << 8, 1 << 7, 1, 2),  # the leaf level freed
        (1 << 6, 1 << 7, 3, 2),  # levels 0..2 freed
        (1 << 6, 1 << 9, 3, 5),  # freed, one group
        (1, 1 << 6, 6, 1),  # every level but the roots freed, one tree a group
    ],
)
def test_forest_memory_plan_matches_jax_and_host(monkeypatch, hash_mode, discard, group, want_freed, want_group):
    _forced(monkeypatch, discard, group)
    B, N = 5, 64
    rng = np.random.default_rng(discard * 7 + group)
    matrix = rng.integers(0, F.MODULUS, size=(B, N), dtype=np.uint64)
    matrix[0, 0], matrix[-1, -1] = F.MODULUS - 1, 0
    port = DeviceMerkleForest(F, lo=witness_dev.from_numpy(matrix.astype(np.uint32), "cpu"), hash_mode=hash_mode)
    assert (port.discarded, port.group_trees) == (want_freed, want_group)
    assert [lvl is None for lvl in port.levels] == [k < want_freed for k in range(7)]
    plan = port.plan()
    assert plan["groups"] == -(-B // want_group)
    assert plan["kept_bytes"] == 32 * sum((B * N) >> k for k in range(want_freed, 7))
    jax_forest = JaxForest(F, matrix, hash_mode=hash_mode)
    roots = port.roots()
    assert roots == jax_forest.roots()
    # every leaf of tree 0 once, so that both directions occur at every level
    for shift in (0, 21, 63):
        indices = (np.arange(B) * 13 + shift) % N
        openings = port.open_all(indices)
        ref_openings = jax_forest.open_all(indices)
        for i in range(B):
            tree = SimpleMerkleTree.build(F, matrix[i], hash_mode)
            assert roots[i] == tree.get_root()
            for ref in (ref_openings[i], tree.open(int(indices[i]))):
                assert openings[i].index == ref.index
                assert openings[i].value.eql(ref.value)
                assert openings[i].path.siblings == ref.path.siblings
                assert openings[i].path.directions == ref.path.directions


def test_shipped_plan_frees_nothing_up_to_2_22_steps():
    """The thresholds as shipped: one group and every level kept at 43 x 2^22,
    the leaf level freed at 2^23, groups of 16 trees and three levels freed at 2^25."""
    from zigz_tpu_torch.commitments import device_forest as port_df

    def plan(v):
        total = 43 << v
        grouped = total > port_df.GROUP_LEAF_DIGESTS
        return (port_df._forest_plan(total, v, port_df.DISCARD_DIGESTS),
                max(1, port_df.GROUP_LEAF_DIGESTS >> v) if grouped else 43)

    assert [plan(v) for v in (16, 20, 22, 23, 24, 25)] == [(0, 43), (0, 43), (0, 43), (1, 43), (2, 32), (3, 16)]
    assert port_df._forest_plan(43, 0, 1) == 0  # a one-leaf tree keeps its root


@pytest.mark.parametrize("name, tape", [("fibonacci", [10]), ("add", None)])
def test_v1_prove_under_a_forced_plan_equals_the_fixture(monkeypatch, name, tape):
    """The whole v1 prove with levels freed and trees in groups: the golden bytes."""
    import pathlib

    import zigz_tpu_torch as zt
    from zigz_tpu_torch.commitments import device_forest as port_df

    monkeypatch.setattr(port_df, "DISCARD_DIGESTS", 1 << 4)
    monkeypatch.setattr(port_df, "GROUP_LEAF_DIGESTS", 1 << 5)
    fixtures = pathlib.Path(__file__).resolve().parent / "fixtures"
    program = (fixtures / f"{name}_program.bin").read_bytes()
    entry, segments = 0x1000, None
    if zt.elf.is_elf(program):
        loaded = zt.elf.load(program)
        entry, segments = loaded.entry_pc, loaded.segments
    prover = zt.Prover(zt.BabyBear, seed=0, device="cpu")
    proof = prover.prove(program, entry, None, 1 << 16, segments, tape)
    plan = prover.last_timings["forest_plan"]
    assert plan["discarded_levels"] > 0 and plan["groups"] >= 3
    data = zt.serialization.BinarySerializer(zt.BabyBear).serialize(proof)
    assert data == (fixtures / f"{name}_v1.bin").read_bytes()
    assert zt.Verifier(zt.BabyBear).verify(proof, program) == "Accept"
