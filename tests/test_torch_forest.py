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
