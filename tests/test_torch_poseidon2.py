"""Port Poseidon2 (torch ops on canonical int64) == zigz_tpu's host Poseidon2
(core/poseidon2.py, the C++ sponge) == zigz_tpu's jnp Poseidon2
(ops/poseidon2.py on the CPU) == ``_hash_columns(..., "poseidon2")``.

Digests, roots and paths are bytes: tolerance zero.  Inputs from a numpy seed."""

import numpy as np
import pytest
import torch

import zigz_tpu  # noqa: F401  (installs the native hashing backend)
from zigz_tpu.commitments import ligero as ref_ligero
from zigz_tpu.commitments.device_forest import DeviceMerkleForest as JaxForest
from zigz_tpu.commitments.merkle import SimpleMerkleTree
from zigz_tpu.core import poseidon2 as ref_host
from zigz_tpu.core.field import BabyBear as F
from zigz_tpu.ops import poseidon2 as ref_dev
from zigz_tpu_torch import runtime as port_runtime
from zigz_tpu_torch.commitments import ligero as port_ligero
from zigz_tpu_torch.commitments import merkle as port_merkle
from zigz_tpu_torch.commitments.device_forest import DeviceMerkleForest
from zigz_tpu_torch.core import poseidon2 as port_host
from zigz_tpu_torch.ops import poseidon2 as p2

P = F.MODULUS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _canonical(shape, seed):
    vals = np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)
    flat = vals.reshape(-1)
    flat[: min(flat.size, 2)] = [0, P - 1][: min(flat.size, 2)]
    return vals


def _tensor(arr, dtype=torch.int64):
    return torch.from_numpy(arr.astype(np.int64)).to(dtype)


def test_constants_are_the_jax_packages():
    assert port_host._RC_EXTERNAL == ref_host._RC_EXTERNAL
    assert port_host._RC_INTERNAL == ref_host._RC_INTERNAL
    assert port_host._MU == ref_host._MU and port_host._M4 == ref_host._M4


@pytest.mark.parametrize("n", [1, 2, 37, 256])
def test_permutation_matches_host(n):
    state = _canonical((16, n), seed=n)
    got = p2.permute_device(_tensor(state))
    assert np.array_equal(got.numpy().astype(np.uint64), ref_host.np_permute(state.copy()))
    assert [int(x) for x in got[:, 0]] == ref_host.permute([int(x) for x in state[:, 0]])
    with pytest.raises(ValueError, match=r"\(16, N\) int64"):
        p2.permute_device(torch.zeros((8, 4), dtype=torch.int64))


@pytest.mark.parametrize("n", [1, 5, 64, 100])
def test_leaves_match_host_and_jax(n):
    vals = _canonical(n, seed=100 + n)
    got = p2.p2_leaves(_tensor(vals, torch.int32))
    assert got.dtype == torch.int32 and tuple(got.shape) == (8, n)
    blob = p2.limbs_to_bytes(got)
    assert blob == ref_host.np_batch_leaf_hashes(vals) == port_host.np_batch_leaf_hashes(vals)
    assert blob == ref_dev.limbs_to_bytes(ref_dev.p2_leaves(vals))
    assert blob[:32] == ref_host.hash_field_values([int(vals[0])])


@pytest.mark.parametrize("n", [2, 6, 64, 100])
def test_merge_matches_host_and_jax(n):
    limbs = _canonical((8, n), seed=200 + n)
    level = limbs.T.astype("<u4").tobytes()
    got = p2.limbs_to_bytes(p2.p2_merge(_tensor(limbs, torch.int32)))
    assert got == ref_host.np_batch_merge_hashes(level) == port_host.np_batch_merge_hashes(level)
    assert got == ref_dev.limbs_to_bytes(ref_dev.p2_merge(np.asarray(limbs, dtype=np.uint32)))
    assert got[:32] == ref_host.hash_two_digests(level[:32], level[32:64])
    with pytest.raises(ValueError, match="do not pair"):
        p2.p2_merge(torch.zeros((8, 3), dtype=torch.int32))


def test_hashes_in_chunks(monkeypatch):
    """A level longer than CHUNK is hashed piece by piece, pairs kept whole."""
    monkeypatch.setattr(p2, "CHUNK", 8)
    vals = _canonical(50, seed=7)
    leaves = p2.p2_leaves(_tensor(vals))
    assert p2.limbs_to_bytes(leaves) == ref_host.np_batch_leaf_hashes(vals)
    assert p2.limbs_to_bytes(p2.p2_merge(leaves)) == ref_host.np_batch_merge_hashes(ref_host.np_batch_leaf_hashes(vals))


@pytest.mark.parametrize("rows", [0, 1, 7, 8, 9, 13, 543, 544, 545, 1100])
def test_column_sponge_matches_hash_columns(rows):
    """Row counts that are no multiple of the rate 8, and more than one
    544-row stream block; the (16, n_e) state is carried across blocks."""
    n, n_e = 8, 64
    mat = _canonical((rows, n), seed=300 + rows)
    encoded = ref_ligero.ntt_pow2_u32(mat, n_e) if rows else np.zeros((0, n_e), dtype=np.uint32)
    want = ref_ligero._hash_columns(encoded, "poseidon2")
    got = p2.limbs_to_bytes(p2.p2_columns_stream(_tensor(mat, torch.int32), n_e))
    assert got == want == port_ligero._hash_columns(encoded, "poseidon2")
    if rows:  # one column against the scalar sponge
        assert got[32:64] == ref_host.hash_field_values([int(v) for v in encoded[:, 1]])


def test_host_column_hash_without_the_native_sponge(monkeypatch):
    """The numpy sponge behind ``_hash_columns`` (the verifier's path where
    the C++ runtime is missing) equals the native one."""
    encoded = _canonical((13, 16), seed=11).astype(np.uint32)
    native = port_ligero._hash_columns(encoded, "poseidon2")
    monkeypatch.setattr(port_runtime, "native_p2_matrix_columns", lambda m: None)
    assert port_ligero._hash_columns(encoded, "poseidon2") == native
    with pytest.raises(ValueError, match="unknown hash mode"):
        port_ligero._hash_columns(encoded, "blake3")


def test_native_entry_points_are_restored():
    vals = _canonical((3, 8), seed=5)
    assert port_runtime.native_p2_matrix_columns(vals) is not None
    level = ref_host.np_batch_leaf_hashes(vals.reshape(-1))
    assert port_runtime.native_p2_merge(level) == ref_host.np_batch_merge_hashes(level)


@pytest.mark.parametrize("shape", [(7, 64), (3, 1), (43, 16)])
def test_forest_poseidon2_matches_simple_merkle_tree_and_jax(shape):
    B, N = shape
    rng = np.random.default_rng(B * 1000 + N)
    matrix = rng.integers(0, P, size=shape, dtype=np.uint64)
    matrix[0, 0], matrix[-1, -1] = P - 1, 0
    port = DeviceMerkleForest(F, lo=_tensor(matrix, torch.int32), hash_mode="poseidon2")
    jax_forest = JaxForest(F, matrix, hash_mode="poseidon2")
    roots = port.roots()
    assert roots == jax_forest.roots()
    indices = rng.integers(0, N, size=B)
    openings, ref_openings = port.open_all(indices), jax_forest.open_all(indices)
    hasher = port_merkle.hasher_for_mode("poseidon2")
    for i in range(B):
        tree = SimpleMerkleTree.build(F, matrix[i], "poseidon2")
        assert port_merkle.SimpleMerkleTree.build(F, matrix[i], "poseidon2").get_root() == tree.get_root() == roots[i]
        for ref in (ref_openings[i], tree.open(int(indices[i]))):
            assert openings[i].index == ref.index and openings[i].value.value == ref.value.value
            assert openings[i].path.siblings == ref.path.siblings
            assert openings[i].path.directions == ref.path.directions
        assert port_merkle.SimpleMerkleTree.verify_at_index(F, roots[i], openings[i], port.height, hasher=hasher)
    with pytest.raises(ValueError, match="unknown hash mode"):
        DeviceMerkleForest(F, lo=_tensor(matrix, torch.int32), hash_mode="blake3")
