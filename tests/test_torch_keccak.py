"""Port SHA3 (plain versions of K1/K2) == zigz_tpu's Keccak == hashlib.

On the CPU the port's wrappers take their plain PyTorch versions and the
JAX package takes its jnp fallback.  Digests are bytes: tolerance zero."""

import hashlib

import numpy as np
import pytest
import torch

from zigz_tpu.ops import keccak as jax_keccak
from zigz_tpu_torch.ops import keccak

P = 2013265921
EDGE = [0, P - 1, (1 << 64) - 1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several pytest workers on a few cores: torch's own
    intra-op thread pool would oversubscribe them (tens of times slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _values(n, seed):
    vals = np.random.default_rng(seed).integers(0, 1 << 64, size=n, dtype=np.uint64)
    vals[: min(n, len(EDGE))] = EDGE[: min(n, len(EDGE))]
    return vals


def _as_tensor(vals_u64):
    return torch.from_numpy(np.ascontiguousarray(vals_u64).view(np.int64))


@pytest.mark.parametrize("n", [1, 3, 4097])
def test_sha3_leaves_plain_matches_jax_and_hashlib(n):
    vals = _values(n, seed=n)
    port = keccak.digests_to_bytes(keccak.sha3_leaves(_as_tensor(vals)))
    lo = (vals & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (vals >> np.uint64(32)).astype(np.uint32)
    ref = jax_keccak.digests_to_bytes(jax_keccak.sha3_leaves_device(lo, hi))
    assert port == ref
    for i in {0, 1, 2, n // 2, n - 1} & set(range(n)):
        expected = hashlib.sha3_256(int(vals[i]).to_bytes(8, "little")).digest()
        assert port[i * 32 : (i + 1) * 32] == expected, i


@pytest.mark.parametrize("n", [1, 3, 4097])
def test_sha3_merge_plain_matches_jax_and_hashlib(n):
    leaves = keccak.sha3_leaves(_as_tensor(_values(2 * n, seed=100 + n)))  # (2n, 4)
    port = keccak.digests_to_bytes(keccak.sha3_merge(leaves.view(n, 8)))
    child_bytes = keccak.digests_to_bytes(leaves)
    # zigz_tpu's adjacent-pair merge takes (8, 2n) uint32 digest words.
    words = np.frombuffer(child_bytes, dtype="<u4").reshape(2 * n, 8).T.copy()
    ref = jax_keccak.digests_to_bytes(jax_keccak.sha3_merge(words))
    assert port == ref
    for i in {0, 1, n // 2, n - 1} & set(range(n)):
        expected = hashlib.sha3_256(child_bytes[i * 64 : (i + 1) * 64]).digest()
        assert port[i * 32 : (i + 1) * 32] == expected, i


def test_digest_row_is_hashlib_bytes():
    vals = _values(5, seed=7)
    digests = keccak.sha3_leaves(_as_tensor(vals))
    assert digests.shape == (5, 4) and digests.dtype == torch.int64
    for i, v in enumerate(vals):
        row = digests[i].view(torch.uint8).numpy().tobytes()
        assert row == hashlib.sha3_256(int(v).to_bytes(8, "little")).digest()


def test_plain_versions_do_not_count_launches():
    before = dict(keccak.LAUNCHES)
    leaves = keccak.sha3_leaves(_as_tensor(_values(4, seed=3)))
    keccak.sha3_merge(leaves.view(2, 8))
    assert keccak.LAUNCHES == before


@pytest.mark.parametrize(
    "fn, bad",
    [
        (keccak.sha3_leaves, torch.zeros(4, dtype=torch.int32)),
        (keccak.sha3_leaves, torch.zeros(4, 2, dtype=torch.int64)),
        (keccak.sha3_merge, torch.zeros(4, 4, dtype=torch.int64)),
        (keccak.sha3_merge, torch.zeros(8, 4, dtype=torch.int64).t()),
        (keccak.sha3_leaves, torch.zeros(4, dtype=torch.int64, device="meta")),
    ],
)
def test_wrappers_reject_what_the_kernels_do_not_take(fn, bad):
    with pytest.raises((TypeError, ValueError)):
        fn(bad)
