"""P2 and P3 on the CPU at the shapes that split unevenly: over the rate
(0, 1, 7, 8, 9 and 544 rows), over blocks and warps (1, 31, 33 and 255
columns; 1, 2, 127 and 129 parents) and over the trees of a tree-major
level.  csrc/poseidon2.cuh is built with ``g++ -O0`` through its host
entries (the bodies the kernels run: the permutation with its round loops
rolled, the merge that reads each child pair twice) and held with tolerance
zero (these are bytes) to the port's plain versions, zigz_tpu's jnp
``p2_merge`` (op by op under ``jax.disable_jit``, once for all shapes),
core/poseidon2.py and zigz_tpu's ``_hash_columns``.  No prove runs here;
tests/test_torch_poseidon2_kernels.py holds the rest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zigz_tpu.commitments import ligero as ref_ligero
from zigz_tpu.core import poseidon2 as ref_host
from zigz_tpu.ops import poseidon2 as ref_dev
from zigz_tpu_torch.ops import poseidon2 as p2

from test_torch_poseidon2_kernels import _canonical, _np_absorb, _one_torch_thread, _t, host  # noqa: F401

P = ref_host.P
ROWS = [0, 1, 7, 8, 9, 544]
COLUMNS = [1, 31, 33, 255]
PARENTS = {"1": 1, "2": 2, "127": 127, "129": 129, "3 trees of 64 leaves": 3 * 32}


def _level(name: str) -> np.ndarray:
    """(8, 2n) child limbs; the 3 trees' level is (8, 3, 64) flattened, as
    the forest hands a tree-major level to P2."""
    n = PARENTS[name]
    if name.endswith("leaves"):
        return _canonical((8, 3, 64), seed=70).reshape(8, -1)
    return _canonical((8, 2 * n), seed=60 + n)


@pytest.fixture(scope="module")
def jnp_merges():
    """zigz_tpu's jnp p2_merge of every level, side by side in one call."""
    levels = [_level(name) for name in PARENTS]
    with jax.disable_jit():
        merged = np.asarray(ref_dev.p2_merge(jnp.asarray(np.concatenate(levels, axis=1))), dtype=np.uint32)
    out, at = {}, 0
    for name, level in zip(PARENTS, levels):
        out[name] = merged[:, at : at + level.shape[1] // 2]
        at += level.shape[1] // 2
    return out


@pytest.mark.parametrize("name", list(PARENTS))
def test_merge_matches_plain_jnp_and_core(host, jnp_merges, name):
    level = _level(name)
    got = host.merge(level)
    assert got.shape == (8, level.shape[1] // 2)
    np.testing.assert_array_equal(got, p2._p2_merge_plain(_t(level)).numpy())
    np.testing.assert_array_equal(got, jnp_merges[name])
    assert got.T.astype("<u4").tobytes() == ref_host.np_batch_merge_hashes(level.T.astype("<u4").tobytes())


@pytest.mark.parametrize("columns", COLUMNS)
@pytest.mark.parametrize("rows", ROWS)
def test_absorb_from_a_carried_state_matches_plain_and_core(host, rows, columns):
    """A block of the column stream into a random carried state: the short
    last block adds to its first lanes only, no rows permutes once."""
    state = _canonical((16, columns), seed=80 + rows + 1000 * columns)
    msg = _canonical((rows, columns), seed=90 + rows + 1000 * columns)
    got = host.absorb(state, msg)
    np.testing.assert_array_equal(got, p2.p2_absorb(_t(state), _t(msg)).numpy())  # CPU tensor: the plain version
    np.testing.assert_array_equal(got, _np_absorb(state, msg))


@pytest.mark.parametrize("rows", ROWS)
def test_absorb_from_the_start_is_zigz_tpus_column_hash(host, rows):
    """From the sponge's start (the row count in lane 8) the absorb of all
    rows gives zigz_tpu's Poseidon2 column digests (33 columns)."""
    msg = _canonical((rows, 33), seed=100 + rows)
    start = np.zeros((16, 33), dtype=np.uint32)
    start[ref_host.RATE] = rows % P
    digests = host.absorb(start, msg)[:8]
    assert digests.T.astype("<u4").tobytes() == ref_ligero._hash_columns(msg, "poseidon2")
