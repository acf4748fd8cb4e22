"""N2's passes: the split of the encode's global stages into launches of at
most 8 stages (csrc/ntt.cuh ``make_plan``, ``pass_first``), and the
encode where N2 takes two passes or more, held on the CPU.

The header's host entry ``zigz_ntt_encode_host`` (built by g++ -O0 in
tests/test_torch_ntt_kernel.py's ``host_ntt`` fixture) runs the card's
launches in their order with any tile and any pass width: N1 on every (row,
tile), then each N2 pass over every (row, block), each block's register
passes and threads in turn.  At tiles and pass widths that give N2 one to
fifteen passes, and at shapes of at most one tile, it is held byte for byte
to the port's plain version (``ntt_dev._encode_rows_plain``), to zigz_tpu's
host encoder (``_ntt_pow2_numpy``) and to zigz_tpu's ``encode_rows_device``
(jnp on the CPU), on the same numpy inputs made from a seed with 0 and
p - 1 among the values.  The card's pass list (``zigz_ntt_passes``, read by
the wrapper's ``n2_passes``) is held to stages written out here.  Field
values are integers: tolerance zero."""

import ctypes

import numpy as np
import pytest
import torch

from test_torch_ntt_kernel import MAX_PASS, TILE, _coefficients, _n2_launches, host_ntt  # noqa: F401  (fixture)
from zigz_tpu.commitments.ligero import _ntt_pow2_numpy
from zigz_tpu.ops.ntt_dev import encode_rows_device
from zigz_tpu_torch.ops import ntt_dev


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several pytest workers on a few cores: torch's own
    intra-op thread pool would oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# (rows, n, n_out, tile, max_pass) -> N2's passes, written out: the global
# stages [max(log2 tile, log2 k), log2 n_out) in as few passes of at most
# max_pass as they take, split as evenly as they go, the longer first.
_SHAPES = [
    ((3, 1, 1024, 2, 1), []),  # k = n_out: N1 broadcasts, no stage is live
    ((3, 2, 1024, 2, 1), [(9, 10)]),  # k = 2^9: N1 broadcasts, one global stage
    ((3, 1024, 1024, 2, 1), [(s, s + 1) for s in range(1, 10)]),  # nine passes of one stage
    ((3, 1024, 1024, 2, 3), [(1, 4), (4, 7), (7, 10)]),
    ((2, 64, 4096, 4, 4), [(6, 9), (9, 12)]),
    ((2, 4096, 4096, 16, 5), [(4, 8), (8, 12)]),
    ((2, 1 << 14, 1 << 14, 32, 8), [(5, 10), (10, 14)]),
    ((1, 1 << 12, 1 << 16, 8, 8), [(4, 10), (10, 16)]),
    ((1, 1 << 16, 1 << 16, 2, 8), [(1, 9), (9, 16)]),
    ((1, 1 << 15, 1 << 16, 2, 4), [(1, 5), (5, 9), (9, 13), (13, 16)]),
    ((1, 1 << 16, 1 << 16, 2, 1), [(s, s + 1) for s in range(1, 16)]),  # fifteen passes
    ((33, 16, 128, 2, 2), [(3, 5), (5, 7)]),
    ((1, 1 << 16, 1 << 19, TILE, MAX_PASS), [(13, 19)]),  # the card's main shapes: N1 and N2 at fixed shapes
    ((1, 1 << 17, 1 << 20, TILE, MAX_PASS), [(13, 20)]),
    ((1, 1 << 14, 1 << 17, TILE, 2), [(13, 15), (15, 17)]),  # the card's tile
    ((1, 1 << 17, 1 << 17, TILE, 3), [(13, 15), (15, 17)]),
    ((2, 2, 1 << 15, TILE, MAX_PASS), [(14, 15)]),  # N1 a broadcast: k = 2^14 > TILE
    ((3, 16, 256, TILE, MAX_PASS), []),  # at most one tile: N1 alone
    ((3, 256, 256, 512, 1), []),
    ((5, 1, 8, 8, MAX_PASS), []),
    ((0, 4, 64, 2, 2), [(4, 6)]),  # no rows: nothing to encode, the plan as for rows
]


@pytest.mark.parametrize("shape, want", _SHAPES, ids=lambda x: "-".join(map(str, x)) if len(x) == 5 else None)
def test_passes_equal_the_plain_version_and_zigz_tpu(host_ntt, shape, want):
    rows, n, n_out, tile, max_pass = shape
    mat = _coefficients(rows, n, seed=sum(shape))
    status, got, launches = host_ntt(mat, n_out, tile=tile, max_pass=max_pass)
    assert status == 0 and launches == len(want) == _n2_launches(n, n_out, tile, max_pass)
    ref = _ntt_pow2_numpy(mat, n_out)
    assert np.array_equal(got.astype(np.uint64), ref)
    plain = ntt_dev._encode_rows_plain(torch.from_numpy(mat.astype(np.int64)), n_out)
    assert np.array_equal(plain.numpy().view(np.uint32).astype(np.uint64), ref)
    assert np.array_equal(np.asarray(encode_rows_device(mat, n_out), dtype=np.uint64), ref)


# N2's passes on the card (the tile 2^13, at most 8 stages a pass), written
# out for the main path's shapes, the largest subgroup and the edges.
@pytest.mark.parametrize("n, n_out, want", [
    (1 << 16, 1 << 19, [(13, 19)]),  # the v2-v4 2^20 commits' stream blocks: one pass of 6
    (1 << 17, 1 << 20, [(13, 20)]),  # the same at 2^22 steps: one pass of 7
    (1 << 13, 1 << 16, [(13, 16)]),
    (1 << 12, 1 << 21, [(13, 21)]),  # eight stages: still one pass
    (1 << 12, 1 << 22, [(13, 18), (18, 22)]),  # nine: 5 + 4
    (1 << 20, 1 << 22, [(13, 18), (18, 22)]),
    (1 << 14, 1 << 27, [(13, 20), (20, 27)]),  # the largest subgroup: 7 + 7
    (1 << 27, 1 << 27, [(13, 20), (20, 27)]),
    (1 << 8, 1 << 27, [(19, 27)]),  # k = 2^19: one pass of 8 after a broadcast
    (1, 1 << 27, []),
    (1 << 13, 1 << 13, []),
    (2, 2, []),
])
def test_the_cards_pass_list(host_ntt, n, n_out, want):
    status, passes = host_ntt.passes(n, n_out)
    assert status == 0 and passes == [range(a, b) for a, b in want]
    assert len(passes) == _n2_launches(n, n_out)


@pytest.mark.parametrize("max_pass", [0, -1, MAX_PASS + 1])
def test_refused_pass_widths(host_ntt, max_pass):
    """A pass of no stage, or of more than the 8 that 32 x 2^8 words of
    shared memory hold, is refused (status 1) before a value is read."""
    none = ctypes.cast(None, ctypes.POINTER(ctypes.c_uint32))
    launches = ctypes.c_int64(-1)
    assert host_ntt.lib.zigz_ntt_encode_host(none, none, none, 2, 4, 64, 2, max_pass, ctypes.byref(launches)) == 1
    assert launches.value == -1
