"""N1 and N2, the Reed-Solomon row encode in CUDA (csrc/ntt_kernels.cu over
csrc/ntt.cuh), held on the CPU.

The header's extern "C" host entry ``zigz_ntt_encode_host``, built here by
g++ -O0, runs the launches of the card in their order: N1 on every (row,
tile), then each N2 pass over every (row, block), each block's register
passes and threads in turn, through the same per-thread steps the kernels
call.  It is held byte for byte to the port's plain
version (``ntt_dev._encode_rows_plain``), to zigz_tpu's host encoder
(``_ntt_pow2_numpy``) and to zigz_tpu's ``encode_rows_device`` (jnp on the
CPU), on the same numpy inputs made from a seed, with 0 and p - 1 among the
values: n_out in {2, 4, TILE / 2, TILE, 2 TILE, 8 TILE} x n in {1,
n_out / 8, n_out} x R in {0, 1, 3, 33}, the card's tile; smaller tiles put
more of the stages in N2.  The split between the kernels and N2's passes
is the header's (``zigz_ntt_passes``, which the wrapper reads from the
card's library); it is held here to 1 + ceil(max(0, log2 n_out - max(log2
TILE, log2 k)) / MAX_PASS) launches.  tests/test_torch_ntt_passes.py holds
the pass split and the shapes of two passes and more.  Field values are
integers: tolerance zero."""

import ctypes
import subprocess

import numpy as np
import pytest
import torch

from zigz_tpu.commitments.ligero import _ntt_pow2_numpy, _twiddles
from zigz_tpu.ops.ntt_dev import encode_rows_device
from zigz_tpu_torch.ops import _build, ntt_dev

P = 2013265921
TILE = 1 << 13  # csrc/ntt.cuh kTile (test_the_tile_is_the_headers)
MAX_PASS = 8  # csrc/ntt.cuh kMaxPassStages: N2's stages a launch at most
_U32 = ctypes.POINTER(ctypes.c_uint32)
_I64P = ctypes.POINTER(ctypes.c_int64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several pytest workers on a few cores: torch's own
    intra-op thread pool would oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def host_ntt(tmp_path_factory):
    """csrc/ntt.cuh built for the host: encode(mat, n_out, tile, max_pass) ->
    (status, out, N2 launches)."""
    build = tmp_path_factory.mktemp("ntt_host")
    src, lib_path = build / "ntt_host.cpp", build / "libntt_host.so"
    src.write_text('#include "ntt.cuh"\n')
    subprocess.run(["g++", "-O0", "-std=c++17", "-shared", "-fPIC", "-I", str(_build.CSRC), "-o", str(lib_path),
                    str(src)], check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(lib_path))
    lib.zigz_ntt_encode_host.argtypes = [_U32, _U32, _U32, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                                         ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
    lib.zigz_ntt_tile_host.restype = ctypes.c_int64
    lib.zigz_ntt_max_pass_host.restype = ctypes.c_int64
    lib.zigz_ntt_passes.argtypes = [ctypes.c_int64, ctypes.c_int64, _I64P, _I64P]

    def encode(mat, n_out, tile=TILE, max_pass=MAX_PASS):
        mat = np.ascontiguousarray(mat, dtype=np.uint32)
        tw = np.ascontiguousarray(ntt_dev._mont_twiddles_np(n_out).view(np.uint32))
        out = np.zeros((mat.shape[0], n_out), dtype=np.uint32)
        stages = ctypes.c_int64(-1)
        status = lib.zigz_ntt_encode_host(mat.ctypes.data_as(_U32), tw.ctypes.data_as(_U32), out.ctypes.data_as(_U32),
                                          mat.shape[0], mat.shape[1], n_out, tile, max_pass, ctypes.byref(stages))
        return status, out, stages.value

    def passes(n, n_out):
        """(status, N2's passes as ranges) of the header's plan."""
        bounds, count = (ctypes.c_int64 * 28)(), ctypes.c_int64(-1)
        status = lib.zigz_ntt_passes(n, n_out, bounds, ctypes.byref(count))
        return status, [range(bounds[i], bounds[i + 1]) for i in range(max(0, count.value))]

    encode.lib = lib
    encode.passes = passes
    return encode


def _coefficients(rows, n, seed):
    vals = np.random.default_rng(seed).integers(0, P, size=(rows, n), dtype=np.uint64)
    flat = vals.reshape(-1)
    flat[: min(flat.size, 2)] = [0, P - 1][: min(flat.size, 2)]
    flat[-1:] = P - 1
    return vals


def _n2_launches(n, n_out, tile=TILE, max_pass=MAX_PASS):
    """N2's launches: the stages from max(log2 tile, log2 k) up, at most
    max_pass a launch."""
    log_k = (n_out // n).bit_length() - 1
    return -(-max(0, n_out.bit_length() - 1 - max(tile.bit_length() - 1, log_k)) // max_pass)


def _widths():
    for n_out in (2, 4, TILE // 2, TILE, 2 * TILE, 8 * TILE):
        for n in sorted({1, max(1, n_out // 8), n_out}):
            yield n_out, n


@pytest.mark.parametrize("rows", [0, 1, 3, 33])
@pytest.mark.parametrize("n_out, n", list(_widths()))
def test_host_entry_equals_the_plain_version_and_zigz_tpu(host_ntt, n_out, n, rows):
    mat = _coefficients(rows, n, seed=n_out + 7 * n + rows)
    status, got, stages = host_ntt(mat, n_out)
    assert status == 0 and stages == _n2_launches(n, n_out)
    plain = ntt_dev._encode_rows_plain(torch.from_numpy(mat.astype(np.int64)), n_out)
    assert plain.dtype == torch.int32 and tuple(plain.shape) == (rows, n_out)
    want = _ntt_pow2_numpy(mat, n_out)
    assert np.array_equal(got.astype(np.uint64), want)
    assert np.array_equal(plain.numpy().view(np.uint32).astype(np.uint64), want)
    assert np.array_equal(np.asarray(encode_rows_device(mat, n_out), dtype=np.uint64), want)


@pytest.mark.parametrize("tile", [2, 8, 64, 512])
@pytest.mark.parametrize("n", [1, 2, 128, 1024])
def test_smaller_tiles_run_more_stages_in_n2(host_ntt, tile, n):
    """The split between the kernels is free: any tile gives the same bytes,
    N2 taking the stages from max(log2 tile, log2 k) up, in passes of at
    most 8."""
    n_out = 1024
    mat = _coefficients(5, n, seed=tile + n)
    status, got, stages = host_ntt(mat, n_out, tile=tile)
    assert status == 0 and stages == _n2_launches(n, n_out, tile)
    assert np.array_equal(got.astype(np.uint64), _ntt_pow2_numpy(mat, n_out))


def test_the_tile_is_the_headers(host_ntt):
    assert host_ntt.lib.zigz_ntt_tile_host() == TILE
    assert host_ntt.lib.zigz_ntt_max_pass_host() == MAX_PASS


@pytest.mark.parametrize("rows, n, n_out, tile", [
    (2, 3, 8, TILE), (2, 8, 4, TILE), (2, 1, 1, TILE), (2, 0, 8, TILE), (2, 4, 6, TILE), (-1, 4, 8, TILE),
    (1, 1, 1 << 28, TILE), (2, 4, 8, 1), (2, 4, 8, 3), (2, 4, 8, 2 * TILE)])
def test_refused_shapes(host_ntt, rows, n, n_out, tile):
    """The host entry refuses what the launchers refuse (status 1, as
    cudaErrorInvalidValue), before it reads or writes a value: n or n_out
    not a power of two, n > n_out, n_out < 2 or past 2^27, a negative row
    count, a tile outside [2, TILE]; ``encode_rows`` raises on the same
    shapes, and the plan's query refuses their n and n_out."""
    none = ctypes.cast(None, _U32)
    stages = ctypes.c_int64(-1)
    assert host_ntt.lib.zigz_ntt_encode_host(none, none, none, rows, n, n_out, tile, MAX_PASS,
                                             ctypes.byref(stages)) == 1
    if rows >= 0 and tile == TILE:
        assert host_ntt.passes(n, n_out)[0] == 1
        with pytest.raises(ValueError):
            ntt_dev.encode_rows(torch.zeros((rows, n), dtype=torch.int32), n_out)


@pytest.mark.parametrize("n_out", [2, 1 << 10, 1 << 19])
def test_twiddles_in_montgomery_form(n_out):
    """The kernels' table: every stage's twiddles end to end, x 2^32 mod p."""
    table = ntt_dev._mont_twiddles_np(n_out).astype(np.uint64)
    r_inv = pow(1 << 32, -1, P)
    assert table.shape == (n_out - 1,) and table.max() < P
    assert np.array_equal(table * np.uint64(r_inv) % np.uint64(P), np.concatenate(_twiddles(n_out)))


@pytest.mark.parametrize("n, n_out, stages", [
    (1 << 16, 1 << 19, range(13, 19)), (1 << 17, 1 << 20, range(13, 20)), (8, 64, range(6, 6)),
    (TILE, TILE, range(13, 13)), (1, 1 << 15, range(15, 15)), (2, 1 << 15, range(14, 15)),
    (TILE, 2 * TILE, range(13, 14))])
def test_n2_stages(host_ntt, n, n_out, stages):
    """N2's stages as the header's plan gives them (``zigz_ntt_passes``, the
    wrapper's ``n2_passes`` on the card): at most 8, so one launch, after
    N1's one, for a call with rows, none where N1 runs every stage."""
    status, passes = host_ntt.passes(n, n_out)
    assert status == 0 and passes == ([stages] if stages else [])


def test_no_rows_encode_to_no_rows():
    got = ntt_dev.encode_rows(torch.zeros((0, 16), dtype=torch.int32), 128)
    assert got.dtype == torch.int32 and tuple(got.shape) == (0, 128)
