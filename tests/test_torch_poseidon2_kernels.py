"""The Poseidon2 kernels' own arithmetic on the CPU: csrc/poseidon2.cuh
(P0 the permutation, P1 leaves, P2 merges, P3 the column sponge's absorb)
built with ``g++ -O0`` as plain C++ through its host entries, held to three
references with tolerance zero (these are bytes):

* the port's plain versions (ops/poseidon2.py ``_permute_plain``,
  ``_p2_leaves_plain``, ``_p2_merge_plain``, ``_p2_absorb_plain``);
* zigz_tpu's jnp Poseidon2 on the CPU (ops/poseidon2.py ``permute_device``,
  ``p2_leaves``, ``p2_merge``), op by op under ``jax.disable_jit`` (its jit
  of one shape takes about 15 s of XLA compile on the CPU), once for all
  sizes;
* zigz_tpu's core/poseidon2.py (``np_permute``, ``np_batch_leaf_hashes``,
  ``np_batch_merge_hashes``) and ``_hash_columns(..., "poseidon2")``.

Also: the constants the wrappers pass to the kernels are zigz_tpu's
Montgomery constants, and a v3 prove at 2^10 steps through the wrappers on
the CPU equals its pin and launches no kernel.  Inputs come from numpy seeds,
with 0 and p - 1 in every case.
"""

import ctypes
import hashlib
import json
import pathlib
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zigz_tpu.commitments import ligero as ref_ligero
from zigz_tpu.core import poseidon2 as ref_host
from zigz_tpu.ops import poseidon2 as ref_dev
from zigz_tpu.ops.babybear import np_from_mont, np_to_mont
import zigz_tpu_torch as zt
from zigz_tpu_torch.ops import _build
from zigz_tpu_torch.ops import poseidon2 as p2

P = ref_host.P
SIZES = [1, 2, 37, 255]  # hashes, or parents of a merge
ROWS = [0, 1, 7, 8, 9, 543, 544, 545]  # message rows of an absorb
COLUMNS = 37
PINNED = json.loads((pathlib.Path(__file__).resolve().parent.parent / "zigz_tpu_torch" / "testdata"
                     / "proof_digests.json").read_text())["proofs"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _canonical(shape, seed) -> np.ndarray:
    """Random canonical uint32, its first two entries 0 and p - 1."""
    vals = np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64).astype(np.uint32)
    flat = vals.reshape(-1)
    flat[: min(flat.size, 2)] = [0, P - 1][: min(flat.size, 2)]
    return vals


def _t(arr: np.ndarray, dtype=torch.int32) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr).astype(np.int64)).to(dtype)


_U32 = ctypes.POINTER(ctypes.c_uint32)


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(_U32)


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """csrc/poseidon2.cuh built for the host (its extern "C" entries)."""
    build = tmp_path_factory.mktemp("poseidon2_host")
    src, lib_path = build / "poseidon2_host.cpp", build / "libposeidon2_host.so"
    src.write_text('#include "poseidon2.cuh"\n')
    subprocess.run(["g++", "-O0", "-std=c++17", "-shared", "-fPIC", "-I", str(_build.CSRC), "-o", str(lib_path),
                    str(src)], check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(lib_path))
    lib.zigz_p2_permute_host.argtypes = [_U32, ctypes.c_int64, _U32]
    lib.zigz_p2_leaves_host.argtypes = [_U32, _U32, ctypes.c_int64, _U32]
    lib.zigz_p2_merge_host.argtypes = [_U32, _U32, ctypes.c_int64, _U32]
    lib.zigz_p2_absorb_host.argtypes = [_U32, _U32, ctypes.c_int64, ctypes.c_int64, _U32]
    consts = np.ascontiguousarray(p2.kernel_constants())

    class Host:
        @staticmethod
        def permute(states):
            out = np.ascontiguousarray(states, dtype=np.uint32).copy()
            lib.zigz_p2_permute_host(_ptr(out), out.shape[1], _ptr(consts))
            return out

        @staticmethod
        def leaves(values):
            values = np.ascontiguousarray(values, dtype=np.uint32)
            out = np.empty((8, values.size), dtype=np.uint32)
            lib.zigz_p2_leaves_host(_ptr(values), _ptr(out), values.size, _ptr(consts))
            return out

        @staticmethod
        def merge(level):
            level = np.ascontiguousarray(level, dtype=np.uint32)
            out = np.empty((8, level.shape[1] // 2), dtype=np.uint32)
            lib.zigz_p2_merge_host(_ptr(level), _ptr(out), out.shape[1], _ptr(consts))
            return out

        @staticmethod
        def absorb(state, msg):
            out = np.ascontiguousarray(state, dtype=np.uint32).copy()
            msg = np.ascontiguousarray(msg, dtype=np.uint32)
            lib.zigz_p2_absorb_host(_ptr(out), _ptr(msg), msg.shape[0], out.shape[1], _ptr(consts))
            return out

    return Host


def _states(n):
    return _canonical((16, n), seed=10 + n)


def _leaf_values(n):
    return _canonical(n, seed=20 + n)


def _merge_level(n):
    """(8, 2n) limbs: n parents' children."""
    return _canonical((8, 2 * n), seed=30 + n)


@pytest.fixture(scope="module")
def jnp_refs():
    """zigz_tpu's jnp permute_device, p2_leaves and p2_merge of every size's
    inputs, each called once over all sizes side by side, op by op."""
    states = np.concatenate([_states(n) for n in SIZES], axis=1)
    values = np.concatenate([_leaf_values(n) for n in SIZES])
    level = np.concatenate([_merge_level(n) for n in SIZES], axis=1)  # every size's width is even
    with jax.disable_jit():
        permuted = ref_dev.permute_device([jnp.asarray(np_to_mont(states[i])) for i in range(16)])
        permuted = np.stack([np_from_mont(np.asarray(lane)) for lane in permuted])
        leaves = np.asarray(ref_dev.p2_leaves(values.astype(np.uint64)), dtype=np.uint32)
        merged = np.asarray(ref_dev.p2_merge(jnp.asarray(level)), dtype=np.uint32)
    refs, at = {}, 0
    for n in SIZES:
        refs[n] = dict(permute=permuted[:, at : at + n], leaves=leaves[:, at : at + n],
                       merge=merged[:, at : at + n])
        at += n
    return refs


def test_kernel_constants_are_zigz_tpus_montgomery_constants():
    """The 157 u32 passed to every launch: zigz_tpu's Montgomery tables of
    the same core/poseidon2.py constants, in the header's order."""
    got = p2.kernel_constants()
    want = np.concatenate([ref_dev._RC_EXT_NP, ref_dev._RC_INT_NP, ref_dev._MU_NP])
    assert got.dtype == np.uint32 and got.shape == (157,)
    np.testing.assert_array_equal(got, want)
    # and back out of Montgomery form, core/poseidon2.py's own lists
    np.testing.assert_array_equal(np_from_mont(got), [*ref_host._RC_EXTERNAL, *ref_host._RC_INTERNAL,
                                                      *ref_host._MU])


@pytest.mark.parametrize("n", SIZES)
def test_permutation_matches_plain_jnp_and_core(host, jnp_refs, n):
    states = _states(n)
    got = host.permute(states)
    np.testing.assert_array_equal(got, p2._permute_plain(_t(states, torch.int64)).numpy())
    np.testing.assert_array_equal(got, jnp_refs[n]["permute"])
    np.testing.assert_array_equal(got, ref_host.np_permute(states.astype(np.uint64)))
    assert [int(x) for x in got[:, -1]] == ref_host.permute([int(x) for x in states[:, -1]])


@pytest.mark.parametrize("n", SIZES)
def test_leaves_match_plain_jnp_and_core(host, jnp_refs, n):
    values = _leaf_values(n)
    got = host.leaves(values)
    np.testing.assert_array_equal(got, p2._p2_leaves_plain(_t(values)).numpy())
    np.testing.assert_array_equal(got, jnp_refs[n]["leaves"])
    blob = got.T.astype("<u4").tobytes()
    assert blob == ref_host.np_batch_leaf_hashes(values.astype(np.uint64))
    assert blob[-32:] == ref_host.hash_field_values([int(values[-1])])


@pytest.mark.parametrize("n", SIZES)
def test_merge_matches_plain_jnp_and_core(host, jnp_refs, n):
    level = _merge_level(n)
    got = host.merge(level)
    np.testing.assert_array_equal(got, p2._p2_merge_plain(_t(level)).numpy())
    np.testing.assert_array_equal(got, jnp_refs[n]["merge"])
    blob = got.T.astype("<u4").tobytes()
    children = level.T.astype("<u4").tobytes()
    assert blob == ref_host.np_batch_merge_hashes(children)
    assert blob[-32:] == ref_host.hash_two_digests(children[-64:-32], children[-32:])


def _np_absorb(state: np.ndarray, msg: np.ndarray) -> np.ndarray:
    """core/poseidon2.py's sponge steps over a carried state."""
    s = state.astype(np.uint64)
    for off in range(0, max(msg.shape[0], 1), ref_host.RATE):
        block = msg[off : off + ref_host.RATE].astype(np.uint64)
        s[: block.shape[0]] = (s[: block.shape[0]] + block) % np.uint64(P)
        s = ref_host.np_permute(s)
    return s.astype(np.uint32)


@pytest.mark.parametrize("rows", ROWS)
def test_absorb_matches_plain_hash_columns_and_core(host, rows):
    """From the sponge's start (the row count in lane 8) the absorb of all
    rows is ``_hash_columns``; from a random carried state it is
    core/poseidon2.py's sponge steps.  Row counts below, at and past the
    rate and the 544-row stream block; no rows permutes the bare state once."""
    msg = _canonical((rows, COLUMNS), seed=40 + rows)
    start = np.zeros((16, COLUMNS), dtype=np.uint32)
    start[ref_host.RATE] = rows % P
    carried = _canonical((16, COLUMNS), seed=50 + rows)
    for state in (start, carried):
        got = host.absorb(state, msg)
        plain = p2.p2_absorb(_t(state), _t(msg))  # the wrapper on a CPU tensor: the plain version
        np.testing.assert_array_equal(got, plain.numpy())
        np.testing.assert_array_equal(got, _np_absorb(state, msg))
    digests = host.absorb(start, msg)[:8].T.astype("<u4").tobytes()
    assert digests == ref_ligero._hash_columns(msg, "poseidon2")
    if rows == 0:
        np.testing.assert_array_equal(host.absorb(carried, msg), host.permute(carried))


def test_wrappers_check_their_arguments():
    state = torch.zeros((16, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match=r"\(16, n\) int32 state"):
        p2.p2_absorb(state.to(torch.int64), torch.zeros((1, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match=r"\(rows, 4\) int32 message"):
        p2.p2_absorb(state, torch.zeros((1, 5), dtype=torch.int32))
    with pytest.raises(ValueError, match="do not pair"):
        p2.p2_merge(torch.zeros((8, 3), dtype=torch.int32))
    with pytest.raises(ValueError, match=r"\(N,\) int32/int64"):
        p2.p2_leaves(torch.zeros((2, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match="unsupported device"):
        p2.p2_leaves(torch.zeros(2, dtype=torch.int32, device="meta"))


def test_v3_prove_through_the_wrappers_on_the_cpu_equals_its_pin():
    """The v3 forest and both column sponges go through the wrappers: on
    the CPU their plain versions, and no kernel launch."""
    case = PINNED["v3-nop-2^10"]
    before = dict(p2.LAUNCHES)
    p2.PERMUTATIONS["count"] = 0
    prover = zt.Prover(zt.BabyBear, seed=0, device="cpu", protocol_version=3)
    program = bytes([0x13, 0, 0, 0]) * case["program"]["count"]
    proof = prover.prove(program, 0x1000, None, case["max_steps"], None, None)
    data = zt.serialization.BinarySerializer(zt.BabyBear).serialize(proof)
    assert (proof.metadata.num_steps, len(data), hashlib.sha256(data).hexdigest()) == (
        case["num_steps"], case["bytes"], case["sha256"])
    assert p2.LAUNCHES == before and p2.PERMUTATIONS["count"] > 0
