"""Protocol v1 over the two 64-bit fields, Goldilocks and Mersenne61, as
zigz_tpu proves them.

The port's v1 proofs over both fields are byte-identical to zigz_tpu's (its
host path on the CPU, where its evaluations are object-dtype integers),
on the native and on the Python VM, and Accept under both verifiers,
crossing as serialized bytes.  The programs include the wide-value guest of
tests/torch_wide_guest.py, whose witness rows hold values of p and above
and of 2^63 and above; it runs over the four fields below 2^31 too.  Below
the prove: the u64 device witness against ``WitnessGenerator`` row by row,
the plain version of kernel E1 and the batched evaluation against zigz_tpu's
``Multilinear``, and E1's own arithmetic (csrc/field64.cuh, built with g++
through its host entry) against the plain version.  Integers throughout:
tolerance zero.
"""

import ctypes
import json
import subprocess

import numpy as np
import pytest
import torch

from zigz_tpu import elf
from zigz_tpu.constraints.witness import WitnessGenerator
from zigz_tpu.core import field as ref_field
from zigz_tpu.poly.multilinear import Multilinear
from zigz_tpu.prover.proof import VerificationResult
from zigz_tpu.prover.prover import Prover as ReferenceProver
from zigz_tpu.prover.serialization import BinarySerializer
from zigz_tpu.runtime import native_vm
from zigz_tpu.verifier.verifier import Verifier
import zigz_tpu_torch as zt
from zigz_tpu_torch.core import field as port_field
from zigz_tpu_torch.guest.asm import Assembler
from zigz_tpu_torch.ops import _build, field64, mle, witness_dev

import torch_wide_guest
from test_torch_prover import FIXTURES
from torch_witness_cases import EDGE_CASES

WIDE = ("Goldilocks", "Mersenne61")
NARROW = ("BabyBear", "KoalaBear", "Mersenne31", "F17")
PROGRAMS = {
    "add": lambda: ((FIXTURES / "add_program.bin").read_bytes(), 0x1000, None, None),
    "nop4": lambda: ((FIXTURES / "nop4_program.bin").read_bytes(), 0x1000, None, None),
    "fibonacci": lambda: _elf((FIXTURES / "fibonacci_program.bin").read_bytes(), [10]),
    "nop-2^10": lambda: (bytes([0x13, 0x00, 0x00, 0x00] * (1 << 10)), 0x1000, None, None),
    "wide-values": lambda: (torch_wide_guest.program(), torch_wide_guest.ENTRY, None, None),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several pytest workers share a few cores: one torch thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _reference_host_path(monkeypatch):
    monkeypatch.setenv("ZIGZ_TPU_COMMITMENTS", "host")


def _elf(program, tape):
    loaded = elf.load(program)
    return program, loaded.entry_pc, loaded.segments, tape


def _prove_both(field_name, program_name, use_native_vm):
    """(port bytes, zigz_tpu bytes, program) of one v1 prove in each package."""
    F, PF = getattr(ref_field, field_name), getattr(port_field, field_name)
    program, entry, segments, tape = PROGRAMS[program_name]()
    ref = ReferenceProver(F, seed=0).prove(program, entry, None, 1 << 16, segments, tape)
    port = zt.Prover(PF, seed=0, device="cpu", use_native_vm=use_native_vm)
    data = zt.serialization.BinarySerializer(PF).serialize(port.prove(program, entry, None, 1 << 16, segments, tape))
    assert "forest_s" in port.last_timings  # the device forest, on the CPU tensors' plain kernels
    return data, BinarySerializer(F).serialize(ref), program


def _accepted_by_both(field_name, data, program):
    F, PF = getattr(ref_field, field_name), getattr(port_field, field_name)
    assert Verifier(F).verify(BinarySerializer(F).deserialize(data), program) == VerificationResult.Accept
    assert zt.Verifier(PF).verify(zt.serialization.BinarySerializer(PF).deserialize(data), program) == "Accept"


# -- (a), (b): the native VM; (c) the Python VM ---------------------------------


@pytest.mark.parametrize("program_name", sorted(PROGRAMS))
@pytest.mark.parametrize("field_name", WIDE)
def test_v1_proof_matches_zigz_tpu(field_name, program_name):
    if not native_vm.available():
        pytest.skip("no native VM (needs a C++ compiler)")
    data, ref, program = _prove_both(field_name, program_name, use_native_vm=True)
    assert data == ref
    _accepted_by_both(field_name, data, program)


@pytest.mark.parametrize("program_name", sorted(PROGRAMS))
@pytest.mark.parametrize("field_name", WIDE)
def test_v1_proof_on_the_python_vm_matches_zigz_tpu(field_name, program_name):
    """The Python interpreter's trace uploads the host witness matrix
    (``witness_dev.from_numpy`` of canonical uint64, no u32 cut)."""
    data, ref, program = _prove_both(field_name, program_name, use_native_vm=False)
    assert data == ref
    _accepted_by_both(field_name, data, program)


@pytest.mark.parametrize("field_name", NARROW)
def test_wide_value_guest_below_2_31_matches_zigz_tpu(field_name):
    data, ref, program = _prove_both(field_name, "wide-values", use_native_vm=None)
    assert data == ref
    _accepted_by_both(field_name, data, program)


def test_wide_value_guest_holds_wide_values():
    """The guest's Goldilocks witness has values of 2^63 and more in its
    register, memory-address and memory-value rows, its immediates are
    u64 words of p and more before the reduction (a sign-extended negative
    immediate is 2^64 - |imm|), and its pinned program is the one built
    here."""
    if not native_vm.available():
        pytest.skip("no native VM (needs a C++ compiler)")
    program, entry, _, _ = PROGRAMS["wide-values"]()
    nvm = native_vm.NativeVM()
    nvm.load_segment(entry, program)
    trace = nvm.run(entry, 10000, None, None)["trace"]
    matrix = WitnessGenerator.generate(ref_field.Goldilocks, trace).matrix
    for rows in ([5, 6, 18, 19], [40], [41]):  # t0, t1, s2, s3; mem addr; mem value
        assert (matrix[rows] >= np.uint64(1 << 63)).any(), rows
    assert (np.asarray(trace.columns["imm"]).astype(np.uint64) >= np.uint64(field64.GOLDILOCKS_P)).any()
    cases = json.loads((FIXTURES.parent.parent / "zigz_tpu_torch" / "testdata" / "proof_digests.json")
                       .read_text())["proofs"]
    for name in WIDE:
        case = cases[f"v1-{name.lower()}-wide-values"]
        assert bytes.fromhex(case["program"]["hex"]) == program and case["field"] == name


# -- (d): the u64 device witness ------------------------------------------------


def _memory_and_regs():
    a = Assembler()
    a.li("t0", 0xDEADBEEF)
    a.li("t1", 0x3000)
    a.sd("t0", "t1", 0)
    a.lw("t3", "t1", 0)  # sign-extended: a u64 value above 2^63
    a.add("t2", "t0", "t5")
    a.addi("t4", "t4", -5)  # imm 2^64 - 5 as u64
    a.ebreak()
    regs = [0] * 32
    regs[5], regs[6], regs[7] = (1 << 64) - 1, field64.GOLDILOCKS_P, field64.MERSENNE61_P + 1
    return a.assemble(), 0x1000, regs, None


WITNESS_CASES = {
    "wide-values": lambda: (torch_wide_guest.program(), torch_wide_guest.ENTRY, None, None),
    "memory-and-initial-regs": _memory_and_regs,
    "fibonacci": lambda: ((FIXTURES / "fibonacci_program.bin").read_bytes(), None, None, [9]),
    **{name: (lambda case=case: (case()["program"], 0x1000, case()["initial_regs"], None))
       for name, case in EDGE_CASES.items()},
}


@pytest.mark.parametrize("case", sorted(WITNESS_CASES))
@pytest.mark.parametrize("field_name", WIDE)
def test_wide_device_witness_equals_the_witness_generator(field_name, case):
    if not native_vm.available():
        pytest.skip("no native VM (needs a C++ compiler)")
    F = getattr(ref_field, field_name)
    program, entry, regs, tape = WITNESS_CASES[case]()
    nvm = native_vm.NativeVM()
    if entry is None:
        loaded = elf.load(program)
        entry = loaded.entry_pc
        for seg in loaded.segments:
            nvm.load_segment(seg.vaddr, seg.data)
    else:
        nvm.load_segment(entry, program)
    trace = nvm.run(entry, 10000, regs, tape)["trace"]
    host = WitnessGenerator.generate(F, trace)
    port = witness_dev.build_witness(trace, trace.initial_regs, host.num_vars, "cpu", p=F.MODULUS)
    assert port.dtype == torch.int64 and port.shape == host.matrix.shape
    np.testing.assert_array_equal(port.numpy().view(np.uint64), host.matrix)
    # and the host matrix uploaded as it is
    up = witness_dev.from_numpy(host.matrix, "cpu", p=F.MODULUS)
    np.testing.assert_array_equal(up.numpy().view(np.uint64), host.matrix)
    with pytest.raises(ValueError, match="canonical"):
        witness_dev.from_numpy(host.matrix + np.uint64(F.MODULUS), "cpu", p=F.MODULUS)


# -- (e): the plain fold and the batched evaluation against Multilinear ---------


def _canonical(rng, p, shape):
    """Seeded canonical u64 values with the edges first: 0, 1, p - 1, p - 2,
    and for Goldilocks 2^63 and p - 2^32 (both 2^63 or more)."""
    vals = (rng.integers(0, 1 << 63, shape, dtype=np.uint64) * np.uint64(2)
            + rng.integers(0, 2, shape, dtype=np.uint64)) % np.uint64(p)
    edges = [0, 1, p - 1, p - 2] + ([1 << 63, p - (1 << 32)] if p == field64.GOLDILOCKS_P else [])
    flat = vals.reshape(-1)
    flat[: min(len(edges), flat.size)] = edges[: flat.size]
    return vals


def _i64(arr):
    return torch.from_numpy(np.ascontiguousarray(arr, dtype=np.uint64).view(np.int64))


@pytest.mark.parametrize("width", [2, 6, 64])
@pytest.mark.parametrize("field_name", WIDE)
def test_plain_fold_equals_multilinear(field_name, width):
    """One LSB fold of each row by its challenge, the challenges 0, 1,
    p - 1 (and 2^63 over Goldilocks) among them, against the reference's
    ``Multilinear`` folded one variable at a time."""
    F = getattr(ref_field, field_name)
    p = F.MODULUS
    rng = np.random.default_rng(width)
    rows = 6
    vals = _canonical(rng, p, (rows, width))
    vals[1, ::2], vals[2, 1::2] = p - 1, p - 1
    r = _canonical(rng, p, (rows,))
    got = field64.fold_lsb_u64(_i64(vals), _i64(r), p).numpy().view(np.uint64)
    for b in range(rows):
        rb = F(int(r[b]))
        want = [(F.one() - rb) * F(int(vals[b, 2 * k])) + rb * F(int(vals[b, 2 * k + 1])) for k in range(width // 2)]
        assert [int(x) for x in got[b]] == [w.value for w in want]


@pytest.mark.parametrize("num_vars", [0, 1, 7])
@pytest.mark.parametrize("field_name", WIDE)
def test_batch_eval_equals_multilinear_eval(field_name, num_vars):
    F = getattr(ref_field, field_name)
    p = F.MODULUS
    rng = np.random.default_rng(100 + num_vars)
    rows = 5
    matrix = _canonical(rng, p, (rows, 1 << num_vars))
    points = _canonical(rng, p, (rows, num_vars))
    got = mle.batch_eval_lsb(_i64(matrix), _i64(points).reshape(rows, num_vars), p).numpy().view(np.uint64)
    for b in range(rows):
        poly = Multilinear(F, [F(int(x)) for x in matrix[b]])
        assert int(got[b]) == poly.eval([F(int(x)) for x in points[b]]).value


# -- (f): E1's arithmetic, built with g++ ---------------------------------------


_U64 = ctypes.POINTER(ctypes.c_uint64)


@pytest.fixture(scope="module")
def host_e1(tmp_path_factory):
    """csrc/field64.cuh built for the host (its extern "C" entry)."""
    build = tmp_path_factory.mktemp("field64_host")
    src, lib_path = build / "field64_host.cpp", build / "libfield64_host.so"
    src.write_text('#include "field64.cuh"\n')
    subprocess.run(["g++", "-O0", "-std=c++17", "-shared", "-fPIC", "-I", str(_build.CSRC), "-o", str(lib_path),
                    str(src)], check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(lib_path))
    lib.zigz_mle_fold_u64_host.argtypes = [_U64, _U64, _U64, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64]

    def fold(vals, r, p):
        vals, r = np.ascontiguousarray(vals, dtype=np.uint64), np.ascontiguousarray(r, dtype=np.uint64)
        out = np.empty((vals.shape[0], vals.shape[1] // 2), dtype=np.uint64)
        status = lib.zigz_mle_fold_u64_host(vals.ctypes.data_as(_U64), r.ctypes.data_as(_U64),
                                            out.ctypes.data_as(_U64), vals.shape[0], out.shape[1], p)
        assert status == 0
        return out

    fold.lib = lib
    return fold


@pytest.mark.parametrize("shape", [(1, 2), (3, 6), (43, 256)])
@pytest.mark.parametrize("field_name", WIDE)
def test_e1_arithmetic_equals_the_plain_version(host_e1, field_name, shape):
    p = getattr(port_field, field_name).MODULUS
    rng = np.random.default_rng(shape[1])
    vals = _canonical(rng, p, shape)
    r = _canonical(rng, p, (shape[0],))
    if shape[0] >= 3:
        r[:3] = [0, 1, p - 1]
    got = host_e1(vals, r, p)
    want = field64._fold_lsb_u64_plain(_i64(vals), _i64(r), p).numpy().view(np.uint64)
    np.testing.assert_array_equal(got, want)


def test_e1_arithmetic_refuses_another_modulus(host_e1):
    one = np.zeros((1, 2), dtype=np.uint64)
    status = host_e1.lib.zigz_mle_fold_u64_host(one.ctypes.data_as(_U64), one.ctypes.data_as(_U64),
                                                one.ctypes.data_as(_U64), 1, 1, 2013265921)
    assert status == 1
    with pytest.raises(ValueError, match="neither Goldilocks"):
        field64.fold_lsb_u64(torch.zeros((1, 2), dtype=torch.int64), torch.zeros(1, dtype=torch.int64), 2013265921)
