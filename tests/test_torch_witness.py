"""Port device witness == zigz_tpu's build_witness_device == WitnessGenerator.

The witness is built from the native VM's raw columns: kernel W1's plain
version on the CPU, and W1's own steps (csrc/witness.cuh, built with g++
through its host entry) held to that plain version; the group path's slices
against the whole witness.  Integers throughout: tolerance zero."""

import ctypes
import subprocess

import numpy as np
import pytest
import torch

from zigz_tpu import elf
from zigz_tpu.constraints.witness import WitnessGenerator
from zigz_tpu.core.field import BabyBear as F
from zigz_tpu.guest.asm import Assembler
from zigz_tpu.guest.programs import fibonacci_guest, mul_stress_guest
from zigz_tpu.ops.witness_dev import build_witness_device
from zigz_tpu.runtime import native_vm
from zigz_tpu_torch.core import field as port_field
from zigz_tpu_torch.ops import _build, witness_dev
from zigz_tpu_torch.parallel.multihost import TraceGroup

from torch_witness_cases import EDGE_CASES, raw_columns


def _native_trace(program=None, segments=None, entry=0x1000, tape=None, initial_regs=None):
    nvm = native_vm.NativeVM()
    if segments is not None:
        for seg in segments:
            nvm.load_segment(seg.vaddr, seg.data)
    else:
        nvm.load_segment(entry, program)
    return nvm.run(entry, 10000, initial_regs, tape)["trace"]


def _guest(build, tape):
    loaded = elf.load(build())
    return dict(segments=loaded.segments, entry=loaded.entry_pc, tape=tape)


def _memory_and_padding():
    a = Assembler()
    a.li("t0", 0xDEADBEEF)
    a.li("t1", 0x3000)
    a.sd("t0", "t1", 0)
    a.ld("t2", "t1", 0)
    a.lw("t3", "t1", 0)  # sign-extended load: a u64 value above 2^63
    a.ebreak()
    return dict(program=a.assemble())


def _initial_regs():
    a = Assembler()
    a.add("t2", "t0", "t1")
    a.ebreak()
    regs = [0] * 32
    regs[5], regs[6] = (1 << 63) + 12345, 999  # needs the full u64 mod p
    return dict(program=a.assemble(), initial_regs=regs)


def _nonpow2():
    a = Assembler()
    for _ in range(5):  # 5 steps + ebreak = 6 -> pads to 8
        a.addi("t0", "t0", 1)
    a.ebreak()
    return dict(program=a.assemble())


def _negative_immediate():
    a = Assembler()
    a.addi("t0", "t0", -5)  # imm = 2^64 - 5 as u64: reduces to (2^64 - 5) mod p
    a.addi("t1", "t0", -2048)
    a.ebreak()
    return dict(program=a.assemble())


CASES = {
    "fibonacci": lambda: _guest(fibonacci_guest, [9]),
    "mul_stress": lambda: _guest(mul_stress_guest, [25]),
    "memory_and_padding": _memory_and_padding,
    "initial_regs": _initial_regs,
    "nonpow2": _nonpow2,
    "negative_immediate": _negative_immediate,
    **EDGE_CASES,
}


@pytest.fixture(autouse=True)
def _needs_native_vm():
    if not native_vm.available():
        pytest.skip("no native VM (needs a C++ compiler)")


@pytest.mark.parametrize("case", sorted(CASES))
def test_witness_matches_jax_and_host(case):
    trace = _native_trace(**CASES[case]())
    host = WitnessGenerator.generate(F, trace)
    port = witness_dev.build_witness(trace, trace.initial_regs, host.num_vars, "cpu")
    assert port.dtype == torch.int32 and tuple(port.shape) == host.matrix.shape
    jax_lo = np.asarray(build_witness_device(trace, trace.initial_regs, host.num_vars))
    np.testing.assert_array_equal(port.numpy().astype(np.uint64), host.matrix)
    np.testing.assert_array_equal(port.numpy().view(np.uint32), jax_lo)


@pytest.mark.parametrize("per_pass", [1, 4])
@pytest.mark.parametrize("case", ["fibonacci", "initial_regs"])
def test_register_fill_in_passes_matches_the_host(monkeypatch, case, per_pass):
    """Long traces fill a few registers per pass to bound the int64
    transients: the same witness as all 32 at once."""
    trace = _native_trace(**CASES[case]())
    host = WitnessGenerator.generate(F, trace)
    monkeypatch.setattr(witness_dev, "_FILL_VALUES", per_pass << host.num_vars)
    port = witness_dev.build_witness(trace, trace.initial_regs, host.num_vars, "cpu")
    np.testing.assert_array_equal(port.numpy().astype(np.uint64), host.matrix)


def test_negative_immediate_reduces_unsigned():
    trace = _native_trace(**_negative_immediate())
    num_vars = WitnessGenerator.generate(F, trace).num_vars
    port = witness_dev.build_witness(trace, trace.initial_regs, num_vars, "cpu")
    assert int(port[39, 0]) == ((1 << 64) - 5) % F.MODULUS
    assert int(port[39, 0]) != (-5) % F.MODULUS


def test_from_numpy_carries_the_jax_witness():
    trace = _native_trace(**_nonpow2())
    jax_lo = np.asarray(build_witness_device(trace, trace.initial_regs, 3))
    carried = witness_dev.from_numpy(jax_lo, "cpu")
    assert carried.dtype == torch.int32 and carried.numpy().view(np.uint32).tolist() == jax_lo.tolist()
    with pytest.raises(ValueError):
        witness_dev.from_numpy(jax_lo.astype(np.uint64), "cpu")


def _group_trace():
    """20 steps, so 2^5 rows: the trace ends inside the third quarter, and
    rank 3 of 4 holds padding only.  Registers written before and inside
    every slice, memory steps on both sides of the cut, initial registers
    of 2^63 and more."""
    a = Assembler()
    a.li("t1", 0x3000)
    for k in range(6):
        a.addi("t0", "t0", -3 - k)
        a.sd("t0", "t1", 8 * k)
    a.ld("t2", "t1", 8)
    a.lw("t3", "t1", 16)
    a.add("t4", "t0", "t5")
    a.addi("t6", "t6", 1)
    a.addi("a0", "a0", 2)
    a.ebreak()
    regs = [0] * 32
    regs[5], regs[30] = (1 << 64) - 1, (1 << 63) + 5
    return _native_trace(program=a.assemble(), initial_regs=regs)


@pytest.mark.parametrize("world_size, rank", [(2, 0), (2, 1), (4, 0), (4, 1), (4, 2), (4, 3)])
def test_group_slices_of_the_raw_columns_equal_the_whole_witness(world_size, rank):
    """Each rank's (43, N/D) slice, built from the raw columns cut to the
    rank's steps, equals those columns of the whole witness: the padding's
    pc is the whole trace's last pc, and the registers carried in are those
    before the slice."""
    trace = _group_trace()
    num_vars = 5
    assert 16 < trace.step_count() < 24
    whole = witness_dev.build_witness(trace, trace.initial_regs, num_vars, "cpu")
    jax_lo = np.asarray(build_witness_device(trace, trace.initial_regs, num_vars))
    np.testing.assert_array_equal(whole.numpy().view(np.uint32), jax_lo)
    group = TraceGroup(rank=rank, world_size=world_size, device=torch.device("cpu"), backend="gloo", pg=object())
    local = witness_dev.build_witness(trace, trace.initial_regs, num_vars, "cpu", group=group)
    per = (1 << num_vars) // world_size
    assert tuple(local.shape) == (43, per)
    assert torch.equal(local, whole[:, rank * per : (rank + 1) * per])


# -- W1's own steps (csrc/witness.cuh), built with g++ ------------------------------


@pytest.fixture(scope="module")
def host_w1(tmp_path_factory):
    """csrc/witness.cuh built for the host (its extern "C" entry): W1's
    groups of steps in order, on numpy arrays -> (rows, wr_val, wr_idx)."""
    build = tmp_path_factory.mktemp("witness_host")
    src, lib_path = build / "witness_host.cpp", build / "libwitness_host.so"
    src.write_text('#include "witness.cuh"\n')
    subprocess.run(["g++", "-O0", "-std=c++17", "-shared", "-fPIC", "-I", str(_build.CSRC), "-o", str(lib_path),
                    str(src)], check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(lib_path))
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    lib.zigz_witness_rows_host.argtypes = [ptrs, ptrs, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64,
                                           ctypes.c_uint64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]

    def rows(cols, n_real, n, last_pc, p, word):
        u64 = (ctypes.c_void_p * 5)(*(cols[k].ctypes.data for k in witness_dev.U64_COLUMNS))
        u8 = (ctypes.c_void_p * 8)(*(cols[k].ctypes.data for k in witness_dev.U8_COLUMNS))
        out = np.zeros((43, n), dtype=word)
        wr_val, wr_idx = np.zeros(n, dtype=word), np.zeros(n, dtype=np.uint8)
        status = lib.zigz_witness_rows_host(u64, u8, n_real, n, last_pc, p, out.ctypes.data, wr_val.ctypes.data,
                                            wr_idx.ctypes.data)
        return status, out, wr_val, wr_idx

    return rows


FIELDS = ("BabyBear", "KoalaBear", "Mersenne31", "F17", "Goldilocks", "Mersenne61")


@pytest.mark.parametrize("n_real, n", [(0, 2), (1, 1), (1, 2), (3, 4), (5, 8), (777, 1024), (1024, 1024)])
@pytest.mark.parametrize("field_name", FIELDS)
def test_w1_steps_equal_the_plain_version(host_w1, field_name, n_real, n):
    """The kernel's steps and its plain version on the same raw columns:
    rows 0 and 33-42, the reduced write value and the write index, the
    padding included; values of p and more, of 2^63 and more, negative
    immediates and garbage memory columns where mem_flag is 0 among them."""
    p = getattr(port_field, field_name).MODULUS
    wide = p >= 1 << 31
    cols = raw_columns(n_real, seed=n_real + 7)
    last_pc = int(cols["pc"][-1]) if n_real else 0
    status, rows, wr_val, wr_idx = host_w1(cols, n_real, n, last_pc, p, np.uint64 if wide else np.uint32)
    assert status == 0
    out = torch.zeros((43, n), dtype=torch.int64 if wide else torch.int32)
    d = {k: torch.from_numpy(a.view(np.int64) if a.dtype == np.uint64 else a) for k, a in cols.items()}
    before = dict(witness_dev.ROWS)
    want_val, want_idx = witness_dev.witness_rows(d, n_real, last_pc, out, p)
    assert witness_dev.ROWS == before  # the plain version launches nothing
    word = np.uint64 if wide else np.uint32
    got = out.numpy().view(word)
    for row in [0, *range(33, 43)]:
        np.testing.assert_array_equal(rows[row], got[row], err_msg=f"row {row}")
    np.testing.assert_array_equal(wr_val, want_val.numpy().view(word))
    np.testing.assert_array_equal(wr_idx, want_idx.numpy())
    assert int(got.max(initial=0)) < p and int(wr_val.max(initial=0)) < p
    if n > n_real:
        assert (got[0, n_real:] == last_pc % p).all() and not got[33:, n_real:].any()


def test_w1_steps_refuse_another_modulus(host_w1):
    cols = raw_columns(4, seed=1)
    for p in (1 << 31, (1 << 61) + 1, 1):
        assert host_w1(cols, 4, 4, 0, p, np.uint64)[0] == 1
    assert host_w1(cols, 5, 4, 0, 17, np.uint32)[0] == 1  # more real steps than rows


def test_witness_rows_refuses_what_w1_does_not_take():
    cols = {k: torch.from_numpy(a.view(np.int64) if a.dtype == np.uint64 else a)
            for k, a in raw_columns(8, seed=2).items()}
    out = torch.zeros((43, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32 rows"):
        witness_dev.witness_rows(cols, 8, 0, out.to(torch.int64), F.MODULUS)
    with pytest.raises(ValueError, match="real steps"):
        witness_dev.witness_rows(cols, 9, 0, out, F.MODULUS)
    with pytest.raises(ValueError, match="column opcode"):
        witness_dev.witness_rows({**cols, "opcode": cols["opcode"].to(torch.int64)}, 8, 0, out, F.MODULUS)
    with pytest.raises(ValueError, match="column imm"):
        trace = _native_trace(**_nonpow2())
        trace.columns["imm"] = trace.columns["imm"].astype(np.int32)
        witness_dev.build_witness(trace, trace.initial_regs, 3, "cpu")
