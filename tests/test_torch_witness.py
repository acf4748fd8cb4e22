"""Port device witness == zigz_tpu's build_witness_device == WitnessGenerator.

Integers throughout: tolerance zero."""

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
from zigz_tpu_torch.ops import witness_dev


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
