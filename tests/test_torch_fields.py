"""Protocol v1 over every field below 2^31, as zigz_tpu proves it.

The port's v1 proofs over KoalaBear, Mersenne31 and F17 are byte-identical
to zigz_tpu's (its host path on the CPU) and Accept under both verifiers,
crossing as serialized bytes; the device witness and the batched
evaluation reduce mod the field's own modulus.  v1 over Goldilocks and
Mersenne61 is tests/test_torch_wide_fields.py's; here v2-v4 and a sharded
prove refuse those two, as zigz_tpu does, and a modulus of 2^31 or more
outside them is refused with the reason.  Integers throughout: tolerance
zero.
"""

import numpy as np
import pytest
import torch

from zigz_tpu import elf
from zigz_tpu.constraints.witness import WitnessGenerator
from zigz_tpu.core import field as ref_field
from zigz_tpu.guest.asm import Assembler
from zigz_tpu.prover.proof import VerificationResult
from zigz_tpu.prover.prover import Prover as ReferenceProver
from zigz_tpu.prover.serialization import BinarySerializer
from zigz_tpu.runtime import native_vm
from zigz_tpu.verifier.verifier import Verifier
import zigz_tpu_torch as zt
from zigz_tpu_torch.core import field as port_field
from zigz_tpu_torch.ops import mle, witness_dev

from test_torch_prover import FIXTURES
from torch_witness_cases import EDGE_CASES

FIELDS = ("KoalaBear", "Mersenne31", "F17")
WIDE = ("Goldilocks", "Mersenne61")
PROGRAMS = {
    "add": lambda: ((FIXTURES / "add_program.bin").read_bytes(), 0x1000, None, None),
    "nop4": lambda: ((FIXTURES / "nop4_program.bin").read_bytes(), 0x1000, None, None),
    "fibonacci": lambda: _elf((FIXTURES / "fibonacci_program.bin").read_bytes(), [10]),
    "nop-2^10": lambda: (bytes([0x13, 0x00, 0x00, 0x00] * (1 << 10)), 0x1000, None, None),
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


def _reference_proof(F, program, entry, segments, tape) -> bytes:
    proof = ReferenceProver(F, seed=0).prove(program, entry, None, 1 << 16, segments, tape)
    return BinarySerializer(F).serialize(proof)


@pytest.mark.parametrize("program_name", sorted(PROGRAMS))
@pytest.mark.parametrize("field_name", FIELDS)
def test_v1_proof_matches_zigz_tpu(field_name, program_name):
    F, PF = getattr(ref_field, field_name), getattr(port_field, field_name)
    program, entry, segments, tape = PROGRAMS[program_name]()
    port = zt.Prover(PF, seed=0, device="cpu")
    data = zt.serialization.BinarySerializer(PF).serialize(
        port.prove(program, entry, None, 1 << 16, segments, tape))
    assert data == _reference_proof(F, program, entry, segments, tape)
    assert "forest_s" in port.last_timings  # the device forest, on the CPU tensors' plain kernels
    # The port's proof under zigz_tpu's verifier, and back under the port's.
    assert Verifier(F).verify(BinarySerializer(F).deserialize(data), program) == VerificationResult.Accept
    assert zt.Verifier(PF).verify(zt.serialization.BinarySerializer(PF).deserialize(data), program) == "Accept"


@pytest.mark.parametrize("version", [2, 3, 4])
@pytest.mark.parametrize("field_name", WIDE)
def test_v2_to_v4_refuse_the_wide_fields(field_name, version):
    """As zigz_tpu: v1 proves over Goldilocks and Mersenne61, v3 and v4 are
    refused when the prover is made, v2 when it proves."""
    F, PF = getattr(ref_field, field_name), getattr(port_field, field_name)
    program, entry, segments, tape = PROGRAMS["nop4"]()
    if version > 2:
        for make in (lambda: ReferenceProver(F, protocol_version=version),
                     lambda: zt.Prover(PF, device="cpu", protocol_version=version)):
            with pytest.raises(ValueError, match="BabyBear-only"):
                make()
        return
    for prover in (ReferenceProver(F, protocol_version=2), zt.Prover(PF, device="cpu", protocol_version=2)):
        with pytest.raises(ValueError, match="use protocol_version=1 for this field"):
            prover.prove(program, entry, None, 1 << 16, segments, tape)


@pytest.mark.parametrize("field_name", WIDE)
def test_sharded_prove_refuses_the_wide_fields(field_name):
    class _Rank:
        device = torch.device("cpu")

    with pytest.raises(ValueError, match="sharded prove is BabyBear-only"):
        zt.Prover(getattr(port_field, field_name), device="cpu", group=_Rank())


@pytest.mark.parametrize("modulus", [(1 << 31) + 11, (1 << 61) + 15, (1 << 64) - 59])
def test_a_modulus_from_2_31_outside_the_two_fields_is_refused(modulus):
    """Neither the int32 witness nor the u64 one with kernel E1 takes it,
    and the message says so; the int64 folds keep their own limit."""
    with pytest.raises(ValueError, match=r"not below 2\^31 and is neither Goldilocks.*nor Mersenne61"):
        zt.Prover(port_field.Field(modulus), device="cpu")
    with pytest.raises(ValueError, match=r"not below 2\^31"):
        mle.check_modulus(modulus)
    for name in WIDE:
        assert mle.check_device_modulus(getattr(port_field, name).MODULUS) == getattr(port_field, name).MODULUS


@pytest.mark.parametrize("version", [2, 3, 4])
def test_v2_to_v4_stay_babybear_only(version):
    """As zigz_tpu: v3 and v4 are refused when the prover is made, v2 when it
    proves ("use protocol_version=1 for this field")."""
    F, PF = ref_field.KoalaBear, port_field.KoalaBear
    program, entry, segments, tape = PROGRAMS["nop4"]()
    if version > 2:
        for make in (lambda: ReferenceProver(F, protocol_version=version),
                     lambda: zt.Prover(PF, device="cpu", protocol_version=version)):
            with pytest.raises(ValueError, match="BabyBear-only"):
                make()
        return
    for prover in (ReferenceProver(F, protocol_version=2), zt.Prover(PF, device="cpu", protocol_version=2)):
        with pytest.raises(ValueError, match="use protocol_version=1 for this field"):
            prover.prove(program, entry, None, 1 << 16, segments, tape)


def test_sharded_prove_stays_babybear_only():
    class _Rank:
        device = torch.device("cpu")

    with pytest.raises(ValueError, match="sharded prove is BabyBear-only"):
        zt.Prover(port_field.KoalaBear, device="cpu", group=_Rank())


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
    regs[5], regs[6] = (1 << 63) + 12345, (1 << 40) + 7
    return dict(program=a.assemble(), entry=0x1000, initial_regs=regs)


WITNESS_CASES = {
    "memory_and_regs": _memory_and_regs,
    "fibonacci": lambda: dict(program=None, entry=None, initial_regs=None),
    **{name: (lambda case=case: dict(entry=0x1000, **case())) for name, case in EDGE_CASES.items()},
}


@pytest.mark.parametrize("case", sorted(WITNESS_CASES))
@pytest.mark.parametrize("field_name", FIELDS)
def test_device_witness_reduces_mod_the_field(field_name, case):
    if not native_vm.available():
        pytest.skip("no native VM (needs a C++ compiler)")
    F = getattr(ref_field, field_name)
    spec = WITNESS_CASES[case]()
    nvm = native_vm.NativeVM()
    tape = None
    if spec["program"] is None:
        _, entry, segments, tape = PROGRAMS["fibonacci"]()
        for seg in segments:
            nvm.load_segment(seg.vaddr, seg.data)
    else:
        entry = spec["entry"]
        nvm.load_segment(entry, spec["program"])
    trace = nvm.run(entry, 10000, spec["initial_regs"], tape)["trace"]
    host = WitnessGenerator.generate(F, trace)
    port = witness_dev.build_witness(trace, trace.initial_regs, host.num_vars, "cpu", p=F.MODULUS)
    np.testing.assert_array_equal(port.numpy().astype(np.uint64), host.matrix)
    assert int(port.max()) < F.MODULUS


@pytest.mark.parametrize("field_name", FIELDS)
def test_batch_eval_reduces_mod_the_field(field_name):
    """``batch_eval_lsb`` at modulus p == the multilinear extension
    evaluated in the field's own scalar class, the LSB first."""
    F = getattr(port_field, field_name)
    p = F.MODULUS
    rng = np.random.default_rng(11)
    rows, v = 5, 6
    matrix = rng.integers(0, p, (rows, 1 << v), dtype=np.int64)
    matrix[0, :4] = p - 1
    points = rng.integers(0, p, (rows, v), dtype=np.int64)
    got = mle.batch_eval_lsb(torch.from_numpy(matrix), torch.from_numpy(points), p).numpy()
    for b in range(rows):
        cur = [F(int(x)) for x in matrix[b]]
        for j in range(v):
            r = F(int(points[b, j]))
            cur = [(F.one() - r) * cur[2 * i] + r * cur[2 * i + 1] for i in range(len(cur) // 2)]
        assert int(got[b]) == cur[0].value
