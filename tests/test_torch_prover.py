"""The port's v1 proof bytes == the golden fixtures == zigz_tpu's proofs.

Proof bytes are compared whole: tolerance zero."""

import pathlib
import subprocess
import sys

import pytest
import torch

from zigz_tpu import elf
from zigz_tpu.core.field import BabyBear as F
from zigz_tpu.prover.proof import VerificationResult
from zigz_tpu.prover.serialization import BinarySerializer
from zigz_tpu.verifier.verifier import Verifier
from zigz_tpu_torch import cli
from zigz_tpu_torch.ops import keccak
from zigz_tpu_torch.prover.prover import Prover, ReferenceProver

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "fixtures"
CASES = {
    "nop4": dict(entry=0x1000, tape=None),
    "add": dict(entry=0x1000, tape=None),
    "fibonacci": dict(entry=None, tape=[10]),  # entry and segments from the ELF
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several pytest workers on a few cores: torch's own
    intra-op thread pool would oversubscribe them (tens of times slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _prove_case(name, prover):
    program = (FIXTURES / f"{name}_program.bin").read_bytes()
    entry, segments = CASES[name]["entry"], None
    if entry is None:
        loaded = elf.load(program)
        entry, segments = loaded.entry_pc, loaded.segments
    proof = prover.prove(program, entry, None, 1 << 16, segments, CASES[name]["tape"])
    return program, BinarySerializer(F).serialize(proof)


@pytest.mark.parametrize("name", sorted(CASES))
def test_v1_bytes_match_golden_fixture(name):
    program, data = _prove_case(name, Prover(F, seed=0, device="cpu"))
    assert data == (FIXTURES / f"{name}_v1.bin").read_bytes()
    restored = BinarySerializer(F).deserialize(data)
    assert Verifier(F).verify(restored, program) == VerificationResult.Accept


@pytest.mark.parametrize("reference_path", ["host", "device"])
def test_v1_bytes_match_zigz_tpu_at_4096_nop_steps(reference_path, monkeypatch):
    """Against zigz_tpu's host forest and its JAX device forest (jnp Keccak
    on the CPU)."""
    n = 1 << 12
    program = bytes([0x13, 0x00, 0x00, 0x00] * n)
    port = Prover(F, seed=0, device="cpu")
    data = BinarySerializer(F).serialize(port.prove(program, 0x1000, None, 2 * n, None, None))
    assert port.last_timings["num_steps"] == n
    assert {"witness_dev_s", "forest_s", "evals_s", "opens_s", "total_s"} <= set(port.last_timings)

    monkeypatch.setenv("ZIGZ_TPU_COMMITMENTS", reference_path)
    ref = ReferenceProver(F, seed=0)
    assert ref._use_device_commitments(n) == (reference_path == "device")
    ref_data = BinarySerializer(F).serialize(ref.prove(program, 0x1000, None, 2 * n, None, None))
    assert data == ref_data
    assert Verifier(F).verify(BinarySerializer(F).deserialize(data), program) == VerificationResult.Accept


def test_port_has_no_size_gate():
    prover = Prover(F, device="cpu")
    assert all(prover._use_device_commitments(n) for n in (1, 4, 1 << 14, 1 << 30))


def test_protocols_beyond_v1_are_not_ported():
    for version in (2, 3, 4):
        with pytest.raises(NotImplementedError, match="slice"):
            Prover(F, device="cpu", protocol_version=version)


def test_cli_prove_writes_the_fixture_bytes(tmp_path, capsys):
    out = tmp_path / "proof.bin"
    program = FIXTURES / "nop4_program.bin"
    assert cli.main(["prove", str(program), "--device", "cpu", "--out", str(out)]) == 0
    assert out.read_bytes() == (FIXTURES / "nop4_v1.bin").read_bytes()
    assert cli.main(["verify", str(out), str(program)]) == 0
    assert cli.main(["prove", str(program)]) == 1  # no --device
    for flag in ("--v2", "--v3", "--v4", "--supervise"):
        assert cli.main(["prove", str(program), "--device", "cpu", flag]) == 1
        assert "not yet ported" in capsys.readouterr().err


_NO_JAX_PROVE = """
import sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
sys.path.insert(0, {root!r})
import zigz_tpu_torch as zt
program = open({program!r}, "rb").read()
proof = zt.Prover(zt.BabyBear, seed=0, device="cpu").prove(program, 0x1000, None, 1 << 16, None, None)
data = zt.serialization.BinarySerializer(zt.BabyBear).serialize(proof)
assert data == open({golden!r}, "rb").read()
assert zt.Verifier(zt.BabyBear).verify(zt.serialization.BinarySerializer(zt.BabyBear).deserialize(data), program) == "Accept"
assert sys.modules["jax"] is None
print("NO_JAX_OK")
"""


def test_port_proves_with_jax_unimportable():
    code = _NO_JAX_PROVE.format(
        root=str(ROOT),
        program=str(FIXTURES / "add_program.bin"),
        golden=str(FIXTURES / "add_v1.bin"),
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "NO_JAX_OK" in res.stdout


def test_cpu_proves_launch_no_kernel():
    before = dict(keccak.LAUNCHES)
    _prove_case("nop4", Prover(F, device="cpu"))
    assert keccak.LAUNCHES == before
