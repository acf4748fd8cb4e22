"""The port's v1 and v2 proof bytes == the golden fixtures == zigz_tpu's proofs.

Proof bytes are compared whole: tolerance zero."""

import os
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
from zigz_tpu_torch.ops import keccak, ligero_dev
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


def test_protocols_beyond_v2_are_not_ported():
    for version in (3, 4):
        with pytest.raises(NotImplementedError, match="slice"):
            Prover(F, device="cpu", protocol_version=version)


def test_cli_prove_writes_the_fixture_bytes(tmp_path, capsys):
    out = tmp_path / "proof.bin"
    program = FIXTURES / "nop4_program.bin"
    assert cli.main(["prove", str(program), "--device", "cpu", "--out", str(out)]) == 0
    assert out.read_bytes() == (FIXTURES / "nop4_v1.bin").read_bytes()
    assert cli.main(["verify", str(out), str(program)]) == 0
    assert cli.main(["prove", str(program)]) == 1  # no --device
    for flag in ("--v3", "--v4", "--supervise"):
        assert cli.main(["prove", str(program), "--device", "cpu", flag]) == 1
        assert "not yet ported" in capsys.readouterr().err


def test_cli_prove_v2_writes_zigz_tpu_bytes(tmp_path, capsys, monkeypatch):
    out = tmp_path / "proof.bin"
    program = FIXTURES / "add_program.bin"
    assert cli.main(["prove", str(program), "--device", "cpu", "--v2", "--out", str(out)]) == 0
    assert "protocol v2" in capsys.readouterr().out
    monkeypatch.setenv("ZIGZ_TPU_COMMITMENTS", "host")
    ref = ReferenceProver(F, seed=0, protocol_version=2).prove(
        program.read_bytes(), 0x1000, None, 1 << 20, None, None)
    assert out.read_bytes() == BinarySerializer(F).serialize(ref)
    assert cli.main(["verify", str(out), str(program)]) == 0


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


# -- protocol v2 -----------------------------------------------------------

V2_CASES = {
    "nop 2^10": dict(program=None, tape=None),
    "fibonacci [10]": dict(program="fibonacci_program.bin", tape=[10]),
}


def _v2_inputs(case):
    spec = V2_CASES[case]
    if spec["program"] is None:
        program = bytes([0x13, 0x00, 0x00, 0x00] * (1 << 10))
        return program, 0x1000, None, spec["tape"]
    program = (FIXTURES / spec["program"]).read_bytes()
    loaded = elf.load(program)
    return program, loaded.entry_pc, loaded.segments, spec["tape"]


@pytest.mark.parametrize("case", sorted(V2_CASES))
def test_v2_bytes_match_zigz_tpu(case, monkeypatch):
    """Against zigz_tpu's host path (host NTT, host column hashing)."""
    program, entry, segments, tape = _v2_inputs(case)
    port = Prover(F, seed=0, device="cpu", protocol_version=2)
    before = dict(ligero_dev.LAUNCHES), dict(keccak.LAUNCHES)
    data = BinarySerializer(F).serialize(port.prove(program, entry, None, 1 << 16, segments, tape))
    assert (dict(ligero_dev.LAUNCHES), dict(keccak.LAUNCHES)) == before  # plain versions on the CPU
    t = port.last_timings
    assert t["data_commit_path"] == t["advice_commit_path"] == "stream-dev"
    assert t["advice_dev_cols"] == 0
    assert {"data_commit_s", "advice_build_s", "advice_commit_s", "zerochecks_s", "batch_eval_s",
            "open_s", "unified_s", "lasso_s", "forest_s", "data_upload_s", "data_stream_s"} <= set(t)

    monkeypatch.setenv("ZIGZ_TPU_COMMITMENTS", "host")
    ref = ReferenceProver(F, seed=0, protocol_version=2)
    ref_data = BinarySerializer(F).serialize(ref.prove(program, entry, None, 1 << 16, segments, tape))
    assert ref.last_timings["data_commit_path"] == "host"
    assert data == ref_data
    restored = BinarySerializer(F).deserialize(data)
    assert restored.metadata.version == 2
    assert Verifier(F).verify(restored, program) == VerificationResult.Accept


_NO_JAX_V2 = """
import os, sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(1)  # the suite runs several workers on a few cores
import zigz_tpu_torch as zt
from zigz_tpu import elf
from zigz_tpu.proofs.zerocheck import ZerocheckExtProver
from zigz_tpu_torch.prover.prover import ReferenceProver

seen = []
_prove = ZerocheckExtProver.prove
def _recording_prove(self, transcript):
    seen.append(self.dev_columns)
    return _prove(self, transcript)
ZerocheckExtProver.prove = _recording_prove

program = open({program!r}, "rb").read() if {program!r} else bytes([0x13, 0, 0, 0] * 1024)
entry, segments = 0x1000, None
if elf.is_elf(program):
    loaded = elf.load(program)
    entry, segments = loaded.entry_pc, loaded.segments
ser = zt.serialization.BinarySerializer(zt.BabyBear)
port = zt.Prover(zt.BabyBear, seed=0, device="cpu", protocol_version=2)
data = ser.serialize(port.prove(program, entry, None, 1 << 16, segments, {tape!r}))
assert port.last_timings["data_commit_path"] == "stream-dev", port.last_timings
assert port.last_timings["advice_commit_path"] == "stream-dev", port.last_timings
assert seen and all(cols is None for cols in seen), seen
os.environ["ZIGZ_TPU_COMMITMENTS"] = "host"
ref = ser.serialize(ReferenceProver(zt.BabyBear, seed=0, protocol_version=2).prove(
    program, entry, None, 1 << 16, segments, {tape!r}))
assert data == ref
assert zt.Verifier(zt.BabyBear).verify(ser.deserialize(data), program) == "Accept"
assert sys.modules["jax"] is None
print("NO_JAX_V2_OK", len(seen))
"""


@pytest.mark.parametrize("case", sorted(V2_CASES))
def test_v2_proves_with_jax_unimportable(case):
    """Both the port and zigz_tpu's host path reach zigz_tpu.ops without
    JAX (zigz_tpu_torch._jaxfree), and no zerocheck receives device
    columns from the port's commitments."""
    spec = V2_CASES[case]
    code = _NO_JAX_V2.format(
        root=str(ROOT),
        program=str(FIXTURES / spec["program"]) if spec["program"] else "",
        tape=spec["tape"],
    )
    env = {k: v for k, v in os.environ.items() if k != "ZIGZ_TPU_COMMITMENTS"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env=env)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "NO_JAX_V2_OK" in res.stdout

