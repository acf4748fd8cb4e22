"""The port's v1 to v4 proof bytes == the golden fixtures == zigz_tpu's proofs
== the pinned digests of zigz_tpu_torch/testdata/proof_digests.json.

Proof bytes are compared whole: tolerance zero.  The port and zigz_tpu are
two packages with classes of their own, so proofs cross between them as
serialized bytes."""

import copy
import hashlib
import json
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
from zigz_tpu.prover.prover import Prover as ReferenceProver
from zigz_tpu.verifier.verifier import Verifier
import zigz_tpu_torch as zt
from zigz_tpu_torch import cli
from zigz_tpu_torch.lookups import pipeline_lasso
from zigz_tpu_torch.commitments import ligero as port_ligero
from zigz_tpu_torch.constraints.witness import WITNESS_POLY_NAMES
from zigz_tpu_torch.verifier.verifier import ProgramHashMismatch
from zigz_tpu_torch.ops import keccak, ligero_dev, zerocheck_dev_ext
from zigz_tpu_torch.proofs.zerocheck import count_zerocheck_proofs
from zigz_tpu_torch.prover.prover import Prover

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "fixtures"
PINNED = json.loads((ROOT / "zigz_tpu_torch" / "testdata" / "proof_digests.json").read_text())["proofs"]
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
    """The reference's gates are not carried over, and a 5-step prove takes
    the device forest."""
    assert not hasattr(Prover, "DEVICE_COMMITMENT_MIN_STEPS")
    assert not hasattr(Prover, "_use_device_commitments")
    assert not hasattr(zerocheck_dev_ext, "MIN_DEVICE_EXT_WIDTH")
    assert not hasattr(pipeline_lasso, "DEVICE_ROUNDS_MIN")
    prover = Prover(F, device="cpu")
    _prove_case("nop4", prover)
    assert prover.last_timings["num_steps"] == 5 and "forest_s" in prover.last_timings


def test_protocols_and_fields_are_refused_as_zigz_tpu_refuses():
    """v1 takes every field below 2^31 and Goldilocks and Mersenne61
    (tests/test_torch_fields.py, tests/test_torch_wide_fields.py); v3 and
    v4 refuse another field when the prover is made, v2 when it proves, as
    zigz_tpu does; any other modulus of 2^31 and above is refused with the
    reason; a version beyond v4 is refused."""
    from zigz_tpu.core.field import KoalaBear as RefKoalaBear
    from zigz_tpu_torch.core.field import Field, Goldilocks, KoalaBear, Mersenne31, Mersenne61

    for field in (KoalaBear, Mersenne31, Goldilocks, Mersenne61):
        assert Prover(field, device="cpu").F is field
    with pytest.raises(ValueError, match=r"not below 2\^31"):
        Prover(Field((1 << 61) + 15), device="cpu")
    for version in (3, 4):
        assert Prover(F, device="cpu", protocol_version=version).protocol_version == version
        for field in (Goldilocks, KoalaBear):
            with pytest.raises(ValueError, match="BabyBear"):
                Prover(field, device="cpu", protocol_version=version)
        with pytest.raises(ValueError, match="BabyBear"):
            ReferenceProver(RefKoalaBear, protocol_version=version)
    program = (FIXTURES / "nop4_program.bin").read_bytes()
    for prover in (Prover(KoalaBear, device="cpu", protocol_version=2), ReferenceProver(RefKoalaBear, protocol_version=2)):
        with pytest.raises(ValueError, match="use protocol_version=1 for this field"):
            prover.prove(program, 0x1000, None, 1 << 16, None, None)
    with pytest.raises(ValueError, match="protocol_version"):
        Prover(F, device="cpu", protocol_version=5)


def test_cli_prove_writes_the_fixture_bytes(tmp_path, capsys):
    out = tmp_path / "proof.bin"
    program = FIXTURES / "nop4_program.bin"
    assert cli.main(["prove", str(program), "--device", "cpu", "--out", str(out)]) == 0
    assert out.read_bytes() == (FIXTURES / "nop4_v1.bin").read_bytes()
    assert cli.main(["verify", str(out), str(program)]) == 0
    assert cli.main(["execute", str(program)]) == 0
    assert "execute: 5 steps" in capsys.readouterr().out
    if not torch.cuda.is_available():  # the default device is the card: an error where there is none
        assert cli.main(["prove", str(program)]) == 1
        assert "cuda" in capsys.readouterr().err
    # --supervise proves in a worker under the supervisor: the same bytes
    supervised = tmp_path / "supervised.bin"
    assert cli.main(["prove", str(program), "--device", "cpu", "--supervise", "--out", str(supervised)]) == 0
    assert "steps 5 (supervised, restarts=0)" in capsys.readouterr().out
    assert supervised.read_bytes() == (FIXTURES / "nop4_v1.bin").read_bytes()


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
sys.modules["jax"] = None  # any import of jax or of the JAX package now raises ImportError
sys.modules["zigz_tpu"] = None
sys.path.insert(0, {root!r})
import zigz_tpu_torch as zt
program = open({program!r}, "rb").read()
proof = zt.Prover(zt.BabyBear, seed=0, device="cpu").prove(program, 0x1000, None, 1 << 16, None, None)
data = zt.serialization.BinarySerializer(zt.BabyBear).serialize(proof)
assert data == open({golden!r}, "rb").read()
assert zt.Verifier(zt.BabyBear).verify(zt.serialization.BinarySerializer(zt.BabyBear).deserialize(data), program) == "Accept"
assert sys.modules["jax"] is None and sys.modules["zigz_tpu"] is None
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

# ``host_tail``: the width at or below which the zerocheck and Lasso rounds
# finish on the host; 8 sends all but the last rounds to the torch device.
V2_CASES = {
    "nop 2^10": dict(version=2, program=None, tape=None, pinned="v2-nop-2^10", host_tail=8),
    "fibonacci [10]": dict(version=2, program="fibonacci_program.bin", tape=[10], pinned="v2-fibonacci-10",
                           host_tail=None),
    "v3 nop 2^10": dict(version=3, program=None, tape=None, pinned="v3-nop-2^10", host_tail=8),
    "v3 fibonacci [10]": dict(version=3, program="fibonacci_program.bin", tape=[10],
                              pinned="v3-fibonacci-10", host_tail=None),
    "v4 nop 2^10": dict(version=4, program=None, tape=None, pinned="v4-nop-2^10", host_tail=8),
    "v4 fibonacci [10]": dict(version=4, program="fibonacci_program.bin", tape=[10],
                              pinned="v4-fibonacci-10", host_tail=None),
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
    """Protocols v2, v3 and v4: every zerocheck on GenericDeviceZerocheckExt,
    the advice planes rebuilt on the torch device and the Lasso rounds there,
    against zigz_tpu's host path (native zerochecks, host NTT, host column
    hashing); both verifiers accept both proofs."""
    program, entry, segments, tape = _v2_inputs(case)
    host_tail, version = V2_CASES[case]["host_tail"], V2_CASES[case]["version"]
    if host_tail is not None:
        monkeypatch.setattr(zerocheck_dev_ext, "HOST_TAIL_EXT", host_tail)
        monkeypatch.setattr(pipeline_lasso, "HOST_TAIL", host_tail)
    port = Prover(F, seed=0, device="cpu", protocol_version=version)
    before = dict(ligero_dev.LAUNCHES), dict(keccak.LAUNCHES)
    zerocheck_dev_ext.reset_counters()
    pipeline_lasso.DEVICE_ROUNDS["count"] = 0
    port_ligero.STITCHED.update(dev_columns=0, host_rows=0)
    proof = port.prove(program, entry, None, 1 << 16, segments, tape)
    data = zt.serialization.BinarySerializer(zt.BabyBear).serialize(proof)
    assert (dict(ligero_dev.LAUNCHES), dict(keccak.LAUNCHES)) == before  # plain versions on the CPU
    zerochecks = count_zerocheck_proofs(proof)
    assert zerochecks >= 12 and zerocheck_dev_ext.DEVICE_PROVES["count"] == zerochecks
    assert zerocheck_dev_ext.COLUMNS["resident"] > zerocheck_dev_ext.COLUMNS["uploaded"] > 0
    assert (pipeline_lasso.DEVICE_ROUNDS["count"] > 0) == (host_tail is not None)
    t = port.last_timings
    assert t["data_commit_path"] == t["advice_commit_path"] == "stream-dev"
    assert t["advice_dev_cols"] == port_ligero.STITCHED["dev_columns"] == 148  # BENCH_r05 advice_dev_cols
    assert port_ligero.STITCHED["host_rows"] > 0  # h_prog and the query-link advice stay host-built
    assert {"data_commit_s", "advice_build_s", "advice_dev_s", "advice_commit_s", "zerochecks_s", "batch_eval_s",
            "open_s", "unified_s", "lasso_s", "data_upload_s", "data_stream_s"} <= set(t)
    # v4 has no forest: the witness MLEs are columns of the DATA commitment
    assert ("forest_s" in t) == (version < 4) == bool(proof.witness_commitments)

    monkeypatch.setenv("ZIGZ_TPU_COMMITMENTS", "host")
    ref = ReferenceProver(F, seed=0, protocol_version=version)
    ref_data = BinarySerializer(F).serialize(ref.prove(program, entry, None, 1 << 16, segments, tape))
    assert ref.last_timings["data_commit_path"] == "host"
    assert data == ref_data
    pinned = PINNED[V2_CASES[case]["pinned"]]
    assert (len(ref_data), hashlib.sha256(ref_data).hexdigest()) == (pinned["bytes"], pinned["sha256"])
    # The port's proof under zigz_tpu's verifier, zigz_tpu's under the port's.
    restored = BinarySerializer(F).deserialize(data)
    assert restored.metadata.version == version
    assert Verifier(F).verify(restored, program) == VerificationResult.Accept
    ported = zt.serialization.BinarySerializer(zt.BabyBear).deserialize(ref_data)
    assert zt.Verifier(zt.BabyBear).verify(ported, program) == "Accept"


def test_pinned_v1_digest_matches_zigz_tpu(monkeypatch):
    """The small v1 entry of proof_digests.json is what zigz_tpu's host path
    and the port produce now (the v2 entries are held in the cases above)."""
    case = PINNED["v1-nop-2^10"]
    program = bytes([0x13, 0x00, 0x00, 0x00] * case["program"]["count"])
    monkeypatch.setenv("ZIGZ_TPU_COMMITMENTS", "host")
    ref = BinarySerializer(F).serialize(
        ReferenceProver(F, seed=0).prove(program, 0x1000, None, case["max_steps"], None, None))
    port = zt.serialization.BinarySerializer(zt.BabyBear).serialize(
        Prover(F, seed=0, device="cpu").prove(program, 0x1000, None, case["max_steps"], None, None))
    assert ref == port
    assert (len(ref), hashlib.sha256(ref).hexdigest()) == (case["bytes"], case["sha256"])


def test_pinned_digests_cover_what_chip_smoke_proves():
    smoke = (ROOT / "chip_smoke.py").read_text()
    for name, case in PINNED.items():
        assert set(case) >= {"protocol_version", "program", "max_steps", "num_steps", "bytes", "sha256"}
        assert case["size"] == "small" or f'"{name}"' in smoke, name


_NO_JAX_V2 = """
import hashlib, json, sys
sys.modules["jax"] = None  # any import of jax or of the JAX package now raises ImportError
sys.modules["zigz_tpu"] = None
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(1)  # the suite runs several workers on a few cores
import zigz_tpu_torch as zt
from zigz_tpu_torch.ops import zerocheck_dev_ext
from zigz_tpu_torch.proofs.zerocheck import ZerocheckExtProver, count_zerocheck_proofs

seen = []
_prove = ZerocheckExtProver.prove
def _recording_prove(self, transcript):
    seen.append((self.device, self.dev_columns))
    return _prove(self, transcript)
ZerocheckExtProver.prove = _recording_prove

program = open({program!r}, "rb").read() if {program!r} else bytes([0x13, 0, 0, 0] * 1024)
entry, segments = 0x1000, None
if zt.elf.is_elf(program):
    loaded = zt.elf.load(program)
    entry, segments = loaded.entry_pc, loaded.segments
ser = zt.serialization.BinarySerializer(zt.BabyBear)
port = zt.Prover(zt.BabyBear, seed=0, device="cpu", protocol_version={version!r})
proof = port.prove(program, entry, None, 1 << 16, segments, {tape!r})
data = ser.serialize(proof)
assert port.last_timings["data_commit_path"] == "stream-dev", port.last_timings
assert port.last_timings["advice_commit_path"] == "stream-dev", port.last_timings
# every zerocheck was handed the device and columns of the resident matrices
assert seen and all(dev == torch.device("cpu") and cols for dev, cols in seen), seen
assert len(seen) == count_zerocheck_proofs(proof) == zerocheck_dev_ext.DEVICE_PROVES["count"]
pinned = json.load(open({digests!r}))["proofs"][{pinned!r}]
assert (len(data), hashlib.sha256(data).hexdigest()) == (pinned["bytes"], pinned["sha256"])
assert zt.Verifier(zt.BabyBear).verify(ser.deserialize(data), program) == "Accept"
assert sys.modules["jax"] is None and sys.modules["zigz_tpu"] is None
print("NO_JAX_V2_OK", len(seen))
"""


@pytest.mark.parametrize("case", sorted(V2_CASES))
def test_v2_proves_with_jax_unimportable(case):
    """With JAX and the JAX package blocked from import, the port proves v2,
    v3 and v4 with every zerocheck on the torch device and fed from the resident
    commit matrices, reproduces the pinned digest and verifies."""
    spec = V2_CASES[case]
    code = _NO_JAX_V2.format(
        root=str(ROOT),
        program=str(FIXTURES / spec["program"]) if spec["program"] else "",
        tape=spec["tape"],
        version=spec["version"],
        digests=str(ROOT / "zigz_tpu_torch" / "testdata" / "proof_digests.json"),
        pinned=spec["pinned"],
    )
    env = {k: v for k, v in os.environ.items() if k != "ZIGZ_TPU_COMMITMENTS"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env=env)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "NO_JAX_V2_OK" in res.stdout


# -- protocols v3 and v4: what the port's verifier rejects -------------------
# (the tamper cases of tests/test_v3_protocol.py and tests/test_v4_protocol.py)

def _adds_program(n_adds=60):
    body = bytes([0x93, 0x00, 0x30, 0x00, 0x13, 0x01, 0x40, 0x00])
    body += bytes([0xB3, 0x81, 0x20, 0x00]) * n_adds
    return body + bytes([0x73, 0x00, 0x10, 0x00])


@pytest.fixture(scope="module")
def port_proofs():
    program = _adds_program()
    return program, {
        version: zt.Prover(zt.BabyBear, seed=0, device="cpu", protocol_version=version).prove(
            program, 0x1000, None, 1 << 10, None, None)
        for version in (2, 3, 4)
    }


def _port_verify(proof, program):
    return zt.Verifier(zt.BabyBear).verify(proof, program)


@pytest.mark.parametrize("version", [3, 4])
def test_v3_v4_accept_and_roundtrip(port_proofs, version):
    program, proofs = port_proofs
    proof = proofs[version]
    assert proof.metadata.version == version
    assert bool(proof.witness_commitments) == (version == 3)
    assert _port_verify(proof, program) == "Accept"
    ser = zt.serialization.BinarySerializer(zt.BabyBear)
    blob = ser.serialize(proof)
    restored = ser.deserialize(blob)
    assert restored.metadata.version == version
    assert _port_verify(restored, program) == "Accept"
    assert ser.serialize(restored) == blob


def test_v3_rejects_sha3_commitments(port_proofs):
    """A v2 proof relabeled as v3 must fail (different hasher)."""
    program, proofs = port_proofs
    relabeled = copy.deepcopy(proofs[2])
    relabeled.metadata.version = 3
    assert _port_verify(relabeled, program) != "Accept"


def test_v3_rejects_tampered_opening(port_proofs):
    program, proofs = port_proofs
    t = copy.deepcopy(proofs[3])
    t.witness_commitments[7].proof.merkle_proof.path.siblings[0] = bytes(32)
    assert _port_verify(t, program) == "RejectInvalidCommitment"


def test_v4_all_43_columns_bound(port_proofs):
    _, proofs = port_proofs
    assert set(proofs[4].v2.witness_evals) == set(WITNESS_POLY_NAMES)
    assert len(proofs[4].v2.unified.data_root) == 32


@pytest.mark.parametrize("column", ["x5", "pc", "mem_is_read"])
def test_v4_tampered_witness_eval_rejected(port_proofs, column):
    """Forging a witness column eval is rejected by the Ligero binding (x5:
    no other argument opens it) or by the cross-commitment consistency of
    pc / mem_is_read with the core zerocheck columns."""
    program, proofs = port_proofs
    t = copy.deepcopy(proofs[4])
    t.v2.witness_evals[column] = (t.v2.witness_evals[column] + 1) % F.MODULUS
    assert _port_verify(t, program) != "Accept"


@pytest.mark.parametrize("what", ["root", "section"])
def test_v4_tampered_commitment_rejected(port_proofs, what):
    program, proofs = port_proofs
    t = copy.deepcopy(proofs[4])
    if what == "root":
        t.v2.unified.data_root = bytes(32)
    else:
        t.v2.witness_evals = None
    assert _port_verify(t, program) != "Accept"


def test_v4_wrong_program_rejected(port_proofs):
    _, proofs = port_proofs
    with pytest.raises(ProgramHashMismatch):
        _port_verify(proofs[4], _adds_program(n_adds=61))
