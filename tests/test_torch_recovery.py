"""Failure detection + deterministic restart of the port
(zigz_tpu_torch/parallel/recovery.py): the six cases of tests/test_recovery.py
with the worker on ``device="cpu"``, held to zigz_tpu's proof bytes; a
supervised proof equal to the golden fixture; the CLI's ``prove --supervise``."""

import hashlib
import json
import os
import pathlib
import subprocess
import sys

import pytest

from zigz_tpu.core.field import BabyBear as F
from zigz_tpu.prover.prover import Prover
from zigz_tpu.prover.serialization import BinarySerializer
from zigz_tpu_torch.parallel.recovery import JobFailed, JobSupervisor, ProveJobSpec

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "fixtures"
PROGRAM = bytes([
    0x93, 0x00, 0x50, 0x00,  # ADDI x1, x0, 5
    0x13, 0x01, 0xA0, 0x00,  # ADDI x2, x0, 10
    0xB3, 0x01, 0x20, 0x00,  # ADD x3, x1, x2
    0x73, 0x00, 0x10, 0x00,  # EBREAK
])


def reference_bytes(protocol_version: int = 1) -> bytes:
    """zigz_tpu's in-process proof of PROGRAM."""
    proof = Prover(F, seed=0, protocol_version=protocol_version).prove(PROGRAM, 0x1000, None, 1 << 10, None, None)
    return BinarySerializer(F).serialize(proof)


def spec(**kwargs) -> ProveJobSpec:
    kwargs.setdefault("program", PROGRAM)
    kwargs.setdefault("max_steps", 1 << 10)
    return ProveJobSpec(device="cpu", **kwargs)


def test_spec_round_trip_carries_the_device():
    s = ProveJobSpec(program=PROGRAM, input_tape=[1, 2], protocol_version=3, device="cuda:1", fault="hang_once")
    back = ProveJobSpec.from_json(s.to_json())
    assert back == s and back.device == "cuda:1" and back.program == PROGRAM
    assert ProveJobSpec(program=PROGRAM).device == "cuda"  # the entry points default to the card
    assert json.loads(s.to_json())["program"] == PROGRAM.hex()


def test_clean_run(tmp_path):
    sup = JobSupervisor(str(tmp_path / "job"), heartbeat_timeout_s=10, deadline_s=120, max_restarts=0)
    res = sup.run(spec())
    assert res.restarts == 0 and res.attempts == 1
    with open(res.proof_path, "rb") as f:
        data = f.read()
    assert hashlib.sha256(data).hexdigest() == res.sha256
    assert data == reference_bytes()
    assert res.journal[0]["num_steps"] == 4 and res.journal[0]["bytes"] == len(data)


def test_crash_restart_is_deterministic(tmp_path):
    """SIGKILL'd worker (simulated host loss) -> detected via process death
    -> restart produces the same proof bytes as an in-process prove."""
    sup = JobSupervisor(str(tmp_path / "job"), heartbeat_timeout_s=10, deadline_s=120, max_restarts=2)
    res = sup.run(spec(fault="crash_once"))
    assert res.restarts == 1
    with open(res.proof_path, "rb") as f:
        assert f.read() == reference_bytes()
    # The journal records exactly the successful attempt.
    assert len(res.journal) == 1 and res.journal[0]["attempt"] == 2


def test_hang_detected_by_heartbeat(tmp_path):
    """Frozen worker (SIGSTOP: all threads halt, heartbeat goes stale) ->
    killed by the supervisor on staleness -> restart completes.  The first
    beat comes before torch is imported, so staleness, not the start-up
    grace, is what fires."""
    sup = JobSupervisor(str(tmp_path / "job"), heartbeat_timeout_s=2.0, deadline_s=120, max_restarts=2,
                        startup_grace_s=1000.0)
    res = sup.run(spec(fault="hang_once"))
    assert res.restarts == 1
    with open(res.proof_path, "rb") as f:
        assert f.read() == reference_bytes()


def test_gives_up_after_max_restarts(tmp_path):
    """A spec that always fails exhausts restarts and raises."""
    sup = JobSupervisor(str(tmp_path / "job"), heartbeat_timeout_s=10, deadline_s=120, max_restarts=1)
    # Empty program -> prover raises EmptyTrace -> worker rc != 0 on every attempt.
    with pytest.raises(JobFailed, match="gave up after 2 attempts"):
        sup.run(spec(program=b"", max_steps=16))


def test_a_cuda_job_without_a_card_fails_and_never_proves_on_the_cpu(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    sup = JobSupervisor(str(tmp_path / "job"), heartbeat_timeout_s=10, deadline_s=120, max_restarts=0)
    with pytest.raises(JobFailed):
        sup.run(ProveJobSpec(program=PROGRAM, max_steps=1 << 10))  # device defaults to "cuda"
    assert not os.path.exists(tmp_path / "job" / "proof.bin")


def test_nondeterminism_is_rejected(tmp_path):
    """A forged journal with two digests must fail loudly, not return a
    proof (the purity invariant is enforced, not assumed)."""
    job_dir = tmp_path / "job"
    sup = JobSupervisor(str(job_dir), heartbeat_timeout_s=10, deadline_s=120, max_restarts=0)
    os.makedirs(job_dir, exist_ok=True)
    with open(job_dir / "journal.jsonl", "w") as f:
        f.write(json.dumps({"attempt": 0, "sha256": "deadbeef", "bytes": 1}) + "\n")
    with pytest.raises(JobFailed, match="nondeterministic"):
        sup.run(spec())


def test_v2_spec_roundtrip(tmp_path):
    """Protocol v2 jobs run under the supervisor too."""
    sup = JobSupervisor(str(tmp_path / "job"), heartbeat_timeout_s=10, deadline_s=180, max_restarts=0)
    res = sup.run(spec(protocol_version=2))
    with open(res.proof_path, "rb") as f:
        assert f.read() == reference_bytes(protocol_version=2)


def test_supervised_proof_equals_the_golden_fixture(tmp_path):
    program = (FIXTURES / "fibonacci_program.bin").read_bytes()
    from zigz_tpu_torch import elf

    loaded = elf.load(program)
    sup = JobSupervisor(str(tmp_path / "job"), heartbeat_timeout_s=10, deadline_s=120, max_restarts=0)
    res = sup.run(spec(program=program, entry_pc=loaded.entry_pc, max_steps=1 << 16, input_tape=[10]))
    with open(res.proof_path, "rb") as f:
        assert f.read() == (FIXTURES / "fibonacci_v1.bin").read_bytes()


def test_cli_prove_supervise_on_the_cpu(tmp_path):
    program_path, proof_path = tmp_path / "program.bin", tmp_path / "p.bin"
    program_path.write_bytes(PROGRAM)
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cli = [sys.executable, "-m", "zigz_tpu_torch.cli"]
    res = subprocess.run(cli + ["prove", str(program_path), "--supervise", "--device", "cpu", "--out", str(proof_path)],
                         capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "steps 4 (supervised, restarts=0)" in res.stdout and f"wrote proof to {proof_path}" in res.stdout
    assert proof_path.read_bytes() == reference_bytes()
    res = subprocess.run(cli + ["verify", str(proof_path), str(program_path)],
                         capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path)
    assert res.returncode == 0 and "verify: Accept" in res.stdout
    # --supervise is ported: nothing in the CLI says otherwise
    source = (ROOT / "zigz_tpu_torch" / "cli.py").read_text()
    assert "_NOT_PORTED" not in source and "not yet ported" not in source
