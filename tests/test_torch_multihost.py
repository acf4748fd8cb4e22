"""Two-process jobs of the port through parallel/launch.py: the cases of
tests/test_multihost.py (a two-rank v2 prove byte-identical to zigz_tpu's
single-process proof; a killed rank fails the job fast and the relaunch gives
the reference bytes), the launcher's failure policy, and the multi-rank dry
run of ``__graft_entry_torch__.py``.  Ranks are gloo CPU processes."""

import hashlib
import os
import sys
import time

import pytest

from zigz_tpu.core.field import BabyBear
from zigz_tpu.prover.prover import Prover
from zigz_tpu.prover.serialization import BinarySerializer
from zigz_tpu_torch.parallel.launch import LaunchFailed, launch
from torch_group_checks import COMMAND

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOP_128 = {"kind": "nop", "count": 128}
SPEC = {"program": NOP_128, "max_steps": 1 << 9, "protocol_version": 2}


@pytest.fixture(scope="module")
def reference_sha():
    """zigz_tpu's single-process proof of the job's program."""
    program = bytes([0x13, 0x00, 0x00, 0x00] * 128)
    proof = Prover(BabyBear, seed=0, protocol_version=2).prove(program, 0x1000, None, 1 << 9, None, None)
    return hashlib.sha256(BinarySerializer(BabyBear).serialize(proof)).hexdigest()


def test_two_process_group_prove_byte_identical(tmp_path, reference_sha):
    results = launch(2, "prove", SPEC, work_dir=str(tmp_path), device="cpu", timeout_s=240)
    assert [(r["rank"], r["world_size"]) for r in results] == [(0, 2), (1, 2)]
    for res in results:
        # a genuine cross-process collective ran: the sums and digests crossed ranks
        assert res["launches"]["collectives"]["all_reduce"] > 0 and res["launches"]["collectives"]["all_to_all"] > 0
    assert results[0]["sha256"] == results[1]["sha256"] == reference_sha


def test_two_process_killed_rank_fail_fast_restart(tmp_path, reference_sha):
    """Rank 1 suffers a simulated host loss (SIGKILL after initialize): the
    job fails fast, the survivor is killed by its exact PID, no partial
    result is left, and a clean relaunch gives the reference bytes."""
    t0 = time.monotonic()
    with pytest.raises(LaunchFailed, match="rank 1 exited with code -9"):
        launch(2, "prove_lost_rank", dict(SPEC, lost_rank=1), work_dir=str(tmp_path), device="cpu", timeout_s=240,
               command=COMMAND)
    assert time.monotonic() - t0 < 60  # not the collective's timeout, let alone the job's
    assert not [f for f in os.listdir(tmp_path) if f.startswith("result_")], "partial results leaked"
    results = launch(2, "prove", SPEC, work_dir=str(tmp_path), device="cpu", timeout_s=240)
    assert {r["sha256"] for r in results} == {reference_sha}


def test_launcher_fails_on_an_unknown_function_and_on_its_deadline(tmp_path):
    with pytest.raises(LaunchFailed, match="unknown job function"):
        launch(2, "no_such_job", {}, work_dir=str(tmp_path / "a"), device="cpu", timeout_s=120)
    assert not [f for f in os.listdir(tmp_path / "a") if f.startswith("result_")]
    with pytest.raises(LaunchFailed, match="deadline"):
        launch(1, "prove", dict(SPEC, program={"kind": "nop", "count": 1 << 12}, max_steps=1 << 13),
               work_dir=str(tmp_path / "b"), device="cpu", timeout_s=0.5)
    assert not [f for f in os.listdir(tmp_path / "b") if f.startswith("result_")]


def test_an_unknown_backend_fails_the_job(tmp_path):
    with pytest.raises(LaunchFailed, match="unknown backend"):
        launch(1, "prove", SPEC, work_dir=str(tmp_path), device="cpu", backend="mpi", timeout_s=120)


def test_a_cuda_group_without_a_card_fails_the_job(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(LaunchFailed, match="torch.cuda.is_available\\(\\) is False"):
        launch(2, "prove", SPEC, work_dir=str(tmp_path), device="cuda:0", timeout_s=120)


def _dryrun(log2_steps, capsys):
    sys.path.insert(0, ROOT)
    try:
        import __graft_entry_torch__ as graft
    finally:
        sys.path.remove(ROOT)
    graft.dryrun_multichip(2, device="cpu", log2_steps=log2_steps)
    out = capsys.readouterr().out
    assert f"dryrun_multichip OK: 2 ranks on cpu, REAL pipeline ({1 << log2_steps} steps" in out
    assert "'data_commit_sharded': True" in out and "'advice_commit_sharded': True" in out


def test_dryrun_multichip_defaults_to_the_card():
    """Like every entry point of the port, the dry run runs on the card unless
    the caller asks for the CPU: without a card it raises."""
    import inspect

    import torch

    sys.path.insert(0, ROOT)
    try:
        import __graft_entry_torch__ as graft
    finally:
        sys.path.remove(ROOT)
    assert inspect.signature(graft.dryrun_multichip).parameters["device"].default == "cuda:0"
    assert inspect.signature(graft.entry).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        graft.dryrun_multichip(2, log2_steps=4)


def test_dryrun_multichip_two_ranks(capsys):
    """The dry run at 2^10 steps (the 2^14-step run is the slow case below)."""
    _dryrun(10, capsys)


@pytest.mark.slow
def test_dryrun_multichip_two_ranks_full_size(capsys):
    _dryrun(14, capsys)


def test_graft_entry_step():
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    try:
        import __graft_entry_torch__ as graft
    finally:
        sys.path.remove(ROOT)
    fn, args = graft.entry(device="cpu")
    assert [tuple(a.shape) for a in args] == [(43, 1024), (43, 10), (1,)]
    evals, g0, g1, folded = fn(*args)
    assert evals.shape == g0.shape == g1.shape == (43,) and folded.shape == (43, 512)
    assert all(t.dtype == torch.int64 and int(t.min()) >= 0 and int(t.max()) < 2013265921
               for t in (evals, g0, g1, folded))
    assert np.array_equal((g0 + g1).numpy() % 2013265921, args[0].sum(dim=1).numpy() % 2013265921)
