"""bench_torch.py, the port's bench, and the multiply chain of its headline.

The chain's plain version is held to the JAX package's chain (bench.py's
eight ``mont_mul`` in Montgomery form) and to x * y^8 mod p, and the CUDA
source's Montgomery constants to the same result in numpy; the bench itself
runs on the CPU at 2^10 NOP steps, where its proofs must equal the pins of
zigz_tpu_torch/testdata/proof_digests.json.  Tolerance zero throughout."""

import json
import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_torch
from zigz_tpu.ops import babybear as jax_bb
from zigz_tpu_torch.ops import _build
from zigz_tpu_torch.ops import babybear as bb

ROOT = pathlib.Path(__file__).resolve().parent.parent
PINNED = json.loads((ROOT / "zigz_tpu_torch" / "testdata" / "proof_digests.json").read_text())["proofs"]
P = bb.P


def _chain_inputs(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, P, size=n, dtype=np.int64)
    y = rng.integers(0, P, size=n, dtype=np.int64)
    x[:3], y[:3] = [0, 1, P - 1], [P - 1, 1, 0]
    x[3:6] = y[3:6] = [0, 1, P - 1]
    return x, y


def _expected(x, y):
    return np.array([int(a) * pow(int(b), bb.CHAIN, P) % P for a, b in zip(x, y)], dtype=np.int64)


def test_plain_chain_matches_the_jax_chain():
    """bench.py's chain: eight mont_mul over to_mont inputs, from_mont after."""
    x, y = _chain_inputs(1 << 12, 0)

    @jax.jit
    def chain(a, b):
        for _ in range(8):
            a = jax_bb.mont_mul(a, b)
        return a

    xm = jax_bb.to_mont(jnp.asarray(x.astype(np.uint32)))
    ym = jax_bb.to_mont(jnp.asarray(y.astype(np.uint32)))
    want = np.asarray(jax_bb.from_mont(chain(xm, ym))).astype(np.int64)
    got = bb._mul_chain_plain(torch.from_numpy(x.astype(np.int32)), torch.from_numpy(y.astype(np.int32)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)
    np.testing.assert_array_equal(want, _expected(x, y))


def _kernel_constants():
    csrc = ROOT / "zigz_tpu_torch" / "csrc"
    field = (csrc / "babybear.cuh").read_text()  # the field helpers field_kernels.cu includes
    src = (csrc / "field_kernels.cu").read_text()
    assert '#include "babybear.cuh"' in src
    return {name: int(re.search(rf"constexpr \w+ {name} = (0x[0-9a-f]+|\d+)u;", field).group(1), 0)
            for name in ("kP", "kNegPInv", "kR2")} | {
        "kChain": int(re.search(r"constexpr int kChain = (\d+);", src).group(1))}


def test_kernel_arithmetic_in_numpy_matches_the_plain_chain():
    """The kernel's steps, in numpy uint64 with its own constants: y into
    Montgomery form by REDC(y * R^2), then kChain times v = REDC(v * yR)."""
    c = _kernel_constants()
    assert (c["kP"], c["kChain"]) == (P, bb.CHAIN)
    mask = np.uint64(0xFFFFFFFF)

    def redc(t):
        m = (t & mask) * np.uint64(c["kNegPInv"]) & mask
        u = (t + m * np.uint64(c["kP"])) >> np.uint64(32)
        return np.where(u >= c["kP"], u - np.uint64(c["kP"]), u)

    x, y = _chain_inputs(1 << 12, 1)
    y_mont = redc(y.astype(np.uint64) * np.uint64(c["kR2"]))
    v = x.astype(np.uint64)
    for _ in range(c["kChain"]):
        v = redc(v * y_mont)
    plain = bb._mul_chain_plain(torch.from_numpy(x.astype(np.int32)), torch.from_numpy(y.astype(np.int32)))
    np.testing.assert_array_equal(v.astype(np.int64), plain.numpy().astype(np.int64))
    np.testing.assert_array_equal(v.astype(np.int64), _expected(x, y))


def test_mul_chain_on_the_cpu_takes_the_plain_version_and_checks_its_inputs():
    x, y = (torch.from_numpy(a.astype(np.int32)) for a in _chain_inputs(257, 2))
    before = dict(bb.LAUNCHES)
    assert torch.equal(bb.mul_chain(x, y), bb._mul_chain_plain(x, y))
    assert bb.LAUNCHES == before
    with pytest.raises(ValueError, match="int32"):
        bb.mul_chain(x.to(torch.int64), y)
    with pytest.raises(ValueError, match="differ"):
        bb.mul_chain(x, y[:-1])
    with pytest.raises(ValueError, match="int32"):
        bb.mul_chain(x.view(1, -1), y.view(1, -1))


class _OnCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to reach the kernel branch."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_mul_chain_on_cuda_builds_the_kernel_or_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LOADED", None)
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    x = torch.zeros(4, dtype=torch.int32).as_subclass(_OnCuda)
    before = dict(bb.LAUNCHES)
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        bb.mul_chain(x, x)
    assert bb.LAUNCHES == before


@pytest.mark.parametrize("version, v, first, want", [
    (1, 14, False, (4, True)), (1, 20, False, (4, True)), (1, 22, False, (5, False)),
    (1, 24, False, (3, False)), (1, 25, False, (3, False)),
    (2, 16, True, (2, False)), (2, 20, False, (3, False)), (3, 20, False, (2, False)), (4, 20, False, (2, False)),
])
def test_passes_per_size(version, v, first, want):
    assert bench_torch._passes(version, v, first) == want


def test_hold_takes_the_pin_or_the_first_verified_pass():
    case = PINNED["v1-nop-2^10"]
    good = (case["bytes"], case["sha256"])
    assert bench_torch.hold("v1-nop-2^10", case["num_steps"], [good, good], PINNED, None) == "pinned"
    with pytest.raises(bench_torch.ProofMismatch, match="differ from the pin"):
        bench_torch.hold("v1-nop-2^10", case["num_steps"], [good, (case["bytes"], "0" * 64)], PINNED, None)
    with pytest.raises(bench_torch.ProofMismatch, match="differ from the pin"):
        bench_torch.hold("v1-nop-2^10", case["num_steps"] + 1, [good], PINNED, None)
    assert bench_torch.hold("v1-nop-2^24", 1 << 24, [(5, "a"), (5, "a")], PINNED, "Accept").startswith("unpinned")
    with pytest.raises(bench_torch.ProofMismatch, match="passes' proofs differ"):
        bench_torch.hold("v1-nop-2^24", 1 << 24, [(5, "a"), (5, "b")], PINNED, "Accept")
    with pytest.raises(bench_torch.ProofMismatch, match="not accepted"):
        bench_torch.hold("v1-nop-2^24", 1 << 24, [(5, "a")], PINNED, "RejectInvalidCommitment")


def _run_bench(*args, timeout=300):
    env = dict(os.environ, OMP_NUM_THREADS="2")  # the suite runs several workers on a few cores
    return subprocess.run([sys.executable, str(ROOT / "bench_torch.py"), *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


@pytest.fixture(scope="module")
def cpu_line():
    res = _run_bench("--device", "cpu", "--v1", "10", "--v2", "10", "--v3", "--v4")
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_cpu_run_prints_the_line_of_bench_py(cpu_line):
    assert (cpu_line["metric"], cpu_line["value"], cpu_line["unit"]) == (
        "babybear_field_ops_per_s_per_chip", None, "field_mul/s")
    extra = cpu_line["extra"]
    assert cpu_line["vs_baseline"] == extra["prover_steps_per_s"] / bench_torch.ASPIRATIONAL_STEPS_PER_S > 0
    assert (extra["backend"], extra["cuda_device"], extra["triton"], extra["budget_s"]) == ("cpu", None, False, 1500)
    assert extra["torch_version"] == torch.__version__ and "no rate" in extra["field_ops_note"]
    assert "torch_int64_mul_per_s" not in extra
    assert len(extra["host_anchor_s"]) == 2 and all(t > 0 for t in extra["host_anchor_s"])
    assert extra["skipped_for_budget"] == [] and extra["elapsed_s"] > 0
    for key in ("prover_steps_per_s", "prover_num_steps", "prover_warm_s", "prover_warm_stddev_s",
                "prover_phase_timings_s", "v2_prover_steps_per_s", "v2_num_steps", "v2_pass_s", "v2_proof_bytes",
                "v2_verify_s", "v2_phase_timings_s", "v2_counters"):
        assert key in extra, key
    assert extra["v2_phase_timings_s"]["data_commit_path"] == extra["v2_phase_timings_s"]["advice_commit_path"]
    assert extra["v2_counters"]["zerochecks"] == extra["v2_counters"]["device_zerochecks"] > 0
    # the CPU builds no generated kernel: no wait on nvcc, only the host's tracing and lowering,
    # part of it when the zerochecks are made after the advice phases
    passes = extra["v2_zerocheck_passes"]
    assert len(passes) == len(extra["v2_pass_s"]) and all(
        z["dag_build_s"] == 0 and 0 < z["zerocheck_host_s"] < z["zerochecks_s"] and z["zerocheck_start_s"] > 0
        for z in passes)
    assert extra["v2_phase_timings_s"]["dag_build_s"] == 0


def test_cpu_run_holds_every_proof_to_its_pin(cpu_line):
    extra = cpu_line["extra"]
    (entry,) = extra["v1_ladder"]
    for pin, got in ((PINNED["v1-nop-2^10"], (entry["num_steps"], entry["proof_bytes"], entry["sha256"])),
                     (PINNED["v2-nop-2^10"], (extra["v2_num_steps"], extra["v2_proof_bytes"], extra["v2_sha256"]))):
        assert got == (pin["num_steps"], pin["bytes"], pin["sha256"])
    assert entry["held"] == extra["v2_held"] == "pinned"
    assert len(extra["v2_pass_s"]) == 2 and extra["v2_verify_s"] > 0


def test_cpu_run_v1_ladder_entry(cpu_line):
    (entry,) = cpu_line["extra"]["v1_ladder"]
    assert 2 <= len(entry["pass_s"]) <= 4 and entry["min_s"] == min(entry["pass_s"])
    assert entry["steps_per_s"] == 1024 / entry["min_s"] == cpu_line["extra"]["prover_steps_per_s"]
    assert entry["forest_plan"]["groups"] == 1 and entry["launches"] == {"K1": 0, "K2": 0}
    assert entry["max_memory_allocated_B"] is None and "total_s" in entry["last_timings"]


def test_spent_budget_skips_every_later_stage():
    res = _run_bench("--device", "cpu", "--budget-s", "0", "--v1", "10", "12", "--v2", "--v3", "10", "--v4", "10")
    assert res.returncode == 0, res.stderr
    extra = json.loads(res.stdout.strip().splitlines()[-1])["extra"]
    assert [e["num_steps"] for e in extra["v1_ladder"]] == [1024]
    assert extra["skipped_for_budget"] == ["v1 2^12", "v3 2^10", "v4 2^10"]


def test_default_run_without_a_card_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    res = _run_bench(timeout=120)
    assert res.returncode != 0
    assert "torch.cuda.is_available() is False" in res.stderr
    assert not any(line.lstrip().startswith("{") for line in res.stdout.splitlines())
