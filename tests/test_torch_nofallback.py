"""No fallback hides the device or the kernels.

* ``device="cuda"`` without a CUDA device raises; nothing becomes the CPU.
* The kernel build raises with a clear message when nvcc is missing, when
  nvcc fails (its stderr is in the error), and when the library does not
  load; it never returns a fallback.
* The Ligero entry points on a CUDA tensor build the kernels or raise;
  they never hash on the host.
* The port reads no ``ZIGZ_TPU_*`` environment variable.
* ``chip_smoke.py`` exits non-zero and prints no result without a card.
"""

import pathlib
import stat
import subprocess
import sys

import numpy as np
import pytest
import torch

from zigz_tpu.core.field import BabyBear as F
from zigz_tpu_torch.commitments.ligero import ligero_commit_mixed
from zigz_tpu_torch.device import card_info, resolve_device
from zigz_tpu_torch.ops import _build, ligero_dev, witness_dev
from zigz_tpu_torch.prover.prover import Prover

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def test_prover_on_cuda_raises_without_a_card(no_cuda):
    with pytest.raises(RuntimeError, match="cuda"):
        Prover(F, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        witness_dev.from_numpy(np.zeros((43, 4), dtype=np.uint32), "cuda")


def test_device_is_required_and_checked(no_cuda):
    with pytest.raises(TypeError):
        Prover(F)  # no default device
    with pytest.raises(ValueError):
        resolve_device(None)
    with pytest.raises(ValueError):
        resolve_device("meta")
    with pytest.raises(RuntimeError):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.fixture
def fresh_build(monkeypatch, tmp_path):
    """An empty build directory and no cached library in this process."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LOADED", None)
    return tmp_path


def _fake_nvcc(tmp_path, body):
    path = tmp_path / "nvcc"
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def test_build_raises_when_nvcc_is_missing(fresh_build, monkeypatch):
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.load()
    assert _build._LOADED is None


def test_build_raises_with_nvcc_stderr(fresh_build, monkeypatch):
    nvcc = _fake_nvcc(fresh_build, 'echo "sha3_kernels.cu(1): error: no such thing" >&2\nexit 2\n')
    monkeypatch.setattr(_build, "find_nvcc", lambda: nvcc)
    with pytest.raises(_build.KernelBuildError, match="no such thing"):
        _build.load()


def test_build_raises_when_the_library_does_not_load(fresh_build, monkeypatch):
    # A "compiler" that writes garbage to the -o path and succeeds.
    nvcc = _fake_nvcc(
        fresh_build,
        'while [ "$1" != "-o" ]; do shift; done\necho garbage > "$2"\nexit 0\n',
    )
    monkeypatch.setattr(_build, "find_nvcc", lambda: nvcc)
    with pytest.raises(_build.KernelBuildError, match="could not load"):
        _build.load()


def test_build_hashes_the_sources():
    units, headers = _build._sources()
    assert [p.name for p in units] == ["ligero_kernels.cu", "sha3_kernels.cu"]
    assert [p.name for p in headers] == ["keccak.cuh"]
    path = _build._library_path(units, headers)
    assert path.parent == _build.BUILD_DIR and path.suffix == ".so"
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)


class _OnCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to reach the kernel branch
    of a wrapper on a host without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("entry", ["sha3_columns", "sha3_absorb"])
def test_ligero_wrappers_on_cuda_build_the_kernels_or_raise(entry, fresh_build, monkeypatch):
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    msg = torch.zeros((34, 4), dtype=torch.int32).as_subclass(_OnCuda)
    state = torch.zeros((25, 4), dtype=torch.int64).as_subclass(_OnCuda)
    before = dict(ligero_dev.LAUNCHES)
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        if entry == "sha3_columns":
            ligero_dev.sha3_columns(msg)
        else:
            ligero_dev.sha3_absorb(state, msg, 0, 1, 40)
    assert ligero_dev.LAUNCHES == before


def test_ligero_commits_on_cuda_raise_without_a_card(no_cuda):
    cols = {"a": np.arange(16, dtype=np.uint64)}
    with pytest.raises(RuntimeError, match="cuda"):
        ligero_commit_mixed(F, cols, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        Prover(F, device="cuda", protocol_version=2)


def test_port_reads_no_zigz_tpu_variable(monkeypatch):
    """zigz_tpu's ZIGZ_TPU_COMMITMENTS=host forces its host commit; the
    port's commit stays on its device path."""
    monkeypatch.setenv("ZIGZ_TPU_COMMITMENTS", "host")
    cols = {"a": np.arange(1 << 6, dtype=np.uint64), "b": np.arange(1 << 3, dtype=np.uint64)}
    assert ligero_commit_mixed(F, cols, device="cpu").commit_path == "stream-dev"
    sources = sorted((ROOT / "zigz_tpu_torch").rglob("*.py"))
    assert sources and not [p.name for p in sources if "ZIGZ_TPU_" in p.read_text()]


def test_card_info_reports_without_a_card(no_cuda):
    info = card_info()
    assert info["cuda_available"] is False and info["device_count"] == 0
    assert info["torch"] == torch.__version__


def test_chip_smoke_fails_without_a_card(no_cuda):
    res = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
    )
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_fails_alone(no_cuda, tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    (tmp_path / "chip_smoke.py").write_bytes((ROOT / "chip_smoke.py").read_bytes())
    res = subprocess.run(
        [sys.executable, "chip_smoke.py"], capture_output=True, text=True, timeout=300, cwd=tmp_path,
    )
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
