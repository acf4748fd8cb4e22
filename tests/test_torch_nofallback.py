"""No fallback hides the device or the kernels.

* ``device="cuda"`` without a CUDA device raises; nothing becomes the CPU.
* The kernel build raises with a clear message when nvcc is missing, when
  nvcc fails (its stderr is in the error), and when the library does not
  load; it never returns a fallback.
* The Ligero entry points on a CUDA tensor build the kernels or raise;
  they never hash on the host.
* The zerocheck and Lasso dispatch with a device never goes back to the
  host provers: an absent CUDA device raises, a combiner outside the traced
  algebra raises ``TraceError``, and there is no width gate.
* A device advice twin or the Poseidon2 column sponge that fails makes
  the commit and the prove raise; both commits of a v2, v3 and v4 prove take
  the ``"stream-dev"`` path.
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

from zigz_tpu_torch.core.field import BabyBear as F
from zigz_tpu_torch.commitments.ligero import ligero_commit_mixed
from zigz_tpu_torch.device import card_info, resolve_device
from zigz_tpu_torch.ops import _build, ligero_dev, witness_dev
from zigz_tpu_torch.core.hash import FiatShamirTranscript
from zigz_tpu_torch.lookups import pipeline_lasso
from zigz_tpu_torch.ops import zerocheck_dev_ext
from zigz_tpu_torch.ops.symtrace import TraceError
from zigz_tpu_torch.proofs.zerocheck import ZerocheckExtProver
from zigz_tpu_torch.prover.prover import Prover
from zigz_tpu_torch.prover.unified import prove_unified

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several pytest workers on a few cores: torch's own
    intra-op thread pool would oversubscribe them (tens of times slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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
    """The entry points default to the card and raise where there is none;
    below them the device is a required argument."""
    with pytest.raises(RuntimeError, match="cuda"):
        Prover(F)  # the default device is the card
    with pytest.raises(TypeError):
        prove_unified(F, FiatShamirTranscript(), [])
    with pytest.raises(TypeError):
        ligero_commit_mixed(F, {"a": np.arange(16, dtype=np.uint64)})
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


def _zerocheck_columns(n=8):
    a = np.arange(n, dtype=np.uint64)
    return {"a": a, "b": a + np.uint64(1), "c": a * (a + np.uint64(1))}


def _vanishing(cols, alphas, p):
    return alphas[0] * ((cols["a"] * cols["b"] % p + p - cols["c"]) % p) % p


def _untraceable(cols, alphas, p):
    """A reduction by another modulus: outside the traced ring algebra."""
    return _vanishing(cols, alphas, p) + cols["a"] % 7


def test_zerocheck_and_lasso_on_cuda_raise_without_a_card(no_cuda):
    with pytest.raises(RuntimeError, match="cuda"):
        ZerocheckExtProver(F, _zerocheck_columns(), _vanishing, 3, num_alphas=1,
                           device="cuda").prove(FiatShamirTranscript())
    queries = {1: (np.ones((3, 2), dtype=np.uint64), np.ones((3, 1), dtype=np.uint64))}
    with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda"):
        pipeline_lasso.prove_pipeline_lasso(F, FiatShamirTranscript(), queries, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        prove_unified(F, FiatShamirTranscript(), [], device="cuda")


def test_zerocheck_trace_error_raises_on_a_device():
    """With a device a TraceError is not caught (the host dispatch would
    hand such a combiner to the numpy prover), and the transcript is
    untouched when it raises."""
    cols = _zerocheck_columns()
    zerocheck_dev_ext.reset_counters()
    transcript = FiatShamirTranscript()
    with pytest.raises(TraceError, match="reduction by 7"):
        ZerocheckExtProver(F, cols, _untraceable, 3, num_alphas=1, device="cpu").prove(transcript)
    assert zerocheck_dev_ext.DEVICE_PROVES["count"] == 0
    assert transcript.finalize() == FiatShamirTranscript().finalize()


def test_make_zerocheck_prover_raises_on_a_device_where_zigz_tpu_falls_back():
    """``make_zerocheck_prover(device=...)`` hands an untraceable combiner's
    TraceError to the caller (zigz_tpu's function swallows it and returns a
    host prover); without a device the numpy prover takes such a combiner;
    ``device="cuda"`` without a card raises."""
    from zigz_tpu_torch.proofs.zerocheck import ZerocheckProver, make_zerocheck_prover

    cols = {"x": np.arange(8, dtype=np.uint64)}

    def base_untraceable(c, alphas, p):
        return c["x"] % 7

    with pytest.raises(TraceError, match="reduction by 7"):
        make_zerocheck_prover(F, cols, base_untraceable, 2, num_alphas=1, device="cpu")
    assert isinstance(make_zerocheck_prover(F, cols, base_untraceable, 2, num_alphas=1), ZerocheckProver)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            make_zerocheck_prover(F, cols, lambda c, alphas, p: c["x"], 2, num_alphas=1, device="cuda")


@pytest.mark.parametrize("n", [2, 8, 1 << 13])
def test_zerocheck_with_a_device_has_no_width_gate(n):
    zerocheck_dev_ext.reset_counters()
    ZerocheckExtProver(F, _zerocheck_columns(n), _vanishing, 3, num_alphas=1,
                       device="cpu").prove(FiatShamirTranscript())
    assert zerocheck_dev_ext.DEVICE_PROVES["count"] == 1


def test_port_reads_no_zigz_tpu_variable(monkeypatch):
    """zigz_tpu's ZIGZ_TPU_COMMITMENTS=host forces its host commit; the
    port's commit stays on its device path."""
    monkeypatch.setenv("ZIGZ_TPU_COMMITMENTS", "host")
    monkeypatch.setenv("ZIGZ_TPU_ZEROCHECK", "native")
    cols = {"a": np.arange(1 << 6, dtype=np.uint64), "b": np.arange(1 << 3, dtype=np.uint64)}
    assert ligero_commit_mixed(F, cols, device="cpu").commit_path == "stream-dev"
    zerocheck_dev_ext.reset_counters()
    ZerocheckExtProver(F, _zerocheck_columns(), _vanishing, 3, num_alphas=1,
                       device="cpu").prove(FiatShamirTranscript())
    assert zerocheck_dev_ext.DEVICE_PROVES["count"] == 1
    sources = sorted((ROOT / "zigz_tpu_torch").rglob("*.py"))
    assert sources and not [p.name for p in sources if "ZIGZ_TPU_" in p.read_text()]


_NOPS = bytes([0x13, 0, 0, 0] * 16)


@pytest.mark.parametrize("version", [2, 3, 4])
def test_both_commits_take_the_device_path(version):
    """v2 and v4 column-hash with the K5 stream, v3 with the Poseidon2
    sponge over the same device encode stream; no host commit path exists."""
    prover = Prover(F, seed=0, device="cpu", protocol_version=version)
    proof = prover.prove(_NOPS, 0x1000, None, 64, None, None)
    t = prover.last_timings
    assert t["data_commit_path"] == t["advice_commit_path"] == "stream-dev"
    assert t["advice_dev_cols"] == 148 and t["advice_dev_s"] > 0
    assert proof.metadata.version == version
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            Prover(F, protocol_version=version)  # the default device is the card


@pytest.mark.parametrize("argument", ["CoreV2Argument", "RegcheckArgument", "BytecodeArgument"])
def test_a_failing_device_advice_twin_fails_the_prove(argument, monkeypatch):
    from zigz_tpu_torch.constraints import bytecode, core_arg, regcheck

    def boom(self, data_state):
        raise RuntimeError(f"forced failure in {argument}")

    owner = {"CoreV2Argument": core_arg, "RegcheckArgument": regcheck, "BytecodeArgument": bytecode}[argument]
    monkeypatch.setattr(getattr(owner, argument), "device_advice", boom)
    with pytest.raises(RuntimeError, match=f"forced failure in {argument}"):
        Prover(F, seed=0, device="cpu", protocol_version=2).prove(_NOPS, 0x1000, None, 64, None, None)


def test_a_failing_poseidon2_sponge_fails_the_commit_and_the_prove(monkeypatch):
    from zigz_tpu_torch.ops import poseidon2

    def boom(mat, n_e):
        raise RuntimeError("forced failure in the Poseidon2 sponge")

    monkeypatch.setattr(poseidon2, "p2_columns_stream", boom)
    cols = {"a": np.arange(1 << 6, dtype=np.uint64)}
    with pytest.raises(RuntimeError, match="forced failure in the Poseidon2 sponge"):
        ligero_commit_mixed(F, cols, "poseidon2", device="cpu")
    assert ligero_commit_mixed(F, cols, "sha3", device="cpu").commit_path == "stream-dev"
    with pytest.raises(RuntimeError, match="forced failure in the Poseidon2 sponge"):
        Prover(F, seed=0, device="cpu", protocol_version=3).prove(_NOPS, 0x1000, None, 64, None, None)


# -- process groups (parallel/, the group paths) -------------------------------

def test_a_cuda_group_raises_without_a_card(no_cuda, tmp_path):
    from zigz_tpu_torch.parallel import multihost

    with pytest.raises(RuntimeError, match="cuda"):
        multihost.single_process_group("cuda")
    for backend in ("gloo", "nccl"):
        with pytest.raises(RuntimeError, match="cuda"):
            multihost.initialize(backend, 0, 1, device="cuda:0", rendezvous_file=str(tmp_path / backend))
    with pytest.raises(RuntimeError, match="has not been called"):
        multihost.global_trace_group()  # nothing was initialised on the way


def test_an_unknown_backend_raises(tmp_path):
    from zigz_tpu_torch.parallel import multihost

    for backend in ("mpi", "ucc", "", "GLOO"):
        with pytest.raises(ValueError, match="unknown backend"):
            multihost.initialize(backend, 0, 1, device="cpu", rendezvous_file=str(tmp_path / "r"))
        with pytest.raises(ValueError, match="unknown backend"):
            multihost.TraceGroup(rank=0, world_size=1, device=torch.device("cpu"), backend=backend)


def test_a_group_on_another_device_than_the_prover_raises():
    from zigz_tpu_torch.commitments.device_forest import DeviceMerkleForest
    from zigz_tpu_torch.parallel.dist import DistSumcheckProver
    from zigz_tpu_torch.parallel.multihost import TraceGroup

    elsewhere = TraceGroup(rank=0, world_size=1, device=torch.device("cuda", 0), backend="gloo")
    with pytest.raises(ValueError, match="cuda:0"):
        Prover(F, device="cpu", group=elsewhere)
    with pytest.raises(ValueError, match="cuda:0"):
        ligero_commit_mixed(F, {"a": np.arange(16, dtype=np.uint64)}, device="cpu", group=elsewhere)
    with pytest.raises(ValueError, match="cuda:0"):
        prove_unified(F, FiatShamirTranscript(), [], device="cpu", group=elsewhere)
    with pytest.raises(ValueError, match="cuda:0"):
        DistSumcheckProver(F, elsewhere, device="cpu")
    with pytest.raises(ValueError, match="cuda:0"):
        DeviceMerkleForest(F, lo=torch.zeros((2, 4), dtype=torch.int32), group=elsewhere)


def test_a_group_commit_says_which_path_ran(monkeypatch):
    """Under a group for which ``mesh_commit_ok`` is false the commit runs
    whole and says "stream-dev"; the sharded path says "mesh" and holds a
    ``MeshEncoded`` (tests/test_torch_ligero_mesh.py has it on real ranks).
    Neither reports the other, and a sponge that fails under a group fails
    the commit: it does not go back to the unsharded stream."""
    from zigz_tpu_torch.ops import ligero_mesh
    from zigz_tpu_torch.parallel.multihost import single_process_group

    one = single_process_group("cpu")
    cols = {"a": np.arange(1 << 8, dtype=np.uint64), "b": np.arange(1 << 6, dtype=np.uint64)}
    plain = ligero_commit_mixed(F, cols, "sha3", device="cpu")
    state = ligero_commit_mixed(F, cols, "sha3", device="cpu", group=one)
    assert state.commit_path == "stream-dev" and isinstance(state.encoded, ligero_dev.StreamedEncoded)
    assert state.root == plain.root and state.device_column("a") is not None
    with pytest.raises(ValueError, match="device columns"):
        ligero_commit_mixed(F, cols, "sha3", device="cpu", group=one,
                            dev_columns={"a": torch.arange(1 << 8, dtype=torch.int32)})

    # force the sharded path on the group of one: its collectives are identities
    monkeypatch.setattr(ligero_mesh, "mesh_commit_ok", lambda group, n_e, rows: group is not None)
    forced = ligero_commit_mixed(F, cols, "sha3", device="cpu", group=one)
    assert forced.commit_path == "mesh" and isinstance(forced.encoded, ligero_mesh.MeshEncoded)
    assert forced.root == plain.root and forced.leaf_digests == plain.leaf_digests
    assert forced.device_column("a") is None  # the matrix is resident on no rank
    with pytest.raises(RuntimeError, match="not resident"):
        forced.device_column("a", required=True)
    idx = [0, 5, forced.n_e - 1]
    assert np.array_equal(forced.encoded.gather(idx), plain.encoded.gather(idx))

    def boom(mat):
        raise RuntimeError("forced failure in the column sponge")

    monkeypatch.setattr(ligero_mesh, "sha3_columns", boom)
    with pytest.raises(RuntimeError, match="forced failure in the column sponge"):
        ligero_commit_mixed(F, cols, "sha3", device="cpu", group=one)
    assert ligero_commit_mixed(F, cols, "sha3", device="cpu").commit_path == "stream-dev"


def test_a_prove_under_a_group_of_one_reports_what_ran():
    """A group of one shards nothing: the flags say so, the twins stay off,
    and the proof bytes are those of ``group=None``."""
    from zigz_tpu_torch.parallel.multihost import single_process_group
    from zigz_tpu_torch.prover.serialization import BinarySerializer

    one = single_process_group("cpu")
    prover = Prover(F, seed=0, device="cpu", protocol_version=2, group=one)
    proof = prover.prove(_NOPS, 0x1000, None, 64, None, None)
    t = prover.last_timings
    assert (t["data_commit_path"], t["advice_commit_path"]) == ("stream-dev", "stream-dev")
    assert t["data_commit_sharded"] is False and t["advice_commit_sharded"] is False
    assert t["batch_eval_sharded"] is False and t["open_sharded"] is False and t["zerochecks_sharded"] is False
    assert "advice_dev_cols" not in t
    plain = Prover(F, seed=0, device="cpu", protocol_version=2)
    ser = BinarySerializer(F)
    assert ser.serialize(proof) == ser.serialize(plain.prove(_NOPS, 0x1000, None, 64, None, None))
    assert "data_commit_sharded" not in plain.last_timings and plain.last_timings["advice_dev_cols"] == 148


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
