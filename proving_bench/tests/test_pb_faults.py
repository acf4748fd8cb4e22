"""A whole run without the look for a card, on the CPU at a tiny input:
sound, it is correct; with the timed path broken underneath, or with the
control in the program's place, it is not."""

import pytest
import torch

from pb_support import SEED, tiny_cell
import run as bench_run
from benchlib import judge, window
from reference import v1 as refproof

SECONDS = 0.5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _drive(workload="v1-fib-2e16"):
    result, early, numbers = bench_run.drive(tiny_cell(workload), SEED, SECONDS, False, "cpu")
    assert result["attempted"] >= 1 and set(result["compared"]) <= set(refproof.NAMES)
    return result, numbers


def test_sound_run_is_correct():
    result, numbers = _drive()
    assert result["correct"] and result["failed"] == 0
    assert set(numbers) == {"execution", "roots", "openings", "proof_bytes"} and not any(numbers.values())
    assert {"prove_s_p95", "setup_s"} == set(result["metrics"])


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    from zigz_tpu_torch.commitments import device_forest

    roots = device_forest.DeviceMerkleForest.roots

    def altered(self):
        out = roots(self)
        return [bytes([out[0][0] ^ 1]) + out[0][1:]] + out[1:]

    monkeypatch.setattr(device_forest.DeviceMerkleForest, "roots", altered)
    result, numbers = _drive()
    assert not result["correct"] and numbers["roots"] > 0 and result["failed"] >= 1


def test_a_step_that_returns_its_state_unchanged(monkeypatch):
    from zigz_tpu_torch.commitments import device_forest

    monkeypatch.setattr(device_forest._Sha3Levels, "merge", staticmethod(lambda level: level[:, 0::2]))
    result, numbers = _drive()
    assert not result["correct"] and numbers["roots"] > 0


def test_half_of_the_trace_left_out(monkeypatch):
    from zigz_tpu_torch.ops import witness_dev

    build = witness_dev.build_witness

    def half(*args, **kwargs):
        w = build(*args, **kwargs).clone()
        w[:, w.shape[1] // 2:] = 0
        return w

    monkeypatch.setattr(witness_dev, "build_witness", half)
    result, numbers = _drive()
    assert not result["correct"] and numbers["roots"] > 0


def test_a_prove_that_raises_is_failed(monkeypatch):
    from zigz_tpu_torch.prover.serialization import BinarySerializer

    calls = []

    def flaky(self, proof):
        calls.append(1)
        if len(calls) == 2:  # the first call in the window; the warm-up's passed
            raise RuntimeError("lost")
        return _ser(self, proof)

    _ser = BinarySerializer.serialize
    monkeypatch.setattr(BinarySerializer, "serialize", flaky)
    result, _ = _drive()
    assert not result["correct"] and result["failed"] >= 1


@pytest.mark.parametrize("workload", ["v1-fib-2e16", "v1-fib-2e22"])
def test_the_control_is_not_correct(workload):
    """The reference with the reduction after each fold left out, in the
    program's place, at a tiny size; on the card the same at the cell's."""
    c = tiny_cell(workload)
    run = window.run_cell(c, SEED, 0.0, False, "cpu")
    inputs = {p.i: p.n for p in run.proves}
    args = (c.reference, run.kept, inputs, c.guest, 1 << c.mix["log2_trace"], c.config, "cpu")
    sound, bad = judge.judge(*args)
    assert judge.verdict(sound, c.reference) and not bad
    control, bad = judge.judge(*args, control=True)
    assert not judge.verdict(control, c.reference) and control["openings"] > 0 and bad == set(run.kept)


def test_import_guard_compares_whole_top_level_names():
    assert bench_run.forbidden_modules(["zigz_tpu_torch", "zigz_tpu_torch.ops", "jaxtyping", "numpy"]) == []
    assert bench_run.forbidden_modules(["zigz_tpu.prover", "jax.numpy", "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "zigz_tpu"]


def test_a_run_with_the_jax_package_loaded_prints_no_result(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "zigz_tpu", types.ModuleType("zigz_tpu"))
    with pytest.raises(SystemExit):
        bench_run.drive(tiny_cell("v1-fib-2e16"), SEED, 0.0, False, "cpu")


def test_parse_refuses_a_truncated_proof():
    with pytest.raises(refproof.ParseError):
        refproof.parse(b"ZIGZ" + bytes(10))
