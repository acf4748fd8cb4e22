"""The port's prove spans (zigz_tpu_torch/utils/profiling.py): the tree of a
v1 prove and its serialize, the numbers of ``last_timings`` read from it,
the leaves a torch.profiler trace shows and the benchmark's reading of that
trace, the collector's hook and the counter tables.

A 2^7-step prove of the Fibonacci fixture on the CPU (73 steps), whose
bytes are the golden fixture's."""

import contextlib
import gc
import importlib.util
import json
import pathlib
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import zigz_tpu_torch as zt
from zigz_tpu_torch import elf
from zigz_tpu_torch.ops import keccak, witness_dev, zerocheck_dev_ext
from zigz_tpu_torch.prover.serialization import BinarySerializer
from zigz_tpu_torch.utils import profiling
from zigz_tpu_torch.utils.profiling import span

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "fixtures"
PROGRAM = (FIXTURES / "fibonacci_program.bin").read_bytes()
PINNED = (FIXTURES / "fibonacci_v1.bin").read_bytes()
BENCHMARK_KEYS = ("execute", "witness_dev", "sumcheck_lasso", "forest")  # metrics/<key>_s.py read these
NEW_KEYS = ("witness_pack_s", "witness_upload_s", "witness_build_s", "lasso_absorb_s", "witness_upload_bytes",
            "gc_s", "gc_collections")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several pytest workers on a few cores: torch's own
    intra-op thread pool would oversubscribe them (tens of times slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _prove(prover, serializer, i=None):
    """A prove and its serialize; with ``i``, inside the benchmark's marks."""
    loaded = elf.load(PROGRAM)
    with record_function(f"prove#{i}") if i is not None else contextlib.nullcontext():
        proof = prover.prove(PROGRAM, loaded.entry_pc, None, 1 << 16, loaded.segments, [10])
    with record_function(f"serialize#{i}") if i is not None else contextlib.nullcontext():
        data = serializer.serialize(proof)
    return proof, data


def _one(log, name):
    (s,) = [s for s in log if s.name == name]
    return s


def _leaves(log):
    return [s for s in log if s.parent_id is not None and not log.children(s)]


def test_a_prove_and_its_serialize_make_one_tree():
    prover, ser = zt.Prover(zt.BabyBear, seed=0, device="cpu"), BinarySerializer(zt.BabyBear)
    proof, data = _prove(prover, ser)
    assert data == PINNED
    assert proof.metadata.num_vars == 7
    prove_log, ser_log = prover.last_spans, ser.last_spans
    assert proof.prove_id == prove_log.prove_id == ser_log.prove_id is not None

    roots = [s for s in prove_log + ser_log if s.parent_id is None]
    assert [s.name for s in roots] == ["prove", "serialize"]
    for log in (prove_log, ser_log):
        assert [s.span_id for s in log] == list(range(len(log)))
        for s in log:
            assert s.prove_id == log.prove_id and s.start_ns <= s.end_ns
            assert log.self_seconds(s) >= 0, s
            if s.parent_id is not None:
                parent = log[s.parent_id]
                assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns, (parent, s)
    tree = {s.name: [c.name for c in prove_log.children(s)] for s in prove_log if prove_log.children(s)}
    assert tree == {"prove": ["execute", "witness", "sumcheck_lasso", "commitments"],
                    "sumcheck_lasso": ["filler", "lasso_absorb"],
                    "commitments": ["witness_dev", "forest", "roots", "points", "evals", "opens"],
                    "witness_dev": ["pack", "upload", "build"]}
    assert [c.name for c in ser_log.children(ser_log[0])] == ["lasso", "commitments"]

    t = prover.last_timings
    for key in BENCHMARK_KEYS:
        assert t[f"{key}_s"] == _one(prove_log, key).seconds
    for key in ("witness", "commitments", "roots", "points", "evals", "opens"):
        assert t[f"{key}_s"] == _one(prove_log, key).seconds
    assert t["total_s"] == prove_log[0].seconds
    assert set(NEW_KEYS) <= set(t)
    for leaf in ("pack", "upload", "build"):
        assert t[f"witness_{leaf}_s"] == _one(prove_log, leaf).seconds
    assert t["witness_pack_s"] + t["witness_upload_s"] + t["witness_build_s"] <= t["witness_dev_s"]
    assert t["lasso_absorb_s"] == _one(prove_log, "lasso_absorb").seconds
    # 44 bytes a step of the 2^7 padded trace, and the 32 initial registers as u32 words
    assert t["witness_upload_bytes"] == 44 * (1 << 7) + 32 * 4
    assert t["gc_s"] >= 0 and t["gc_collections"] >= 0


def test_last_spans_is_replaced_not_grown():
    prover, ser = zt.Prover(zt.BabyBear, seed=0, device="cpu"), BinarySerializer(zt.BabyBear)
    seen = []
    for _ in range(3):
        proof, data = _prove(prover, ser)
        assert data == PINNED
        seen.append((prover.last_spans, len(prover.last_spans), ser.last_spans, len(ser.last_spans)))
    assert len({id(s[0]) for s in seen}) == 3 and len({id(s[2]) for s in seen}) == 3
    assert len({s[1] for s in seen}) == 1 and len({s[3] for s in seen}) == 1
    ids = [s[0].prove_id for s in seen]
    assert ids == sorted(set(ids)) and [s[2].prove_id for s in seen] == ids


def _load_trace_module():
    path = ROOT / "proving_bench" / "benchlib" / "trace.py"
    spec = importlib.util.spec_from_file_location("proving_bench_trace", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # its dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


def test_the_profiler_names_idle_gaps_after_program_leaves(tmp_path):
    """The benchmark's window marks around a prove and its serialize, as
    its window does; two kernels at the window's ends make the rest of the
    window one idle gap, which the benchmark's reader names after the
    program's leaf that overlaps it most."""
    prover, ser = zt.Prover(zt.BabyBear, seed=0, device="cpu"), BinarySerializer(zt.BabyBear)
    _prove(prover, ser)  # warm-up
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, data = _prove(prover, ser, 0)
    assert data == PINNED
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]

    program = [ev for ev in events if ev.get("ph") == "X" and ev.get("name", "").startswith("zigz/")]
    leaves = _leaves(prover.last_spans) + _leaves(ser.last_spans)
    expected = sorted(f"zigz/{log[s.parent_id].name}/{s.name}"
                      for log in (prover.last_spans, ser.last_spans) for s in _leaves(log))
    assert sorted(ev["name"] for ev in program) == expected and len(program) == len(leaves)
    assert "zigz/witness_dev/pack" in expected and "zigz/sumcheck_lasso/lasso_absorb" in expected
    named = [ev["name"] for ev in events if ev.get("cat") == "user_annotation"]
    assert not any(n.startswith(("prove#", "serialize#")) for n in named if n not in ("prove#0", "serialize#0"))
    assert not any(s.name.startswith(("prove#", "serialize#")) for s in prover.last_spans + ser.last_spans)

    marks = {ev["name"]: ev for ev in events if ev.get("name") in ("prove#0", "serialize#0")}
    lo = float(marks["prove#0"]["ts"])
    hi = float(marks["serialize#0"]["ts"]) + float(marks["serialize#0"]["dur"])
    pid, tid = marks["prove#0"]["pid"], marks["prove#0"]["tid"]
    events += [{"ph": "X", "cat": "kernel", "name": "edge", "ts": ts, "dur": 1.0, "pid": pid, "tid": tid}
               for ts in (lo, hi - 1.0)]
    summary = _load_trace_module().summarize(events)
    name, seconds = summary.gaps[0]
    assert name.startswith("prove:zigz/"), summary.gaps
    assert seconds == pytest.approx((hi - lo - 2.0) * 1e-6)


def test_span_outside_a_root_times_and_keeps_nothing():
    with span("alone") as s:
        pass
    assert s.seconds >= 0 and s.span_id is None and s.parent_id is None
    with profiling.root("prove", 7) as log:
        with span("outer", outer=True):
            with span("inner") as inner:
                pass
    assert [x.name for x in log] == ["prove", "outer", "inner"]
    assert inner.parent_id == 1 and log.children(log[1]) == [inner]
    with span("after") as s:
        pass
    assert s.span_id is None and len(log) == 3


def test_root_counts_the_collector():
    with profiling.root("prove", None) as log:
        gc.collect()
        gc.collect()
    assert log.gc_collections >= 2 and log.gc_s > 0
    assert gc.callbacks.count(profiling._on_gc) == 1
    with profiling.root("prove", None) as quiet:
        pass
    assert quiet.gc_s >= 0 and gc.callbacks.count(profiling._on_gc) == 1


def test_format_tree_shows_self_time():
    with profiling.root("prove", 1) as log:
        with span("commitments", outer=True):
            with span("forest"):
                pass
    lines = profiling.format_tree(log).splitlines()
    assert [line.split()[0] for line in lines] == ["prove", "commitments", "forest"]
    assert all(line.endswith("ms self") for line in lines)


def test_counter_tables_are_the_modules_own_dicts():
    tables = profiling._COUNTERS
    assert tables["keccak"] is keccak.LAUNCHES
    assert tables["zerocheck"] is zerocheck_dev_ext.DEVICE_PROVES
    assert tables["witness_upload"] is witness_dev.UPLOADED
    before = profiling.counters()
    keccak.LAUNCHES["leaves"] += 3
    try:
        after = profiling.counters()
        assert after["keccak.leaves"] - before["keccak.leaves"] == 3
        assert set(after) == set(before) and "keccak.merge" in after
    finally:
        keccak.LAUNCHES["leaves"] -= 3
    table = profiling.counter_table("spans_test_table", ["count", "wait_s"])
    assert table == {"count": 0, "wait_s": 0.0} and isinstance(table["wait_s"], float)
    assert profiling._COUNTERS.pop("spans_test_table") is table
