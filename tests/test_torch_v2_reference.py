"""The port's protocol v2 proofs against the benchmark's plain v2 reference
(proving_bench/reference/v2.py), and the spans of a v2 prove.

The reference re-derives the execution, the witness openings and the
Lasso records from the guest alone, replays the transcript from the
proof's messages and holds every zerocheck, the logUp sums, the batch
evaluation and both Ligero openings to their relations, each zerocheck's
constraints restated (the bytecode argument's against its own decode of
the program): every count is 0 on the port's CPU proofs of the fixtures;
one altered byte, a bytecode constraint left out of the port's
combination, or a decode the port gets wrong on both sides of the fetch
reads on the name of the part it alters. One prove a case, shared by the
tests."""

import json
import pathlib
import sys

import numpy as np
import pytest
import torch

import zigz_tpu_torch as zt
from zigz_tpu_torch import elf
from zigz_tpu_torch.constraints import bytecode
from zigz_tpu_torch.prover.serialization import BinarySerializer

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "fixtures"
sys.path.append(str(ROOT / "proving_bench"))
from reference import v2 as ref, v2wire  # noqa: E402

CONFIG = json.loads((ROOT / "proving_bench" / "configs" / "zigz-v2-babybear.json").read_text())
MAX_STEPS = 1 << 12
FIB_INPUTS = [int(n) for n in np.random.default_rng(21).integers(5, 300, size=2)]
CASES = [("fibonacci", [n]) for n in FIB_INPUTS] + [("add", None), ("nop4", None)]
NS = ("v2", "lv", "rc", "mc", "bc")


@pytest.fixture(scope="module")
def proves():
    """Per case: (program, tape, proof bytes, the prover's spans and timings)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    try:
        for name, tape in CASES:
            program = (FIXTURES / f"{name}_program.bin").read_bytes()
            entry, segments = 0x1000, None
            if program[:4] == b"\x7fELF":
                loaded = elf.load(program)
                entry, segments = loaded.entry_pc, loaded.segments
            prover = zt.Prover(zt.BabyBear, seed=0, device="cpu", protocol_version=2)
            proof = prover.prove(program, entry, None, MAX_STEPS, segments, tape)
            data = BinarySerializer(zt.BabyBear).serialize(proof)
            out[(name, str(tape))] = (program, tape, data, prover.last_spans, dict(prover.last_timings))
    finally:
        torch.set_num_threads(threads)
    return out


def _key(case):
    return (case[0], str(case[1]))


def _compare(program, tape, data):
    exp = ref.expect(program, tape, MAX_STEPS, CONFIG, "cpu")
    return ref.compare(data, exp, program, CONFIG, "cpu")


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_v2_proof_agrees_with_the_plain_reference(proves, case):
    program, tape, data, _, _ = proves[_key(case)]
    out = _compare(program, tape, data)
    assert set(out) == set(ref.NAMES) and all(out[k] == 0 for k in ref.NAMES), out


def _flip(data: bytes, pos: int) -> bytes:
    b = bytearray(data)
    b[pos] ^= 1
    return bytes(b)


@pytest.mark.parametrize("part", ["witness_root", "data_root", "advice_root", "core_round", "table_round",
                                  "lasso_round", "batch_eval"])
def test_one_altered_byte_reads_on_its_own_name(proves, part):
    program, tape, data, _, _ = proves[_key(CASES[0])]
    got = v2wire.parse(data)
    s = got.sections
    unified = s["batch"][0] + 1  # the flags byte, then the two roots
    pos, name = {
        "witness_root": (s["witness"][0], "witness_roots"),
        "data_root": (unified, "data_root"),
        "advice_root": (unified + 32, "advice_root"),
        "core_round": (got.core.start + 9 + 2 * 32, "zerochecks"),  # g(2) of round 1
        "table_round": (got.rc["zc_table"].start + 9 + 2 * 32, "zerochecks"),
        "lasso_round": (s["lasso"][0] + 4 + 16, "lasso"),  # g0 of the first table's first round
        "batch_eval": (s["batch"][1] - 32, "batch_eval"),  # the last column evaluation
    }[part]
    out = _compare(program, tape, _flip(data, pos))
    assert out[name] > 0, out


def test_the_control_is_not_correct(proves):
    """The proof with its ADVICE opening at half the queries: the opening's
    shape and the bytes after it read, its columns still hash to the root."""
    program, tape, data, _, _ = proves[_key(CASES[1])]
    exp = ref.expect(program, tape, MAX_STEPS, CONFIG, "cpu")
    assert not any(ref.compare(data, exp, program, CONFIG, "cpu").values())
    out = ref.compare(ref.control(program, tape, MAX_STEPS, CONFIG, "cpu"), exp, program, CONFIG, "cpu")
    assert out["openings"] > 0 and out["proof_bytes"] > 0 and out["advice_root"] == 0, out


def _fetch_constraint_left_out(monkeypatch):
    """The step zerocheck's first constraint (the fetch) left out of the
    port's combination; its challenges are drawn as before."""
    orig = bytecode._make_step_combiner

    def combiner(*args, **kwargs):
        combine, public = orig(*args, **kwargs)
        return (lambda cols, alphas, p: combine(cols, [alphas[0] * 0] + list(alphas[1:]), p)), public

    monkeypatch.setattr(bytecode, "_make_step_combiner", combiner)


def _decode_wrong_on_both_sides(monkeypatch):
    """funct3 + 8 on every OP-IMM word, in the port's table and its steps
    alike: the fetch multisets still agree, the program does not say so."""
    orig = bytecode.step_static_columns

    def columns(*args):
        cols = orig(*args)
        cols["f3"] = np.where(cols["fimm"] == 1, cols["f3"] + np.uint64(8), cols["f3"])
        return cols

    monkeypatch.setattr(bytecode, "step_static_columns", columns)


@pytest.mark.parametrize("fault", [_fetch_constraint_left_out, _decode_wrong_on_both_sides], ids=lambda f: f.__name__[1:])
def test_a_bytecode_fault_reads_on_zerochecks(monkeypatch, fault):
    program = (FIXTURES / "add_program.bin").read_bytes()
    fault(monkeypatch)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        proof = zt.Prover(zt.BabyBear, seed=0, device="cpu", protocol_version=2).prove(program, 0x1000, None,
                                                                                      MAX_STEPS, None, None)
    finally:
        torch.set_num_threads(threads)
    out = _compare(program, None, BinarySerializer(zt.BabyBear).serialize(proof))
    assert out["zerochecks"] > 0 and not any(out[k] for k in ref.NAMES if k != "zerochecks"), out


def _one(log, name, parent):
    found = [s for s in log if s.name == name and s.parent_id == parent.span_id]
    assert len(found) == 1, (name, parent.name)
    return found[0]


@pytest.mark.parametrize("case", CASES[:1], ids=lambda c: c[0])
def test_v2_spans_and_their_keys(proves, case):
    _, _, _, log, t = proves[_key(case)]
    (unified,) = [s for s in log if s.name == "unified"]
    parts = {name: _one(log, name, unified) for name in ("arguments", "data_build", "advice_build", "zerochecks")}
    assert t["arguments_s"] == parts["arguments"].seconds and not log.children(parts["arguments"])
    assert t["data_build_s"] == parts["data_build"].seconds
    assert t["zerochecks_s"] == parts["zerochecks"].seconds
    for outer in ("data_build", "advice_build", "zerochecks"):
        leaves = {ns: _one(log, ns, parts[outer]) for ns in NS}
        for ns, leaf in leaves.items():
            assert t[f"{outer}_{ns}_s"] == leaf.seconds and not log.children(leaf)
        assert sum(leaf.seconds for leaf in leaves.values()) <= parts[outer].seconds
    start = [s for s in log.children(parts["advice_build"]) if s.name == "zerocheck_start"]
    assert len(start) == len(NS)
    assert t["advice_build_s"] == pytest.approx(parts["advice_build"].seconds - sum(s.seconds for s in start))
    for key in ("data", "advice"):
        rows, n, n_e = t[f"{key}_commit_shape"]
        assert (t[f"{key}_commit_rows"], t[f"{key}_commit_n"], t[f"{key}_commit_n_e"]) == (rows, n, n_e)
        assert all(type(t[f"{key}_commit_{k}"]) is int for k in ("rows", "n", "n_e"))


def test_a_v1_prove_has_none_of_the_v2_spans():
    program = (FIXTURES / "fibonacci_program.bin").read_bytes()
    loaded = elf.load(program)
    prover = zt.Prover(zt.BabyBear, seed=0, device="cpu")
    prover.prove(program, loaded.entry_pc, None, 1 << 16, loaded.segments, [10])
    names = {s.name for s in prover.last_spans}
    assert not names & {"unified", "arguments", "data_build", "advice_build", "zerochecks", *NS}
    assert not any(k.startswith(("arguments", "data_build", "zerochecks_")) for k in prover.last_timings)
