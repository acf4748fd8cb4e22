"""The v2 cell on the CPU at a tiny input: a sound window is correct; the
control, a DATA root altered where it is made and a zerocheck fold that
ignores its challenge are not; a guest of every gadget table reads 0;
the Ligero work counts read the shapes the proof carries; every metric of
the cell reads a number."""

import numpy as np
import pytest
import torch

from pb_support import SEED, tiny_cell
import run as bench_run
from benchlib import cell, judge, trace, window
from reference import v2 as refproof, v2wire

SECONDS = 0.5
WORKLOAD = "v2-fib-2e20"
NEW_METRICS = ("arguments_s", "data_build_s", "advice_build_s", "zerochecks_s", "batch_eval_s", "lasso_s",
               "ligero_commit_s", "ligero_open_s", "ligero_roofline_pct", "device_idle_pct.v2", "execute_s.v2",
               "witness_dev_s.v2", "forest_s.v2", "forest_roofline_pct.v2", "serialize_s.v2", "gc_s.v2")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _drive():
    result, _, numbers = bench_run.drive(tiny_cell(WORKLOAD), SEED, SECONDS, False, "cpu")
    assert result["attempted"] >= 1 and list(result["compared"]) == list(refproof.NAMES)
    return result, numbers


def test_sound_run_is_correct():
    result, numbers = _drive()
    assert result["correct"] and result["failed"] == 0 and not any(numbers.values()), numbers
    assert {"prove_steps_per_s", "setup_s"} == set(result["metrics"])


def test_the_control_is_not_correct():
    c = tiny_cell(WORKLOAD)
    run = window.run_cell(c, SEED, 0.0, False, "cpu")
    args = (c.reference, run.kept, {p.i: p.n for p in run.proves}, c.guest, 1 << c.mix["log2_trace"], c.config,
            "cpu")
    sound, bad = judge.judge(*args)
    assert judge.verdict(sound, c.reference) and not bad
    control, bad = judge.judge(*args, control=True)
    assert not judge.verdict(control, c.reference) and bad == set(run.kept)
    assert control["openings"] > 0 and control["proof_bytes"] > 0 and control["advice_root"] == 0


def test_a_data_root_altered_where_it_is_made(monkeypatch):
    from zigz_tpu_torch.prover import unified

    commit = unified.ligero_commit_mixed
    made = []

    def altered(*args, **kwargs):
        state = commit(*args, **kwargs)
        made.append(1)
        if len(made) % 2 == 1:  # the DATA commit; the ADVICE commit follows it
            state.root = bytes([state.root[0] ^ 1]) + state.root[1:]
        return state

    monkeypatch.setattr(unified, "ligero_commit_mixed", altered)
    result, numbers = _drive()
    assert not result["correct"] and numbers["data_root"] > 0 and numbers["advice_root"] == 0


def test_a_zerocheck_fold_that_ignores_its_challenge(monkeypatch):
    from zigz_tpu_torch.ops import ext4_dev

    fold = ext4_dev.fold_planes
    monkeypatch.setattr(ext4_dev, "fold_planes", lambda planes, r4, groups: fold(planes, [0, 0, 0, 0], groups))
    result, numbers = _drive()
    assert not result["correct"] and numbers["zerochecks"] > 0


def test_every_table_and_link_of_an_alu_guest():
    """A guest with a step of every ALU, word, multiply and divide table:
    the port's CPU v2 proof reads 0 on every count, so the reference's
    query extraction, its hash and the query links' fingerprints hold for
    every gadget table, not only for the Fibonacci guest's two; and a bit
    flipped anywhere in the proof reads above 0."""
    import zigz_tpu_torch as zt
    from zigz_tpu_torch import elf
    from zigz_tpu_torch.guest.asm import Assembler
    from zigz_tpu_torch.prover.serialization import BinarySerializer

    a = Assembler(0x1000)
    a.io_read("t0")
    a.io_read("t1")
    for op in ("sub", "and_", "or_", "xor", "sll", "srl", "sra", "slt", "sltu", "addw", "subw", "sllw", "srlw", "sraw",
               "mul", "mulh", "mulhsu", "mulhu", "mulw", "div", "divu", "rem", "remu", "divw", "divuw", "remw", "remuw"):
        getattr(a, op)("t2", "t0", "t1")
        a.add("t3", "t3", "t2")
    a.sub("x0", "t0", "t1")  # a result dropped by x0 is still its table's entry
    a.mv("a0", "t3")
    a.io_commit("a0")
    a.ebreak()
    program, tape = a.to_elf(), [2**64 - 123456789, 98765]
    loaded = elf.load(program)
    prover = zt.Prover(zt.BabyBear, seed=0, device="cpu", protocol_version=2)
    proof = prover.prove(program, loaded.entry_pc, None, 1 << 8, loaded.segments, tape)
    data = BinarySerializer(zt.BabyBear).serialize(proof)
    config = tiny_cell(WORKLOAD).config
    exp = refproof.expect(program, tape, 1 << 8, config, "cpu")
    tables = {t.table_id for t in exp.tables}
    assert set(v2wire.GADGETS) <= tables | {10}, sorted(tables)
    assert not any(refproof.compare(data, exp, program, config, "cpu").values())
    rng = np.random.default_rng(SEED)
    for pos, bit in zip(rng.integers(0, len(data), 24), rng.integers(0, 8, 24)):  # any one flipped bit is seen
        flipped = bytearray(data)
        flipped[pos] ^= 1 << int(bit)
        out = refproof.compare(bytes(flipped), exp, program, config, "cpu")
        assert sum(v for k, v in out.items() if k in refproof.NAMES) > 0, (pos, bit)


def test_ligero_work_reads_the_shapes_the_proof_carries():
    c = tiny_cell(WORKLOAD)
    run = window.run_cell(c, SEED, 0.0, False, "cpu")
    ligero = cell.work("ligero")
    (i, data), = sorted(run.kept.items())[:1]
    got = v2wire.parse(data)
    t = next(p for p in run.proves if p.i == i).timings
    for key, op in (("data", got.data_open), ("advice", got.advice_open)):
        shape = (t[f"{key}_commit_rows"], t[f"{key}_commit_n"], t[f"{key}_commit_n_e"])
        assert shape == (op.rows, op.n, c.config["inv_rate"] * op.n)
    w = ligero.count(t)
    parts = [ligero.commit(op.rows, op.n, c.config["inv_rate"] * op.n) for op in (got.data_open, got.advice_open)]
    assert w == {k: parts[0][k] + parts[1][k] for k in w}
    assert ligero.count({}) is None


def test_every_metric_of_the_cell_reads_a_number():
    c = tiny_cell(WORKLOAD)
    assert [m["name"] for m in c.per_layer] == list(NEW_METRICS)
    run = window.run_cell(c, SEED, 0.0, False, "cpu")
    run.card = {"sm_clock_max_mhz": 1980.0}
    names = list(cell.work("ligero").KERNELS) + list(cell.work("forest").KERNELS)
    run.trace = trace.Summary(window_s=10.0, busy_s=4.0, op_s={}, kernel_s={f"void {k}<13>(int*)": 1.0 for k in names})
    for name in NEW_METRICS:
        value = cell.metric_reader(name)(run)
        assert isinstance(value, float) and value >= 0, name
    assert cell.metric_reader("device_idle_pct.v2")(run) == pytest.approx(60.0)
