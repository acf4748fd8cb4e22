"""The end-to-end arithmetic and the trace's union arithmetic on runs and
traces made up by hand."""

import pytest

from pb_support import cell
from benchlib import trace, window


def _run(seconds, steps, window_s, errors=()):
    run = window.Run(cell=None, seed=0, window_s=window_s)
    for i, (s, n) in enumerate(zip(seconds, steps)):
        run.proves.append(window.Prove(i, 0, n, 16, s, 0.01 * s, {"execute_s": s / 2},
                                       error="x" if i in errors else None))
    return run


def test_steps_per_s_is_all_steps_over_the_whole_window():
    run = _run([1.0, 2.0, 3.0], [100, 200, 300], window_s=8.0)  # 2 s of the window between proves
    assert cell.metric_reader("prove_steps_per_s")(run) == 600 / 8.0


def test_a_split_name_reads_the_quantity_before_its_dot():
    run = _run([1.0, 3.0], [100, 300], window_s=8.0)
    assert cell.metric_reader("prove_steps_per_s.short")(run) == cell.metric_reader("prove_steps_per_s")(run)
    assert cell.metric_reader("execute_s.short")(run) == pytest.approx(1.0)
    with pytest.raises(FileNotFoundError):
        cell.metric_reader("no_such_metric.short")


def test_p95_over_every_prove():
    seconds = [float(i) for i in range(1, 101)]  # 1 .. 100 s
    run = _run(seconds, [1] * 100, window_s=5050.0, errors={99})
    # Linear between order statistics: 95% of the way along 99 gaps.
    assert cell.metric_reader("prove_s_p95")(run) == pytest.approx(1 + 0.95 * 99)


def test_layer_means_leave_out_failed_proves():
    run = _run([1.0, 3.0, 100.0], [1, 1, 1], window_s=104.0, errors={2})
    assert cell.metric_reader("execute_s")(run) == pytest.approx(1.0)
    assert cell.metric_reader("serialize_s")(run) == pytest.approx(0.02)
    assert cell.metric_reader("witness_dev_s")(run) is None  # a phase the prover did not report


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_idle_share_is_a_union_not_a_sum():
    events = [
        _x("prove#0", "user_annotation", 0, 60), _x("serialize#0", "user_annotation", 60, 40),
        _x("k1", "kernel", 10, 20),  # 10-30
        _x("k2", "kernel", 20, 20),  # 20-40, overlaps k1: counts once
        _x("Memcpy HtoD", "gpu_memcpy", 50, 5),  # 50-55
        _x("Memset", "gpu_memset", 95, 10),  # 95-105: 5 us inside the window
        _x("k0", "kernel", -20, 10),  # before the window
        _x("aten::copy_", "cpu_op", 40, 10), _x("numpy_work", "cpu_op", 56, 39),
    ]
    s = trace.summarize(events)
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx((30 + 5 + 5) * 1e-6)  # 10-40, 50-55, 95-100
    assert s.kernel_s == pytest.approx({"k1": 20e-6, "k2": 20e-6, "k0": 0.0})
    assert s.kernels_matching(["k1", "k2"]) == pytest.approx(40e-6)
    run = window.Run(cell=None, seed=0)
    run.trace = s
    assert cell.metric_reader("device_idle_pct")(run) == pytest.approx(60.0)
    # The gaps, longest first, each named by the span it lies in and the
    # host event that overlaps it most.
    assert [(n, round(d * 1e6)) for n, d in s.gaps] == [
        ("serialize:numpy_work", 40), ("prove", 10), ("prove:aten::copy_", 10)]


def test_a_trace_without_the_spans_is_refused():
    with pytest.raises(ValueError):
        trace.summarize([_x("k1", "kernel", 0, 1)])


def test_roofline_reads_nothing_without_its_kernels():
    run = window.Run(cell=None, seed=0)
    run.proves.append(window.Prove(0, 0, 1, 16, 1.0, 0.1, {}))
    run.card = {"sm_clock_max_mhz": 1980.0}
    assert cell.metric_reader("forest_roofline_pct")(run) is None  # no trace
    run.trace = trace.Summary(window_s=1.0, busy_s=0.5, kernel_s={"other": 1.0}, op_s={})
    assert cell.metric_reader("forest_roofline_pct")(run) is None  # no K1/K2 in it


def test_roofline_share():
    run = window.Run(cell=None, seed=0)
    run.proves.append(window.Prove(0, 0, 1, 16, 1.0, 0.1, {}))
    run.card = {"sm_clock_max_mhz": 1980.0}
    work = cell.work("forest").count(16)
    least = work["instructions"] / (132 * 64 * 1980e6)  # operations bound this shape
    assert least > work["bytes"] / 3.35e12
    run.trace = trace.Summary(window_s=1.0, busy_s=0.5, op_s={},
                              kernel_s={"void sha3_leaves_kernel(long*)": least, "sha3_merge_kernel": least})
    assert cell.metric_reader("forest_roofline_pct")(run) == pytest.approx(50.0)


def test_every_number_of_last_timings_is_kept():
    timings = {"execute_s": 0.5, "opens_s": 2, "forest_plan": {"groups": 1}, "sharded": True,
               "rows": __import__("numpy").int64(7)}
    assert window.numbers(timings) == {"execute_s": 0.5, "opens_s": 2.0, "rows": 7.0}
