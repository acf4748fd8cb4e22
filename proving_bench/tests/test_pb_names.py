"""BENCHMARK.json against the contract's shape, and everything it names
found by name, with nothing to edit when a file and an entry are added."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from pb_support import BENCH, REPO, SEED, TINY, cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["proving_bench"] and 1 <= bench["run_seconds"] <= 51
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for x in bench[key]]
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200 and NAME.match(w["traffic"])
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and c["file"].startswith("proving_bench/")
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
        assert any(w["config"] == c["name"] for w in bench["workloads"])
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m) <= {"name", "unit", "better", "bound", "source", "layer", "moves", "workloads"}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        for w in m.get("workloads", []):  # each cell it lists reports the metric it moves
            assert any(e["name"] == m["moves"] and w in e.get("workloads", [w]) for e in bench["end_to_end"])


def test_everything_is_found_by_name(bench):
    for w in bench["workloads"]:
        c = cell.load(w["name"])
        assert c.config["name"] == w["config"] and c.guest[:4] == b"\x7fELF"
        reported = {m["name"] for m in c.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert c.per_layer, w["name"]
        assert all(m["moves"] in reported for m in c.per_layer)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(cell.metric_reader(m["name"]))
    assert cell.work("forest").KERNELS


def test_metric_layers_and_per_cell_lists():
    short, flagship = cell.load("v1-fib-2e16"), cell.load("v1-fib-2e22")
    assert "prove_s_p95" in {m["name"] for m in short.end_to_end}
    assert "prove_s_p95" not in {m["name"] for m in flagship.end_to_end}
    assert "forest_roofline_pct" in {m["name"] for m in flagship.per_layer}
    assert "prove_steps_per_s" in {m["name"] for m in flagship.end_to_end}
    assert "prove_steps_per_s" not in {m["name"] for m in short.end_to_end}
    assert {"prove_steps_per_s.short", "forest_roofline_pct.short"} <= {m["name"] for m in short.per_layer}
    assert all(m["moves"] == "prove_s_p95" for m in short.per_layer)


def test_a_metric_added_as_a_file_and_an_entry(tmp_path):
    """A throwaway metric in a copy: one new file, one new entry, no edit.
    It reads a span of the prover's `last_timings` that no metric reads yet
    (`opens_s`), from a real window of tiny proves on the CPU."""
    shutil.copytree(BENCH, tmp_path / "proving_bench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    assert all(m["name"] != "opens_s" for m in bench["per_layer"])
    assert not any("opens_s" in path.read_text() for path in (BENCH / "metrics").glob("*.py"))
    bench["per_layer"].append({"name": "opens_s", "unit": "s", "better": "lower", "source": "program_span",
                               "layer": "commitments, Merkle forest", "moves": "prove_s_p95",
                               "workloads": ["v1-fib-2e16"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "proving_bench" / "metrics" / "opens_s.py").write_text(
        "from statistics import mean\n\n\ndef read(run):\n"
        "    values = [p.timings['opens_s'] for p in run.good() if 'opens_s' in p.timings]\n"
        "    return mean(values) if values else None\n")
    code = ("import sys; sys.path[:0] = ['proving_bench', sys.argv[1]]; import torch; torch.set_num_threads(1); "
            "from benchlib import cell, window; c = cell.load('v1-fib-2e16'); "
            "c.mix = dict(c.mix, input={'min': 10, 'max': 19, 'grid': 8}, log2_trace=7, warmup_proves=1); "
            "run = window.run_cell(c, 5, 0.2, False, 'cpu'); "
            "print(c.per_layer[-1]['name'], len(run.good()), cell.metric_reader('opens_s')(run))")
    out = subprocess.run([sys.executable, "-c", code, str(REPO)], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    name, proves, value = out.stdout.split()[-3:]
    assert name == "opens_s" and int(proves) >= 1 and float(value) > 0


# A protocol that the program proves and the benchmark has no reference of
# yet, and a throwaway reference of it: the header against the reference's
# own, and a count the test plants.
TOY_VERSION = 2
TOY_REFERENCE = '''from . import proof, rv64

NAMES = ("header_bytes", "planted")
LIMITS = {"header_bytes": 0, "planted": 3}


def expect(program, input_tape, max_steps, config, device):
    entry, segments = rv64.parse_elf(program)
    ex = rv64.execute(entry, segments, input_tape, max_steps)
    return proof.header(config["protocol_version"], config["modulus"], ex.steps, rv64.num_vars(ex.steps))


def compare(data, expected, program, config, device):
    head = data[:len(expected)]
    return {"header_bytes": sum(a != b for a, b in zip(head, expected)) + len(expected) - len(head),
            "planted": PLANTED}


def control(program, input_tape, max_steps, config, device):
    return bytes(len(expect(program, input_tape, max_steps, config, device)))
'''


def _copy_with_configuration(tmp_path):
    """A copy of the benchmark as it stands before protocol `TOY_VERSION` has
    a reference, with one configuration of that protocol and one cell of it
    added: new files and new entries, no file edited."""
    def ignore(folder, names):
        return [n for n in names if n == "__pycache__"
                or (Path(folder) == BENCH / "reference" and n == f"v{TOY_VERSION}.py")]

    shutil.copytree(BENCH, tmp_path / "proving_bench", ignore=ignore)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    config = json.loads((BENCH / "configs" / "zigz-v1-babybear.json").read_text())
    config.update(name="toy-babybear", protocol_version=TOY_VERSION)
    path = tmp_path / "proving_bench" / "configs" / "toy-babybear.json"
    assert not path.exists()
    path.write_text(json.dumps(config))
    bench["configs"].append({"name": "toy-babybear", "source": "a throwaway configuration of the tests",
                             "file": "proving_bench/configs/toy-babybear.json", "reduced": [], "why": "its reference"})
    bench["workloads"].append({"name": "toy-fib", "config": "toy-babybear", "traffic": "fib-2e16", "chips": 1,
                               "why": "a cell judged by its own reference"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))


@pytest.mark.parametrize("planted", [0, 4])
def test_a_configuration_added_as_files_and_entries(tmp_path, planted):
    """A configuration of a protocol with its own reference module, in a
    copy: a window of tiny CPU proves through `run.drive` is judged by that
    module's names and limits, and a count over its limit makes the run not
    correct."""
    _copy_with_configuration(tmp_path)
    module = tmp_path / "proving_bench" / "reference" / f"v{TOY_VERSION}.py"
    assert not module.exists()
    module.write_text(TOY_REFERENCE + f"\n\nPLANTED = {planted}\n")
    code = ("import json, sys; sys.path[:0] = ['proving_bench', sys.argv[1]]; import torch; torch.set_num_threads(1); "
            "import run; from benchlib import cell; c = cell.load('toy-fib'); "
            "c.mix = dict(c.mix, **json.loads(sys.argv[2])); "
            "result, _, _ = run.drive(c, int(sys.argv[3]), 0.3, False, 'cpu'); print(json.dumps(result))")
    out = subprocess.run([sys.executable, "-c", code, str(REPO), json.dumps(TINY), str(SEED)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    compared = result["compared"]
    assert list(result)[-1] == "compared" and result["attempted"] >= 1
    assert {k: c["limit"] for k, c in compared.items()} == {"header_bytes": 0, "planted": 3}
    assert compared["header_bytes"]["value"] == 0
    if planted:  # every kept proof reads 4 against the limit 3
        assert compared["planted"]["value"] >= 4 and not result["correct"] and result["failed"] >= 1
    else:
        assert compared["planted"]["value"] == 0 and result["correct"] and result["failed"] == 0


def test_a_configuration_naming_a_missing_reference_fails_at_load(tmp_path):
    """A configuration of a protocol with no reference module: the
    benchmark's command refuses the cell at `cell.load`, before it builds a
    prover or looks for a card, and prints no result."""
    _copy_with_configuration(tmp_path)
    out = subprocess.run([sys.executable, "proving_bench/run.py", "--workload", "toy-fib", "--seed", "5",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 1 and out.stdout == ""  # without a card a loaded cell exits with 2
    assert f"FileNotFoundError: no reference module 'v{TOY_VERSION}'" in out.stderr
    assert ", in load\n" in out.stderr


def test_stated_padded_sizes(bench):
    """Every input of every mix runs as many steps as the mix's trace holds,
    and more than half of it: the proof's variable count is the mix's."""
    for w in bench["workloads"]:
        mix = cell.load(w["name"]).mix
        for stream in ("warmup", "window"):
            order = cell.inputs(mix, 7, stream).order
            assert min(order) == mix["input"]["min"] and max(order) == mix["input"]["max"]
            for n in order:
                steps = cell.steps_for(mix, n)
                assert 1 << (mix["log2_trace"] - 1) < steps <= 1 << mix["log2_trace"], (w["name"], n)


def test_inputs_are_one_set_in_a_seeded_order():
    mix = cell.load("v1-fib-2e16").mix
    a, b = cell.inputs(mix, 1, "window").order, cell.inputs(mix, 2**62 + 5, "window").order
    assert sorted(a) == sorted(b) and a != b
    assert a == cell.inputs(mix, 1, "window").order
    assert cell.inputs(mix, -3, "window").order  # any whole number seeds it
