"""The plain reference: its SHA3 against hashlib, its interpreter against
the stated step counts, its whole v1 proof against the program's on the
CPU, and that it imports nothing of the program or of JAX."""

import ast
import hashlib

import numpy as np
import pytest
import torch

from pb_support import BENCH, cell
from reference import forest, rv64, sha3, v1 as refproof

P = 2013265921
FIB = (BENCH / "guests" / "fibonacci.elf").read_bytes()


def test_sha3_leaves_and_nodes_match_hashlib():
    values = torch.tensor([0, 1, P - 1, 2**31 - 1, 12345, 2**62 + 3], dtype=torch.int64)
    leaves = sha3.leaf_digests(values)
    want = [hashlib.sha3_256(int(v).to_bytes(8, "little")).digest() for v in values]
    assert [sha3.digest_bytes(d) for d in leaves] == want
    nodes = sha3.node_digests(leaves)
    assert [sha3.digest_bytes(d) for d in nodes] == [
        hashlib.sha3_256(want[i] + want[i + 1]).digest() for i in (0, 2, 4)]


def test_forest_root_and_path_by_hand():
    col = np.array([[5, 6, 7, 8]], dtype=np.uint64)
    f = forest.build(col, "cpu")
    h = [hashlib.sha3_256(int(v).to_bytes(8, "little")).digest() for v in col[0]]
    n0, n1 = hashlib.sha3_256(h[0] + h[1]).digest(), hashlib.sha3_256(h[2] + h[3]).digest()
    assert f.roots() == [hashlib.sha3_256(n0 + n1).digest()]
    assert f.siblings(np.array([2]))[0].tobytes() == h[3] + n0


def test_evaluation_by_hand():
    m = np.array([[3, 5, 7, 11]], dtype=np.uint64)
    r0, r1 = 10, 20  # r0 binds the lowest bit of the row index
    want = ((1 - r0) * (1 - r1) * 3 + r0 * (1 - r1) * 5 + (1 - r0) * r1 * 7 + r0 * r1 * 11) % P
    assert int(forest.evaluate(m, np.array([[r0, r1]], dtype=np.uint64), P, "cpu")[0]) == want
    assert int(forest.evaluate(m, np.array([[P - 1, P - 2]], dtype=np.uint64), P, "cpu", lazy=True)[0]) != \
        int(forest.evaluate(m, np.array([[P - 1, P - 2]], dtype=np.uint64), P, "cpu")[0])


@pytest.mark.parametrize("workload", ["v1-fib-2e16", "v1-fib-2e22"])
def test_range_ends_run_the_stated_steps(workload):
    """The interpreter at both ends of the mix's input range: the step count
    the mix states, and a padded size of 2^log2_trace."""
    mix = cell.load(workload).mix
    entry, segments = rv64.parse_elf(FIB)
    for n in (mix["input"]["min"], mix["input"]["max"]):
        ex = rv64.execute(entry, segments, [n], 1 << mix["log2_trace"])
        assert ex.steps == cell.steps_for(mix, n)
        assert rv64.num_vars(ex.steps) == mix["log2_trace"]


def test_fibonacci_outputs():
    entry, segments = rv64.parse_elf(FIB)
    ex = rv64.execute(entry, segments, [10], 1000)
    assert (ex.steps, ex.outputs, ex.final_pc) == (73, [55, 89], 0x1044)


@pytest.mark.parametrize("n", [10, 300])
def test_v1_proof_bytes_equal_the_programs(n):
    """The reference's whole v1 proof against the program's CPU prove."""
    import zigz_tpu_torch as zt
    from zigz_tpu_torch.prover.serialization import BinarySerializer

    proof = zt.Prover(zt.BabyBear, seed=3, device="cpu").prove(FIB, 0x1000, None, 1 << 12, None, [n])
    data = BinarySerializer(zt.BabyBear).serialize(proof)
    exp = refproof.expect(FIB, [n], 1 << 12, cell.load("v1-fib-2e16").config, "cpu")
    assert exp.proof == data
    parsed = refproof.parse(data)
    assert [o.root for o in parsed.openings] == exp.roots and parsed.outputs == exp.execution.outputs


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            yield "__import__"


def test_reference_imports_nothing_of_the_program_or_jax():
    files = sorted((BENCH / "reference").rglob("*.py"))
    assert files
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("zigz_tpu_torch", "zigz_tpu", "jax", "jaxlib", "flax", "__import__"), (path, name)
            assert top in ("__future__", "ast", "hashlib", "struct", "array", "dataclasses", "typing",
                           "numpy", "torch"), (path, name)


def test_nothing_in_the_folder_imports_jax_or_the_jax_package():
    for path in sorted(BENCH.rglob("*.py")):
        if path.parent.name == "tests":
            continue
        for name in _imports(path):
            assert name.split(".")[0] not in ("zigz_tpu", "jax", "jaxlib", "flax"), (path, name)
