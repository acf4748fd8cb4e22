"""The port is a package of its own: it imports torch and numpy, never JAX
and nothing of the JAX package ``zigz_tpu``, and it proves and verifies with
both blocked from import."""

import ast
import hashlib
import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "zigz_tpu_torch"
FIXTURES = ROOT / "tests" / "fixtures"
FORBIDDEN = ("jax", "jaxlib", "zigz_tpu")
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "__graft_entry_torch__.py",
                                        ROOT / "scripts" / "torch_group_phases.py",
                                        ROOT / "tests" / "torch_group_checks.py"]


def _imports(path):
    """(line, module) of every import statement, wherever it stands; a
    relative import has no absolute module and cannot leave the package."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module


def test_sources_are_found():
    names = {p.relative_to(ROOT).as_posix() for p in SOURCES}
    assert len(SOURCES) > 40
    assert {"zigz_tpu_torch/prover/prover.py", "zigz_tpu_torch/verifier/verifier.py", "zigz_tpu_torch/cli.py",
            "zigz_tpu_torch/runtime/native_vm.py", "zigz_tpu_torch/ops/zerocheck_dev_ext.py",
            "zigz_tpu_torch/ops/advice_dev.py", "zigz_tpu_torch/ops/poseidon2.py",
            "zigz_tpu_torch/core/poseidon2.py", "zigz_tpu_torch/core/poseidon2_params.py",
            "zigz_tpu_torch/parallel/multihost.py", "zigz_tpu_torch/parallel/launch.py",
            "zigz_tpu_torch/parallel/dist.py", "zigz_tpu_torch/parallel/recovery.py",
            "zigz_tpu_torch/parallel/jobs.py", "zigz_tpu_torch/ops/ligero_mesh.py",
            "zigz_tpu_torch/ops/batch_eval_dev.py", "__graft_entry_torch__.py",
            "chip_smoke.py", "tests/torch_group_checks.py"} <= names
    assert not (PORT / "_jaxfree.py").exists()


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_import_of_jax_or_the_jax_package(path):
    bad = [(line, mod) for line, mod in _imports(path) if mod.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path}: {bad}"


def test_only_the_distributed_layer_calls_torch_distributed():
    """Every collective goes through parallel/dist.py's wrappers, every
    bring-up through parallel/multihost.py: no other file imports
    ``torch.distributed`` or reaches it as an attribute of ``torch``."""
    users = set()
    for path in SOURCES:
        text = path.read_text()
        if any(mod.startswith("torch.distributed") for _line, mod in _imports(path)) or "torch.distributed." in \
                text.replace("``torch.distributed``", ""):
            users.add(path.relative_to(ROOT).as_posix())
    assert users == {"zigz_tpu_torch/parallel/dist.py", "zigz_tpu_torch/parallel/multihost.py"}


_BLOCKED_RANK = """
import sys
sys.modules["jax"] = None  # any import of these now raises ImportError
sys.modules["jaxlib"] = None
sys.modules["zigz_tpu"] = None
from zigz_tpu_torch.parallel.launch import worker_main
worker_main(sys.argv[1:])
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "zigz_tpu") and sys.modules[m])
assert not loaded, loaded
"""


@pytest.mark.parametrize("version,name", [(1, "v1-nop-2^10"), (2, "v2-nop-2^10")])
def test_ranks_prove_with_jax_and_zigz_tpu_blocked(tmp_path, version, name):
    """Two ranks started by parallel/launch.py, each with JAX and zigz_tpu
    blocked before the port is imported, prove to the pinned digest."""
    from zigz_tpu_torch.parallel.launch import launch

    case = json.loads((PORT / "testdata" / "proof_digests.json").read_text())["proofs"][name]
    results = launch(2, "prove", {"program": case["program"], "max_steps": case["max_steps"],
                                  "protocol_version": version},
                     work_dir=str(tmp_path), device="cpu", timeout_s=600,
                     command=[sys.executable, "-c", _BLOCKED_RANK])
    for res in results:
        assert (res["num_steps"], res["bytes"], res["sha256"], res["verify"]) == (
            case["num_steps"], case["bytes"], case["sha256"], "Accept")


def test_no_environment_switch_and_no_sys_modules_patch():
    """No ZIGZ_TPU_* variable is read, and nothing registers modules by hand."""
    for path in SOURCES:
        text = path.read_text()
        assert "ZIGZ_TPU_" not in text, path
        if path.name != "chip_smoke.py":  # which blocks jax and zigz_tpu from import
            assert "sys.modules" not in text, path


def test_runtime_sources_are_package_data():
    sources = {p.name for p in (PORT / "runtime").iterdir() if p.suffix in (".cpp", ".h")}
    assert sources == {"vm.cpp", "sha3.cpp", "ntt.cpp", "dag.cpp", "ext4.cpp", "lasso_hash.cpp", "bb_simd.h"}
    pyproject = (ROOT / "pyproject.toml").read_text()
    assert '"runtime/*.cpp"' in pyproject and '"runtime/*.h"' in pyproject and '"testdata/*.json"' in pyproject


_BLOCKED_PROVE = """
import hashlib, json, sys
sys.modules["jax"] = None  # any import of these now raises ImportError
sys.modules["jaxlib"] = None
sys.modules["zigz_tpu"] = None
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(1)  # the suite runs several workers on a few cores
import zigz_tpu_torch as zt
from zigz_tpu_torch import runtime
from zigz_tpu_torch.runtime import native_vm

assert runtime.NATIVE_AVAILABLE and native_vm.available(), "the port's own C++ runtime did not build"
assert runtime._LIB.startswith({port!r}), runtime._LIB
pinned = json.load(open({digests!r}))["proofs"]
ser = zt.serialization.BinarySerializer(zt.BabyBear)
nop = bytes([0x13, 0, 0, 0] * 1024)
for version, name in ((1, "v1-nop-2^10"), (2, "v2-nop-2^10")):
    case = pinned[name]
    assert case["program"] == {{"kind": "nop", "count": 1024}}
    proof = zt.Prover(zt.BabyBear, seed=0, device="cpu", protocol_version=version).prove(
        nop, 0x1000, None, case["max_steps"], None, None)
    data = ser.serialize(proof)
    assert (proof.metadata.num_steps, len(data), hashlib.sha256(data).hexdigest()) == (
        case["num_steps"], case["bytes"], case["sha256"]), name
    assert zt.Verifier(zt.BabyBear).verify(ser.deserialize(data), nop) == "Accept"
for name, tape in (("nop4", None), ("add", None), ("fibonacci", [10])):
    program = open({fixtures!r} + "/" + name + "_program.bin", "rb").read()
    entry, segments = 0x1000, None
    if zt.elf.is_elf(program):
        loaded = zt.elf.load(program)
        entry, segments = loaded.entry_pc, loaded.segments
    proof = zt.Prover(zt.BabyBear, seed=0, device="cpu").prove(program, entry, None, 1 << 16, segments, tape)
    assert ser.serialize(proof) == open({fixtures!r} + "/" + name + "_v1.bin", "rb").read(), name
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "zigz_tpu") and sys.modules[m])
assert not loaded, loaded
print("SELF_CONTAINED_OK")
"""


def test_port_proves_and_verifies_with_jax_and_zigz_tpu_blocked():
    code = _BLOCKED_PROVE.format(
        root=str(ROOT), port=str(PORT), fixtures=str(FIXTURES),
        digests=str(PORT / "testdata" / "proof_digests.json"),
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "SELF_CONTAINED_OK" in res.stdout


def test_pinned_digests_file_is_well_formed():
    pinned = json.loads((PORT / "testdata" / "proof_digests.json").read_text())
    assert pinned["made_by"] == "scripts/torch_reference_digests.py"
    assert (ROOT / pinned["made_by"]).exists()
    names = set(pinned["proofs"])
    assert {"v1-nop-2^16", "v1-nop-2^20", "v1-nop-2^22", "v1-fibonacci-150000",
            "v2-nop-2^16", "v2-nop-2^20", "v2-fibonacci-10000"} <= names
    for case in pinned["proofs"].values():
        assert len(case["sha256"]) == 64 and int(case["sha256"], 16) >= 0 and case["bytes"] > 0
    assert pinned["proofs"]["v1-fibonacci-150000"]["num_steps"] == 900_013
    assert pinned["proofs"]["v2-fibonacci-10000"]["num_steps"] == 60_013
    # the fixture a fibonacci case names is the one whose bytes are pinned
    fib = (FIXTURES / "fibonacci_program.bin").read_bytes()
    assert hashlib.sha256(fib).hexdigest() == hashlib.sha256(
        (FIXTURES / pinned["proofs"]["v2-fibonacci-10"]["program"]["name"]).read_bytes()).hexdigest()
