"""Whole proves of the port under a process group (``Prover(group=...)``) on
gloo CPU ranks: every rank's proof bytes equal zigz_tpu's host-path bytes of
the same program, and both packages' verifiers accept them.  Also the forest
under a forced memory plan and the witness slices under a group.  Bytes and
canonical integers: tolerance zero."""

import hashlib
import os
import pathlib

import numpy as np
import pytest

import zigz_tpu  # noqa: F401  (installs the native hashing backend)
from zigz_tpu.commitments.device_forest import DeviceMerkleForest as JaxForest
from zigz_tpu.core.field import BabyBear as F
from zigz_tpu.ops.witness_dev import build_witness_device
from zigz_tpu.prover.prover import Prover as JaxProver
from zigz_tpu.prover.serialization import BinarySerializer as JaxSerializer
from zigz_tpu.runtime import native_vm
from zigz_tpu.verifier.verifier import Verifier as JaxVerifier
import zigz_tpu_torch as zt
from zigz_tpu_torch.parallel.jobs import make_program, seeded
from zigz_tpu_torch.parallel.launch import launch
from torch_group_checks import COMMAND, launch_checks

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
ARITH_128 = {"kind": "arith", "adds": 125}  # 128 steps, v = 7
ARITH_63 = {"kind": "arith", "adds": 60}  # 63 steps, v = 6
ARITH_1024 = {"kind": "arith", "adds": (1 << 10) - 3}  # 2^10 steps: mesh_commit_ok holds for both commits


def _jax_host_bytes(program_spec, version, max_steps):
    """zigz_tpu's proof bytes by its host path."""
    prev = os.environ.get("ZIGZ_TPU_COMMITMENTS")
    os.environ["ZIGZ_TPU_COMMITMENTS"] = "host"
    try:
        proof = JaxProver(F, seed=0, protocol_version=version).prove(
            make_program(program_spec), 0x1000, None, max_steps, None, None)
    finally:
        if prev is None:
            del os.environ["ZIGZ_TPU_COMMITMENTS"]
        else:
            os.environ["ZIGZ_TPU_COMMITMENTS"] = prev
    return JaxSerializer(F).serialize(proof)


def _prove_on_ranks(tmp_path, ranks, program_spec, version, max_steps, function="prove", **spec):
    work_dir = str(tmp_path / f"job_v{version}_{ranks}")
    results = launch(ranks, function, dict(spec, program=program_spec, max_steps=max_steps,
                                           protocol_version=version, write_proof=True),
                     work_dir=work_dir, device="cpu", timeout_s=600, command=COMMAND)
    with open(os.path.join(work_dir, "proof.bin"), "rb") as f:
        return results, f.read()


def _assert_same_proof(results, data, want, program_spec):
    program = make_program(program_spec)
    assert data == want
    digest = hashlib.sha256(want).hexdigest()
    for res in results:
        assert res["sha256"] == digest and res["bytes"] == len(want) and res["verify"] == "Accept"
    # both packages' verifiers accept the coordinator's bytes
    assert JaxVerifier(F).verify(JaxSerializer(F).deserialize(data), program) == "Accept"
    ser = zt.serialization.BinarySerializer(zt.BabyBear)
    assert zt.Verifier(zt.BabyBear).verify(ser.deserialize(data), program) == "Accept"


@pytest.mark.parametrize("ranks", (2, 4))
def test_v1_prove_under_a_group_byte_identical(tmp_path, ranks):
    """The multi-rank gate: witness build -> forest -> opening evaluations ->
    openings, each rank on its slice, byte-identical to zigz_tpu."""
    want = _jax_host_bytes(ARITH_128, 1, 1 << 10)
    results, data = _prove_on_ranks(tmp_path, ranks, ARITH_128, 1, 1 << 10)
    _assert_same_proof(results, data, want, ARITH_128)
    for res in results:
        assert res["timings"]["forest_plan"]["ranks"] == ranks
        assert res["launches"]["collectives"] == {"all_reduce": 1, "all_gather": 2, "all_to_all": 0}


def test_v1_prove_under_a_group_and_a_forced_forest_plan(tmp_path):
    """Freed levels and three groups of trees on each rank's slice."""
    want = _jax_host_bytes(ARITH_128, 1, 1 << 10)
    plan = {"discard_digests": (43 * 128) >> 2, "group_leaf_digests": 16 * 64}
    results, data = _prove_on_ranks(tmp_path, 2, ARITH_128, 1, 1 << 10, "prove_forced_plan", forest_plan=plan)
    _assert_same_proof(results, data, want, ARITH_128)
    for res in results:
        got = res["timings"]["forest_plan"]
        assert (got["discarded_levels"], got["group_trees"], got["groups"], got["ranks"]) == (2, 16, 3, 2)


@pytest.mark.parametrize("program_spec,max_steps", [(ARITH_1024, 1 << 11), (ARITH_63, 1 << 10)],
                         ids=["2^10-steps", "63-steps"])
def test_v2_prove_under_a_group_byte_identical(tmp_path, program_spec, max_steps):
    """Real zerocheck + Lasso under two sharded commits: both commits, the
    batch evaluation and the openings run sharded; the extension zerochecks
    run whole on every rank, as in zigz_tpu."""
    want = _jax_host_bytes(program_spec, 2, max_steps)
    results, data = _prove_on_ranks(tmp_path, 2, program_spec, 2, max_steps)
    _assert_same_proof(results, data, want, program_spec)
    for res in results:
        t = res["timings"]
        assert t["data_commit_sharded"] is True and t["advice_commit_sharded"] is True
        assert t["batch_eval_sharded"] is True and t["open_sharded"] is True
        assert t["zerochecks_sharded"] is False
        assert (t["data_commit_path"], t["advice_commit_path"]) == ("mesh", "mesh")
        assert "advice_dev_cols" not in t  # the device advice twins are off under a group
        assert res["launches"]["collectives"]["all_to_all"] >= 2


FOREST_CHECKS = [
    {"name": "sha3", "kind": "forest", "seed": 5, "B": 5, "v": 6, "return_data": True},
    {"name": "sha3_planned", "kind": "forest", "seed": 5, "B": 5, "v": 6, "return_data": True,
     "discard_digests": 80, "group_leaf_digests": 64},
    {"name": "poseidon2_planned", "kind": "forest", "seed": 6, "B": 3, "v": 5, "hash_mode": "poseidon2",
     "discard_digests": 24, "group_leaf_digests": 32},
    {"name": "fibonacci", "kind": "witness", "program": {"kind": "file", "path": str(FIXTURES / "fibonacci_program.bin")},
     "max_steps": 1 << 16, "input_tape": [10]},
    {"name": "arith", "kind": "witness", "program": ARITH_128, "max_steps": 1 << 10},
    {"name": "poseidon2_commit", "kind": "mixed_commit", "seed": 8, "log2_sizes": [9, 8], "hash_mode": "poseidon2"},
]


@pytest.fixture(scope="module")
def pieces(tmp_path_factory):
    return {
        D: launch_checks(D, FOREST_CHECKS, work_dir=str(tmp_path_factory.mktemp(f"ranks{D}")), device="cpu",
                         timeout_s=300)
        for D in (2, 4)
    }


@pytest.mark.parametrize("D", (2, 4))
@pytest.mark.parametrize("name", ["sha3", "sha3_planned"])
def test_forest_under_a_group_equals_the_jax_forest(pieces, D, name):
    B, v = 5, 6
    matrix = seeded(5, (B, 1 << v))
    indices = np.random.default_rng(6).integers(0, 1 << v, size=B)
    points = seeded(7, (B, v))
    ref = JaxForest(F, matrix)
    want_evals = np.asarray(ref.eval_backend(None, points)).tolist()
    openings = ref.open_all(indices)
    for res in pieces[D]:
        check = res["results"][name]
        assert check["equal_single"] and check["plan"]["ranks"] == D
        assert [bytes.fromhex(r) for r in check["roots"]] == ref.roots()
        assert check["evals"] == want_evals
        for got, want in zip(check["openings"], openings):
            assert got[0] == want.index and got[1] == want.value.value
            assert [bytes.fromhex(s) for s in got[2]] == want.path.siblings and got[3] == want.path.directions
    if name == "sha3_planned":
        plan = pieces[D][0]["results"][name]["plan"]
        # freed levels from the GLOBAL widths (320, 160 > 80), groups from what a rank holds
        assert plan["discarded_levels"] == 2 and plan["groups"] == {2: 3, 4: 2}[D]


@pytest.mark.parametrize("D", (2, 4))
def test_poseidon2_forest_under_a_group_and_a_plan(pieces, D):
    digests = {res["results"]["poseidon2_planned"]["sha256"] for res in pieces[D]}
    assert len(digests) == 1 and all(res["results"]["poseidon2_planned"]["equal_single"] for res in pieces[D])
    assert pieces[D][0]["results"]["poseidon2_planned"]["plan"]["discarded_levels"] == 2


@pytest.mark.parametrize("D", (2, 4))
def test_a_poseidon2_commit_runs_whole_on_every_rank(pieces, D):
    """zigz_tpu shards SHA3 commits only: under a group a Poseidon2 commit
    (protocol v3) runs the unsharded path on every rank and says so."""
    for res in pieces[D]:
        check = res["results"]["poseidon2_commit"]
        assert not check["sharded"] and check["commit_path"] == "stream-dev"
        assert check["equal_single"] and check["verified"] and check["device_column_resident"]


@pytest.mark.parametrize("D", (2, 4))
@pytest.mark.parametrize("name,tape", [("fibonacci", [10]), ("arith", None)])
def test_witness_slices_equal_the_whole_witness(pieces, D, name, tape):
    """Each rank builds only its columns; a register that is never written
    inside a slice carries its value in from the steps before it."""
    if not native_vm.available():
        pytest.skip("no native VM (needs a C++ compiler)")
    spec = next(c for c in FOREST_CHECKS if c["name"] == name)
    program = make_program(spec["program"])
    nvm = native_vm.NativeVM()
    entry = 0x1000
    if zt.elf.is_elf(program):
        loaded = zt.elf.load(program)
        entry = loaded.entry_pc
        for seg in loaded.segments:
            nvm.load_segment(seg.vaddr, seg.data)
    else:
        nvm.load_segment(entry, program)
    trace = nvm.run(entry, spec["max_steps"], None, tape)["trace"]
    num_vars = max(1, (trace.step_count() - 1).bit_length())
    want = np.asarray(build_witness_device(trace, trace.initial_regs, num_vars))
    for res in pieces[D]:
        check = res["results"][name]
        assert check["num_steps"] == trace.step_count()
        assert check["slice_shape"] == [43, want.shape[1] // D]
        assert check["equal_single"]
        assert check["sha256"] == hashlib.sha256(np.ascontiguousarray(want).tobytes()).hexdigest()


def test_a_slice_of_fewer_than_two_steps_raises():
    import torch

    from zigz_tpu_torch.commitments.device_forest import DeviceMerkleForest
    from zigz_tpu_torch.ops import witness_dev
    from zigz_tpu_torch.parallel.multihost import TraceGroup

    group = TraceGroup(rank=0, world_size=4, device=torch.device("cpu"), backend="gloo", pg=object())
    with pytest.raises(ValueError, match="at least 2"):
        witness_dev.check_slice_width(4, 4)
    with pytest.raises(ValueError, match="at least 2"):
        DeviceMerkleForest(zt.BabyBear, lo=torch.zeros((43, 1), dtype=torch.int32), group=group)
    assert witness_dev.check_slice_width(8, 4) == 2
