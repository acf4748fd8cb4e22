"""The CUDA kernels and the port's prove on the card (skipped without one).

Run on a machine with an NVIDIA GPU (tests/conftest.py imports JAX, which
that machine need not have, hence --noconftest):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q

Digests and proof bytes are compared whole: tolerance zero.  This file
imports no JAX."""

import hashlib
import pathlib

import numpy as np
import pytest
import torch

from zigz_tpu_torch import BabyBear, Prover, elf, serialization
from zigz_tpu_torch.commitments.device_forest import DeviceMerkleForest
from zigz_tpu_torch.commitments.ligero import ligero_commit_mixed
from zigz_tpu_torch.ops import keccak, ligero_dev, witness_dev
from zigz_tpu_torch.prover.prover import ReferenceProver

pytestmark = pytest.mark.cuda

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
P = BabyBear.MODULUS


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _values(n, seed):
    vals = np.random.default_rng(seed).integers(0, 1 << 64, size=n, dtype=np.uint64)
    edge = np.array([0, P - 1, (1 << 64) - 1], dtype=np.uint64)[:n]
    vals[: edge.size] = edge
    return torch.from_numpy(vals.view(np.int64))


@pytest.mark.parametrize("n", [1, 255, 4097, 1 << 16])
def test_kernels_match_plain_and_hashlib(cuda, n):
    vals = _values(n, seed=n)
    before = dict(keccak.LAUNCHES)
    leaves = keccak.sha3_leaves(vals.to(cuda))
    assert torch.equal(leaves.cpu(), keccak._sha3_leaves_plain(vals))
    msg = _values(8 * n, seed=n + 1).view(n, 8)
    merged = keccak.sha3_merge(msg.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(merged.cpu(), keccak._sha3_merge_plain(msg))
    assert keccak.LAUNCHES == {"leaves": before["leaves"] + 1, "merge": before["merge"] + 1}
    for i in {0, 1, 2, n - 1} & set(range(n)):
        data = int(vals[i]).to_bytes(8, "little", signed=True)
        assert leaves[i].cpu().numpy().tobytes() == hashlib.sha3_256(data).digest()
        assert merged[i].cpu().numpy().tobytes() == hashlib.sha3_256(msg[i].numpy().tobytes()).digest()


def test_forest_on_the_card_matches_the_cpu(cuda):
    matrix = np.random.default_rng(9).integers(0, P, size=(43, 1 << 10), dtype=np.uint32)
    on_card = DeviceMerkleForest(BabyBear, lo=witness_dev.from_numpy(matrix, cuda))
    on_cpu = DeviceMerkleForest(BabyBear, lo=witness_dev.from_numpy(matrix, "cpu"))
    assert on_card.roots() == on_cpu.roots()
    idx = np.random.default_rng(10).integers(0, 1 << 10, size=43)
    for a, b in zip(on_card.open_all(idx), on_cpu.open_all(idx)):
        assert (a.index, a.value.value, a.path.siblings, a.path.directions) == (
            b.index, b.value.value, b.path.siblings, b.path.directions)
    points = np.random.default_rng(11).integers(0, P, size=(43, 10), dtype=np.uint64)
    assert on_card.eval_backend(None, points).tolist() == on_cpu.eval_backend(None, points).tolist()


@pytest.mark.parametrize("name, tape", [("nop4", None), ("add", None), ("fibonacci", [10])])
def test_prove_on_the_card_matches_the_fixture(cuda, name, tape):
    program = (FIXTURES / f"{name}_program.bin").read_bytes()
    entry, segments = 0x1000, None
    if elf.is_elf(program):
        loaded = elf.load(program)
        entry, segments = loaded.entry_pc, loaded.segments
    keccak.LAUNCHES.update(leaves=0, merge=0)
    proof = Prover(BabyBear, seed=0, device=cuda).prove(program, entry, None, 1 << 16, segments, tape)
    assert keccak.LAUNCHES["leaves"] == 1 and keccak.LAUNCHES["merge"] == proof.metadata.num_vars
    data = serialization.BinarySerializer(BabyBear).serialize(proof)
    assert data == (FIXTURES / f"{name}_v1.bin").read_bytes()


def _words(r, n, seed):
    vals = np.random.default_rng(seed).integers(0, P, size=(r, n), dtype=np.uint32)
    vals.reshape(-1)[:2] = [0, P - 1][: vals.size]
    return torch.from_numpy(vals.view(np.int32))


@pytest.mark.parametrize("n", [1, 255, 4097])
@pytest.mark.parametrize("r", [1, 33, 34, 543, 544, 545])
def test_column_sponges_match_plain_and_hashlib(cuda, r, n):
    mat = _words(r, n, seed=r * n)
    before = dict(ligero_dev.LAUNCHES)
    got = ligero_dev.sha3_columns(mat.to(cuda))
    state = torch.zeros((25, n), dtype=torch.int64, device=cuda)
    pw = ligero_dev.pad_words(r)
    on_card = mat.to(cuda)
    for k0 in range(0, pw, 544):
        end = min(k0 + 544, pw)
        live = max(0, min(end, r) - k0)
        ligero_dev.sha3_absorb(state, on_card[k0 : k0 + live], k0, (end - k0) // 34, r)
    torch.cuda.synchronize()
    plain = ligero_dev._sha3_columns_plain(mat)
    assert torch.equal(got.cpu(), plain)
    assert torch.equal(state[:4].t().cpu(), plain)
    assert ligero_dev.LAUNCHES["columns"] == before["columns"] + 1
    assert ligero_dev.LAUNCHES["absorb"] == before["absorb"] + len(range(0, pw, 544))
    words = mat.numpy().view(np.uint32)
    for j in {0, n - 1}:
        want = hashlib.sha3_256(np.ascontiguousarray(words[:, j]).astype("<u4").tobytes()).digest()
        assert got[j].cpu().numpy().tobytes() == want


def test_mixed_commit_on_the_card_matches_the_cpu(cuda):
    rng = np.random.default_rng(12)
    cols = {f"c{v}": rng.integers(0, P, size=1 << v, dtype=np.uint64) for v in (3, 9, 12, 12)}
    on_card = ligero_commit_mixed(BabyBear, cols, device=cuda)
    on_cpu = ligero_commit_mixed(BabyBear, cols, device="cpu")
    assert on_card.levels == on_cpu.levels and on_card.commit_path == "stream-dev"
    idx = [0, 5, on_card.n_e - 1]
    assert np.array_equal(on_card.encoded.gather(idx), on_cpu.encoded.gather(idx))


def test_v2_prove_on_the_card_matches_zigz_tpu(cuda, monkeypatch):
    program = (FIXTURES / "add_program.bin").read_bytes()
    ser = serialization.BinarySerializer(BabyBear)
    ligero_dev.LAUNCHES.update(columns=0, absorb=0)
    prover = Prover(BabyBear, seed=0, device=cuda, protocol_version=2)
    data = ser.serialize(prover.prove(program, 0x1000, None, 1 << 16, None, None))
    assert ligero_dev.LAUNCHES["absorb"] > 0
    assert prover.last_timings["data_commit_path"] == "stream-dev"
    monkeypatch.setenv("ZIGZ_TPU_COMMITMENTS", "host")
    ref = ReferenceProver(BabyBear, seed=0, protocol_version=2).prove(program, 0x1000, None, 1 << 16, None, None)
    assert data == ser.serialize(ref)
