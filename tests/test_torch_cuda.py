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
from zigz_tpu_torch.ops import keccak, witness_dev

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
