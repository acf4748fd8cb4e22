"""The CUDA kernels and the port's prove on the card (skipped without one).

Run on a machine with an NVIDIA GPU (tests/conftest.py imports JAX, which
that machine need not have, hence --noconftest):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q

Digests and proof bytes are compared whole: tolerance zero.  This file
imports no JAX and nothing of the JAX package: the references are the
kernels' plain PyTorch versions, hashlib, the golden fixtures, the port's
host provers and the pinned digests of
zigz_tpu_torch/testdata/proof_digests.json."""

import hashlib
import json
import pathlib

import numpy as np
import pytest
import torch

from zigz_tpu_torch import BabyBear, Goldilocks, Mersenne61, Prover, Verifier, elf, serialization
from zigz_tpu_torch.commitments.device_forest import DeviceMerkleForest
from zigz_tpu_torch.commitments.ligero import ligero_commit_mixed
from zigz_tpu_torch.core.ext4 import ext_from_ints
from zigz_tpu_torch.core.hash import FiatShamirTranscript
from zigz_tpu_torch.lookups import pipeline_lasso
from zigz_tpu_torch.commitments import ligero
from zigz_tpu_torch.core import poseidon2 as p2_host
from zigz_tpu_torch.ops import ext4_dev, field64, keccak, ligero_dev, ntt_dev, poseidon2, witness_dev, zerocheck_dev_ext
from zigz_tpu_torch.proofs.zerocheck import ZerocheckExtProver, count_zerocheck_proofs
from zigz_tpu_torch.runtime import native_vm

from torch_witness_cases import EDGE_CASES, raw_columns

pytestmark = pytest.mark.cuda

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
PINNED = json.loads((pathlib.Path(__file__).resolve().parent.parent / "zigz_tpu_torch" / "testdata"
                     / "proof_digests.json").read_text())["proofs"]
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


@pytest.mark.parametrize("shape", [(1, 2), (3, 6), (5, 510), (43, 1 << 12)])
@pytest.mark.parametrize("p", [field64.GOLDILOCKS_P, field64.MERSENNE61_P])
def test_e1_matches_its_plain_version(cuda, p, shape):
    """E1 against ``_fold_lsb_u64_plain`` on the same inputs, 0, 1, p - 1
    and 2^63 (Goldilocks: a negative int64) among values and challenges."""
    rng = np.random.default_rng(shape[1])
    vals = rng.integers(0, 1 << 63, size=shape, dtype=np.uint64) % np.uint64(p)
    vals.reshape(-1)[:3] = [0, 1, p - 1][: vals.size]
    if p == field64.GOLDILOCKS_P:
        vals.reshape(-1)[-1] = 1 << 63
    r = rng.integers(0, 1 << 63, size=shape[0], dtype=np.uint64) % np.uint64(p)
    r[: min(3, r.size)] = [p - 1, 0, 1][: min(3, r.size)]
    x, rr = torch.from_numpy(vals.view(np.int64)), torch.from_numpy(r.view(np.int64))
    before = field64.LAUNCHES["fold"]
    got = field64.fold_lsb_u64(x.to(cuda), rr.to(cuda), p)
    torch.cuda.synchronize()
    assert field64.LAUNCHES["fold"] == before + 1
    assert torch.equal(got.cpu(), field64._fold_lsb_u64_plain(x, rr, p))


@pytest.mark.parametrize("n_real, n", [(777, 1 << 10), (4_190_000, 1 << 22)])
@pytest.mark.parametrize("field", [BabyBear, Goldilocks, Mersenne61])
def test_w1_matches_its_plain_version(cuda, field, n_real, n):
    """W1 against ``_witness_rows_plain`` on the same raw columns, byte for
    byte: rows 0 and 33-42 (the rest left as they were), the reduced write
    value and the write index; one launch over ``n_real`` steps."""
    p = field.MODULUS
    cols = {k: torch.from_numpy(a.view(np.int64) if a.dtype == np.uint64 else a)
            for k, a in raw_columns(n_real, seed=n_real).items()}
    last_pc = int(cols["pc"][-1]) & ((1 << 64) - 1)
    dtype = torch.int64 if p >= 1 << 31 else torch.int32
    want = torch.full((43, n), 7, dtype=dtype)
    want_val, want_idx = witness_dev.witness_rows(cols, n_real, last_pc, want, p)
    got = torch.full((43, n), 7, dtype=dtype, device=cuda)
    before = dict(witness_dev.ROWS)
    got_val, got_idx = witness_dev.witness_rows({k: v.to(cuda) for k, v in cols.items()}, n_real, last_pc, got, p)
    torch.cuda.synchronize()
    assert witness_dev.ROWS == {"launches": before["launches"] + 1, "steps": before["steps"] + n_real}
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got_val.cpu(), want_val) and torch.equal(got_idx.cpu(), want_idx)


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_build_witness_on_the_card_launches_w1_once(cuda, case):
    """One ``build_witness`` of a native trace on the card: exactly one
    launch of W1, and the witness of the CPU's plain path."""
    spec = EDGE_CASES[case]()
    nvm = native_vm.NativeVM()
    nvm.load_segment(0x1000, spec["program"])
    trace = nvm.run(0x1000, 10000, spec["initial_regs"], None)["trace"]
    num_vars = max(0, (trace.step_count() - 1).bit_length())
    for field in (BabyBear, Goldilocks):
        before = witness_dev.ROWS["launches"]
        lo = witness_dev.build_witness(trace, trace.initial_regs, num_vars, cuda, p=field.MODULUS)
        assert witness_dev.ROWS["launches"] == before + 1
        assert torch.equal(lo.cpu(), witness_dev.build_witness(trace, trace.initial_regs, num_vars, "cpu",
                                                               p=field.MODULUS))


@pytest.mark.parametrize("field", [Goldilocks, Mersenne61])
def test_wide_field_prove_on_the_card_matches_its_pin(cuda, field):
    case = PINNED["v1-goldilocks-nop-2^16" if field is Goldilocks else "v1-mersenne61-nop-2^16"]
    program = bytes([0x13, 0, 0, 0]) * case["program"]["count"]
    field64.LAUNCHES["fold"] = 0
    prover = Prover(field, seed=0)  # the default device
    data = serialization.BinarySerializer(field).serialize(prover.prove(program, 0x1000, None, case["max_steps"]))
    assert (len(data), hashlib.sha256(data).hexdigest()) == (case["bytes"], case["sha256"])
    assert field64.LAUNCHES["fold"] == 16
    assert Verifier(field).verify(serialization.BinarySerializer(field).deserialize(data), program) == "Accept"


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


@pytest.mark.parametrize("hash_mode", ["sha3", "poseidon2"])
@pytest.mark.parametrize("discard, group", [(1 << 12, 1 << 14), (1 << 9, 1 << 13), (1, 1 << 11)])
def test_forest_under_a_forced_plan_on_the_card_matches_the_full_one(cuda, monkeypatch, hash_mode, discard, group):
    """Levels freed and trees in groups (the last group smaller) against the
    forest that keeps every level: roots, kept levels, and every opened
    sibling, the recomputed ones against the full forest's kept levels."""
    from zigz_tpu_torch.commitments import device_forest

    B, N = 43, 1 << 9
    matrix = np.random.default_rng(discard + group).integers(0, P, size=(B, N), dtype=np.uint32)
    lo = witness_dev.from_numpy(matrix, cuda)
    full = DeviceMerkleForest(BabyBear, lo=lo, hash_mode=hash_mode)
    assert full.discarded == 0 and full.group_trees == B
    monkeypatch.setattr(device_forest, "DISCARD_DIGESTS", discard)
    monkeypatch.setattr(device_forest, "GROUP_LEAF_DIGESTS", group)
    before = dict(keccak.LAUNCHES)
    planned = DeviceMerkleForest(BabyBear, lo=lo, hash_mode=hash_mode)
    plan = planned.plan()
    assert planned.discarded > 0 and plan["groups"] >= 2 and B % planned.group_trees
    if hash_mode == "sha3":  # K1 once and K2 once per level, for each group
        assert keccak.LAUNCHES == {"leaves": before["leaves"] + plan["groups"],
                                   "merge": before["merge"] + plan["groups"] * planned.height}
    assert planned.roots() == full.roots()
    for k, level in enumerate(planned.levels):
        assert (level is None) == (k < planned.discarded)
        if level is not None:
            assert torch.equal(level, full.levels[k])
    before = dict(keccak.LAUNCHES)
    idx = np.random.default_rng(11).integers(0, N, size=B)
    opened = planned.open_all(idx)
    if hash_mode == "sha3":  # K1 once per freed level, K2 k times for level k
        D = planned.discarded
        assert keccak.LAUNCHES == {"leaves": before["leaves"] + D, "merge": before["merge"] + D * (D - 1) // 2}
    for a, b in zip(opened, full.open_all(idx)):
        assert (a.index, a.value.value, a.path.siblings, a.path.directions) == (
            b.index, b.value.value, b.path.siblings, b.path.directions)


def test_base_zerocheck_on_the_card_matches_the_host_provers(cuda):
    """ops/zerocheck_gen.py on the card, every round there (host tail 1),
    against the numpy prover and the card's rounds down to the default tail."""
    from zigz_tpu_torch.ops import zerocheck_gen
    from zigz_tpu_torch.proofs.zerocheck import ZerocheckProver, make_zerocheck_prover

    n = 1 << 13
    rng = np.random.default_rng(12)
    cols = {name: rng.integers(0, P, size=n, dtype=np.uint64) for name in ("a", "b", "g")}
    cols["__sel__"] = rng.integers(0, 2, size=n, dtype=np.uint64)

    def comb(c, alphas, p):
        fp = (5 + p - (c["a"] + 7 * c["b"]) % p) % p
        return (alphas[0] * ((c["g"] * fp + p - c["__sel__"]) % p) + alphas[1] * (c["__sel__"] * c["b"] % p)) % p

    def run(prover):
        transcript = FiatShamirTranscript()
        proof = prover.prove(transcript)
        return proof.round_evals, proof.final_point, proof.column_evals, transcript.challenge_value(P)

    want = run(ZerocheckProver(BabyBear, cols, comb, 3, num_alphas=2))
    zerocheck_gen.DEVICE_PROVES.update(count=0, sweep_launches=0)
    assert run(make_zerocheck_prover(BabyBear, cols, comb, 3, num_alphas=2, device=cuda)) == want
    assert run(zerocheck_gen.GenericDeviceZerocheck(BabyBear, cols, comb, 3, num_alphas=2, host_tail=1,
                                                    device=cuda)) == want
    assert zerocheck_gen.DEVICE_PROVES["count"] == 2 and zerocheck_gen.DEVICE_PROVES["sweep_launches"] > 0


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


@pytest.mark.parametrize("rows, n, n_out", [(1, 1, 2), (33, 4096, 4096), (33, 1, 1 << 13), (545, 2048, 1 << 14),
                                            (3, 1 << 16, 1 << 16), (544, 1 << 13, 1 << 16), (0, 8, 1 << 14)])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_ntt_kernels_match_their_plain_version(cuda, rows, n, n_out, dtype):
    """N1 and N2 (``encode_rows`` on the card) against ``_encode_rows_plain``
    on the same inputs, byte for byte, with N1 once and N2 once a pass of
    ``n2_passes`` (8 stages at most a pass) for a block with rows, no launch
    for one without."""
    mat = _words(rows, n, seed=rows + n).to(dtype)
    before = dict(ntt_dev.LAUNCHES)
    got = ntt_dev.encode_rows(mat.to(cuda), n_out)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and tuple(got.shape) == (rows, n_out)
    assert torch.equal(got.cpu(), ntt_dev._encode_rows_plain(mat, n_out))
    log_k = (n_out // n).bit_length() - 1
    assert len(ntt_dev.n2_passes(n, n_out)) == -(-max(0, n_out.bit_length() - 1 - max(13, log_k)) // 8)
    want = (1, len(ntt_dev.n2_passes(n, n_out))) if rows else (0, 0)
    assert (ntt_dev.LAUNCHES["tile"] - before["tile"], ntt_dev.LAUNCHES["pass"] - before["pass"]) == want


def test_mixed_commit_on_the_card_matches_the_cpu(cuda):
    rng = np.random.default_rng(12)
    cols = {f"c{v}": rng.integers(0, P, size=1 << v, dtype=np.uint64) for v in (3, 9, 12, 12)}
    on_card = ligero_commit_mixed(BabyBear, cols, device=cuda)
    on_cpu = ligero_commit_mixed(BabyBear, cols, device="cpu")
    assert on_card.levels == on_cpu.levels and on_card.commit_path == "stream-dev"
    idx = [0, 5, on_card.n_e - 1]
    assert np.array_equal(on_card.encoded.gather(idx), on_cpu.encoded.gather(idx))


def test_v2_prove_on_the_card_matches_zigz_tpu(cuda):
    """The v2 prove of the fibonacci guest on the card: zigz_tpu's bytes
    (the pinned digest), the commitments through K5, every zerocheck on
    GenericDeviceZerocheckExt and fed from the resident matrices, the Lasso
    rounds on the card, accepted by the verifier."""
    case = PINNED["v2-fibonacci-10000"]
    program = (FIXTURES / case["program"]["name"]).read_bytes()
    loaded = elf.load(program)
    ser = serialization.BinarySerializer(BabyBear)
    ligero_dev.LAUNCHES.update(columns=0, absorb=0)
    zerocheck_dev_ext.reset_counters()
    pipeline_lasso.DEVICE_ROUNDS["count"] = 0
    prover = Prover(BabyBear, seed=0, device=cuda, protocol_version=2)
    proof = prover.prove(program, loaded.entry_pc, None, case["max_steps"], loaded.segments, case["program"]["tape"])
    data = ser.serialize(proof)
    assert ligero_dev.LAUNCHES["absorb"] > 0
    assert prover.last_timings["data_commit_path"] == "stream-dev"
    assert zerocheck_dev_ext.DEVICE_PROVES["count"] == count_zerocheck_proofs(proof) >= 12
    assert zerocheck_dev_ext.COLUMNS["resident"] > 0 and pipeline_lasso.DEVICE_ROUNDS["count"] > 0
    assert (proof.metadata.num_steps, len(data), hashlib.sha256(data).hexdigest()) == (
        case["num_steps"], case["bytes"], case["sha256"])
    assert Verifier(BabyBear).verify(ser.deserialize(data), program) == "Accept"


def test_ext_zerocheck_of_a_real_v2_combiner_on_the_card_matches_native(cuda):
    """The core argument's combiner at width 2^16: the card's rounds against
    the native C++ prover (device=None), same transcript and proof."""
    from zigz_tpu_torch.constraints import v2
    from zigz_tpu_torch.constraints.core_arg import CORE_COLUMNS, V2_G_COLUMNS
    from zigz_tpu_torch.ops.zerocheck_native import native_available

    assert native_available()
    rng = np.random.default_rng(23)
    tau, beta = (ext_from_ints([int(x) for x in rng.integers(0, P, size=4)]) for _ in range(2))
    comb = v2.make_v2_combiner(tau, beta)
    num_vars = 16
    n = 1 << num_vars
    cols = {name: rng.integers(0, P, size=n, dtype=np.uint64) for name in (*CORE_COLUMNS, *V2_G_COLUMNS)}
    cols.update(v2.logup_public_tables(n, num_vars, P))

    def prove(device):
        t = FiatShamirTranscript()
        proof = ZerocheckExtProver(BabyBear, cols, comb, v2.V2_DEGREE, num_alphas=v2.NUM_V2_ALPHAS,
                                   device=device).prove(t)
        return t.finalize(), [[g.to_ints() for g in r] for r in proof.round_evals], [
            r.to_ints() for r in proof.final_point], {k: e.to_ints() for k, e in proof.column_evals.items()}

    zerocheck_dev_ext.reset_counters()
    torch.cuda.reset_peak_memory_stats(cuda)
    on_card = prove(cuda)
    assert zerocheck_dev_ext.DEVICE_PROVES["count"] == 1 and zerocheck_dev_ext.DEVICE_PROVES["sweep_launches"] > 0
    assert torch.cuda.max_memory_allocated(cuda) > 0
    assert on_card == prove(None)
    assert zerocheck_dev_ext.DEVICE_PROVES["count"] == 1  # the native prover is not counted


@pytest.mark.parametrize("width", [2, 64, 1 << 12])
def test_zerocheck_kernels_match_their_plain_versions(cuda, width):
    """Z1 (round sums of the core argument's DAGs, both layouts, each
    through the kernel generated for its program) and Z2 (the fold from
    each layout) on card tensors == their plain versions on the same
    tensors; each wrapper call is one launch, and the prover started both
    programs' builds when it was constructed."""
    from zigz_tpu_torch.constraints import v2
    from zigz_tpu_torch.constraints.core_arg import CORE_COLUMNS, V2_G_COLUMNS
    from zigz_tpu_torch.ops import dag_dev
    from zigz_tpu_torch.ops.symtrace import compile_device, trace_combiner_ext

    rng = np.random.default_rng(width)
    ext = [ext_from_ints([int(x) for x in rng.integers(0, P, size=4)]) for _ in range(2 + v2.NUM_V2_ALPHAS)]
    comb = v2.make_v2_combiner(ext[0], ext[1])
    base = sorted((*CORE_COLUMNS, *V2_G_COLUMNS, *v2.logup_public_tables(4, 2, P)))
    B, G = len(base), len(base) + 1
    zc = zerocheck_dev_ext.GenericDeviceZerocheckExt(
        BabyBear, {name: np.zeros(width, dtype=np.uint64) for name in base}, comb, v2.V2_DEGREE,
        num_alphas=v2.NUM_V2_ALPHAS, device=cuda)
    layouts = (B + 4, 4 * G)
    for lift, row_of, rows in zip((False, True), zc._row_maps(), layouts):
        tr = trace_combiner_ext(comb, base, [], ext[2:], P, lift_base=lift)
        program = compile_device(tr.nodes, tr.outs, row_of)
        consts = program.constants(tr.consts)
        planes = torch.from_numpy(rng.integers(0, P, size=(rows, width), dtype=np.int64)).to(cuda)
        before = dag_dev.LAUNCHES["round_sums"]
        got = dag_dev.round_sums(program, consts, planes, v2.V2_DEGREE)
        assert dag_dev.LAUNCHES["round_sums"] == before + 1
        assert program.kernel is zc.programs[lift].kernel and program.kernel.path.is_file()
        assert torch.equal(got, dag_dev.plain_round_sums(program, consts, planes, v2.V2_DEGREE).cpu())
        groups = zerocheck_dev_ext.fold_groups(B, 0)[lift]
        r4 = [int(x) for x in rng.integers(0, P, size=4)]
        before = ext4_dev.LAUNCHES["fold_planes"]
        folded = ext4_dev.fold_planes(planes, r4, groups)
        assert ext4_dev.LAUNCHES["fold_planes"] == before + 1
        assert torch.equal(folded, ext4_dev._fold_planes_plain(planes, r4, groups))


def test_ext4_and_lasso_rounds_on_the_card_match_the_cpu(cuda):
    rng = np.random.default_rng(31)
    t4 = torch.from_numpy(rng.integers(0, P, size=(4, 5, 1 << 10), dtype=np.int64))
    t4[:, 0, :2] = torch.tensor([0, P - 1])
    r = [int(x) for x in rng.integers(0, P, size=4)]
    for fn, arg in ((ext4_dev.ext_fold_dev, t4), (ext4_dev.ext_fold_base_dev, t4[0]),
                    (ext4_dev.ext_scale_dev, t4), (ext4_dev.ext_inv_dev, t4[:, 0])):
        args = (r,) if fn is not ext4_dev.ext_inv_dev else ()
        assert torch.equal(fn(arg.to(cuda), *args).cpu(), fn(arg, *args))
    assert torch.equal(ext4_dev.ext_mul_dev(t4.to(cuda), t4.flip(-1).to(cuda)).cpu(), ext4_dev.ext_mul_dev(t4, t4.flip(-1)))
    taus = [[int(x) for x in rng.integers(0, P, size=4)] for _ in range(12)]
    assert torch.equal(ext4_dev.ext_eq_table_dev(taus, 1 << 12, cuda).cpu(), ext4_dev.ext_eq_table_dev(taus, 1 << 12, "cpu"))

    evals = rng.integers(0, P, size=1 << 15, dtype=np.uint64)
    results = []
    for device in (cuda, torch.device("cpu")):
        t = FiatShamirTranscript()
        rounds, point, final = pipeline_lasso._sumcheck_rounds_device(BabyBear, t, evals.copy(), device)
        results.append(([[c.value for c in row] for row in rounds], [c.value for c in point], final.value, t.finalize()))
    assert results[0] == results[1]


# -- protocols v3 and v4, the advice twins, the device Ligero state -----------

@pytest.mark.parametrize("n", [1, 255, 4097, 1 << 16])
def test_poseidon2_on_the_card_matches_the_host(cuda, n):
    rng = np.random.default_rng(n)
    vals = rng.integers(0, P, size=n, dtype=np.uint64)
    vals[:2] = [0, P - 1][:n]
    leaves = poseidon2.p2_leaves(torch.from_numpy(vals.astype(np.int32)).to(cuda))
    assert poseidon2.limbs_to_bytes(leaves) == p2_host.np_batch_leaf_hashes(vals)
    level = rng.integers(0, P, size=(8, 2 * n), dtype=np.uint64)
    merged = poseidon2.p2_merge(torch.from_numpy(level.astype(np.int32)).to(cuda))
    assert poseidon2.limbs_to_bytes(merged) == p2_host.np_batch_merge_hashes(level.T.astype("<u4").tobytes())


@pytest.mark.parametrize("rows", [1, 13, 545])
def test_poseidon2_column_sponge_on_the_card_matches_hash_columns(cuda, rows):
    mat = np.random.default_rng(rows).integers(0, P, size=(rows, 64), dtype=np.uint64)
    want = ligero._hash_columns(ligero.ntt_pow2_u32(mat, 512), "poseidon2")
    got = poseidon2.p2_columns_stream(torch.from_numpy(mat.astype(np.int32)).to(cuda), 512)
    assert poseidon2.limbs_to_bytes(got) == want


@pytest.mark.parametrize("n", [1, 2, 37, 255, 4097])
def test_poseidon2_kernels_match_their_plain_versions(cuda, n):
    """P1, P2 and P3 (and the bare permutation, P3 with no rows) against
    their plain versions on the same values, one launch a call."""
    rng = np.random.default_rng(100 + n)

    def canonical(shape):
        vals = rng.integers(0, P, size=shape, dtype=np.uint64)
        vals.reshape(-1)[:2] = [0, P - 1][: vals.size]
        return torch.from_numpy(vals.astype(np.int32))

    values, level, state = canonical(n), canonical((8, 2 * n)), canonical((16, n))
    before = dict(poseidon2.LAUNCHES)
    assert torch.equal(poseidon2.p2_leaves(values.to(cuda)).cpu(), poseidon2._p2_leaves_plain(values))
    assert torch.equal(poseidon2.p2_merge(level.to(cuda)).cpu(), poseidon2._p2_merge_plain(level))
    wide = state.to(torch.int64)
    assert torch.equal(poseidon2.permute_device(wide.to(cuda)).cpu(), poseidon2._permute_plain(wide))
    for rows in (0, 1, 7, 8, 9, 545):
        msg = canonical((rows, n))
        got = poseidon2.p2_absorb(state.clone().to(cuda), msg.to(cuda))
        assert torch.equal(got.cpu(), poseidon2._p2_absorb_plain(state.clone(), msg))
    torch.cuda.synchronize()
    assert poseidon2.LAUNCHES == {"leaves": before["leaves"] + 1, "merge": before["merge"] + 1,
                                  "absorb": before["absorb"] + 7}


@pytest.mark.parametrize("hash_mode", ["sha3", "poseidon2"])
def test_stitched_commit_on_the_card_matches_the_cpu(cuda, hash_mode):
    """Device-built columns placed into the device matrix, the rest uploaded."""
    rng = np.random.default_rng(14)
    cols = {f"c{k}": rng.integers(0, P, size=1 << v, dtype=np.uint64) for k, v in enumerate((3, 9, 12, 12, 0))}
    dev_columns = {k: torch.from_numpy(cols[k].astype(np.int32)).to(cuda) for k in ("c0", "c2", "c4")}
    on_card = ligero_commit_mixed(BabyBear, cols, hash_mode, device=cuda, dev_columns=dev_columns)
    on_cpu = ligero_commit_mixed(BabyBear, cols, hash_mode, device="cpu")
    assert on_card.levels == on_cpu.levels and on_card.commit_path == "stream-dev"
    assert torch.equal(on_card.encoded.mat_dev.cpu(), on_cpu.encoded.mat_dev)


@pytest.mark.parametrize("name", ["v3-fibonacci-10000", "v4-nop-2^16"])
def test_v3_v4_prove_on_the_card_matches_zigz_tpu(cuda, name):
    """Pinned digest, Accept, the advice planes built on the card, and the
    launches of the path: v3 runs no SHA3 kernel, v4 no forest kernel."""
    case = PINNED[name]
    if case["program"]["kind"] == "nop":
        program, entry, segments, tape = bytes([0x13, 0, 0, 0]) * case["program"]["count"], 0x1000, None, None
    else:
        program = (FIXTURES / case["program"]["name"]).read_bytes()
        loaded = elf.load(program)
        entry, segments, tape = loaded.entry_pc, loaded.segments, case["program"]["tape"]
    ser = serialization.BinarySerializer(BabyBear)
    keccak.LAUNCHES.update(leaves=0, merge=0)
    ligero_dev.LAUNCHES.update(columns=0, absorb=0)
    poseidon2.LAUNCHES.update(leaves=0, merge=0, absorb=0)
    poseidon2.PERMUTATIONS["count"] = 0
    prover = Prover(BabyBear, seed=0, protocol_version=case["protocol_version"])  # the default device
    assert prover.device.type == "cuda"
    proof = prover.prove(program, entry, None, case["max_steps"], segments, tape)
    data = ser.serialize(proof)
    assert (proof.metadata.num_steps, len(data), hashlib.sha256(data).hexdigest()) == (
        case["num_steps"], case["bytes"], case["sha256"])
    assert Verifier(BabyBear).verify(ser.deserialize(data), program) == "Accept"
    assert prover.last_timings["advice_dev_cols"] == 148
    assert prover.last_timings["data_commit_path"] == prover.last_timings["advice_commit_path"] == "stream-dev"
    assert keccak.LAUNCHES == {"leaves": 0, "merge": 0}
    assert poseidon2.PERMUTATIONS["count"] == 0  # no plain permutation on the card
    if case["protocol_version"] == 3:
        assert ligero_dev.LAUNCHES["absorb"] == 0 and all(poseidon2.LAUNCHES.values())
    else:
        assert ligero_dev.LAUNCHES["absorb"] > 0 and not any(poseidon2.LAUNCHES.values())
        assert proof.witness_commitments == []


def test_device_ligero_state_opens_on_the_card(cuda):
    rng = np.random.default_rng(15)
    names = [f"w{k:02d}" for k in range(5)]
    rows = rng.integers(0, P, size=(5, 1 << 10), dtype=np.uint64)
    state = ligero_dev.ligero_commit_device(BabyBear, names, torch.from_numpy(rows.astype(np.int32)).to(cuda))
    host = ligero.ligero_commit(BabyBear, {n: rows[k] for k, n in enumerate(names)}, "sha3")
    assert state.matrix.is_cuda and state.encoded.is_cuda and state.levels == host.levels
    point = [int(x) for x in rng.integers(1, P, size=10)]
    opened = ligero.ligero_prove_eval(state, point, FiatShamirTranscript())
    ref = ligero.ligero_prove_eval(host, point, FiatShamirTranscript())
    assert np.array_equal(opened.us[0].c, ref.us[0].c) and np.array_equal(opened.columns, ref.columns)
    evals = ligero.ligero_column_evals(state, point)
    assert evals == ligero.ligero_column_evals(host, point)
    assert ligero.ligero_verify_eval(BabyBear, state.root, 10, names, evals, point, opened, FiatShamirTranscript())


# -- the sharded prover: ranks that share the card ------------------------------

GROUP_CHECKS = [
    {"name": "wrappers", "kind": "wrappers", "seed": 1},
    {"name": "sumcheck", "kind": "dist_sumcheck", "seed": 7, "log2_n": 12},
    {"name": "step", "kind": "prove_step", "seed": 3, "B": 43, "v": 10},
    {"name": "commit", "kind": "commit", "seed": 0, "rows": 601, "n": 1 << 10, "n_e": 1 << 13, "n_gather": 23},
    {"name": "mixed", "kind": "mixed_commit", "seed": 2, "log2_sizes": [12, 11, 8]},
    {"name": "batch_eval", "kind": "batch_eval", "seed": 3, "log2_sizes": [12, 12, 8, 6]},
    {"name": "forest", "kind": "forest", "seed": 5, "B": 43, "v": 10,
     "discard_digests": (43 << 10) >> 2, "group_leaf_digests": 16 << 9},
    {"name": "lasso", "kind": "lasso_rounds", "seed": 9, "log2_n": 14},
    {"name": "zerocheck", "kind": "zerocheck_gen", "seed": 11, "log2_n": 14},
]


def test_group_pieces_on_two_ranks_sharing_the_card(cuda, tmp_path):
    """Two gloo ranks on cuda:0: every piece equals its single-device
    result, the sharded commit launches K4 once, the forest K1 and K2."""
    from torch_group_checks import launch_checks

    results = launch_checks(2, GROUP_CHECKS, work_dir=str(tmp_path), device="cuda:0", backend="gloo", timeout_s=600)
    for res in results:
        assert res["device"] == "cuda:0"
        checks = res["results"]
        assert checks["wrappers"]["rows_to_columns_ok"] and checks["wrappers"]["gather_cyclic_ok"]
        for name in GROUP_CHECKS[1:]:
            assert checks[name["name"]]["equal_single"], name["name"]
        assert checks["commit"]["launches"]["K4"] == 1 and checks["commit"]["launches"]["K5"] == 0
        assert checks["mixed"]["commit_path"] == "mesh" and checks["mixed"]["verified"]
        assert checks["batch_eval"]["sharded"] and checks["batch_eval"]["mesh_rounds"] > 0
        assert (checks["forest"]["plan"]["discarded_levels"], checks["forest"]["plan"]["groups"]) == (2, 3)


@pytest.mark.parametrize("version,name", [(1, "v1-nop-2^16"), (2, "v2-nop-2^16")])
def test_group_prove_on_two_ranks_sharing_the_card(cuda, tmp_path, version, name):
    from zigz_tpu_torch.parallel.launch import launch

    case = PINNED[name]
    results = launch(2, "prove", {"program": case["program"], "max_steps": case["max_steps"],
                                  "protocol_version": version},
                     work_dir=str(tmp_path), device="cuda:0", backend="gloo", timeout_s=600)
    for res in results:
        assert (res["num_steps"], res["bytes"], res["sha256"], res["verify"]) == (
            case["num_steps"], case["bytes"], case["sha256"], "Accept")
        assert res["launches"]["K1"] > 0 and res["launches"]["K2"] > 0
        if version == 2:
            t = res["timings"]
            assert res["launches"]["K4"] == 2 and res["launches"]["K5"] == 0
            assert t["data_commit_sharded"] and t["advice_commit_sharded"] and t["batch_eval_sharded"]
            assert t["open_sharded"] and t["zerochecks_sharded"] is False


def test_wrappers_under_a_one_rank_nccl_group(cuda, tmp_path):
    """The "nccl" branch hands CUDA tensors to the collectives as they are."""
    from torch_group_checks import launch_checks

    res = launch_checks(1, [GROUP_CHECKS[0]], work_dir=str(tmp_path), device="cuda:0", backend="nccl",
                        timeout_s=300)[0]["results"]["wrappers"]
    assert res["rows_to_columns_ok"] and res["gather_cyclic_ok"] and res["gather_last_ok"]
    assert res["all_reduce"] == [0, 1, 2, 3, 4, 5] and res["exchange_rows"] == [0]
    assert res["collectives"] == {"all_reduce": 1, "all_gather": 3, "all_to_all": 2}



def test_bench_on_the_card_prints_its_line(cuda):
    """bench_torch.py at reduced sizes: the headline kernel's rate, v1 2^14
    and v2 2^16 held to their pins, the card's line before the result."""
    import subprocess
    import sys

    root = FIXTURES.parent.parent
    res = subprocess.run([sys.executable, str(root / "bench_torch.py"), "--field-log2", "20", "--v1", "14",
                          "--v2", "16", "--v3", "--v4"], cwd=root, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    line = json.loads(lines[-1])
    extra = line["extra"]
    assert line["metric"] == "babybear_field_ops_per_s_per_chip" and line["value"] > 0
    assert extra["backend"] == "cuda" and extra["cuda_device"]["nvidia_smi"] == lines[-2]
    assert extra["field_lanes"] == 1 << 20 and extra["field_kernel_launches"] == 22
    assert extra["torch_int64_mul_per_s"] > 0
    (entry,) = extra["v1_ladder"]
    assert entry["held"] == extra["v2_held"] == "pinned"
    assert entry["sha256"] == PINNED["v1-nop-2^14"]["sha256"] and extra["v2_sha256"] == PINNED["v2-nop-2^16"]["sha256"]
    assert entry["launches"]["K1"] > 0 and entry["max_memory_allocated_B"] > 0
    assert extra["v2_counters"]["device_zerochecks"] == extra["v2_counters"]["zerochecks"] > 0
