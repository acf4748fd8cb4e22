"""Port Ligero (encode, plain K4/K5, streamed commit, mixed and device
commits) == zigz_tpu's Ligero == hashlib.

On the CPU the port's wrappers take the kernels' plain PyTorch versions.
zigz_tpu's Pallas column sponges need Mosaic and cannot run here; the twin
the JAX package holds them to is ``_hash_columns(encoded, "sha3")``, so the
port is held to it, to hashlib and to zigz_tpu's host commitments.  Field
values, digests, roots and transcripts are integers and bytes: tolerance
zero."""

import hashlib

import numpy as np
import pytest
import torch

from zigz_tpu.commitments import ligero as ref
from zigz_tpu.core.ext4 import Ext4
from zigz_tpu.core.field import BabyBear as F
from zigz_tpu.core.hash import FiatShamirTranscript
from zigz_tpu.ops.ntt_dev import encode_rows_device
from zigz_tpu.proofs.batch_eval import mixed_claim_from_rho
from zigz_tpu_torch.commitments import ligero as port_ligero
from zigz_tpu_torch.commitments.ligero import ligero_commit_mixed
from zigz_tpu_torch.core.ext4 import Ext4 as PortExt4
from zigz_tpu_torch.core.hash import FiatShamirTranscript as PortTranscript
from zigz_tpu_torch.ops import ligero_dev, ntt_dev
from zigz_tpu_torch.ops.keccak import digests_to_bytes

P = F.MODULUS
ROW_COUNTS = [1, 33, 34, 543, 544, 545]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several pytest workers on a few cores: torch's own
    intra-op thread pool would oversubscribe them (tens of times slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _canonical(shape, seed):
    vals = np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)
    flat = vals.reshape(-1)
    flat[: min(flat.size, 2)] = [0, P - 1][: min(flat.size, 2)]
    return vals


def _words(mat_u64):
    return torch.from_numpy(mat_u64.astype(np.uint32).view(np.int32))


# -- encode ----------------------------------------------------------------


@pytest.mark.parametrize(
    "rows, n, n_out",
    [(5, 256, 1024), (3, 128, 512), (7, 64, 256), (2, 1, 2), (2, 1, 4), (2, 4, 16), (2, 32, 128),
     (3, 8, 8)],
)
def test_encode_rows_matches_jax_and_host(rows, n, n_out):
    """The shapes of tests/test_ntt_dev.py, n_out < 256 included (the JAX
    package encodes those on the host; the port encodes every size)."""
    mat = _canonical((rows, n), seed=rows * n + n_out)
    got = ntt_dev.encode_rows(_words(mat), n_out)
    assert got.dtype == torch.int32 and tuple(got.shape) == (rows, n_out)
    host = ref._ntt_pow2_numpy(mat, n_out)
    assert np.array_equal(got.numpy().astype(np.uint64), host)
    assert np.array_equal(np.asarray(encode_rows_device(mat, n_out), dtype=np.uint64), host)


def test_encode_rows_in_slabs(monkeypatch):
    monkeypatch.setattr(ntt_dev, "_SLAB_ELEMS", 2 * 1024)  # 2 rows per slab
    mat = _canonical((9, 256), seed=9)
    got = ntt_dev.encode_rows(torch.from_numpy(mat.astype(np.int64)), 1024)
    assert np.array_equal(got.numpy().astype(np.uint64), ref._ntt_pow2_numpy(mat, 1024))


@pytest.mark.parametrize("n, n_out", [(3, 8), (4, 1), (8, 4), (1, 1)])
def test_encode_rows_rejects_bad_sizes(n, n_out):
    with pytest.raises(ValueError):
        ntt_dev.encode_rows(torch.zeros((2, n), dtype=torch.int32), n_out)


# -- K4 / K5 plain versions ------------------------------------------------


@pytest.mark.parametrize("r", ROW_COUNTS)
def test_sha3_columns_plain_matches_jax_and_hashlib(r):
    mat = _canonical((r, 5), seed=r)
    got = digests_to_bytes(ligero_dev.sha3_columns(_words(mat)))
    assert got == ref._hash_columns(mat.astype(np.uint32), "sha3")
    for j in (0, 4):
        col = np.ascontiguousarray(mat[:, j]).astype("<u4").tobytes()
        assert got[32 * j : 32 * (j + 1)] == hashlib.sha3_256(col).digest()


def _absorb_raw(mat_u64, step_words):
    """K5 driven over raw message rows, ``step_words`` words per call."""
    r, n = mat_u64.shape
    words = _words(mat_u64)
    state = torch.zeros((25, n), dtype=torch.int64)
    pw = ligero_dev.pad_words(r)
    for k0 in range(0, pw, step_words):
        end = min(k0 + step_words, pw)
        live = max(0, min(end, r) - k0)
        ligero_dev.sha3_absorb(state, words[k0 : k0 + live], k0, (end - k0) // 34, r)
    return digests_to_bytes(state[:4].t().contiguous())


@pytest.mark.parametrize("r", ROW_COUNTS)
@pytest.mark.parametrize("step_words", [34, 544])
def test_sha3_absorb_plain_matches_jax(r, step_words):
    """One rate block per call, and 544-word stream blocks."""
    mat = _canonical((r, 3), seed=100 + r)
    assert _absorb_raw(mat, step_words) == ref._hash_columns(mat.astype(np.uint32), "sha3")


def test_sha3_absorb_carries_the_state():
    """Two calls of 8 blocks == one call of 16 blocks, from any state."""
    rng = np.random.default_rng(7)
    state = torch.from_numpy(rng.integers(0, 1 << 63, size=(25, 4), dtype=np.int64))
    msg = _words(_canonical((544, 4), seed=8))
    one = ligero_dev.sha3_absorb(state.clone(), msg, 544, 16, 2000)
    two = state.clone()
    ligero_dev.sha3_absorb(two, msg[:272].contiguous(), 544, 8, 2000)
    ligero_dev.sha3_absorb(two, msg[272:].contiguous(), 816, 8, 2000)
    assert torch.equal(one, two)


@pytest.mark.parametrize(
    "k0, nb, live, r",
    [(17, 1, 0, 100), (0, 5, 0, 100), (-34, 1, 0, 100), (0, 1, 40, 35)],
    ids=["unaligned", "past-the-pad", "negative", "rows-past-r"],
)
def test_sha3_absorb_rejects_what_the_kernel_does_not_take(k0, nb, live, r):
    state = torch.zeros((25, 2), dtype=torch.int64)
    with pytest.raises(ValueError):
        ligero_dev.sha3_absorb(state, torch.zeros((live, 2), dtype=torch.int32), k0, nb, r)


def test_plain_versions_do_not_count_launches():
    before = dict(ligero_dev.LAUNCHES)
    mat = _words(_canonical((40, 4), seed=1))
    ligero_dev.sha3_columns(mat)
    ligero_dev.sha3_absorb(torch.zeros((25, 4), dtype=torch.int64), mat[:34].contiguous(), 0, 1, 40)
    assert ligero_dev.LAUNCHES == before


# -- streamed commit and gather --------------------------------------------


@pytest.mark.parametrize("rows", [33, 545, 1100])
def test_sha3_columns_stream_matches_jax(rows):
    """Across 544-row stream blocks: the virtual encoded matrix's digests."""
    mat = _canonical((rows, 4), seed=rows)
    got = ligero_dev.sha3_columns_stream(_words(mat), 32)
    assert digests_to_bytes(got) == ref._hash_columns(ref.ntt_pow2_u32(mat, 32), "sha3")


def test_gather_encoded_columns_matches_the_encoded_matrix():
    mat = _canonical((600, 4), seed=3)
    idx = [0, 31, 5, 5, 17]
    enc = ref.ntt_pow2_u32(mat, 32)
    got = ligero_dev.StreamedEncoded(_words(mat), 32).gather(idx)
    assert got.dtype == np.uint64 and np.array_equal(got, enc[:, idx].T.astype(np.uint64))


# -- commitments ------------------------------------------------------------


def _mixed_columns(seed):
    rng = np.random.default_rng(seed)
    sizes = {"a": 10, "b": 10, "c": 8, "d": 3, "e": 0, "f": 9}
    return {name: rng.integers(0, P, size=1 << v, dtype=np.uint64) for name, v in sizes.items()}


def _mixed_claim(state, seed):
    rng = np.random.default_rng(seed)
    v = max(state.col_vars.values())
    rho = [Ext4.from_ints([int(x) for x in rng.integers(0, P, size=4)]) for _ in range(v)]
    evals = {name: Ext4.from_ints([int(x) for x in rng.integers(0, P, size=4)]) for name in state.names}
    return mixed_claim_from_rho(state.col_vars, state.cn, rho, evals)


def test_ligero_commit_mixed_matches_jax():
    cols = _mixed_columns(1)
    host = ref.ligero_commit_mixed(F, cols, "sha3")
    port = ligero_commit_mixed(F, cols, "sha3", device="cpu")
    assert port.commit_path == "stream-dev" and host.commit_path == "host"
    assert port.root == host.root
    assert port.leaf_digests == host.leaf_digests
    assert port.levels == host.levels
    assert port.matrix.dtype == np.uint64 and np.array_equal(port.matrix, host.matrix)
    assert (port.cn, port.n, port.n_e, port.names, port.offsets, port.heights, port.col_vars) == (
        host.cn, host.n, host.n_e, host.names, host.offsets, host.heights, host.col_vars)

    claim = _mixed_claim(host, seed=2)
    th, tp = FiatShamirTranscript(), FiatShamirTranscript()
    ph = ref.ligero_prove_mixed(host, [claim], th)
    pp = ref.ligero_prove_mixed(port, [claim], tp)
    assert all(np.array_equal(a.c, b.c) for a, b in zip(ph.us, pp.us))
    assert np.array_equal(ph.columns, pp.columns) and ph.nodes == pp.nodes
    next_challenge = th.challenge_value(P)
    assert next_challenge == tp.challenge_value(P)

    # The port's own opening (its own Ext4 and transcript classes) on the
    # same claim: the same rows, columns, nodes and transcript state.
    own_claim = port_ligero.LigeroMixedClaim(
        b=PortExt4(claim.b.c), entries={k: (PortExt4(a.c), PortExt4(v.c)) for k, (a, v) in claim.entries.items()})
    to = PortTranscript()
    po = port_ligero.ligero_prove_mixed(port, [own_claim], to)
    assert all(np.array_equal(a.c, b.c) for a, b in zip(ph.us, po.us))
    assert np.array_equal(ph.columns, po.columns) and ph.nodes == po.nodes
    assert to.challenge_value(P) == next_challenge


def test_streamed_state_offers_no_device_column():
    """A name the commitment does not hold gets no device column; every
    committed column is offered as a slice of the resident matrix
    (``mat_dev``) that reproduces it, zero padding of short columns cut."""
    cols = _mixed_columns(3)
    port = ligero_commit_mixed(F, cols, "sha3", device="cpu")
    assert port.device_column("not-committed") is None
    assert port.encoded.mat_dev.dtype == torch.int32 and tuple(port.encoded.mat_dev.shape) == port.matrix.shape
    for name in port.names:
        ref_col = port.device_column(name)
        assert ref_col.mat is port.encoded.mat_dev and ref_col.length == len(cols[name])
        assert ref_col.resolve().tolist() == cols[name].tolist()
    # a commitment whose matrix is host numpy offers none
    rows = _words(np.stack([_canonical(1 << 6, seed=k) for k in range(2)]))
    assert ligero_dev.ligero_commit_device(F, ["a", "b"], rows).device_column("a") is None


def test_ligero_commit_mixed_reports_its_phases():
    state = ligero_commit_mixed(F, _mixed_columns(4), "sha3", device="cpu")
    assert set(state.commit_timings) == {"assemble_s", "upload_s", "stream_s", "levels_s"}


@pytest.mark.parametrize("v, B", [(10, 4), (8, 2), (6, 43)])
def test_ligero_commit_device_matches_jax(v, B):
    cols = {f"c{k:02d}": _canonical(1 << v, seed=10 * v + k) for k in range(B)}
    host = ref.ligero_commit(F, cols, "sha3")
    names = sorted(cols)
    rows = torch.from_numpy(np.stack([cols[n].astype(np.uint32) for n in names]).view(np.int32))
    port = ligero_dev.ligero_commit_device(F, names, rows)
    assert port.root == host.root
    assert port.leaf_digests == host.leaf_digests
    assert port.levels == host.levels
    assert (port.cn, port.m, port.n, port.n_e, port.names) == (host.cn, host.m, host.n, host.n_e, host.names)
    assert port.matrix.dtype == np.uint64 and np.array_equal(port.matrix, host.matrix)
    assert port.encoded.dtype == np.uint32 and np.array_equal(port.encoded, host.encoded)

    rs = [int(x) for x in np.random.default_rng(v).integers(1, P, size=v)]
    th, tp = FiatShamirTranscript(), FiatShamirTranscript()
    ph = ref.ligero_prove_eval(host, rs, th)
    pp = ref.ligero_prove_eval(port, rs, tp)
    assert np.array_equal(ph.columns, pp.columns) and ph.nodes == pp.nodes
    assert th.challenge_value(P) == tp.challenge_value(P)
    assert ref.ligero_column_evals(port, rs) == ref.ligero_column_evals(host, rs)
