"""Ligero-style multilinear polynomial commitment over BabyBear.

Closes the main soundness gap shared with the reference: the v1 scheme's
"opening" binds one Merkle leaf chosen by point[0] mod 2^v
(polynomial_commit.zig:178-183 — replicated for wire parity) and the round-1
v2 protocol carried terminal ``column_evals`` as bare claims.  This module
provides a REAL evaluation binding: tampering either the claimed evaluation
or the committed column data is rejected (tests/test_ligero.py).

Scheme (Ligero/Brakedown lineage, tensor-query flavor):

* The 2^v evaluations of each MLE are arranged row-major into an m x n
  matrix; B polynomials sharing one commitment stack into (B*m, n).
* Every row is Reed-Solomon encoded: row values are taken as coefficients
  and evaluated over the 2-adic subgroup of size n_e = INV_RATE * n
  (BabyBear has 2-adicity 27) via an iterative NTT.
* The commitment is a Merkle root over the n_e COLUMNS of the encoded
  matrix (leaf = hash of the column's B*m field values; SHA3 or Poseidon2
  per the proof version's hash mode).
* To open the batched evaluation sum_k gamma^k f_k(r): the MSB-first fold
  point r splits into row weights a (size m) and column weights b (size n)
  with f(r) = a^T M b (matching the zerocheck's fold ordering, r_1 = MSB).
  The prover sends u = a_hat^T M (a_hat = gamma-scaled a stacked over the B
  blocks); optionally (NUM_RHO > 0, off by default since round 5 — see
  LigeroParams) extra proximity rows w_i = rho_i^T M; then t random
  columns are opened and checked against ONE deduplicated Merkle
  multiproof: Enc(u)[j] == a_hat . col_j (and Enc(w_i)[j] == rho_i .
  col_j when present); finally <u, b> == sum_k gamma^k claimed_eval_k.
  Default code/query sizing: rate 1/8, t = 64 (see LigeroParams).

Soundness (the claim of record lives in PROVER.md "Soundness budget"):
analyzed in the proximity-gaps regime — correlated agreement of the
verifier-randomized power combination u (gamma^k across row blocks; the
BCIKS FOCS'20 parameterized-curves theorem), then each of the t uniform
columns catches a far matrix w.p. >= delta (t = 64 at rate 1/8).  The
claim row u carries the correlated-agreement role itself, so no separate
testing-phase row is needed (classic Ligero's testing phase exists
because its claim combination is not verifier-randomized).  All
algebraic draws come from BabyBear^4 (core/ext4.py, |K| ~ 2^124),
closing the round-2 verdict's base-field grinding hole (the
no-assumptions unique-decoding floor of the sizing is in PROVER.md).
Claims may carry base or extension row/column weights (``a``/``b``): the
evaluation claims at extension zerocheck points use Ext4 eq-tensors, the
hypercube-sum claims stay base all-ones vectors.  The combined query rows
``u``/``w`` are extension-valued (absorbed/serialized as 4 coordinate
rows).  The reference itself draws all challenges from the base field
(hash.zig:228-242) — this is where this system goes beyond it.

Counterpart of zigz_tpu/commitments/ligero.py.  The host layer (layout,
parameters, claims, openings, verification, the host encoder and hasher
that the verifier re-runs on the opened rows) is carried over;
``ligero_commit_mixed`` is the port's own: it takes an explicit
``device``, assembles the matrix on the host, uploads it as plain u32
words (or stitches it on the device from device-built columns and the
host-only rows, ``_assemble_mat_dev``), and encodes and column-hashes it
there with the streamed K5 commit (ops/ligero_dev.py) or, in Poseidon2
mode, the column sponge of ops/poseidon2.py, so only the 32-byte leaf
digests come back.  Root, digests and levels equal zigz_tpu's host path
(tests/test_torch_ligero.py).
``state.matrix`` stays host numpy, because ``ligero_prove_mixed`` runs its
query-row vecmat on the host; ``state.encoded`` is a ``StreamedEncoded``,
whose ``gather`` re-encodes on the device at open time and whose
``mat_dev`` feeds the zerochecks through ``device_column``.  The commit has
no host encode or host hash, no way back to them, no size gate and no
environment switch: ``commit_path`` is ``"stream-dev"``, or ``"mesh"`` for
a SHA3 commit sharded over a process group (``group=``,
ops/ligero_mesh.py).  Not carried over: the JAX branches and the
width-packed upload (``_pack_rows_host``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from ..core.hash import FiatShamirTranscript
from ..device import resolve_device, synchronize
from ..utils.profiling import counter_table
from .merkle import _hash_fns

__all__ = [
    "LigeroParams",
    "LigeroCommitState",
    "LigeroClaim",
    "LigeroMixedClaim",
    "LigeroEvalProof",
    "ntt_pow2",
    "ligero_commit",
    "ligero_commit_mixed",
    "ligero_prove_claims",
    "ligero_verify_claims",
    "ligero_prove_eval",
    "ligero_verify_eval",
    "ligero_prove_mixed",
    "ligero_verify_mixed",
    "mixed_layout",
]

P = 2013265921  # BabyBear
_GEN = 31  # primitive root of BabyBear (2^27 two-adicity)


def _root_of_unity(order: int, p: int = P) -> int:
    assert order & (order - 1) == 0 and order <= (1 << 27)
    w = pow(_GEN, (p - 1) // order, p)
    assert pow(w, order, p) == 1 and pow(w, order // 2, p) == p - 1
    return w


_BITREV_CACHE: Dict[int, np.ndarray] = {}


def _bit_reverse_indices(n: int) -> np.ndarray:
    cached = _BITREV_CACHE.get(n)
    if cached is not None:
        return cached
    bits = n.bit_length() - 1
    idx = np.arange(n, dtype=np.uint64)
    rev = np.zeros_like(idx)
    for b in range(bits):
        rev |= ((idx >> np.uint64(b)) & np.uint64(1)) << np.uint64(bits - 1 - b)
    out = rev.astype(np.int64)
    _BITREV_CACHE[n] = out
    return out


_TWIDDLE_CACHE: Dict[int, List[np.ndarray]] = {}


def _twiddles(n: int) -> List[np.ndarray]:
    """Per-stage twiddle tables for an iterative DIT NTT of size n."""
    if n in _TWIDDLE_CACHE:
        return _TWIDDLE_CACHE[n]
    w = _root_of_unity(n)
    stages = []
    length = 2
    while length <= n:
        wl = pow(w, n // length, P)
        tw = np.empty(length // 2, dtype=np.uint64)
        acc = 1
        for i in range(length // 2):
            tw[i] = acc
            acc = acc * wl % P
        stages.append(tw)
        length *= 2
    _TWIDDLE_CACHE[n] = stages
    return stages


_native_ntt_state = "untested"  # "untested" | "ok" | "unavailable"


def _native_ntt(rows: np.ndarray, n_out: int):
    """Dispatch to the threaded C++ row encoder (runtime/ntt.cpp), self-
    tested against the numpy path once per process; None on any miss."""
    global _native_ntt_state
    if _native_ntt_state == "unavailable" or n_out < 2:
        return None
    try:
        from ..runtime import native_ntt_rows
    except Exception:
        _native_ntt_state = "unavailable"
        return None
    tw = np.concatenate(_twiddles(n_out))
    br = _bit_reverse_indices(n_out)
    if _native_ntt_state == "untested":
        rng = np.random.default_rng(0)
        probe = rng.integers(0, P, size=(3, 8), dtype=np.uint64)
        got = native_ntt_rows(probe, 32, np.concatenate(_twiddles(32)),
                              _bit_reverse_indices(32))
        if got is None or not np.array_equal(got, _ntt_pow2_numpy(probe, 32)):
            _native_ntt_state = "unavailable"
            return None
        _native_ntt_state = "ok"
        if n_out == 32:
            tw = np.concatenate(_twiddles(n_out))
    flat = rows.reshape(-1, rows.shape[-1])
    out = native_ntt_rows(flat, n_out, tw, br)
    if out is None:
        _native_ntt_state = "unavailable"
        return None
    return out.reshape(rows.shape[:-1] + (n_out,))


def ntt_pow2(rows: np.ndarray, n_out: int) -> np.ndarray:
    """Evaluate each row's coefficient vector on the size-n_out subgroup.

    rows: (..., n) canonical uint64, n <= n_out (zero-padded).  Returns
    (..., n_out).  Exact u64 arithmetic: products < 2^62, sums < 2^63."""
    native = _native_ntt(np.asarray(rows, dtype=np.uint64), n_out)
    if native is not None:
        return native
    return _ntt_pow2_numpy(np.asarray(rows, dtype=np.uint64), n_out)


_native_ntt32_state = "untested"


def ntt_pow2_u32(rows: np.ndarray, n_out: int) -> np.ndarray:
    """ntt_pow2 with uint32 storage for the output (canonical values are
    < 2^31, so this is lossless) — the encoded matrix is the dominant
    memory term of every Ligero commitment and this halves it."""
    global _native_ntt_state, _native_ntt32_state
    if (_native_ntt_state != "unavailable"
            and _native_ntt32_state != "unavailable" and n_out >= 2):
        # Reuse _native_ntt's availability gate, then self-test the u32
        # entry point itself once (it has its own arithmetic path).
        if _native_ntt_state == "untested":
            _native_ntt(np.zeros((1, 2), dtype=np.uint64), 4)
        if _native_ntt_state == "ok":
            try:
                from ..runtime import native_ntt_rows32
            except Exception:
                native_ntt_rows32 = None
            if native_ntt_rows32 is not None and _native_ntt32_state == "untested":
                rng = np.random.default_rng(1)
                probe = rng.integers(0, P, size=(3, 16), dtype=np.uint64)
                got = native_ntt_rows32(probe, 64, np.concatenate(_twiddles(64)),
                                        _bit_reverse_indices(64))
                if got is None or not np.array_equal(
                    got, _ntt_pow2_numpy(probe, 64).astype(np.uint32)
                ):
                    _native_ntt32_state = "unavailable"
                    native_ntt_rows32 = None
                else:
                    _native_ntt32_state = "ok"
            if native_ntt_rows32 is not None:
                rows64 = np.asarray(rows, dtype=np.uint64)
                flat = rows64.reshape(-1, rows64.shape[-1])
                out = native_ntt_rows32(
                    flat, n_out, np.concatenate(_twiddles(n_out)),
                    _bit_reverse_indices(n_out),
                )
                if out is not None:
                    return out.reshape(rows64.shape[:-1] + (n_out,))
    return ntt_pow2(rows, n_out).astype(np.uint32)


def _ntt_pow2_numpy(rows: np.ndarray, n_out: int) -> np.ndarray:
    pad = n_out - rows.shape[-1]
    if pad:
        rows = np.concatenate(
            [rows, np.zeros(rows.shape[:-1] + (pad,), dtype=np.uint64)], axis=-1
        )
    x = rows[..., _bit_reverse_indices(n_out)].copy()
    p = np.uint64(P)
    for tw in _twiddles(n_out):
        half = len(tw)
        length = half * 2
        shape = x.shape[:-1] + (n_out // length, length)
        x = x.reshape(shape)
        lo = x[..., :half]
        hi = x[..., half:] * tw % p
        x = np.concatenate([(lo + hi) % p, (lo + p - hi) % p], axis=-1)
        x = x.reshape(shape[:-2] + (n_out,))
    return x


@dataclass
class LigeroParams:
    """Code/query parameters.  Sized for the stated proximity-gaps
    analysis (PROVER.md "Soundness budget"): at rate 1/4 each uniform
    query contributes -log2(1-delta) bits against a delta-far matrix.

    Round-5 sizing: rate 1/8 with t = 64 queries.  Per uniform query a
    delta-far matrix survives w.p. 1-delta with delta = 1-sqrt(rho)(1+
    1/(2m)) = 0.558 at m = 2 (Johnson regime): ~1.18 bits/query, so the
    64-query sampling term carries ~75 bits and the scheme stays
    correlated-agreement-limited (~66-68 proven bits, ~94 conjectured —
    PROVER.md "Soundness budget" is the claim of record).  Versus the
    round-4 rate-1/4/t=110 sizing this halves the opened-column bytes
    and the query count at a ~2x encode/hash cost per commit and ~2-5
    proven CA bits (the conjectured reading is unchanged); both
    readings remain within a few bits of their best for the rate.

    num_rho = 0 (round 5): the separate proximity row w is REDUNDANT
    under the claim-of-record analysis — the per-claim batched query row
    u is itself a random power-combination (gamma^k across row blocks)
    subject to the identical column-consistency checks, so the
    correlated-agreement step (BCIKS curves theorem) already applies to
    it; classic Ligero needed a distinct testing phase only because its
    claim combination was not verifier-randomized.  Dropping w removes a
    16n-byte extension row per commitment (~25-30% of v2 proof size) and
    one term from the CA union bound.  ``num_rho=1`` (both sides)
    restores the belt-and-braces row."""

    inv_rate: int = 8
    num_queries: int = 64
    num_rho: int = 0

    def choose_split(self, v: int, num_polys: int) -> int:
        """log2(n): balance column-opening bytes (t*B*m) vs row bytes
        ((1+num_rho)*n) for proof size."""
        if v <= 1:
            return v
        import math

        target = 0.5 * (v + math.log2(self.num_queries * num_polys / (1 + self.num_rho)))
        cn = max(1, min(v, round(target)))
        return cn


@dataclass
class DeviceColumnRef:
    """A committed column as a static slice of a device-resident matrix:
    ``mat[off : off + rows].reshape(-1)[:length]`` (canonical values as
    int32 words)."""

    mat: object  # torch tensor (total_rows, n)
    off: int
    rows: int
    length: int

    def resolve(self):
        """The flat column, a view of the resident matrix."""
        flat = self.mat[self.off : self.off + self.rows].reshape(-1)
        return flat[: self.length]


@dataclass
class LigeroCommitState:
    root: bytes
    names: List[str]
    num_vars: int
    cn: int  # log2(n)
    m: int
    n: int
    n_e: int
    matrix: np.ndarray  # (B*m, n) unencoded, uint64
    encoded: np.ndarray  # (B*m, n_e), uint32 storage (canonical < 2^31)
    leaf_digests: bytes
    levels: List[bytes]
    hash_mode: str
    # Mixed-length commitments (ligero_commit_mixed) only: per-column
    # variable counts and the derived row layout.  Uniform commitments
    # leave these None and use the single (num_vars, m) pair above.
    col_vars: Dict[str, int] = None
    offsets: Dict[str, int] = None  # first matrix row of each column
    heights: Dict[str, int] = None  # m_k rows per column

    def device_column(self, name: str, *, required: bool = False):
        """:class:`DeviceColumnRef` onto the resident device matrix for a
        committed column when this commitment keeps its matrix on the
        device (the streamed commit), else None.  Lets the device
        zerochecks read the resident matrix instead of uploading the
        column again.  ``required`` is for a caller that has no other
        source (the device advice twins): a column that is not resident is
        then an error."""
        mat_dev = getattr(self.encoded, "mat_dev", None)
        if mat_dev is None or self.offsets is None or name not in self.offsets:
            if required:
                raise RuntimeError(f"committed column {name} is not resident on the device")
            return None
        return DeviceColumnRef(
            mat=mat_dev,
            off=self.offsets[name],
            rows=self.heights[name],
            length=1 << self.col_vars[name],
        )


@dataclass
class LigeroClaim:
    """One linear query a^T M_k b with per-column claimed values.

    ``a`` (m,) row weights and ``b`` (n,) column weights are VERIFIER-
    computable (eq tensors for an MLE evaluation; all-ones for a hypercube
    sum); ``values`` maps column names to the claimed query results.  The
    claim batches across columns with a per-claim gamma challenge."""

    a: np.ndarray
    b: np.ndarray
    values: Dict[str, int]


@dataclass
class LigeroEvalProof:
    us: List[np.ndarray]  # one (n,) row per claim
    ws: List[np.ndarray]  # num_rho x (n,)
    columns: np.ndarray  # (t, B*m) opened encoded columns
    # Deduplicated Merkle MULTIPROOF for the t opened columns: the
    # sibling digests of the covered-subtree frontier in the
    # deterministic order of _multiproof_schedule (round 5 — shared path
    # prefixes across the t indices were ~40-50% redundant bytes).
    nodes: List[bytes]

    # Backward-compatible accessor for single-claim proofs.
    @property
    def u(self):
        return self.us[0]


def _hash_columns(encoded: np.ndarray, hash_mode: str) -> bytes:
    """Leaf digest per column of the encoded matrix."""
    rows, n_e = encoded.shape
    if hash_mode == "poseidon2":
        from ..core import poseidon2 as p2

        from ..runtime import native_p2_matrix_columns

        # threaded C++ sponge (runtime/sha3.cpp), byte-identical; None where
        # the runtime does not take this matrix, and an error is an error
        native = native_p2_matrix_columns(encoded)
        if native is not None:
            return native
        state = np.zeros((p2.T, n_e), dtype=np.uint64)
        state[p2.RATE] = rows % P  # length domain separation, as in the sponge
        for off in range(0, max(rows, 1), p2.RATE):
            block = encoded[off : off + p2.RATE]
            state[: block.shape[0]] = (state[: block.shape[0]] + block) % np.uint64(P)
            state = p2.np_permute(state)
        return state[:8].T.astype("<u4").tobytes()
    if hash_mode != "sha3":
        raise ValueError(f"unknown hash mode {hash_mode!r}")
    import hashlib

    # Narrow leaf preimage: canonical values (< 2^31) absorbed as 4-byte
    # LE words — half the Keccak blocks of a u64 encoding.  Prover and
    # verifier both route through this function, so the encoding is the
    # single source of truth for the v2+ Ligero leaf format.
    try:
        from ..runtime import native_sha3_matrix_columns_u32le

        native = native_sha3_matrix_columns_u32le(encoded)
        if native is not None:
            return native
    except Exception:
        pass
    cols = np.ascontiguousarray(encoded.T, dtype="<u4")  # (n_e, rows)
    out = bytearray(n_e * 32)
    sha3 = hashlib.sha3_256
    for j in range(n_e):
        out[j * 32 : (j + 1) * 32] = sha3(cols[j].tobytes()).digest()
    return bytes(out)


def _build_levels(leaf_digests: bytes, hash_mode: str) -> List[bytes]:
    _, merge_fn, _ = _hash_fns(hash_mode)
    levels = [leaf_digests]
    cur = leaf_digests
    while len(cur) > 32:
        cur = merge_fn(cur)
        levels.append(cur)
    return levels


def ligero_commit(F, columns: Dict[str, np.ndarray], hash_mode: str = "sha3",
                  params: LigeroParams = None) -> LigeroCommitState:
    """Commit B equal-length MLEs (name -> (2^v,) canonical uint64) under
    ONE column-Merkle root."""
    assert F.MODULUS == P, "Ligero PCS is BabyBear-only (needs 2-adic NTT)"
    params = params or LigeroParams()
    names = sorted(columns)
    num_vars = len(next(iter(columns.values()))).bit_length() - 1
    cn = params.choose_split(num_vars, len(names))
    n = 1 << cn
    m = (1 << num_vars) // n
    mat = np.concatenate(
        [np.asarray(columns[name], dtype=np.uint64).reshape(m, n) for name in names]
    )
    encoded = ntt_pow2_u32(mat, params.inv_rate * n)
    leaf_digests = _hash_columns(encoded, hash_mode)
    levels = _build_levels(leaf_digests, hash_mode)
    return LigeroCommitState(
        root=levels[-1],
        names=names,
        num_vars=num_vars,
        cn=cn,
        m=m,
        n=n,
        n_e=params.inv_rate * n,
        matrix=mat,
        encoded=encoded,
        leaf_digests=leaf_digests,
        levels=levels,
        hash_mode=hash_mode,
    )


def _row_col_weights(rs: List, cn: int):
    """(a, b): eq weights for the row (MSB) and column (LSB) index bits,
    matching the zerocheck's MSB-first fold (r_1 binds the top bit).
    Extension points (lists of Ext4) produce Ext4 weight vectors."""
    from ..core.ext4 import Ext4
    from ..proofs.zerocheck import _eq_table, _eq_table_ext

    v = len(rs)
    if v and isinstance(rs[0], Ext4):
        return _eq_table_ext(rs[: v - cn], P), _eq_table_ext(rs[v - cn:], P)
    a = _eq_table(rs[: v - cn], P)  # (m,)
    b = _eq_table(rs[v - cn :], P)  # (n,)
    return a, b


def _multiproof_schedule(indices: List[int], height: int) -> List[tuple]:
    """Deterministic (level, sibling_position) list both sides derive
    from the (transcript-fixed) query indices: per level, walk the known
    positions in sorted order and record every sibling NOT itself known.
    Shared ancestors are computed, never shipped."""
    need = []
    cur = sorted(set(indices))
    for level in range(height):
        known = set(cur)
        for pos in cur:
            if pos ^ 1 not in known:
                need.append((level, pos ^ 1))
        cur = sorted({pos >> 1 for pos in cur})
    return need


def _multiproof_nodes(state: LigeroCommitState, indices: List[int]) -> List[bytes]:
    height = state.n_e.bit_length() - 1
    return [
        state.levels[level][pos * 32 : pos * 32 + 32]
        for level, pos in _multiproof_schedule(indices, height)
    ]


def _multiproof_verify(indices: List[int], leaf_blob: bytes,
                       nodes: List[bytes], root: bytes, height: int,
                       hasher) -> bool:
    """Reconstruct the root from the opened columns' leaf digests plus
    the frontier ``nodes`` (consumed in _multiproof_schedule order).
    Duplicate indices must carry identical leaf digests."""
    known: Dict[int, bytes] = {}
    for t_i, idx in enumerate(indices):
        d = leaf_blob[t_i * 32 : (t_i + 1) * 32]
        if known.setdefault(idx, d) != d:
            return False  # same column opened twice with different data
    it = iter(nodes)
    try:
        for _level in range(height):
            positions = sorted(known)
            nxt: Dict[int, bytes] = {}
            for pos in positions:
                parent = pos >> 1
                if parent in nxt:
                    continue
                sib = pos ^ 1
                sib_digest = known.get(sib)
                if sib_digest is None:
                    sib_digest = next(it)
                    if len(sib_digest) != 32:
                        return False
                if pos % 2 == 0:
                    nxt[parent] = hasher.hash_internal(known[pos], sib_digest)
                else:
                    nxt[parent] = hasher.hash_internal(sib_digest, known[pos])
            known = nxt
    except StopIteration:
        return False
    if next(it, None) is not None:
        return False  # trailing unconsumed nodes
    return len(known) == 1 and known.get(0) == root


def _pow_range(base: int, count: int) -> np.ndarray:
    """[base^1, base^2, ..., base^count] mod P, vectorized (log2(count)
    masked multiplies)."""
    ks = np.arange(1, count + 1, dtype=np.uint64)
    out = np.ones(count, dtype=np.uint64)
    sq = np.uint64(base % P)
    bit = np.uint64(1)
    for _ in range(int(count).bit_length() + 1):
        mask = (ks & bit) != 0
        out[mask] = out[mask] * sq % np.uint64(P)
        sq = sq * sq % np.uint64(P)
        bit <<= np.uint64(1)
    return out


def _vecmat(a: np.ndarray, matrix: np.ndarray) -> np.ndarray:
    """out[j] = sum_i a[i]*M[i, j] mod P (native 128-bit accumulate when
    available; exact numpy fallback — row count < 2^33 keeps the uint64
    sum of sub-2^31 products from wrapping).  A matrix that lies on the
    device (an ops/ligero_dev.py ``ligero_commit_device`` state) reduces there."""
    if isinstance(matrix, torch.Tensor):
        from ..ops.ligero_dev import vecmat_device

        return vecmat_device(a, matrix)
    try:
        from ..runtime import native_mod_vecmat

        out = native_mod_vecmat(a, matrix, P)
        if out is not None:
            return out
    except Exception:
        pass
    p = np.uint64(P)
    return (a[:, None] * matrix % p).sum(axis=0, dtype=np.uint64) % p


def _gamma_a_hat(gamma, a, B: int, m: int):
    """gamma-scaled stacked row weights: block k carries gamma^k * a.
    ``a`` may be a base (m,) array or an Ext4 (m,) array; gamma is Ext4."""
    from ..core.ext4 import Ext4, ext_concat

    blocks = []
    gpow = Ext4.from_ints([1, 0, 0, 0])
    for _ in range(B):
        blk = gpow * a
        blocks.append(blk if isinstance(blk, Ext4) else Ext4.lift(blk))
        gpow = gpow * gamma
    return ext_concat(blocks)  # Ext4 (B*m,)


def _vecmat_ext(a_ext, matrix):
    """Extension row-vector times base matrix: one fused 4-coordinate
    native pass when available (runtime zigz_ext4_vecmat — reads the
    matrix once and skips zero-weight rows), else one base vecmat per
    coordinate (the matrix is base-field, so coordinates never mix)."""
    from ..core.ext4 import Ext4

    if isinstance(matrix, np.ndarray):
        try:
            from ..runtime import native_ext4_vecmat

            out = native_ext4_vecmat(
                np.ascontiguousarray(a_ext.c, dtype=np.uint64),
                np.ascontiguousarray(matrix, dtype=np.uint64),
            )
            if out is not None:
                return Ext4(out)
        except Exception:
            pass
    rows = [_vecmat(a_ext.c[e], matrix) for e in range(4)]
    return Ext4(np.stack(rows))


def ligero_prove_claims(state: LigeroCommitState, claims: List[LigeroClaim],
                        transcript: FiatShamirTranscript,
                        params: LigeroParams = None) -> LigeroEvalProof:
    """Multi-claim linear-query argument on one commitment.

    Transcript schedule (replayed by the verifier):
      per claim: gamma := ext challenge; absorb the 4 coordinate rows of
                 u = a_hat^T M;                      [batched query row]
      per rep:   rho := ext challenge, row = rho^1..rho^(B*m); absorb the
                 4 coordinate rows of w;  [proximity rows, ext-batched]
      query indices := challenges(t) mod n_e.        [column spot checks]
    """
    from ..core.ext4 import challenge_ext, ext_pow_range

    params = params or LigeroParams()
    B = len(state.names)

    us = []
    for claim in claims:
        gamma = challenge_ext(transcript)
        a_hat = _gamma_a_hat(gamma, claim.a, B, state.m)
        u = _vecmat_ext(a_hat, state.matrix)
        transcript.append_u64s(u.c)
        us.append(u)

    ws = []
    for _ in range(params.num_rho):
        rho = ext_pow_range(challenge_ext(transcript), B * state.m)
        w = _vecmat_ext(rho, state.matrix)
        transcript.append_u64s(w.c)
        ws.append(w)

    indices = [transcript.challenge_index(state.n_e) for _ in range(params.num_queries)]
    if isinstance(state.encoded, np.ndarray):
        columns = state.encoded[:, indices].T.astype(np.uint64)  # (t, B*m)
    else:
        # Device-resident encoded matrix: gather the t opened columns on
        # the device, download only them (t * B*m values).
        idx = torch.as_tensor(indices, dtype=torch.int64, device=state.encoded.device)
        columns = state.encoded.index_select(1, idx).cpu().numpy().T.astype(np.uint64)
    nodes = _multiproof_nodes(state, indices)
    return LigeroEvalProof(us=us, ws=ws, columns=columns, nodes=nodes)


def ligero_verify_claims(F, root: bytes, num_vars: int, names: List[str],
                         claims: List[LigeroClaim], proof: LigeroEvalProof,
                         transcript: FiatShamirTranscript,
                         hash_mode: str = "sha3",
                         params: LigeroParams = None) -> bool:
    """Replay the multi-claim schedule; check per-claim consistency at the
    opened columns, the Merkle paths, and each <u, b> binding."""
    from ..core.ext4 import Ext4, challenge_ext, ext_lift, ext_pow_range

    params = params or LigeroParams()
    p = np.uint64(P)
    B = len(names)
    cn = params.choose_split(num_vars, B)
    n = 1 << cn
    m = (1 << num_vars) // n
    n_e = params.inv_rate * n
    height = n_e.bit_length() - 1

    if len(proof.us) != len(claims):
        return False
    if any(not (isinstance(u, Ext4) and u.shape == (n,)) for u in proof.us):
        return False
    if len(proof.ws) != params.num_rho:
        return False
    if any(not (isinstance(w, Ext4) and w.shape == (n,)) for w in proof.ws):
        return False
    if proof.columns.shape != (params.num_queries, B * m):
        return False

    a_hats = []
    bindings_ok = True
    for claim, u in zip(claims, proof.us):
        if claim.a.shape != (m,) or claim.b.shape != (n,):
            return False
        gamma = challenge_ext(transcript)
        a_hat = _gamma_a_hat(gamma, claim.a, B, m)
        a_hats.append(a_hat)
        transcript.append_u64s(u.c)
        combined = ext_lift(0)
        gpow = Ext4.from_ints([1, 0, 0, 0])
        for name in names:
            val = claim.values.get(name)
            if val is None:
                # Untrusted claim missing a committed column: reject rather
                # than raise (advisor finding, round 3).
                return False
            combined = combined + gpow * val
            gpow = gpow * gamma
        if (u * claim.b).sum() != combined:
            bindings_ok = False

    rhos = []
    for w in proof.ws:
        rho = ext_pow_range(challenge_ext(transcript), B * m)
        transcript.append_u64s(w.c)
        rhos.append(rho)

    indices = [transcript.challenge_index(n_e) for _ in range(params.num_queries)]

    cols = proof.columns.astype(np.uint64) % p
    idx_arr = np.asarray(indices)
    # Re-encode ALL query/proximity rows in one batched NTT call (4
    # coordinate rows per extension row): one threaded C++ sweep instead
    # of 4*(claims+num_rho) small ones — the dominant verify cost.
    all_rows = proof.us + proof.ws
    enc_all = ntt_pow2_u32(
        np.concatenate([u.c for u in all_rows], axis=0), n_e
    ).astype(np.uint64)
    for k, (a_hat, u) in enumerate(zip(a_hats + rhos, all_rows)):
        # Each opened column must satisfy Enc(u)[j] == a_hat . col_j.
        u_enc = Ext4(enc_all[4 * k : 4 * k + 4])
        col_dot = Ext4(np.stack([
            (a_hat.c[e][None, :] * cols % p).sum(axis=1, dtype=np.uint64) % p
            for e in range(4)
        ]))
        if not np.array_equal(col_dot.c, u_enc.c[:, idx_arr]):
            return False

    leaf_blob = _hash_columns(cols.T, hash_mode)
    _, merge_fn, hasher = _hash_fns(hash_mode)
    if not _multiproof_verify(indices, leaf_blob, proof.nodes, root, height,
                              hasher):
        return False

    return bindings_ok


def ligero_column_evals(state: LigeroCommitState, rs: List) -> Dict[str, object]:
    """Per-column MLE evaluations at the fold point rs, computed from the
    committed (unencoded) matrix: eval_k = a^T M_k b with the eq-tensor
    row/column weights.  These are the claimed values a v4 verifier feeds
    to :func:`ligero_verify_eval`.  Extension points yield Ext4 values
    (one base vecmat per coordinate; the committed matrix stays base)."""
    from ..core.ext4 import Ext4

    p = np.uint64(P)
    a, b = _row_col_weights(rs, state.cn)
    if isinstance(a, Ext4):
        if isinstance(state.matrix, torch.Tensor):
            # Device-resident matrix: 16 base-coordinate passes
            # a_e^T M b_f recombined as X^(e+f) basis products.
            from ..core.ext4 import _BASIS, ext_lift
            from ..ops.ligero_dev import column_evals_device

            evals = {name: ext_lift(0) for name in state.names}
            for e in range(4):
                for f in range(4):
                    part = column_evals_device(state, a.c[e], b.c[f])
                    basis = _BASIS[e] * _BASIS[f]
                    for name, val in part.items():
                        evals[name] = evals[name] + basis * val
            return evals
        evals = {}
        for k, name in enumerate(state.names):
            block = state.matrix[k * state.m : (k + 1) * state.m]
            u = _vecmat_ext(a, block)
            evals[name] = (u * b).sum()
        return evals
    if isinstance(state.matrix, torch.Tensor):
        from ..ops.ligero_dev import column_evals_device

        return column_evals_device(state, a, b)
    b = b % p
    evals = {}
    for k, name in enumerate(state.names):
        block = state.matrix[k * state.m : (k + 1) * state.m]
        u = _vecmat(a, block).astype(np.uint64) % p
        # u, b < 2^31 so u*b fits uint64; reduce before the n-term sum.
        evals[name] = int((u * b % p).sum(dtype=np.uint64) % p)
    return evals


def ligero_prove_eval(state: LigeroCommitState, rs: List[int],
                      transcript: FiatShamirTranscript,
                      params: LigeroParams = None) -> LigeroEvalProof:
    """Single-claim wrapper: batched MLE evaluation at the fold point rs."""
    a, b = _row_col_weights(rs, state.cn)
    claim = LigeroClaim(a=a, b=b, values={})
    return ligero_prove_claims(state, [claim], transcript, params)


def ligero_verify_eval(F, root: bytes, num_vars: int, names: List[str],
                       claimed_evals: Dict[str, int], rs: List[int],
                       proof: LigeroEvalProof, transcript: FiatShamirTranscript,
                       hash_mode: str = "sha3",
                       params: LigeroParams = None) -> bool:
    """Single-claim wrapper over ligero_verify_claims."""
    params = params or LigeroParams()
    cn = params.choose_split(num_vars, len(names))
    a, b = _row_col_weights(rs, cn)
    claim = LigeroClaim(a=a, b=b, values=claimed_evals)
    return ligero_verify_claims(
        F, root, num_vars, names, [claim], proof, transcript, hash_mode, params
    )


# ===========================================================================
# Mixed-length commitments (protocol v2+ unified PCS, round 3)
#
# One Merkle root over columns of DIFFERENT hypercube sizes: column k with
# 2^{v_k} evaluations occupies m_k = max(1, 2^{v_k}/n) consecutive matrix
# rows (zero-padded to one n-wide row when 2^{v_k} < n).  This is what lets
# the whole v2 argument pipeline share ONE data commitment and ONE advice
# commitment instead of ~20 per-argument ones — the per-opening costs
# (t opened columns, Merkle paths, proximity rows) are paid once.
#
# A LigeroMixedClaim is a single linear query over the whole matrix:
# shared column weights ``b`` (n,) and per-column row weights ``a_k``
# (m_k,), gamma-batched across columns exactly like the uniform scheme.
# The batch-evaluation sumcheck (proofs/batch_eval.py) reduces every
# argument's per-point/per-sum claims to one such query.
# ===========================================================================


def choose_split_mixed(total_data: int, num_claims: int,
                       params: LigeroParams) -> int:
    """log2(n) minimizing proof bytes: t opened columns cost
    ~t * (D/n) * 4 bytes, the extension query/proximity rows cost
    ~(num_claims + num_rho) * 16 * n bytes."""
    import math

    if total_data <= 2:
        return 1
    rows = 16 * max(1, num_claims + params.num_rho)
    target = 0.5 * math.log2(params.num_queries * 4 * total_data / rows)
    return max(1, min(int(total_data).bit_length(), round(target)))


def mixed_layout(col_vars: Dict[str, int], cn: int):
    """(names, offsets, heights, total_rows) — the deterministic row
    layout both sides derive from the public per-column sizes."""
    names = sorted(col_vars)
    offsets: Dict[str, int] = {}
    heights: Dict[str, int] = {}
    off = 0
    n = 1 << cn
    for name in names:
        m_k = max(1, (1 << col_vars[name]) // n)
        offsets[name] = off
        heights[name] = m_k
        off += m_k
    return names, offsets, heights, off


# Columns placed into a commit matrix from device tensors, and matrix rows
# uploaded from the host, by ligero_commit_mixed(dev_columns=...) since the
# last reset.
STITCHED = counter_table("ligero_stitched", ["dev_columns", "host_rows"])


def _assemble_mat_dev(mat: np.ndarray, dev_columns: Dict[str, torch.Tensor], names, offsets,
                      heights, col_vars, dev: torch.device) -> torch.Tensor:
    """The (total_rows, n) canonical int32 device matrix, stitched from
    device-built columns plus an upload of the rows that only the host has.
    Equal to the upload of the host-assembled ``mat`` (same row layout, zero
    padding for short columns).  A device column of another length than its
    host twin, or one that is not a column of this commitment, is an error."""
    total_rows, n = mat.shape
    unknown = sorted(set(dev_columns) - set(names))
    if unknown:
        raise ValueError(f"device columns {unknown} are not columns of this commitment")
    out = torch.zeros((total_rows, n), dtype=torch.int32, device=dev)
    host_runs = []  # [first, past-the-last) of consecutive rows that only the host has
    for name in names:
        off, m_k = offsets[name], heights[name]
        col = dev_columns.get(name)
        if col is None:
            if host_runs and host_runs[-1][1] == off:
                host_runs[-1][1] = off + m_k
            else:
                host_runs.append([off, off + m_k])
            continue
        length = 1 << col_vars[name]
        if col.numel() != length or col.device != dev:
            raise ValueError(f"device column {name}: {col.numel()} values on {col.device}, "
                             f"expected {length} on {dev}")
        if length >= n:
            out[off : off + m_k] = col.reshape(m_k, n)
        else:
            out[off, :length] = col.reshape(-1)
    for first, past in host_runs:
        out[first:past] = torch.from_numpy(mat[first:past].astype(np.uint32).view(np.int32)).to(dev)
        STITCHED["host_rows"] += past - first
    STITCHED["dev_columns"] += len(dev_columns)
    return out


def ligero_commit_mixed(F, columns: Dict[str, np.ndarray], hash_mode: str = "sha3", *,
                        device, dev_columns: Dict[str, torch.Tensor] = None,
                        group=None) -> LigeroCommitState:
    """Commit power-of-two-length MLEs of heterogeneous sizes (name ->
    canonical values) under one column-Merkle root, on ``device``, with
    the default ``LigeroParams`` and one claim as the layout hint (what
    the v2 prover and verifier use).

    ``dev_columns`` (name -> flat canonical tensor on ``device``) are twins of
    some of ``columns`` that already lie on the device (ops/advice_dev.py):
    they are placed into the device matrix as they are and only the other
    rows are uploaded.  The host ``matrix`` is assembled all the same: the
    openings and the batch evaluation read it.

    ``hash_mode`` ``"sha3"`` column-hashes with the K5 stream,
    ``"poseidon2"`` with the column sponge of ops/poseidon2.py over the same
    encode stream.

    ``state.commit_timings`` holds ``assemble_s`` (the host matrix),
    ``upload_s`` (its u32 words host to device, or the stitch and the upload
    of the host-only rows), ``stream_s`` (encode + absorb) and ``levels_s``
    (host Merkle levels), each read after a synchronize.

    With a ``group`` (parallel/multihost.py ``TraceGroup``) a SHA3 commit for
    which ``mesh_commit_ok`` holds runs sharded over the group's devices
    (ops/ligero_mesh.py: rows cut by rank, one all_to_all per block, the
    column sponge over each rank's columns), with the same root;
    ``commit_path`` is then ``"mesh"`` and ``state.encoded`` a
    ``MeshEncoded``.  A Poseidon2 commit, or one below that size, runs whole
    on every rank (``"stream-dev"``).  Device columns cannot be placed into
    a sharded matrix: ``dev_columns`` with a group is an error."""
    from ..ops.ligero_dev import StreamedEncoded

    if F.MODULUS != P:
        raise ValueError(f"the port's field is BabyBear (p = {P}), not {F.MODULUS}")
    if hash_mode not in ("sha3", "poseidon2"):
        raise ValueError(f"unknown hash mode {hash_mode!r}")
    dev = resolve_device(device)
    if group is not None and group.device != dev:
        raise ValueError(f"group on {group.device}, commit on {dev}")
    if group is not None and dev_columns:
        raise ValueError("device columns cannot be placed into a commit under a group")
    params = LigeroParams()
    t0 = time.perf_counter()
    col_vars = {}
    total = 0
    for name, arr in columns.items():
        ln = len(arr)
        if ln < 1 or ln & (ln - 1):
            raise ValueError(f"column {name} has {ln} values, not a power of two")
        col_vars[name] = ln.bit_length() - 1
        total += ln
    cn = choose_split_mixed(total, 1, params)
    n = 1 << cn
    n_e = params.inv_rate * n
    names, offsets, heights, total_rows = mixed_layout(col_vars, cn)
    mat = np.zeros((total_rows, n), dtype=np.uint64)
    for name in names:
        arr = np.asarray(columns[name], dtype=np.uint64)
        off, m_k = offsets[name], heights[name]
        if len(arr) >= n:
            mat[off : off + m_k] = arr.reshape(m_k, n)
        else:
            mat[off, : len(arr)] = arr
    t1 = time.perf_counter()
    sharded = False
    if group is not None and hash_mode == "sha3":
        from ..ops.ligero_mesh import MeshEncoded, commit_columns_mesh, mesh_commit_ok

        sharded = mesh_commit_ok(group, n_e, total_rows)
    if sharded:
        rows = None
    elif dev_columns:
        rows = _assemble_mat_dev(mat, dev_columns, names, offsets, heights, col_vars, dev)
    else:
        rows = torch.from_numpy(mat.astype(np.uint32).view(np.int32)).to(dev)
    synchronize(dev)
    t2 = time.perf_counter()
    # The copy of the digests to the host waits for the card.
    if sharded:
        # upload_s is zero here: each rank uploads its rows inside stream_s
        leaf_digests, mat_loc = commit_columns_mesh(group, mat.astype(np.uint32), n_e)
        encoded = MeshEncoded(group, mat_loc, n_e, total_rows)
    elif hash_mode == "poseidon2":
        from ..ops.poseidon2 import limbs_to_bytes, p2_columns_stream

        leaf_digests = limbs_to_bytes(p2_columns_stream(rows, n_e))
    else:
        from ..ops.keccak import digests_to_bytes
        from ..ops.ligero_dev import sha3_columns_stream

        leaf_digests = digests_to_bytes(sha3_columns_stream(rows, n_e))
    t3 = time.perf_counter()
    levels = _build_levels(leaf_digests, hash_mode)
    t4 = time.perf_counter()
    state = LigeroCommitState(
        root=levels[-1],
        names=names,
        num_vars=max(col_vars.values()),
        cn=cn,
        m=0,  # heterogeneous; use ``heights``
        n=n,
        n_e=n_e,
        matrix=mat,
        encoded=encoded if sharded else StreamedEncoded(rows, n_e),
        leaf_digests=leaf_digests,
        levels=levels,
        hash_mode=hash_mode,
        col_vars=col_vars,
        offsets=offsets,
        heights=heights,
    )
    state.commit_path = "mesh" if sharded else "stream-dev"
    state.commit_timings = dict(assemble_s=t1 - t0, upload_s=t2 - t1, stream_s=t3 - t2, levels_s=t4 - t3)
    return state


@dataclass
class LigeroMixedClaim:
    """One linear query over a mixed commitment: claims
    sum_j a_k[j] * M_k[j, :] . b == value_k for every named entry.

    ``b`` (n,) is shared; each entry carries its own (m_k,) row weights
    and claimed value.  Weights/values may be base or Ext4 — the batched
    query row u is always extension-valued."""

    b: object  # (n,) np.ndarray or Ext4
    entries: Dict[str, tuple]  # name -> (a_k, value)


def _gamma_a_hat_mixed(gamma, claim: LigeroMixedClaim,
                       names: List[str], offsets: Dict[str, int],
                       heights: Dict[str, int], total_rows: int):
    """Stacked gamma-scaled row weights over the mixed layout: column k
    (position k in names) contributes gamma^k * a_k on its row block,
    zero elsewhere."""
    from ..core.ext4 import Ext4

    out = np.zeros((4, total_rows), dtype=np.uint64)
    a_hat = Ext4(out, _trusted=True)
    gpow = Ext4.from_ints([1, 0, 0, 0])
    for name in names:
        ent = claim.entries.get(name)
        if ent is not None:
            a_k = ent[0]
            blk = gpow * a_k
            if not isinstance(blk, Ext4):
                blk = Ext4.lift(blk)
            off, m_k = offsets[name], heights[name]
            out[:, off : off + m_k] = blk.c
        gpow = gpow * gamma
    return a_hat


def _combined_value_mixed(gamma, claim: LigeroMixedClaim, names: List[str]):
    from ..core.ext4 import Ext4, ext_lift

    combined = ext_lift(0)
    gpow = Ext4.from_ints([1, 0, 0, 0])
    for name in names:
        ent = claim.entries.get(name)
        if ent is not None:
            combined = combined + gpow * ent[1]
        gpow = gpow * gamma
    return combined


def ligero_prove_mixed(state: LigeroCommitState, claims: List[LigeroMixedClaim],
                       transcript: FiatShamirTranscript,
                       params: LigeroParams = None) -> LigeroEvalProof:
    """Multi-claim linear-query argument on one mixed commitment.  Same
    transcript schedule as ligero_prove_claims (per-claim gamma + u row,
    per-rep rho + w row, t column indices)."""
    from ..core.ext4 import challenge_ext, ext_pow_range

    params = params or LigeroParams()
    total_rows = state.matrix.shape[0]

    us = []
    for claim in claims:
        gamma = challenge_ext(transcript)
        a_hat = _gamma_a_hat_mixed(
            gamma, claim, state.names, state.offsets, state.heights, total_rows
        )
        u = _vecmat_ext(a_hat, state.matrix)
        transcript.append_u64s(u.c)
        us.append(u)

    ws = []
    for _ in range(params.num_rho):
        rho = ext_pow_range(challenge_ext(transcript), total_rows)
        w = _vecmat_ext(rho, state.matrix)
        transcript.append_u64s(w.c)
        ws.append(w)

    indices = [transcript.challenge_index(state.n_e)
               for _ in range(params.num_queries)]
    if isinstance(state.encoded, np.ndarray):
        columns = state.encoded[:, indices].T.astype(np.uint64)  # (t, total_rows)
    else:
        # Streamed device commitment: re-encode on the device, gather only
        # the opened columns (ops/ligero_dev.py StreamedEncoded).
        columns = state.encoded.gather(indices)
    nodes = _multiproof_nodes(state, indices)
    return LigeroEvalProof(us=us, ws=ws, columns=columns, nodes=nodes)


def ligero_verify_mixed(F, root: bytes, col_vars: Dict[str, int],
                        claims: List[LigeroMixedClaim], proof: LigeroEvalProof,
                        transcript: FiatShamirTranscript,
                        hash_mode: str = "sha3",
                        params: LigeroParams = None,
                        num_claims_hint: int = 1) -> bool:
    """Replay the mixed-claim schedule: per-claim <u, b> binding, per-row
    code-consistency at the opened columns, Merkle paths."""
    from ..core.ext4 import Ext4, challenge_ext, ext_pow_range

    params = params or LigeroParams()
    p = np.uint64(P)
    total = sum(1 << v for v in col_vars.values())
    cn = choose_split_mixed(total, num_claims_hint, params)
    n = 1 << cn
    n_e = params.inv_rate * n
    height = n_e.bit_length() - 1
    names, offsets, heights, total_rows = mixed_layout(col_vars, cn)

    if len(proof.us) != len(claims):
        return False
    if any(not (isinstance(u, Ext4) and u.shape == (n,)) for u in proof.us):
        return False
    if len(proof.ws) != params.num_rho:
        return False
    if any(not (isinstance(w, Ext4) and w.shape == (n,)) for w in proof.ws):
        return False
    if proof.columns.shape != (params.num_queries, total_rows):
        return False

    a_hats = []
    bindings_ok = True
    for claim, u in zip(claims, proof.us):
        b = claim.b
        if (b.shape if isinstance(b, Ext4) else np.shape(b)) != (n,):
            return False
        for name, (a_k, _val) in claim.entries.items():
            if name not in heights:
                return False
            shp = a_k.shape if isinstance(a_k, Ext4) else np.shape(a_k)
            if shp != (heights[name],):
                return False
        gamma = challenge_ext(transcript)
        a_hats.append(_gamma_a_hat_mixed(gamma, claim, names, offsets,
                                         heights, total_rows))
        transcript.append_u64s(u.c)
        if (u * claim.b).sum() != _combined_value_mixed(gamma, claim, names):
            bindings_ok = False

    rhos = []
    for w in proof.ws:
        rho = ext_pow_range(challenge_ext(transcript), total_rows)
        transcript.append_u64s(w.c)
        rhos.append(rho)

    indices = [transcript.challenge_index(n_e)
               for _ in range(params.num_queries)]

    cols = proof.columns.astype(np.uint64) % p
    idx_arr = np.asarray(indices)
    # One batched NTT over every query/proximity coordinate row (see
    # ligero_verify_claims).
    all_rows = proof.us + proof.ws
    enc_all = ntt_pow2_u32(
        np.concatenate([u.c for u in all_rows], axis=0), n_e
    ).astype(np.uint64)
    for k, (a_hat, u) in enumerate(zip(a_hats + rhos, all_rows)):
        u_enc = Ext4(enc_all[4 * k : 4 * k + 4])
        col_dot = Ext4(np.stack([
            (a_hat.c[e][None, :] * cols % p).sum(axis=1, dtype=np.uint64) % p
            for e in range(4)
        ]))
        if not np.array_equal(col_dot.c, u_enc.c[:, idx_arr]):
            return False

    leaf_blob = _hash_columns(cols.T, hash_mode)
    _, merge_fn, hasher = _hash_fns(hash_mode)
    if not _multiproof_verify(indices, leaf_blob, proof.nodes, root, height,
                              hasher):
        return False

    return bindings_ok
