"""Ligero commitments on the device: column sponges K4/K5, the streamed
commit, the opened-column gather, ``ligero_commit_device`` and the query-row
products of a commitment whose matrix lies on the device.

Counterpart of zigz_tpu/ops/ligero_dev.py.  A Ligero leaf is the SHA3-256 of
one column of the Reed-Solomon-encoded matrix, its canonical values taken
as 4-byte little-endian words (zigz_tpu/commitments/ligero.py
``_hash_columns(encoded, "sha3")``).  Digests are (n, 4) int64 tensors, one
row per column, in the layout of ops/keccak.py.

Kernels (csrc/ligero_kernels.cu), each with its plain PyTorch version here:

* K4 :func:`sha3_columns`: (r, n) canonical words -> (n, 4) digests, one
  sponge per column from the zero state;
* K5 :func:`sha3_absorb`: absorbs whole rate blocks of the padded column
  stream into a carried (25, n) state, in place.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises.  There is no fallback from one to the other, and no host
hash.  ``LAUNCHES`` counts kernel launches.

The streamed commit (:func:`sha3_columns_stream`) keeps the JAX package's
structure: the input rows are encoded in blocks of ``_STREAM_BLOCK_WORDS``
rows (ops/ntt_dev.py ``encode_rows``: kernels N1 and N2 on the card, whose
int32 output K5 reads as it lies) and each block is absorbed as it is
encoded, so the (rows, n_e) encoded matrix never exists whole and the
transient stays flat in the row count.  The openings re-encode the same blocks and keep only the opened
columns (:class:`StreamedEncoded`).  The TPU kernel's ``n % 1024`` column
padding is a tile constraint and is not carried over.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from ..commitments.ligero import LigeroCommitState, LigeroParams, _build_levels
from ..utils.profiling import counter_table

from . import _build
from .babybear import P
from .keccak import _keccak_f1600, digests_to_bytes
from .mle import sum_mod
from .ntt_dev import encode_rows

__all__ = [
    "sha3_columns",
    "sha3_absorb",
    "sha3_columns_stream",
    "gather_encoded_columns",
    "StreamedEncoded",
    "ligero_commit_device",
    "vecmat_device",
    "column_evals_device",
    "LAUNCHES",
]

# Kernel launches since the last reset; the plain versions do not count.
LAUNCHES = counter_table("ligero", ["columns", "absorb"])

RATE_WORDS = 34  # 136-byte Keccak rate as u32 words
_STREAM_BLOCK_WORDS = RATE_WORDS * 16  # 544 rows per encode + absorb step
_PAD_START = 0x06
_PAD_END = 0x80 << 24
_MASK32 = 0xFFFFFFFF


def pad_words(r: int) -> int:
    """Padded word count of an r-word column: full blocks plus the pad block."""
    return ((r * 4) // 136 + 1) * RATE_WORDS


def _absorb_plain(lanes: List[torch.Tensor], msg: torch.Tensor, k0: int, nb: int, r: int):
    """Plain version of the kernels' shared loop: absorb nb rate blocks from
    stream word k0, message rows k0.. being ``msg`` (live, n)."""
    pw = pad_words(r)
    live = msg.shape[0]
    zero = torch.zeros_like(lanes[0])

    def word(w: int) -> torch.Tensor:
        v = msg[w - k0].to(torch.int64) & _MASK32 if w - k0 < live else zero
        pad = (_PAD_START if w == r else 0) | (_PAD_END if w == pw - 1 else 0)
        return v | pad if pad else v

    for b in range(nb):
        w0 = k0 + b * RATE_WORDS
        for k in range(17):
            lanes[k] = lanes[k] ^ (word(w0 + 2 * k) | (word(w0 + 2 * k + 1) << 32))
        lanes = _keccak_f1600(lanes)
    return lanes


def _sha3_columns_plain(mat: torch.Tensor) -> torch.Tensor:
    """Plain version of K4: (r, n) int32 -> (n, 4) int64 digests."""
    r, n = mat.shape
    lanes = [torch.zeros(n, dtype=torch.int64, device=mat.device)] * 25
    lanes = _absorb_plain(lanes, mat, 0, pad_words(r) // RATE_WORDS, r)
    return torch.stack(lanes[:4], dim=1)


def _sha3_absorb_plain(state: torch.Tensor, msg: torch.Tensor, k0: int, nb: int, r: int) -> torch.Tensor:
    """Plain version of K5: updates the (25, n) int64 state in place."""
    lanes = _absorb_plain(list(state.clone().unbind(0)), msg, k0, nb, r)
    state.copy_(torch.stack(lanes))
    return state


def _check_words(t: torch.Tensor, name: str) -> None:
    if t.dtype != torch.int32 or t.dim() != 2:
        raise ValueError(f"{name}: expected a (rows, n) int32 tensor, got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")


def _launch(counter: str, symbol: str, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        _build.launch(symbol, *args, torch.cuda.current_stream(device).cuda_stream)
    LAUNCHES[counter] += 1


def sha3_columns(mat: torch.Tensor) -> torch.Tensor:
    """SHA3-256 of every column of ``mat`` (r, n) int32, its r words taken
    little-endian.  Returns (n, 4) int64 digests."""
    _check_words(mat, "sha3_columns")
    if mat.device.type == "cpu":
        return _sha3_columns_plain(mat)
    _build.load()  # build, or raise, before anything touches the card
    r, n = mat.shape
    out = torch.empty((n, 4), dtype=torch.int64, device=mat.device)
    if n:
        _launch("columns", "zigz_sha3_columns", mat.device, mat.data_ptr(), out.data_ptr(), n, r)
    return out


def sha3_absorb(state: torch.Tensor, msg: torch.Tensor, k0: int, nb: int, r: int) -> torch.Tensor:
    """Absorb rate blocks k0 / 34 .. k0 / 34 + nb of every column's padded
    stream (r message words) into ``state`` (25, n) int64, in place.

    ``msg`` (live, n) int32 holds message rows k0 .. k0 + live; words past
    them are zero or pad.  Returns ``state``."""
    _check_words(msg, "sha3_absorb")
    n = msg.shape[1]
    if state.dtype != torch.int64 or tuple(state.shape) != (25, n) or not state.is_contiguous():
        raise ValueError(f"sha3_absorb: expected a contiguous (25, {n}) int64 state, "
                         f"got {state.dtype} {tuple(state.shape)}")
    if state.device != msg.device:
        raise ValueError(f"sha3_absorb: state on {state.device}, message on {msg.device}")
    if k0 < 0 or k0 % RATE_WORDS or nb < 0 or k0 + nb * RATE_WORDS > pad_words(r):
        raise ValueError(f"sha3_absorb: blocks [{k0}, {k0 + nb * RATE_WORDS}) do not fit the "
                         f"{pad_words(r)} padded words of r={r}")
    if k0 + msg.shape[0] > r:
        raise ValueError(f"sha3_absorb: {msg.shape[0]} rows from word {k0} pass r={r}")
    if msg.device.type == "cpu":
        return _sha3_absorb_plain(state, msg, k0, nb, r)
    _build.load()
    if n and nb:
        _launch("absorb", "zigz_sha3_absorb", msg.device, state.data_ptr(), msg.data_ptr(),
                n, k0, msg.shape[0], nb, r)
    return state


def _stream_blocks(rows: int):
    """(k0, live rows, rate blocks) of every encode + absorb step."""
    pw = pad_words(rows)
    for k0 in range(0, pw, _STREAM_BLOCK_WORDS):
        end = min(k0 + _STREAM_BLOCK_WORDS, pw)
        yield k0, max(0, min(end, rows) - k0), (end - k0) // RATE_WORDS


def sha3_columns_stream(mat: torch.Tensor, n_e: int) -> torch.Tensor:
    """Leaf digests (n_e, 4) of the encoded matrix ``encode_rows(mat, n_e)``
    without materializing it: equal to ``sha3_columns(encode_rows(mat, n_e))``
    and to zigz_tpu's ``_hash_columns(ntt_pow2_u32(mat, n_e), "sha3")``."""
    rows = mat.shape[0]
    state = torch.zeros((25, n_e), dtype=torch.int64, device=mat.device)
    for k0, live, nb in _stream_blocks(rows):
        sha3_absorb(state, encode_rows(mat[k0 : k0 + live], n_e), k0, nb, rows)
    return state[:4].t().contiguous()


def gather_encoded_columns(mat: torch.Tensor, n_e: int, indices: Sequence[int]) -> np.ndarray:
    """(t, rows) uint64 opened columns of the encoded matrix: re-encode
    ``mat`` in stream blocks and keep only ``indices``."""
    idx = torch.as_tensor(np.asarray(indices, dtype=np.int64), device=mat.device)
    parts = [
        encode_rows(mat[k0 : k0 + _STREAM_BLOCK_WORDS], n_e).index_select(1, idx)
        for k0 in range(0, mat.shape[0], _STREAM_BLOCK_WORDS)
    ]
    return torch.cat(parts).cpu().numpy().T.astype(np.uint64)


class StreamedEncoded:
    """``LigeroCommitState.encoded`` of a streamed commit: holds the INPUT
    matrix on the device as ``mat_dev`` ((rows, n) canonical int32 words);
    opened columns re-encode on demand, and
    ``LigeroCommitState.device_column`` hands slices of it to the device
    zerochecks."""

    def __init__(self, mat_dev: torch.Tensor, n_e: int):
        self.mat_dev = mat_dev
        self.n_e = n_e

    def gather(self, indices) -> np.ndarray:
        return gather_encoded_columns(self.mat_dev, self.n_e, indices)


def ligero_commit_device(F, names, rows: torch.Tensor) -> LigeroCommitState:
    """Ligero commitment of B equal-length MLEs that lie on the device.

    ``rows`` is a (B, 2^v) canonical int32 tensor whose rows are the MLEs in
    ``sorted(names)`` order.  Root, leaf digests and levels equal zigz_tpu's
    ``ligero_commit`` of the same columns.  The matrix and the encoded
    matrix stay on the device as int32 tensors: ``ligero_prove_eval`` and
    ``ligero_column_evals`` branch on the type and reach
    :func:`vecmat_device` and :func:`column_evals_device`.  The default
    ``LigeroParams``; SHA3 only."""
    if F.MODULUS != P:
        raise ValueError(f"the port's field is BabyBear (p = {P}), not {F.MODULUS}")
    if rows.dim() != 2 or rows.dtype != torch.int32:
        raise ValueError(f"expected a (B, 2^v) int32 tensor, got {rows.dtype} {tuple(rows.shape)}")
    params = LigeroParams()
    num_polys, size = rows.shape
    if size < 1 or size & (size - 1) or len(names) != num_polys:
        raise ValueError(f"{num_polys} rows of {size} values for {len(names)} names")
    num_vars = size.bit_length() - 1
    cn = params.choose_split(num_vars, num_polys)
    n = 1 << cn
    m = size // n
    n_e = params.inv_rate * n
    mat = rows.reshape(num_polys * m, n).contiguous()
    encoded = encode_rows(mat, n_e)
    leaf_digests = digests_to_bytes(sha3_columns(encoded))
    levels = _build_levels(leaf_digests, "sha3")
    return LigeroCommitState(
        root=levels[-1],
        names=list(names),
        num_vars=num_vars,
        cn=cn,
        m=m,
        n=n,
        n_e=n_e,
        matrix=mat,
        encoded=encoded,
        leaf_digests=leaf_digests,
        levels=levels,
        hash_mode="sha3",
    )


def _weights(a: np.ndarray, device) -> torch.Tensor:
    """Host base-field weights -> canonical int64 on ``device``."""
    reduced = np.asarray(a, dtype=np.uint64) % np.uint64(P)
    return torch.from_numpy(reduced.astype(np.int64)).to(device)


def vecmat_device(a: np.ndarray, matrix: torch.Tensor) -> np.ndarray:
    """out[j] = sum_i a[i] * M[i, j] mod p for a device-resident canonical
    matrix; ``a`` is host-side, the result host uint64.  Each product of two
    values below p fits int64 and is reduced before the column sum."""
    prods = (matrix.to(torch.int64) * _weights(a, matrix.device)[:, None]).remainder_(P)
    return sum_mod(prods, dim=0).cpu().numpy().astype(np.uint64)


def column_evals_device(state: LigeroCommitState, a: np.ndarray, b: np.ndarray) -> Dict[str, int]:
    """Per-column MLE evaluations a^T M_k b for all blocks of a device commit
    state in one batched pass."""
    B = len(state.names)
    mat = state.matrix.to(torch.int64).view(B, state.m, state.n)
    u = sum_mod((mat * _weights(a, mat.device)[None, :, None]).remainder_(P), dim=1)  # (B, n)
    vals = sum_mod((u * _weights(b, mat.device)[None, :]).remainder_(P), dim=-1)  # (B,)
    host = vals.cpu().numpy()
    return {name: int(host[k]) for k, name in enumerate(state.names)}
