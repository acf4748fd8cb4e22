"""Poseidon2 over BabyBear on the device: leaf and node hashes of the
protocol-v3 Merkle forest and the column sponge of its Ligero commitments.

Counterpart of zigz_tpu/ops/poseidon2.py.  The JAX package computes
Poseidon2 in jnp (no Pallas kernel), so the port uses torch ops on canonical
int64; core/poseidon2.py and runtime/sha3.cpp are the host twins, and the
digests are byte-identical to them (tests/test_torch_poseidon2.py).

The state is ONE (16, N) tensor, N hashes side by side, and every layer acts
on the whole tensor, so a permutation is about 320 launches whatever N:

* S-box x^7: four products, each reduced (a^2 < 2^62 fits int64);
* external linear layer: the 4x4 block M4 as one broadcast product and one
  sum over a (4, 4, 4, N) view, then the column sums;
* internal round: the S-box on lane 0, one sum over the lanes (< 2^35) and
  one broadcast product by the diagonal.

Inputs are canonical (< p < 2^31) and every product takes reduced operands.
Hashes run in chunks of ``CHUNK`` so that the (4, 4, 4, N) transient of the
external layer stays bounded: one state of the 2^20-step forest's leaf level
would be 16 x 43 x 2^20 int64 values.

Digests are (8, N) canonical int32 limbs, limb-major as in the JAX package;
:func:`limbs_to_bytes` gives the 32-byte digests of core/poseidon2.py.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core import poseidon2 as host
from .babybear import P
from .ntt_dev import encode_rows

__all__ = [
    "permute_device",
    "p2_leaves",
    "p2_merge",
    "p2_absorb",
    "p2_columns_stream",
    "limbs_to_bytes",
    "CHUNK",
    "PERMUTATIONS",
]

T = host.T
RATE = host.RATE

# Hashes per permutation call of the forest: a (16, CHUNK) int64 state is
# 256 MiB and the external layer's transient four times that.
CHUNK = 1 << 21

# Rows per encode + absorb step of the column sponge: a multiple of RATE, and
# the step of ops/ligero_dev.py, so that the openings re-encode the same blocks.
_STREAM_BLOCK_ROWS = 544

# Permutation calls since the last reset (each over a whole (16, N) state).
PERMUTATIONS = {"count": 0}


@functools.lru_cache(maxsize=4)
def _consts(device: torch.device):
    """(M4 as (1, 4, 4, 1), external constants (8, 16, 1), internal constants,
    the diagonal (16, 1)) on ``device``."""
    m4 = torch.tensor(host._M4, dtype=torch.int64, device=device).view(1, 4, 4, 1)
    rc_ext = torch.tensor(host._RC_EXTERNAL, dtype=torch.int64, device=device).view(host.ROUNDS_F, T, 1)
    mu = torch.tensor(host._MU, dtype=torch.int64, device=device).view(T, 1)
    return m4, rc_ext, [int(c) for c in host._RC_INTERNAL], mu


def _sbox_(x: torch.Tensor) -> torch.Tensor:
    """x^7 of a canonical tensor, in place."""
    x2 = (x * x).remainder_(P)
    x4 = (x2 * x2).remainder_(P)
    x4.mul_(x2).remainder_(P)
    return x.mul_(x4).remainder_(P)


def _external_linear(s: torch.Tensor, m4: torch.Tensor) -> torch.Tensor:
    """M4 within each block of four lanes, then the column sums of all blocks
    added (core/poseidon2.py ``_external_linear``).  Canonical in, canonical out."""
    n = s.shape[1]
    # (block, 1, lane j, n) * (1, row i, lane j, 1), summed over j: < 16 p.
    mixed = (s.reshape(4, 1, 4, n) * m4).sum(dim=2)
    col = mixed.sum(dim=0, keepdim=True)  # < 64 p
    return mixed.add_(col).remainder_(P).view(T, n)


def permute_device(state: torch.Tensor) -> torch.Tensor:
    """The Poseidon2 permutation of every column of ``state`` (16, N)
    canonical int64.  Returns a new tensor; the input is left as it was."""
    if state.dtype != torch.int64 or state.dim() != 2 or state.shape[0] != T:
        raise ValueError(f"permute_device: expected a (16, N) int64 state, got {state.dtype} {tuple(state.shape)}")
    m4, rc_ext, rc_int, mu = _consts(state.device)
    PERMUTATIONS["count"] += 1
    half = host.ROUNDS_F // 2
    s = _external_linear(state, m4)
    for r in range(half):
        s = _external_linear(_sbox_(s.add_(rc_ext[r]).remainder_(P)), m4)
    for r in range(host.ROUNDS_P):
        s[0] = _sbox_((s[0] + rc_int[r]).remainder_(P))
        total = s.sum(dim=0, keepdim=True)  # < 16 p
        s = s.mul_(mu).add_(total).remainder_(P)
    for r in range(half, host.ROUNDS_F):
        s = _external_linear(_sbox_(s.add_(rc_ext[r]).remainder_(P)), m4)
    return s


def _check_limbs(t: torch.Tensor, name: str) -> None:
    if t.dtype not in (torch.int32, torch.int64) or t.dim() != 2 or t.shape[0] != 8:
        raise ValueError(f"{name}: expected (8, N) int32/int64 limbs, got {t.dtype} {tuple(t.shape)}")


def p2_leaves(values: torch.Tensor) -> torch.Tensor:
    """Digest limbs (8, N) int32 of N one-element messages: ``values`` (N,)
    canonical int32 or int64 (core/poseidon2.py ``np_batch_leaf_hashes``)."""
    if values.dim() != 1 or values.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"p2_leaves: expected (N,) int32/int64 values, got {values.dtype} {tuple(values.shape)}")
    n = values.shape[0]
    out = torch.empty((8, n), dtype=torch.int32, device=values.device)
    for s0 in range(0, n, CHUNK):
        piece = values[s0 : s0 + CHUNK]
        state = torch.zeros((T, piece.shape[0]), dtype=torch.int64, device=values.device)
        state[0] = piece
        state[RATE] = 1  # the message length, in the capacity
        out[:, s0 : s0 + CHUNK] = permute_device(state)[:8]
    return out


def p2_merge(level: torch.Tensor) -> torch.Tensor:
    """(8, N) digest limbs -> (8, N / 2) parent limbs, int32: children 2i and
    2i + 1 form one 16-limb message, two rate blocks (``np_batch_merge_hashes``)."""
    _check_limbs(level, "p2_merge")
    n = level.shape[1]
    if n % 2:
        raise ValueError(f"p2_merge: {n} digests do not pair")
    out = torch.empty((8, n // 2), dtype=torch.int32, device=level.device)
    for s0 in range(0, n // 2, CHUNK):
        piece = level[:, 2 * s0 : 2 * (s0 + CHUNK)]
        state = torch.zeros((T, piece.shape[1] // 2), dtype=torch.int64, device=level.device)
        state[:8] = piece[:, 0::2]
        state[RATE] = 16
        state = permute_device(state)
        state[:8].add_(piece[:, 1::2]).remainder_(P)
        out[:, s0 : s0 + CHUNK] = permute_device(state)[:8]
    return out


def p2_absorb(state: torch.Tensor, msg: torch.Tensor) -> torch.Tensor:
    """Absorb ``msg`` (rows, n) canonical int32 into the carried column-sponge
    ``state`` (16, n) int64, RATE rows per permutation; a short last block
    adds to the first rows only.  Returns the new state."""
    for off in range(0, msg.shape[0], RATE):
        block = msg[off : off + RATE]
        state[: block.shape[0]].add_(block).remainder_(P)
        state = permute_device(state)
    return state


def p2_columns_stream(mat: torch.Tensor, n_e: int) -> torch.Tensor:
    """Leaf digest limbs (8, n_e) int32 of the encoded matrix
    ``encode_rows(mat, n_e)`` without materializing it: each block of rows is
    encoded and absorbed into a (16, n_e) state carried across blocks.  Equal
    to commitments/ligero.py ``_hash_columns(encoded, "poseidon2")``: the row
    count mod p in lane RATE, then RATE rows per permutation."""
    rows = mat.shape[0]
    state = torch.zeros((T, n_e), dtype=torch.int64, device=mat.device)
    state[RATE] = rows % P
    if rows == 0:
        state = permute_device(state)
    for k0 in range(0, rows, _STREAM_BLOCK_ROWS):
        state = p2_absorb(state, encode_rows(mat[k0 : k0 + _STREAM_BLOCK_ROWS], n_e))
    return state[:8].to(torch.int32)


def limbs_to_bytes(digests: torch.Tensor) -> bytes:
    """(8, N) canonical limbs -> N * 32 bytes, 4-byte little-endian limbs
    (core/poseidon2.py ``hash_field_values``)."""
    _check_limbs(digests, "limbs_to_bytes")
    arr = digests.detach().to("cpu").numpy().astype(np.uint32)
    return np.ascontiguousarray(arr.T).astype("<u4").tobytes()
