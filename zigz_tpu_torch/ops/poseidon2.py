"""Poseidon2 over BabyBear on the device: leaf and node hashes of the
protocol-v3 Merkle forest and the column sponge of its Ligero commitments.
CUDA kernels P1 ``p2_leaves``, P2 ``p2_merge`` and P3 ``p2_absorb``
(csrc/poseidon2_kernels.cu over the permutation P0 of csrc/poseidon2.cuh)
and their plain PyTorch versions.

Counterpart of zigz_tpu/ops/poseidon2.py (jnp, jitted; no Pallas kernel)
and of the host column hash of zigz_tpu/commitments/ligero.py; the digests
are byte-identical to core/poseidon2.py and runtime/sha3.cpp
(tests/test_torch_poseidon2.py, tests/test_torch_poseidon2_kernels.py).

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises.  There is no fallback from one to the other.  On the card
each call is one launch over its whole width.  ``LAUNCHES`` counts kernel
launches and ``PERMUTATIONS`` calls of the plain permutation, so a run can
show which it went through: a prove on the card counts no plain
permutation.

The plain versions keep the state as ONE (16, N) int64 tensor, N hashes
side by side, and act on the whole tensor, so a permutation is about 320
launches whatever N:

* S-box x^7: four products, each reduced (a^2 < 2^62 fits int64);
* external linear layer: the 4x4 block M4 as one broadcast product and one
  sum over a (4, 4, 4, N) view, then the column sums;
* internal round: the S-box on lane 0, one sum over the lanes (< 2^35) and
  one broadcast product by the diagonal.

Inputs are canonical (< p < 2^31) and every product takes reduced operands.
The plain leaf and merge hashes run in chunks of ``CHUNK`` so that the
(4, 4, 4, N) transient of the external layer stays bounded; the kernels
keep a hash's 16 lanes in registers and need no chunks.

Digests are (8, N) canonical int32 limbs, limb-major as in the JAX package;
:func:`limbs_to_bytes` gives the 32-byte digests of core/poseidon2.py.  The
column sponge's carried state is (16, n) canonical int32 on every device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core import poseidon2 as host
from ..utils.profiling import counter_table
from . import _build
from .babybear import P
from .ntt_dev import encode_rows

__all__ = [
    "permute_device",
    "p2_leaves",
    "p2_merge",
    "p2_absorb",
    "p2_columns_stream",
    "limbs_to_bytes",
    "kernel_constants",
    "CHUNK",
    "LAUNCHES",
    "PERMUTATIONS",
]

T = host.T
RATE = host.RATE

# Hashes per permutation call of the plain leaf and merge hashes: a
# (16, CHUNK) int64 state is 256 MiB and the external layer's transient
# four times that.
CHUNK = 1 << 21

# Rows per encode + absorb step of the column sponge: a multiple of RATE, and
# the step of ops/ligero_dev.py, so that the openings re-encode the same blocks.
_STREAM_BLOCK_ROWS = 544

# Kernel launches since the last reset; the plain versions do not count.
LAUNCHES = counter_table("poseidon2", ["leaves", "merge", "absorb"])
# Calls of the plain permutation since the last reset (each over a whole
# (16, N) state).
PERMUTATIONS = counter_table("poseidon2_permutations", ["count"])


@functools.lru_cache(maxsize=1)
def kernel_constants() -> np.ndarray:
    """The kernels' constants: core/poseidon2.py's external round constants
    (8 x 16), internal ones (13) and diagonal (16), in that order, in
    Montgomery form (x 2^32 mod p), as 157 uint32: csrc/poseidon2.cuh
    ``Consts``, passed by value to every launch."""
    vals = np.array([*host._RC_EXTERNAL, *host._RC_INTERNAL, *host._MU], dtype=np.uint64)
    out = (vals * np.uint64((1 << 32) % P) % np.uint64(P)).astype(np.uint32)
    out.flags.writeable = False
    return out


# -- plain versions --------------------------------------------------------------


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


def _permute_plain(state: torch.Tensor) -> torch.Tensor:
    """Plain version of P0 over every column of ``state`` (16, N) canonical
    int64.  Returns a new tensor; the input is left as it was."""
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


def _p2_leaves_plain(values: torch.Tensor) -> torch.Tensor:
    """Plain version of P1: (N,) canonical int32/int64 -> (8, N) int32."""
    n = values.shape[0]
    out = torch.empty((8, n), dtype=torch.int32, device=values.device)
    for s0 in range(0, n, CHUNK):
        piece = values[s0 : s0 + CHUNK]
        state = torch.zeros((T, piece.shape[0]), dtype=torch.int64, device=values.device)
        state[0] = piece
        state[RATE] = 1  # the message length, in the capacity
        out[:, s0 : s0 + CHUNK] = _permute_plain(state)[:8]
    return out


def _p2_merge_plain(level: torch.Tensor) -> torch.Tensor:
    """Plain version of P2: (8, N) limbs -> (8, N / 2) int32."""
    n = level.shape[1]
    out = torch.empty((8, n // 2), dtype=torch.int32, device=level.device)
    for s0 in range(0, n // 2, CHUNK):
        piece = level[:, 2 * s0 : 2 * (s0 + CHUNK)]
        state = torch.zeros((T, piece.shape[1] // 2), dtype=torch.int64, device=level.device)
        state[:8] = piece[:, 0::2]
        state[RATE] = 16
        state = _permute_plain(state)
        state[:8].add_(piece[:, 1::2]).remainder_(P)
        out[:, s0 : s0 + CHUNK] = _permute_plain(state)[:8]
    return out


def _p2_absorb_plain(state: torch.Tensor, msg: torch.Tensor) -> torch.Tensor:
    """Plain version of P3: updates the (16, n) int32 state in place."""
    s = state.to(torch.int64)
    for off in range(0, max(msg.shape[0], 1), RATE):
        block = msg[off : off + RATE]
        s[: block.shape[0]].add_(block).remainder_(P)
        s = _permute_plain(s)
    return state.copy_(s)


# -- the wrappers ------------------------------------------------------------------


def _on_card(t: torch.Tensor, name: str) -> bool:
    """False for a CPU tensor (the plain version), True for a CUDA one (the
    kernel); any other device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return True


def _words(t: torch.Tensor, name: str) -> torch.Tensor:
    """``t`` as the contiguous int32 words a kernel reads."""
    t = t.to(torch.int32)
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    return t


def _launch(kernel: str, symbol: str, device: torch.device, *args) -> None:
    consts = kernel_constants()
    with torch.cuda.device(device):
        _build.launch(symbol, *args, consts.ctypes.data, torch.cuda.current_stream(device).cuda_stream)
    LAUNCHES[kernel] += 1


def _check_limbs(t: torch.Tensor, name: str) -> None:
    if t.dtype not in (torch.int32, torch.int64) or t.dim() != 2 or t.shape[0] != 8:
        raise ValueError(f"{name}: expected (8, N) int32/int64 limbs, got {t.dtype} {tuple(t.shape)}")


def permute_device(state: torch.Tensor) -> torch.Tensor:
    """The Poseidon2 permutation of every column of ``state`` (16, N)
    canonical int64.  Returns a new tensor; the input is left as it was.
    On the card it is P3 with no message rows (one bare permutation a
    column); no prove calls it there, the kernels inline the permutation."""
    if state.dtype != torch.int64 or state.dim() != 2 or state.shape[0] != T:
        raise ValueError(f"permute_device: expected a (16, N) int64 state, got {state.dtype} {tuple(state.shape)}")
    if not _on_card(state, "permute_device"):
        return _permute_plain(state)
    words = state.to(torch.int32).contiguous()
    return p2_absorb(words, words.new_empty((0, words.shape[1]))).to(torch.int64)


def p2_leaves(values: torch.Tensor) -> torch.Tensor:
    """Digest limbs (8, N) int32 of N one-element messages: ``values`` (N,)
    canonical int32 or int64 (core/poseidon2.py ``np_batch_leaf_hashes``)."""
    if values.dim() != 1 or values.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"p2_leaves: expected (N,) int32/int64 values, got {values.dtype} {tuple(values.shape)}")
    if not _on_card(values, "p2_leaves"):
        return _p2_leaves_plain(values)
    _build.load()  # build, or raise, before anything touches the card
    words = _words(values, "p2_leaves")
    n = words.shape[0]
    out = torch.empty((8, n), dtype=torch.int32, device=words.device)
    if n:
        _launch("leaves", "zigz_p2_leaves", words.device, words.data_ptr(), out.data_ptr(), n)
    return out


def p2_merge(level: torch.Tensor) -> torch.Tensor:
    """(8, N) digest limbs -> (8, N / 2) parent limbs, int32: children 2i and
    2i + 1 form one 16-limb message, two rate blocks (``np_batch_merge_hashes``)."""
    _check_limbs(level, "p2_merge")
    n = level.shape[1]
    if n % 2:
        raise ValueError(f"p2_merge: {n} digests do not pair")
    if not _on_card(level, "p2_merge"):
        return _p2_merge_plain(level)
    _build.load()  # build, or raise, before anything touches the card
    words = _words(level, "p2_merge")
    if words.data_ptr() % 8:
        raise ValueError("p2_merge: the level must be 8-byte aligned (P2 reads a child pair as one word)")
    out = torch.empty((8, n // 2), dtype=torch.int32, device=words.device)
    if n:
        _launch("merge", "zigz_p2_merge", words.device, words.data_ptr(), out.data_ptr(), n // 2)
    return out


def p2_absorb(state: torch.Tensor, msg: torch.Tensor) -> torch.Tensor:
    """Absorb ``msg`` (rows, n) canonical int32 into the carried column-sponge
    ``state`` (16, n) canonical int32, in place: RATE rows per permutation,
    a short last block adding to the first lanes only; with no rows the
    bare state is permuted once (the sponge of an empty message).  Returns
    ``state``."""
    n = state.shape[-1]
    if state.dtype != torch.int32 or tuple(state.shape) != (T, n) or not state.is_contiguous():
        raise ValueError(f"p2_absorb: expected a contiguous (16, n) int32 state, got {state.dtype} "
                         f"{tuple(state.shape)}")
    if msg.dtype != torch.int32 or msg.dim() != 2 or msg.shape[1] != n:
        raise ValueError(f"p2_absorb: expected a (rows, {n}) int32 message, got {msg.dtype} {tuple(msg.shape)}")
    if state.device != msg.device:
        raise ValueError(f"p2_absorb: state on {state.device}, message on {msg.device}")
    if not _on_card(state, "p2_absorb"):
        return _p2_absorb_plain(state, msg)
    _build.load()  # build, or raise, before anything touches the card
    words = _words(msg, "p2_absorb")
    if n:
        _launch("absorb", "zigz_p2_absorb", state.device, state.data_ptr(), words.data_ptr(), msg.shape[0], n)
    return state


def p2_columns_stream(mat: torch.Tensor, n_e: int) -> torch.Tensor:
    """Leaf digest limbs (8, n_e) int32 of the encoded matrix
    ``encode_rows(mat, n_e)`` without materializing it: each block of rows is
    encoded and absorbed (P3) into a (16, n_e) int32 state carried across
    blocks.  Equal to commitments/ligero.py ``_hash_columns(encoded,
    "poseidon2")``: the row count mod p in lane RATE, then RATE rows per
    permutation; no rows, one permutation."""
    rows = mat.shape[0]
    state = torch.zeros((T, n_e), dtype=torch.int32, device=mat.device)
    state[RATE] = rows % P
    if rows == 0:
        p2_absorb(state, state.new_empty((0, n_e)))
    for k0 in range(0, rows, _STREAM_BLOCK_ROWS):
        p2_absorb(state, encode_rows(mat[k0 : k0 + _STREAM_BLOCK_ROWS], n_e))
    return state[:8]


def limbs_to_bytes(digests: torch.Tensor) -> bytes:
    """(8, N) canonical limbs -> N * 32 bytes, 4-byte little-endian limbs
    (core/poseidon2.py ``hash_field_values``)."""
    _check_limbs(digests, "limbs_to_bytes")
    arr = digests.detach().to("cpu").numpy().astype(np.uint32)
    return np.ascontiguousarray(arr.T).astype("<u4").tobytes()
