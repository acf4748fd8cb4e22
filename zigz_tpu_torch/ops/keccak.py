"""SHA3-256 of Merkle leaves and nodes: CUDA kernels K1/K2 and their plain
PyTorch versions.

Counterpart of zigz_tpu/ops/keccak.py and zigz_tpu/ops/keccak_pallas.py.
Digests are (n, 4) int64 tensors, one row per hash, holding the four
little-endian 64-bit lanes of the digest; on a little-endian host
``.view(torch.uint8)`` of a row is the hashlib digest.  int64 stands in for
uint64 (the bits are the same): torch on the CPU has no shifts or ``~`` on
uint64.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel (csrc/sha3_kernels.cu) or raises.  There is no fallback from one to
the other.  ``LAUNCHES`` counts kernel launches, so a run can show that it
went through the kernels.

The JAX package's SUPER_CHUNK / _bucket / _run_chunked exist to bound the
number of Mosaic compiles; the port launches once per call, whatever n.
"""

from __future__ import annotations

import sys

import torch

from ..utils.profiling import counter_table
from . import _build

__all__ = [
    "sha3_leaves",
    "sha3_merge",
    "digests_to_bytes",
    "LAUNCHES",
]

# Kernel launches since the last reset; the plain versions do not count.
LAUNCHES = counter_table("keccak", ["leaves", "merge"])

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
_PILN = [10, 7, 11, 17, 18, 3, 5, 16, 8, 21, 24, 4, 15, 23, 19, 13, 12, 2, 20, 14, 22, 9, 6, 1]
_ROTC = [1, 3, 6, 10, 15, 21, 28, 36, 45, 55, 2, 14, 27, 41, 56, 8, 25, 43, 62, 18, 39, 61, 20, 44]


def _as_i64(u: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    return u - (1 << 64) if u >= (1 << 63) else u


_RC_I64 = [_as_i64(rc) for rc in _RC]
_PAD_LAST = _as_i64(0x80 << 56)  # 0x80 in byte 135 = top byte of lane 16


def _rotl(x: torch.Tensor, s: int) -> torch.Tensor:
    # int64 >> is arithmetic: mask the low s bits to make it logical.
    return (x << s) | ((x >> (64 - s)) & ((1 << s) - 1))


def _keccak_f1600(lanes):
    """24-round Keccak-f[1600] on a list of 25 int64 lane tensors."""
    for rnd in range(24):
        bc = [lanes[i] ^ lanes[i + 5] ^ lanes[i + 10] ^ lanes[i + 15] ^ lanes[i + 20] for i in range(5)]
        for i in range(5):
            t = bc[(i + 4) % 5] ^ _rotl(bc[(i + 1) % 5], 1)
            for j in range(0, 25, 5):
                lanes[j + i] = lanes[j + i] ^ t
        t = lanes[1]
        for i in range(24):
            j = _PILN[i]
            tmp = lanes[j]
            lanes[j] = _rotl(t, _ROTC[i])
            t = tmp
        for j in range(0, 25, 5):
            row = lanes[j : j + 5]
            for i in range(5):
                lanes[j + i] = row[i] ^ (~row[(i + 1) % 5] & row[(i + 2) % 5])
        lanes[0] = lanes[0] ^ _RC_I64[rnd]
    return lanes


def _sponge_plain(message_lanes, pad_lane: int) -> torch.Tensor:
    """One-block SHA3-256 of messages given as ``len(message_lanes)`` int64
    lane tensors of shape (n,); 0x06 goes into ``pad_lane``."""
    ref = message_lanes[0]
    zero = torch.zeros_like(ref)
    lanes = [zero] * 25
    lanes[: len(message_lanes)] = list(message_lanes)
    lanes[pad_lane] = torch.full_like(ref, 0x06)
    lanes[16] = torch.full_like(ref, _PAD_LAST)
    out = _keccak_f1600(lanes)
    return torch.stack(out[:4], dim=1)


def _sha3_leaves_plain(values: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: (n,) int64 -> (n, 4) int64 digests."""
    return _sponge_plain([values], pad_lane=1)


def _sha3_merge_plain(pairs: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: (n, 8) int64 messages -> (n, 4) int64 digests."""
    return _sponge_plain([pairs[:, k] for k in range(8)], pad_lane=8)


def _check(t: torch.Tensor, name: str, width) -> None:
    if t.dtype != torch.int64:
        raise TypeError(f"{name}: expected int64, got {t.dtype}")
    want_dim = 1 if width is None else 2
    if t.dim() != want_dim or (width is not None and t.shape[1] != width):
        shape = "(n,)" if width is None else f"(n, {width})"
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")


def _launch(kernel: str, symbol: str, src: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.empty((n, 4), dtype=torch.int64, device=src.device)
    if n:
        with torch.cuda.device(src.device):
            stream = torch.cuda.current_stream(src.device).cuda_stream
            _build.launch(symbol, src.data_ptr(), out.data_ptr(), n, stream)
        LAUNCHES[kernel] += 1
    return out


def sha3_leaves(values: torch.Tensor) -> torch.Tensor:
    """SHA3-256 of each value's 8-byte little-endian encoding.

    values: (n,) int64 holding u64 bits.  Returns (n, 4) int64 digests."""
    _check(values, "sha3_leaves", None)
    if values.device.type == "cpu":
        return _sha3_leaves_plain(values)
    return _launch("leaves", "zigz_sha3_leaves", values, values.shape[0])


def sha3_merge(pairs: torch.Tensor) -> torch.Tensor:
    """SHA3-256 of each 64-byte row (left digest || right digest).

    pairs: (n, 8) int64.  Returns (n, 4) int64 digests."""
    _check(pairs, "sha3_merge", 8)
    if pairs.device.type == "cpu":
        return _sha3_merge_plain(pairs)
    return _launch("merge", "zigz_sha3_merge", pairs, pairs.shape[0])


def digests_to_bytes(digests: torch.Tensor) -> bytes:
    """(n, 4) int64 digests -> n * 32 bytes in hashlib's layout."""
    if sys.byteorder != "little":
        raise RuntimeError("digest lanes are little-endian; this host is not")
    return digests.detach().to("cpu").contiguous().view(torch.uint8).numpy().tobytes()
