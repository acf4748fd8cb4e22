"""SHA3-256 (FIPS 202) in plain PyTorch int64 operations, batched.

A state is a list of 25 int64 tensors, lane (x, y) at index x + 5 y, each
lane's 64 bits held as an int64's two's-complement bits. Only the two
message shapes a Merkle tree over field elements needs are here: one 8-byte
little-endian value (a leaf) and two 32-byte digests (a node).
`tests/test_pb_reference.py` holds both to `hashlib.sha3_256`.
"""

from __future__ import annotations

from typing import List

import torch

_RC = (
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
)
# Rotation offsets r[x + 5 y].
_ROT = (0, 1, 62, 28, 27, 36, 44, 6, 55, 20, 3, 10, 43, 25, 39, 41, 45, 15, 21, 8, 18, 2, 61, 56, 14)


def _i64(u: int) -> int:
    return u - (1 << 64) if u >> 63 else u


RC = tuple(_i64(c) for c in _RC)
ROT = _ROT
PAD_FIRST = 0x06  # SHA3 domain bits and the first pad bit
PAD_LAST = _i64(0x80 << 56)  # the last pad bit, top byte of lane 16 (rate 136 bytes)


def _rotl(x: torch.Tensor, n: int) -> torch.Tensor:
    if n == 0:
        return x
    return (x << n) | ((x >> (64 - n)) & ((1 << n) - 1))


def keccak_f(a: List[torch.Tensor]) -> List[torch.Tensor]:
    """Keccak-f[1600] on a state of 25 lanes."""
    for rc in RC:
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        b = [None] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(a[x + 5 * y] ^ d[x], ROT[x + 5 * y])
        a = [b[i] ^ (~b[(i + 1) % 5 + 5 * (i // 5)] & b[(i + 2) % 5 + 5 * (i // 5)]) for i in range(25)]
        a[0] = a[0] ^ rc
    return a


def _absorb(lanes: List[torch.Tensor], pad_lane: int) -> torch.Tensor:
    """SHA3-256 of the message in the first lanes (whole lanes), as (N, 4)
    int64 digest lanes."""
    ref = lanes[0]
    zero = torch.zeros_like(ref)
    state = list(lanes) + [zero] * (25 - len(lanes))
    state[pad_lane] = state[pad_lane] ^ PAD_FIRST
    state[16] = state[16] ^ PAD_LAST
    out = keccak_f(state)
    return torch.stack(out[:4], dim=1)


def leaf_digests(values: torch.Tensor) -> torch.Tensor:
    """SHA3-256 of each value's 8-byte little-endian encoding: (N,) -> (N, 4)."""
    return _absorb([values.to(torch.int64)], 1)


def node_digests(children: torch.Tensor) -> torch.Tensor:
    """SHA3-256 of left || right for each pair of neighbouring digests:
    (2N, 4) -> (N, 4)."""
    pairs = children.reshape(-1, 8)
    return _absorb([pairs[:, i].contiguous() for i in range(8)], 8)


def digest_bytes(digest: torch.Tensor) -> bytes:
    """The 32 bytes of one (4,) digest."""
    return digest.cpu().numpy().astype("<i8").tobytes()
