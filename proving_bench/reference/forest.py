"""The reference's commitments to the 43 witness columns and their openings.

Each column is a binary SHA3-256 Merkle tree: a leaf hashes the value's
8-byte little-endian encoding, a node hashes left || right; an opening gives
the leaf's value and its siblings from the leaf up, with a flag that is set
where the path's node is a right child. The evaluation of a column at a
point is its multilinear extension there, the point's first coordinate
binding the lowest bit of the row index.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from . import sha3

CHUNK = 1 << 22  # hashes per batch of torch operations


def _chunked(fn, x: torch.Tensor, per: int) -> torch.Tensor:
    """fn over x in slices of `per` rows (a whole number of pairs for nodes)."""
    if x.shape[0] <= per:
        return fn(x)
    return torch.cat([fn(x[i:i + per]) for i in range(0, x.shape[0], per)])


@dataclass
class Forest:
    levels: List[torch.Tensor]  # level k: (B, N >> k, 4) int64 digest lanes; the last is the roots

    def roots(self) -> List[bytes]:
        top = self.levels[-1][:, 0].cpu().numpy().astype("<i8")
        return [top[i].tobytes() for i in range(top.shape[0])]

    def siblings(self, indices: np.ndarray) -> np.ndarray:
        """(B, height, 32) uint8: the sibling digests from the leaf up."""
        idx = torch.from_numpy(np.asarray(indices, dtype=np.int64)).to(self.levels[0].device)
        rows = torch.arange(idx.shape[0], device=idx.device)
        out = [self.levels[k][rows, (idx >> k) ^ 1] for k in range(len(self.levels) - 1)]
        if not out:
            return np.zeros((idx.shape[0], 0, 32), dtype=np.uint8)
        sib = torch.stack(out, dim=1).cpu().numpy().astype("<i8")
        return sib.view(np.uint8).reshape(idx.shape[0], len(out), 32)


def build(matrix: np.ndarray, device) -> Forest:
    """Every level of the 43 trees over the (B, 2^v) canonical matrix."""
    values = torch.from_numpy(np.ascontiguousarray(matrix).view(np.int64)).to(device)
    B, N = values.shape
    uniq, inv = torch.unique(values.reshape(-1), return_inverse=True)
    leaf = _chunked(sha3.leaf_digests, uniq, CHUNK)
    level = leaf[inv].reshape(B, N, 4)
    del uniq, inv, leaf
    levels = [level]
    while level.shape[1] > 1:
        flat = level.reshape(-1, 4)
        level = _chunked(sha3.node_digests, flat, 2 * CHUNK).reshape(B, -1, 4)
        levels.append(level)
    return Forest(levels)


def evaluate(matrix: np.ndarray, points: np.ndarray, p: int, device, lazy: bool = False) -> np.ndarray:
    """(B,) values: row i's multilinear extension at points[i], all mod p.
    `lazy` leaves out the reduction after each fold: the control's shortcut."""
    cur = torch.from_numpy(np.ascontiguousarray(matrix).view(np.int64)).to(device)
    pts = torch.from_numpy(np.ascontiguousarray(points, dtype=np.uint64).view(np.int64)).to(device)
    for j in range(pts.shape[1]):
        r = pts[:, j:j + 1]
        folded = (p + 1 - r) % p * cur[:, 0::2] + r * cur[:, 1::2]
        cur = folded if lazy else folded % p
    return (cur[:, 0] % p).cpu().numpy().astype(np.uint64)
