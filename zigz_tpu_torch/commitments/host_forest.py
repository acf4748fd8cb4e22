"""Host Merkle forest: all 43 witness trees in ONE native call.

CPU counterpart of the device forest (device_forest.py) with the same
roots()/open_all() API.  The per-tree Python loop over SimpleMerkleTree
costs significant interpreter/copy overhead on top of the raw hash rate;
``zigz_sha3_forest`` builds every tree's every level into a single buffer
with one thread pool, parallelized across trees.

Byte-identical roots and paths vs SimpleMerkleTree
(tests/test_host_forest.py).
"""

from __future__ import annotations

import ctypes
from typing import List

import numpy as np

from .. import runtime
from .merkle import MerklePath, OpeningProof

__all__ = ["HostMerkleForest", "available"]


def available() -> bool:
    return runtime.NATIVE_AVAILABLE and hasattr(runtime._lib, "zigz_sha3_forest")


class HostMerkleForest:
    def __init__(self, F, matrix: np.ndarray):
        """matrix: (B, N) canonical uint64, N a power of two."""
        self.F = F
        self.matrix = matrix
        B, N = matrix.shape
        self.B, self.N = B, N
        self.height = N.bit_length() - 1
        self.per_tree = (2 * N - 1) * 32

        vals = np.ascontiguousarray(matrix, dtype=np.uint64)
        self.buffer = np.empty(B * self.per_tree, dtype=np.uint8)
        runtime._lib.zigz_sha3_forest(
            vals.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_size_t(B),
            ctypes.c_size_t(N),
            self.buffer.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_int(runtime.NUM_THREADS),
        )
        # Level start offsets (in digests) within one tree's blob.
        self.level_offsets = []
        offset = 0
        n = N
        while n >= 1:
            self.level_offsets.append(offset)
            offset += n
            if n == 1:
                break
            n //= 2

    def _digest(self, tree: int, level: int, index: int) -> bytes:
        base = tree * self.per_tree + (self.level_offsets[level] + index) * 32
        return self.buffer[base : base + 32].tobytes()

    def roots(self) -> List[bytes]:
        last = len(self.level_offsets) - 1
        return [self._digest(t, last, 0) for t in range(self.B)]

    def open_all(self, indices: np.ndarray) -> List[OpeningProof]:
        indices = np.asarray(indices, dtype=np.int64)
        out = []
        for t in range(self.B):
            cur = int(indices[t])
            siblings, directions = [], []
            for level in range(self.height):
                is_right = (cur % 2) == 1
                sibling = cur - 1 if is_right else cur + 1
                siblings.append(self._digest(t, level, sibling))
                directions.append(is_right)
                cur //= 2
            out.append(
                OpeningProof(
                    index=int(indices[t]),
                    value=self.F.from_reduced(int(self.matrix[t, indices[t]])),
                    path=MerklePath(siblings=siblings, directions=directions),
                )
            )
        return out
