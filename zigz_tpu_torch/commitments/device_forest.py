"""The 43 witness Merkle trees, built and kept on the device.

Counterpart of zigz_tpu/commitments/device_forest.py.  Layout: tree-major
with adjacent pairing.  Level k is a (B, N >> k, 4) int64 tensor of digests
(level 0 = leaf digests, level height = the B roots).  Viewed as
(B * N >> (k + 1), 8), level k is exactly K2's input for level k + 1, and a
pair never crosses trees because N >> k is even below the root.  So the
sibling of node i is node i ^ 1 of the same tree.

The JAX package stores levels in a bit-reversed, tree-minor order that
avoids lane shuffles on the TPU, folds the top levels on the host, and at
large sizes frees low levels and recomputes their siblings at open time
(HOST_TOP_THRESHOLD, DISCARD_DIGESTS, GROUP_LEAF_DIGESTS,
_recompute_siblings).  None of that is ported here: every level stays on
the device, which at 2^22 steps is 43 * (2^23 - 1) * 32 bytes, about
11.5 GB.  Roots, openings and evaluations are byte-identical to
SimpleMerkleTree and to the JAX forest (tests/test_torch_forest.py).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .merkle import MerklePath, OpeningProof

from ..ops import babybear as bb
from ..ops import keccak, mle

__all__ = ["DeviceMerkleForest"]


class DeviceMerkleForest:
    def __init__(self, F, lo: torch.Tensor):
        """``lo``: (B, N) int32 canonical witness on the device, N = 2^height.

        Builds every level: one K1 launch for the B * N leaves, then one K2
        launch per level."""
        if F.MODULUS != bb.P:
            raise ValueError(f"the port's field is BabyBear (p = {bb.P}), not {F.MODULUS}")
        if lo.dtype != torch.int32 or lo.dim() != 2:
            raise ValueError(f"expected a (B, N) int32 tensor, got {lo.dtype} {tuple(lo.shape)}")
        B, N = lo.shape
        if N <= 0 or N & (N - 1):
            raise ValueError(f"leaf count {N} is not a power of two")
        self.F = F
        self.lo = lo
        self.B, self.N = B, N
        self.height = N.bit_length() - 1

        level = keccak.sha3_leaves(lo.reshape(-1).to(torch.int64))  # (B * N, 4)
        self.levels = [level.view(B, N, 4)]
        for k in range(self.height):
            level = keccak.sha3_merge(level.view(-1, 8))
            self.levels.append(level.view(B, N >> (k + 1), 4))
        self._root_bytes = keccak.digests_to_bytes(self.levels[-1].reshape(B, 4))

    def roots(self) -> List[bytes]:
        return [self._root_bytes[i * 32 : (i + 1) * 32] for i in range(self.B)]

    def eval_backend(self, matrix, points: np.ndarray) -> np.ndarray:
        """Evaluate the B witness MLEs at per-row points (B, v) canonical
        uint64, from the device-resident witness; ``matrix`` is ignored (the
        prover passes None).  Returns (B,) canonical uint64."""
        pts = torch.from_numpy(np.ascontiguousarray(points, dtype=np.uint64).view(np.int64))
        values = mle.batch_eval_lsb(self.lo.to(torch.int64), pts.to(self.lo.device))
        return values.cpu().numpy().astype(np.uint64)

    def open_all(self, indices: np.ndarray) -> List[OpeningProof]:
        """One opening per tree at the given per-tree leaf indices.

        One gather per level, then a single device-to-host copy of the
        (height, B, 4) sibling digests together with the B leaf values."""
        B, N, height = self.B, self.N, self.height
        idx = np.asarray(indices, dtype=np.int64)
        if idx.shape != (B,) or (idx < 0).any() or (idx >= N).any():
            raise ValueError(f"expected {B} leaf indices in [0, {N})")
        device = self.lo.device
        shifts = np.arange(height, dtype=np.int64)[:, None]
        sibling = torch.from_numpy((idx[None, :] >> shifts) ^ 1).to(device)  # (height, B)
        rows = torch.arange(B, device=device)
        parts = [self.levels[k][rows, sibling[k]].reshape(-1) for k in range(height)]
        parts.append(self.lo[rows, torch.from_numpy(idx).to(device)].to(torch.int64))
        host = torch.cat(parts).cpu().numpy()

        sib = host[: height * B * 4].reshape(height, B, 4).astype("<i8")
        leaf_values = host[height * B * 4 :]
        is_right = ((idx[None, :] >> shifts) & 1).astype(bool)  # (height, B)
        return [
            OpeningProof(
                index=int(idx[i]),
                value=self.F.from_reduced(int(leaf_values[i])),
                path=MerklePath(
                    siblings=[sib[k, i].tobytes() for k in range(height)],
                    directions=[bool(is_right[k, i]) for k in range(height)],
                ),
            )
            for i in range(B)
        ]
