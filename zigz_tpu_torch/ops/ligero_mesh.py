"""Ligero commitments sharded over a process group.

Counterpart of zigz_tpu/ops/ligero_mesh.py (the file keeps its name; the
"mesh" is a :class:`~..parallel.multihost.TraceGroup`), with the
collectives written out:

* the (rows, n) input matrix is padded with zero rows to a multiple of D and
  cut CONTIGUOUSLY by rows: every rank holds the host matrix whole and
  uploads only its own rows;
* each rank Reed-Solomon-encodes its rows (ops/ntt_dev.py ``encode_rows``,
  kernels N1 and N2 on the card; rows are independent, so the encode needs
  no exchange), in stream blocks of ``_STREAM_BLOCK_WORDS`` rows, so the
  encoded transient stays one block whatever the row count;
* ONE ``all_to_all_single`` per block turns the block's row shards into
  column shards (parallel/dist.py ``rows_to_columns``); the received chunks
  land at their rows of this rank's (rows_pad, n_e / D) int32 column shard;
* each rank sponges its n_e / D columns over the first ``rows`` words with
  **K4** (ops/ligero_dev.py ``sha3_columns``, one launch over the whole
  column shard; its plain version on the CPU).  The exchange delivers a
  block's rows from every rank at once, which are not consecutive rows of
  the column stream, so the carried-state kernel K5 has nothing to stream
  here: the shard has to exist whole, and then one K4 launch hashes it;
* the (n_e / D, 4) digests are all-gathered; the Merkle levels stay on the
  host, as in the unsharded commit.

Openings re-encode each rank's rows and gather only the t opened columns
(:class:`MeshEncoded`).

Exactness: the encode and the sponge are the programs of the unsharded
commit, so the digest blob, and with it the root, the transcript and the
proof bytes, equal ``sha3_columns_stream``'s and zigz_tpu's
``_hash_columns(ntt_pow2_u32(mat, n_e), "sha3")``
(tests/test_torch_ligero_mesh.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel import dist
from .keccak import digests_to_bytes
from .ligero_dev import _STREAM_BLOCK_WORDS, sha3_columns
from .ntt_dev import encode_rows

__all__ = ["mesh_commit_ok", "commit_columns_mesh", "MeshEncoded"]


def mesh_commit_ok(group, n_e: int, total_rows: int) -> bool:
    """The sharded path needs the encoded-column axis divisible by the group
    (for the all_to_all) and a code length of at least 256."""
    if group is None:
        return False
    d = group.world_size
    return d > 1 and n_e >= 256 and n_e % d == 0 and total_rows >= 1


def _upload_rows(group, mat_u32: np.ndarray) -> torch.Tensor:
    """This rank's rows of the zero-padded matrix as int32 words on the
    group's device: (rows_pad / D, n)."""
    rows, n = mat_u32.shape
    d = group.world_size
    per = -(-rows // d)
    first = group.rank * per
    local = np.zeros((per, n), dtype=np.uint32)
    have = max(0, min(rows, first + per) - first)
    local[:have] = mat_u32[first : first + have]
    return torch.from_numpy(local.view(np.int32)).to(group.device)


def commit_columns_mesh(group, mat_u32: np.ndarray, n_e: int):
    """Leaf-digest blob (n_e * 32 bytes) of the encoded columns of the
    (rows, n) canonical-u32 host matrix, computed over ``group``; also
    returns this rank's row shard on the device, for the openings."""
    if mat_u32.dtype != np.uint32 or mat_u32.ndim != 2:
        raise ValueError(f"expected a (rows, n) uint32 matrix, got {mat_u32.dtype} {mat_u32.shape}")
    rows = mat_u32.shape[0]
    d = group.world_size
    if n_e % d:
        raise ValueError(f"{n_e} encoded columns do not divide over {d} ranks")
    mat_loc = _upload_rows(group, mat_u32)
    per = mat_loc.shape[0]
    cols = torch.empty((d, per, n_e // d), dtype=torch.int32, device=group.device)
    for k0 in range(0, per, _STREAM_BLOCK_WORDS):
        enc = encode_rows(mat_loc[k0 : k0 + _STREAM_BLOCK_WORDS], n_e)
        blk = enc.shape[0]
        # rows k0.. of every rank s, for this rank's columns
        cols[:, k0 : k0 + blk] = dist.rows_to_columns(group, enc).view(d, blk, n_e // d)
        del enc
    digests = sha3_columns(cols.view(d * per, n_e // d)[:rows])
    del cols
    blob = digests_to_bytes(dist.all_gather_cat(group, digests, 0))
    return blob, mat_loc


class MeshEncoded:
    """``LigeroCommitState.encoded`` of a sharded commit: holds this rank's
    rows of the INPUT matrix on the device as ``mat_loc``; opened columns
    re-encode on every rank and only the (rows, t) gather crosses ranks.
    There is no ``mat_dev``: the whole matrix is resident on no rank, so
    ``LigeroCommitState.device_column`` answers "not resident" and the
    zerochecks upload their columns from the host arrays."""

    def __init__(self, group, mat_loc: torch.Tensor, n_e: int, rows: int):
        self.group = group
        self.mat_loc = mat_loc
        self.n_e = n_e
        self.rows = rows

    def gather(self, indices) -> np.ndarray:
        """(t, rows) uint64 opened columns of the encoded matrix."""
        idx = torch.as_tensor(np.asarray(indices, dtype=np.int64), device=self.mat_loc.device)
        parts = [
            encode_rows(self.mat_loc[k0 : k0 + _STREAM_BLOCK_WORDS], self.n_e).index_select(1, idx)
            for k0 in range(0, self.mat_loc.shape[0], _STREAM_BLOCK_WORDS)
        ]
        opened = dist.all_gather_cat(self.group, torch.cat(parts).contiguous(), 0)  # (rows_pad, t)
        return opened[: self.rows].cpu().numpy().T.astype(np.uint64)
