"""The v2 mixed-length Ligero commitment, encoded and hashed on a torch device.

Counterpart of zigz_tpu/commitments/ligero.py ``ligero_commit_mixed``
(its streamed-device branch).  The row layout and the Merkle levels are
zigz_tpu's (``choose_split_mixed``, ``mixed_layout``, ``_build_levels``, by
import); the matrix is assembled on the host, uploaded as plain u32 words,
Reed-Solomon-encoded and column-hashed by the streamed K5 commit
(ops/ligero_dev.py), and only the 32-byte leaf digests come back.  Root,
digests and levels equal zigz_tpu's host path (tests/test_torch_ligero.py).

``state.matrix`` stays host numpy, because zigz_tpu's ``ligero_prove_mixed``
runs its query-row vecmat on the host; ``state.encoded`` is a
:class:`StreamedEncoded`, whose ``gather`` re-encodes on the device at
open time.  There is no host encode or host hash, no fallback to them, no
size gate and no environment switch: ``commit_path`` is always
``"stream-dev"``.  The JAX package's width-packed upload
(``_pack_rows_host``) is not ported; it packed for a ~30 MB/s link.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from zigz_tpu.commitments.ligero import (
    LigeroCommitState,
    LigeroParams,
    _build_levels,
    choose_split_mixed,
    mixed_layout,
)

from ..device import resolve_device, synchronize
from ..ops.babybear import P
from ..ops.keccak import digests_to_bytes
from ..ops.ligero_dev import StreamedEncoded, sha3_columns_stream

__all__ = ["ligero_commit_mixed"]


def ligero_commit_mixed(F, columns: Dict[str, np.ndarray], hash_mode: str = "sha3", *,
                        device) -> LigeroCommitState:
    """Commit power-of-two-length MLEs of heterogeneous sizes (name ->
    canonical values) under one column-Merkle root, on ``device``, with
    zigz_tpu's default ``LigeroParams`` and one claim as the layout hint
    (what the v2 prover and verifier use).

    ``state.commit_timings`` holds ``assemble_s`` (the host matrix and its
    u32 words), ``upload_s`` (host to device), ``stream_s`` (encode +
    absorb) and ``levels_s`` (host Merkle levels), each read after a
    synchronize."""
    if F.MODULUS != P:
        raise ValueError(f"the port's field is BabyBear (p = {P}), not {F.MODULUS}")
    if hash_mode != "sha3":
        raise ValueError(f"hash_mode {hash_mode!r} is not ported (v2 commits with sha3)")
    dev = resolve_device(device)
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
    words = mat.astype(np.uint32).view(np.int32)
    t1 = time.perf_counter()
    rows = torch.from_numpy(words).to(dev)
    synchronize(dev)
    t2 = time.perf_counter()
    digests = sha3_columns_stream(rows, n_e)
    leaf_digests = digests_to_bytes(digests)  # the copy to the host waits for the card
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
        encoded=StreamedEncoded(rows, n_e),
        leaf_digests=leaf_digests,
        levels=levels,
        hash_mode=hash_mode,
        col_vars=col_vars,
        offsets=offsets,
        heights=heights,
    )
    state.commit_path = "stream-dev"
    state.commit_timings = dict(assemble_s=t1 - t0, upload_s=t2 - t1, stream_s=t3 - t2, levels_s=t4 - t3)
    return state
