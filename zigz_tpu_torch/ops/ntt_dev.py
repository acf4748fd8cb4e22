"""Reed-Solomon row encode of the Ligero commitments, in torch ops.

Counterpart of zigz_tpu/ops/ntt_dev.py ``encode_rows_device`` (jnp/XLA in
the JAX package, not Pallas).  Every row's n values are coefficients,
zero-padded to n_out, and evaluated over the size-n_out subgroup with the
same root of unity, twiddles and bit-reversed-input DIT as the host encoder
(zigz_tpu/commitments/ligero.py ``_ntt_pow2_numpy``), so the canonical
outputs are identical.

Arithmetic is canonical int64 (a product of two values below p is below
2^62).  The JAX package's four-step layout exists to keep every butterfly
stage on the TPU's 128-lane axis; the port runs the plain radix-2 stages,
in place on each slab.  Because the input is zero-padded by a factor
n_out / n, the first log2(n_out / n) stages only copy each value into its
whole group: the port starts from that broadcast and skips them.

Every size is encoded here, on the tensor's device: there is no host branch
for small n_out.  Rows are processed in slabs of at most ``_SLAB_ELEMS``
int64 values, so the transient stays bounded whatever the row count.  A CUDA
NTT kernel is later work, if the card shows the encode is the wall.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from zigz_tpu.commitments.ligero import _bit_reverse_indices, _twiddles

from .babybear import P

__all__ = ["encode_rows"]

# Transient int64 slab per butterfly sweep: 2 GiB.
_SLAB_ELEMS = 1 << 28


@functools.lru_cache(maxsize=16)
def _tables(n: int, n_out: int, device: torch.device):
    """(bit-reverse permutation of n, twiddles of the stages that run) on
    ``device``; stage s of length 2^(s+1) runs when 2^(s+1) > n_out / n."""
    skip = (n_out // n).bit_length() - 1
    br = torch.from_numpy(_bit_reverse_indices(n)).to(device)
    tws = tuple(torch.from_numpy(t.astype(np.int64)).to(device) for t in _twiddles(n_out)[skip:])
    return br, tws


def _encode_slab(mat: torch.Tensor, n_out: int, br, tws) -> torch.Tensor:
    rows, n = mat.shape
    x = mat[:, br].to(torch.int64).repeat_interleave(n_out // n, dim=1)
    for tw in tws:
        half = tw.shape[0]
        x = x.view(rows, n_out // (2 * half), 2, half)
        lo, hi = x[:, :, 0], x[:, :, 1]
        hi.mul_(tw).remainder_(P)
        diff = lo - hi
        lo.add_(hi).remainder_(P)
        hi.copy_(diff.remainder_(P))
    return x.view(rows, n_out).to(torch.int32)


def encode_rows(mat: torch.Tensor, n_out: int) -> torch.Tensor:
    """(R, n) canonical int32 or int64 -> (R, n_out) canonical int32 on the
    same device; n and n_out are powers of two, n <= n_out, 2 <= n_out."""
    if mat.dim() != 2 or mat.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"encode_rows: expected a (R, n) int32/int64 tensor, got {mat.dtype} {tuple(mat.shape)}")
    rows, n = mat.shape
    if n < 1 or n & (n - 1) or n_out < max(n, 2) or n_out & (n_out - 1):
        raise ValueError(f"encode_rows: n={n}, n_out={n_out} must be powers of two with n <= n_out, n_out >= 2")
    br, tws = _tables(n, n_out, mat.device)
    slab = max(1, _SLAB_ELEMS // n_out)
    if rows <= slab:
        return _encode_slab(mat, n_out, br, tws)
    out = torch.empty((rows, n_out), dtype=torch.int32, device=mat.device)
    for s in range(0, rows, slab):
        out[s : s + slab] = _encode_slab(mat[s : s + slab], n_out, br, tws)
    return out
