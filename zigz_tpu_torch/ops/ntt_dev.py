"""Reed-Solomon row encode of the Ligero commitments: CUDA kernels N1 and N2
and their plain PyTorch version.

Counterpart of zigz_tpu/ops/ntt_dev.py ``encode_rows_device`` (jnp/XLA in
the JAX package, not Pallas).  Every row's n values are coefficients,
zero-padded to n_out, and evaluated over the size-n_out subgroup with the
same root of unity, twiddles and bit-reversed-input DIT as the host encoder
(zigz_tpu/commitments/ligero.py ``_ntt_pow2_numpy``), so the canonical
outputs are identical.  Because the input is zero-padded by a factor
k = n_out / n, the first log2(k) stages only copy each value into its whole
group: both versions start from that broadcast and skip them.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches N1
and N2 (csrc/ntt_kernels.cu over csrc/ntt.cuh) or raises.  There is no
fallback from one to the other and no size gate.  N1 runs the stages inside
each tile of 2^13 outputs (csrc/ntt.cuh ``kTile``) in register passes of 5
stages, N2 the global stages in passes of at most 8, one launch a pass
(``n2_passes``, the split of the header's plan): 1 + ceil(max(0, log2 n_out
- max(13, log2 k)) / 8) launches a call, 2 at the main shapes, none for a
call with no rows.  ``LAUNCHES`` counts them.

The plain version works in canonical int64 (a product of two values below p
is below 2^62), radix-2 stages in place on slabs of at most ``_SLAB_ELEMS``
values, so its transient stays bounded whatever the row count.  The kernels
work on canonical u32 with the twiddles in Montgomery form.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..commitments.ligero import _bit_reverse_indices, _twiddles
from ..utils.profiling import counter_table

from . import _build
from .babybear import P

__all__ = ["encode_rows", "n2_passes", "LAUNCHES"]

# Kernel launches since the last reset; the plain version does not count.
LAUNCHES = counter_table("ntt", ["tile", "pass"])

_LOG_MAX_OUT = 27  # BabyBear's two-adicity: the largest subgroup
_MAX_OUT = 1 << _LOG_MAX_OUT

# Transient int64 slab per butterfly sweep of the plain version: 2 GiB.
_SLAB_ELEMS = 1 << 28


# -- the plain version -------------------------------------------------------


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


def _encode_rows_plain(mat: torch.Tensor, n_out: int) -> torch.Tensor:
    """Plain version of N1 and N2: int64 torch ops, in slabs of rows."""
    rows, n = mat.shape
    br, tws = _tables(n, n_out, mat.device)
    slab = max(1, _SLAB_ELEMS // n_out)
    if rows <= slab:
        return _encode_slab(mat, n_out, br, tws)
    out = torch.empty((rows, n_out), dtype=torch.int32, device=mat.device)
    for s in range(0, rows, slab):
        out[s : s + slab] = _encode_slab(mat[s : s + slab], n_out, br, tws)
    return out


# -- the kernels -------------------------------------------------------------


def n2_passes(n: int, n_out: int) -> list:
    """N2's passes of an (R, n) -> (R, n_out) encode, each a range of the
    global stages it runs in one launch, as csrc/ntt.cuh's plan splits the
    stages between the kernels and the passes (``zigz_ntt_passes``): from
    max(log2 of the tile, log2 k) to log2 n_out - 1, at most 8 a pass.
    Builds the kernels' library or raises."""
    bounds, count = (ctypes.c_int64 * (_LOG_MAX_OUT + 1))(), ctypes.c_int64()
    _build.launch("zigz_ntt_passes", n, n_out, bounds, ctypes.byref(count))
    return [range(bounds[i], bounds[i + 1]) for i in range(count.value)]


def _mont_twiddles_np(n_out: int) -> np.ndarray:
    """The n_out - 1 twiddles of every stage end to end (stage s at offset
    2^s - 1) in Montgomery form, x 2^32 mod p, as int32."""
    tw = np.concatenate(_twiddles(n_out)).astype(np.uint64)
    return ((tw << np.uint64(32)) % np.uint64(P)).astype(np.int32)


@functools.lru_cache(maxsize=16)
def _mont_twiddles(n_out: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_mont_twiddles_np(n_out)).to(device)


def encode_rows(mat: torch.Tensor, n_out: int) -> torch.Tensor:
    """(R, n) canonical int32 or int64 -> (R, n_out) canonical int32 on the
    same device; n and n_out are powers of two, n <= n_out, 2 <= n_out <=
    2^27."""
    if mat.dim() != 2 or mat.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"encode_rows: expected a (R, n) int32/int64 tensor, got {mat.dtype} {tuple(mat.shape)}")
    rows, n = mat.shape
    if n < 1 or n & (n - 1) or n_out < max(n, 2) or n_out & (n_out - 1) or n_out > _MAX_OUT:
        raise ValueError(f"encode_rows: n={n}, n_out={n_out} must be powers of two with n <= n_out, "
                         f"2 <= n_out <= 2^27")
    if mat.device.type == "cpu":
        return _encode_rows_plain(mat, n_out)
    if mat.device.type != "cuda":
        raise ValueError(f"encode_rows: unsupported device {mat.device}")
    _build.load()  # build, or raise, before anything touches the card
    out = torch.empty((rows, n_out), dtype=torch.int32, device=mat.device)
    if rows == 0:
        return out
    passes = n2_passes(n, n_out)
    words = mat.to(torch.int32).contiguous()
    tw = _mont_twiddles(n_out, mat.device)
    with torch.cuda.device(mat.device):
        stream = torch.cuda.current_stream(mat.device).cuda_stream
        _launch_tile(words, tw, out, stream)
        for stages in passes:
            _launch_pass(out, tw, stages, stream)
    return out


def _launch_tile(words: torch.Tensor, tw: torch.Tensor, out: torch.Tensor, stream: int) -> None:
    """N1 on contiguous (R, n) int32 words into (R, n_out)."""
    _build.launch("zigz_ntt_tile", words.data_ptr(), tw.data_ptr(), out.data_ptr(), words.shape[0],
                  words.shape[1], out.shape[1], stream)
    LAUNCHES["tile"] += 1


def _launch_pass(out: torch.Tensor, tw: torch.Tensor, stages: range, stream: int) -> None:
    """N2: the global stages ``stages`` of every row of ``out``, in place,
    one launch."""
    _build.launch("zigz_ntt_pass", out.data_ptr(), tw.data_ptr(), out.shape[0], out.shape[1], stages.start,
                  stages.stop, stream)
    LAUNCHES["pass"] += 1
