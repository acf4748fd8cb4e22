"""BabyBear^4 extension-field arithmetic on canonical int64 tensors.

Counterpart of zigz_tpu/ops/ext4_dev.py and device twin of the hot pieces
of core/ext4.py (F_p[X]/(X^4 - 11)): an extension value-array is an int64
tensor of shape ``(4,) + base_shape`` holding the four coordinates as
canonical values (0 <= x < p).  The JAX package keeps Montgomery uint32
lanes; the port's contract is canonical int64 (ops/babybear.py), so
conversion to and from the host ``Ext4`` is a plain copy.  The JAX package
computes all of this in jnp outside any Pallas kernel, so the port uses
torch ops.  Scalar transcript algebra stays on the host in core/ext4.py.

Overflow discipline: a product of two canonical values is below
p^2 < 0.88 * 2^62, so int64 holds the sum of TWO raw products and no
more.  A schoolbook coordinate sums up to four products, one group of
them times W = 11: every sum here is taken pair by pair with a ``% P``
between, and the W factor multiplies a value that is already reduced.

Extension SCALARS (a fold challenge, an eq-table tau) are sequences of
four canonical Python ints, ``x.to_ints()`` of a host ``Ext4``: they reach
the kernels as immediate arguments, with no upload and no read-back.

Results are bit-equal to the host Ext4 and to the JAX functions
(tests/test_torch_ext4.py).

``fold_planes`` folds a whole zerocheck plane stack by one extension
challenge in one launch of kernel Z2 (csrc/zerocheck_kernels.cu
``ext_fold_kernel``) for a CUDA tensor, and by its plain version,
``ext_fold_base_dev`` / ``ext_fold_dev`` and a concatenation, for a CPU
tensor.  ``LAUNCHES`` counts Z2's launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..utils.profiling import counter_table
from . import _build
from . import babybear as bb
from .babybear import P

__all__ = [
    "W",
    "ext_to_device",
    "ext_from_device",
    "ext_scalar_to_device",
    "ext_add_dev",
    "ext_sub_dev",
    "ext_mul_dev",
    "ext_scale_dev",
    "ext_mul_base_dev",
    "ext_fold_dev",
    "ext_fold_base_dev",
    "ext_eq_table_dev",
    "ext_sum_dev",
    "ext_inv_dev",
    "FoldGroups",
    "fold_planes",
    "LAUNCHES",
]

# Kernel launches since the last reset; the plain version does not count.
LAUNCHES = counter_table("ext4", ["fold_planes"])

W = 11  # X^4 = W (core/ext4.py)
_R_MONT = (1 << 32) % P  # Montgomery radix mod p: Z2 takes r and W r in Montgomery form
_SIGMA = pow(W, (P - 1) // 4, P)
# Frobenius coordinate scalings sigma^(k*i), k = 0..3.
_FROB = [[pow(_SIGMA, (k * i) % 4, P) for i in range(4)] for k in range(4)]


# -- host <-> device conversion ---------------------------------------------

def ext_to_device(x, device) -> torch.Tensor:
    """Host Ext4 (or a (4, ...) canonical uint64 array) -> (4, ...) int64 on ``device``."""
    c = x.c if hasattr(x, "c") else np.asarray(x, dtype=np.uint64)
    return torch.from_numpy(np.ascontiguousarray(c, dtype=np.uint64).view(np.int64)).to(device)


def ext_from_device(x4: torch.Tensor) -> np.ndarray:
    """(4, ...) canonical int64 tensor -> canonical uint64 coordinates on the host."""
    return x4.cpu().numpy().astype(np.uint64)


def ext_scalar_to_device(x, device) -> torch.Tensor:
    """Host scalar Ext4 -> (4,) int64 on ``device``."""
    return ext_to_device(x, device).reshape(4)


def _scalar_ints(s4) -> List[int]:
    """An extension scalar as four canonical Python ints."""
    vals = s4.to_ints() if hasattr(s4, "to_ints") else (s4.tolist() if hasattr(s4, "tolist") else list(s4))
    if len(vals) != 4:
        raise ValueError(f"an extension scalar has 4 coordinates, got {len(vals)}")
    return [int(v) % P for v in vals]


# -- ring ops ----------------------------------------------------------------

def ext_add_dev(a4: torch.Tensor, b4: torch.Tensor) -> torch.Tensor:
    return (a4 + b4) % P


def ext_sub_dev(a4: torch.Tensor, b4: torch.Tensor) -> torch.Tensor:
    return (a4 - b4) % P


def _schoolbook(a, b) -> List[torch.Tensor]:
    """Coordinate lists a[0..3], b[0..3] (broadcastable tensors) -> the four
    coordinates of the product mod X^4 - W.  16 raw products, summed two at
    a time."""
    m = [[a[i] * b[j] for j in range(4)] for i in range(4)]

    def pair(x, y):
        return (x + y) % P

    c0 = (m[0][0] % P + W * ((pair(m[1][3], m[2][2]) + m[3][1] % P) % P)) % P
    c1 = (pair(m[0][1], m[1][0]) + W * pair(m[2][3], m[3][2])) % P
    c2 = (pair(m[0][2], m[1][1]) + m[2][0] % P + W * (m[3][3] % P)) % P
    c3 = (pair(m[0][3], m[1][2]) + pair(m[2][1], m[3][0])) % P
    return [c0, c1, c2, c3]


def ext_mul_dev(a4: torch.Tensor, b4: torch.Tensor) -> torch.Tensor:
    """(4, ...) x (4, ...) elementwise extension product."""
    return torch.stack(_schoolbook(a4.unbind(0), b4.unbind(0)))


def _scalar_matrix(s: Sequence[int]) -> List[List[int]]:
    """Multiplication by the scalar s as a 4 x 4 matrix of canonical ints:
    (s * t)_k = sum_j M[k][j] t_j, with the X^4 = W wrap folded in."""
    return [[s[k - j] if k >= j else W * s[4 + k - j] % P for j in range(4)] for k in range(4)]


def _apply_pairs(terms) -> torch.Tensor:
    """sum of coeff * tensor over ``terms`` [(int, tensor), ...] mod p, two
    raw products per reduction."""
    acc = None
    for i in range(0, len(terms), 2):
        c0, t0 = terms[i]
        part = t0 * c0
        if i + 1 < len(terms):
            c1, t1 = terms[i + 1]
            part = part + t1 * c1
        part = part % P
        acc = part if acc is None else acc + part
    # at most len(terms) / 2 canonical parts: far below 2^63
    return acc % P


def ext_scale_dev(t4: torch.Tensor, s4) -> torch.Tensor:
    """Extension table (4, ...) scaled by an extension scalar."""
    mat = _scalar_matrix(_scalar_ints(s4))
    t = t4.unbind(0)
    return torch.stack([_apply_pairs([(mat[k][j], t[j]) for j in range(4)]) for k in range(4)])


def ext_mul_base_dev(a4: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(4, ...) extension times a base-field tensor."""
    return (a4 * b) % P


def ext_fold_dev(t4: torch.Tensor, r4) -> torch.Tensor:
    """MSB fold of an extension table (4, ..., n) by an extension scalar r:
    (1-r) * lo + r * hi -> (4, ..., n/2).  Leading axes after the
    coordinate axis are batch axes (a stack of tables folds in one call)."""
    r = _scalar_ints(r4)
    om = [(1 - r[0]) % P, (-r[1]) % P, (-r[2]) % P, (-r[3]) % P]
    m_om, m_r = _scalar_matrix(om), _scalar_matrix(r)
    half = t4.shape[-1] // 2
    lo = t4[..., :half].unbind(0)
    hi = t4[..., half:].unbind(0)
    return torch.stack([
        _apply_pairs([(m_om[k][j], lo[j]) for j in range(4)] + [(m_r[k][j], hi[j]) for j in range(4)])
        for k in range(4)
    ])


def ext_fold_base_dev(t: torch.Tensor, r4) -> torch.Tensor:
    """MSB fold of a BASE table (..., n) by an extension scalar r ->
    (4, ..., n/2): coordinate e = (1-r)_e * lo + r_e * hi."""
    r = _scalar_ints(r4)
    om = [(1 - r[0]) % P, (-r[1]) % P, (-r[2]) % P, (-r[3]) % P]
    half = t.shape[-1] // 2
    lo, hi = t[..., :half], t[..., half:]
    return torch.stack([(lo * om[e] + hi * r[e]) % P for e in range(4)])


def ext_eq_table_dev(taus: Sequence, n: int, device) -> torch.Tensor:
    """Dense eq(tau, .) extension table (4, n) on ``device``, MSB-first
    variable order: device twin of proofs.zerocheck._eq_table_ext.  ``taus``
    are extension scalars (host Ext4 or four ints each)."""
    table = torch.zeros((4, 1), dtype=torch.int64, device=device)
    table[0, 0] = 1
    for tau in reversed(list(taus)):
        t = _scalar_ints(tau)
        om = [(1 - t[0]) % P, (-t[1]) % P, (-t[2]) % P, (-t[3]) % P]
        table = torch.cat([ext_scale_dev(table, om), ext_scale_dev(table, t)], dim=-1)
    if tuple(table.shape) != (4, n):
        raise ValueError(f"{len(taus)} taus give an eq table of {table.shape[-1]} entries, not {n}")
    return table


def ext_sum_dev(t4: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Exact modular coordinate-wise sum."""
    from .mle import sum_mod

    return sum_mod(t4, dim=dim)


def ext_inv_dev(a4: torch.Tensor) -> torch.Tensor:
    """Batched extension inverse via Frobenius and norm (core/ext4.py
    ``Ext4.inv`` twin): b = phi(a) phi^2(a) phi^3(a), N = (a * b)_0 is a
    base element, a^-1 = b / N.  Maps 0 to 0 (as the Fermat base inverse
    does)."""
    a = a4.unbind(0)

    def frob(k):
        return [a[e] * _FROB[k][e] % P for e in range(4)]

    b = _schoolbook(_schoolbook(frob(1), frob(2)), frob(3))
    # N(a) = (a * b)_0: only coordinate 0 of the product is needed.
    n0 = (a[0] * b[0] % P + W * (((a[1] * b[3] + a[2] * b[2]) % P + a[3] * b[1] % P) % P)) % P
    n_inv = bb.inv(n0)
    return torch.stack([b[e] * n_inv % P for e in range(4)])


# -- the fold of a whole plane stack: kernel Z2 ------------------------------

class FoldGroups:
    """The tables of a plane stack, for :func:`fold_planes`: ``table`` (G, 5)
    int32 rows (kind, s0, s1, s2, s3); kind 0 is a base table in row s0,
    kind 1 an extension table whose coordinate e lies in row s_e.  Folded
    table g lands in rows e * G + g of the output (the all-extension
    layout).  ``on`` uploads the table once per device."""

    __slots__ = ("table", "n_rows", "_on")

    def __init__(self, table):
        t = np.ascontiguousarray(table, dtype=np.int32)
        if t.ndim != 2 or t.shape[1] != 5 or not 1 <= t.shape[0] <= 65535:
            raise ValueError(f"FoldGroups: expected (G, 5) rows with 1 <= G <= 65535, got {t.shape}")
        kinds = t[:, 0]
        if not np.isin(kinds, (0, 1)).all():
            raise ValueError("FoldGroups: a kind is 0 (base) or 1 (extension)")
        used = np.concatenate([t[kinds == 0, 1], t[kinds == 1, 1:].ravel()])
        if (used < 0).any():
            raise ValueError("FoldGroups: a source row is negative")
        self.table = t
        self.n_rows = int(used.max(initial=-1)) + 1
        self._on: Dict[torch.device, torch.Tensor] = {}

    def on(self, device: torch.device) -> torch.Tensor:
        t = self._on.get(device)
        if t is None:
            t = torch.from_numpy(self.table).to(device)
            self._on[device] = t
        return t


def _fold_planes_plain(planes: torch.Tensor, r4, groups: FoldGroups) -> torch.Tensor:
    """Plain version of Z2: the base tables by ``ext_fold_base_dev``, the
    extension tables by ``ext_fold_dev``, concatenated in group order."""
    t = groups.table
    base, ext = np.flatnonzero(t[:, 0] == 0), np.flatnonzero(t[:, 0] == 1)
    half = planes.shape[-1] // 2
    out = torch.empty((4, t.shape[0], half), dtype=torch.int64, device=planes.device)
    if base.size:
        out[:, torch.from_numpy(base)] = ext_fold_base_dev(planes[torch.from_numpy(t[base, 1].astype(np.int64))], r4)
    if ext.size:
        rows = torch.from_numpy(np.ascontiguousarray(t[ext, 1:].T).astype(np.int64))  # (4, E)
        out[:, torch.from_numpy(ext)] = ext_fold_dev(planes[rows], r4)
    return out.reshape(4 * t.shape[0], half)


def fold_planes(planes: torch.Tensor, r4, groups: FoldGroups) -> torch.Tensor:
    """Fold every table of ``planes`` (rows, width) canonical int64 by the
    extension scalar r: (4 G, width / 2) canonical int64 in the
    all-extension layout of ``groups``.

    A CPU tensor takes the plain version; a CUDA tensor launches
    ``zigz_ext_fold`` or raises (KernelBuildError, KernelLaunchError)."""
    r = _scalar_ints(r4)
    if planes.dtype != torch.int64 or planes.dim() != 2 or not planes.is_contiguous():
        raise ValueError(f"fold_planes: expected a contiguous (rows, width) int64 tensor, "
                         f"got {planes.dtype} {tuple(planes.shape)}")
    rows, width = planes.shape
    if width < 2 or width % 2:
        raise ValueError(f"fold_planes: the width must be even and >= 2, got {width}")
    if groups.n_rows > rows:
        raise ValueError(f"fold_planes: the groups read {groups.n_rows} rows, the planes have {rows}")
    if planes.device.type == "cpu":
        return _fold_planes_plain(planes, r, groups)
    if planes.device.type != "cuda":
        raise ValueError(f"fold_planes: unsupported device {planes.device}")
    _build.load()  # build, or raise, before anything touches the card
    dev = planes.device
    n_groups = groups.table.shape[0]
    table = groups.on(dev)
    out = torch.empty((4 * n_groups, width // 2), dtype=torch.int64, device=dev)
    scalar = (ctypes.c_uint32 * 8)(*[v * _R_MONT % P for v in r], *[W * v * _R_MONT % P for v in r])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.launch("zigz_ext_fold", planes.data_ptr(), width, table.data_ptr(), n_groups, scalar,
                      out.data_ptr(), stream)
    LAUNCHES["fold_planes"] += 1
    return out

