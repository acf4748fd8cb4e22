"""Sharding over the trace/hypercube axis with explicit collectives.

Counterpart of zigz_tpu/parallel/dist.py.  The JAX package writes
global-semantics programs and lets the SPMD partitioner emit the
collectives; here every rank of a :class:`~.multihost.TraceGroup` holds its
shard as a plain tensor and the collectives are written out.  The wrappers
below are the only code, with parallel/multihost.py, that calls
``torch.distributed``: under ``"nccl"`` they hand device tensors over as
they are, under ``"gloo"`` they hand CPU tensors over as they are and stage
tensors that lie on a card through the host.  Only int32 and int64 cross
ranks (canonical field values, digest words).

Two layouts, chosen per array; only canonical values are the contract:

* **contiguous** (:func:`shard_rows`): rank r holds
  ``[..., r*N/D : (r+1)*N/D]``.  For the witness, the forest and the
  LSB-fold opening evaluations: adjacent pairs (2i, 2i+1) stay on one rank
  for ``v - log2 D`` levels and rounds.  This is the JAX package's layout.
* **cyclic** (:func:`shard_cyclic`): index i lies on rank ``i mod D`` at
  local index ``i // D``.  For every MSB-fold sumcheck: the pair
  (i, i + N/2) lies on one rank at local indices j and j + N/(2D), so the
  half sums g0 and g1 are local halves and the fold needs no exchange until
  the global width reaches D; only the sums cross ranks (one all_reduce of
  canonical int64, D * p far below 2^63).  At the tail the shards are
  all-gathered and un-interleaved into natural order
  (:func:`gather_cyclic`).

Each sumcheck round needs one device-to-host read for the challenge, which
Fiat-Shamir makes inherent; the transcript stays on the host and every rank
repeats it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.hash import FiatShamirTranscript
from ..device import resolve_device
from ..ops import babybear as bb
from ..ops.mle import batch_eval_lsb, fold_msb, round_poly_msb, sum_mod
from ..utils.profiling import counter_table
from .multihost import TraceGroup

__all__ = [
    "world_size",
    "all_reduce_sum",
    "all_gather_cat",
    "all_gather_last",
    "rows_to_columns",
    "exchange_rows",
    "shard_rows",
    "shard_cyclic",
    "gather_cyclic",
    "sumcheck_rounds_msb",
    "DistSumcheckProver",
    "device_prove_step",
    "COLLECTIVES",
]

# Collectives issued through torch.distributed since the last reset.
COLLECTIVES = counter_table("collectives", ["all_reduce", "all_gather", "all_to_all"])


def world_size(group: Optional[TraceGroup]) -> int:
    return 1 if group is None else group.world_size


def _check(group: TraceGroup, t: torch.Tensor) -> None:
    if t.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"only int32 and int64 cross ranks, not {t.dtype}")
    if t.device != group.device and not (group.backend == "gloo" and t.device.type == "cpu"):
        raise ValueError(f"tensor on {t.device}, group on {group.device}")


def _wire(group: TraceGroup, t: torch.Tensor) -> torch.Tensor:
    """The tensor a collective is given: the device tensor under nccl, a
    host copy of a card's tensor under gloo.  Always contiguous."""
    if group.backend == "gloo" and t.device.type == "cuda":
        return t.cpu().contiguous()
    return t.contiguous()


def all_reduce_sum(group: Optional[TraceGroup], t: torch.Tensor) -> torch.Tensor:
    """Elementwise sum over the ranks, on ``t``'s device; ``t`` is not
    altered.  The caller reduces mod p: D canonical values sum far below
    2^63."""
    if group is None or group.pg is None:
        return t
    import torch.distributed as dist

    _check(group, t)
    wire = _wire(group, t)
    if wire.data_ptr() == t.data_ptr():
        wire = wire.clone()
    dist.all_reduce(wire, op=dist.ReduceOp.SUM, group=group.pg)
    COLLECTIVES["all_reduce"] += 1
    return wire.to(t.device)


def all_gather_cat(group: Optional[TraceGroup], t: torch.Tensor, dim: int) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order."""
    if group is None or group.pg is None:
        return t
    import torch.distributed as dist

    _check(group, t)
    wire = _wire(group, t)
    parts = [torch.empty_like(wire) for _ in range(group.world_size)]
    dist.all_gather(parts, wire, group=group.pg)
    COLLECTIVES["all_gather"] += 1
    return torch.cat(parts, dim=dim).to(t.device)


def all_gather_last(group: Optional[TraceGroup], t: torch.Tensor) -> torch.Tensor:
    """Contiguous shards of the trailing axis -> the whole axis."""
    return all_gather_cat(group, t, -1)


def rows_to_columns(group: Optional[TraceGroup], block: torch.Tensor) -> torch.Tensor:
    """Row shards -> column shards in ONE ``all_to_all_single``.

    ``block`` (rows_loc, n) is this rank's rows of a matrix cut by rows; the
    result (D * rows_loc, n / D) holds every rank's rows, in rank order,
    which is the original row order, for this rank's n / D columns.  The
    chunks sent must be contiguous by destination rank:
    (rows_loc, D, n/D) -> (D, rows_loc, n/D)."""
    if group is None or group.pg is None:
        return block
    import torch.distributed as dist

    _check(group, block)
    D = group.world_size
    rows_loc, n = block.shape
    if n % D:
        raise ValueError(f"{n} columns do not divide over {D} ranks")
    send = _wire(group, block).view(rows_loc, D, n // D).permute(1, 0, 2).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group.pg)
    COLLECTIVES["all_to_all"] += 1
    return recv.view(D * rows_loc, n // D).to(block.device)


def exchange_rows(group: TraceGroup, t: torch.Tensor, send_counts, recv_counts) -> torch.Tensor:
    """``all_to_all_single`` with uneven splits of dim 0: rows
    ``sum(send_counts[:d]) ..`` of ``t`` go to rank d; the result holds
    ``recv_counts[s]`` rows of every rank s, in rank order."""
    import torch.distributed as dist

    _check(group, t)
    send = _wire(group, t)
    recv = send.new_empty((sum(recv_counts),) + tuple(send.shape[1:]))
    dist.all_to_all_single(recv, send, list(recv_counts), list(send_counts), group=group.pg)
    COLLECTIVES["all_to_all"] += 1
    return recv.to(t.device)


def _axis_len(group, arr, axis):
    n = arr.shape[axis]
    if n % world_size(group):
        raise ValueError(f"axis of {n} does not divide over {world_size(group)} ranks")
    return n


def shard_rows(group: Optional[TraceGroup], arr, axis: int = -1):
    """This rank's CONTIGUOUS slice of ``axis`` (numpy array or tensor): the
    host array is whole on every rank, so nothing is scattered."""
    if group is None:
        return arr
    per = _axis_len(group, arr, axis) // group.world_size
    index = [slice(None)] * arr.ndim
    index[axis] = slice(group.rank * per, (group.rank + 1) * per)
    return arr[tuple(index)]


def shard_cyclic(group: Optional[TraceGroup], arr):
    """This rank's CYCLIC slice of the trailing axis: ``arr[..., rank::D]``."""
    if group is None:
        return arr
    _axis_len(group, arr, -1)
    return arr[..., group.rank :: group.world_size]


def gather_cyclic(group: Optional[TraceGroup], local: torch.Tensor) -> torch.Tensor:
    """Cyclic shards (..., w/D) -> the whole (..., w) in natural order on
    every rank: (D, ..., w/D) -> (..., w/D, D) -> (..., w).  Index i of the
    result is local index i // D of rank i mod D."""
    if group is None or group.pg is None:
        return local
    stacked = all_gather_cat(group, local.unsqueeze(0), 0)  # (D, ..., w/D)
    return stacked.movedim(0, -1).reshape(*local.shape[:-1], -1)


def sumcheck_rounds_msb(F, transcript, evals, device, group: Optional[TraceGroup] = None,
                        host_tail: int = 1, pad=()):
    """The MSB-fold sumcheck rounds of one table of canonical values, the
    one round loop of :class:`DistSumcheckProver` and of the Lasso rounds
    (lookups/pipeline_lasso.py).

    The table lies on ``device`` as canonical int64; each round reads back
    its two half sums, absorbs the wire coefficients ``[g0, g1 - g0, *pad]``
    and folds by the challenge; the transcript stays on the host.  Under a
    ``group`` a table wider than the tail is cut cyclically over the ranks:
    the half sums and the fold are local and one all_reduce a round carries
    the sums.  At width ``max(host_tail, D)`` the shards are all-gathered
    into natural order and the remaining rounds run on the host.  Returns
    (rounds, point, final value, rounds run on the device)."""
    p = F.MODULUS
    n = len(evals)
    num_vars = n.bit_length() - 1
    D = world_size(group)
    host_tail = max(host_tail, D)
    sharded = D > 1 and n > host_tail
    words = np.ascontiguousarray(evals, dtype=np.uint64).view(np.int64)
    if sharded:
        words = np.ascontiguousarray(shard_cyclic(group, words))
    rounds, point = [], []

    def absorb(g0: int, g1: int) -> int:
        coeffs = [F.from_reduced(g0), F.from_reduced((g1 - g0) % p), *pad]
        rounds.append(coeffs)
        for c in coeffs:
            transcript.append_field_element(F, c)
        r = transcript.challenge_value(p)
        point.append(F.from_reduced(r))
        return r

    cur = torch.from_numpy(words).to(device)
    device_rounds = 0
    while (n >> device_rounds) > host_tail:
        sums = torch.stack(round_poly_msb(cur))
        if sharded:
            sums = all_reduce_sum(group, sums) % p
        g0, g1 = (int(g) for g in sums.cpu())
        cur = fold_msb(cur, absorb(g0, g1))
        device_rounds += 1
    if sharded:
        cur = gather_cyclic(group, cur)
    tail = cur.cpu().numpy().astype(np.uint64)
    for _ in range(num_vars - device_rounds):
        half = len(tail) // 2
        r = absorb(int(tail[:half].sum(dtype=np.uint64)) % p, int(tail[half:].sum(dtype=np.uint64)) % p)
        tail = (np.uint64((1 - r) % p) * tail[:half] + np.uint64(r) * tail[half:]) % np.uint64(p)
    return rounds, point, F.from_reduced(int(tail[0]) if len(tail) else 0), device_rounds


class DistSumcheckProver:
    """Distributed wire-compatible sumcheck over a sharded MLE.

    Produces EXACTLY the round polynomials, challenges and final value of
    the host ``SumcheckProver`` (same MSB-fold ordering, a fresh transcript
    per proof, coefficients [g0, g1 - g0]), with the 2^v axis on the device,
    cut cyclically over the group.  ``group=None`` is the single-device
    case; ``device`` defaults to the group's device, or to the card."""

    def __init__(self, F, group: Optional[TraceGroup] = None, *, device=None):
        if F.MODULUS != bb.P:
            raise ValueError(f"the device sumcheck is BabyBear-only (p = {bb.P}), not {F.MODULUS}")
        self.F = F
        self.group = group
        if device is None:
            device = group.device if group is not None else "cuda"
        self.device = resolve_device(device)
        if group is not None and group.device != self.device:
            raise ValueError(f"group on {group.device}, prover on {self.device}")

    def prove(self, evals_canonical: np.ndarray):
        from ..proofs.sumcheck import SumcheckProof

        n = len(evals_canonical)
        num_vars = n.bit_length() - 1
        if n == 1 or (1 << num_vars) != n:
            raise ValueError("evals must be a power of two > 1")
        round_polys, challenges, final_eval, _ = sumcheck_rounds_msb(
            self.F, FiatShamirTranscript(), evals_canonical, self.device, self.group)
        return SumcheckProof(
            round_polynomials=round_polys,
            final_point=challenges,
            final_eval=final_eval,
            num_vars=num_vars,
        )


def device_prove_step(matrix: torch.Tensor, points: torch.Tensor, r: torch.Tensor,
                      group: Optional[TraceGroup] = None):
    """One device phase of the proving pipeline, the step the multi-rank dry
    run drives:

    * the opening evaluation of all rows at per-row points (LSB folds, local
      to a rank for ``v - log2 D`` rounds, then one all-gather of (B, D));
    * one sumcheck round (the two half sums; one all_reduce);
    * one MSB fold (ranks d and d + D/2 hold a pair's two halves: one
      exchange).

    Canonical int64 in and out.  ``matrix`` (B, N), or under a group this
    rank's contiguous (B, N/D) slice; ``points`` (B, v) with N = 2^v;
    ``r`` (1,).  Returns (evals (B,), g0 (B,), g1 (B,), folded): ``folded``
    is (B, N/2), or this rank's contiguous (B, N/(2D)) slice of it."""
    D = world_size(group)
    if D == 1:
        half = matrix.shape[-1] // 2
        return (batch_eval_lsb(matrix, points), sum_mod(matrix[:, :half]),
                sum_mod(matrix[:, half:]), fold_msb(matrix, r))

    B, n_loc = matrix.shape
    v = points.shape[1]
    v_loc = n_loc.bit_length() - 1
    if n_loc < 2 or n_loc & (n_loc - 1) or n_loc * D != 1 << v:
        raise ValueError(f"a (B, {n_loc}) slice on {D} ranks does not match {v} variables")
    rank = group.rank

    # LSB folds: bit j of the global index is bit j of the local index for
    # j < v_loc, the rank above them.
    local = batch_eval_lsb(matrix, points[:, :v_loc])
    tops = all_gather_cat(group, local[:, None], 1)  # (B, D)
    evals = batch_eval_lsb(tops, points[:, v_loc:])

    # ranks below D/2 hold the first half of every row
    own = sum_mod(matrix)
    zero = torch.zeros_like(own)
    sums = all_reduce_sum(group, torch.stack([own, zero] if rank < D // 2 else [zero, own])) % bb.P

    # Output block b of (B, N/(2D)) pairs the b%2 half of rank b//2 with the
    # same half of rank D/2 + b//2: every rank sends its two halves to ranks
    # 2*(rank mod D/2) and 2*(rank mod D/2) + 1.
    send = [0] * D
    send[2 * (rank % (D // 2))] = send[2 * (rank % (D // 2)) + 1] = n_loc // 2
    recv = [0] * D
    recv[rank // 2] = recv[D // 2 + rank // 2] = n_loc // 2
    pair = exchange_rows(group, matrix.t().contiguous(), send, recv)  # (n_loc, B): lo rows, then hi rows
    folded = fold_msb(pair.t(), r)
    return evals, sums[0], sums[1], folded

