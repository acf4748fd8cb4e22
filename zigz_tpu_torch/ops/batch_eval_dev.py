"""Batch-evaluation sumcheck rounds sharded over a process group.

Counterpart of zigz_tpu/ops/batch_eval_dev.py: the device twin, under a
:class:`~..parallel.multihost.TraceGroup`, of the round loop of
:func:`zigz_tpu_torch.proofs.batch_eval.prove_batch_eval`.  The host prover
keeps each claim group's tables at their native width and tracks
zero-padding with a scalar ``(1-r)^2`` scale; here every group's ``F`` and
``w`` tables are ZERO-PADDED to the full ``2^v_max`` domain, which is
mathematically identical (the padded multilinear extension of a short column
is ``prod(1-x_j) * f~``, and the weight pads the same way, which is exactly
the host path's ``(1-t)^2`` inactive-group term), so the emitted round
evaluations are the same field elements and the proof bytes are unchanged
(tests/test_torch_ligero_mesh.py).

The stack is cut CYCLICALLY along the hypercube axis (parallel/dist.py), so
the MSB fold and the half sums are local to a rank: per round one fold by
the previous challenge, the degree-2 sums g(0) and g(2) (g(1) = claim - g(0),
the identity the native C++ path also uses) and ONE all_reduce of the
(2, 4) coordinate sums.  The tail rounds (width at or below ``host_tail``,
never below D) finish on the host in numpy after one all-gather.

Arithmetic is canonical int64 over ops/ext4_dev.py; the JAX package's
Montgomery form and its jit caches keyed by mesh are not carried over.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..core.ext4 import Ext4, challenge_ext, ext_from_ints
from ..parallel import dist
from ..utils.profiling import counter_table
from .babybear import P
from .ext4_dev import _schoolbook, ext_fold_dev
from .mle import sum_mod

__all__ = ["mesh_rounds_ok", "prove_rounds_mesh", "MESH_ROUNDS"]

# Rounds that ran sharded on the group's device since the last reset.
MESH_ROUNDS = counter_table("batch_eval_mesh_rounds", ["count"])


def mesh_rounds_ok(group, v_max: int) -> bool:
    if group is None:
        return False
    d = group.world_size
    return d > 1 and (1 << v_max) >= 4 * d


def _ext_prod_sums(planes: torch.Tensor) -> torch.Tensor:
    """g(0), g(2) of sum_g F_g * w_g over a (4, G, 2, w) canonical stack:
    (2, 4) coordinate sums of this rank's half-split."""
    half = planes.shape[-1] // 2
    lo = planes[..., :half]
    hi = planes[..., half:]
    out = []
    for t in (0, 2):
        at = lo if t == 0 else (2 * hi - lo) % P  # (4, G, 2, half)
        prod = _schoolbook(at[:, :, 0].unbind(0), at[:, :, 1].unbind(0))  # 4 coords of (G, half)
        out.append(torch.stack([sum_mod(sum_mod(c, dim=-1), dim=0) for c in prod]))
    return torch.stack(out)


def prove_rounds_mesh(glist: List[dict], v_max: int, combined_claim: Ext4,
                      transcript, group, host_tail: int = None):
    """Run the batch-eval round loop under ``group``.  ``glist`` is the
    prover's materialized group list ({"v", "F", "w"}); returns
    (round_evals, rs, claim_running) with transcript absorbs identical to
    the host loop."""
    from ..proofs.zerocheck import _interp_eval_ext, absorb_ext

    d = group.world_size
    host_tail = max(d, max(4 * d, 256) if host_tail is None else host_tail)
    W = 1 << v_max
    stacked = np.zeros((4, len(glist), 2, W), dtype=np.uint32)
    for gi, g in enumerate(glist):
        w_g = 1 << g["v"]
        stacked[:, gi, 0, :w_g] = g["F"].c
        stacked[:, gi, 1, :w_g] = g["w"].c
    local = np.ascontiguousarray(dist.shard_cyclic(group, stacked))
    del stacked
    planes = torch.from_numpy(local.view(np.int32)).to(group.device).to(torch.int64)

    round_evals: List[List[Ext4]] = []
    rs: List[Ext4] = []
    claim_running = combined_claim

    def emit(g0: Ext4, g2: Ext4) -> Ext4:
        nonlocal claim_running
        evals = [g0, claim_running - g0, g2]
        round_evals.append(evals)
        for e in evals:
            absorb_ext(transcript, e)
        r = challenge_ext(transcript)
        rs.append(r)
        claim_running = _interp_eval_ext(evals, r, P)
        return r

    def device_round() -> Ext4:
        sums = (dist.all_reduce_sum(group, _ext_prod_sums(planes)) % P).cpu().tolist()
        MESH_ROUNDS["count"] += 1
        return emit(ext_from_ints(sums[0]), ext_from_ints(sums[1]))

    r = device_round()
    width = W
    rnd = 1
    while rnd < v_max and width // 2 > host_tail:
        width //= 2
        planes = ext_fold_dev(planes, r)
        r = device_round()
        rnd += 1

    # Host tail: all-gather into natural order, fold by the pending r,
    # finish in numpy on the padded per-group Ext4 tables (same values as
    # the device rounds).
    arr = dist.gather_cyclic(group, planes).cpu().numpy().astype(np.uint64)
    tabs = [(Ext4(np.ascontiguousarray(arr[:, gi, 0])), Ext4(np.ascontiguousarray(arr[:, gi, 1])))
            for gi in range(len(glist))]
    while rnd < v_max:
        tabs = [(_fold_host(F, r), _fold_host(w, r)) for F, w in tabs]
        r = emit(_prod_sum_host(tabs, 0), _prod_sum_host(tabs, 2))
        rnd += 1
    return round_evals, rs, claim_running


def _fold_host(tab: Ext4, r: Ext4) -> Ext4:
    half = tab.shape[-1] // 2
    return (1 - r) * tab[..., :half] + r * tab[..., half:]


def _at_t_host(tab: Ext4, t: int) -> Ext4:
    half = tab.shape[-1] // 2
    lo = tab[..., :half]
    hi = tab[..., half:]
    if t == 0:
        return lo
    return (1 - t) * lo + t * hi


def _prod_sum_host(tabs, t: int) -> Ext4:
    from ..core.ext4 import ext_zeros

    total = ext_zeros()
    for F, w in tabs:
        total = total + (_at_t_host(F, t) * _at_t_host(w, t)).sum()
    return total
