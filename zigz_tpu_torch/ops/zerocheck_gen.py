"""Base-field zerocheck prover on a torch device: any combiner's rounds via
symtrace.

Counterpart of zigz_tpu/ops/zerocheck_gen.py and device twin of
``proofs.zerocheck.ZerocheckProver``: the call site's own numpy combiner is
traced (ops/symtrace.py ``trace_combiner``), the DAG is lowered to the
round-sum kernel's program (``compile_device``, as in the extension prover
with one output instead of four), and the rounds run on the device:

* one (C, n) u32 upload of all columns;
* eq(tau, .) built on the device from the tau challenges;
* per round, g(0) and g(2..degree) of eq * C from one launch of kernel Z1
  (ops/dag_dev.py ``round_sums``, the eq row passed beside the DAG, which
  leaves it out; its kernel, generated for the program, starts building
  when the prover is constructed) - g(1) follows from the running claim as
  in the host prover - and one ``fold_msb`` of the whole stack in torch ops
  (a few launches a round; the extension prover's fold kernel Z2 is not
  used);
* under a ``group`` (parallel/multihost.py ``TraceGroup``) the stack is cut
  cyclically over the ranks (parallel/dist.py) and each round's sums cross
  them in one all_reduce;
* below ``host_tail`` remaining width the tables come down once and the
  rounds finish with the ORIGINAL combiner in numpy
  (``ZerocheckProver.round_values``), the reference path for tiny shapes.

Transcript bytes and the returned proof are identical to the host
ZerocheckProver's and to zigz_tpu's device class
(tests/test_torch_zerocheck_gen.py): every op reduces mod p, so the
canonical integers absorbed per round are the same.

Not carried over from zigz_tpu: Montgomery form (the port computes on
canonical int64), the jit caches, the bandwidth probe, the width gate and
every environment switch.  The caller names the device
(``proofs.zerocheck.make_zerocheck_prover(..., device=...)``); a
``TraceError`` or a failed launch raises.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..core.hash import FiatShamirTranscript
from ..device import resolve_device
from ..parallel import dist
from . import dag_dev
from .babybear import P
from .mle import fold_msb
from .symtrace import TraceError, trace_combiner

__all__ = ["GenericDeviceZerocheck", "eq_table_device", "HOST_TAIL", "DEVICE_PROVES"]

# Remaining table width below which rounds finish on host numpy.
HOST_TAIL = 1 << 12

# Zerochecks proven by this class since the last reset, and the launches of
# Z1 they made.
DEVICE_PROVES = {"count": 0, "sweep_launches": 0}


def eq_table_device(taus: List[int], n: int, device, group=None) -> torch.Tensor:
    """(n,) canonical int64 eq(tau, .) over the hypercube, built on
    ``device``: bit v-1-j of the index selects tau_j, so tau_j belongs to
    the MSB-first fold variable j (``proofs.zerocheck._eq_table``).  Under a
    ``group`` this rank's cyclic (n / D,) slice, built from its own indices."""
    v = len(taus)
    idx = dist.shard_cyclic(group, torch.arange(n, dtype=torch.int64, device=device))
    acc = torch.ones(idx.shape[0], dtype=torch.int64, device=device)
    for j, tau in enumerate(taus):
        tau %= P
        one_minus = (1 - tau) % P
        bit = (idx >> (v - 1 - j)) & 1
        acc = acc * (one_minus + bit * (tau - one_minus)) % P
    return acc


class GenericDeviceZerocheck:
    """Drop-in device twin of proofs.zerocheck.ZerocheckProver.

    Construction traces the combiner: a TraceError propagates BEFORE the
    transcript is touched."""

    def __init__(self, F, columns: Dict[str, np.ndarray], combiner, degree: int,
                 num_alphas: int = None, host_tail: int = None, *, device, group=None):
        if F.MODULUS != P:
            raise ValueError(f"the device zerocheck is BabyBear-only (p = {P}), not {F.MODULUS}")
        self.F = F
        self.device = resolve_device(device)
        if group is not None and group.device != self.device:
            raise ValueError(f"group on {group.device}, zerocheck on {self.device}")
        self.group = group
        self.combiner = combiner
        self.degree = degree
        self.num_alphas = num_alphas if num_alphas is not None else len(columns)
        # under a group the tail is never narrower than its D ranks
        self.host_tail = max(dist.world_size(group), host_tail if host_tail is not None else HOST_TAIL)

        self.names = sorted(columns)
        n = columns[self.names[0]].shape[-1]
        if n <= 0 or n & (n - 1):
            raise ValueError(f"zerocheck tables must be a power of two wide, got {n}")
        self.n = n
        self.columns = columns
        # Trace with placeholder alphas; prove() traces again with the real
        # ones and holds the structure against this one.  The program
        # depends on that structure alone; on a card its kernel starts
        # building here.
        self._probe_trace = trace_combiner(combiner, self.names, [1] * self.num_alphas, P)
        self.eq_row = len(self.names)
        row_of = {name: i for i, name in enumerate(self.names)}
        row_of["__eq__"] = self.eq_row
        self.program = dag_dev.program(self._probe_trace, [self._probe_trace.out], row_of, self.device)

    def prove(self, transcript: FiatShamirTranscript):
        from ..proofs.zerocheck import ZerocheckProof, ZerocheckProver, _fold_msb, _interp_eval

        p = P
        n = self.n
        num_vars = n.bit_length() - 1

        taus = [transcript.challenge_value(p) for _ in range(num_vars)]
        alphas = [transcript.challenge_value(p) for _ in range(self.num_alphas)]

        tr = trace_combiner(self.combiner, self.names, alphas, p)
        if tr.signature != self._probe_trace.signature:
            raise TraceError("combiner structure depends on challenge values")
        eq_row, program = self.eq_row, self.program
        consts = program.constants(tr.consts)

        # Under a group a table wider than the tail is cut cyclically over
        # the ranks: the half sums and the fold are local, the sums of a
        # round are all-reduced, and the tail is all-gathered.
        group = self.group if n > self.host_tail else None
        sharded = dist.world_size(group) > 1
        stacked = np.stack([np.asarray(self.columns[name], dtype=np.uint64) % np.uint64(p)
                            for name in self.names]).astype(np.uint32)
        stacked = np.ascontiguousarray(dist.shard_cyclic(group, stacked))
        planes = torch.empty((eq_row + 1, stacked.shape[1]), dtype=torch.int64, device=self.device)
        planes[:eq_row] = torch.from_numpy(stacked.view(np.int32)).to(self.device)
        planes[eq_row] = eq_table_device(taus, n, self.device, group)

        host = ZerocheckProver(self.F, self.columns, self.combiner, self.degree, num_alphas=self.num_alphas)
        round_evals: List[List[int]] = []
        rs: List[int] = []
        claim = 0
        launches_before = dag_dev.LAUNCHES["round_sums"]
        host_tables = None
        while len(rs) < num_vars:
            if host_tables is None and n >> len(rs) <= self.host_tail:
                arr = dist.gather_cyclic(group, planes).cpu().numpy().astype(np.uint64)
                host_tables = {name: arr[i] for i, name in enumerate(self.names)}
                host_tables["__eq__"] = arr[eq_row]
            if host_tables is not None:
                evals_this_round = host.round_values(host_tables, alphas, claim, p)
            else:
                sums = dag_dev.round_sums(program, consts, planes, self.degree, eq=eq_row)
                if sharded:
                    sums = dist.all_reduce_sum(group, sums.to(planes.device)).cpu() % p
                sums = [int(x) for x in sums[:, 0]]
                evals_this_round = [sums[0], (claim - sums[0]) % p] + sums[1:]
            round_evals.append(evals_this_round)
            for g in evals_this_round:
                transcript.append_u64(g)
            r = transcript.challenge_value(p)
            rs.append(r)
            claim = _interp_eval(evals_this_round, r, p)
            if host_tables is not None:
                host_tables = {k: _fold_msb(t, r, p) for k, t in host_tables.items()}
            else:
                planes = fold_msb(planes, r)

        finals = [int(host_tables[name][0]) for name in self.names] if host_tables is not None \
            else [int(x) for x in planes[:eq_row, 0].cpu()]
        # "__"-prefixed tables (eq, public MLEs) are verifier-computable: no
        # terminal evaluations are emitted for them.
        column_evals = {name: finals[i] for i, name in enumerate(self.names) if not name.startswith("__")}
        for name in sorted(column_evals):
            transcript.append_u64(column_evals[name])
        DEVICE_PROVES["count"] += 1
        DEVICE_PROVES["sweep_launches"] += dag_dev.LAUNCHES["round_sums"] - launches_before
        return ZerocheckProof(
            num_vars=num_vars,
            degree=self.degree,
            round_evals=round_evals,
            final_point=rs,
            column_evals=column_evals,
        )
