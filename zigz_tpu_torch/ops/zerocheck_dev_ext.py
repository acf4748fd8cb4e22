"""Extension-field zerocheck prover on a torch device.

Counterpart of zigz_tpu/ops/zerocheck_dev_ext.py and device twin of
``NativeZerocheckExtProver`` (ops/zerocheck_native_ext.py, itself the C++
twin of ``proofs.zerocheck.ZerocheckExtProver``): the combiner is traced
once (ops/symtrace.py ``trace_combiner_ext``) and the resulting base-op DAG
is evaluated with torch ops over canonical int64 planes (ops/symtrace.py
``compile_dag``, ops/ext4_dev.py).  All three provers emit byte-identical
transcripts and proofs (tests/test_torch_zerocheck.py).

Every challenge of the v2 zerochecks is drawn from BabyBear^4, so the
tables turn into 4-coordinate extension tables after the first fold.  The
fold by a round's challenge is fused into the next round's sweep (one
device step per round, one small read-back of the round sums), the
Fiat-Shamir transcript stays on the host between rounds, and the rounds at
or below ``host_tail`` width finish on the host: the planes come down once
and the same fold and sweep go on over host tensors (the JAX class runs
the numpy prover's round body there).  The tail is part of the algorithm
and does not change the bytes.

There is no size gate and no environment switch here: the caller
(``ZerocheckExtProver`` with a ``device``) sends every width n >= 2
through this class, and a ``TraceError`` or a failed launch raises.
``dev_columns`` names columns that already lie on the device as slices of
a commitment's resident matrix (``DeviceColumnRef``), so only the columns
that are in no commitment are uploaded.  ``DEVICE_PROVES`` counts the
zerochecks proven here; ``COLUMNS`` counts their base columns by origin.

Plane layouts (rows of one (rows, width) int64 tensor), chosen so that
every fold is a whole-stack operation with no transposes:

* round 0: the B base columns as single planes, then the E extension
  columns and the eq table coordinate-major, row B + e * (E + 1) + j;
* later rounds: all G = B + E + 1 tables as extension tables,
  coordinate-major, row e * G + i (base names, then extension names,
  then eq).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.ext4 import Ext4, challenge_ext, ext_from_ints
from ..device import resolve_device
from . import ext4_dev
from .babybear import P
from .symtrace import TraceError, compile_dag, trace_combiner_ext

__all__ = ["GenericDeviceZerocheckExt", "HOST_TAIL_EXT", "DEVICE_PROVES", "COLUMNS", "reset_counters"]

# Remaining-width threshold to finish the rounds on the host.
HOST_TAIL_EXT = 1 << 12

# Widest slice of the half-tables that one DAG pass evaluates (at all its
# ``degree`` points at once); wider rounds run in chunks, so the sweep's
# transient stays bounded.
SWEEP_CHUNK = 1 << 19

# Zerochecks proven by this class since the last reset, and where their
# base columns came from: a commitment's resident matrix, or an upload.
DEVICE_PROVES = {"count": 0, "sweep_launches": 0}
COLUMNS = {"resident": 0, "uploaded": 0}


def reset_counters() -> None:
    DEVICE_PROVES.update(count=0, sweep_launches=0)
    COLUMNS.update(resident=0, uploaded=0)


def _round_sums(dag, planes: torch.Tensor, degree: int):
    """g(0), g(2..degree) coordinate sums of eq * C over the current
    variable's half-split: ((degree, 4) canonical int64, DAG passes made).
    g(1) follows from the sumcheck identity on the host.  A base-field DAG
    (ops/zerocheck_gen.py) has one output and gives (degree, 1).

    The ``degree`` evaluation points are laid side by side along the width
    and go through the DAG in ONE pass: the sweep is bound by the number of
    launches, not by their width, so this divides its cost by ``degree``."""
    half = planes.shape[-1] // 2
    total, passes = None, 0
    for s in range(0, half, SWEEP_CHUNK):
        lo = planes[:, s : min(s + SWEEP_CHUNK, half)]
        hi = planes[:, half + s : half + min(s + SWEEP_CHUNK, half)]
        points = [lo]
        if degree >= 2:
            delta = (hi - lo) % P
            cur = hi
            for _t in range(2, degree + 1):
                cur = (cur + delta) % P
                points.append(cur)
        out = torch.stack(dag(torch.cat(points, dim=-1)))  # (4, degree * chunk)
        # a width below 2^32 sums below 2^63
        part = out.view(out.shape[0], len(points), -1).sum(dim=-1).t() % P
        total = part if total is None else (total + part) % P
        passes += 1
    return total, passes


class GenericDeviceZerocheckExt:
    """Device twin of ``proofs.zerocheck.ZerocheckExtProver``.

    ``columns`` values: base canonical uint64 numpy arrays or Ext4 arrays;
    ``dev_columns`` maps base column names to ``DeviceColumnRef`` slices of
    a matrix on ``device``.  Construction traces the combiner: a
    ``TraceError`` propagates before the transcript is touched."""

    def __init__(self, F, columns: Dict[str, np.ndarray], combiner, degree: int,
                 num_alphas: int = None, dev_columns: Optional[Dict[str, object]] = None,
                 host_tail: int = None, *, device):
        if F.MODULUS != P:
            raise ValueError(f"the device ext zerocheck is BabyBear-only (p = {P}), not {F.MODULUS}")
        self.F = F
        self.device = resolve_device(device)
        self.combiner = combiner
        self.degree = degree
        self.num_alphas = num_alphas if num_alphas is not None else len(columns)
        self.columns = columns
        self.dev_columns = dev_columns or {}
        self.host_tail = max(2, host_tail if host_tail is not None else HOST_TAIL_EXT)
        self.base_names = sorted(n for n, c in columns.items() if not isinstance(c, Ext4))
        self.ext_names = sorted(n for n, c in columns.items() if isinstance(c, Ext4))
        widths = {(c.shape[-1] if isinstance(c, Ext4) else np.shape(c)[-1]) for c in columns.values()}
        if len(widths) != 1:
            raise ValueError(f"zerocheck tables must be equal width, got {sorted(widths)}")
        n = widths.pop()
        if n < 2 or n & (n - 1):
            raise ValueError(f"zerocheck tables must be a power of two >= 2 wide, got {n}")
        self.n = n
        probe = [ext_from_ints([1, 0, 0, 0])] * self.num_alphas
        self._probe1 = trace_combiner_ext(combiner, self.base_names, self.ext_names, probe, P,
                                          lift_base=False)
        self._probe2 = trace_combiner_ext(combiner, self.base_names, self.ext_names, probe, P,
                                          lift_base=True)

    # ------------------------------------------------------------------
    def _row_maps(self):
        B, E = len(self.base_names), len(self.ext_names)
        row_of1: Dict[str, int] = {f"{name}#0": i for i, name in enumerate(self.base_names)}
        for j, name in enumerate(self.ext_names + ["__eq__"]):
            for e in range(4):
                row_of1[f"{name}#{e}"] = B + e * (E + 1) + j
        G = B + E + 1
        row_of2: Dict[str, int] = {}
        for i, name in enumerate(self.base_names + self.ext_names + ["__eq__"]):
            for e in range(4):
                row_of2[f"{name}#{e}"] = e * G + i
        return row_of1, row_of2

    def _assemble(self, taus) -> torch.Tensor:
        """The round-0 plane stack (B + 4 (E + 1), n) on the device:
        resident columns are sliced where they lie, the other base columns
        and the extension columns are uploaded as one stacked u32 matrix,
        and the eq table is built on the device from the taus."""
        n, dev = self.n, self.device
        B, E = len(self.base_names), len(self.ext_names)
        planes = torch.empty((B + 4 * (E + 1), n), dtype=torch.int64, device=dev)
        host_rows, host_at = [], []
        for i, name in enumerate(self.base_names):
            ref = self.dev_columns.get(name)
            if ref is not None and ref.length == n:
                if ref.mat.device != dev:
                    raise ValueError(f"column {name} lies on {ref.mat.device}, the zerocheck on {dev}")
                planes[i] = ref.resolve()
                COLUMNS["resident"] += 1
                continue
            arr = np.asarray(self.columns[name], dtype=np.uint64)
            if int(arr.max(initial=0)) >= P:
                arr = arr % np.uint64(P)
            host_rows.append(arr.astype(np.uint32))
            host_at.append(i)
            COLUMNS["uploaded"] += 1
        for j, name in enumerate(self.ext_names):
            coords = np.asarray(self.columns[name].c, dtype=np.uint64).astype(np.uint32)
            for e in range(4):
                host_rows.append(coords[e])
                host_at.append(B + e * (E + 1) + j)
        if host_rows:
            host = torch.from_numpy(np.stack(host_rows).view(np.int32)).to(dev)
            planes[torch.tensor(host_at, device=dev)] = host.to(torch.int64)
        planes[B + E :: E + 1] = ext4_dev.ext_eq_table_dev(taus, n, dev)
        return planes

    # ------------------------------------------------------------------
    def prove(self, transcript):
        from ..proofs.zerocheck import ZerocheckProof, _interp_eval_ext, absorb_ext

        p = P
        n = self.n
        num_vars = n.bit_length() - 1

        taus = [challenge_ext(transcript) for _ in range(num_vars)]
        alphas = [challenge_ext(transcript) for _ in range(self.num_alphas)]

        tr1 = trace_combiner_ext(self.combiner, self.base_names, self.ext_names, alphas, p,
                                 lift_base=False)
        tr2 = trace_combiner_ext(self.combiner, self.base_names, self.ext_names, alphas, p,
                                 lift_base=True)
        if tr1.signature != self._probe1.signature or tr2.signature != self._probe2.signature:
            raise TraceError("combiner structure depends on challenge values")

        row_of1, row_of2 = self._row_maps()
        dag1 = compile_dag(tr1.nodes, tr1.outs, row_of1, tr1.consts)
        dag2 = compile_dag(tr2.nodes, tr2.outs, row_of2, tr2.consts)

        B, E = len(self.base_names), len(self.ext_names)
        G = B + E + 1
        planes = self._assemble(taus)

        round_evals: List[List[Ext4]] = []
        rs: List[Ext4] = []
        claim = Ext4.zeros()

        def emit_round(sums: torch.Tensor):
            nonlocal claim
            sums_np = sums.cpu().numpy()
            g0 = ext_from_ints([int(x) for x in sums_np[0]])
            evals_this_round = [g0, claim - g0]
            for t in range(2, self.degree + 1):
                evals_this_round.append(ext_from_ints([int(x) for x in sums_np[t - 1]]))
            round_evals.append(evals_this_round)
            for g in evals_this_round:
                absorb_ext(transcript, g)
            r = challenge_ext(transcript)
            rs.append(r)
            claim = _interp_eval_ext(evals_this_round, r, p)
            return r

        def fold(planes: torch.Tensor, r, first: bool) -> torch.Tensor:
            """Fold every table by r -> the all-extension layout (4 G, width / 2)."""
            r4 = r.to_ints()
            if first:
                base = ext4_dev.ext_fold_base_dev(planes[:B], r4)  # (4, B, half)
                ext = ext4_dev.ext_fold_dev(planes[B:].view(4, E + 1, -1), r4)
                folded = torch.cat([base, ext], dim=1)
            else:
                folded = ext4_dev.ext_fold_dev(planes.view(4, G, -1), r4)
            return folded.reshape(4 * G, -1)

        # Round 0 on the round-0 layout; every later round folds by the
        # pending challenge and sweeps the halved, all-extension tables.  At
        # ``host_tail`` width the planes come down once and the same loop
        # goes on over host tensors: a narrow round costs a launch per DAG
        # op wherever it runs, and the host issues them faster than it can
        # queue them on a card.
        sums, passes = _round_sums(dag1, planes, self.degree)
        launches = dag1.num_launches * passes
        r = emit_round(sums)
        for rnd in range(1, num_vars):
            if n >> rnd <= self.host_tail and planes.device.type != "cpu":
                planes = planes.cpu()
            planes = fold(planes, r, first=rnd == 1)
            sums, passes = _round_sums(dag2, planes, self.degree)
            if planes.device.type != "cpu":
                launches += dag2.num_launches * passes
            r = emit_round(sums)
        final = ext4_dev.ext_from_device(fold(planes, r, first=num_vars == 1)).reshape(4, G)
        # "__"-prefixed tables (eq, public MLEs) are verifier-computable: no
        # terminal evaluations are emitted for them.
        column_evals = {name: Ext4(final[:, i]) for i, name in enumerate(self.base_names + self.ext_names)
                        if not name.startswith("__")}

        for name in sorted(column_evals):
            absorb_ext(transcript, column_evals[name])
        DEVICE_PROVES["count"] += 1
        DEVICE_PROVES["sweep_launches"] += launches
        return ZerocheckProof(
            num_vars=num_vars,
            degree=self.degree,
            round_evals=round_evals,
            final_point=rs,
            column_evals=column_evals,
        )
