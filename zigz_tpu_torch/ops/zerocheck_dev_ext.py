"""Extension-field zerocheck prover on a torch device.

Counterpart of zigz_tpu/ops/zerocheck_dev_ext.py and device twin of
``NativeZerocheckExtProver`` (ops/zerocheck_native_ext.py, itself the C++
twin of ``proofs.zerocheck.ZerocheckExtProver``): the combiner is traced
once (ops/symtrace.py ``trace_combiner_ext``), the resulting base-op DAG is
lowered to the round-sum kernel's program (``compile_device``), and each
round on a card is two launches and one small read-back: Z1 gives the
round's sums at every point over the whole width (ops/dag_dev.py
``round_sums``, a kernel generated for the program by ops/dag_codegen.py),
Z2 folds every table by the round's challenge into the next round's layout
(ops/ext4_dev.py ``fold_planes``, csrc/zerocheck_kernels.cu).  The two
programs of a zerocheck (round 0, later rounds) are found or lowered from
the probe traces when the prover is constructed (``dag_dev.program``, once
per DAG signature in a process), and on a card their kernels' builds start
there; the first round waits for them.  prover/unified.py constructs the
provers right after each argument's advice phase
(``ZerocheckExtProver.start``).  All
three provers emit byte-identical transcripts and proofs
(tests/test_torch_zerocheck.py).

Every challenge of the v2 zerochecks is drawn from BabyBear^4, so the
tables turn into 4-coordinate extension tables after the first fold.  The
Fiat-Shamir transcript stays on the host between rounds.  Rounds at or
below ``host_tail`` width (none by default) finish on the host: the planes
come down once and the same fold and sweep go on over host tensors,
through the plain versions of Z1 and Z2.  The tail does not change the
bytes.

There is no size gate and no environment switch here: the caller
(``ZerocheckExtProver`` with a ``device``) sends every width n >= 2
through this class, and a ``TraceError`` or a failed launch raises.
``dev_columns`` names columns that already lie on the device as slices of
a commitment's resident matrix (``DeviceColumnRef``), so only the columns
that are in no commitment are uploaded.  ``DEVICE_PROVES`` counts the
zerochecks proven here, the launches of Z1 and Z2 they made, the seconds
they waited on nvcc for Z1's generated kernels (``dag_build_s``) and the
seconds of their host tracing, lowering and generation
(``zerocheck_host_s``); ``COLUMNS`` counts their base columns by origin.

Plane layouts (rows of one (rows, width) int64 tensor), chosen so that
every fold is a whole-stack operation with no transposes:

* round 0: the B base columns as single planes, then the E extension
  columns and the eq table coordinate-major, row B + e * (E + 1) + j;
* later rounds: all G = B + E + 1 tables as extension tables,
  coordinate-major, row e * G + i (base names, then extension names,
  then eq).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.ext4 import Ext4, challenge_ext, ext_from_ints
from ..device import resolve_device
from ..utils.profiling import counter_table
from . import dag_dev, ext4_dev
from .babybear import P
from .symtrace import TraceError, trace_combiner_ext

__all__ = ["GenericDeviceZerocheckExt", "HOST_TAIL_EXT", "DEVICE_PROVES", "COLUMNS", "reset_counters", "fold_groups"]

# Remaining-width threshold to finish the rounds on the host.  1: every
# round of a card zerocheck runs on the card, two launches a round; with the
# threshold at 2^12 the narrow rounds ran compile_dag's torch ops on the host,
# and a v2 prove of 2^20 NOP steps spent 3.42-3.55 s in its zerochecks
# against 1.17-1.30 s (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md).
HOST_TAIL_EXT = 1

# Zerochecks proven by this class since the last reset, the launches of Z1
# and Z2 they made, their waits on nvcc and their host tracing, lowering and
# generation (seconds), and where their base columns came from: a
# commitment's resident matrix, or an upload.
DEVICE_PROVES = counter_table("zerocheck", ["count", "sweep_launches", "dag_build_s", "zerocheck_host_s"])
COLUMNS = counter_table("zerocheck_columns", ["resident", "uploaded"])


def reset_counters() -> None:
    DEVICE_PROVES.update(count=0, sweep_launches=0, dag_build_s=0.0, zerocheck_host_s=0.0)
    COLUMNS.update(resident=0, uploaded=0)


def fold_groups(B: int, E: int):
    """Where each of the G = B + E + 1 tables lies before a fold, for
    ``ext4_dev.fold_planes``: (round-0 layout, all-extension layout)."""
    G = B + E + 1
    first = ext4_dev.FoldGroups([(0, i, 0, 0, 0) for i in range(B)]
                                + [(1, *(B + e * (E + 1) + j for e in range(4))) for j in range(E + 1)])
    return first, ext4_dev.FoldGroups([(1, *(e * G + i for e in range(4))) for i in range(G)])


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
        self.host_tail = max(1, host_tail if host_tail is not None else HOST_TAIL_EXT)
        self.base_names = sorted(n for n, c in columns.items() if not isinstance(c, Ext4))
        self.ext_names = sorted(n for n, c in columns.items() if isinstance(c, Ext4))
        widths = {(c.shape[-1] if isinstance(c, Ext4) else np.shape(c)[-1]) for c in columns.values()}
        if len(widths) != 1:
            raise ValueError(f"zerocheck tables must be equal width, got {sorted(widths)}")
        n = widths.pop()
        if n < 2 or n & (n - 1):
            raise ValueError(f"zerocheck tables must be a power of two >= 2 wide, got {n}")
        self.n = n
        t0 = time.perf_counter()
        probe = [ext_from_ints([1, 0, 0, 0])] * self.num_alphas
        self._probe1 = trace_combiner_ext(combiner, self.base_names, self.ext_names, probe, P,
                                          lift_base=False)
        self._probe2 = trace_combiner_ext(combiner, self.base_names, self.ext_names, probe, P,
                                          lift_base=True)
        # The programs depend on the DAGs' structure alone, which prove()
        # holds equal to the probes'; on a card their kernels start building.
        self.programs = tuple(dag_dev.program(tr, tr.outs, row_of, self.device)
                              for tr, row_of in zip((self._probe1, self._probe2), self._row_maps()))
        DEVICE_PROVES["zerocheck_host_s"] += time.perf_counter() - t0

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

        t0 = time.perf_counter()
        tr1 = trace_combiner_ext(self.combiner, self.base_names, self.ext_names, alphas, p,
                                 lift_base=False)
        tr2 = trace_combiner_ext(self.combiner, self.base_names, self.ext_names, alphas, p,
                                 lift_base=True)
        if tr1.signature != self._probe1.signature or tr2.signature != self._probe2.signature:
            raise TraceError("combiner structure depends on challenge values")

        program1, program2 = self.programs
        consts1, consts2 = program1.constants(tr1.consts), program2.constants(tr2.consts)
        DEVICE_PROVES["zerocheck_host_s"] += time.perf_counter() - t0

        B, E = len(self.base_names), len(self.ext_names)
        G = B + E + 1
        first_groups, ext_groups = fold_groups(B, E)
        launches_before = dag_dev.LAUNCHES["round_sums"] + ext4_dev.LAUNCHES["fold_planes"]
        waited_before = dag_dev.WAITED["build_s"]
        planes = self._assemble(taus)

        round_evals: List[List[Ext4]] = []
        rs: List[Ext4] = []
        claim = Ext4.zeros()

        def emit_round(sums: torch.Tensor):
            nonlocal claim
            sums_np = sums.numpy()
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
            return ext4_dev.fold_planes(planes, r.to_ints(), first_groups if first else ext_groups)

        # Round 0 on the round-0 layout; every later round folds by the
        # pending challenge and sweeps the halved, all-extension tables.  At
        # ``host_tail`` width the planes come down once and the same loop
        # goes on over host tensors.
        r = emit_round(dag_dev.round_sums(program1, consts1, planes, self.degree))
        for rnd in range(1, num_vars):
            if n >> rnd <= self.host_tail and planes.device.type != "cpu":
                planes = planes.cpu()
            planes = fold(planes, r, first=rnd == 1)
            r = emit_round(dag_dev.round_sums(program2, consts2, planes, self.degree))
        final = ext4_dev.ext_from_device(fold(planes, r, first=num_vars == 1)).reshape(4, G)
        # "__"-prefixed tables (eq, public MLEs) are verifier-computable: no
        # terminal evaluations are emitted for them.
        column_evals = {name: Ext4(final[:, i]) for i, name in enumerate(self.base_names + self.ext_names)
                        if not name.startswith("__")}

        for name in sorted(column_evals):
            absorb_ext(transcript, column_evals[name])
        DEVICE_PROVES["count"] += 1
        DEVICE_PROVES["sweep_launches"] += (dag_dev.LAUNCHES["round_sums"] + ext4_dev.LAUNCHES["fold_planes"]
                                            - launches_before)
        DEVICE_PROVES["dag_build_s"] += dag_dev.WAITED["build_s"] - waited_before
        return ZerocheckProof(
            num_vars=num_vars,
            degree=self.degree,
            round_evals=round_evals,
            final_point=rs,
            column_evals=column_evals,
        )
