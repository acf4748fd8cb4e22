"""Unified commitment harness for the v2+ argument pipeline (round 3).

Round 2 gave every argument (pc-chain logUp, lookup validity, regcheck,
memcheck, bytecode, linkage) its own Ligero commitments and its own
openings — ~20 commitments x (128 opened columns + Merkle paths +
extension query/proximity rows) per proof.  This harness restructures the
pipeline into the standard phased schedule so those costs are paid ONCE:

  1. DATA    — every argument absorbs its public block and returns its
               challenge-independent columns; ONE mixed-length Ligero
               commitment binds them all ("V2_DATA" + root).
  2. ADVICE  — every argument draws its fingerprint challenges (nonce
               retry loops fork the transcript as before) and returns its
               logUp inverse / multiplicity-inverse columns as base
               coordinate columns; ONE commitment binds them
               ("V2_ADVICE" + root) after the per-argument sums are
               absorbed.
  3. ZEROCHECKS — unchanged per-argument extension zerochecks (their
               round polynomials and terminal column evals bind to the
               transcript), each registering its terminal evaluation
               claims and hypercube-sum claims with the claim sink.
  4. REDUCE  — one batch-evaluation sumcheck (proofs/batch_eval.py)
               folds every claim to a single point rho.
  5. OPEN    — each commitment is opened once with a LigeroMixedClaim
               whose weights both sides derive from rho.

An Argument object implements data_phase/advice_phase/zerocheck_phase on
the prover side (and ``zerochecks``, the provers its zerocheck phase runs)
and the same trio on the verifier side (replaying
absorbs, re-deriving challenges from the proof-carried nonce, verifying
zerochecks, and registering the SAME claims).  Cross-argument data
(e.g. the bytecode argument referencing regcheck's committed operand
columns) flows through a shared ``ctx`` dict and the per-argument
``locmap`` (local name -> (commitment key, namespaced name, num_vars)).

The standalone prove_regcheck/verify_regcheck (etc.) entry points reuse
this harness with a single argument, so each argument keeps its own
self-contained test surface.

Counterpart of zigz_tpu/prover/unified.py with the device work on a torch
device: ``prove_unified`` takes an explicit ``device``, the two
commitments are encoded and column-hashed there (commitments/ligero.py,
the K5 kernel), and every argument is handed the device next to the commit
states, so its zerochecks run on ``GenericDeviceZerocheckExt`` and read
the committed columns from the resident matrices.  The transcript
schedule and the ``timings`` keys are the JAX package's.  The arguments'
``device_advice`` hooks rebuild their ADVICE columns on the device
(ops/advice_dev.py) for the advice commit; ``advice_dev_s`` and
``advice_dev_cols`` time and count them.  With a ``group``
(parallel/multihost.py ``TraceGroup``) the two commits and the batch
evaluation run sharded over its ranks where their size predicates hold
(``*_commit_sharded``, ``batch_eval_sharded``, ``open_sharded`` in
``timings`` say what ran); the device advice twins are then off, and the
extension zerochecks run whole on every rank (``zerochecks_sharded`` is
False), as in the JAX package.  Each argument's zerochecks are made right
after its advice phase (``zerochecks``, ``ZerocheckExtProver.start``): on
a card their generated round-sum kernels start building there, and
``zerocheck_start_s`` times that (tracing, lowering, generation, starting
nvcc).  Inside ``zerochecks_s``, ``dag_build_s`` is the time the
zerochecks waited on nvcc for those kernels (0 once they are built) and
``zerocheck_host_s`` their host tracing and constant folding
(ops/zerocheck_dev_ext.py ``DEVICE_PROVES``).  ``data_build``, ``advice_build``
and ``zerochecks`` hold one leaf span per argument, named by its ``ns``
(keys ``<phase>_<ns>_s``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from ..commitments.ligero import (
    LigeroCommitState,
    LigeroEvalProof,
    LigeroParams,
    choose_split_mixed,
    ligero_commit_mixed,
    ligero_prove_mixed,
    ligero_verify_mixed,
)
from ..core.ext4 import Ext4
from ..device import resolve_device, synchronize
from ..ops import zerocheck_dev_ext
from ..proofs.batch_eval import (
    BatchClaim,
    BatchEvalProof,
    mixed_claim_from_rho,
    prove_batch_eval,
    verify_batch_eval,
)
from ..utils.profiling import span

__all__ = ["ClaimSink", "UnifiedProof", "prove_unified", "verify_unified"]


class ClaimSink:
    """Ordered claim collector shared by all arguments of one proof."""

    def __init__(self):
        self.claims: List[BatchClaim] = []

    def eval_claim(self, commit_key: str, name: str, num_vars: int,
                   point: List[Ext4], value: Ext4) -> None:
        self.claims.append(BatchClaim(commit_key, name, num_vars, point, value))

    def sum_claim(self, commit_key: str, name: str, num_vars: int,
                  value: Ext4) -> None:
        self.claims.append(BatchClaim(commit_key, name, num_vars, None, value))


@dataclass
class UnifiedProof:
    data_root: Optional[bytes]
    advice_root: Optional[bytes]
    batch: Optional[BatchEvalProof]
    data_open: Optional[LigeroEvalProof]
    advice_open: Optional[LigeroEvalProof]


def _namespace(arg, cols: Dict[str, np.ndarray], commit_key: str,
               full: Dict[str, np.ndarray]) -> None:
    for local, arr in cols.items():
        fn = f"{arg.ns}:{local}"
        assert fn not in full, f"duplicate column {fn}"
        ln = len(arr)
        assert ln & (ln - 1) == 0 and ln >= 1, \
            f"column {fn} must be a power-of-two length >= 1 (got {ln})"
        arg.locmap[local] = (commit_key, fn, ln.bit_length() - 1)
        full[fn] = arr


def _commit(F, key: str, columns, hash_mode, device, timings, dev_columns=None, group=None) -> LigeroCommitState:
    with span(f"{key}_commit") as sp:
        state = ligero_commit_mixed(F, columns, hash_mode, device=device, dev_columns=dev_columns, group=group)
    if timings is not None:
        timings[f"{key}_commit_s"] = sp.seconds
        timings[f"{key}_commit_path"] = state.commit_path
        if group is not None:
            timings[f"{key}_commit_sharded"] = state.commit_path == "mesh"
        shape = (state.matrix.shape[0], state.n, state.n_e)  # total_rows, n, n_e
        timings[f"{key}_commit_shape"] = shape
        # the same as numbers, which a reader of the timings keeps and a tuple is not
        timings.update(zip((f"{key}_commit_rows", f"{key}_commit_n", f"{key}_commit_n_e"), map(int, shape)))
        timings.update({f"{key}_{name}": seconds for name, seconds in state.commit_timings.items()})
    return state


def prove_unified(F, transcript, args: List, hash_mode: str = "sha3",
                  timings: Optional[dict] = None, *, device, group=None) -> UnifiedProof:
    """With a ``group`` the DATA and ADVICE commits (commitments/ligero.py,
    ops/ligero_mesh.py) and the batch-evaluation rounds
    (ops/batch_eval_dev.py) run sharded over its ranks; the proof bytes are
    those of the unsharded path."""
    device = resolve_device(device)
    if group is not None and group.device != device:
        raise ValueError(f"group on {group.device}, prove on {device}")
    data_full: Dict[str, np.ndarray] = {}
    with span("data_build", outer=True) as data_span:
        data_s = {}
        for a in args:
            a.locmap = getattr(a, "locmap", {})
            a._unified_device = device
            with span(a.ns) as sp:
                cols = a.data_phase(transcript)
            data_s[a.ns] = sp.seconds
            _namespace(a, cols, "data", data_full)
    if timings is not None:
        timings["data_build_s"] = data_span.seconds
        timings.update({f"data_build_{ns}_s": seconds for ns, seconds in data_s.items()})

    data_state = None
    if data_full:
        data_state = _commit(F, "data", data_full, hash_mode, device, timings, group=group)
        transcript.append_bytes(b"V2_DATA")
        transcript.append_bytes(data_state.root)

    advice_full: Dict[str, np.ndarray] = {}
    start_s: List[float] = []
    advice_s = {}
    with span("advice_build", outer=True) as advice_span:
        for a in args:
            with span(a.ns) as sp:
                cols = a.advice_phase(transcript)
            advice_s[a.ns] = sp.seconds
            _namespace(a, cols, "advice", advice_full)
            # The argument's zerochecks can be made now that its challenges are
            # drawn: on a card each one's round-sum kernels start building
            # (ops/dag_dev.py), beside the later advice phases and both commits.
            with span("zerocheck_start") as sp:
                for zc in a.zerochecks:
                    zc.start()
            start_s.append(sp.seconds)
    if timings is not None:
        timings["advice_build_s"] = advice_span.seconds - sum(start_s)
        timings["zerocheck_start_s"] = sum(start_s)
        timings.update({f"advice_build_{ns}_s": seconds for ns, seconds in advice_s.items()})

    # Device twins of the advice columns (ops/advice_dev.py): rebuilt on the
    # device from the resident data matrix + the host-resolved challenges, so
    # the advice commit stitches them into its device matrix and uploads only
    # the host-built rest.  The host columns above stay authoritative for
    # the transcript sums, the batch evaluation and the openings' host
    # matrix; bit-equality of the twins is guaranteed by exact mod-p
    # arithmetic (tests/test_torch_advice.py).  A twin that fails makes
    # the prove fail: there is no way back to the host upload.  Under a
    # group the twins are off and the advice rows upload from the host: no
    # rank holds the whole DATA matrix they would read.
    advice_dev: Dict[str, object] = {}
    if group is None and data_state is not None and advice_full:
        with span("advice_dev") as sp:
            for a in args:
                build = getattr(a, "device_advice", None)
                if build is None:
                    continue
                for local, arr in build(data_state).items():
                    advice_dev[f"{a.ns}:{local}"] = arr
            synchronize(device)
        if timings is not None:
            timings["advice_dev_s"] = sp.seconds
            timings["advice_dev_cols"] = len(advice_dev)

    advice_state = None
    if advice_full:
        advice_state = _commit(F, "advice", advice_full, hash_mode, device, timings,
                               dev_columns=advice_dev or None, group=group)
        del advice_dev
        transcript.append_bytes(b"V2_ADVICE")
        transcript.append_bytes(advice_state.root)

    sink = ClaimSink()
    zc_before = dict(zerocheck_dev_ext.DEVICE_PROVES)
    states = {"data": data_state, "advice": advice_state}
    for a in args:
        a._unified_states = states
    zc_s = {}
    with span("zerochecks", outer=True) as sp:
        for a in args:
            with span(a.ns) as leaf:
                a.zerocheck_phase(transcript, sink)
            zc_s[a.ns] = leaf.seconds
    if timings is not None:
        timings["zerochecks_s"] = sp.seconds
        timings.update({f"zerochecks_{ns}_s": seconds for ns, seconds in zc_s.items()})
        for key in ("dag_build_s", "zerocheck_host_s"):
            timings[key] = zerocheck_dev_ext.DEVICE_PROVES[key] - zc_before[key]
        if group is not None:
            timings["zerochecks_sharded"] = False  # no group reaches the extension zerochecks

    batch = None
    opened = {"data": None, "advice": None}
    if sink.claims:
        columns = {("data", fn): arr for fn, arr in data_full.items()}
        columns.update({("advice", fn): arr for fn, arr in advice_full.items()})
        with span("batch_eval") as sp:
            batch = prove_batch_eval(sink.claims, columns, transcript, group=group,
                                     timings=timings if group is not None else None)
        if timings is not None:
            timings["batch_eval_s"] = sp.seconds
        rho = batch.final_point
        with span("open") as sp:
            for key, state in states.items():
                if state is None:
                    continue
                evals = {fn: v for (ck, fn), v in batch.column_evals.items() if ck == key}
                if not evals:
                    continue
                claim = mixed_claim_from_rho(state.col_vars, state.cn, rho, evals)
                opened[key] = ligero_prove_mixed(state, [claim], transcript)
            synchronize(device)
        if timings is not None:
            timings["open_s"] = sp.seconds
            if group is not None:
                timings["open_sharded"] = any(
                    opened[key] is not None and state.commit_path == "mesh"
                    for key, state in states.items() if state is not None)

    return UnifiedProof(
        data_root=data_state.root if data_state is not None else None,
        advice_root=advice_state.root if advice_state is not None else None,
        batch=batch,
        data_open=opened["data"],
        advice_open=opened["advice"],
    )


def verify_unified(F, transcript, args: List, proof: UnifiedProof,
                   hash_mode: str = "sha3") -> Optional[str]:
    """Mirror of prove_unified.  Verifier-side arguments implement:
    data_phase(t) -> {local: num_vars} (replaying the public absorbs and
    returning the STRUCTURAL column sizes), advice_phase(t) -> same for
    advice columns (replaying nonce/challenges/sums and checking the
    grand logUp equations), zerocheck_phase(t, sink) -> bool (verifying
    its zerochecks and registering the same claims).

    Returns None on success, or the failing stage: an argument's ``ns``
    or "__commit__" (root/claim structure), "__batch__" (batch-eval
    reduction), "__open__" (Ligero opening)."""
    if not isinstance(proof, UnifiedProof):
        return "__commit__"
    data_vars: Dict[str, int] = {}
    for a in args:
        a.locmap = getattr(a, "locmap", {})
        shape = a.data_phase(transcript)
        if shape is None:
            return a.ns
        for local, v in shape.items():
            fn = f"{a.ns}:{local}"
            if fn in data_vars or v < 0:
                return a.ns
            a.locmap[local] = ("data", fn, v)
            data_vars[fn] = v

    if bool(data_vars) != (proof.data_root is not None):
        return "__commit__"
    if data_vars:
        transcript.append_bytes(b"V2_DATA")
        transcript.append_bytes(proof.data_root)

    advice_vars: Dict[str, int] = {}
    for a in args:
        shape = a.advice_phase(transcript)
        if shape is None:
            return a.ns
        for local, v in shape.items():
            fn = f"{a.ns}:{local}"
            if fn in advice_vars or v < 0:
                return a.ns
            a.locmap[local] = ("advice", fn, v)
            advice_vars[fn] = v

    if bool(advice_vars) != (proof.advice_root is not None):
        return "__commit__"
    if advice_vars:
        transcript.append_bytes(b"V2_ADVICE")
        transcript.append_bytes(proof.advice_root)

    sink = ClaimSink()
    for a in args:
        if not a.zerocheck_phase(transcript, sink):
            return a.ns

    if not sink.claims:
        if proof.batch is None and proof.data_open is None \
                and proof.advice_open is None:
            return None
        return "__commit__"

    # Structural check: every claim must reference a committed column of
    # the declared width.
    all_vars = {("data", fn): v for fn, v in data_vars.items()}
    all_vars.update({("advice", fn): v for fn, v in advice_vars.items()})
    for c in sink.claims:
        if all_vars.get((c.commitment, c.name)) != c.num_vars:
            return "__commit__"

    if proof.batch is None:
        return "__batch__"
    if not verify_batch_eval(sink.claims, proof.batch, transcript):
        return "__batch__"

    rho = proof.batch.final_point
    params = LigeroParams()
    for key, root, col_vars, opened in (
        ("data", proof.data_root, data_vars, proof.data_open),
        ("advice", proof.advice_root, advice_vars, proof.advice_open),
    ):
        evals = {fn: v for (ck, fn), v in proof.batch.column_evals.items()
                 if ck == key}
        if not evals:
            if opened is not None:
                return "__open__"
            continue
        if opened is None or root is None:
            return "__open__"
        cn = choose_split_mixed(sum(1 << v for v in col_vars.values()), 1, params)
        claim = mixed_claim_from_rho(col_vars, cn, rho, evals)
        if not ligero_verify_mixed(F, root, col_vars, [claim], opened,
                                   transcript, hash_mode):
            return "__open__"
    return None
