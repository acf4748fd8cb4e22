"""The v2 unified commitment harness with its Ligero commits on a torch device.

Counterpart of zigz_tpu/prover/unified.py ``prove_unified``, with the same
transcript schedule (DATA commit, ADVICE commit, zerochecks, batch-eval
reduction, two openings) and the same ``timings`` keys.  The arguments'
phases, their zerochecks, the batch-eval sumcheck and the openings are
zigz_tpu's host code, reused by import; the two commitments are the port's
``ligero_commit_mixed``, whose leaf hashing runs in the K5 kernel.

Not ported here: the mesh path (slice 5) and the device advice builders
(ops/advice_dev, ROADMAP A12), so ``advice_dev_cols`` is 0 and the ADVICE
matrix is uploaded from the host like the DATA matrix.  The proof bytes do
not depend on either.  zigz_tpu's zerochecks receive no device columns
(the port's commit states offer none), so they take their native C++
provers.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

from zigz_tpu.commitments.ligero import LigeroCommitState, ligero_prove_mixed
from zigz_tpu.proofs.batch_eval import mixed_claim_from_rho, prove_batch_eval
from zigz_tpu.prover.unified import ClaimSink, UnifiedProof, _namespace

from ..commitments.ligero import ligero_commit_mixed
from ..device import resolve_device, synchronize

__all__ = ["prove_unified"]


def _commit(F, key: str, columns, hash_mode, device, timings) -> LigeroCommitState:
    t0 = time.perf_counter()
    state = ligero_commit_mixed(F, columns, hash_mode, device=device)
    if timings is not None:
        timings[f"{key}_commit_s"] = time.perf_counter() - t0
        timings[f"{key}_commit_path"] = state.commit_path
        timings.update({f"{key}_{name}": seconds for name, seconds in state.commit_timings.items()})
    return state


def prove_unified(F, transcript, args: List, hash_mode: str = "sha3",
                  timings: Optional[dict] = None, *, device) -> UnifiedProof:
    device = resolve_device(device)
    data_full: Dict[str, np.ndarray] = {}
    for a in args:
        a.locmap = getattr(a, "locmap", {})
        _namespace(a, a.data_phase(transcript), "data", data_full)

    data_state = None
    if data_full:
        data_state = _commit(F, "data", data_full, hash_mode, device, timings)
        transcript.append_bytes(b"V2_DATA")
        transcript.append_bytes(data_state.root)

    advice_full: Dict[str, np.ndarray] = {}
    t0 = time.perf_counter()
    for a in args:
        _namespace(a, a.advice_phase(transcript), "advice", advice_full)
    if timings is not None:
        timings["advice_build_s"] = time.perf_counter() - t0
        if data_state is not None and advice_full:
            timings["advice_dev_s"] = 0.0
            timings["advice_dev_cols"] = 0

    advice_state = None
    if advice_full:
        advice_state = _commit(F, "advice", advice_full, hash_mode, device, timings)
        transcript.append_bytes(b"V2_ADVICE")
        transcript.append_bytes(advice_state.root)

    sink = ClaimSink()
    t0 = time.perf_counter()
    states = {"data": data_state, "advice": advice_state}
    for a in args:
        a._unified_states = states
    for a in args:
        a.zerocheck_phase(transcript, sink)
    if timings is not None:
        timings["zerochecks_s"] = time.perf_counter() - t0

    batch = None
    opened = {"data": None, "advice": None}
    if sink.claims:
        columns = {("data", fn): arr for fn, arr in data_full.items()}
        columns.update({("advice", fn): arr for fn, arr in advice_full.items()})
        t0 = time.perf_counter()
        batch = prove_batch_eval(sink.claims, columns, transcript)
        if timings is not None:
            timings["batch_eval_s"] = time.perf_counter() - t0
        rho = batch.final_point
        t0 = time.perf_counter()
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
            timings["open_s"] = time.perf_counter() - t0

    return UnifiedProof(
        data_root=data_state.root if data_state is not None else None,
        advice_root=advice_state.root if advice_state is not None else None,
        batch=batch,
        data_open=opened["data"],
        advice_open=opened["advice"],
    )
