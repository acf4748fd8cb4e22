"""Device-built logUp advice columns for the unified v2 commitment.

Counterpart of zigz_tpu/ops/advice_dev.py.  The ADVICE columns are
BabyBear^4 inverse columns of fingerprints of committed DATA columns.  This
module rebuilds them ON THE DEVICE from the resident data-commit matrix plus
the (host-resolved) challenges, so the advice Ligero commitment stitches its
device matrix from tensors that are already there and uploads only the rows
the host alone has (commitments/ligero.py ``_assemble_mat_dev``).

Division of labor (prover/unified.py), as in the JAX package:

* the HOST advice phase stays authoritative: it resolves the nonce,
  absorbs the per-column sums into the transcript, and its numpy/C++ columns
  keep feeding the batch evaluation and the openings' host matrix;
* the DEVICE twin here rebuilds the same columns for the commitment.  Every
  operation is exact arithmetic mod p and field inversion is a unique
  function, so the device columns are bit-equal to the host's
  (tests/test_torch_advice.py); a mismatch would surface as a self-rejecting
  proof, never as a silently wrong one.

Plain torch ops on canonical int64 over ops/ext4_dev.py (the JAX package
computes these in jnp, outside any Pallas kernel).  Not carried over:
Montgomery form, the per-layout jit caches, and every way out: a column
that is not resident on the device is an error here, not a reason to fall
back to the host upload.

Overflow discipline: a fingerprint is a sum of up to 13 extension-scalar x
base-column products; ``ext4_dev._apply_pairs`` reduces after every two raw
products.  Selectors come from int64 ``arange`` comparisons, because
``n_active - 2`` may be negative.

Every twin returns {committed column name: (len,) canonical int32 tensor}.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from ..commitments.ligero import DeviceColumnRef
from .babybear import P
from .ext4_dev import (
    _apply_pairs,
    _scalar_ints,
    ext_add_dev,
    ext_inv_dev,
    ext_mul_base_dev,
    ext_mul_dev,
)

__all__ = [
    "core_logup_advice_dev",
    "regcheck_advice_dev",
    "bytecode_advice_dev",
]


# -- helpers -----------------------------------------------------------------

def _col(ref: DeviceColumnRef) -> torch.Tensor:
    """A committed column as a flat canonical int64 tensor."""
    return ref.resolve().to(torch.int64)


def _const(s4, device) -> torch.Tensor:
    """An extension scalar as a (4, 1) tensor that broadcasts over a table."""
    return torch.tensor(_scalar_ints(s4), dtype=torch.int64, device=device).view(4, 1)


def _kappa(terms: Sequence) -> torch.Tensor:
    """sum_i s_i * b_i as a (4, n) table, for ``terms`` [(extension scalar,
    base column), ...]: coordinate e is sum_i s_i[e] * b_i."""
    scalars = [_scalar_ints(s) for s, _ in terms]
    return torch.stack([
        _apply_pairs([(scalars[i][e], b) for i, (_, b) in enumerate(terms)]) for e in range(4)
    ])


def _denominator(tau, kappa4, *bases) -> torch.Tensor:
    """tau - kappa4 - sum(bases) as a (4, n) canonical table: ``tau`` an
    extension scalar, ``kappa4`` a (4, n) table or None, ``bases`` canonical
    base columns (they touch coordinate 0 only)."""
    device = bases[0].device if kappa4 is None else kappa4.device
    n = bases[0].shape[0] if kappa4 is None else kappa4.shape[1]
    d = _const(tau, device).expand(4, n)
    d = (d - kappa4) % P if kappa4 is not None else d.contiguous()
    for b in bases:  # canonical operands: the difference stays above -p
        d[0] = (d[0] - b) % P
    return d


def _selector(n: int, lo: int, hi: int, device) -> torch.Tensor:
    """1 on lo <= index <= hi, else 0, from signed comparisons (``hi`` may
    be negative)."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return ((idx >= lo) & (idx <= hi)).to(torch.int64)


def _emit(out: Dict[str, torch.Tensor], name: str, g4: torch.Tensor) -> None:
    planes = g4.to(torch.int32)
    for e in range(4):
        out[f"{name}#{e}"] = planes[e]


def _fraction_sum(ds: List[torch.Tensor]) -> torch.Tensor:
    """sum_j 1 / d_j for up to four (4, n) denominators with ONE inverse:
    numerator / product (constraints/regcheck.py ``_fraction_sum_parts``)."""
    k = len(ds)
    if k == 1:
        return ext_inv_dev(ds[0])
    if k == 2:
        prod_all, num = ext_mul_dev(ds[0], ds[1]), ext_add_dev(ds[0], ds[1])
    elif k == 3:
        d01 = ext_mul_dev(ds[0], ds[1])
        prod_all = ext_mul_dev(d01, ds[2])
        num = ext_add_dev(ext_mul_dev(ext_add_dev(ds[0], ds[1]), ds[2]), d01)
    elif k == 4:
        d01 = ext_mul_dev(ds[0], ds[1])
        d23 = ext_mul_dev(ds[2], ds[3])
        prod_all = ext_mul_dev(d01, d23)
        num = ext_add_dev(ext_mul_dev(ext_add_dev(ds[0], ds[1]), d23),
                          ext_mul_dev(ext_add_dev(ds[2], ds[3]), d01))
    else:
        raise ValueError(f"a merged fraction sum takes 1 to 4 denominators, got {k}")
    return ext_mul_dev(num, ext_inv_dev(prod_all))


def _range_denominator(tau_r, col: torch.Tensor, coef: int) -> torch.Tensor:
    return _denominator(tau_r, None, col if coef == 1 else col * coef % P)


def _range16_h(tau_r, m_col: torch.Tensor) -> torch.Tensor:
    """m / (tau_r - index) over the RANGE16 domain."""
    idx16 = torch.arange(1 << 16, dtype=torch.int64, device=m_col.device)
    return ext_mul_base_dev(ext_inv_dev(_denominator(tau_r, None, idx16)), m_col)


# -- core argument: pc-chain logUp g1/g2 -------------------------------------

def core_logup_advice_dev(pc_ref: DeviceColumnRef, next_pc_ref: DeviceColumnRef, num_steps: int,
                          num_vars: int, tau, beta) -> Dict[str, torch.Tensor]:
    """Device twin of constraints/v2.py ``build_logup_columns``: the 8
    committed coordinate planes {"g1#e", "g2#e"}."""
    n = 1 << num_vars
    pc, npc = _col(pc_ref), _col(next_pc_ref)
    idx = torch.arange(n, dtype=torch.int64, device=pc.device)  # n <= 2^28 < p
    # fp1 = tau - beta * (idx + 1) - next_pc ; fp2 = tau - beta * idx - pc
    fp1 = _denominator(tau, _kappa([(beta, (idx + 1) % P)]), npc)
    fp2 = _denominator(tau, _kappa([(beta, idx)]), pc)
    out: Dict[str, torch.Tensor] = {}
    _emit(out, "g1", ext_mul_base_dev(ext_inv_dev(fp1), _selector(n, 0, num_steps - 2, pc.device)))
    _emit(out, "g2", ext_mul_base_dev(ext_inv_dev(fp2), _selector(n, 1, num_steps - 1, pc.device)))
    return out


# -- regcheck: kappa fingerprints + RANGE16 quads + h ------------------------

def regcheck_advice_dev(refs: Dict[str, DeviceColumnRef], n_active: int, num_vars: int,
                        tau_m, tau_r, gamma, m_ref: DeviceColumnRef) -> Dict[str, torch.Tensor]:
    """Device twin of ``RegcheckArgument.advice_phase``'s column
    construction: the six g_{r,w}{m} fingerprint inverses, the merged
    RANGE16 quads gq_i, and the table-side h column.

    ``refs`` maps regcheck data-column names (a1..a3, rt1..rt3, value limbs,
    tl/dl limbs) to DeviceColumnRef; ``m_ref`` is the RANGE16 multiplicity
    column."""
    from ..constraints.regcheck import _RANGE_GROUPS, _gamma_powers, _kappa_parts

    if num_vars > 28:
        raise ValueError(f"num_vars={num_vars}: ts = 3*idx + m must stay below p")
    n = 1 << num_vars
    cols = {k: _col(r) for k, r in refs.items()}
    device = m_ref.mat.device
    gp = _gamma_powers(gamma)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    sel = _selector(n, 0, n_active - 1, device)
    out: Dict[str, torch.Tensor] = {}
    # g_{side}{m}: sel / (tau_m - kappa), kappa = sum_i gamma^i * parts[i]
    for m in (1, 2, 3):
        for side in ("r", "w"):
            a_name, vpre = _kappa_parts(m, side)
            ts = cols[f"rt{m}"] if side == "r" else 3 * idx + m
            parts = [cols[a_name]] + [cols[f"{vpre}_{k}"] for k in range(4)] + [ts]
            d = _denominator(tau_m, _kappa(list(zip(gp, parts))))
            _emit(out, f"g_{side}{m}", ext_mul_base_dev(ext_inv_dev(d), sel))
    # Range quads: gq_i = sum_j 1 / (tau_r - coef * c_j), one inverse a group.
    for i, group in enumerate(_RANGE_GROUPS):
        _emit(out, f"gq{i}", _fraction_sum([_range_denominator(tau_r, cols[c], coef) for c, coef in group]))
    _emit(out, "h", _range16_h(tau_r, _col(m_ref)))
    return out


# -- bytecode: fetch/counter/output/linkage/range/mem-link advice ------------

def _bytecode_refs(data_state) -> Dict[str, DeviceColumnRef]:
    """The committed columns the bytecode advice reads, across namespaces:
    bc's own link columns, the core pc, the regcheck operand limbs, the
    memcheck byte rows.  Every one must be resident on the device."""
    from ..constraints.bytecode import BYTECODE_SLOTS, RANGE_GROUPS

    names = {}
    for slot in BYTECODE_SLOTS:
        if slot == "pc":
            names["pc"] = "v2:pc"
        elif slot in ("a1", "a2"):
            names[slot] = f"rc:{slot}"
        else:
            names[slot] = f"bc:{slot}"
    for extra in ("cnt", "c_commit", "bcnt", "m_r16", "res_0", "res_1", "res_2", "res_3", "taken_b"):
        names[extra] = f"bc:{extra}"
    for cname, _coef in sum(RANGE_GROUPS, ()):
        names.setdefault(cname, f"bc:{cname}")
    for k in range(4):
        names[f"rv1_{k}"] = f"rc:rv1_{k}"
        names[f"rv2_{k}"] = f"rc:rv2_{k}"
    for mcn in ("ba0", "ba1", "ba2", "ba3", "bk", "vw", "st"):
        names[f"mc_{mcn}"] = f"mc:{mcn}"
    return {local: data_state.device_column(full, required=True) for local, full in names.items()}


def bytecode_advice_dev(data_state, bc, num_vars: int) -> Dict[str, torch.Tensor]:
    """Device twin of the bulk of ``_bc_advice_phase``'s column
    construction: g_bc, the counter chains g_c1/g_c2/g_b1/g_b2, g_out, the
    step linkage g_lk_s, the merged RANGE16 pairs grp*, the merged per-byte
    mem-link pairs gmp*, the byte-domain g_lnk, and h_r16.  The
    program-domain h_prog and the per-table query-link advice stay
    host-built (their domains are small and need the public decode table,
    not committed columns).

    ``bc`` is the BytecodeArgument AFTER its host advice_phase (challenges
    resolved, powers computed)."""
    from ..constraints.bytecode import (
        BYTECODE_SLOTS,
        GM_GROUPS,
        RANGE_GROUPS,
        _LOAD_FLAGS,
        _STORE_FLAGS,
        _gammas,
        _out_betas,
    )
    from ..constraints.linkage import link_deltas

    cols = {k: _col(r) for k, r in _bytecode_refs(data_state).items()}
    (tau, gamma, tau_c, beta_c, tau_o, beta_o, tau_l, delta, tau_r, tau_w, _eps) = bc.challenges
    gp = _gammas(gamma, P)
    ob = _out_betas(beta_o, P)
    dl = link_deltas(delta, P)
    ep = bc.ep

    device = cols["pc"].device
    n = 1 << num_vars
    n_active = bc.n
    idx = torch.arange(n, dtype=torch.int64, device=device)
    idx1 = (idx + 1) % P
    sel = _selector(n, 0, n_active - 1, device)
    sel1 = _selector(n, 0, n_active - 2, device)
    sel2 = _selector(n, 1, n_active - 1, device)
    out: Dict[str, torch.Tensor] = {}

    def inv_times(d4, b):
        return ext_mul_base_dev(ext_inv_dev(d4), b)

    # g_bc: sel / (tau - kappa_step)
    d_bc = _denominator(tau, _kappa([(gp[i], cols[slot]) for i, slot in enumerate(BYTECODE_SLOTS)]))
    _emit(out, "g_bc", inv_times(d_bc, sel))
    del d_bc

    # Counter chains g_c1/g_c2 over cnt/c_commit; beta_c * (idx + 1) and
    # beta_c * idx are shared with the byte-counter chains below.
    bc_idx1 = _kappa([(beta_c, idx1)])
    bc_idx = _kappa([(beta_c, idx)])
    _emit(out, "g_c1", inv_times(_denominator(tau_c, bc_idx1, cols["cnt"], cols["c_commit"]), sel1))
    _emit(out, "g_c2", inv_times(_denominator(tau_c, bc_idx, cols["cnt"]), sel2))

    # g_out: c_commit / (tau_o - ob0 * cnt - sum ob_{k+1} * rv2_k)
    key_out = _kappa([(ob[0], cols["cnt"])] + [(ob[k + 1], cols[f"rv2_{k}"]) for k in range(4)])
    _emit(out, "g_out", inv_times(_denominator(tau_o, key_out), cols["c_commit"]))
    del key_out

    # g_lk_s: flk / (tau_l - kappa_lk), kappa as in _step_link_denoms.
    falu = (cols["flk"] - cols["fbr"]) % P
    terms = [(dl[0], cols["tbl1"])]
    for k in range(4):
        terms.append((dl[1 + k], cols[f"rv1_{k}"]))
        in1k = (cols["fimm"] * cols[f"imm_{k}"] + cols["frs2"] * cols[f"rv2_{k}"]) % P
        terms.append((dl[5 + k], in1k))
    s_terms = [
        (falu * cols["res_0"] + cols["fbr"] * cols["f3"]) % P,
        (falu * cols["res_1"] + cols["fbr"] * cols["taken_b"]) % P,
        falu * cols["res_2"] % P,
        falu * cols["res_3"] % P,
    ]
    terms += [(dl[9 + k], s_terms[k]) for k in range(4)]
    _emit(out, "g_lk_s", inv_times(_denominator(tau_l, _kappa(terms)), cols["flk"]))
    del terms, s_terms, falu

    # RANGE16 merged pairs over the scaled lk columns.
    for i, group in enumerate(RANGE_GROUPS):
        _emit(out, f"grp{i}", _fraction_sum([_range_denominator(tau_r, cols[c], coef) for c, coef in group]))

    # Per-byte mem-link pairs: sel_k / d_k merged in pairs.
    def flag_sum(names):
        acc = cols[names[0]]
        for name in names[1:]:
            acc = acc + cols[name]
        return acc % P

    s1b = flag_sum(_LOAD_FLAGS + _STORE_FLAGS)
    s2b = flag_sum(("flh", "flhu", "flw", "flwu", "fld", "fsh", "fsw", "fsd"))
    s4b = flag_sum(("flw", "flwu", "fld", "fsw", "fsd"))
    s8b = flag_sum(("fld", "fsd"))
    mem_sels = [s1b, s2b, s4b, s4b, s8b, s8b, s8b, s8b]
    base_k = _kappa([(ep[0], cols["bcnt"])] + [(ep[1 + j], cols[f"jt_{j}"]) for j in range(4)]
                    + [(ep[7], cols["fstore"])])
    mem_dens = []
    for k in range(8):
        # kappa_k = base + (ep0 + ep5) * k + ep6 * vb_k; the constant part
        # joins tau_w on the host.
        tau_k = tau_w - (ep[0] * k + ep[5] * k) if k else tau_w
        mem_dens.append(_denominator(tau_k, ext_add_dev(base_k, _kappa([(ep[6], cols[f"vb_{k}"])]))))
    del base_k
    for i, (ka, kb) in enumerate(GM_GROUPS):
        da, db = mem_dens[ka], mem_dens[kb]
        num = (db * mem_sels[ka] + da * mem_sels[kb]) % P
        _emit(out, f"gmp{i}", ext_mul_dev(num, ext_inv_dev(ext_mul_dev(da, db))))
    del mem_dens

    # Byte-counter chains: nb_full = the sum of the eight mem selectors.
    nb_full = (s1b + s2b + 2 * s4b + 4 * s8b) % P
    _emit(out, "g_b1", inv_times(_denominator(tau_c, bc_idx1, cols["bcnt"], nb_full), sel1))
    _emit(out, "g_b2", inv_times(_denominator(tau_c, bc_idx, cols["bcnt"]), sel2))
    del bc_idx1, bc_idx

    # Byte-domain g_lnk over the memcheck rows.
    n_bytes = 1 << bc.mvv
    idx_a = torch.arange(n_bytes, dtype=torch.int64, device=device)
    kap_w = _kappa([(ep[0], idx_a)] + [(ep[1 + j], cols[f"mc_ba{j}"]) for j in range(4)]
                   + [(ep[5], cols["mc_bk"]), (ep[6], cols["mc_vw"]), (ep[7], cols["mc_st"])])
    _emit(out, "g_lnk", inv_times(_denominator(tau_w, kap_w), _selector(n_bytes, 0, bc.A - 1, device)))

    _emit(out, "h_r16", _range16_h(tau_r, cols["m_r16"]))
    return out
