"""Witness linkage: lookup-validity queries ARE the executed steps.

The validity argument (lookups/validity.py) proves each committed query
multiset consists of genuine table entries, but — as its scope note
records — nothing tied those query columns to the execution witness: a
prover could commit a VALID query set unrelated to the trace.  This
module closes ROADMAP #4 with a logUp multiset equality between

  step side   {(tbl, in0, in1, s) : gadget-covered step}     (flk-selected)
  query side  {(tbl, in0, in1, s) : committed query, table tbl}

where every step-side slot is a PROVEN column: tbl/f3/imm/selector flags
from the bytecode fetch argument (constraints/bytecode.py), operand
limbs rv1/rv2 from the regcheck read cells, and the result limbs res
tied to the regcheck write value whenever the instruction architecturally
writes (fwr * (res - wv) = 0; rd=x0 results stay free advice — the
register file discards them, and the table inclusion still proves the
semantics).  The s-block is (result limbs) for ALU tables and
(funct3, taken, 0, 0) for the branch table, giving downstream
control-flow constraints a PROVEN taken bit.

Query-side slots are linear reconstructions of each gadget's committed
representation (8-bit chunks recombine into 16-bit limbs; SUB swaps its
carry-chain roles back; compare/branch outputs sit in slot s_0/s_1).
The fingerprint challenges (tau_l, delta) are drawn in the bytecode
argument's challenge fork — after the validity commitments, the regcheck
commitment, and the bytecode linkage commitment are all absorbed.

Each table gets a second zerocheck over its query domain proving
g_lk * (tau_l - key) = sel pointwise against the SAME column commitment
the validity argument opened (a second Ligero claim at the new point),
plus an eval+sum-bound g_lk commitment; the verifier checks
sum_t sum(g_lk^t) == sum(g_lk^step).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from ..core.ext4 import Ext4, ext_lift
from ..poly.public_mles import le_indicator_eval, le_table
from ..proofs.zerocheck import (
    ZerocheckExtProver,
    ZerocheckExtVerifier,
    ZerocheckProof,
    unified_dev_columns,
    unified_device,
)
from .regcheck import g_coord_names, g_eval_from_coords, pack_g_coords, sum_claim_values

__all__ = [
    "LINK_SLOTS",
    "QueryLinkRecord",
    "gadget_linkage_arrays",
    "gadget_linkage_scalars",
    "link_deltas",
    "prove_query_links",
    "verify_query_links",
]

LINK_SLOTS = tuple(
    f"{pre}_{j}" for pre in ("in0", "in1", "s") for j in range(4)
)
LINKAGE_DEGREE = 3  # deg(eq * g_lk * key), key linear in committed cols

_M16 = np.uint64(0xFFFF)


def link_deltas(delta: Ext4, p: int) -> List[Ext4]:
    """delta^1..delta^13: the table-id slot then the 12 LINK_SLOTS
    (extension powers — round-3 hardening)."""
    out, g = [], ext_lift(1)
    for _ in range(len(LINK_SLOTS) + 1):
        g = g * delta
        out.append(g)
    return out


def _zero_like(cols, name: str):
    return 0 * cols[name]  # generic: numpy zeros or an Ext4 zero array


def gadget_linkage_arrays(tid: int, cols: Dict[str, np.ndarray], p: int):
    """Slot arrays (mod p) reconstructed linearly from a gadget's
    committed query columns.  Row layout mirrors the gadget's build()."""
    P = np.uint64(p)
    two8 = np.uint64(1 << 8)

    def limbs(prefix):
        return [cols[f"{prefix}{j}"] for j in range(4)]

    def chunk16(prefix):
        return [
            (cols[f"{prefix}{2 * j}"] + two8 * cols[f"{prefix}{2 * j + 1}"]) % P
            for j in range(4)
        ]

    def z():
        return 0 * next(iter(cols.values()))  # generic base/Ext4 zero

    if tid == 0:  # ADD: committed (x, y, z) = (in0, in1, out)
        in0, in1, s = limbs("x"), limbs("y"), limbs("z")
    elif tid == 1:  # SUB: committed (x, y, z) = (out, in1, in0)
        in0, in1, s = limbs("z"), limbs("y"), limbs("x")
    elif tid in (2, 3, 4):  # AND/OR/XOR 8-bit chunk triples
        in0, in1, s = chunk16("a"), chunk16("b"), chunk16("o")
    elif tid in (5, 6, 7):  # shifts
        in0, in1, s = limbs("x"), limbs("y"), limbs("z")
    elif tid in (8, 9):  # SLT/SLTU: out is the single bit "o"
        in0, in1, s = limbs("x"), limbs("y"), [cols["o"], z(), z(), z()]
    elif tid == 10:  # BRANCH: s carries (funct3, taken, 0, 0)
        in0, in1, s = limbs("x"), limbs("y"), [cols["f3"], cols["o"], z(), z()]
    elif tid in (13, 14, 15, 16, 17):  # word ops: (x, y) -> z
        in0, in1, s = limbs("x"), limbs("y"), limbs("z")
    elif tid in (18, 19, 20, 21, 22):  # multiplies: byte-committed
        in0 = [(cols[f"xb{2*j}"] + two8 * cols[f"xb{2*j+1}"]) % P
               for j in range(4)]
        in1 = [(cols[f"yb{2*j}"] + two8 * cols[f"yb{2*j+1}"]) % P
               for j in range(4)]
        if tid == 18:  # MUL: low product bytes
            s = [(cols[f"zb{2*j}"] + two8 * cols[f"zb{2*j+1}"]) % P
                 for j in range(4)]
        elif tid == 21:  # MULHU: high product bytes
            s = [(cols[f"zb{8+2*j}"] + two8 * cols[f"zb{8+2*j+1}"]) % P
                 for j in range(4)]
        elif tid in (19, 20):  # MULH/MULHSU: corrected high bytes
            s = [(cols[f"wb{2*j}"] + two8 * cols[f"wb{2*j+1}"]) % P
                 for j in range(4)]
        else:  # MULW: sext32 of the low 32 product bits
            fill = np.uint64(0xFFFF % p) * cols["sw"] % P
            s = [(cols["zb0"] + two8 * cols["zb1"]) % P,
                 (cols["zb2"] + two8 * cols["zb3"]) % P,
                 fill, fill]
    elif tid in range(23, 31):  # divisions: byte-committed q or r
        in0 = [(cols[f"xb{2*j}"] + two8 * cols[f"xb{2*j+1}"]) % P
               for j in range(4)]
        in1 = [(cols[f"yb{2*j}"] + two8 * cols[f"yb{2*j+1}"]) % P
               for j in range(4)]
        pre = "rb" if tid in (25, 26, 29, 30) else "qb"
        if tid >= 27:  # W variants: sext32 via the committed top-bit split
            sw = cols["swr" if pre == "rb" else "swq"]
            fill = np.uint64(0xFFFF % p) * sw % P
            s = [(cols[f"{pre}0"] + two8 * cols[f"{pre}1"]) % P,
                 (cols[f"{pre}2"] + two8 * cols[f"{pre}3"]) % P, fill, fill]
        else:
            s = [(cols[f"{pre}{2*j}"] + two8 * cols[f"{pre}{2*j+1}"]) % P
                 for j in range(4)]
    else:
        raise ValueError(f"no linkage spec for table {tid}")
    return dict(zip(LINK_SLOTS, in0 + in1 + s))


def gadget_linkage_scalars(tid: int, ev: Dict[str, int], p: int) -> Dict[str, int]:
    def limbs(prefix):
        return [ev[f"{prefix}{j}"] % p for j in range(4)]

    def chunk16(prefix):
        return [
            (ev[f"{prefix}{2 * j}"] + (1 << 8) * ev[f"{prefix}{2 * j + 1}"]) % p
            for j in range(4)
        ]

    if tid == 0:
        in0, in1, s = limbs("x"), limbs("y"), limbs("z")
    elif tid == 1:
        in0, in1, s = limbs("z"), limbs("y"), limbs("x")
    elif tid in (2, 3, 4):
        in0, in1, s = chunk16("a"), chunk16("b"), chunk16("o")
    elif tid in (5, 6, 7, 13, 14, 15, 16, 17):
        in0, in1, s = limbs("x"), limbs("y"), limbs("z")
    elif tid in (8, 9):
        in0, in1, s = limbs("x"), limbs("y"), [ev["o"] % p, 0, 0, 0]
    elif tid == 10:
        in0, in1, s = limbs("x"), limbs("y"), [ev["f3"] % p, ev["o"] % p, 0, 0]
    elif tid in (18, 19, 20, 21, 22):
        in0 = chunk16("xb")
        in1 = chunk16("yb")
        if tid == 18:
            s = [(ev[f"zb{2*j}"] + (1 << 8) * ev[f"zb{2*j+1}"]) % p
                 for j in range(4)]
        elif tid == 21:
            s = [(ev[f"zb{8+2*j}"] + (1 << 8) * ev[f"zb{8+2*j+1}"]) % p
                 for j in range(4)]
        elif tid in (19, 20):
            s = chunk16("wb")
        else:
            fill = 0xFFFF * ev["sw"] % p
            s = [(ev["zb0"] + (1 << 8) * ev["zb1"]) % p,
                 (ev["zb2"] + (1 << 8) * ev["zb3"]) % p, fill, fill]
    elif tid in range(23, 31):
        in0 = chunk16("xb")
        in1 = chunk16("yb")
        pre = "rb" if tid in (25, 26, 29, 30) else "qb"
        if tid >= 27:
            sw = ev["swr" if pre == "rb" else "swq"] % p
            fill = 0xFFFF * sw % p
            s = [(ev[f"{pre}0"] + (1 << 8) * ev[f"{pre}1"]) % p,
                 (ev[f"{pre}2"] + (1 << 8) * ev[f"{pre}3"]) % p, fill, fill]
        else:
            s = [(ev[f"{pre}{2*j}"] + (1 << 8) * ev[f"{pre}{2*j+1}"]) % p
                 for j in range(4)]
    else:
        raise ValueError(f"no linkage spec for table {tid}")
    return dict(zip(LINK_SLOTS, in0 + in1 + s))


def _key_array(tid: int, slots: Dict, dl: List[Ext4], p: int) -> Ext4:
    acc = dl[0] * (tid + 1)
    for k, name in enumerate(LINK_SLOTS):
        acc = acc + dl[k + 1] * slots[name]
    return acc


@dataclass
class QueryLinkRecord:
    """Round-3 slim form: the g_lk commitment and the extra claim on the
    validity columns live in the shared unified commitment."""

    table_id: int
    num_queries: int
    num_vars: int
    zc: ZerocheckProof  # query-domain zerocheck (gadget cols + g_lk)
    g_sum: object


def _make_link_combiner(gadget, tid: int, tau_l: Ext4, dl: List[Ext4], p: int):
    """One generic combiner: the prover passes (partially folded) gadget
    columns + the g_lk coordinate tables; the verifier passes terminal
    Ext4 evaluations plus the public __sel__ value."""

    def combiner(cols, alphas: List, p_: int):
        slots = gadget_linkage_arrays(tid, cols, p)
        key = _key_array(tid, slots, dl, p)
        g = g_eval_from_coords(cols, "g_lk")
        return alphas[0] * (g * (tau_l - key) - cols["__sel__"])

    return combiner


def _link_public_evals(num_queries: int, num_vars: int, p: int):
    def fn(rs):
        return {"__sel__": le_indicator_eval(num_queries - 1, num_vars, rs, p)}

    return fn


def link_denominators(tid: int, cols: Dict[str, np.ndarray], nq: int,
                      tau_l: Ext4, dl: List[Ext4], p: int) -> Ext4:
    slots = gadget_linkage_arrays(tid, cols, p)
    key = _key_array(tid, slots, dl, p)
    return tau_l - key


def build_query_link_advice(F, transcript, validity_info: List[dict],
                            tau_l, delta) -> Tuple[dict, object]:
    """ADVICE phase of the query linkage (run inside the bytecode
    argument): per validity table, build the g_lk inverse column, absorb
    its sum, and return ({local advice name: coord column}, total sum).
    The caller draws (tau_l, delta) after the data commitment."""
    from ..proofs.zerocheck import absorb_ext

    p = F.MODULUS
    out = {}
    total = ext_lift(0)
    dl = link_deltas(delta, p)
    for info in validity_info:
        tid = info["tid"]
        nq, v = info["nq"], info["v"]
        sel = le_table(nq - 1, v)
        den = link_denominators(tid, info["cols"], nq, tau_l, dl, p)
        g_lk = sel * den.inv()
        g_sum = g_lk.sum()
        total = total + g_sum
        transcript.append_bytes(b"LK_G")
        transcript.append_u64(tid)
        absorb_ext(transcript, g_sum)
        info["g_lk"] = g_lk
        info["g_lk_sum"] = g_sum
        info["sel"] = sel
        for e in range(4):
            out[f"lk{tid}:g_lk#{e}"] = g_lk.c[e]
    return out, total


def prove_query_links(F, transcript, sink, validity_info: List[dict],
                      tau_l, delta, bc_locmap) -> List[QueryLinkRecord]:
    """ZEROCHECK phase of the query linkage: per-table zerochecks over
    the validity argument's committed query columns + the g_lk advice,
    registering claims on the shared commitments (validity columns via
    each table's ``arg`` locmap; g_lk via the bytecode locmap)."""
    from ..core.ext4 import ext_lift as _lift

    p = F.MODULUS
    records: List[QueryLinkRecord] = []
    dl = link_deltas(delta, p)
    for info in validity_info:
        tid = info["tid"]
        gadget = info["gadget"]
        zc_cols = dict(info["cols"])
        zc_cols.update(pack_g_coords({"g_lk": info["g_lk"]}))
        zc_cols["__sel__"] = info["sel"]
        combiner = _make_link_combiner(gadget, tid, tau_l, dl, p)
        zc = ZerocheckExtProver(
            F, zc_cols, combiner, LINKAGE_DEGREE, num_alphas=1,
            device=unified_device(info["arg"]),
            dev_columns=unified_dev_columns(
                info["arg"], zc_cols, rename=lambda n, t=tid: f"t{t}:{n}"
            ),
        ).prove(transcript)
        records.append(QueryLinkRecord(
            table_id=tid, num_queries=info["nq"], num_vars=info["v"],
            zc=zc, g_sum=info["g_lk_sum"],
        ))
        register_link_claims(sink, zc, tid, info["arg"].locmap, bc_locmap,
                             info["g_lk_sum"])
    return records


def register_link_claims(sink, zc, tid: int, lv_locmap, bc_locmap, g_sum):
    """Shared prover/verifier claim schedule for one link record."""
    from ..core.ext4 import ext_lift as _lift

    gc_names = set(g_coord_names(["g_lk"]))
    for name in sorted(zc.column_evals):
        if name in gc_names:
            ck, fn, v = bc_locmap[f"lk{tid}:{name}"]
        else:
            ck, fn, v = lv_locmap[f"t{tid}:{name}"]
        sink.eval_claim(ck, fn, v, zc.final_point, zc.column_evals[name])
    for e in range(4):
        ck, fn, v = bc_locmap[f"lk{tid}:g_lk#{e}"]
        sink.sum_claim(ck, fn, v, _lift(int(g_sum.c[e])))


def verify_query_link_sums(transcript, links: List[QueryLinkRecord],
                           lv_tables: List) -> Tuple[bool, object]:
    """ADVICE-phase replay: shape checks + sum absorption.  Returns
    (ok, total query-side g sum)."""
    from ..proofs.zerocheck import absorb_ext

    if len(links) != len(lv_tables):
        return False, ext_lift(0)
    total = ext_lift(0)
    for link, rec in zip(links, lv_tables):
        if link.table_id != rec.table_id or link.num_queries != rec.num_queries:
            return False, ext_lift(0)
        if link.num_vars != rec.num_vars:
            return False, ext_lift(0)
        if not (isinstance(link.g_sum, Ext4) and link.g_sum.is_scalar):
            return False, ext_lift(0)
        total = total + link.g_sum
        transcript.append_bytes(b"LK_G")
        transcript.append_u64(link.table_id)
        absorb_ext(transcript, link.g_sum)
    return True, total


def verify_query_links(F, transcript, sink, links: List[QueryLinkRecord],
                       tau_l, delta, lv_locmap, bc_locmap) -> bool:
    """ZEROCHECK-phase replay of the per-table link zerochecks."""
    from ..lookups.validity import GADGETS

    p = F.MODULUS
    dl = link_deltas(delta, p)
    gc_names = sorted(g_coord_names(["g_lk"]))
    for link in links:
        tid = link.table_id
        gadget = GADGETS[tid]
        names = sorted(gadget.columns)
        if set(link.zc.column_evals) != set(names) | set(gc_names):
            return False
        if link.zc.num_vars != link.num_vars or link.zc.degree != LINKAGE_DEGREE:
            return False
        combiner = _make_link_combiner(gadget, tid, tau_l, dl, p)
        if not ZerocheckExtVerifier(
            F, combiner, 1, LINKAGE_DEGREE,
            public_evals=_link_public_evals(link.num_queries, link.num_vars, p),
        ).verify(link.zc, transcript):
            return False
        register_link_claims(sink, link.zc, tid, lv_locmap, bc_locmap,
                             link.g_sum)
    return True
