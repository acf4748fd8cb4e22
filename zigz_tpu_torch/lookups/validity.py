"""Lookup VALIDITY argument: queries are genuine table entries.

The reference's pipeline Lasso never proves that a looked-up output is
correct — its own "complete implementation" comment (prover.zig:351-357)
sketches a multiset/decomposition argument that was never built, and our
round-1 pipeline_lasso.py proved only a sumcheck over the hash-encoded
query polynomial (no table, no multiplicities).  This module closes that
gap for the operand tables with a logUp-based chunked lookup argument:

* Every query table with algebraic RV64 semantics gets a GADGET that
  re-expresses its queries as committed columns (4 x 16-bit limbs +
  carries/borrows, or 8 x 8-bit chunk triples) over the padded query
  domain.  Semantics are FULL 64-bit (the catalog's "32-bit table
  shapes" are reference metadata; truncation would reject honest RV64
  traces with operands >= 2^32).
* Pointwise validity is enforced by two instruments:
    - zerocheck constraints (limb identities, carry booleanity), and
    - logUp multiset inclusion of chunk tuples in SMALL subtables
      (2^16 entries) whose multilinear extensions have closed forms the
      verifier evaluates itself — the TPU answer to the reference's
      naive 2^33-entry subtable enumeration (table_decomposition.zig:
      86-128, strategy "Procedural" at :20-26).
* logUp soundness ordering: query columns and table-side multiplicities
  are Ligero-committed BEFORE the fingerprint challenge tau is drawn;
  the inverse columns (g on the query side, h = m/(tau - key) on the
  table side) are committed after; zerochecks prove the inverse
  identities pointwise; Ligero sum claims pin the hypercube sums, and
  the verifier checks  sum(g over all uses of subtable S) == sum(h_S)
  — the logUp multiset equation.

Subtable key encodings (all < 2^24 < p, injective):

    RANGE16:  key(x) = x                     (range check, 2^16 entries)
    AND8/OR8/XOR8: key(a,b) = a + 2^8 b + 2^16 op(a,b)

Gadget constraint systems (all degree <= 2; zerocheck degree 3):

    ADD  (out = in0 + in1 mod 2^64), SUB via out + in1 = in0:
         x_j + y_j + c_{j-1} - z_j - 2^16 c_j  = 0    (j = 0..3)
         c_j (1 - c_j) = 0
         limbs x/y/z_j range-checked via RANGE16.
      Every term is < 2^17 in magnitude, so the mod-p identities hold
      over the integers — carries + range checks make this exactly
      64-bit addition (no wrap-around ambiguity at p ~ 2^31).

    AND/OR/XOR: 8-bit chunk triples (a_k, b_k, o_k), k = 0..7, each
      included in the matching op subtable; the chunks ARE the committed
      query representation (out = sum 2^{8k} o_k by definition).

    SLT/SLTU: 4-limb borrow chain x - y = d - 2^64 b3 with d
      range-checked, so the borrow-out b3 IS the comparison; SLT biases
      both top limbs by +2^15 (sign flip) via a range-checked split.

    SLL/SRL/SRA (s = y & 63, RV64): a staged 128-bit shifter computes
      x * 2^t in 16-bit limbs — t = 16a + b with a one-hot and b in
      bits; 2^b via two committed partial products; limb rotation by a;
      per-limb w_j * 2^b = lo_j + 2^16 hi_j with lo/hi range-checked
      (shifted sub-limb pieces never overlap, so v_j = lo_j + hi_{j-1}
      is carry-free).  SLL reads the low half of x * 2^s; SRL reads the
      HIGH half of x * 2^(64-s) (exactly x >> s); SRA adds
      sign * fill-mask limbs derived from the same one-hot.  The shift
      amount is bound to the query by y0 = s + 64*yq with 64*yq
      range-checked.

    BRANCH (all variants share one catalog table): queries carry
      funct3; one-hot selectors bound to funct3 route equality (per-limb
      inverse gadgets + product tree) and the two borrow chains into the
      committed ``taken`` bit.

Linkage (ROADMAP #4, closed): constraints/linkage.py ties these
committed query columns to the execution — a logUp multiset equality
between the per-step (table, in0, in1, out) tuples built from PROVEN
columns (regcheck read/write values, bytecode decode flags) and the
query tuples reconstructed from this module's commitments.  Together: a
trace carrying a forged lookup output has no satisfying assignment
(tests/test_lookup_validity.py), and a valid-but-unrelated query set is
rejected by the linkage (tests/test_bytecode.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..constraints.regcheck import (
    g_coord_names,
    g_eval_from_coords,
    pack_g_coords,
    sum_claim_values,
)
from ..core.ext4 import (
    MAX_NONCE,
    Ext4,
    challenge_ext,
    high_coords_nonzero,
)
from ..poly.public_mles import idx_eval, np_inv
from ..proofs.zerocheck import (
    ZerocheckExtProver,
    ZerocheckExtVerifier,
    ZerocheckProof,
    absorb_ext,
    unified_dev_columns,
    unified_device,
)

__all__ = [
    "GADGETS",
    "GADGET_TABLE_IDS",
    "LookupValidityProof",
    "TableValidityRecord",
    "SubtableSideRecord",
    "prove_lookup_validity",
    "verify_lookup_validity",
]

_M8 = np.uint64(0xFF)
_M16 = np.uint64(0xFFFF)
# deg(eq * C): gadget constraints are degree <= 2; the merged-inclusion
# logUp constraints (below) are degree 1 + INCLUSION_MERGE.
INCLUSION_MERGE = 4
VALIDITY_DEGREE = INCLUSION_MERGE + 2

_MERGED_CACHE: dict = {}


def merged_inclusions(gadget):
    """Deterministic merge plan for a gadget's logUp inclusions (round 4):
    same-subtable inclusions chunk into INCLUSION_MERGE-sized groups, each
    committed as ONE advice column gq_{sub}_{i} carrying
    sum_j 1/(tau - key_j), pinned per row by the degree-(k+1) constraint
    gq * prod_j d_j == sum_j prod_{l != j} d_l (denominators are nonzero
    by construction: tau has nonzero high coordinates, keys are base).
    Per-subtable grand sums are unchanged in value.  Returns
    [(g_name, sub, (spec, ...)), ...]."""
    key = id(gadget.inclusions)
    got = _MERGED_CACHE.get(key)
    if got is not None:
        return got
    by_sub: Dict[str, list] = {}
    order: List[str] = []
    for _g, sub, spec in gadget.inclusions:
        if sub not in by_sub:
            by_sub[sub] = []
            order.append(sub)
        by_sub[sub].append(spec)
    out = []
    for sub in order:
        specs = by_sub[sub]
        for i in range(0, len(specs), INCLUSION_MERGE):
            out.append((f"gq_{sub}_{len(out)}", sub,
                        tuple(specs[i : i + INCLUSION_MERGE])))
    _MERGED_CACHE[key] = out
    return out


# ---------------------------------------------------------------------------
# Subtables: dense prover twins + verifier closed-form key MLEs


def _bit_var(rs: List[int], num_vars: int, bit: int) -> int:
    """Fold variable controlling index bit ``bit`` (MSB-first fold:
    rs[j] <-> bit num_vars-1-j, matching proofs/zerocheck.py)."""
    return rs[num_vars - 1 - bit]


def _bitwise_key_eval(op: str, rs: List[int], p: int) -> int:
    """key(a,b) = a + 2^8 b + 2^16 op(a,b) as a multilinear closed form
    over the 16-bit domain x = a + 2^8 b."""
    acc = 0
    for i in range(8):
        a_i = _bit_var(rs, 16, i) % p
        b_i = _bit_var(rs, 16, 8 + i) % p
        ab = a_i * b_i % p
        if op == "AND":
            o_i = ab
        elif op == "OR":
            o_i = (a_i + b_i - ab) % p
        else:  # XOR
            o_i = (a_i + b_i - 2 * ab) % p
        acc = (acc + (1 << i) * a_i + (1 << (8 + i)) * b_i + (1 << (16 + i)) * o_i) % p
    return acc


def _bitwise_dense_key(op: str, p: int) -> np.ndarray:
    x = np.arange(1 << 16, dtype=np.uint64)
    a = x & _M8
    b = x >> np.uint64(8)
    if op == "AND":
        o = a & b
    elif op == "OR":
        o = a | b
    else:
        o = a ^ b
    return (x + (o << np.uint64(16))) % np.uint64(p)


@dataclass(frozen=True)
class Subtable:
    name: str
    num_vars: int

    def dense_key(self, p: int) -> np.ndarray:
        if self.name == "RANGE16":
            return np.arange(1 << 16, dtype=np.uint64) % np.uint64(p)
        return _bitwise_dense_key(self.name[:-1], p)  # "AND8" -> "AND"

    def key_eval(self, rs: List[int], p: int) -> int:
        if self.name == "RANGE16":
            return idx_eval(16, rs, p)
        return _bitwise_key_eval(self.name[:-1], rs, p)


SUBTABLES: Dict[str, Subtable] = {
    name: Subtable(name, 16) for name in ("RANGE16", "AND8", "OR8", "XOR8")
}


# ---------------------------------------------------------------------------
# Gadgets

# An inclusion is (g_column_name, subtable_name, key_spec) where key_spec
# maps column names to integer coefficients: key = sum coef * col.
Inclusion = Tuple[str, str, Dict[str, int]]


def _pad_cols(arrays: List[np.ndarray], n_pad: int) -> List[np.ndarray]:
    out = []
    for a in arrays:
        b = np.zeros(n_pad, dtype=np.uint64)
        b[: a.shape[0]] = a
        out.append(b)
    return out


def _limbs(prefix: str, v: np.ndarray) -> Dict[str, np.ndarray]:
    """Four little-endian 16-bit limbs of a 64-bit value."""
    return {
        f"{prefix}{j}": (v >> np.uint64(16 * j)) & _M16 for j in range(4)
    }


_LIMB = tuple(range(4))


class _AddSubGadget:
    """ADD: z = x + y mod 2^64 via a 4-limb carry chain; SUB reuses it as
    z + y = x with the roles (x, y, z) = (out, in1, in0)."""

    columns = tuple(f"c{j}" for j in _LIMB) + tuple(
        f"{pre}{j}" for pre in ("x", "y", "z") for j in _LIMB
    )
    inclusions: Tuple[Inclusion, ...] = tuple(
        (f"g_{pre}{j}", "RANGE16", {f"{pre}{j}": 1})
        for pre in ("x", "y", "z") for j in _LIMB
    )

    def __init__(self, is_sub: bool):
        self.is_sub = is_sub

    def build(self, inputs: np.ndarray, outputs: np.ndarray, n_pad: int, p: int):
        if self.is_sub:
            x, y, z = _pad_cols([outputs[:, 0], inputs[:, 1], inputs[:, 0]], n_pad)
        else:
            x, y, z = _pad_cols([inputs[:, 0], inputs[:, 1], outputs[:, 0]], n_pad)
        cols = {**_limbs("x", x), **_limbs("y", y), **_limbs("z", z)}
        carry = np.zeros(n_pad, dtype=np.uint64)
        for j in _LIMB:
            carry = (cols[f"x{j}"] + cols[f"y{j}"] + carry) >> np.uint64(16)
            cols[f"c{j}"] = carry
        return cols

    @staticmethod
    def constraint_arrays(cols, p: int) -> List[np.ndarray]:
        P = np.uint64(p)
        sixt = np.uint64(1 << 16)
        one = np.uint64(1)
        terms = []
        for j in _LIMB:
            cin = cols[f"c{j-1}"] if j else 0
            terms.append(
                (cols[f"x{j}"] + cols[f"y{j}"] + cin + (P - cols[f"z{j}"])
                 + (P - sixt * cols[f"c{j}"] % P)) % P
            )
        for j in _LIMB:
            terms.append(cols[f"c{j}"] * ((one + P - cols[f"c{j}"]) % P) % P)
        return terms

    @staticmethod
    def constraint_scalars(ev, p: int) -> List[int]:
        terms = []
        for j in _LIMB:
            cin = ev[f"c{j-1}"] if j else 0
            terms.append(
                (ev[f"x{j}"] + ev[f"y{j}"] + cin - ev[f"z{j}"]
                 - (1 << 16) * ev[f"c{j}"]) % p
            )
        for j in _LIMB:
            terms.append(ev[f"c{j}"] * (1 - ev[f"c{j}"]) % p)
        return terms


class _BitwiseGadget:
    """AND/OR/XOR via 8-bit chunk triples over the full 64-bit operands;
    no algebraic constraints — each chunk triple's inclusion in the op
    subtable IS the semantics."""

    columns = tuple(
        f"{kind}{k}" for k in range(8) for kind in ("a", "b", "o")
    )

    def __init__(self, op: str):
        self.op = op
        self.inclusions: Tuple[Inclusion, ...] = tuple(
            (f"g{k}", f"{op}8", {f"a{k}": 1, f"b{k}": 1 << 8, f"o{k}": 1 << 16})
            for k in range(8)
        )

    def build(self, inputs: np.ndarray, outputs: np.ndarray, n_pad: int, p: int):
        a, b, o = _pad_cols([inputs[:, 0], inputs[:, 1], outputs[:, 0]], n_pad)
        cols = {}
        for k in range(8):
            sh = np.uint64(8 * k)
            cols[f"a{k}"] = (a >> sh) & _M8
            cols[f"b{k}"] = (b >> sh) & _M8
            cols[f"o{k}"] = (o >> sh) & _M8
        return cols

    @staticmethod
    def constraint_arrays(cols, p: int) -> List[np.ndarray]:
        return []

    @staticmethod
    def constraint_scalars(ev, p: int) -> List[int]:
        return []


def _borrow_chain_arrays(cols, p: int, xp: str, yp: str, dp: str, bp: str,
                         sign: bool) -> List[np.ndarray]:
    """x - y = d - 2^64 b3 limb constraints (vectorized).  With ``sign``
    the top limb is biased by +2^15 on both sides (x3 - 2^16 s_x etc.),
    turning the borrow-out into the SIGNED comparison."""
    P = np.uint64(p)
    sixt = np.uint64(1 << 16)
    terms = []
    for j in _LIMB:
        xs = cols[f"{xp}{j}"]
        ys = cols[f"{yp}{j}"]
        bin_ = cols[f"{bp}{j-1}"] if j else 0
        t = (xs + (P - ys) + (P - bin_ if j else 0) + (P - cols[f"{dp}{j}"])
             + sixt * cols[f"{bp}{j}"] % P) % P
        if sign and j == 3:
            t = (t + (P - sixt * cols["s_x"] % P) + sixt * cols["s_y"] % P) % P
        terms.append(t % P)
    return terms


def _borrow_chain_scalars(ev, p: int, xp: str, yp: str, dp: str, bp: str,
                          sign: bool) -> List[int]:
    terms = []
    for j in _LIMB:
        t = (ev[f"{xp}{j}"] - ev[f"{yp}{j}"] - (ev[f"{bp}{j-1}"] if j else 0)
             - ev[f"{dp}{j}"] + (1 << 16) * ev[f"{bp}{j}"]) % p
        if sign and j == 3:
            t = (t - (1 << 16) * ev["s_x"] + (1 << 16) * ev["s_y"]) % p
        terms.append(t)
    return terms


def _compare_build(x: np.ndarray, y: np.ndarray, signed: bool, p: int):
    """Borrow-chain advice for x < y over 64 bits (optionally signed via
    the +2^63 bias)."""
    if signed:
        bias = np.uint64(1 << 63)
        xe, ye = x ^ bias, y ^ bias
    else:
        xe, ye = x, y
    d = xe - ye  # mod 2^64 (numpy wraps)
    cols = _limbs("d" if not signed else "d", d)
    borrow = np.zeros(len(x), dtype=np.uint64)
    out = {}
    for j in _LIMB:
        xs = (xe >> np.uint64(16 * j)) & _M16
        ys = (ye >> np.uint64(16 * j)) & _M16
        borrow = (xs < ys + borrow).astype(np.uint64)
        out[f"b{j}"] = borrow
    return cols, out


class _SltuGadget:
    """SLTU: out = 1 iff in0 < in1 (unsigned 64-bit) via a 4-limb borrow
    chain: in0 - in1 = d - 2^64 b3 with d range-checked, so b3 IS the
    borrow."""

    columns = tuple(f"b{j}" for j in _LIMB) + tuple(
        f"{pre}{j}" for pre in ("d", "x", "y") for j in _LIMB
    ) + ("o",)
    inclusions: Tuple[Inclusion, ...] = tuple(
        (f"g_{pre}{j}", "RANGE16", {f"{pre}{j}": 1})
        for pre in ("x", "y", "d") for j in _LIMB
    )
    signed = False

    def build(self, inputs: np.ndarray, outputs: np.ndarray, n_pad: int, p: int):
        x, y, o = _pad_cols([inputs[:, 0], inputs[:, 1], outputs[:, 0]], n_pad)
        cols = {**_limbs("x", x), **_limbs("y", y), "o": o}
        d_cols, b_cols = _compare_build(x, y, self.signed, p)
        cols.update(d_cols)
        cols.update(b_cols)
        if self.signed:
            cols["s_x"] = cols["x3"] >> np.uint64(15)
            cols["s_y"] = cols["y3"] >> np.uint64(15)
            cols["rx2"] = (cols["x3"] & np.uint64(0x7FFF)) * np.uint64(2)
            cols["ry2"] = (cols["y3"] & np.uint64(0x7FFF)) * np.uint64(2)
        return cols

    def constraint_arrays(self, cols, p: int) -> List[np.ndarray]:
        P = np.uint64(p)
        one = np.uint64(1)
        terms = _borrow_chain_arrays(cols, p, "x", "y", "d", "b", self.signed)
        bools = [f"b{j}" for j in _LIMB] + (["s_x", "s_y"] if self.signed else [])
        for b in bools:
            terms.append(cols[b] * ((one + P - cols[b]) % P) % P)
        if self.signed:
            sixt = np.uint64(1 << 16)
            two = np.uint64(2)
            terms.append((two * cols["x3"] + (P - sixt * cols["s_x"] % P)
                          + (P - cols["rx2"])) % P)
            terms.append((two * cols["y3"] + (P - sixt * cols["s_y"] % P)
                          + (P - cols["ry2"])) % P)
        terms.append((cols["o"] + P - cols["b3"]) % P)
        return terms

    def constraint_scalars(self, ev, p: int) -> List[int]:
        terms = _borrow_chain_scalars(ev, p, "x", "y", "d", "b", self.signed)
        bools = [f"b{j}" for j in _LIMB] + (["s_x", "s_y"] if self.signed else [])
        for b in bools:
            terms.append(ev[b] * (1 - ev[b]) % p)
        if self.signed:
            terms.append((2 * ev["x3"] - (1 << 16) * ev["s_x"] - ev["rx2"]) % p)
            terms.append((2 * ev["y3"] - (1 << 16) * ev["s_y"] - ev["ry2"]) % p)
        terms.append((ev["o"] - ev["b3"]) % p)
        return terms


class _SltGadget(_SltuGadget):
    """SLT: signed 64-bit compare by biasing both operands with +2^63
    (sign-bit flip on the top limb) and reusing the unsigned borrow chain.
    The sign split 2*x3 = 2^16*s_x + rx2 with rx2 range-checked forces
    s_x = top bit of x3."""

    columns = _SltuGadget.columns + ("rx2", "ry2", "s_x", "s_y")
    inclusions: Tuple[Inclusion, ...] = _SltuGadget.inclusions + tuple(
        (f"g_{c}", "RANGE16", {c: 1}) for c in ("rx2", "ry2")
    )
    signed = True


def _sub_m(a, b, p):
    """a - b mod p for python ints AND canonical uint64 numpy arrays
    (a + p stays < 2^32, so uint64 never wraps)."""
    return (a + p - b) % p


def _mul_m(a, b, p):
    return a * b % p


class _ShiftGadget:
    """SLL/SRL/SRA: out = x << s / x >> s (logical/arithmetic), s = y & 63
    (state.py:248-260, :328-340 — RV64 shamt is the low 6 bits of rs2/imm).

    Core is a staged 128-bit shifter proving v = x * 2^t as 8 carry-free
    16-bit limbs:

      * t = 16*alpha + beta: ``A{i}`` one-hot selects alpha, ``b{i}``
        bits give beta; ``pb = 2^beta`` via two degree-2 partial
        products (pb01, pb23).
      * limb rotation: w_j = sum_i A_i * x_{j-i}            (j = 0..7)
      * sub-limb shift: w_j * pb = lo_j + 2^16 * hi_j with lo/hi
        RANGE16-checked — the unique decomposition of a < 2^32 value.
        v_j = lo_j + hi_{j-1}: lo_j's low beta bits are zero and
        hi_{j-1} < 2^beta, so the sum is carry-free and < 2^16.

    SLL: t = s (alpha in [0,3] keeps the decomposition of y0 unique),
         z_j = v_j (mod-2^64 truncation = dropping the high limbs).
    SRL: t = 64 - s (alpha in [0,4]; s has its own one-hot ``sa{i}`` +
         bits ``sb{i}``, linked by 16a+b + 16sa+sb = 64), z_j = v_{4+j}
         — the high half of x * 2^(64-s) IS x >> s.
    SRA: SRL plus sign fill: z_j = v_{4+j} + sgn * mk_j where mk_j are
         the limbs of 2^64 - 2^(64-s) (committed, bound to the one-hot)
         and sgn is x's top bit via the 2*x3 = 2^16*sgn + rx2 split.
         Fill bits sit strictly above the SRL result, so no carries.

    The shift amount binds to the query via y0 = (16sa+sb) + 64*yq with
    64*yq RANGE16-checked (yq < 2^10, unique since s < 64 <= 2^6).
    """

    def __init__(self, kind: str):
        assert kind in ("SLL", "SRL", "SRA")
        self.kind = kind
        na = self._n_alpha = 4 if kind == "SLL" else 5
        cols = [f"{pre}{j}" for pre in ("x", "y", "z") for j in _LIMB]
        cols += ["yq", "pb01", "pb23", "pb"]
        cols += [f"b{i}" for i in range(4)]
        cols += [f"A{i}" for i in range(na)]
        if kind != "SLL":
            cols += [f"sa{i}" for i in range(4)] + [f"sb{i}" for i in range(4)]
        cols += [f"w{j}" for j in range(8)]
        cols += [f"lo{j}" for j in range(8)]
        cols += [f"hi{j}" for j in range(7)]
        if kind == "SRA":
            cols += ["sgn", "rx2"] + [f"mk{j}" for j in _LIMB]
        self.columns = tuple(sorted(cols))
        inc = [
            (f"g_{pre}{j}", "RANGE16", {f"{pre}{j}": 1})
            for pre in ("x", "y", "z") for j in _LIMB
        ]
        inc.append(("g_yq", "RANGE16", {"yq": 64}))
        inc += [(f"g_lo{j}", "RANGE16", {f"lo{j}": 1}) for j in range(8)]
        inc += [(f"g_hi{j}", "RANGE16", {f"hi{j}": 1}) for j in range(7)]
        if kind == "SRA":
            inc.append(("g_rx2", "RANGE16", {"rx2": 1}))
        self.inclusions: Tuple[Inclusion, ...] = tuple(inc)

    def build(self, inputs: np.ndarray, outputs: np.ndarray, n_pad: int, p: int):
        one = np.uint64(1)
        x, y, z = _pad_cols([inputs[:, 0], inputs[:, 1], outputs[:, 0]], n_pad)
        cols = {**_limbs("x", x), **_limbs("y", y), **_limbs("z", z)}
        s = y & np.uint64(63)
        cols["yq"] = (y & _M16) >> np.uint64(6)
        t = s if self.kind == "SLL" else np.uint64(64) - s
        alpha = t >> np.uint64(4)
        beta = t & np.uint64(15)
        for i in range(4):
            cols[f"b{i}"] = (beta >> np.uint64(i)) & one
        for i in range(self._n_alpha):
            cols[f"A{i}"] = (alpha == i).astype(np.uint64)
        if self.kind != "SLL":
            for i in range(4):
                cols[f"sa{i}"] = ((s >> np.uint64(4)) == i).astype(np.uint64)
                cols[f"sb{i}"] = (s >> np.uint64(i)) & one
        pb = one << beta
        cols["pb01"] = (one + cols["b0"]) * (one + np.uint64(3) * cols["b1"])
        cols["pb23"] = (one + np.uint64(15) * cols["b2"]) * (
            one + np.uint64(255) * cols["b3"]
        )
        cols["pb"] = pb
        for j in range(8):
            w = np.zeros(n_pad, dtype=np.uint64)
            for i in range(self._n_alpha):
                if 0 <= j - i <= 3:
                    w += cols[f"A{i}"] * cols[f"x{j - i}"]
            cols[f"w{j}"] = w
            prod = w * pb
            cols[f"lo{j}"] = prod & _M16
            if j < 7:
                cols[f"hi{j}"] = prod >> np.uint64(16)
        if self.kind == "SRA":
            cols["sgn"] = cols["x3"] >> np.uint64(15)
            cols["rx2"] = (cols["x3"] & np.uint64(0x7FFF)) * np.uint64(2)
            for j in _LIMB:
                low = np.where(
                    alpha > j, np.uint64(0xFFFF),
                    np.where(alpha == j, pb - one, np.uint64(0)),
                )
                cols[f"mk{j}"] = np.uint64(0xFFFF) - low
        return cols

    def _terms(self, ev, p: int):
        """Constraint terms; ev values are python ints OR canonical
        uint64 arrays — every operation goes through _sub_m/_mul_m."""
        na = self._n_alpha
        one = 1 % p
        terms = []
        bools = [f"A{i}" for i in range(na)] + [f"b{i}" for i in range(4)]
        if self.kind != "SLL":
            bools += [f"sa{i}" for i in range(4)] + [f"sb{i}" for i in range(4)]
        if self.kind == "SRA":
            bools.append("sgn")
        for name in bools:
            terms.append(_mul_m(ev[name], _sub_m(one, ev[name], p), p))
        onehot_a = 0
        for i in range(na):
            onehot_a = (onehot_a + ev[f"A{i}"]) % p
        terms.append(_sub_m(onehot_a, one, p))
        t_lin = 0
        for i in range(na):
            t_lin = (t_lin + (16 * i % p) * ev[f"A{i}"]) % p
        for i in range(4):
            t_lin = (t_lin + (1 << i) * ev[f"b{i}"]) % p
        if self.kind == "SLL":
            s_lin = t_lin
        else:
            onehot_s = 0
            s_lin = 0
            for i in range(4):
                onehot_s = (onehot_s + ev[f"sa{i}"]) % p
                s_lin = (s_lin + (16 * i % p) * ev[f"sa{i}"]
                         + (1 << i) * ev[f"sb{i}"]) % p
            terms.append(_sub_m(onehot_s, one, p))
            terms.append(_sub_m((t_lin + s_lin) % p, 64 % p, p))
        # y0 = s + 64*yq.
        terms.append(_sub_m(ev["y0"], (s_lin + 64 * ev["yq"]) % p, p))
        # pb = 2^beta via two partial products.
        terms.append(_sub_m(
            ev["pb01"],
            _mul_m((one + ev["b0"]) % p, (one + 3 * ev["b1"]) % p, p), p))
        terms.append(_sub_m(
            ev["pb23"],
            _mul_m((one + 15 * ev["b2"]) % p, (one + 255 * ev["b3"]) % p, p), p))
        terms.append(_sub_m(ev["pb"], _mul_m(ev["pb01"], ev["pb23"], p), p))
        # Rotation and sub-limb shift.
        for j in range(8):
            rot = 0
            for i in range(na):
                if 0 <= j - i <= 3:
                    rot = (rot + _mul_m(ev[f"A{i}"], ev[f"x{j - i}"], p)) % p
            terms.append(_sub_m(ev[f"w{j}"], rot, p))
            rhs = ev[f"lo{j}"] if j == 7 else (
                ev[f"lo{j}"] + (1 << 16) * ev[f"hi{j}"]
            ) % p
            terms.append(_sub_m(_mul_m(ev[f"w{j}"], ev["pb"], p), rhs, p))
        # Output limbs.
        off = 0 if self.kind == "SLL" else 4
        for j in _LIMB:
            v = ev[f"lo{off + j}"]
            if off + j > 0:
                v = (v + ev[f"hi{off + j - 1}"]) % p
            if self.kind == "SRA":
                v = (v + _mul_m(ev["sgn"], ev[f"mk{j}"], p)) % p
            terms.append(_sub_m(ev[f"z{j}"], v, p))
        if self.kind == "SRA":
            terms.append(_sub_m(
                2 * ev["x3"] % p, ((1 << 16) * ev["sgn"] + ev["rx2"]) % p, p))
            # mk_j = 0xFFFF - (0xFFFF*[j < alpha] + (pb-1)*[j == alpha]).
            for j in _LIMB:
                above = 0
                for i in range(j + 1, na):
                    above = (above + ev[f"A{i}"]) % p
                low = (0xFFFF * above
                       + _mul_m(ev[f"A{j}"], _sub_m(ev["pb"], one, p), p)) % p
                terms.append(_sub_m(ev[f"mk{j}"], _sub_m(0xFFFF % p, low, p), p))
        return terms

    def constraint_arrays(self, cols, p: int) -> List[np.ndarray]:
        return self._terms(cols, p)

    def constraint_scalars(self, ev, p: int) -> List[int]:
        return self._terms(ev, p)




class _AddSubWGadget:
    """ADDW: z = sext32(x + y mod 2^32) via a 2-limb carry chain on the
    low halves; SUBW reuses it as z + y = x (mod 2^32).  The sign
    extension is the 2*z1 = 2^16*sw + rz2 top-bit split."""

    columns = tuple(f"{pre}{j}" for pre in ("x", "y", "z") for j in _LIMB) + (
        "c0", "c1", "sw", "rz2",
    )
    inclusions: Tuple[Inclusion, ...] = tuple(
        (f"g_{pre}{j}", "RANGE16", {f"{pre}{j}": 1})
        for pre in ("x", "y") for j in _LIMB
    ) + (
        ("g_z0", "RANGE16", {"z0": 1}),
        ("g_z1", "RANGE16", {"z1": 1}),
        ("g_rz2", "RANGE16", {"rz2": 1}),
    )

    def __init__(self, is_sub: bool):
        self.is_sub = is_sub

    def build(self, inputs: np.ndarray, outputs: np.ndarray, n_pad: int, p: int):
        x, y, z = _pad_cols([inputs[:, 0], inputs[:, 1], outputs[:, 0]], n_pad)
        cols = {**_limbs("x", x), **_limbs("y", y), **_limbs("z", z)}
        a, b = (z, y) if self.is_sub else (x, y)
        lo_sum0 = (a & _M16) + (b & _M16)
        c0 = lo_sum0 >> np.uint64(16)
        cols["c0"] = c0
        cols["c1"] = (((a >> np.uint64(16)) & _M16)
                      + ((b >> np.uint64(16)) & _M16) + c0) >> np.uint64(16)
        cols["sw"] = cols["z1"] >> np.uint64(15)
        cols["rz2"] = (cols["z1"] & np.uint64(0x7FFF)) * np.uint64(2)
        return cols

    def _terms(self, ev, p: int):
        one = 1 % p
        a, b, out = (("z", "y", "x") if self.is_sub else ("x", "y", "z"))
        terms = []
        # a + b = out (mod 2^32) over 2 limbs; the carry out is dropped.
        terms.append(_sub_m(
            (ev[f"{a}0"] + ev[f"{b}0"]) % p,
            (ev[f"{out}0"] + (1 << 16) * ev["c0"]) % p, p))
        terms.append(_sub_m(
            (ev[f"{a}1"] + ev[f"{b}1"] + ev["c0"]) % p,
            (ev[f"{out}1"] + (1 << 16) * ev["c1"]) % p, p))
        for c in ("c0", "c1", "sw"):
            terms.append(_mul_m(ev[c], _sub_m(one, ev[c], p), p))
        terms.append(_sub_m(2 * ev["z1"] % p,
                            ((1 << 16) * ev["sw"] + ev["rz2"]) % p, p))
        terms.append(_sub_m(ev["z2"], 0xFFFF * ev["sw"] % p, p))
        terms.append(_sub_m(ev["z3"], 0xFFFF * ev["sw"] % p, p))
        return terms

    def constraint_arrays(self, cols, p: int) -> List[np.ndarray]:
        return self._terms(cols, p)

    def constraint_scalars(self, ev, p: int) -> List[int]:
        return self._terms(ev, p)


class _ShiftWGadget:
    """SLLW/SRLW/SRAW: 32-bit shifts of the LOW half of x, s = y & 31,
    result sign-extended to 64 bits.  Same staged shifter as the 64-bit
    gadget, over a 2-limb input producing 4 sub-limb stages."""

    def __init__(self, kind: str):
        assert kind in ("SLLW", "SRLW", "SRAW")
        self.kind = kind
        na = self._n_alpha = 2 if kind == "SLLW" else 3
        cols = [f"{pre}{j}" for pre in ("x", "y", "z") for j in _LIMB]
        cols += ["yq", "pb01", "pb23", "pb"]
        cols += [f"b{i}" for i in range(4)]
        cols += [f"A{i}" for i in range(na)]
        if kind != "SLLW":
            cols += [f"sa{i}" for i in range(2)] + [f"sb{i}" for i in range(4)]
        cols += [f"w{j}" for j in range(4)]
        cols += [f"lo{j}" for j in range(4)]
        cols += [f"hi{j}" for j in range(3)]
        if kind == "SRAW":
            cols += ["sgnw", "rx1w", "mk0", "mk1"]
        else:
            cols += ["sw", "rtop"]
        self.columns = tuple(sorted(cols))
        inc = [
            (f"g_{pre}{j}", "RANGE16", {f"{pre}{j}": 1})
            for pre in ("x", "y") for j in _LIMB
        ]
        inc += [("g_z0", "RANGE16", {"z0": 1}), ("g_z1", "RANGE16", {"z1": 1})]
        inc.append(("g_yq", "RANGE16", {"yq": 32}))
        inc += [(f"g_lo{j}", "RANGE16", {f"lo{j}": 1}) for j in range(4)]
        inc += [(f"g_hi{j}", "RANGE16", {f"hi{j}": 1}) for j in range(3)]
        if kind == "SRAW":
            inc.append(("g_rx1w", "RANGE16", {"rx1w": 1}))
        else:
            inc.append(("g_rtop", "RANGE16", {"rtop": 1}))
        self.inclusions: Tuple[Inclusion, ...] = tuple(inc)

    def build(self, inputs: np.ndarray, outputs: np.ndarray, n_pad: int, p: int):
        one = np.uint64(1)
        x, y, z = _pad_cols([inputs[:, 0], inputs[:, 1], outputs[:, 0]], n_pad)
        cols = {**_limbs("x", x), **_limbs("y", y), **_limbs("z", z)}
        s = y & np.uint64(31)
        cols["yq"] = (y & _M16) >> np.uint64(5)
        t = s if self.kind == "SLLW" else np.uint64(32) - s
        alpha = t >> np.uint64(4)
        beta = t & np.uint64(15)
        for i in range(4):
            cols[f"b{i}"] = (beta >> np.uint64(i)) & one
        for i in range(self._n_alpha):
            cols[f"A{i}"] = (alpha == i).astype(np.uint64)
        if self.kind != "SLLW":
            for i in range(2):
                cols[f"sa{i}"] = ((s >> np.uint64(4)) == i).astype(np.uint64)
            for i in range(4):
                cols[f"sb{i}"] = (s >> np.uint64(i)) & one
        pb = one << beta
        cols["pb01"] = (one + cols["b0"]) * (one + np.uint64(3) * cols["b1"])
        cols["pb23"] = (one + np.uint64(15) * cols["b2"]) * (
            one + np.uint64(255) * cols["b3"]
        )
        cols["pb"] = pb
        for j in range(4):
            w = np.zeros(n_pad, dtype=np.uint64)
            for i in range(self._n_alpha):
                if 0 <= j - i <= 1:
                    w += cols[f"A{i}"] * cols[f"x{j - i}"]
            cols[f"w{j}"] = w
            prod = w * pb
            cols[f"lo{j}"] = prod & _M16
            if j < 3:
                cols[f"hi{j}"] = prod >> np.uint64(16)
        if self.kind == "SRAW":
            cols["sgnw"] = cols["x1"] >> np.uint64(15)
            cols["rx1w"] = (cols["x1"] & np.uint64(0x7FFF)) * np.uint64(2)
            for j in range(2):
                low = np.where(
                    alpha > j, np.uint64(0xFFFF),
                    np.where(alpha == j, pb - one, np.uint64(0)),
                )
                cols[f"mk{j}"] = np.uint64(0xFFFF) - low
        else:
            cols["sw"] = cols["z1"] >> np.uint64(15)
            cols["rtop"] = (cols["z1"] & np.uint64(0x7FFF)) * np.uint64(2)
        return cols

    def _terms(self, ev, p: int):
        na = self._n_alpha
        one = 1 % p
        terms = []
        bools = [f"A{i}" for i in range(na)] + [f"b{i}" for i in range(4)]
        if self.kind != "SLLW":
            bools += [f"sa{i}" for i in range(2)] + [f"sb{i}" for i in range(4)]
        if self.kind == "SRAW":
            bools.append("sgnw")
        else:
            bools.append("sw")
        for name in bools:
            terms.append(_mul_m(ev[name], _sub_m(one, ev[name], p), p))
        onehot_a = 0
        for i in range(na):
            onehot_a = (onehot_a + ev[f"A{i}"]) % p
        terms.append(_sub_m(onehot_a, one, p))
        t_lin = 0
        for i in range(na):
            t_lin = (t_lin + (16 * i % p) * ev[f"A{i}"]) % p
        for i in range(4):
            t_lin = (t_lin + (1 << i) * ev[f"b{i}"]) % p
        if self.kind == "SLLW":
            s_lin = t_lin
        else:
            onehot_s = 0
            s_lin = 0
            for i in range(2):
                onehot_s = (onehot_s + ev[f"sa{i}"]) % p
                s_lin = (s_lin + (16 * i % p) * ev[f"sa{i}"]) % p
            for i in range(4):
                s_lin = (s_lin + (1 << i) * ev[f"sb{i}"]) % p
            terms.append(_sub_m(onehot_s, one, p))
            terms.append(_sub_m((t_lin + s_lin) % p, 32 % p, p))
        # y0 = s + 32*yq.
        terms.append(_sub_m(ev["y0"], (s_lin + 32 * ev["yq"]) % p, p))
        terms.append(_sub_m(
            ev["pb01"],
            _mul_m((one + ev["b0"]) % p, (one + 3 * ev["b1"]) % p, p), p))
        terms.append(_sub_m(
            ev["pb23"],
            _mul_m((one + 15 * ev["b2"]) % p, (one + 255 * ev["b3"]) % p, p), p))
        terms.append(_sub_m(ev["pb"], _mul_m(ev["pb01"], ev["pb23"], p), p))
        for j in range(4):
            rot = 0
            for i in range(na):
                if 0 <= j - i <= 1:
                    rot = (rot + _mul_m(ev[f"A{i}"], ev[f"x{j - i}"], p)) % p
            terms.append(_sub_m(ev[f"w{j}"], rot, p))
            rhs = ev[f"lo{j}"] if j == 3 else (
                ev[f"lo{j}"] + (1 << 16) * ev[f"hi{j}"]
            ) % p
            terms.append(_sub_m(_mul_m(ev[f"w{j}"], ev["pb"], p), rhs, p))
        off = 0 if self.kind == "SLLW" else 2
        r32 = []
        for j in range(2):
            v = ev[f"lo{off + j}"]
            if off + j > 0:
                v = (v + ev[f"hi{off + j - 1}"]) % p
            if self.kind == "SRAW":
                v = (v + _mul_m(ev["sgnw"], ev[f"mk{j}"], p)) % p
            r32.append(v)
            terms.append(_sub_m(ev[f"z{j}"], v, p))
        if self.kind == "SRAW":
            fill = ev["sgnw"]
            terms.append(_sub_m(
                2 * ev["x1"] % p, ((1 << 16) * ev["sgnw"] + ev["rx1w"]) % p, p))
            for j in range(2):
                above = 0
                for i in range(j + 1, na):
                    above = (above + ev[f"A{i}"]) % p
                low = (0xFFFF * above
                       + _mul_m(ev[f"A{j}"], _sub_m(ev["pb"], one, p), p)) % p
                terms.append(_sub_m(ev[f"mk{j}"], _sub_m(0xFFFF % p, low, p), p))
        else:
            fill = ev["sw"]
            terms.append(_sub_m(
                2 * ev["z1"] % p, ((1 << 16) * ev["sw"] + ev["rtop"]) % p, p))
        terms.append(_sub_m(ev["z2"], 0xFFFF * fill % p, p))
        terms.append(_sub_m(ev["z3"], 0xFFFF * fill % p, p))
        return terms

    def constraint_arrays(self, cols, p: int) -> List[np.ndarray]:
        return self._terms(cols, p)

    def constraint_scalars(self, ev, p: int) -> List[int]:
        return self._terms(ev, p)




class _MulGadget:
    """MUL/MULH/MULHSU/MULHU/MULW via an 8-bit-chunk schoolbook product.

    BabyBear (p ~ 2^31) cannot hold 16-bit limb products exactly, so the
    multiplier works in bytes: committed xb/yb byte decompositions (the
    linkage reconstructs the 16-bit operand limbs as byte pairs, like
    the bitwise gadget) and the FULL 128-bit product zb_0..15 with a
    carry chain S_k + c_{k-1} = zb_k + 256 c_k where
    S_k = sum_{i+j=k} xb_i yb_j < 2^20 — every constraint quantity stays
    far below p, so the mod-p identities hold over the integers.

    Outputs: MUL = zb_0..7; MULHU = zb_8..15; MULW = sext32(zb_0..3)
    via a top-bit split; MULH/MULHSU subtract the signed corrections
    (high(x_s*y_s) = zhi - sx*y [- sy*x] mod 2^64) with a byte borrow
    chain whose borrows are < 4 (RANGE16 * 2^14)."""

    _SIGNED = {"MULH": (True, True), "MULHSU": (True, False)}

    def __init__(self, kind: str):
        assert kind in ("MUL", "MULH", "MULHSU", "MULHU", "MULW")
        self.kind = kind
        cols = [f"xb{i}" for i in range(8)] + [f"yb{i}" for i in range(8)]
        cols += [f"zb{i}" for i in range(16)]
        cols += [f"c{i}" for i in range(15)]
        if kind == "MULW":
            cols += ["sw", "rw"]
        if kind in self._SIGNED:
            cols += ["sx", "rx"] + [f"wb{i}" for i in range(8)]
            cols += [f"bw{i}" for i in range(8)]
            if self._SIGNED[kind][1]:
                cols += ["sy", "ry"]
        self.columns = tuple(sorted(cols))
        inc = [(f"g_xb{i}", "RANGE16", {f"xb{i}": 256}) for i in range(8)]
        inc += [(f"g_yb{i}", "RANGE16", {f"yb{i}": 256}) for i in range(8)]
        inc += [(f"g_zb{i}", "RANGE16", {f"zb{i}": 256}) for i in range(16)]
        inc += [(f"g_c{i}", "RANGE16", {f"c{i}": 16}) for i in range(15)]
        if kind == "MULW":
            inc.append(("g_rw", "RANGE16", {"rw": 256}))
        if kind in self._SIGNED:
            inc.append(("g_rx", "RANGE16", {"rx": 256}))
            inc += [(f"g_wb{i}", "RANGE16", {f"wb{i}": 256}) for i in range(8)]
            inc += [(f"g_bw{i}", "RANGE16", {f"bw{i}": 1 << 14})
                    for i in range(8)]
            if self._SIGNED[kind][1]:
                inc.append(("g_ry", "RANGE16", {"ry": 256}))
        self.inclusions: Tuple[Inclusion, ...] = tuple(inc)

    def build(self, inputs: np.ndarray, outputs: np.ndarray, n_pad: int, p: int):
        x, y, _z = _pad_cols([inputs[:, 0], inputs[:, 1], outputs[:, 0]], n_pad)
        cols = {}
        for i in range(8):
            cols[f"xb{i}"] = (x >> np.uint64(8 * i)) & _M8
            cols[f"yb{i}"] = (y >> np.uint64(8 * i)) & _M8
        carry = np.zeros(n_pad, dtype=np.uint64)
        for k in range(15):
            s = carry.copy()
            for i in range(max(0, k - 7), min(8, k + 1)):
                s += cols[f"xb{i}"] * cols[f"yb{k - i}"]
            cols[f"zb{k}"] = s & _M8
            carry = s >> np.uint64(8)
            cols[f"c{k}"] = carry
        cols["zb15"] = carry
        if self.kind == "MULW":
            cols["sw"] = cols["zb3"] >> np.uint64(7)
            cols["rw"] = (cols["zb3"] & np.uint64(0x7F)) * np.uint64(2)
        if self.kind in self._SIGNED:
            cols["sx"] = cols["xb7"] >> np.uint64(7)
            cols["rx"] = (cols["xb7"] & np.uint64(0x7F)) * np.uint64(2)
            sy_on = self._SIGNED[self.kind][1]
            if sy_on:
                cols["sy"] = cols["yb7"] >> np.uint64(7)
                cols["ry"] = (cols["yb7"] & np.uint64(0x7F)) * np.uint64(2)
            # w = (zhi - sx*y [- sy*x]) mod 2^64, borrows derived exactly
            # from the per-byte identity.
            zhi = np.zeros(n_pad, dtype=np.uint64)
            for k in range(8):
                zhi |= cols[f"zb{8 + k}"] << np.uint64(8 * k)
            w64 = zhi - cols["sx"] * y
            if sy_on:
                w64 = w64 - cols["sy"] * x
            borrow = np.zeros(n_pad, dtype=np.uint64)
            for k in range(8):
                wbk = (w64 >> np.uint64(8 * k)) & _M8
                cols[f"wb{k}"] = wbk
                sub = cols["sx"] * cols[f"yb{k}"] + borrow
                if sy_on:
                    sub = sub + cols["sy"] * cols[f"xb{k}"]
                borrow = (wbk + sub - cols[f"zb{8 + k}"]) >> np.uint64(8)
                cols[f"bw{k}"] = borrow
        return cols

    def _terms(self, ev, p: int):
        terms = []
        for k in range(15):
            s = ev[f"c{k-1}"] if k else 0
            for i in range(max(0, k - 7), min(8, k + 1)):
                s = (s + _mul_m(ev[f"xb{i}"], ev[f"yb{k - i}"], p)) % p
            terms.append(_sub_m(s, (ev[f"zb{k}"] + 256 * ev[f"c{k}"]) % p, p))
        terms.append(_sub_m(ev["zb15"], ev["c14"], p))
        if self.kind == "MULW":
            terms.append(_mul_m(ev["sw"], _sub_m(1 % p, ev["sw"], p), p))
            terms.append(_sub_m(2 * ev["zb3"] % p,
                                (256 * ev["sw"] + ev["rw"]) % p, p))
        if self.kind in self._SIGNED:
            sy_on = self._SIGNED[self.kind][1]
            terms.append(_mul_m(ev["sx"], _sub_m(1 % p, ev["sx"], p), p))
            terms.append(_sub_m(2 * ev["xb7"] % p,
                                (256 * ev["sx"] + ev["rx"]) % p, p))
            if sy_on:
                terms.append(_mul_m(ev["sy"], _sub_m(1 % p, ev["sy"], p), p))
                terms.append(_sub_m(2 * ev["yb7"] % p,
                                    (256 * ev["sy"] + ev["ry"]) % p, p))
            for k in range(8):
                sub = _mul_m(ev["sx"], ev[f"yb{k}"], p)
                if sy_on:
                    sub = (sub + _mul_m(ev["sy"], ev[f"xb{k}"], p)) % p
                if k:
                    sub = (sub + ev[f"bw{k-1}"]) % p
                lhs = (ev[f"zb{8 + k}"] + 256 * ev[f"bw{k}"]) % p
                terms.append(_sub_m(lhs, (ev[f"wb{k}"] + sub) % p, p))
        return terms

    def constraint_arrays(self, cols, p: int) -> List[np.ndarray]:
        return self._terms(cols, p)

    def constraint_scalars(self, ev, p: int) -> List[int]:
        return self._terms(ev, p)




class _DivGadget:
    """DIV/DIVU/REM/REMU (width=8 bytes) and their W variants (width=4,
    sign-extended outputs) via byte-chunk long arithmetic.

    Core relation (on the unsigned operands ux, uy): a combined
    product-accumulate chain proves uq*uy + ur = ux exactly AND that the
    product never overflows the width (high partial sums + carries must
    vanish); a byte borrow chain proves ur < uy whenever uy != 0; a
    byte-sum inverse gadget detects uy == 0, in which case uq is forced
    to all-ones (RISC-V div-by-zero) while ur = ux falls out of the
    chain.  Signed kinds wrap the core with four conditional two's-
    complement chains (x->ax, y->ay, aq->q, ar->r; the quotient negation
    is gated by the committed XOR sq of the operand signs, the remainder
    follows the dividend).  The INT_MIN/-1 overflow needs no special
    case: |INT_MIN|/1 = 2^63 re-negated by sq=0 reproduces INT_MIN's bit
    pattern and r = 0, exactly the mandated result.  W variants run the
    core on the LOW 4 bytes (RV64 ignores the upper half) and pin the
    64-bit outputs through top-bit sign-extension splits.

    All constraint quantities stay below 2^20 << p, so every mod-p
    identity holds over the integers (same discipline as _MulGadget)."""

    def __init__(self, kind: str):
        assert kind in ("DIV", "DIVU", "REM", "REMU",
                        "DIVW", "DIVUW", "REMW", "REMUW")
        self.kind = kind
        self.width = 4 if kind.endswith("W") else 8
        self.signed = kind in ("DIV", "REM", "DIVW", "REMW")
        self.rem = kind.startswith("REM")
        W = self.width
        cols = [f"xb{i}" for i in range(8)] + [f"yb{i}" for i in range(8)]
        cols += [f"qb{i}" for i in range(W)] + [f"rb{i}" for i in range(W)]
        if self.signed:
            cols += ["sx", "rxs", "sy", "rys", "sq"]
            cols += [f"axb{i}" for i in range(W)]
            cols += [f"ayb{i}" for i in range(W)]
            cols += [f"aqb{i}" for i in range(W)]
            cols += [f"arb{i}" for i in range(W)]
            for pre in ("ncx", "ncy", "ncq", "ncr"):
                cols += [f"{pre}{i}" for i in range(W)]
        cols += [f"c{i}" for i in range(2 * W - 1)]
        cols += [f"db{i}" for i in range(W)] + [f"bb{i}" for i in range(W)]
        cols += ["zy", "iy"]
        if W == 4:
            cols += ["swq", "rwq", "swr", "rwr"]
        self.columns = tuple(sorted(cols))
        inc = [(f"g_xb{i}", "RANGE16", {f"xb{i}": 256}) for i in range(8)]
        inc += [(f"g_yb{i}", "RANGE16", {f"yb{i}": 256}) for i in range(8)]
        inc += [(f"g_qb{i}", "RANGE16", {f"qb{i}": 256}) for i in range(W)]
        inc += [(f"g_rb{i}", "RANGE16", {f"rb{i}": 256}) for i in range(W)]
        if self.signed:
            inc += [("g_rxs", "RANGE16", {"rxs": 256}),
                    ("g_rys", "RANGE16", {"rys": 256})]
            for pre in ("axb", "ayb", "aqb", "arb"):
                inc += [(f"g_{pre}{i}", "RANGE16", {f"{pre}{i}": 256})
                        for i in range(W)]
        inc += [(f"g_c{i}", "RANGE16", {f"c{i}": 16}) for i in range(2 * W - 1)]
        inc += [(f"g_db{i}", "RANGE16", {f"db{i}": 256}) for i in range(W)]
        if W == 4:
            inc += [("g_rwq", "RANGE16", {"rwq": 256}),
                    ("g_rwr", "RANGE16", {"rwr": 256})]
        self.inclusions: Tuple[Inclusion, ...] = tuple(inc)

    # -- honest witness -----------------------------------------------------
    def build(self, inputs: np.ndarray, outputs: np.ndarray, n_pad: int, p: int):
        W = self.width
        x, y, _z = _pad_cols([inputs[:, 0], inputs[:, 1], outputs[:, 0]], n_pad)
        cols = {}
        for i in range(8):
            cols[f"xb{i}"] = (x >> np.uint64(8 * i)) & _M8
            cols[f"yb{i}"] = (y >> np.uint64(8 * i)) & _M8
        WM = np.uint64((1 << (8 * W)) - 1)
        xw = x & WM
        yw = y & WM
        if self.signed:
            top = np.uint64(8 * W - 1)
            sx = (xw >> top) & np.uint64(1)
            sy = (yw >> top) & np.uint64(1)
            ax = np.where(sx == 1, (np.uint64(0) - xw) & WM, xw)
            ay = np.where(sy == 1, (np.uint64(0) - yw) & WM, yw)
            cols["sx"], cols["sy"] = sx, sy
            cols["rxs"] = (cols[f"xb{W-1}"] & np.uint64(0x7F)) * np.uint64(2)
            cols["rys"] = (cols[f"yb{W-1}"] & np.uint64(0x7F)) * np.uint64(2)
            cols["sq"] = sx ^ sy
        else:
            ax, ay = xw, yw
        zy = (ay == 0).astype(np.uint64)
        aq = np.where(zy == 1, WM, ax // np.maximum(ay, np.uint64(1)))
        ar = np.where(zy == 1, ax, ax % np.maximum(ay, np.uint64(1)))
        if self.signed:
            # div-by-zero: q is the all-ones pattern regardless of signs;
            # pick the a-side advice that re-negates to it.
            aq = np.where((zy == 1) & (cols["sq"] == 1), np.uint64(1), aq)
            q = np.where(cols["sq"] == 1, (np.uint64(0) - aq) & WM, aq)
            r = np.where(cols["sx"] == 1, (np.uint64(0) - ar) & WM, ar)
            for pre, v in (("axb", ax), ("ayb", ay), ("aqb", aq), ("arb", ar),
                           ("qb", q), ("rb", r)):
                for i in range(W):
                    cols[f"{pre}{i}"] = (v >> np.uint64(8 * i)) & _M8
            for pre, sgate, orig, neg in (
                ("ncx", cols["sx"], xw, ax), ("ncy", cols["sy"], yw, ay),
                ("ncq", cols["sq"], aq, q), ("ncr", cols["sx"], ar, r),
            ):
                carry = np.zeros(n_pad, dtype=np.uint64)
                for i in range(W):
                    s = ((orig >> np.uint64(8 * i)) & _M8)                         + ((neg >> np.uint64(8 * i)) & _M8) + carry
                    carry = s >> np.uint64(8)
                    cols[f"{pre}{i}"] = np.where(sgate == 1, carry, np.uint64(0))
        else:
            q, r = aq, ar
            for pre, v in (("qb", q), ("rb", r)):
                for i in range(W):
                    cols[f"{pre}{i}"] = (v >> np.uint64(8 * i)) & _M8
        # Core chain: aq*ay + ar = ax with vanishing high half.
        uq = [(aq >> np.uint64(8 * i)) & _M8 for i in range(W)]
        uy = [(ay >> np.uint64(8 * i)) & _M8 for i in range(W)]
        uxb = [(ax >> np.uint64(8 * i)) & _M8 for i in range(W)]
        urb = [(ar >> np.uint64(8 * i)) & _M8 for i in range(W)]
        carry = np.zeros(n_pad, dtype=np.uint64)
        for k in range(2 * W - 1):
            s = carry.copy()
            for i in range(max(0, k - W + 1), min(W, k + 1)):
                s += uq[i] * uy[k - i]
            if k < W:
                s += urb[k]
            tgt = uxb[k] if k < W else np.uint64(0)
            carry = (s - tgt) >> np.uint64(8)
            cols[f"c{k}"] = carry
        # Compare ar < ay (borrow chain), meaningful when ay != 0.
        borrow = np.zeros(n_pad, dtype=np.uint64)
        for k in range(W):
            d = urb[k] + np.uint64(512) - uy[k] - borrow
            cols[f"db{k}"] = d & _M8
            borrow = (np.uint64(512) - (d - (d & _M8))) >> np.uint64(8)
            cols[f"bb{k}"] = borrow
        cols["zy"] = zy
        ysum = np.zeros(n_pad, dtype=np.uint64)
        for i in range(W):
            ysum += uy[i]
        cols["iy"] = np_inv(ysum % np.uint64(p), p)
        if W == 4:
            cols["swq"] = cols["qb3"] >> np.uint64(7)
            cols["rwq"] = (cols["qb3"] & np.uint64(0x7F)) * np.uint64(2)
            cols["swr"] = cols["rb3"] >> np.uint64(7)
            cols["rwr"] = (cols["rb3"] & np.uint64(0x7F)) * np.uint64(2)
        return cols

    # -- constraints ----------------------------------------------------------
    def _core_names(self):
        W = self.width
        if self.signed:
            return ("aqb", "ayb", "arb", "axb")
        return ("qb", "yb", "rb", "xb")

    def _terms(self, ev, p: int):
        W = self.width
        one = 1 % p
        qn, yn, rn, xn = self._core_names()
        terms = []
        if self.signed:
            for s, rr, bn in (("sx", "rxs", f"xb{W-1}"), ("sy", "rys", f"yb{W-1}")):
                terms.append(_mul_m(ev[s], _sub_m(one, ev[s], p), p))
                terms.append(_sub_m(2 * ev[bn] % p,
                                    (256 * ev[s] + ev[rr]) % p, p))
            terms.append(_sub_m(
                ev["sq"],
                _sub_m((ev["sx"] + ev["sy"]) % p,
                       2 * _mul_m(ev["sx"], ev["sy"], p) % p, p), p))
            for pre, sgate, orig, neg in (
                ("ncx", "sx", "xb", "axb"), ("ncy", "sy", "yb", "ayb"),
                ("ncq", "sq", "aqb", "qb"), ("ncr", "sx", "arb", "rb"),
            ):
                sg = ev[sgate]
                for i in range(W):
                    # gated: sg=0 -> neg == orig; sg=1 -> two's complement
                    # chain orig + neg + cc_{i-1} = 256*cc_i (+2^64 wrap).
                    terms.append(_mul_m(
                        _sub_m(one, sg, p),
                        _sub_m(ev[f"{neg}{i}"], ev[f"{orig}{i}"], p), p))
                    cc_in = ev[f"{pre}{i-1}"] if i else 0
                    terms.append(_mul_m(
                        sg,
                        _sub_m((ev[f"{orig}{i}"] + ev[f"{neg}{i}"] + cc_in) % p,
                               256 * ev[f"{pre}{i}"] % p, p), p))
                    terms.append(_mul_m(ev[f"{pre}{i}"],
                                        _sub_m(one, ev[f"{pre}{i}"], p), p))
        # Core product-accumulate chain.
        for k in range(2 * W - 1):
            s = ev[f"c{k-1}"] if k else 0
            for i in range(max(0, k - W + 1), min(W, k + 1)):
                s = (s + _mul_m(ev[f"{qn}{i}"], ev[f"{yn}{k - i}"], p)) % p
            if k < W:
                s = (s + ev[f"{rn}{k}"]) % p
            tgt = ev[f"{xn}{k}"] if k < W else 0
            terms.append(_sub_m(s, (tgt + 256 * ev[f"c{k}"]) % p, p))
        terms.append(ev[f"c{2 * W - 2}"] % p)
        # Remainder comparison ar < ay: borrow chain + final borrow 1.
        for k in range(W):
            b_in = ev[f"bb{k-1}"] if k else 0
            terms.append(_sub_m(
                (ev[f"{rn}{k}"] + 256 * ev[f"bb{k}"]) % p,
                (ev[f"db{k}"] + ev[f"{yn}{k}"] + b_in) % p, p))
            terms.append(_mul_m(ev[f"bb{k}"],
                                _sub_m(one, ev[f"bb{k}"], p), p))
        ysum = 0
        for i in range(W):
            ysum = (ysum + ev[f"{yn}{i}"]) % p
        terms.append(_mul_m(ev["zy"], ysum, p))
        terms.append(_sub_m((_mul_m(ysum, ev["iy"], p) + ev["zy"]) % p, one, p))
        terms.append(_mul_m(ev["zy"], _sub_m(one, ev["zy"], p), p))
        # y != 0 -> ar < y; y == 0 -> quotient all-ones.
        terms.append(_mul_m(_sub_m(one, ev["zy"], p),
                            _sub_m(ev[f"bb{W-1}"], one, p), p))
        for i in range(W):
            terms.append(_mul_m(ev["zy"], _sub_m(ev[f"qb{i}"], 255 % p, p), p))
        if W == 4:
            for s, rr, bn in (("swq", "rwq", "qb3"), ("swr", "rwr", "rb3")):
                terms.append(_mul_m(ev[s], _sub_m(one, ev[s], p), p))
                terms.append(_sub_m(2 * ev[bn] % p,
                                    (256 * ev[s] + ev[rr]) % p, p))
        return terms

    def constraint_arrays(self, cols, p: int) -> List[np.ndarray]:
        return self._terms(cols, p)

    def constraint_scalars(self, ev, p: int) -> List[int]:
        return self._terms(ev, p)


# funct3 encodings of the six RV64 branch comparisons (rv64i BRANCH).
_BRANCH_F3 = {"t_eq": 0, "t_ne": 1, "t_lt": 4, "t_ge": 5, "t_ltu": 6, "t_geu": 7}


class _BranchGadget:
    """All branch variants share one catalog table (instruction_table
    :267-271); queries carry (rs1_val, rs2_val, funct3) -> taken.  The
    gadget one-hot-decodes funct3 into the six comparisons and proves
    ``taken`` against equality + signed/unsigned 64-bit borrow
    sub-gadgets.  The signed chain shares the unsigned chain's limbs
    0..2 borrows (the +2^63 bias only changes the top limb), adding just
    sd3/sb3."""

    columns = (
        tuple(f"b{j}" for j in _LIMB)
        + tuple(f"{pre}{j}" for pre in ("d", "x", "y") for j in _LIMB)
        + tuple(f"e{j}" for j in _LIMB)
        + tuple(f"i{j}" for j in _LIMB)
        + ("e", "e01", "e23", "f3", "o", "rx2", "ry2", "s_x", "s_y",
           "sb3", "sd3", "t_eq", "t_ge", "t_geu", "t_lt", "t_ltu", "t_ne")
    )
    inclusions: Tuple[Inclusion, ...] = tuple(
        (f"g_{pre}{j}", "RANGE16", {f"{pre}{j}": 1})
        for pre in ("x", "y", "d") for j in _LIMB
    ) + tuple(
        (f"g_{c}", "RANGE16", {c: 1}) for c in ("rx2", "ry2", "sd3")
    )

    _BOOLS = ("t_eq", "t_ne", "t_lt", "t_ge", "t_ltu", "t_geu",
              "b0", "b1", "b2", "b3", "s_x", "s_y", "sb3")

    def build(self, inputs: np.ndarray, outputs: np.ndarray, n_pad: int, p: int):
        n = inputs.shape[0]
        x, y, f3 = _pad_cols([inputs[:, 0], inputs[:, 1], inputs[:, 2]], n_pad)
        o = np.ones(n_pad, dtype=np.uint64)  # padding: BEQ(0,0) is taken
        o[:n] = outputs[:, 0]
        cols = {**_limbs("x", x), **_limbs("y", y), "f3": f3, "o": o}
        for name, enc in _BRANCH_F3.items():
            cols[name] = (f3 == enc).astype(np.uint64)
        # Equality sub-gadget per limb: e_j = 1[diff == 0], i_j = inverse
        # of the diff (0 when equal); product tree keeps degree <= 2.
        for j in _LIMB:
            diff = (cols[f"x{j}"] + np.uint64(p) - cols[f"y{j}"]) % np.uint64(p)
            cols[f"e{j}"] = (diff == 0).astype(np.uint64)
            cols[f"i{j}"] = np_inv(diff, p)
        cols["e01"] = cols["e0"] * cols["e1"]
        cols["e23"] = cols["e2"] * cols["e3"]
        cols["e"] = cols["e01"] * cols["e23"]
        # Unsigned borrow chain.
        d_cols, b_cols = _compare_build(x, y, False, p)
        cols.update(d_cols)
        cols.update(b_cols)
        # Signed: bias both; limbs 0..2 are unchanged so only the top limb
        # of the difference and the final borrow differ.
        bias = np.uint64(1 << 63)
        sd = (x ^ bias) - (y ^ bias)
        cols["sd3"] = (sd >> np.uint64(48)) & _M16
        cols["sb3"] = ((x ^ bias) < (y ^ bias)).astype(np.uint64)
        cols["s_x"] = cols["x3"] >> np.uint64(15)
        cols["s_y"] = cols["y3"] >> np.uint64(15)
        cols["rx2"] = (cols["x3"] & np.uint64(0x7FFF)) * np.uint64(2)
        cols["ry2"] = (cols["y3"] & np.uint64(0x7FFF)) * np.uint64(2)
        return cols

    @staticmethod
    def constraint_arrays(cols, p: int) -> List[np.ndarray]:
        P = np.uint64(p)
        sixt = np.uint64(1 << 16)
        one = np.uint64(1)
        two = np.uint64(2)
        terms = [
            cols[b] * ((one + P - cols[b]) % P) % P for b in _BranchGadget._BOOLS
        ]
        onehot = (sum(cols[t] for t in _BRANCH_F3) + P - one) % P
        f3bind = (cols["f3"] + sum(
            (P - np.uint64(enc) * cols[name] % P) for name, enc in _BRANCH_F3.items()
        )) % P
        terms += [onehot, f3bind]
        for j in _LIMB:
            diff = (cols[f"x{j}"] + P - cols[f"y{j}"]) % P
            terms.append((diff * cols[f"i{j}"] % P + cols[f"e{j}"] + P - one) % P)
            terms.append(cols[f"e{j}"] * diff % P)
        terms.append((cols["e01"] + P - cols["e0"] * cols["e1"] % P) % P)
        terms.append((cols["e23"] + P - cols["e2"] * cols["e3"] % P) % P)
        terms.append((cols["e"] + P - cols["e01"] * cols["e23"] % P) % P)
        terms += _borrow_chain_arrays(cols, p, "x", "y", "d", "b", False)
        terms.append((two * cols["x3"] + (P - sixt * cols["s_x"] % P)
                      + (P - cols["rx2"])) % P)
        terms.append((two * cols["y3"] + (P - sixt * cols["s_y"] % P)
                      + (P - cols["ry2"])) % P)
        # Signed top limb: x3 - 2^16 s_x - y3 + 2^16 s_y - b2 - sd3 + 2^16 sb3.
        terms.append((cols["x3"] + (P - sixt * cols["s_x"] % P)
                      + (P - cols["y3"]) + sixt * cols["s_y"] % P
                      + (P - cols["b2"]) + (P - cols["sd3"])
                      + sixt * cols["sb3"] % P) % P)
        taken = (cols["t_eq"] * cols["e"]
                 + cols["t_ne"] * ((one + P - cols["e"]) % P)
                 + cols["t_lt"] * cols["sb3"]
                 + cols["t_ge"] * ((one + P - cols["sb3"]) % P)
                 + cols["t_ltu"] * cols["b3"]
                 + cols["t_geu"] * ((one + P - cols["b3"]) % P)) % P
        terms.append((cols["o"] + P - taken) % P)
        return terms

    @staticmethod
    def constraint_scalars(ev, p: int) -> List[int]:
        terms = [ev[b] * (1 - ev[b]) % p for b in _BranchGadget._BOOLS]
        terms.append((sum(ev[t] for t in _BRANCH_F3) - 1) % p)
        terms.append((ev["f3"] - sum(enc * ev[name] for name, enc in _BRANCH_F3.items())) % p)
        for j in _LIMB:
            diff = (ev[f"x{j}"] - ev[f"y{j}"]) % p
            terms.append((diff * ev[f"i{j}"] + ev[f"e{j}"] - 1) % p)
            terms.append(ev[f"e{j}"] * diff % p)
        terms.append((ev["e01"] - ev["e0"] * ev["e1"]) % p)
        terms.append((ev["e23"] - ev["e2"] * ev["e3"]) % p)
        terms.append((ev["e"] - ev["e01"] * ev["e23"]) % p)
        terms += _borrow_chain_scalars(ev, p, "x", "y", "d", "b", False)
        terms.append((2 * ev["x3"] - (1 << 16) * ev["s_x"] - ev["rx2"]) % p)
        terms.append((2 * ev["y3"] - (1 << 16) * ev["s_y"] - ev["ry2"]) % p)
        terms.append((ev["x3"] - (1 << 16) * ev["s_x"] - ev["y3"]
                      + (1 << 16) * ev["s_y"] - ev["b2"] - ev["sd3"]
                      + (1 << 16) * ev["sb3"]) % p)
        taken = (ev["t_eq"] * ev["e"] + ev["t_ne"] * (1 - ev["e"])
                 + ev["t_lt"] * ev["sb3"] + ev["t_ge"] * (1 - ev["sb3"])
                 + ev["t_ltu"] * ev["b3"] + ev["t_geu"] * (1 - ev["b3"])) % p
        terms.append((ev["o"] - taken) % p)
        return terms


# table_id -> gadget (ids per lookups/pipeline_lasso.TABLE_IDS catalog
# order ADD..STORE).  LOAD/STORE have no static semantics (memory
# consistency is a separate argument).
GADGETS = {
    0: _AddSubGadget(is_sub=False),  # ADD
    1: _AddSubGadget(is_sub=True),   # SUB
    2: _BitwiseGadget("AND"),
    3: _BitwiseGadget("OR"),
    4: _BitwiseGadget("XOR"),
    5: _ShiftGadget("SLL"),
    6: _ShiftGadget("SRL"),
    7: _ShiftGadget("SRA"),
    8: _SltGadget(),
    9: _SltuGadget(),
    10: _BranchGadget(),
    # RV64 word ops (OP_32 / OP_IMM_32): 32-bit semantics, sign-extended.
    13: _AddSubWGadget(is_sub=False),  # ADDW
    14: _AddSubWGadget(is_sub=True),   # SUBW
    15: _ShiftWGadget("SLLW"),
    16: _ShiftWGadget("SRLW"),
    17: _ShiftWGadget("SRAW"),
    # M extension (multiplies; divisions are 23-26/27-30).
    18: _MulGadget("MUL"),
    19: _MulGadget("MULH"),
    20: _MulGadget("MULHSU"),
    21: _MulGadget("MULHU"),
    22: _MulGadget("MULW"),
    23: _DivGadget("DIV"),
    24: _DivGadget("DIVU"),
    25: _DivGadget("REM"),
    26: _DivGadget("REMU"),
    27: _DivGadget("DIVW"),
    28: _DivGadget("DIVUW"),
    29: _DivGadget("REMW"),
    30: _DivGadget("REMUW"),
}
GADGET_TABLE_IDS = frozenset(GADGETS)


# ---------------------------------------------------------------------------
# Proof structures


@dataclass
class TableValidityRecord:
    """Round-3 slim form: the Ligero roots/openings moved to the shared
    unified commitment (prover/unified.py)."""

    table_id: int
    num_queries: int
    num_vars: int
    zc: ZerocheckProof
    g_sums: Dict[str, Ext4]


@dataclass
class SubtableSideRecord:
    names: List[str]  # used subtables, sorted
    zc: ZerocheckProof
    h_sums: Dict[str, Ext4]


@dataclass
class LookupValidityProof:
    nonce: int
    tables: List[TableValidityRecord]
    table_side: Optional[SubtableSideRecord]


# ---------------------------------------------------------------------------
# Combiners


def _key_array(cols, spec: Dict[str, int], p: int):
    """key = sum coef * col, generic over base arrays / Ext4 values."""
    acc = None
    for name, coef in sorted(spec.items()):
        term = np.uint64(coef % p) * cols[name] % np.uint64(p)
        acc = term if acc is None else (acc + term) % p
    return acc


def _make_query_combiner(gadget, tau: Ext4):
    """One generic combiner (prover arrays / verifier Ext4 evals): the
    gadget constraint terms route through the generic mod-p idioms, the
    logUp inclusion terms recombine the extension g coordinate columns."""

    def combiner(cols, alphas: List, p: int):
        from ..constraints.regcheck import _fraction_sum_parts

        terms = list(gadget.constraint_arrays(cols, p))
        for g_name, _sub, specs in merged_inclusions(gadget):
            ds = [tau - _key_array(cols, spec, p) for spec in specs]
            prod_all, num = _fraction_sum_parts(ds)
            g = g_eval_from_coords(cols, g_name)
            terms.append(g * prod_all - num)
        acc = alphas[0] * terms[0]
        for alpha, term in zip(alphas[1:], terms[1:]):
            acc = acc + alpha * term
        return acc

    return combiner


def _make_table_combiner(names: List[str], tau: Ext4):
    def combiner(cols, alphas: List, p: int):
        acc = None
        for j, name in enumerate(names):
            h = g_eval_from_coords(cols, f"h_{name}")
            term = h * (tau - cols[f"__key_{name}__"]) - cols[f"m_{name}"]
            term = alphas[j] * term
            acc = term if acc is None else acc + term
        return acc

    return combiner


def _table_public_evals(names: List[str], p: int):
    def fn(rs):
        return {f"__key_{name}__": SUBTABLES[name].key_eval(rs, p)
                for name in names}

    return fn


def _num_constraints(gadget) -> int:
    return len(gadget.constraint_scalars(
        {c: 0 for c in gadget.columns}, 2013265921
    )) + len(merged_inclusions(gadget))


def _qvars(n: int) -> int:
    """Query-domain variables: >= 1 so every instance has rounds."""
    return max(1, (max(n, 1) - 1).bit_length())


# ---------------------------------------------------------------------------
# Prover


class ValidityArgument:
    """Prover-side phased argument (prover/unified.py harness).  Local
    column names are prefixed ``t{tid}:`` per table; the table side keeps
    its ``m_{sub}`` / ``h_{sub}#{e}`` names."""

    ns = "lv"

    def __init__(self, F, queries_by_table, forge_hook=None,
                 unsafe_skip_self_checks=False):
        self.F = F
        self.queries_by_table = queries_by_table
        self._forge_hook = forge_hook
        self._unsafe = unsafe_skip_self_checks
        self.locmap = {}
        self.proof: Optional[LookupValidityProof] = None
        self.per_table: Dict[int, dict] = {}

    def data_phase(self, transcript) -> Dict[str, np.ndarray]:
        F = self.F
        p = F.MODULUS
        if p >= (1 << 31):
            raise ValueError("lookup validity requires a field modulus < 2^31")
        table_ids = sorted(t for t in self.queries_by_table if t in GADGET_TABLE_IDS)
        self.table_ids = table_ids

        transcript.append_bytes(b"LV_BEGIN")
        transcript.append_u64(len(table_ids))
        if not table_ids:
            self.sub_names = []
            return {}

        out: Dict[str, np.ndarray] = {}
        used_subs = set()
        for tid in table_ids:
            gadget = GADGETS[tid]
            inputs, outputs = self.queries_by_table[tid]
            nq = inputs.shape[0]
            v = _qvars(nq)
            cols = gadget.build(inputs, outputs, 1 << v, p)
            if self._forge_hook is not None:
                self._forge_hook(tid, cols)
            if not self._unsafe:
                for j, arr in enumerate(gadget.constraint_arrays(cols, p)):
                    if np.any(arr != 0):
                        bad = int(np.nonzero(arr)[0][0])
                        raise AssertionError(
                            f"lookup validity violated: table {tid} row {bad} breaks "
                            f"constraint {j} (forged lookup output?)"
                        )
            transcript.append_bytes(b"LV_TABLE")
            transcript.append_u64(tid)
            transcript.append_u64(nq)
            transcript.append_u64(v)
            self.per_table[tid] = dict(gadget=gadget, cols=cols, nq=nq, v=v)
            used_subs.update(sub for _, sub, _ in gadget.inclusions)
            for c, arr in cols.items():
                out[f"t{tid}:{c}"] = arr

        # Multiplicities over each used subtable domain (tau-independent;
        # counting validates every query key is in-table).
        sub_names = sorted(used_subs)
        dense_keys = {name: SUBTABLES[name].dense_key(p) for name in sub_names}
        m_cols = {f"m_{name}": np.zeros(1 << SUBTABLES[name].num_vars, dtype=np.uint64)
                  for name in sub_names}
        for tid in table_ids:
            info = self.per_table[tid]
            for _g_name, sub, spec in info["gadget"].inclusions:
                keys = _key_array(info["cols"], spec, p)
                size = 1 << SUBTABLES[sub].num_vars
                x = (keys & np.uint64(size - 1)).astype(np.int64)
                if not np.array_equal(dense_keys[sub][x], keys) and not self._unsafe:
                    bad = int(np.nonzero(dense_keys[sub][x] != keys)[0][0])
                    raise AssertionError(
                        f"lookup validity violated: table {tid} row {bad} is not a "
                        f"{sub} entry (forged lookup output?)"
                    )
                m_cols[f"m_{sub}"] += np.bincount(x, minlength=size).astype(np.uint64)
        transcript.append_bytes(b"LV_MULT")
        transcript.append_u64(len(sub_names))
        for name in sub_names:
            transcript.append_bytes(name.encode())

        self.sub_names = sub_names
        self.dense_keys = dense_keys
        self.m_cols = m_cols
        out.update(m_cols)
        return out

    def advice_phase(self, transcript) -> Dict[str, np.ndarray]:
        if not self.table_ids:
            self.proof = LookupValidityProof(nonce=0, tables=[], table_side=None)
            return {}
        F = self.F
        p = F.MODULUS
        # Extension fingerprint challenges.  A tau with a nonzero high
        # coordinate can never equal a (lifted) base-field key, so every
        # query- and table-side denominator is nonzero by construction;
        # the nonce loop only retries the ~2^-93 all-high-zero draw.
        nonce = 0
        while True:
            trial = transcript.fork()
            trial.append_bytes(b"LV_CHAL")
            trial.append_u64(nonce)
            tau = challenge_ext(trial)
            gamma = challenge_ext(trial)  # reserved for multi-word keys (shifts)
            if high_coords_nonzero(tau):
                break
            nonce += 1
            assert nonce <= MAX_NONCE, "validity nonce overflow"
        transcript.append_bytes(b"LV_CHAL")
        transcript.append_u64(nonce)
        assert challenge_ext(transcript) == tau
        assert challenge_ext(transcript) == gamma
        self.tau = tau
        self.nonce = nonce

        out: Dict[str, np.ndarray] = {}
        for tid in self.table_ids:
            info = self.per_table[tid]
            from ..constraints.regcheck import _fraction_sum_parts

            g_cols: Dict[str, Ext4] = {}
            for g_name, _sub, specs in merged_inclusions(info["gadget"]):
                ds = [tau - _key_array(info["cols"], spec, p)
                      for spec in specs]
                prod_all, num = _fraction_sum_parts(ds)
                g_cols[g_name] = num * prod_all.inv()
            info["g_cols"] = g_cols
            info["g_coords"] = pack_g_coords(g_cols)
            info["g_sums"] = {name: col.sum() for name, col in g_cols.items()}
            transcript.append_bytes(b"LV_G")
            for name in sorted(info["g_sums"]):
                absorb_ext(transcript, info["g_sums"][name])
            for c, arr in info["g_coords"].items():
                out[f"t{tid}:{c}"] = arr

        h_cols: Dict[str, Ext4] = {}
        h_sums: Dict[str, Ext4] = {}
        for name in self.sub_names:
            h = (tau - self.dense_keys[name]).inv() * self.m_cols[f"m_{name}"]
            h_cols[f"h_{name}"] = h
            h_sums[name] = h.sum()
        self.h_coords = pack_g_coords(h_cols)
        self.h_sums = h_sums
        transcript.append_bytes(b"LV_H")
        for name in self.sub_names:
            absorb_ext(transcript, h_sums[name])
        out.update(self.h_coords)

        # Honest-prover grand-sum self-check (the logUp identity).
        from ..core.ext4 import ext_lift

        use_sums = {name: ext_lift(0) for name in self.sub_names}
        for tid in self.table_ids:
            info = self.per_table[tid]
            for g_name, sub, _specs in merged_inclusions(info["gadget"]):
                use_sums[sub] = use_sums[sub] + info["g_sums"][g_name]
        for name in self.sub_names:
            if use_sums[name] != h_sums[name] and not self._unsafe:
                raise AssertionError(f"lookup validity violated: {name} multiset mismatch")
        return out

    def zerocheck_phase(self, transcript, sink) -> None:
        if not self.table_ids:
            return
        F = self.F
        p = F.MODULUS
        from ..core.ext4 import ext_lift

        records = []
        for tid in self.table_ids:
            info = self.per_table[tid]
            gadget = info["gadget"]
            all_cols = dict(info["cols"])
            all_cols.update(info["g_coords"])
            zc = ZerocheckExtProver(
                F, all_cols, _make_query_combiner(gadget, self.tau),
                VALIDITY_DEGREE, num_alphas=_num_constraints(gadget),
                device=unified_device(self),
                dev_columns=unified_dev_columns(
                    self, all_cols, rename=lambda n, t=tid: f"t{t}:{n}"
                ),
            ).prove(transcript)
            records.append(TableValidityRecord(
                table_id=tid, num_queries=info["nq"], num_vars=info["v"],
                zc=zc, g_sums=info["g_sums"],
            ))
            for name in sorted(zc.column_evals):
                ck, fn, v = self.locmap[f"t{tid}:{name}"]
                sink.eval_claim(ck, fn, v, zc.final_point, zc.column_evals[name])
            for g in sorted(info["g_sums"]):
                for e in range(4):
                    ck, fn, v = self.locmap[f"t{tid}:{g}#{e}"]
                    sink.sum_claim(ck, fn, v,
                                   ext_lift(int(info["g_sums"][g].c[e])))
            info["zc"] = zc

        table_cols = dict(self.m_cols)
        table_cols.update(self.h_coords)
        for name in self.sub_names:
            table_cols[f"__key_{name}__"] = self.dense_keys[name]
        zc_t = ZerocheckExtProver(
            F, table_cols, _make_table_combiner(self.sub_names, self.tau),
            VALIDITY_DEGREE, num_alphas=len(self.sub_names),
            device=unified_device(self),
            dev_columns=unified_dev_columns(self, table_cols),
        ).prove(transcript)
        for name in sorted(zc_t.column_evals):
            ck, fn, v = self.locmap[name]
            sink.eval_claim(ck, fn, v, zc_t.final_point, zc_t.column_evals[name])
        for name in self.sub_names:
            for e in range(4):
                ck, fn, v = self.locmap[f"h_{name}#{e}"]
                sink.sum_claim(ck, fn, v, ext_lift(int(self.h_sums[name].c[e])))

        self.proof = LookupValidityProof(
            nonce=self.nonce, tables=records,
            table_side=SubtableSideRecord(names=self.sub_names, zc=zc_t,
                                          h_sums=self.h_sums),
        )

    def linkage_info(self) -> List[dict]:
        """Per-table state the witness-linkage argument consumes: the
        committed query columns plus this argument's locmap handle (for
        issuing claims on the shared data commitment)."""
        return [
            dict(tid=tid, gadget=self.per_table[tid]["gadget"],
                 cols=self.per_table[tid]["cols"],
                 nq=self.per_table[tid]["nq"], v=self.per_table[tid]["v"],
                 arg=self)
            for tid in self.table_ids
        ]


class LookupValidityStandalone:
    def __init__(self, lv: LookupValidityProof, unified):
        self.lv = lv
        self.unified = unified

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "lv"), name)


def prove_lookup_validity(F, transcript, queries_by_table, hash_mode: str = "sha3",
                          _forge_hook=None, _unsafe_skip_self_checks=False,
                          _return_state: bool = False, *, device):
    """Standalone entry point: prove every gadget-covered query is a
    genuine table entry, under a private unified harness.

    ``queries_by_table``: table_id -> (inputs (n,2), outputs (n,1)).
    ``_forge_hook`` / ``_unsafe_skip_self_checks`` are test seams: the
    hook mutates a table's column dict before commitment and the flag
    suppresses the honest-prover assertions — together they model a
    malicious prover (tests/test_lookup_validity.py)."""
    from ..prover.unified import prove_unified

    arg = ValidityArgument(F, queries_by_table, forge_hook=_forge_hook,
                           unsafe_skip_self_checks=_unsafe_skip_self_checks)
    unified = prove_unified(F, transcript, [arg], hash_mode, device=device)
    lv = LookupValidityStandalone(lv=arg.proof, unified=unified)
    if _return_state:
        return lv, arg.linkage_info()
    return lv


# ---------------------------------------------------------------------------
# Verifier


class ValidityVerify:
    """Verifier-side phased argument (prover/unified.py harness).

    ``lasso_counts``: table_id -> num_lookups from the (already verified)
    pipeline Lasso records; every gadget-covered table there MUST carry a
    validity record with the same query count — a prover cannot silently
    omit the argument."""

    ns = "lv"

    def __init__(self, F, lv: LookupValidityProof, lasso_counts: Dict[int, int]):
        self.F = F
        self.lv = lv
        self.lasso_counts = lasso_counts
        self.locmap = {}

    def data_phase(self, transcript) -> Optional[Dict[str, int]]:
        lv = self.lv
        if not isinstance(lv, LookupValidityProof):
            return None
        expected_ids = sorted(t for t in self.lasso_counts if t in GADGET_TABLE_IDS)
        if [r.table_id for r in lv.tables] != expected_ids:
            return None
        if not (0 <= lv.nonce <= MAX_NONCE):
            return None

        transcript.append_bytes(b"LV_BEGIN")
        transcript.append_u64(len(lv.tables))
        if not lv.tables:
            self.sub_names = []
            return {} if lv.table_side is None else None

        shape: Dict[str, int] = {}
        used_subs = set()
        for rec in lv.tables:
            gadget = GADGETS[rec.table_id]
            if rec.num_queries != self.lasso_counts[rec.table_id]:
                return None
            if rec.num_vars != _qvars(rec.num_queries):
                return None
            transcript.append_bytes(b"LV_TABLE")
            transcript.append_u64(rec.table_id)
            transcript.append_u64(rec.num_queries)
            transcript.append_u64(rec.num_vars)
            used_subs.update(sub for _, sub, _ in gadget.inclusions)
            for c in gadget.columns:
                shape[f"t{rec.table_id}:{c}"] = rec.num_vars

        sub_names = sorted(used_subs)
        ts = lv.table_side
        if ts is None or ts.names != sub_names:
            return None
        transcript.append_bytes(b"LV_MULT")
        transcript.append_u64(len(sub_names))
        for name in sub_names:
            transcript.append_bytes(name.encode())
            shape[f"m_{name}"] = SUBTABLES[name].num_vars
        self.sub_names = sub_names
        return shape

    def advice_phase(self, transcript) -> Optional[Dict[str, int]]:
        lv = self.lv
        if not lv.tables:
            return {}
        transcript.append_bytes(b"LV_CHAL")
        transcript.append_u64(lv.nonce)
        tau = challenge_ext(transcript)
        challenge_ext(transcript)  # gamma (reserved)
        if not high_coords_nonzero(tau):
            return None
        self.tau = tau

        shape: Dict[str, int] = {}
        for rec in lv.tables:
            gadget = GADGETS[rec.table_id]
            g_names = sorted(g for g, _s, _k in merged_inclusions(gadget))
            if set(rec.g_sums) != set(g_names):
                return None
            if not all(isinstance(v, Ext4) and v.is_scalar
                       for v in rec.g_sums.values()):
                return None
            transcript.append_bytes(b"LV_G")
            for name in g_names:
                absorb_ext(transcript, rec.g_sums[name])
            for gc in g_coord_names(g_names):
                shape[f"t{rec.table_id}:{gc}"] = rec.num_vars
        ts = lv.table_side
        if set(ts.h_sums) != set(self.sub_names):
            return None
        if not all(isinstance(v, Ext4) and v.is_scalar for v in ts.h_sums.values()):
            return None
        transcript.append_bytes(b"LV_H")
        for name in self.sub_names:
            absorb_ext(transcript, ts.h_sums[name])
            for e in range(4):
                shape[f"h_{name}#{e}"] = SUBTABLES[name].num_vars

        # The logUp grand-sum equation: per subtable, the query-side
        # inverse sums across every use must equal the table-side sum.
        from ..core.ext4 import ext_lift

        use_sums = {name: ext_lift(0) for name in self.sub_names}
        for rec in lv.tables:
            for g_name, sub, _specs in merged_inclusions(GADGETS[rec.table_id]):
                use_sums[sub] = use_sums[sub] + rec.g_sums[g_name]
        if not all(use_sums[n] == ts.h_sums[n] for n in self.sub_names):
            return None
        return shape

    def zerocheck_phase(self, transcript, sink) -> bool:
        lv, F = self.lv, self.F
        if not lv.tables:
            return True
        p = F.MODULUS
        from ..core.ext4 import ext_lift

        for rec in lv.tables:
            gadget = GADGETS[rec.table_id]
            g_names = sorted(g for g, _s, _k in merged_inclusions(gadget))
            gc_names = sorted(g_coord_names(g_names))
            col_names = sorted(gadget.columns)
            if set(rec.zc.column_evals) != set(col_names) | set(gc_names):
                return False
            if rec.zc.num_vars != rec.num_vars or rec.zc.degree != VALIDITY_DEGREE:
                return False
            if not ZerocheckExtVerifier(
                F, _make_query_combiner(gadget, self.tau),
                _num_constraints(gadget), VALIDITY_DEGREE,
            ).verify(rec.zc, transcript):
                return False
            for name in sorted(rec.zc.column_evals):
                ck, fn, v = self.locmap[f"t{rec.table_id}:{name}"]
                sink.eval_claim(ck, fn, v, rec.zc.final_point,
                                rec.zc.column_evals[name])
            for g in g_names:
                for e in range(4):
                    ck, fn, v = self.locmap[f"t{rec.table_id}:{g}#{e}"]
                    sink.sum_claim(ck, fn, v, ext_lift(int(rec.g_sums[g].c[e])))

        # Table side.
        ts = lv.table_side
        m_names = [f"m_{n}" for n in self.sub_names]
        hc_names = sorted(g_coord_names([f"h_{n}" for n in self.sub_names]))
        if set(ts.zc.column_evals) != set(m_names) | set(hc_names):
            return False
        if ts.zc.num_vars != 16 or ts.zc.degree != VALIDITY_DEGREE:
            return False
        if not ZerocheckExtVerifier(
            F, _make_table_combiner(self.sub_names, self.tau),
            len(self.sub_names), VALIDITY_DEGREE,
            public_evals=_table_public_evals(self.sub_names, p),
        ).verify(ts.zc, transcript):
            return False
        for name in sorted(ts.zc.column_evals):
            ck, fn, v = self.locmap[name]
            sink.eval_claim(ck, fn, v, ts.zc.final_point, ts.zc.column_evals[name])
        for name in self.sub_names:
            for e in range(4):
                ck, fn, v = self.locmap[f"h_{name}#{e}"]
                sink.sum_claim(ck, fn, v, ext_lift(int(ts.h_sums[name].c[e])))
        return True


def verify_lookup_validity(F, transcript, lv, lasso_counts: Dict[int, int],
                           hash_mode: str = "sha3") -> bool:
    """Standalone verifier (see ValidityVerify for the phase logic)."""
    from ..prover.unified import verify_unified

    arg = ValidityVerify(F, lv.lv if isinstance(lv, LookupValidityStandalone) else lv,
                         lasso_counts)
    return verify_unified(F, transcript, [arg], lv.unified, hash_mode) is None
