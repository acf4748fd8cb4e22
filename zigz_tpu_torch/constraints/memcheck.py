"""RAM consistency: byte-level offline memory checking over the trace.

The reference treats data memory as an execution-only structure
(memory.zig sparse byte map; nothing in builder.zig constrains loads
against stores) — so a dishonest trace could return ANY value from a
LOAD.  Protocol v2 closes this with the same Spice-style offline
memory check as the register file ([[constraints/regcheck.py]]), over
byte cells instead of 32 registers:

* Every LOAD/STORE of size s touches nbytes = 1 << s consecutive byte
  cells; each touched byte is ONE access row, modeled read-then-write:
    LOAD  byte k: read cell addr+k -> vr, write vr back   (st = 0)
    STORE byte k: read cell addr+k -> vr, write the new
                  byte vw = (value >> 8k) & 0xFF          (st = 1)
  Rows are laid out in execution order; the write timestamp of row j is
  the PUBLIC j + 1 (idx MLE), read timestamps are committed advice with
  range-decomposed lag (idx - rt = dl0 + 2^16 dl1), exactly regcheck's
  ordering argument.
* Committed advice per row: 4 x 16-bit address limbs, the read/written
  byte values vr/vw (range-checked < 256 via coefficient 256), the
  store flag st (boolean; (1-st)*(vw-vr)=0 keeps LOAD rows from
  mutating memory), and the rt/lag limb decompositions.
* logUp multiset equation over tuples (addr, byte, ts), fingerprinted
  kappa = a0 + g*a1 + g^2*a2 + g^3*a3 + g^4*v + g^5*ts:

      RS + FINAL == WS + INIT

  INIT tuples are (a, initial_byte(a), 0) over the touched-address set;
  the VERIFIER computes initial_byte itself from the public program
  (ELF segments, or the raw image at initial_pc — the same data the VM
  loaded, memory.zig:35-37 unmapped-reads-0).  FINAL tuples
  (a, final_val, final_ts) travel explicitly in the proof (sorted,
  deduplicated), so the verifier computes both boundary sums itself.

An extra address may appear in the touched list only as a fixed point
(final == init, ts 0), which cancels; omitting or mis-reporting a
genuinely touched byte breaks the multiset balance.

Range checks reuse the RANGE16 logUp pattern (multiplicity column over
the 2^16 domain, closed-form key MLE), as in regcheck.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.ext4 import (
    MAX_NONCE,
    Ext4,
    challenge_ext,
    ext_lift,
    ext_stack,
    high_coords_nonzero,
)
from ..poly.public_mles import idx_eval, idx_table, le_indicator_eval, le_table
from ..proofs.zerocheck import (
    ZerocheckExtProver,
    ZerocheckExtVerifier,
    ZerocheckProof,
    absorb_ext,
    prove_unified_zerocheck,
    unified_device,
)
from .regcheck import g_coord_names, g_eval_from_coords, pack_g_coords, sum_claim_values

__all__ = [
    "MemCheckProof",
    "MemCheckStandalone",
    "MemcheckArgument",
    "MemcheckVerify",
    "ByteAccessColumns",
    "initial_memory_map",
    "extract_byte_accesses",
    "prove_memcheck",
    "verify_memcheck",
    "MEMCHECK_DEGREE",
]

_M16 = np.uint64(0xFFFF)
_M64 = (1 << 64) - 1
# deg(eq * C): base constraints are degree <= 2; the merged RANGE16
# constraints (below) are degree 1 + _RANGE_MERGE.
_RANGE_MERGE = 4
MEMCHECK_DEGREE = _RANGE_MERGE + 2

# (column, coefficient) pairs whose scaled values are RANGE16-checked.
# vr/vw carry coefficient 256 (256*x < 2^16 bounds the byte), tl1/dl1
# coefficient 16 (bounds ts and lag < 2^28; see regcheck.py on why the
# tight bound makes the decomposition hold over the integers).
_RANGED = (
    ("a0", 1), ("a1", 1), ("a2", 1), ("a3", 1),
    ("vr", 256), ("vw", 256),
    ("tl0", 1), ("tl1", 16), ("dl0", 1), ("dl1", 16),
    # Base-address limbs and byte offset (8192*bk < 2^16 bounds bk < 8)
    # for the step<->byte-row linkage (constraints/bytecode.py): each
    # byte row proves a = base + bk mod 2^64 via a carry chain, so the
    # linkage can fingerprint (base limbs, bk) against the step's
    # committed address-adder output.
    ("ba0", 1), ("ba1", 1), ("ba2", 1), ("ba3", 1), ("bk", 8192),
)

COLUMNS = ("a0", "a1", "a2", "a3", "vr", "vw", "st", "rt",
           "tl0", "tl1", "dl0", "dl1",
           "ba0", "ba1", "ba2", "ba3", "bk", "cb0", "cb1", "cb2", "cb3")
G_MEM = ("g_r", "g_w")
# RANGE16 fractions committed MERGED (see regcheck.py _RANGE_GROUPS):
# gq_i = sum over its group of 1/(tau_r - coef*c), pinned per row by the
# degree-(k+1) product constraint; grand range equation unchanged.
_RANGE_GROUPS = tuple(
    tuple(_RANGED[i : i + _RANGE_MERGE])
    for i in range(0, len(_RANGED), _RANGE_MERGE)
)
G_RNG = tuple(f"gq{i}" for i in range(len(_RANGE_GROUPS)))
# logUp r/w, rt decomp, lag decomp, st boolean, load-preserves, base+bk
# carry chain (4) + carry booleans (4), range groups.
NUM_CONSTRAINTS = 2 + 1 + 1 + 1 + 1 + 8 + len(_RANGE_GROUPS)


@dataclass
class ByteAccessColumns:
    """Per-byte-access data (length A, unpadded, canonical uint64)."""

    addr: np.ndarray       # (A,) byte addresses
    base: np.ndarray       # (A,) access base addresses (addr = base + bk)
    bk: np.ndarray         # (A,) byte offset within the access (< 8)
    vr: np.ndarray         # (A,) byte read
    vw: np.ndarray         # (A,) byte written (== vr for loads)
    st: np.ndarray         # (A,) store flag
    read_ts: np.ndarray    # (A,)
    touched: List[Tuple[int, int, int]]  # sorted (addr, final_val, final_ts)


def initial_memory_map(program: bytes, initial_pc: int,
                       segments=None) -> Dict[int, int]:
    """addr -> byte of the pre-execution memory image.  Mirrors the
    prover's load (prover.py:_execute_*): ELF segments when given or
    sniffed (magic b"\\x7fELF"), else the raw image at initial_pc."""
    if segments is None and program[:4] == b"\x7fELF":
        from .. import elf

        segments = elf.load(program).segments
    mem: Dict[int, int] = {}
    if segments is not None:
        for seg in segments:
            base = seg.vaddr
            for i, b in enumerate(seg.data):
                mem[(base + i) & _M64] = b
    else:
        for i, b in enumerate(program):
            mem[(initial_pc + i) & _M64] = b
    return mem


def extract_byte_accesses(trace, init_mem: Dict[int, int]) -> ByteAccessColumns:
    """Replay the trace's per-step memory accesses into the byte-access
    stream (execution order, one row per touched byte)."""
    mem = dict(init_mem)
    last_ts: Dict[int, int] = {}
    addrs: List[int] = []
    bases: List[int] = []
    bks: List[int] = []
    vrs: List[int] = []
    vws: List[int] = []
    sts: List[int] = []
    rts: List[int] = []
    touched_addrs: set = set()
    pos = 0
    for acc in trace.memory_accesses:
        if acc is None:
            continue
        nbytes = 1 << acc.size
        is_store = acc.access_type == 1
        for k in range(nbytes):
            a = (acc.address + k) & _M64
            old = mem.get(a, 0)
            if is_store:
                new = (acc.value >> (8 * k)) & 0xFF
                mem[a] = new
            else:
                new = old
            bases.append(acc.address & _M64)
            bks.append(k)
            addrs.append(a)
            vrs.append(old)
            vws.append(new)
            sts.append(1 if is_store else 0)
            rts.append(last_ts.get(a, 0))
            pos += 1
            last_ts[a] = pos
            touched_addrs.add(a)
    touched = [
        (a, mem.get(a, 0), last_ts[a]) for a in sorted(touched_addrs)
    ]
    return ByteAccessColumns(
        addr=np.array(addrs, dtype=np.uint64),
        base=np.array(bases, dtype=np.uint64),
        bk=np.array(bks, dtype=np.uint64),
        vr=np.array(vrs, dtype=np.uint64),
        vw=np.array(vws, dtype=np.uint64),
        st=np.array(sts, dtype=np.uint64),
        read_ts=np.array(rts, dtype=np.uint64),
        touched=touched,
    )


# ---------------------------------------------------------------------------
# Proof structure


@dataclass
class MemCheckProof:
    """Round-3 slim form: Ligero roots/openings live in the shared
    unified commitment (prover/unified.py)."""

    nonce: int
    num_vars: int
    num_accesses: int
    touched: List[Tuple[int, int, int]]  # sorted (addr, final_val, final_ts)
    zc: ZerocheckProof           # access-domain zerocheck
    zc_table: ZerocheckProof     # RANGE16-domain zerocheck
    g_sums: Dict[str, Ext4]
    h_sum: Ext4


# ---------------------------------------------------------------------------
# Fingerprints and the shared (prover/verifier) combiner — extension
# challenges throughout (round-3 hardening; see regcheck.py's note).


def _gamma_powers(gamma: Ext4) -> List[Ext4]:
    gs = [ext_lift(1)]
    for _ in range(5):
        gs.append(gs[-1] * gamma)
    return gs


def _make_combiner(tau_m: Ext4, tau_r: Ext4, gamma: Ext4, p: int):
    gp = _gamma_powers(gamma)

    def combiner(cols, alphas: List, p_: int):
        one = 1
        sel = cols["__sel__"]
        idx = cols["__idx__"]
        addr_fp = gp[0] * cols["a0"]
        for k in (1, 2, 3):
            addr_fp = addr_fp + gp[k] * cols[f"a{k}"]
        terms = []
        for side in ("r", "w"):
            v = cols["vr"] if side == "r" else cols["vw"]
            ts = cols["rt"] if side == "r" else (idx + 1) % p
            kappa = addr_fp + gp[4] * v + gp[5] * ts
            g = g_eval_from_coords(cols, f"g_{side}")
            terms.append(g * (tau_m - kappa) - sel)
        recon = (cols["tl0"] + (1 << 16) * cols["tl1"]) % p
        terms.append((cols["rt"] + p - recon) % p)
        recon_d = (cols["dl0"] + (1 << 16) * cols["dl1"]) % p
        terms.append((idx + p + p - cols["rt"] - recon_d) % p)
        st = cols["st"]
        terms.append(st * ((one + p - st) % p) % p)
        terms.append(((one + p - st) % p)
                     * ((cols["vw"] + p - cols["vr"]) % p) % p)
        for k in range(4):
            cin = cols[f"cb{k-1}"] if k else cols["bk"]
            terms.append((cols[f"ba{k}"] + cin + p - cols[f"a{k}"]
                          + p - (1 << 16) * cols[f"cb{k}"] % p) % p)
        for k in range(4):
            terms.append(cols[f"cb{k}"] * ((one + p - cols[f"cb{k}"]) % p) % p)
        from .regcheck import _fraction_sum_parts

        for i, group in enumerate(_RANGE_GROUPS):
            ds = [tau_r - coef * cols[c] % p for c, coef in group]
            prod_all, num = _fraction_sum_parts(ds)
            gq = g_eval_from_coords(cols, f"gq{i}")
            terms.append(gq * prod_all - num)
        acc = alphas[0] * terms[0]
        for alpha, t in zip(alphas[1:], terms[1:]):
            acc = acc + alpha * t
        return acc

    return combiner


def _public_evals(num_rows: int, num_vars: int, p: int):
    def fn(rs):
        sel = le_indicator_eval(num_rows - 1, num_vars, rs, p) if num_rows \
            else ext_lift(0)
        return {"__sel__": sel, "__idx__": idx_eval(num_vars, rs, p)}

    return fn


def _make_table_combiner(tau_r: Ext4):
    def combiner(cols, alphas: List, p: int):
        h = g_eval_from_coords(cols, "h")
        return alphas[0] * (h * (tau_r - cols["__key__"]) - cols["m"])

    return combiner


def _table_public_evals(p: int):
    def fn(rs):
        return {"__key__": idx_eval(16, rs, p)}

    return fn


def _addr_limbs(a: int) -> List[int]:
    return [(a >> (16 * k)) & 0xFFFF for k in range(4)]


def _boundary_sum(tau_m: Ext4, gamma: Ext4,
                  entries: List[Tuple[int, int, int]], p: int) -> Optional[Ext4]:
    """sum 1/(tau - kappa(addr, value, ts)) over (addr, value, ts) tuples
    — computed identically by prover and verifier, in the extension."""
    if not entries:
        return ext_lift(0)
    gp = _gamma_powers(gamma)
    arr = np.array([(a, v, ts) for a, v, ts in entries], dtype=np.uint64)
    kappa = gp[0] * (arr[:, 0] & np.uint64(0xFFFF))
    for k in (1, 2, 3):
        kappa = kappa + gp[k] * ((arr[:, 0] >> np.uint64(16 * k)) & np.uint64(0xFFFF))
    kappa = kappa + gp[4] * (arr[:, 1] % np.uint64(p))
    kappa = kappa + gp[5] * (arr[:, 2] % np.uint64(p))
    d = tau_m - kappa
    if np.any(d.is_zero()):
        return None  # nonce retry
    return d.inv().sum()


# ---------------------------------------------------------------------------
# Prover


class MemcheckArgument:
    """Prover-side phased argument (prover/unified.py harness)."""

    ns = "mc"

    def __init__(self, F, access: ByteAccessColumns, init_mem: Dict[int, int],
                 forge_hook=None, unsafe_skip_self_checks=False):
        self.F = F
        self.access = access
        self.init_mem = init_mem
        self._forge_hook = forge_hook
        self._unsafe = unsafe_skip_self_checks
        self.locmap = {}
        self.proof: Optional[MemCheckProof] = None

    def data_phase(self, transcript) -> Dict[str, np.ndarray]:
        F, access = self.F, self.access
        p = F.MODULUS
        if p != 2013265921:
            raise ValueError("memcheck requires BabyBear (extension challenges)")
        A = len(access.addr)
        num_vars = max(1, (max(A, 1) - 1).bit_length() or 1)
        padded = 1 << num_vars
        assert padded < (1 << 28), "access stream too long for the ts decomposition"

        cols: Dict[str, np.ndarray] = {}

        def _pad(a):
            b = np.zeros(padded, dtype=np.uint64)
            b[:A] = a
            return b

        for k in range(4):
            cols[f"a{k}"] = _pad((access.addr >> np.uint64(16 * k)) & _M16)
        for k in range(4):
            cols[f"ba{k}"] = _pad((access.base >> np.uint64(16 * k)) & _M16)
        cols["bk"] = _pad(access.bk)
        carry = np.zeros(A, dtype=np.uint64)
        for k in range(4):
            s = ((access.base >> np.uint64(16 * k)) & _M16) + (access.bk if k == 0 else 0) + carry
            carry = s >> np.uint64(16)
            cols[f"cb{k}"] = _pad(carry)
        cols["vr"] = _pad(access.vr)
        cols["vw"] = _pad(access.vw)
        cols["st"] = _pad(access.st)
        cols["rt"] = _pad(access.read_ts)
        idx = np.arange(padded, dtype=np.uint64)
        rt = cols["rt"]
        cols["tl0"] = rt & _M16
        cols["tl1"] = rt >> np.uint64(16)
        lag = idx - rt  # >= 0 for honest advice (rt <= position)
        cols["dl0"] = lag & _M16
        cols["dl1"] = lag >> np.uint64(16)

        if self._forge_hook is not None:
            self._forge_hook(cols)

        # Multiplicities over RANGE16 for every ranged (scaled) column.
        m_col = np.zeros(1 << 16, dtype=np.uint64)
        for c, coef in _RANGED:
            scaled = np.uint64(coef) * cols[c]
            if np.any(scaled > _M16):
                if not self._unsafe:
                    raise AssertionError(f"memcheck violated: column {c} out of range")
                scaled = scaled & _M16
            m_col += np.bincount(scaled.astype(np.int64), minlength=1 << 16).astype(np.uint64)

        transcript.append_bytes(b"MC_BEGIN")
        transcript.append_u64(A)
        transcript.append_u64(len(access.touched))
        for a, fv, fts in access.touched:
            transcript.append_u64(a)
            transcript.append_u64(fv)
            transcript.append_u64(fts)

        self.A = A
        self.num_vars = num_vars
        self.idx = idx
        self.cols = cols
        self.m_col = m_col
        return {**cols, "m": m_col}

    def advice_phase(self, transcript) -> Dict[str, np.ndarray]:
        F, cols, idx, access = self.F, self.cols, self.idx, self.access
        p = F.MODULUS
        P64 = np.uint64(p)
        A, num_vars = self.A, self.num_vars
        padded = 1 << num_vars
        sel = le_table(A - 1, num_vars) if A else np.zeros(padded, dtype=np.uint64)

        nonce = 0
        while True:
            trial = transcript.fork()
            trial.append_bytes(b"MC_CHAL")
            trial.append_u64(nonce)
            tau_m = challenge_ext(trial)
            tau_r = challenge_ext(trial)
            gamma = challenge_ext(trial)
            gp = _gamma_powers(gamma)
            ok = high_coords_nonzero(tau_r)
            denoms: Dict[str, Ext4] = {}
            if ok:
                addr_fp = gp[0] * cols["a0"]
                for k in (1, 2, 3):
                    addr_fp = addr_fp + gp[k] * cols[f"a{k}"]
                for side in ("r", "w"):
                    v = cols["vr"] if side == "r" else cols["vw"]
                    ts = cols["rt"] if side == "r" else (idx + np.uint64(1)) % P64
                    kappa = addr_fp + gp[4] * v + gp[5] * ts
                    d = tau_m - kappa
                    if np.any(d.is_zero() & (sel == 1)):
                        ok = False
                        break
                    denoms[f"g_{side}"] = d
            init_sum = final_sum = None
            if ok:
                init_entries = [(a, self.init_mem.get(a, 0), 0)
                                for a, _fv, _ft in access.touched]
                init_sum = _boundary_sum(tau_m, gamma, init_entries, p)
                final_sum = _boundary_sum(tau_m, gamma, access.touched, p)
                ok = init_sum is not None and final_sum is not None
            if ok:
                break
            nonce += 1
            assert nonce <= MAX_NONCE, "memcheck nonce overflow"
        transcript.append_bytes(b"MC_CHAL")
        transcript.append_u64(nonce)
        assert challenge_ext(transcript) == tau_m
        assert challenge_ext(transcript) == tau_r
        assert challenge_ext(transcript) == gamma

        g_cols: Dict[str, Ext4] = {}
        for name, d in denoms.items():
            g_cols[name] = sel * d.inv()
        from .regcheck import _fraction_sum_parts

        for i, group in enumerate(_RANGE_GROUPS):
            ds = [tau_r - np.uint64(coef) * cols[c] % P64 for c, coef in group]
            prod_all, num = _fraction_sum_parts(ds)
            g_cols[f"gq{i}"] = num * prod_all.inv()
        h_col = (tau_r - idx_table(16, p)).inv() * self.m_col

        g_sums = {name: col.sum() for name, col in g_cols.items()}
        h_sum = h_col.sum()
        transcript.append_bytes(b"MC_G")
        for name in sorted(g_sums):
            absorb_ext(transcript, g_sums[name])
        transcript.append_bytes(b"MC_H")
        absorb_ext(transcript, h_sum)

        if not self._unsafe:
            if g_sums["g_r"] + final_sum != g_sums["g_w"] + init_sum:
                raise AssertionError("memcheck violated: memory multiset mismatch")
            rng_lhs = sum(g_sums[g] for g in G_RNG)
            if rng_lhs != h_sum:
                raise AssertionError("memcheck violated: range multiset mismatch")

        self.sel = sel
        self.tau_m, self.tau_r, self.gamma = tau_m, tau_r, gamma
        self.nonce = nonce
        self.g_coords = pack_g_coords(g_cols)
        self.h_coords = pack_g_coords({"h": h_col})
        self.g_sums = g_sums
        self.h_sum = h_sum
        return {**self.g_coords, **self.h_coords}

    @cached_property
    def zerochecks(self) -> List[ZerocheckExtProver]:
        """The trace-domain and the RANGE16 zerocheck, in proving order,
        made once after the advice phase (prover/unified.py starts them
        there)."""
        F = self.F
        p = F.MODULUS
        all_cols = dict(self.cols)
        all_cols.update(self.g_coords)
        all_cols["__sel__"] = self.sel
        all_cols["__idx__"] = self.idx % np.uint64(p)
        table_cols = {"m": self.m_col, "__key__": idx_table(16, p)}
        table_cols.update(self.h_coords)
        return [
            ZerocheckExtProver(F, all_cols, _make_combiner(self.tau_m, self.tau_r, self.gamma, p),
                               MEMCHECK_DEGREE, num_alphas=NUM_CONSTRAINTS, device=unified_device(self)),
            ZerocheckExtProver(F, table_cols, _make_table_combiner(self.tau_r), MEMCHECK_DEGREE,
                               num_alphas=1, device=unified_device(self)),
        ]

    def zerocheck_phase(self, transcript, sink) -> None:
        from .regcheck import register_claims

        zc, zc_t = (prove_unified_zerocheck(self, z, transcript) for z in self.zerochecks)

        self.proof = MemCheckProof(
            nonce=self.nonce, num_vars=self.num_vars, num_accesses=self.A,
            touched=list(self.access.touched), zc=zc, zc_table=zc_t,
            g_sums=self.g_sums, h_sum=self.h_sum,
        )
        register_claims(self, sink, zc, zc_t, self.g_sums, self.h_sum)


class MemCheckStandalone:
    def __init__(self, mc: MemCheckProof, unified):
        self.mc = mc
        self.unified = unified

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "mc"), name)

    @property
    def root_cols(self):
        return self.unified.data_root

    @root_cols.setter
    def root_cols(self, value):
        self.unified.data_root = value


def prove_memcheck(F, transcript, access: ByteAccessColumns,
                   init_mem: Dict[int, int], hash_mode: str = "sha3",
                   _forge_hook=None,
                   _unsafe_skip_self_checks=False, *, device) -> MemCheckStandalone:
    from ..prover.unified import prove_unified

    arg = MemcheckArgument(F, access, init_mem, forge_hook=_forge_hook,
                           unsafe_skip_self_checks=_unsafe_skip_self_checks)
    unified = prove_unified(F, transcript, [arg], hash_mode, device=device)
    return MemCheckStandalone(mc=arg.proof, unified=unified)


# ---------------------------------------------------------------------------
# Verifier


class MemcheckVerify:
    """Verifier-side phased argument (prover/unified.py harness)."""

    ns = "mc"

    def __init__(self, F, mc: MemCheckProof, num_steps: int,
                 init_mem: Dict[int, int]):
        self.F = F
        self.mc = mc
        self.num_steps = num_steps
        self.init_mem = init_mem
        self.locmap = {}

    def data_phase(self, transcript) -> Optional[Dict[str, int]]:
        mc = self.mc
        if not isinstance(mc, MemCheckProof):
            return None
        A = mc.num_accesses
        if not (0 <= A <= 8 * self.num_steps):
            return None
        if mc.num_vars != max(1, (max(A, 1) - 1).bit_length() or 1):
            return None
        if len(mc.touched) > max(A, 1):
            return None
        prev = -1
        for a, fv, fts in mc.touched:
            if not (0 <= a <= _M64 and prev < a):
                return None  # sorted, deduplicated addresses
            if not (0 <= fv < 256 and 0 <= fts <= A):
                return None
            prev = a
        if not (0 <= mc.nonce <= MAX_NONCE):
            return None

        transcript.append_bytes(b"MC_BEGIN")
        transcript.append_u64(A)
        transcript.append_u64(len(mc.touched))
        for a, fv, fts in mc.touched:
            transcript.append_u64(a)
            transcript.append_u64(fv)
            transcript.append_u64(fts)
        shape = {name: mc.num_vars for name in COLUMNS}
        shape["m"] = 16
        return shape

    def advice_phase(self, transcript) -> Optional[Dict[str, int]]:
        mc = self.mc
        p = self.F.MODULUS
        transcript.append_bytes(b"MC_CHAL")
        transcript.append_u64(mc.nonce)
        tau_m = challenge_ext(transcript)
        tau_r = challenge_ext(transcript)
        gamma = challenge_ext(transcript)
        if not high_coords_nonzero(tau_r):
            return None

        g_names = sorted(G_MEM + G_RNG)
        if set(mc.g_sums) != set(g_names):
            return None
        if not all(isinstance(v, Ext4) and v.is_scalar for v in mc.g_sums.values()):
            return None
        if not (isinstance(mc.h_sum, Ext4) and mc.h_sum.is_scalar):
            return None
        transcript.append_bytes(b"MC_G")
        for name in g_names:
            absorb_ext(transcript, mc.g_sums[name])
        transcript.append_bytes(b"MC_H")
        absorb_ext(transcript, mc.h_sum)

        # Grand equations: the memory multiset and the range multiset.
        init_entries = [(a, self.init_mem.get(a, 0), 0)
                        for a, _fv, _ft in mc.touched]
        init_sum = _boundary_sum(tau_m, gamma, init_entries, p)
        final_sum = _boundary_sum(tau_m, gamma, mc.touched, p)
        if init_sum is None or final_sum is None:
            return None
        if mc.g_sums["g_r"] + final_sum != mc.g_sums["g_w"] + init_sum:
            return None
        if sum(mc.g_sums[g] for g in G_RNG) != mc.h_sum:
            return None

        self.tau_m, self.tau_r, self.gamma = tau_m, tau_r, gamma
        shape = {gc: mc.num_vars for gc in g_coord_names(g_names)}
        for e in range(4):
            shape[f"h#{e}"] = 16
        return shape

    def zerocheck_phase(self, transcript, sink) -> bool:
        from .regcheck import register_claims

        F, mc = self.F, self.mc
        p = F.MODULUS
        col_names = sorted(COLUMNS)
        gc_names = sorted(g_coord_names(sorted(G_MEM + G_RNG)))
        if set(mc.zc.column_evals) != set(col_names) | set(gc_names):
            return False
        if mc.zc.num_vars != mc.num_vars or mc.zc.degree != MEMCHECK_DEGREE:
            return False
        if not ZerocheckExtVerifier(
            F, _make_combiner(self.tau_m, self.tau_r, self.gamma, p),
            NUM_CONSTRAINTS, MEMCHECK_DEGREE,
            public_evals=_public_evals(mc.num_accesses, mc.num_vars, p),
        ).verify(mc.zc, transcript):
            return False

        hc_names = sorted(g_coord_names(["h"]))
        if set(mc.zc_table.column_evals) != {"m"} | set(hc_names):
            return False
        if mc.zc_table.num_vars != 16 or mc.zc_table.degree != MEMCHECK_DEGREE:
            return False
        if not ZerocheckExtVerifier(
            F, _make_table_combiner(self.tau_r), 1, MEMCHECK_DEGREE,
            public_evals=_table_public_evals(p),
        ).verify(mc.zc_table, transcript):
            return False

        register_claims(self, sink, mc.zc, mc.zc_table, mc.g_sums, mc.h_sum)
        return True


def verify_memcheck(F, transcript, proof: MemCheckStandalone, num_steps: int,
                    init_mem: Dict[int, int], hash_mode: str = "sha3") -> bool:
    from ..prover.unified import verify_unified

    arg = MemcheckVerify(F, proof.mc, num_steps, init_mem)
    return verify_unified(F, transcript, [arg], proof.unified, hash_mode) is None
