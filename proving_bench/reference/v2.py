"""The plain reference of protocol v2: the comparison that decides
`correct` for its proofs, and its control.

Protocol v2 proves an execution with five arguments (the core zerocheck
with its pc-chain logUp, lookup validity, the register check, the memory
check and the bytecode argument) whose columns lie under two Ligero
commitments, DATA and ADVICE, followed by a batch evaluation that folds
every claim to one point, one opening of each commitment there, Lasso
records and the v1-style witness openings (`v2wire.py` has the layout).

The reference does not rebuild the arguments' columns. It re-derives,
from the guest, its input and the trace size alone, every part of a
proof that depends on the execution only, and it verifies every other
part as the protocol's verifier does, each challenge drawn from its own
replay of the transcript:

* `execution`: the header and the public IO against its own run
  (`rv64.py`), one count a field that differs;
* `witness_roots`: the 43 witness roots against its own Merkle forest;
* `witness_openings`: each of the 43 openings (its point against the
  replayed challenges, index, leaf, siblings, directions, and the value
  against the column's multilinear extension), one count an opening with
  any fault;
* `lasso`: each table's record and extras against its own queries
  (`lasso.py`): lookups, claimed sum, query commitment, round
  coefficients, point and final value; and the lookup-validity tables and
  query links, which have to be its own gadget-covered tables with their
  query counts; one count a table with any fault;
* `zerochecks`: each zerocheck of every argument: g(0) + g(1) against the
  running claim, its point against the replayed challenges and, for the
  core argument, the ADD, SUB and BRANCH validity tables, the register
  check, the memory check, the bytecode argument's steps and program
  (against its own decode of the image, `bytecode.py`), the RANGE16 table
  sides, the query links and the memory link, eq(tau, r) times the
  combination of its constraints at its terminal evaluations against the
  final claim; one count a zerocheck with any fault;
* `logup_sums`: the grand-sum equations the proof's logUp sums must meet
  (lookup queries against the subtable side, range queries against their
  table, the bytecode fetch, counter, byte-chain, range, query-link and
  memory-link multisets, and the boundaries from its own run: the
  register file from zero to the public final registers, memory from the
  loaded image, the public output tape), one count an equation that
  fails;
* `data_root`, `advice_root`: the opened columns of each commitment
  against its root (column SHA3-256 of the rows as u32 LE, Merkle
  multiproof at the replayed query positions), 1 where they do not hash
  to it;
* `batch_eval`: the batch evaluation: every argument's claims, in the
  order the arguments make them, folded by the replayed challenges from
  their combination to each column's weight at the point times its
  evaluation there; one count a fault;
* `openings`: each Ligero opening: its shape against the configuration
  (one batched row, `num_rho` proximity rows, `num_queries` columns, rate
  1 / `inv_rate`, the mixed layout of the columns the batch evaluation
  names), its row against the claimed column evaluations, and the opened
  columns against the row's Reed-Solomon codeword; one count a fault;
* `proof_bytes`: the bytes that differ from the reference's own emission
  of the parts it re-derives (header, public IO, Lasso records, witness
  openings, Lasso extras), length differences included, plus any bytes
  after the proof's end.

Not re-derived: the constraint combinations of the other lookup-validity
gadgets (logic, shifts, compares, word ops, multiplies, divisions); their
rounds, points and claims are checked as above.

Every number is a count whose limit is 0. The control is the proof that
`compare` read last for the same guest, input and trace size, with its
ADVICE opening re-made at half the configuration's queries.
"""

from __future__ import annotations

import hashlib
import struct
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from . import bytecode, ext4, forest, lasso, rv64, v2wire
from .ext4 import P, Transcript
from .proof import header, public_io

VERSION = 2
COLUMNS = 43
RAW_BASE = 0x1000  # where a program that is not an ELF file is loaded, and its entry

NAMES = ("execution", "witness_roots", "witness_openings", "lasso", "zerochecks", "logup_sums", "data_root",
         "advice_root", "batch_eval", "openings", "proof_bytes")
LIMITS = {name: 0 for name in NAMES}

REG_REFS = ("a1", "a2", "a3", "rv1_0", "rv1_1", "rv1_2", "rv1_3", "rv2_0", "rv2_1", "rv2_2", "rv2_3",
            "wv_0", "wv_1", "wv_2", "wv_3")  # the register check's columns the bytecode step reads
PC_REFS = ("pc", "seq", "next_pc")  # the core argument's
MEM_REFS = ("ba0", "ba1", "ba2", "ba3", "bk", "vw", "st")  # the memory check's, for the memory link
BC_SUMS = {"g_bc": "g", "g_c1": "gc1", "g_c2": "gc2", "g_out": "gout", "g_lk_s": "glk", "g_b1": "gb1", "g_b2": "gb2",
           **{f"grp{i}": ("gr", i) for i in range(8)}, **{f"gmp{i}": ("gm", i) for i in range(4)}}
COORDS = tuple(range(4))


@dataclass
class Expected:
    """What the reference works out for one prove from the execution alone."""

    program: bytes
    execution: rv64.Execution
    num_vars: int
    roots: List[bytes]
    forest: forest.Forest
    matrix: np.ndarray
    tables: List[lasso.Table]
    program_table: Dict[str, np.ndarray]  # the bytecode argument's decode of the image
    key: tuple  # the guest's hash, the input tape and the trace size


def load(program: bytes):
    """(entry pc, segments) of an ELF guest, or of a raw image at RAW_BASE."""
    if program[:4] == b"\x7fELF":
        return rv64.parse_elf(program)
    return RAW_BASE, [(RAW_BASE, program)]


def expect(program: bytes, input_tape, max_steps: int, config: dict, device) -> Expected:
    entry, segments = load(program)
    ex = rv64.execute(entry, segments, input_tape, max_steps)
    matrix = rv64.witness_matrix(ex, config["modulus"])
    trees = forest.build(matrix, device)
    return Expected(program, ex, rv64.num_vars(ex.steps), trees.roots(), trees, matrix, lasso.tables(ex),
                    bytecode.table(segments), _key(program, input_tape, max_steps))


def _key(program: bytes, input_tape, max_steps: int) -> tuple:
    return hashlib.sha256(program).digest(), tuple(input_tape or ()), max_steps


def _head(program: bytes, exp: Expected) -> bytes:
    return header(VERSION, P, exp.execution.steps, exp.num_vars) + public_io(program, exp.execution)


def _preamble(program: bytes, ex: rv64.Execution) -> Transcript:
    t = Transcript()
    t.absorb(hashlib.sha256(program).digest())
    t.element(ex.entry_pc, P)
    return t


def _lasso_bytes(exp: Expected, t: Transcript, wire: Optional[List[v2wire.LassoRecord]] = None):
    """The Lasso records the reference emits, and per table whether the
    proof's record (absorbed in the reference's place, so that the replay
    follows the proof) differs. `wire` None: the reference's own."""
    t.absorb(b"LASSO_BEGIN")
    parts, faults = [struct.pack("<I", len(exp.tables))], 0
    got = {rec.table_id: rec for rec in wire or []}
    for tab in exp.tables:
        rec = got.get(tab.table_id)
        t.absorb(b"LASSO_TABLE")
        t.element(tab.table_id, P)
        t.absorb(tab.commitment)
        t.u64(tab.claimed)
        it = iter(rec.rounds if rec is not None else [])

        def challenge(coeffs):
            for c in next(it, None) or coeffs:
                t.element(c, P)
            return t.challenge(P)

        rounds, point, final = lasso.sumcheck(tab.evals, challenge)
        v = len(point)
        parts.append(struct.pack("<IQI", tab.table_id, tab.lookups, v))
        parts.append(np.array(rounds, dtype="<u8").tobytes() + np.array(point + [final], dtype="<u8").tobytes())
        if wire is not None:
            faults += rec is None or (rec.lookups, rec.num_vars, [tuple(x) for x in rec.rounds], rec.point,
                                      rec.final) != (tab.lookups, v, rounds, point, final)
    if wire is not None:
        faults += len({rec.table_id for rec in wire} - {tab.table_id for tab in exp.tables})
    return b"".join(parts), faults


def _witness_bytes(exp: Expected, t: Transcript, roots: List[bytes], values=None):
    """The witness openings the reference emits at the replayed points
    (absorbing the proof's `roots` and `values` where given)."""
    v = exp.num_vars
    t.absorb(b"POLY_COMMITMENTS")
    for root in roots:
        t.absorb(root)
    points = np.array([[t.challenge(P) for _ in range(v)] for _ in range(COLUMNS)], dtype=np.uint64)
    points = points.reshape(COLUMNS, v)
    mine = forest.evaluate(exp.matrix, points, P, exp.forest.levels[0].device)
    t.absorb(b"OPENING_CLAIMS")
    for x in (mine if values is None else values):
        t.element(int(x), P)
    index = points[:, 0] % np.uint64(1 << v) if v else np.zeros(COLUMNS, dtype=np.uint64)
    siblings = exp.forest.siblings(index.astype(np.int64))
    parts = []
    for i in range(COLUMNS):
        idx = int(index[i])
        parts.append(exp.roots[i] + points[i].astype("<u8").tobytes())
        parts.append(struct.pack("<QQQQI", int(mine[i]), int(mine[i]), idx, int(exp.matrix[i, idx]), v))
        parts.append(siblings[i].tobytes() + bytes((idx >> k) & 1 for k in range(v)))
    return b"".join(parts), points, mine, siblings


def _extras_bytes(exp: Expected) -> bytes:
    return struct.pack("<I", len(exp.tables)) + b"".join(
        struct.pack("<IQ", tab.table_id, tab.claimed) + tab.commitment for tab in exp.tables)


# The proofs `compare` read last, by `Expected.key`: (bytes, the positions
# the ADVICE opening's columns were drawn at), for the control to re-make.
_COMPARED: Dict[tuple, tuple] = {}
_KEEP = 16


def control(program: bytes, input_tape, max_steps: int, config: dict, device) -> bytes:
    """The proof `compare` read last for the same guest, input and trace
    size, with its ADVICE opening made at half the configuration's queries:
    its first num_queries / 2 columns, in the order the transcript drew
    them, and the Merkle frontier of those alone. It saves half the
    opening's columns and paths; the columns still hash to the root."""
    found = _COMPARED.get(_key(program, input_tape, max_steps))
    if found is None:
        raise LookupError("the control re-makes a proof that compare has read: compare the proof first")
    data, positions = found
    got = v2wire.parse(data)
    op, half = got.advice_open, config["num_queries"] // 2
    height = (config["inv_rate"] * op.n).bit_length() - 1
    leaves = [hashlib.sha3_256(c).digest() for c in op.columns]
    it = iter(op.nodes)
    _, seen = _walk(positions, leaves, lambda level, pos: next(it, None), height)
    frontier: List[bytes] = []
    _walk(positions[:half], leaves[:half], lambda level, pos: frontier.append(seen[(level, pos)]) or seen[(level, pos)],
          height)
    short = v2wire.Ligero(op.n, op.us, op.ws, half, op.rows, op.columns[:half], op.column_values[:half], frontier)
    lo, hi = got.sections["ligero"]
    return data[:lo] + _ligero_bytes(got.data_open) + _ligero_bytes(short) + data[hi:]


def _ligero_bytes(op: v2wire.Ligero) -> bytes:
    """One opening as the wire format lays it out (`v2wire._ligero`)."""
    parts = [struct.pack("<II", op.n, len(op.us))] + [struct.pack(f"<{4 * op.n}I", *u) for u in op.us]
    parts += [struct.pack("<I", len(op.ws))] + op.ws + [struct.pack("<II", op.t, op.rows)] + op.columns
    return b"".join(parts + [struct.pack("<I", len(op.nodes))] + op.nodes)


def _zerocheck(t: Transcript, zc: v2wire.Zerocheck, combine=None) -> int:
    """Replay one zerocheck; 1 where a round sum or its point is wrong or,
    given its constraints' `combine(evals, point, alphas)`, where
    eq(tau, r) times that combination of its terminal evaluations is not
    the final claim."""
    taus = t.challenges_ext(zc.num_vars)  # the eq randomizer
    alphas = t.challenges_ext(zc.alphas)  # one a constraint
    claim, bad, rs = ext4.ZERO, 0, []
    for j, g in enumerate(zc.rounds):
        bad |= ext4.add(g[0], g[1]) != claim
        for x in g:
            t.ext(x)
        rs.append(t.challenge_ext())
        bad |= rs[-1] != zc.point[j]
        claim = ext4.interpolate(g, rs[-1])
    for x in zc.evals:
        t.ext(x)
    if combine is not None:
        try:
            bad |= ext4.mul(ext4.eq(taus, rs), combine(zc.evals, rs, alphas)) != claim
        except KeyError:  # an evaluation its constraints need is not in the proof
            bad = 1
    return int(bad)


def _table_side(tau):
    """The logUp table side over a 2^16 index domain, key = index: with the
    evaluations h#0..h#3, m, alpha (h (tau - index) - m) = 0."""
    def combine(evals, rs, alphas):
        h = ext4.from_coords(evals[:4])
        return ext4.mul(alphas[0], ext4.sub(ext4.mul(h, ext4.sub(tau, ext4.index_mle(rs))), evals[4]))
    return combine




def _named(names, evals):
    e = dict(zip(names, evals))
    return e, lambda g: ext4.from_coords([e[f"{g}#{k}"] for k in COORDS])


def _range_groups(ranged, e, g, tau_r):
    """Four range-checked (column, coefficient) pairs a column gq_i: gq_i
    is the sum of 1 / (tau_r - coefficient column)."""
    groups = [ranged[i:i + 4] for i in range(0, len(ranged), 4)]
    return [ext4.fraction([ext4.sub(tau_r, ext4.mul(ext4.lift(c), e[n])) for n, c in grp], g(f"gq{i}"))
            for i, grp in enumerate(groups)]


def _regcheck(names, steps: int, chal):
    """The register check's 26 constraints: per access m of a step (rs1,
    rs2, rd) the read and the write fingerprints' logUp inverses
    g (tau_m - kappa) = sel, kappa = cell + gamma^(1..4) the value's limbs +
    gamma^5 the timestamp (a read's rt_m, a write's 3 idx + m); each read
    timestamp and its lag behind the step split into 16-bit limbs; x0
    hardwired (z0 = 1[a3 = 0] through ia3, and z0 zeroes the written
    value); the range columns' merged inverses."""
    tau_m, tau_r, gamma = chal
    gp = ext4.powers(gamma, 6)
    values = [f"{v}_{k}" for v in ("rv1", "rv2", "ov", "wv") for k in range(4)]
    ranged = [(c, 1) for c in values] + [(f"{pre}{m}", c) for m in (1, 2, 3)
                                         for pre, c in (("tl0_", 1), ("tl1_", 16), ("dl0_", 1), ("dl1_", 16))]

    def combine(evals, rs, alphas):
        e, g = _named(names, evals)
        one, sel, idx = ext4.lift(1), ext4.le_mle(steps - 1, rs), ext4.index_mle(rs)
        terms = []
        for m in (1, 2, 3):
            for side in ("r", "w"):
                pre = {1: "rv1", 2: "rv2", 3: "ov" if side == "r" else "wv"}[m]
                ts = e[f"rt{m}"] if side == "r" else ext4.add(ext4.mul(ext4.lift(3), idx), ext4.lift(m))
                kappa = ext4.lin(gp, [e[f"a{m}"]] + [e[f"{pre}_{k}"] for k in range(4)] + [ts])
                terms.append(ext4.sub(ext4.mul(g(f"g_{side}{m}"), ext4.sub(tau_m, kappa)), sel))
        for m in (1, 2, 3):
            terms.append(ext4.sub(e[f"rt{m}"], ext4.lin([one, ext4.lift(1 << 16)], [e[f"tl0_{m}"], e[f"tl1_{m}"]])))
            lag = ext4.add(ext4.mul(ext4.lift(3), idx), ext4.lift(m - 1))
            terms.append(ext4.sub(ext4.sub(lag, e[f"rt{m}"]),
                                  ext4.lin([one, ext4.lift(1 << 16)], [e[f"dl0_{m}"], e[f"dl1_{m}"]])))
        z0 = e["z0"]
        terms += [ext4.sub(ext4.add(ext4.mul(e["a3"], e["ia3"]), z0), one), ext4.mul(z0, e["a3"]),
                  ext4.mul(z0, ext4.sub(one, z0))] + [ext4.mul(z0, e[f"wv_{k}"]) for k in range(4)]
        return ext4.combination(terms + _range_groups(ranged, e, g, tau_r), alphas)
    return combine


def _memcheck(names, accesses: int, chal):
    """The byte memory check's 18 constraints: the read and the write
    fingerprints' logUp inverses (kappa = gamma^(0..3) the address's limbs
    + gamma^4 the byte + gamma^5 the timestamp, a read's rt, a write's
    idx + 1); rt and its lag split into limbs; st boolean and a load
    writing back what it read; the address as base + offset through a
    four-limb carry chain, its carries boolean; the range columns' merged
    inverses."""
    tau_m, tau_r, gamma = chal
    gp = ext4.powers(gamma, 6)
    ranged = [("a0", 1), ("a1", 1), ("a2", 1), ("a3", 1), ("vr", 256), ("vw", 256), ("tl0", 1), ("tl1", 16),
              ("dl0", 1), ("dl1", 16), ("ba0", 1), ("ba1", 1), ("ba2", 1), ("ba3", 1), ("bk", 8192)]

    def combine(evals, rs, alphas):
        e, g = _named(names, evals)
        one, idx = ext4.lift(1), ext4.index_mle(rs)
        sel = ext4.le_mle(accesses - 1, rs) if accesses else ext4.ZERO
        addr = ext4.lin(gp[:4], [e[f"a{k}"] for k in range(4)])
        terms = []
        for side, v, ts in (("r", e["vr"], e["rt"]), ("w", e["vw"], ext4.add(idx, one))):
            kappa = ext4.add(addr, ext4.lin(gp[4:], [v, ts]))
            terms.append(ext4.sub(ext4.mul(g(f"g_{side}"), ext4.sub(tau_m, kappa)), sel))
        shift = ext4.lift(1 << 16)
        terms.append(ext4.sub(e["rt"], ext4.lin([one, shift], [e["tl0"], e["tl1"]])))
        terms.append(ext4.sub(ext4.sub(idx, e["rt"]), ext4.lin([one, shift], [e["dl0"], e["dl1"]])))
        st = e["st"]
        terms += [ext4.mul(st, ext4.sub(one, st)), ext4.mul(ext4.sub(one, st), ext4.sub(e["vw"], e["vr"]))]
        for k in range(4):
            cin = e[f"cb{k - 1}"] if k else e["bk"]
            terms.append(ext4.sub(ext4.sub(ext4.add(e[f"ba{k}"], cin), e[f"a{k}"]), ext4.mul(shift, e[f"cb{k}"])))
        terms += [ext4.mul(e[f"cb{k}"], ext4.sub(one, e[f"cb{k}"])) for k in range(4)]
        return ext4.combination(terms + _range_groups(ranged, e, g, tau_r), alphas)
    return combine


def _memory_link(accesses: int, tau_w, eps):
    """The bytecode argument's link to the memory check's byte rows: over
    the evaluations g_lnk#0..3 and the rows' ba0..3, bk, st, vw,
    alpha (g_lnk (tau_w - kappa) - sel) = 0, kappa = eps^1 idx + eps^(2..5)
    the base address's limbs + eps^6 the offset + eps^7 the byte + eps^8
    the store flag, sel the rows 0..accesses-1."""
    names = sorted([f"g_lnk#{k}" for k in COORDS] + [f"ref_{x}" for x in MEM_REFS])
    ep = ext4.powers(eps, 9)[1:]

    def combine(evals, rs, alphas):
        e, g = _named(names, evals)
        kappa = ext4.lin(ep, [ext4.index_mle(rs)] + [e[f"ref_{x}"] for x in ("ba0", "ba1", "ba2", "ba3", "bk", "vw", "st")])
        return ext4.mul(alphas[0], ext4.sub(ext4.mul(g("g_lnk"), ext4.sub(tau_w, kappa)), ext4.le_mle(accesses - 1, rs)))
    return combine


def _link_slots(tid: int, e) -> List[tuple]:
    """A validity table's query as the link fingerprints it, rebuilt from
    the gadget's committed columns: the two inputs' and the output's four
    16-bit limbs (a byte pair a limb where the gadget commits bytes; SUB
    commits (out, in1, in0); a compare's output and a branch's funct3 and
    taken bit sit in the first output slots; a word result's top limbs
    are 0xFFFF times its sign)."""
    def limbs(pre):
        return [e[f"{pre}{j}"] for j in range(4)]

    def pairs(pre, first=0, count=4):
        return [ext4.lin([ext4.lift(1), ext4.lift(256)], [e[f"{pre}{first + 2 * j}"], e[f"{pre}{first + 2 * j + 1}"]])
                for j in range(count)]

    def word(pre, sign):
        fill = ext4.mul(ext4.lift(0xFFFF), e[sign])
        return pairs(pre, count=2) + [fill, fill]

    zero = ext4.ZERO
    if tid in (0, 5, 6, 7, 13, 14, 15, 16, 17):
        return limbs("x") + limbs("y") + limbs("z")
    if tid == 1:
        return limbs("z") + limbs("y") + limbs("x")
    if tid in (2, 3, 4):
        return pairs("a") + pairs("b") + pairs("o")
    if tid in (8, 9):
        return limbs("x") + limbs("y") + [e["o"], zero, zero, zero]
    if tid == 10:
        return limbs("x") + limbs("y") + [e["f3"], e["o"], zero, zero]
    out = {18: lambda: pairs("zb"), 21: lambda: pairs("zb", 8), 19: lambda: pairs("wb"), 20: lambda: pairs("wb"),
           22: lambda: word("zb", "sw"), 23: lambda: pairs("qb"), 24: lambda: pairs("qb"), 25: lambda: pairs("rb"),
           26: lambda: pairs("rb"), 27: lambda: word("qb", "swq"), 28: lambda: word("qb", "swq"),
           29: lambda: word("rb", "swr"), 30: lambda: word("rb", "swr")}[tid]()
    return pairs("xb") + pairs("yb") + out


def _query_link(tid: int, queries: int, names, tau_l, delta):
    """A validity table's link to the steps' lookups: over the gadget's
    columns and g_lk#0..3, alpha (g_lk (tau_l - key) - sel) = 0, key =
    delta^1 (tid + 1) + delta^(2..13) the query's twelve limbs, sel the
    rows 0..queries-1."""
    dl = ext4.powers(delta, 14)[1:]

    def combine(evals, rs, alphas):
        e, g = _named(names, evals)
        key = ext4.lin(dl, [tid + 1] + _link_slots(tid, e))
        return ext4.mul(alphas[0], ext4.sub(ext4.mul(g("g_lk"), ext4.sub(tau_l, key)), ext4.le_mle(queries - 1, rs)))
    return combine


BRANCH_F3 = {"t_eq": 0, "t_ne": 1, "t_lt": 4, "t_ge": 5, "t_ltu": 6, "t_geu": 7}


def _add_sub(e, one) -> List[tuple]:
    """z = x + y over four 16-bit limbs with boolean carries (SUB commits
    z + y = x)."""
    terms = []
    for j in range(4):
        cin = e[f"c{j - 1}"] if j else ext4.ZERO
        terms.append(ext4.sub(ext4.sub(ext4.add(ext4.add(e[f"x{j}"], e[f"y{j}"]), cin), e[f"z{j}"]),
                              ext4.mul(ext4.lift(1 << 16), e[f"c{j}"])))
    return terms + [ext4.mul(e[f"c{j}"], ext4.sub(one, e[f"c{j}"])) for j in range(4)]


def _branch(e, one) -> List[tuple]:
    """taken = the funct3-selected comparison: a one-hot of the six
    comparisons bound to funct3; per-limb equality through inverses and a
    product tree; the unsigned borrow chain x - y = d - 2^64 b3; the
    signed top limb through the sign bits; the booleans."""
    shift = ext4.lift(1 << 16)
    bools = ("t_eq", "t_ne", "t_lt", "t_ge", "t_ltu", "t_geu", "b0", "b1", "b2", "b3", "s_x", "s_y", "sb3")
    terms = [ext4.mul(e[b], ext4.sub(one, e[b])) for b in bools]
    terms.append(ext4.sub(ext4.esum(e[t] for t in BRANCH_F3), one))
    terms.append(ext4.sub(e["f3"], ext4.lin([ext4.lift(c) for c in BRANCH_F3.values()], [e[t] for t in BRANCH_F3])))
    for j in range(4):
        diff = ext4.sub(e[f"x{j}"], e[f"y{j}"])
        terms += [ext4.sub(ext4.add(ext4.mul(diff, e[f"i{j}"]), e[f"e{j}"]), one), ext4.mul(e[f"e{j}"], diff)]
    terms += [ext4.sub(e["e01"], ext4.mul(e["e0"], e["e1"])), ext4.sub(e["e23"], ext4.mul(e["e2"], e["e3"])),
              ext4.sub(e["e"], ext4.mul(e["e01"], e["e23"]))]
    for j in range(4):
        borrow_in = e[f"b{j - 1}"] if j else ext4.ZERO
        terms.append(ext4.add(ext4.sub(ext4.sub(ext4.sub(e[f"x{j}"], e[f"y{j}"]), borrow_in), e[f"d{j}"]),
                              ext4.mul(shift, e[f"b{j}"])))
    for v in ("x", "y"):
        terms.append(ext4.sub(ext4.sub(ext4.mul(ext4.lift(2), e[f"{v}3"]), ext4.mul(shift, e[f"s_{v}"])), e[f"r{v}2"]))
    top = ext4.lin([one, ext4.sub(ext4.ZERO, shift), ext4.lift(P - 1), shift, ext4.lift(P - 1), ext4.lift(P - 1), shift],
               [e["x3"], e["s_x"], e["y3"], e["s_y"], e["b2"], e["sd3"], e["sb3"]])
    taken = ext4.lin([e["e"], ext4.sub(one, e["e"]), e["sb3"], ext4.sub(one, e["sb3"]), e["b3"], ext4.sub(one, e["b3"])],
                 [e[t] for t in ("t_eq", "t_ne", "t_lt", "t_ge", "t_ltu", "t_geu")])
    return terms + [top, ext4.sub(e["o"], taken)]


def _validity(tid: int, names, tau):
    """A lookup-validity table's constraints where the reference states
    its gadget (ADD, SUB, BRANCH; None for the others): the gadget's
    identities, then each group of four RANGE16 inclusions' merged logUp
    inverse gq (g prod(tau - limb) = the fractions' numerator)."""
    if tid in (0, 1):
        gadget, ranged = _add_sub, [f"{v}{j}" for v in "xyz" for j in range(4)]
    elif tid == 10:
        gadget, ranged = _branch, [f"{v}{j}" for v in "xyd" for j in range(4)] + ["rx2", "ry2", "sd3"]
    else:
        return None

    def combine(evals, rs, alphas):
        e, g = _named(names, evals)
        groups = [ranged[i:i + 4] for i in range(0, len(ranged), 4)]
        terms = gadget(e, ext4.lift(1)) + [ext4.fraction([ext4.sub(tau, e[c]) for c in grp], g(f"gq_RANGE16_{i}"))
                                           for i, grp in enumerate(groups)]
        return ext4.combination(terms, alphas)
    return combine


def _core(steps: int, tau, beta):
    """The core argument's six constraints over the evaluations g1#0..3,
    g2#0..3, is_read, next_pc, pc, seq, x0 (PROVER.md, Protocol v2): x0 = 0,
    is_read and seq boolean, seq (next_pc - pc - 4) = 0, and the pc chain's
    logUp inverses g1 (tau - beta (idx + 1) - next_pc) = sel1 (rows 0..n-2),
    g2 (tau - beta idx - pc) = sel2 (rows 1..n-1)."""
    def combine(evals, rs, alphas):
        one = ext4.lift(1)
        g1, g2 = ext4.from_coords(evals[0:4]), ext4.from_coords(evals[4:8])
        is_read, next_pc, pc, seq, x0 = evals[8:13]
        idx = ext4.index_mle(rs)
        sel1 = ext4.le_mle(steps - 2, rs)
        sel2 = ext4.sub(ext4.le_mle(steps - 1, rs), ext4.eq([ext4.ZERO] * len(rs), rs))
        fp1 = ext4.sub(ext4.sub(tau, ext4.mul(beta, ext4.add(idx, one))), next_pc)
        fp2 = ext4.sub(ext4.sub(tau, ext4.mul(beta, idx)), pc)
        terms = [x0, ext4.mul(is_read, ext4.sub(one, is_read)), ext4.mul(seq, ext4.sub(one, seq)),
                 ext4.mul(seq, ext4.sub(ext4.sub(next_pc, pc), ext4.lift(4))),
                 ext4.sub(ext4.mul(g1, fp1), sel1), ext4.sub(ext4.mul(g2, fp2), sel2)]
        return ext4.combination(terms, alphas)
    return combine


def _limbs(v: int) -> List[int]:
    return [(v >> (16 * k)) & 0xFFFF for k in range(4)]


def _fingerprints(tau, keys) -> tuple:
    """sum_i 1 / (tau - keys[i])."""
    return ext4.esum(ext4.inv(ext4.sub(tau, key)) for key in keys)



def _register_boundary(chal, rc, ex: rv64.Execution):
    """Reads plus the final file against writes plus the initial file: a
    register's key is r + gamma^(1..4) its value's 16-bit limbs +
    gamma^5 its timestamp."""
    tau_m, _, gamma = chal
    g = ext4.powers(gamma, 6)
    final = [ext4.lin(g, [r] + _limbs(v) + [ts]) for r, (v, ts) in enumerate(zip(ex.final_regs, rc["final_ts"]))]
    start = [ext4.lin(g, [r, 0, 0, 0, 0, 0]) for r in range(32)]
    sums = rc["g_sums"]  # g_r1..3, g_w1..3, then the range columns
    return (ext4.add(ext4.esum(sums[0:3]), _fingerprints(tau_m, final)),
            ext4.add(ext4.esum(sums[3:6]), _fingerprints(tau_m, start)))


def _memory_boundary(chal, mc, exp: Expected):
    """The byte memory's reads plus its final state against its writes
    plus its initial state, over the touched addresses: a byte's key is
    gamma^(0..3) its address's 16-bit limbs + gamma^4 its value + gamma^5
    its timestamp."""
    tau_m, _, gamma = chal
    g = ext4.powers(gamma, 6)
    image = {}
    for base, data in load(exp.program)[1]:
        image.update({base + i: b for i, b in enumerate(data)})
    final = [ext4.lin(g, _limbs(a) + [v % P, ts % P]) for a, v, ts in mc["touched"]]
    start = [ext4.lin(g, _limbs(a) + [image.get(a, 0), 0]) for a, _, _ in mc["touched"]]
    sums = mc["g_sums"]  # g_r, g_w, then the range columns
    return (ext4.add(sums[0], _fingerprints(tau_m, final)), ext4.add(sums[1], _fingerprints(tau_m, start)))


def _output_tape(chal, bc, ex: rv64.Execution):
    """The committed a0 values against the public output tape: output i's
    key is beta_o^1 i + beta_o^(2..5) its 16-bit limbs."""
    tau_o, beta_o = chal[4], chal[5]
    b = ext4.powers(beta_o, 6)[1:]
    return bc["gout"], _fingerprints(tau_o, [ext4.lin(b, [i] + _limbs(v)) for i, v in enumerate(ex.outputs)])



def column_vars(name: str, got: v2wire.Parsed) -> int:
    """The variables of a committed column, from its argument and name: a
    column lies over its argument's domain, a logUp table side over its
    table's (2^16 for RANGE16 and the byte tables, the program for the
    bytecode fetch), a query link over its table's queries and the memory
    link over the memory check's rows."""
    ns, local = name.split(":", 1)
    if local.split("#")[0] in ("m", "h", "m_r16", "h_r16") or (ns == "lv" and local.startswith(("m_", "h_"))):
        return 16
    if ns == "v2":
        return got.num_vars
    if ns == "lv":
        return next(tab["vars"] for tab in got.lv_tables if local.startswith(f"t{tab['id']}:"))
    if ns == "bc" and local.split("#")[0] in ("m_prog", "h_prog"):
        return got.bc["table_vars"]
    if ns == "bc" and local.startswith("lk"):
        return next(ln["vars"] for ln in got.bc["links"] if local.startswith(f"lk{ln['id']}:"))
    if ns == "bc" and local.startswith("g_lnk"):
        return got.mc["vars"]
    return {"rc": got.rc["vars"], "mc": got.mc["vars"], "bc": got.bc["vars"]}[ns]


def _split(total: int, config: dict) -> int:
    """log2 of a commitment's row length for `total` committed values: the
    opened columns (num_queries of total / n values) against one batched
    extension row of n, balanced."""
    if total <= 2:
        return 1
    rows = 16 * (1 + config["num_rho"])
    return max(1, min(total.bit_length(), round(0.5 * float(np.log2(config["num_queries"] * 4 * total / rows)))))


def _encode_at(row: np.ndarray, n_e: int, positions) -> np.ndarray:
    """The Reed-Solomon codeword of `row` (coefficients, zero-padded to
    n_e) at `positions`: sum_j row[j] w^(q j), w of order n_e from the
    generator 31."""
    w = pow(31, (P - 1) // n_e, P)
    powers = np.ones(n_e, dtype=np.uint64)
    k = 1
    while k < n_e:
        powers[k:2 * k] = powers[:k] * np.uint64(pow(w, k, P)) % np.uint64(P)
        k *= 2
    j = np.arange(row.shape[-1], dtype=np.int64)
    return np.array([[int((r * powers[q * j % n_e] % np.uint64(P)).sum()) % P for q in positions] for r in row])


def _ligero(t: Transcript, op: v2wire.Ligero, root: bytes, col_vars: Dict[str, int], evals: Dict[str, tuple],
            rho: List[tuple], config: dict):
    """Replay one opening: (1 where its columns do not hash to `root`,
    faults of its shape, of its row against the claimed evaluations and of
    the opened columns against the row's codeword, the positions drawn)."""
    gamma = t.challenge_ext()  # the row combination
    for u in op.us:
        t.u64s(u)
    for w in op.ws:  # each proximity row after its own challenge
        t.challenge_ext()
        t.u64s(struct.unpack(f"<{len(w) // 4}I", w))
    n_e = config["inv_rate"] * op.n
    cn = op.n.bit_length() - 1
    names = sorted(col_vars)
    heights = [max(1, (1 << col_vars[k]) >> cn) for k in names]
    unusable = (len(op.us) != 1) + (op.rows != sum(heights))  # its row and columns cannot be read
    shape = unusable + (len(op.ws) != config["num_rho"]) + (op.t != config["num_queries"])
    shape += op.n != 1 << _split(sum(1 << v for v in col_vars.values()), config)
    if unusable or n_e & (n_e - 1) or n_e < 2:
        return 1, shape, []
    indices = [t.index(n_e) for _ in range(op.t)]
    leaves = [hashlib.sha3_256(c).digest() for c in op.columns]
    it = iter(op.nodes)
    top, _ = _walk(indices, leaves, lambda level, pos: next(it, None), n_e.bit_length() - 1)
    rooted = top == root and next(it, None) is None

    # The claim at the batch point rho: b = eq(rho's last cn), each column's
    # rows weighted by eq(its own next variables), the combination gamma^k.
    a_hat = np.zeros((4, op.rows), dtype=np.uint64)
    value, gpow, off, v_max = ext4.ZERO, ext4.lift(1), 0, len(rho)
    for name, m_k in zip(names, heights):
        v_k = col_vars[name]
        e = evals[name]
        if v_k >= cn:
            a_k = ext4.eq_table(rho[v_max - v_k:v_max - cn])
        else:
            a_k = ext4.eq_table([])
            for r in rho[v_max - cn:v_max - v_k]:  # a short column is zero-padded in its row
                e = ext4.mul(e, ext4.sub(ext4.lift(1), r))
        a_hat[:, off:off + m_k] = ext4.mul_np(a_k, gpow)
        value = ext4.add(value, ext4.mul(gpow, e))
        gpow, off = ext4.mul(gpow, gamma), off + m_k
    u = np.array(op.us[0], dtype=np.uint64).reshape(4, op.n)
    b = ext4.eq_table(rho[v_max - cn:])
    bound = tuple(int(x) for x in ext4.mul_np(u, b).sum(axis=1) % np.uint64(P)) == value
    cols = np.array(op.column_values, dtype=np.uint64)  # (t, rows)
    dots = np.stack([(a_hat[e][None, :] * cols % np.uint64(P)).sum(axis=1) % np.uint64(P) for e in range(4)])
    coded = np.array_equal(dots, _encode_at(u, n_e, indices).astype(np.uint64))
    return int(not rooted), shape + int(not bound) + int(not coded), indices


def _walk(indices, leaves, frontier, height: int):
    """The root rebuilt from the opened leaves: per level, the known
    positions in ascending order take each missing sibling from
    `frontier(level, position)`. Returns (the root, or None where two
    leaves at one position differ or a sibling is missing; every node met,
    by (level, position))."""
    known: Dict[int, bytes] = {}
    for i, d in zip(indices, leaves):
        if known.setdefault(i, d) != d:
            return None, {}
    seen = {(0, i): d for i, d in known.items()}
    for level in range(height):
        nxt: Dict[int, bytes] = {}
        for pos in sorted(known):
            if pos >> 1 in nxt:
                continue
            sib = known.get(pos ^ 1)
            if sib is None:
                sib = seen[(level, pos ^ 1)] = frontier(level, pos ^ 1)
                if sib is None:
                    return None, seen
            pair = known[pos] + sib if pos % 2 == 0 else sib + known[pos]
            nxt[pos >> 1] = hashlib.sha3_256(pair).digest()
        known = nxt
        seen.update({(level + 1, pos): d for pos, d in known.items()})
    return known.get(0) if len(known) == 1 else None, seen


def _replay(got: v2wire.Parsed, exp: Expected, program: bytes, config: dict, out: Dict[str, int]):
    """Replay the transcript from the proof's messages and hold each part
    to its relations. Returns the emitted bytes of the Lasso records and
    the witness openings, and the ADVICE opening's positions."""
    ex = exp.execution
    t = _preamble(program, ex)
    t.absorb(b"SUMCHECK_BEGIN")
    t.element(ex.steps, P)
    t.element(exp.num_vars, P)
    t.absorb(b"LV_BEGIN")
    t.u64(len(got.lv_tables))
    for tab in got.lv_tables:
        t.absorb(b"LV_TABLE")
        for x in (tab["id"], tab["queries"], tab["vars"]):
            t.u64(x)
    if got.lv_tables:
        t.absorb(b"LV_MULT")
        t.u64(len(got.lv_side["names"]) if got.lv_side else 0)
        for name in (got.lv_side or {}).get("names", []):
            t.absorb(name.encode())
    rc, mc, bc = got.rc, got.mc, got.bc
    t.absorb(b"RC_BEGIN")
    t.u64(ex.steps)
    for x in list(ex.final_regs) + rc["final_ts"]:
        t.u64(x)
    t.absorb(b"MC_BEGIN")
    t.u64(mc["accesses"])
    t.u64(len(mc["touched"]))
    for row in mc["touched"]:
        for x in row:
            t.u64(x)
    t.absorb(b"BC_BEGIN")
    t.u64(ex.steps)
    t.u64(bc["table_vars"])
    t.absorb(b"V2_DATA")
    t.absorb(got.data_root)

    # ADVICE: each argument's fingerprint challenges after its nonce, then its sums.
    def chal(label: bytes, nonce: int, count: int):
        t.absorb(label)
        t.u64(nonce)
        return t.challenges_ext(count)

    core = chal(b"V2_LOGUP_NONCE", got.logup_nonce, 2)  # tau, beta
    t.absorb(b"V2_LOGUP_SUM")
    t.ext(got.logup_sum)
    if got.lv_tables:
        lv = chal(b"LV_CHAL", got.lv_nonce, 2)  # tau, gamma
        for tab in got.lv_tables:
            t.absorb(b"LV_G")
            for x in tab["g_sums"]:
                t.ext(x)
        t.absorb(b"LV_H")
        for x in got.lv_side["h_sums"]:
            t.ext(x)
    rcc = chal(b"RC_CHAL", rc["nonce"], 3)  # tau_m, tau_r, gamma
    t.absorb(b"RC_G")
    for x in rc["g_sums"]:
        t.ext(x)
    t.absorb(b"RC_H")
    t.ext(rc["h_sum"])
    mcc = chal(b"MC_CHAL", mc["nonce"], 3)  # tau_m, tau_r, gamma
    t.absorb(b"MC_G")
    for x in mc["g_sums"]:
        t.ext(x)
    t.absorb(b"MC_H")
    t.ext(mc["h_sum"])
    bcc = chal(b"BC_CHAL", bc["nonce"], 11)  # tau, gamma, tau_c, beta_c, tau_o, beta_o, tau_l, delta, tau_r, ...
    t.absorb(b"BC_G")
    for x in [bc["g"], bc["gc1"], bc["gc2"], bc["gout"], bc["glk"]] + bc["gr"] + bc["gm"] + [bc["gb1"], bc["gb2"]]:
        t.ext(x)
    for label, x in ((b"BC_H", bc["h"]), (b"BC_HR", bc["hr"]), (b"BC_WLNK", bc["wg"])):
        t.absorb(label)
        t.ext(x)
    for link in bc["links"]:
        t.absorb(b"LK_G")
        t.u64(link["id"])
        t.ext(link["g_sum"])
    t.absorb(b"V2_ADVICE")
    t.absorb(got.advice_root)

    # In proving order, each with its constraints where the reference states them.
    side = got.lv_side
    names = {name for _, name, _ in got.batch["evals"]}
    zcs = [(got.core, _core(ex.steps, *core))]
    for tab in got.lv_tables:
        prefix = f"lv:t{tab['id']}:"
        zcs.append((tab["zc"], _validity(tab["id"], sorted(n[len(prefix):] for n in names if n.startswith(prefix)), lv[0])))
    zcs += [(side["zc"], _table_side(lv[0]) if side["names"] == ["RANGE16"] else None)] if side else []

    def trace_columns(ns):  # an argument's columns but its table side's, in sorted order
        return sorted(n[3:] for n in names if n.startswith(ns + ":") and n[3:] not in ("m", "h#0", "h#1", "h#2", "h#3"))

    zcs += [(rc["zc"], _regcheck(trace_columns("rc"), ex.steps, rcc)), (rc["zc_table"], _table_side(rcc[1])),
            (mc["zc"], _memcheck(trace_columns("mc"), mc["accesses"], mcc)), (mc["zc_table"], _table_side(mcc[1]))]
    zcs += [(bc["zcs"][0], bytecode.step(_step_names(names), ex.steps, ex.entry_pc, ex.final_pc, bcc)),
            (bc["zcs"][1], bytecode.program(exp.program_table, bcc[0], bcc[1])), (bc["zcs"][2], _table_side(bcc[8]))]
    for link in bc["links"]:  # the query links, over the validity table's columns and g_lk
        cols = [n.split(":")[-1] for n in names if n.startswith(f"lv:t{link['id']}:") and "#" not in n]
        link_names = sorted(cols + [f"g_lk#{k}" for k in COORDS])
        zcs.append((link["zc"], _query_link(link["id"], link["queries"], link_names, bcc[6], bcc[7])))
    zcs += [(bc["zcs"][3], _memory_link(mc["accesses"], bcc[9], bcc[10]))]
    out["zerochecks"] = sum(_zerocheck(t, zc, combine) for zc, combine in zcs)

    # The logUp grand sums: each multiset's two sides.
    lv_g = [x for tab in got.lv_tables for x in tab["g_sums"]]
    equations = [(ext4.esum(lv_g), ext4.esum(got.lv_side["h_sums"]) if got.lv_side else ext4.ZERO),
                 (ext4.esum(rc["g_sums"][6:]), rc["h_sum"]), (ext4.esum(mc["g_sums"][2:]), mc["h_sum"]),
                 (bc["g"], bc["h"]), (bc["gc1"], bc["gc2"]), (bc["gb1"], bc["gb2"]),
                 (ext4.esum(bc["gr"]), bc["hr"]), (ext4.esum(bc["gm"]), bc["wg"]),
                 (ext4.esum(link["g_sum"] for link in bc["links"]), bc["glk"])]
    # The boundaries, from the reference's own run: the register file starts
    # at zero and ends at the public final registers (at the proof's final
    # timestamps), memory starts as the loaded image, the output tape is
    # the public outputs.
    equations += [_register_boundary(rcc, rc, ex), _memory_boundary(mcc, mc, exp), _output_tape(bcc, bc, ex)]
    out["logup_sums"] = sum(a != b for a, b in equations)

    out["batch_eval"] = _batch(t, got)

    batch = got.batch
    for kind, key, op, root in ((0, "data", got.data_open, got.data_root), (1, "advice", got.advice_open,
                                                                            got.advice_root)):
        evals = {name: x for k, name, x in batch["evals"] if k == kind}
        col_vars = {name: column_vars(name, got) for name in evals}
        out[f"{key}_root"], faults, positions = _ligero(t, op, root, col_vars, evals, batch["point"], config)
        out["openings"] += faults

    records, out["lasso"] = _lasso_bytes(exp, t, got.lasso)
    covered = sorted((tab.table_id, tab.lookups) for tab in exp.tables if tab.table_id in v2wire.GADGETS)
    for listed in (got.lv_tables, bc["links"]):
        out["lasso"] += len(set(covered) ^ {(x["id"], x["queries"]) for x in listed})
    extras = {tid: (claimed, commit) for tid, claimed, commit in got.extras}
    out["lasso"] += sum(extras.get(tab.table_id) != (tab.claimed, tab.commitment) for tab in exp.tables)
    out["lasso"] += len(set(extras) - {tab.table_id for tab in exp.tables})
    witness, points, values, siblings = _witness_bytes(exp, t, [o.root for o in got.openings],
                                                       [o.value for o in got.openings])
    out["witness_roots"] = sum(o.root != r for o, r in zip(got.openings, exp.roots))
    v = exp.num_vars
    for i, o in enumerate(got.openings):
        idx = int(points[i, 0]) % (1 << v) if v else 0
        ok = o.point == [int(x) for x in points[i]] and o.index == idx and o.leaf == int(exp.matrix[i, idx])
        ok = ok and o.value == o.proof_value == int(values[i]) and o.siblings == siblings[i].tobytes()
        out["witness_openings"] += not (ok and o.directions == bytes((idx >> k) & 1 for k in range(v)))
    return records, witness, positions


def _step_names(names) -> List[str]:
    """The bytecode step zerocheck's evaluations in their order: the
    argument's own columns but its table sides' and links', and the
    register check's and core argument's columns it reads, as ref_<name>."""
    tables = ("m_prog", "h_prog", "m_r16", "h_r16", "g_lnk")
    own = [n[3:] for n in names if n.startswith("bc:") and n[3:].split("#")[0] not in tables
           and not n[3:].startswith("lk")]
    return sorted(own + [f"ref_{x}" for x in REG_REFS + PC_REFS])


def claims(got: v2wire.Parsed) -> Optional[List[tuple]]:
    """Every claim the batch evaluation folds, in the order the arguments
    make them: (column, variables, point or None for a hypercube sum,
    value). A zerocheck claims each of its terminal evaluations at its
    point, the evaluations named in sorted order after the columns they
    evaluate; a logUp inverse column's sum is claimed a coordinate at a
    time. None where a zerocheck's evaluations do not fit its columns."""
    names = {name for _, name, _ in got.batch["evals"]}
    out: List[tuple] = []

    def local(ns: str, keep=lambda x: True):
        return sorted(n[len(ns) + 1:] for n in names if n.startswith(ns + ":") and keep(n[len(ns) + 1:]))

    def evals(zc, pairs):  # pairs: sorted local names -> columns
        if len(pairs) != len(zc.evals):
            raise KeyError(f"{len(zc.evals)} evaluations for {len(pairs)} columns")
        out.extend((col, column_vars(col, got), zc.point, x) for col, x in zip(pairs, zc.evals))

    def sums(col_of, values):
        for g, x in values:
            out.extend((col_of(g, e), column_vars(col_of(g, e), got), None, ext4.lift(x[e])) for e in COORDS)

    def own(ns, locals_):
        return [f"{ns}:{x}" for x in locals_]

    def side(x):
        return x in ("m", "h#0", "h#1", "h#2", "h#3")

    try:
        evals(got.core, own("v2", local("v2")))
        sums(lambda g, e: f"v2:{g}#{e}", [("g1", got.logup_sum), ("g2", got.logup_sum)])
        for tab in got.lv_tables:
            ns = f"lv:t{tab['id']}"
            evals(tab["zc"], own(ns, local(ns)))
            gs = sorted({x.split("#")[0] for x in local(ns, lambda x: "#" in x)})
            sums(lambda g, e, ns=ns: f"{ns}:{g}#{e}", zip(gs, tab["g_sums"]))
        if got.lv_side:
            subs = got.lv_side["names"]
            evals(got.lv_side["zc"], own("lv", sorted([f"m_{x}" for x in subs] + [f"h_{x}#{e}" for x in subs for e in COORDS])))
            sums(lambda g, e: f"lv:h_{g}#{e}", zip(subs, got.lv_side["h_sums"]))
        for ns, arg in (("rc", got.rc), ("mc", got.mc)):
            evals(arg["zc"], own(ns, local(ns, lambda x: not side(x))))
            evals(arg["zc_table"], own(ns, local(ns, side)))
            gs = sorted({x.split("#")[0] for x in local(ns, lambda x: "#" in x and not side(x))})
            sums(lambda g, e, ns=ns: f"{ns}:{g}#{e}", list(zip(gs, arg["g_sums"])) + [("h", arg["h_sum"])])
        bc = got.bc
        evals(bc["zcs"][0], [f"rc:{x[4:]}" if x[4:] in REG_REFS else f"v2:{x[4:]}" if x.startswith("ref_")
                             else f"bc:{x}" for x in _step_names(names)])
        sums(lambda g, e: f"bc:{g}#{e}", [(g, bc[w] if isinstance(w, str) else bc[w[0]][w[1]])
                                          for g, w in sorted(BC_SUMS.items())])
        for zc, tab, h in ((bc["zcs"][1], "prog", bc["h"]), (bc["zcs"][2], "r16", bc["hr"])):
            evals(zc, [f"bc:h_{tab}#{e}" for e in COORDS] + [f"bc:m_{tab}"])
            sums(lambda g, e: f"bc:{g}#{e}", [(f"h_{tab}", h)])
        for link in bc["links"]:
            cols = [f"lv:t{link['id']}:{x}" for x in local(f"lv:t{link['id']}", lambda x: "#" not in x)]
            pairs = sorted([(c.split(":")[-1], c) for c in cols] + [(f"g_lk#{e}", f"bc:lk{link['id']}:g_lk#{e}")
                                                                     for e in COORDS])
            evals(link["zc"], [c for _, c in pairs])
            sums(lambda g, e, t=link["id"]: f"bc:lk{t}:g_lk#{e}", [("g_lk", link["g_sum"])])
        pairs = sorted([(f"ref_{x}", f"mc:{x}") for x in MEM_REFS] + [(f"g_lnk#{e}", f"bc:g_lnk#{e}") for e in COORDS])
        evals(bc["zcs"][3], [c for _, c in pairs])
        sums(lambda g, e: f"bc:g_lnk#{e}", [("g_lnk", bc["wg"])])
    except (KeyError, StopIteration):
        return None
    return out


def _batch(t: Transcript, got: v2wire.Parsed) -> int:
    """Replay the batch evaluation: its rounds from the combination of every
    claim to the sum of each claim's weight at the point times the column's
    evaluation there; one count a fault."""
    batch, listed = got.batch, claims(got)
    delta = t.challenge_ext()  # the claims' combination
    column = {name: x for _, name, x in batch["evals"]}
    bad = int(listed is None or {c[0] for c in listed} != set(column))
    listed = [] if bad else listed
    claim, dpow = ext4.ZERO, ext4.lift(1)
    powers = []
    for _, _, _, value in listed:
        powers.append(dpow)
        claim = ext4.add(claim, ext4.mul(dpow, value))
        dpow = ext4.mul(dpow, delta)
    v_max = batch["num_vars"]
    bad += v_max != max([c[1] for c in listed], default=v_max)
    rs = []
    for j, g in enumerate(batch["rounds"]):
        bad += bool(listed) and ext4.add(g[0], g[1]) != claim
        for x in g:
            t.ext(x)
        rs.append(t.challenge_ext())
        bad += rs[-1] != batch["point"][j]
        claim = ext4.interpolate(g, rs[-1])
    for _, _, x in batch["evals"]:
        t.ext(x)
    terminal, weights = ext4.ZERO, {}
    for (name, v, point, _), dp in zip(listed, powers):
        key = (v, None if point is None else tuple(point))
        if key not in weights:  # the zero-padded weight of the claim's group
            w = ext4.lift(1)
            for r in rs[:v_max - v]:
                w = ext4.mul(w, ext4.mul(ext4.sub(ext4.lift(1), r), ext4.sub(ext4.lift(1), r)))
            weights[key] = w if point is None else ext4.mul(w, ext4.eq(point, rs[v_max - v:]))
        terminal = ext4.add(terminal, ext4.mul(dp, ext4.mul(weights[key], column[name])))
    return bad + int(bool(listed) and terminal != claim)


def _diff(a: bytes, b: bytes) -> int:
    size = min(len(a), len(b))
    return int((np.frombuffer(a[:size], np.uint8) != np.frombuffer(b[:size], np.uint8)).sum()) + abs(len(a) - len(b))


def compare(data: bytes, exp: Expected, program: bytes, config: dict, device) -> Dict[str, int]:
    """The counts for one proof's bytes against the reference's `exp`."""
    out = {name: 0 for name in NAMES}
    head = _head(program, exp)

    def unreadable(exc):
        out.update({name: 1 for name in NAMES})
        out.update(witness_roots=COLUMNS, witness_openings=COLUMNS)
        out["proof_bytes"] = _diff(data[:len(head)], head) + max(len(data) - len(head), 1)
        out["unreadable"] = repr(exc)
        return out

    try:
        got = v2wire.parse(data)
    except (v2wire.ParseError, ValueError, UnicodeDecodeError) as exc:
        return unreadable(exc)
    ex, v = exp.execution, exp.num_vars
    want = dict(version=VERSION, modulus=P, steps=ex.steps, num_vars=v, io_steps=ex.steps,
                program_hash=hashlib.sha256(program).digest(), initial_pc=ex.entry_pc, final_pc=ex.final_pc,
                initial_regs=[])
    out["execution"] = sum(getattr(got, k) != w for k, w in want.items())
    out["execution"] += sum(a != b for a, b in zip(got.final_regs, ex.final_regs)) + abs(len(got.final_regs) - 32)
    out["execution"] += sum(a != b for a, b in zip(got.outputs, ex.outputs)) + abs(len(got.outputs) - len(ex.outputs))
    if got.num_vars != v:
        out.update(witness_openings=COLUMNS, lasso=len(exp.tables) or 1)
        out["witness_roots"] = sum(o.root != r for o, r in zip(got.openings, exp.roots))
        out["proof_bytes"] = _diff(data, head)
        return out
    try:
        records, witness, positions = _replay(got, exp, program, config, out)
    except (KeyError, IndexError, TypeError, ValueError, StopIteration) as exc:  # sections that contradict each other
        return unreadable(exc)
    _COMPARED.pop(exp.key, None)
    _COMPARED[exp.key] = (data, positions)
    while len(_COMPARED) > _KEEP:
        del _COMPARED[next(iter(_COMPARED))]
    spans = got.sections
    emitted = ((spans["head"], head), (spans["lasso"], records), (spans["witness"], witness),
               (spans["extras"], _extras_bytes(exp)))
    out["proof_bytes"] = sum(_diff(data[lo:hi], mine) for (lo, hi), mine in emitted) + len(data) - got.end
    return out
