"""Protocol v2's bytecode argument, restated plainly: the program table the
verifier decodes from the initial image, and the constraints of the
argument's step and program zerochecks.

The program table has one row for every address a of the initial image
(each loaded segment from 3 bytes before its start to its end; bytes no
segment holds read 0) whose little-endian word w = image[a..a+4) has a
nonzero opcode field, in ascending order of address. A row holds a's
decode slots (`SLOTS`): the pc, the two read cells, the written cell,
funct3, the lookup table's id + 1, the sequential flag, the immediate's
four 16-bit limbs (its sign-extended value as a u64), the class flags and
the per-funct3 load and store flags, and the pc's two low 16-bit limbs.
Its key is sum_i gamma^(i+1) slot_i; the rows past the table are 0.

A step's slots are the same tuple read from its committed columns (the
pc, read cells, the register check's values and the core argument's pc
chain from theirs): the step zerocheck's first constraint puts each
step's key among the table's, and the program zerocheck holds the
committed multiplicities to h (tau - key) = m on the table's domain.
The other 81 constraints of the step zerocheck are the execution's
semantics over those columns (`step`); the zerocheck draws 93
combination challenges and uses the first 82.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from . import ext4, lasso, rv64
from .ext4 import P

SLOTS = ("pc", "a1", "a2", "wrs", "f3", "tbl1", "seqb", "imm_0", "imm_1", "imm_2", "imm_3", "fsys", "fecall", "fimm",
         "frs2", "fwr", "fbr", "fjal", "fjalr", "fneg", "flk", "pcl0", "pcl1", "febrk", "flui", "faui", "fnz", "fload",
         "fstore", "flb", "flbu", "flh", "flhu", "flw", "flwu", "fld", "fsb", "fsh", "fsw", "fsd", "falucls")
LOADS = {"flb": 0, "flh": 1, "flw": 2, "fld": 3, "flbu": 4, "flhu": 5, "flwu": 6}  # flag: funct3
STORES = {"fsb": 0, "fsh": 1, "fsw": 2, "fsd": 3}
LOAD_FP, STORE_FP = 0x07, 0x27
WRITES_RD = (rv64.OP, rv64.OP_32, rv64.OP_IMM, rv64.OP_IMM_32, rv64.LOAD, rv64.LUI, rv64.AUIPC, rv64.JAL, rv64.JALR)
JUMPS = (rv64.BRANCH, rv64.JAL, rv64.JALR, rv64.SYSTEM)  # the steps whose next pc is not pc + 4
NO_GADGET = (-1, lasso.LOAD_T, lasso.STORE_T)  # every other table has a validity gadget
RANGED = [("jt_0", 1), ("jt_1", 1), ("jt_2", 1), ("jt_3", 1), ("jh", 2)] + [(f"vb_{k}", 256) for k in range(8)] + [
    ("vhi0", 256), ("rl", 512)]  # each value times its coefficient lies in [0, 2^16)


def _imm(word: int) -> int:
    """The immediate of the word's format as a u64: I (loads, OP-IMM,
    JALR, fences, SYSTEM), S (stores), B, U, J; 0 for any other opcode."""
    op = word & 0x7F
    if op in (LOAD_FP, STORE_FP):  # the floating-point load and store share the I and S formats
        op = rv64.LOAD if op == LOAD_FP else rv64.STORE
    return rv64.decode((word & ~0x7F) | op)[6] & rv64.M64


def decode(addr: int, word: int) -> Dict[str, int]:
    """One program row's slots."""
    op, rd, f3, rs1, rs2, f7, _ = rv64.decode(word)
    imm = _imm(word)
    tid = int(lasso.table_ids(np.array([op]), np.array([f3]), np.array([f7]))[0])
    sys_, flk = op == rv64.SYSTEM, tid not in NO_GADGET
    row = dict(pc=addr % P, a1=17 if sys_ else rs1, a2=10 if sys_ else rs2, wrs=rd if op in WRITES_RD else 0, f3=f3,
               tbl1=tid + 1, seqb=op not in JUMPS, fsys=sys_, fecall=sys_ and imm == 0 and f3 == 0,
               fimm=op in (rv64.OP_IMM, rv64.OP_IMM_32) and flk, frs2=(op in (rv64.OP, rv64.OP_32) and flk)
               or op == rv64.BRANCH, fwr=flk and tid != lasso.BRANCH_T and rd != 0, fbr=op == rv64.BRANCH,
               fjal=op == rv64.JAL, fjalr=op == rv64.JALR, fneg=imm >> 63, flk=flk, pcl0=addr & 0xFFFF,
               pcl1=(addr >> 16) & 0xFFFF, febrk=sys_ and imm == 1 and f3 == 0, flui=op == rv64.LUI,
               faui=op == rv64.AUIPC, fnz=rd != 0, fload=op == rv64.LOAD, fstore=op == rv64.STORE,
               falucls=op in (rv64.OP, rv64.OP_32, rv64.OP_IMM, rv64.OP_IMM_32))
    row.update({f"imm_{k}": (imm >> (16 * k)) & 0xFFFF for k in range(4)})
    row.update({flag: op == rv64.LOAD and f3 == c for flag, c in LOADS.items()})
    row.update({flag: op == rv64.STORE and f3 == c for flag, c in STORES.items()})
    return {k: int(v) for k, v in row.items()}


def table(segments) -> Dict[str, np.ndarray]:
    """The program table's slot columns, padded to its domain (2^v >= the
    rows, v >= 1), from the loaded segments [(address, bytes)]."""
    image: Dict[int, int] = {}
    for base, data in segments:
        image.update({base + i: b for i, b in enumerate(data)})
    candidates = sorted({a for base, data in segments for a in range(max(base - 3, 0), base + len(data))})
    rows = []
    for a in candidates:
        word = sum(image.get(a + k, 0) << (8 * k) for k in range(4))
        if word & 0x7F:
            rows.append(decode(a, word))
    v = max(1, (max(len(rows), 1) - 1).bit_length())
    cols = {s: np.zeros(1 << v, dtype=np.uint64) for s in SLOTS}
    for i, row in enumerate(rows):
        for s in SLOTS:
            cols[s][i] = row[s]
    return cols


def program(cols: Dict[str, np.ndarray], tau, gamma):
    """The program zerocheck over h#0..h#3 and m: alpha (h (tau - key) -
    m) = 0, key the multilinear extension of the table's keys at the
    point."""
    g = ext4.powers(gamma, len(SLOTS) + 1)[1:]
    v = cols["pc"].shape[0].bit_length() - 1

    def combine(evals, rs, alphas):
        if len(rs) != v:
            raise KeyError(f"a program zerocheck of {len(rs)} variables over a table of {v}")
        eq = ext4.eq_table(rs)
        key = ext4.ZERO
        for gi, s in zip(g, SLOTS):
            at = tuple(int(x) for x in (eq * (cols[s] % np.uint64(P)) % np.uint64(P)).sum(axis=1) % np.uint64(P))
            key = ext4.add(key, ext4.mul(gi, at))
        h = ext4.from_coords(evals[:4])
        return ext4.combination([ext4.sub(ext4.mul(h, ext4.sub(tau, key)), evals[4])], alphas)
    return combine


def step(names: List[str], steps: int, entry_pc: int, final_pc: int, chal):
    """The step zerocheck's 82 constraints over its terminal evaluations
    (`names` in their order: the argument's columns, the coordinates of
    its inverse columns and ref_<column> of the register check's and the
    core argument's), with the argument's challenges tau, gamma (the
    fetch), tau_c, beta_c (the counters' chains), tau_o, beta_o (the
    output tape), tau_l, delta (the query link), tau_r (its range
    checks), tau_w, eps (the memory link)."""
    tau, gamma, tau_c, beta_c, tau_o, beta_o, tau_l, delta, tau_r, tau_w, eps = chal
    gp = ext4.powers(gamma, len(SLOTS) + 1)[1:]
    ob = ext4.powers(beta_o, 6)[1:]
    dl = ext4.powers(delta, 14)[1:]
    ep = ext4.powers(eps, 9)[1:]
    lim = [1 << (16 * k) for k in range(4)]

    def combine(evals, rs, alphas):
        e = dict(zip(names, evals))
        if len(e) != len(evals):
            raise KeyError("the step zerocheck's names and evaluations differ in number")

        def c(name):  # a committed column, or the register check's or core argument's
            return e[name] if name in e else e[f"ref_{name}"]

        def g(name):
            return ext4.from_coords([e[f"{name}#{k}"] for k in range(4)])

        one, zero = ext4.lift(1), ext4.ZERO

        def neg(x):
            return ext4.sub(one, x)

        def mul(*xs):
            acc = one
            for x in xs:
                acc = ext4.mul(acc, x)
            return acc

        def add(*xs):
            return ext4.esum(xs)

        def sub(a, *bs):
            return ext4.sub(a, ext4.esum(bs))

        def k(x):
            return ext4.lift(x)

        idx = ext4.index_mle(rs)
        eq0 = ext4.eq([zero] * len(rs), rs)
        sel, sel1 = ext4.le_mle(steps - 1, rs), ext4.le_mle(steps - 2, rs)
        sel2 = ext4.sub(sel, eq0)
        rv1 = ext4.lin(lim, [c(f"rv1_{j}") for j in range(4)])
        terms = []

        # Fetch: the step's slots are a row of the program table.
        kappa = ext4.lin(gp, [c(s) for s in SLOTS])
        terms.append(sub(mul(g("g_bc"), sub(tau, kappa)), sel))
        terms.append(mul(eq0, sub(c("pc"), k(entry_pc))))
        # System calls: a read (a7 = 2) writes a0, a commit (a7 = 1) emits a0.
        terms.append(sub(c("a3"), mul(neg(c("fsys")), c("wrs")), mul(k(10), c("fsys"), c("c_read"))))
        terms += [mul(c("c_read"), neg(c("c_read"))), mul(c("c_commit"), neg(c("c_commit")))]
        terms += [mul(c("c_read"), sub(rv1, k(2))), mul(c("c_commit"), sub(rv1, one))]
        terms += [mul(neg(c("fecall")), c("c_read")), mul(neg(c("fecall")), c("c_commit"))]
        terms.append(mul(c("fecall"), add(sub(c("c_read"), one), mul(sub(rv1, k(2)), c("inv_r")))))
        terms.append(mul(c("fecall"), add(sub(c("c_commit"), one), mul(sub(rv1, one), c("inv_c")))))
        terms += [mul(neg(sel), c("c_read")), mul(neg(sel), c("c_commit"))]
        # The commit counter: 0 at the start, +1 a commit; the output tape's keys.
        terms.append(sub(mul(g("g_c1"), sub(tau_c, mul(beta_c, add(idx, one)), c("cnt"), c("c_commit"))), sel1))
        terms.append(sub(mul(g("g_c2"), sub(tau_c, mul(beta_c, idx), c("cnt"))), sel2))
        terms.append(mul(eq0, c("cnt")))
        key_out = ext4.lin(ob, [c("cnt")] + [c(f"rv2_{j}") for j in range(4)])
        terms.append(sub(mul(g("g_out"), sub(tau_o, key_out)), c("c_commit")))
        # The step's lookup: its table, operands and result, as the query link fingerprints them.
        falu = sub(c("flk"), c("fbr"))
        in1 = [add(mul(c("fimm"), c(f"imm_{j}")), mul(c("frs2"), c(f"rv2_{j}"))) for j in range(4)]
        out = [add(mul(falu, c("res_0")), mul(c("fbr"), c("f3"))), add(mul(falu, c("res_1")), mul(c("fbr"), c("taken_b"))),
               mul(falu, c("res_2")), mul(falu, c("res_3"))]
        key_lk = ext4.lin(dl, [c("tbl1")] + [c(f"rv1_{j}") for j in range(4)] + in1 + out)
        terms.append(sub(mul(g("g_lk_s"), sub(tau_l, key_lk)), c("flk")))
        terms += [mul(c("fwr"), sub(c(f"res_{j}"), c(f"wv_{j}"))) for j in range(4)]
        # Control flow.
        simm = sub(ext4.lin(lim, [c(f"imm_{j}") for j in range(4)]), mul(k((1 << 64) % P), c("fneg")))
        dnp = sub(c("next_pc"), c("pc"))
        link = mul(add(c("fjal"), c("fjalr")), c("fnz"))  # a jump that writes its link register
        taken = c("taken_b")
        terms += [mul(c("fsys"), sub(one, c("fecall"), c("febrk"))), mul(c("febrk"), dnp),
                  mul(c("fecall"), sub(dnp, k(4))), sub(c("seq"), c("seqb")),
                  mul(c("fbr"), sub(dnp, mul(simm, taken), mul(k(4), neg(taken)))), mul(c("fjal"), sub(dnp, simm)),
                  mul(link, add(sub(c("wv_0"), c("pcl0"), k(4)), mul(k(1 << 16), c("pc4c")))),
                  mul(link, sub(c("wv_1"), c("pcl1"), c("pc4c"))), mul(link, c("wv_2")), mul(link, c("wv_3")),
                  mul(c("pc4c"), neg(c("pc4c")))]
        terms += [mul(c("flui"), c("fnz"), sub(c(f"wv_{j}"), c(f"imm_{j}"))) for j in range(4)]
        # The adder jt = x + imm mod 2^64: x the pc (AUIPC) or rs1 (JALR, loads, stores).
        rvsel = add(c("fjalr"), c("fload"), c("fstore"))
        gate = add(c("faui"), rvsel)
        xs = [add(mul(c("faui"), c("pcl0")), mul(rvsel, c("rv1_0"))),
              add(mul(c("faui"), c("pcl1")), mul(rvsel, c("rv1_1"))), mul(rvsel, c("rv1_2")), mul(rvsel, c("rv1_3"))]
        for j in range(4):
            carry = c(f"jc_{j - 1}") if j else zero
            terms.append(mul(gate, sub(add(xs[j], c(f"imm_{j}"), carry), c(f"jt_{j}"), mul(k(1 << 16), c(f"jc_{j}")))))
        terms += [mul(c(f"jc_{j}"), neg(c(f"jc_{j}"))) for j in range(4)]
        terms += [mul(c("faui"), c("fnz"), sub(c(f"jt_{j}"), c(f"wv_{j}"))) for j in range(4)]
        terms.append(mul(c("fjalr"), sub(c("jt_0"), mul(k(2), c("jh")), c("jlsb"))))
        terms.append(mul(c("jlsb"), neg(c("jlsb"))))
        target = ext4.lin([2, 1 << 16, 1 << 32, 1 << 48], [c("jh"), c("jt_1"), c("jt_2"), c("jt_3")])
        terms.append(mul(c("fjalr"), sub(c("next_pc"), target)))
        # Range checks, two values a merged inverse column.
        for i in range(0, len(RANGED), 2):
            ds = [sub(tau_r, mul(k(coef), c(name))) for name, coef in RANGED[i:i + 2]]
            terms.append(ext4.fraction(ds, g(f"grp{i // 2}")))
        # The memory link: byte j of an access of at least j + 1 bytes.
        flags = {f: c(f) for f in list(LOADS) + list(STORES)}
        s1 = ext4.esum(flags.values())
        s2 = ext4.esum(flags[f] for f in ("flh", "flhu", "flw", "flwu", "fld", "fsh", "fsw", "fsd"))
        s4 = ext4.esum(flags[f] for f in ("flw", "flwu", "fld", "fsw", "fsd"))
        s8 = add(flags["fld"], flags["fsd"])
        sels = [s1, s2, s4, s4, s8, s8, s8, s8]
        base = ext4.lin(ep[:5] + [ep[7]], [c("bcnt")] + [c(f"jt_{j}") for j in range(4)] + [c("fstore")])
        ds = [sub(tau_w, add(base, mul(k(j), add(ep[0], ep[5])), mul(ep[6], c(f"vb_{j}")))) for j in range(8)]
        for i in range(4):
            terms.append(ext4.fraction(ds[2 * i:2 * i + 2], g(f"gmp{i}"), sels[2 * i:2 * i + 2]))
        nb = ext4.esum(sels)
        terms.append(sub(mul(g("g_b1"), sub(tau_c, mul(beta_c, add(idx, one)), c("bcnt"), nb)), sel1))
        terms.append(sub(mul(g("g_b2"), sub(tau_c, mul(beta_c, idx), c("bcnt"))), sel2))
        terms.append(mul(eq0, c("bcnt")))
        # Stores: the bytes are rs2's.
        pairs = [add(c(f"vb_{2 * j}"), mul(k(256), c(f"vb_{2 * j + 1}"))) for j in range(4)]
        terms.append(mul(c("fsb"), sub(add(c("vb_0"), mul(k(256), c("vhi0"))), c("rv2_0"))))
        terms.append(mul(add(c("fsh"), c("fsw"), c("fsd")), sub(pairs[0], c("rv2_0"))))
        terms.append(mul(add(c("fsw"), c("fsd")), sub(pairs[1], c("rv2_1"))))
        terms += [mul(c("fsd"), sub(pairs[j], c(f"rv2_{j}"))) for j in (2, 3)]
        # Loads: the written value is the bytes, sign- or zero-extended.
        loads = ext4.esum(flags[f] for f in LOADS)
        fill = mul(k(0xFFFF), c("sgn"))
        signed = add(flags["flw"], flags["flh"], flags["flb"])
        wide = [add(flags["fld"], flags["flw"], flags["flwu"], flags["flh"], flags["flhu"]),
                add(flags["fld"], flags["flw"], flags["flwu"]), flags["fld"], flags["fld"]]
        ext = [add(mul(wide[0], pairs[0]), mul(flags["flb"], add(c("vb_0"), mul(k(0xFF00), c("sgn")))),
                   mul(flags["flbu"], c("vb_0"))),
               add(mul(wide[1], pairs[1]), mul(add(flags["flh"], flags["flb"]), fill)),
               add(mul(wide[2], pairs[2]), mul(signed, fill)), add(mul(wide[3], pairs[3]), mul(signed, fill))]
        terms += [mul(c("fnz"), sub(mul(loads, c(f"wv_{j}")), ext[j])) for j in range(4)]
        sign_byte = add(mul(flags["flb"], c("vb_0")), mul(flags["flh"], c("vb_1")), mul(flags["flw"], c("vb_3")))
        terms.append(sub(sign_byte, mul(signed, add(mul(k(128), c("sgn")), c("rl")))))
        terms.append(mul(c("sgn"), neg(c("sgn"))))
        # Every executed load, store and ALU word is a valid instruction of its class.
        terms += [mul(c("fload"), sub(loads, one)), mul(c("fstore"), sub(ext4.esum(flags[f] for f in STORES), one)),
                  mul(c("falucls"), neg(c("flk")))]
        # The last step's next pc is the public final pc.
        terms.append(mul(sub(sel, sel1), sub(c("next_pc"), k(final_pc))))
        return ext4.combination(terms, alphas)
    return combine
