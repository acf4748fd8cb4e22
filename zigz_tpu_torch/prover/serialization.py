"""Binary proof codec — "ZIGZ" v1 wire format, byte-exact.

Reference: zigz src/prover/serialization.zig.  Layout (all
little-endian; field elements are canonical u64 limbs):

  header   : "ZIGZ" | u32 version=1 | u64 modulus | u64 num_steps |
             u32 num_vars | u32 reserved=0                     (:175-182)
  public io: 32B sha256(program) | u64 initial_pc | u64 final_pc |
             u32 n + n×u64 initial regs | u32 n + n×u64 final regs |
             u64 num_steps | u32 n + n×u64 outputs             (:209-245)
  constraint proof: [num_vars][4]u64 coeffs | [num_vars]u64 point |
             u64 final_eval                                    (:296-311)
  lasso    : u32 count; per proof u32 table_id | u64 num_lookups |
             u32 num_vars | multiset proof (3 coeffs/round)    (:333-344)
  openings : per 43: 32B root | [num_vars]u64 point | u64 value |
             u64 proof.value | u64 index | u64 leaf value |
             u32 path_len | path_len×32B siblings | path_len×u8 dirs
                                                               (:374-429)
"""

from __future__ import annotations

import struct
from typing import List

from ..commitments.commit import OpeningProof
from ..commitments.merkle import MerklePath, OpeningProof as MerkleOpening
from ..utils import profiling
from ..utils.profiling import span
from .proof import (
    CompactLassoList,
    PipelineLassoProof,
    PipelineSumcheckProof,
    Proof,
    ProofMetadata,
    PublicIO,
)

__all__ = ["BinarySerializer", "SerializationError"]

MAGIC = b"ZIGZ"
CURRENT_VERSION = 1


class SerializationError(Exception):
    pass


class _Writer:
    """Accumulates proof bytes; with a `sink` (file-like object) the
    buffer is flushed in `chunk`-sized pieces instead of materializing
    the whole proof (ROADMAP: streaming serialization — the v1 wire
    format is O(num_steps) because of the per-instruction Lasso block,
    reference serialization.zig:333-344)."""

    def __init__(self, sink=None, chunk: int = 1 << 22):
        self.buf = bytearray()
        self.sink = sink
        self.chunk = chunk
        self.written = 0

    def _maybe_flush(self):
        if self.sink is not None and len(self.buf) >= self.chunk:
            self.written += len(self.buf)
            self.sink.write(self.buf)
            self.buf = bytearray()

    def finish(self) -> int:
        """Flush the tail; returns the total byte count."""
        if self.sink is not None and self.buf:
            self.written += len(self.buf)
            self.sink.write(self.buf)
            self.buf = bytearray()
        return self.written + len(self.buf)

    def bytes_(self, data: bytes):
        self.buf += data
        self._maybe_flush()

    def u8(self, v: int):
        self.buf += struct.pack("<B", v)
        self._maybe_flush()

    def u16(self, v: int):
        self.buf += struct.pack("<H", v)
        self._maybe_flush()

    def u32(self, v: int):
        self.buf += struct.pack("<I", v)
        self._maybe_flush()

    def u64(self, v: int):
        self.buf += struct.pack("<Q", v)
        self._maybe_flush()


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def bytes_(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise SerializationError("InvalidData")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return struct.unpack("<B", self.bytes_(1))[0]

    def u16(self) -> int:
        return struct.unpack("<H", self.bytes_(2))[0]

    def u32(self) -> int:
        return struct.unpack("<I", self.bytes_(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.bytes_(8))[0]


class BinarySerializer:
    """BinarySerializer(F) twin.  ``last_spans`` holds the spans of the last
    serialize (utils/profiling.py), under the prove id of the proof's
    ``Prover.prove`` (its ``prove_id``; None for a proof from elsewhere)."""

    def __init__(self, F):
        self.F = F
        self.last_spans = profiling.SpanLog(None)

    # -- serialize ---------------------------------------------------------
    def serialize(self, proof: Proof) -> bytes:
        w = _Writer()
        self._write_all(w, proof)
        return bytes(w.buf)

    def serialize_to(self, proof: Proof, fileobj) -> int:
        """Stream the proof to a binary file object in ~4 MB chunks;
        returns the byte count.  Byte-identical to serialize() without
        ever holding the full proof buffer (the 2^22-step v1 proof is
        ~100 MB of Lasso filler records)."""
        w = _Writer(sink=fileobj)
        self._write_all(w, proof)
        return w.finish()

    def _write_all(self, w: _Writer, proof: Proof) -> None:
        with profiling.root("serialize", getattr(proof, "prove_id", None)) as spans:
            self.last_spans = spans
            self._write_header(w, proof)
            self._write_public_io(w, proof.public_io)
            if proof.metadata.version < 2:
                # v2+ carries its extension-field zerocheck in the v2 section;
                # the v1 constraint rows would be dead zero bytes.
                self._write_sumcheck(w, proof.constraint_proof)
            with span("lasso"):
                self._write_lasso_proofs(w, proof.lookup_proofs)
            if proof.metadata.version < 4:
                # v4 has no per-column Merkle forest (Ligero witness PCS in
                # the v2 section replaces it).
                with span("commitments"):
                    self._write_witness_commitments(w, proof.witness_commitments)
            if proof.metadata.version >= 2:
                self._write_v2_section(w, proof.v2, proof.metadata.version)

    def _write_header(self, w: _Writer, proof: Proof) -> None:
        w.bytes_(MAGIC)
        w.u32(proof.metadata.version)
        w.u64(proof.metadata.field_modulus)
        w.u64(proof.metadata.num_steps)
        w.u32(proof.metadata.num_vars)
        w.u32(0)  # reserved

    def _write_public_io(self, w: _Writer, io: PublicIO) -> None:
        w.bytes_(io.program_hash)
        w.u64(io.initial_pc)
        w.u64(io.final_pc)
        if io.initial_regs:
            w.u32(len(io.initial_regs))
            for reg in io.initial_regs:
                w.u64(reg)
        else:
            w.u32(0)
        if io.final_regs:
            w.u32(len(io.final_regs))
            for reg in io.final_regs:
                w.u64(reg)
        else:
            w.u32(0)
        w.u64(io.num_steps)
        if io.outputs:
            w.u32(len(io.outputs))
            for val in io.outputs:
                w.u64(val)
        else:
            w.u32(0)

    def _write_sumcheck(self, w: _Writer, sc: PipelineSumcheckProof) -> None:
        for poly in sc.round_polynomials:
            for coeff in poly:
                w.u64(coeff.value)
        for coord in sc.final_point:
            w.u64(coord.value)
        w.u64(sc.final_eval.value)

    def _write_lasso_proofs(self, w: _Writer, proofs) -> None:
        w.u32(len(proofs))
        if isinstance(proofs, CompactLassoList):
            # Vectorized: each filler proof is u32 table_id | u64 1 | u32 0 |
            # u64 final_eval=0 (0 rounds, empty point) = 24 bytes.
            import numpy as np

            n = len(proofs)
            # Emit in bounded slices so a streaming writer never holds
            # more than one slice of the O(num_steps) filler block.
            step = 1 << 18
            for lo in range(0, n, step):
                hi = min(lo + step, n)
                rec = np.zeros(
                    hi - lo, dtype=[("id", "<u4"), ("nl", "<u8"), ("nv", "<u4"), ("fe", "<u8")]
                )
                rec["id"] = np.arange(lo, hi, dtype=np.uint32)
                rec["nl"] = 1
                w.bytes_(rec.tobytes())
            return
        for lasso in proofs:
            w.u32(lasso.table_id)
            w.u64(lasso.num_lookups)
            w.u32(lasso.multiset_proof.num_vars)
            self._write_sumcheck(w, lasso.multiset_proof)

    def _write_witness_commitments(self, w: _Writer, commitments) -> None:
        for c in commitments:
            w.bytes_(c.commitment)
            for coord in c.point:
                w.u64(coord.value)
            w.u64(c.value.value)
            self._write_merkle_proof(w, c.proof)

    def _write_merkle_proof(self, w: _Writer, proof: OpeningProof) -> None:
        w.u64(proof.value.value)
        w.u64(proof.merkle_proof.index)
        w.u64(proof.merkle_proof.value.value)
        w.u32(len(proof.merkle_proof.path.siblings))
        for sibling in proof.merkle_proof.path.siblings:
            w.bytes_(sibling)
        for d in proof.merkle_proof.path.directions:
            w.u8(1 if d else 0)


    # -- v2 extension section ----------------------------------------------
    # Round-3 layout (extension-field protocol): the constraint zerocheck
    # (ext kind) | lasso extras | 32B pcs root + ligero proof | logUp
    # nonce (u64) + ext sum (4 u64) + 32B root + ligero proof | validity |
    # regcheck | memcheck | bytecode | (v4) witness root + 43 ext evals +
    # ligero proof.  Extension values serialize as 4 LE u64 limbs c0..c3.
    _V2_COLUMNS = tuple(sorted(
        ("is_read", "next_pc", "pc", "seq", "x0")
        + tuple(f"g{i}#{e}" for i in (1, 2) for e in range(4))
    ))

    def _write_ext(self, w: _Writer, x) -> None:
        for limb in x.to_ints():
            w.u64(limb)

    def _read_ext(self, r: _Reader):
        from ..core.ext4 import Ext4

        limbs = [r.u64() for _ in range(4)]
        # Canonical encoding only: limbs must already be reduced.  Accepting
        # >= p values would let many distinct byte strings decode to the same
        # proof (malleability) — the reference serializer is strict-canonical
        # throughout (serialization.zig:100-131).
        if any(limb >= self.F.MODULUS for limb in limbs):
            raise SerializationError("InvalidData")
        return Ext4.from_ints(limbs)

    def _write_v2_section(self, w: _Writer, v2, version: int = 2) -> None:
        self._write_zerocheck(w, v2.zerocheck)
        # Real-Lasso metadata: u32 count; per table u32 id | u64 claimed
        # sum | 32B query commitment (ids ascending).
        extras = v2.lasso_extras or {}
        w.u32(len(extras))
        for table_id in sorted(extras):
            w.u32(table_id)
            w.u64(extras[table_id]["claimed_sum"] % self.F.MODULUS)
            w.bytes_(extras[table_id]["query_commitment"])
        # PC-chain logUp: nonce | shared ext sum (columns/openings live in
        # the unified commitment below).
        w.u64(v2.logup_nonce)
        self._write_ext(w, v2.logup_sum)
        self._write_lookup_validity(w, v2.lookup_validity)
        self._write_regcheck(w, v2.regcheck)
        self._write_memcheck(w, v2.memcheck)
        self._write_bytecode(w, v2.bytecode)
        if version >= 4:
            # v4 witness evals: 43 ext values (sorted witness poly names),
            # claimed at the zerocheck point and opened via the unified
            # data commitment.
            from ..constraints.witness import WITNESS_POLY_NAMES

            for name in sorted(WITNESS_POLY_NAMES):
                self._write_ext(w, v2.witness_evals[name])
        self._write_unified(w, v2.unified)

    # -- unified commitment proof (prover/unified.py) -----------------------
    # Layout: u8 flags (bit0 data_root, bit1 advice_root, bit2 batch,
    # bit3 data_open, bit4 advice_open) | roots (32B each, if present) |
    # batch: u32 num_vars | 3 ext evals per round | ext final point |
    # u32 eval count, per entry (sorted): u8 commitment kind (0=data,
    # 1=advice) | u16 name length + utf8 name | ext eval | the two ligero
    # proofs.  Names ride the wire but the batch-eval verifier requires
    # the key set to equal its own derived claim set, so they carry no
    # authority.

    def _write_unified(self, w: _Writer, up) -> None:
        flags = ((1 if up.data_root is not None else 0)
                 | (2 if up.advice_root is not None else 0)
                 | (4 if up.batch is not None else 0)
                 | (8 if up.data_open is not None else 0)
                 | (16 if up.advice_open is not None else 0))
        w.u8(flags)
        if up.data_root is not None:
            w.bytes_(up.data_root)
        if up.advice_root is not None:
            w.bytes_(up.advice_root)
        if up.batch is not None:
            b = up.batch
            w.u32(b.num_vars)
            for evals in b.round_evals:
                for e in evals:
                    self._write_ext(w, e)
            for r_ in b.final_point:
                self._write_ext(w, r_)
            w.u32(len(b.column_evals))
            for key in sorted(b.column_evals):
                ck, name = key
                w.u8(0 if ck == "data" else 1)
                data = name.encode()
                w.u16(len(data))
                w.bytes_(data)
                self._write_ext(w, b.column_evals[key])
        if up.data_open is not None:
            self._write_ligero_proof(w, up.data_open)
        if up.advice_open is not None:
            self._write_ligero_proof(w, up.advice_open)

    def _read_unified(self, r: _Reader):
        from ..proofs.batch_eval import BatchEvalProof
        from .unified import UnifiedProof

        flags = r.u8()
        data_root = r.bytes_(32) if flags & 1 else None
        advice_root = r.bytes_(32) if flags & 2 else None
        batch = None
        if flags & 4:
            num_vars = r.u32()
            if num_vars > 40:
                raise SerializationError("InvalidData")
            rounds = [[self._read_ext(r) for _ in range(3)]
                      for _ in range(num_vars)]
            point = [self._read_ext(r) for _ in range(num_vars)]
            count = r.u32()
            if count > (1 << 20):
                raise SerializationError("InvalidData")
            column_evals = {}
            for _ in range(count):
                ck = "data" if r.u8() == 0 else "advice"
                name = r.bytes_(r.u16()).decode()
                column_evals[(ck, name)] = self._read_ext(r)
            batch = BatchEvalProof(num_vars=num_vars, round_evals=rounds,
                                   final_point=point, column_evals=column_evals)
        data_open = self._read_ligero_proof(r) if flags & 8 else None
        advice_open = self._read_ligero_proof(r) if flags & 16 else None
        return UnifiedProof(data_root=data_root, advice_root=advice_root,
                            batch=batch, data_open=data_open,
                            advice_open=advice_open)

    # -- register memory check (constraints/regcheck.py) -------------------
    # Layout: u8 present and, if set: u64 nonce | u32 num_vars | 32 x u64
    # final_ts | zerocheck (trace domain) | zerocheck (RANGE16 domain) |
    # per sorted g name: ext sum | ext h_sum.  Column/eval names are fixed
    # by the module's COLUMNS/G_MEM/G_RNG specs, never read from the wire;
    # commitments/openings live in the unified section.

    def _write_regcheck(self, w: _Writer, rc) -> None:
        w.u8(1 if rc is not None else 0)
        if rc is None:
            return
        w.u64(rc.nonce)
        w.u32(rc.num_vars)
        for t in rc.final_ts:
            w.u64(t)
        self._write_zerocheck(w, rc.zc)
        self._write_zerocheck(w, rc.zc_table)
        for name in sorted(rc.g_sums):
            self._write_ext(w, rc.g_sums[name])
        self._write_ext(w, rc.h_sum)

    def _read_regcheck(self, r: _Reader):
        if not r.u8():
            return None
        from ..constraints.regcheck import (
            COLUMNS,
            G_MEM,
            G_RNG,
            RegCheckProof,
            g_coord_names,
        )

        nonce = r.u64()
        num_vars = r.u32()
        final_ts = [r.u64() for _ in range(32)]
        g_names = sorted(G_MEM + G_RNG)
        zc = self._read_zerocheck(r, list(COLUMNS) + g_coord_names(g_names))
        zc_table = self._read_zerocheck(r, ["m"] + g_coord_names(["h"]))
        g_sums = {name: self._read_ext(r) for name in g_names}
        h_sum = self._read_ext(r)
        return RegCheckProof(
            nonce=nonce, num_vars=num_vars, final_ts=final_ts,
            zc=zc, zc_table=zc_table, g_sums=g_sums, h_sum=h_sum,
        )

    # -- RAM byte memory check (constraints/memcheck.py) --------------------
    # Layout mirrors regcheck with a touched-address list in place of the
    # 32 final_ts slots.

    def _write_memcheck(self, w: _Writer, mc) -> None:
        w.u8(1 if mc is not None else 0)
        if mc is None:
            return
        w.u64(mc.nonce)
        w.u32(mc.num_vars)
        w.u64(mc.num_accesses)
        w.u32(len(mc.touched))
        for a, fv, fts in mc.touched:
            w.u64(a)
            w.u64(fv)
            w.u64(fts)
        self._write_zerocheck(w, mc.zc)
        self._write_zerocheck(w, mc.zc_table)
        for name in sorted(mc.g_sums):
            self._write_ext(w, mc.g_sums[name])
        self._write_ext(w, mc.h_sum)

    def _read_memcheck(self, r: _Reader):
        if not r.u8():
            return None
        from ..constraints.memcheck import COLUMNS, G_MEM, G_RNG, MemCheckProof
        from ..constraints.regcheck import g_coord_names

        nonce = r.u64()
        num_vars = r.u32()
        num_accesses = r.u64()
        touched = [(r.u64(), r.u64(), r.u64()) for _ in range(r.u32())]
        g_names = sorted(G_MEM + G_RNG)
        zc = self._read_zerocheck(r, list(COLUMNS) + g_coord_names(g_names))
        zc_table = self._read_zerocheck(r, ["m"] + g_coord_names(["h"]))
        g_sums = {name: self._read_ext(r) for name in g_names}
        h_sum = self._read_ext(r)
        return MemCheckProof(
            nonce=nonce, num_vars=num_vars, num_accesses=num_accesses,
            touched=touched, zc=zc, zc_table=zc_table,
            g_sums=g_sums, h_sum=h_sum,
        )

    # -- bytecode fetch/decode argument (constraints/bytecode.py) -----------
    # Layout: u8 present and, if set: u64 nonce | u32 num_vars | u32
    # table_vars | 4 zerochecks (step, program, RANGE16, memlink domains)
    # | sums (fetch, counter chain, tape, linkage, ranges, byte slots,
    # byte counters, wlnk — all ext) | u32 link count, per link: u32 id |
    # u64 num_queries | u32 num_vars | zerocheck | ext g_sum.  Names fixed
    # by module specs; commitments/openings live in the unified section.

    def _write_bytecode(self, w: _Writer, bc) -> None:
        w.u8(1 if bc is not None else 0)
        if bc is None:
            return
        from ..constraints.bytecode import GM_NAMES, GR_NAMES

        w.u64(bc.nonce)
        w.u32(bc.num_vars)
        w.u32(bc.table_vars)
        self._write_zerocheck(w, bc.zc)
        self._write_zerocheck(w, bc.zc_table)
        self._write_zerocheck(w, bc.zc_range)
        self._write_zerocheck(w, bc.zc_mem)
        self._write_ext(w, bc.g_sum)
        self._write_ext(w, bc.h_sum)
        self._write_ext(w, bc.gc1_sum)
        self._write_ext(w, bc.gc2_sum)
        self._write_ext(w, bc.gout_sum)
        for name in GR_NAMES:
            self._write_ext(w, bc.gr_sums[name])
        self._write_ext(w, bc.hr_sum)
        for s in bc.gm_sums:
            self._write_ext(w, s)
        self._write_ext(w, bc.gb1_sum)
        self._write_ext(w, bc.gb2_sum)
        self._write_ext(w, bc.wg_sum)
        self._write_ext(w, bc.glk_sum)
        links = bc.links or []
        w.u32(len(links))
        for ln in links:
            w.u32(ln.table_id)
            w.u64(ln.num_queries)
            w.u32(ln.num_vars)
            self._write_zerocheck(w, ln.zc)
            self._write_ext(w, ln.g_sum)

    def _read_bytecode(self, r: _Reader):
        if not r.u8():
            return None
        from ..constraints.bytecode import (
            _PCS_REFS,
            _REG_REFS,
            LINK_COLUMNS,
            GM_NAMES,
            GR_NAMES,
            BytecodeProof,
        )
        from ..constraints.regcheck import g_coord_names

        nonce = r.u64()
        num_vars = r.u32()
        table_vars = r.u32()
        bc_g_names = (["g_bc", "g_c1", "g_c2", "g_out", "g_lk_s",
                       "g_b1", "g_b2"]
                      + list(GM_NAMES) + list(GR_NAMES))
        zc_names = (list(LINK_COLUMNS)
                    + g_coord_names(bc_g_names)
                    + [f"ref_{n}" for n in _REG_REFS]
                    + [f"ref_{n}" for n in _PCS_REFS])
        zc = self._read_zerocheck(r, zc_names)
        zc_table = self._read_zerocheck(r, ["m"] + g_coord_names(["h"]))
        zc_range = self._read_zerocheck(r, ["m"] + g_coord_names(["h"]))
        wl_refs = ("ba0", "ba1", "ba2", "ba3", "bk", "vw", "st")
        zc_mem = self._read_zerocheck(
            r, g_coord_names(["g_lnk"]) + [f"ref_{n}" for n in wl_refs]
        )
        g_sum = self._read_ext(r)
        h_sum = self._read_ext(r)
        gc1_sum = self._read_ext(r)
        gc2_sum = self._read_ext(r)
        gout_sum = self._read_ext(r)
        gr_sums = {name: self._read_ext(r) for name in GR_NAMES}
        hr_sum = self._read_ext(r)
        gm_sums = [self._read_ext(r) for _ in GM_NAMES]
        gb1_sum = self._read_ext(r)
        gb2_sum = self._read_ext(r)
        wg_sum = self._read_ext(r)
        glk_sum = self._read_ext(r)
        from ..constraints.linkage import QueryLinkRecord
        from ..lookups.validity import GADGETS

        links = []
        for _ in range(r.u32()):
            tid = r.u32()
            if tid not in GADGETS:
                raise SerializationError(f"unknown link gadget table {tid}")
            nq = r.u64()
            v = r.u32()
            zc_lk = self._read_zerocheck(
                r, list(GADGETS[tid].columns) + g_coord_names(["g_lk"])
            )
            g_sum_lk = self._read_ext(r)
            links.append(QueryLinkRecord(
                table_id=tid, num_queries=nq, num_vars=v,
                zc=zc_lk, g_sum=g_sum_lk,
            ))
        return BytecodeProof(
            nonce=nonce, num_vars=num_vars, table_vars=table_vars,
            zc=zc, zc_table=zc_table, zc_range=zc_range, zc_mem=zc_mem,
            g_sum=g_sum, h_sum=h_sum,
            gc1_sum=gc1_sum, gc2_sum=gc2_sum, gout_sum=gout_sum,
            glk_sum=glk_sum, links=links,
            gr_sums=gr_sums, hr_sum=hr_sum,
            gm_sums=gm_sums, gb1_sum=gb1_sum, gb2_sum=gb2_sum,
            wg_sum=wg_sum,
        )

    @staticmethod
    def _write_ligero_proof(w: _Writer, pp) -> None:
        # All payload values are canonical BabyBear (< 2^31): u32 LE
        # storage halves the dominant proof-size term (opened columns).
        # u/w rows are extension-valued (4 coordinate rows each,
        # coordinate-major) since the Ligero batching/proximity challenges
        # moved to BabyBear^4.
        import numpy as np

        w.u32(len(pp.us[0]))
        w.u32(len(pp.us))
        for u in pp.us:
            w.bytes_(np.ascontiguousarray(u.c, dtype="<u4").tobytes())
        w.u32(len(pp.ws))
        for wr in pp.ws:
            w.bytes_(np.ascontiguousarray(wr.c, dtype="<u4").tobytes())
        t, rows = pp.columns.shape
        w.u32(t)
        w.u32(rows)
        w.bytes_(np.ascontiguousarray(pp.columns, dtype="<u4").tobytes())
        # Merkle MULTIPROOF (round 5): one deduplicated frontier-node list
        # for all t opened columns instead of t full paths.
        w.u32(len(pp.nodes))
        for node in pp.nodes:
            w.bytes_(node)

    # -- lookup validity (lookups/validity.py) -----------------------------
    # Layout: u64 nonce | u32 num_tables; per table (ids ascending):
    # u32 table_id | u64 num_queries | u32 num_vars | 32B root_cols |
    # 32B root_g | zerocheck | ligero cols_proof | ligero g_proof |
    # per sorted g name: u64 sum.  Then u8 has_table_side and, if set:
    # u32 num_subs + length-prefixed ascii names | 32B root_m | 32B root_h
    # | zerocheck | ligero m_proof | ligero h_proof | per name: u64 sum.
    # Zerocheck: u32 num_vars | u32 degree | rounds (num_vars x degree+1
    # u64) | point (num_vars u64) | evals in sorted-name order (names are
    # re-derived from the gadget/subtable specs, never trusted from the
    # wire).

    def _write_zerocheck(self, w: _Writer, zc) -> None:
        # Kind byte: 0 = base-field (round-2 arguments during the ongoing
        # extension migration), 1 = BabyBear^4 (4 limbs per value).
        from ..core.ext4 import Ext4

        p = self.F.MODULUS
        is_ext = bool(zc.final_point) and isinstance(zc.final_point[0], Ext4)
        if not zc.final_point and zc.column_evals:
            is_ext = isinstance(next(iter(zc.column_evals.values())), Ext4)
        w.u8(1 if is_ext else 0)
        w.u32(zc.num_vars)
        w.u32(zc.degree)
        if is_ext:
            for row in zc.round_evals:
                for g in row:
                    self._write_ext(w, g)
            for r_ in zc.final_point:
                self._write_ext(w, r_)
            for name in sorted(zc.column_evals):
                self._write_ext(w, zc.column_evals[name])
            return
        for row in zc.round_evals:
            for g in row:
                w.u64(g % p)
        for r_ in zc.final_point:
            w.u64(r_ % p)
        for name in sorted(zc.column_evals):
            w.u64(zc.column_evals[name] % p)

    def _read_zerocheck(self, r: _Reader, eval_names):
        from ..proofs.zerocheck import ZerocheckProof

        is_ext = r.u8() != 0
        num_vars = r.u32()
        degree = r.u32()
        if degree > 64 or num_vars > 40:
            raise SerializationError("InvalidData")
        if is_ext:
            rounds = [[self._read_ext(r) for _ in range(degree + 1)]
                      for _ in range(num_vars)]
            point = [self._read_ext(r) for _ in range(num_vars)]
            evals = {name: self._read_ext(r) for name in sorted(eval_names)}
        else:
            rounds = [[r.u64() for _ in range(degree + 1)] for _ in range(num_vars)]
            point = [r.u64() for _ in range(num_vars)]
            evals = {name: r.u64() for name in sorted(eval_names)}
        return ZerocheckProof(
            num_vars=num_vars, degree=degree, round_evals=rounds,
            final_point=point, column_evals=evals,
        )

    def _write_lookup_validity(self, w: _Writer, lv) -> None:
        if lv is None:
            from ..lookups.validity import LookupValidityProof

            lv = LookupValidityProof(nonce=0, tables=[], table_side=None)
        w.u64(lv.nonce)
        w.u32(len(lv.tables))
        for rec in lv.tables:
            w.u32(rec.table_id)
            w.u64(rec.num_queries)
            w.u32(rec.num_vars)
            self._write_zerocheck(w, rec.zc)
            for name in sorted(rec.g_sums):
                self._write_ext(w, rec.g_sums[name])
        ts = lv.table_side
        w.u8(1 if ts is not None else 0)
        if ts is None:
            return
        w.u32(len(ts.names))
        for name in ts.names:
            data = name.encode()
            w.u8(len(data))
            w.bytes_(data)
        self._write_zerocheck(w, ts.zc)
        for name in ts.names:
            self._write_ext(w, ts.h_sums[name])

    def _read_lookup_validity(self, r: _Reader):
        from ..lookups.validity import (
            GADGETS,
            LookupValidityProof,
            SubtableSideRecord,
            TableValidityRecord,
            merged_inclusions,
        )

        nonce = r.u64()
        tables = []
        for _ in range(r.u32()):
            table_id = r.u32()
            gadget = GADGETS.get(table_id)
            if gadget is None:
                raise SerializationError(f"unknown validity gadget table {table_id}")
            num_queries = r.u64()
            num_vars = r.u32()
            from ..constraints.regcheck import g_coord_names

            g_names = sorted(g for g, _s, _k in merged_inclusions(gadget))
            zc = self._read_zerocheck(
                r, list(gadget.columns) + g_coord_names(g_names)
            )
            g_sums = {name: self._read_ext(r) for name in g_names}
            tables.append(TableValidityRecord(
                table_id=table_id, num_queries=num_queries, num_vars=num_vars,
                zc=zc, g_sums=g_sums,
            ))
        table_side = None
        if r.u8():
            names = []
            for _ in range(r.u32()):
                names.append(r.bytes_(r.u8()).decode())
            from ..constraints.regcheck import g_coord_names

            eval_names = ([f"m_{n}" for n in names]
                          + g_coord_names([f"h_{n}" for n in names]))
            zc = self._read_zerocheck(r, eval_names)
            h_sums = {name: self._read_ext(r) for name in names}
            table_side = SubtableSideRecord(names=names, zc=zc, h_sums=h_sums)
        return LookupValidityProof(nonce=nonce, tables=tables, table_side=table_side)

    @staticmethod
    def _read_ligero_proof(r: _Reader):
        import numpy as np

        from ..commitments.ligero import LigeroEvalProof, P
        from ..core.ext4 import Ext4

        n = r.u32()
        if n > (1 << 28):
            raise SerializationError("InvalidData")
        # Canonical-range bound: the Ligero module's own modulus constant —
        # one source of truth shared with the writer and with _read_ext's
        # self.F.MODULUS (BabyBear-only today; a single constant keeps the
        # strictness paths from diverging if the field is ever parameterized).

        def read_row():
            raw = np.frombuffer(r.bytes_(16 * n), dtype="<u4").astype(np.uint64)
            if raw.size and int(raw.max()) >= P:
                raise SerializationError("InvalidData")
            return Ext4(raw.reshape(4, n))

        us = [read_row() for _ in range(r.u32())]
        ws = [read_row() for _ in range(r.u32())]
        t = r.u32()
        rows = r.u32()
        columns = np.frombuffer(r.bytes_(4 * t * rows), dtype="<u4").astype(np.uint64).reshape(t, rows)
        # Canonical encoding only (same malleability argument as _read_ext).
        if columns.size and int(columns.max()) >= P:
            raise SerializationError("InvalidData")
        num_nodes = r.u32()
        if num_nodes > (1 << 24):
            raise SerializationError("InvalidData")
        nodes = [r.bytes_(32) for _ in range(num_nodes)]
        return LigeroEvalProof(us=us, ws=ws, columns=columns, nodes=nodes)

    def _read_v2_section(self, r: _Reader, version: int = 2):
        from .proof import V2Section

        zerocheck = self._read_zerocheck(r, list(self._V2_COLUMNS))
        lasso_extras = {}
        for _ in range(r.u32()):
            table_id = r.u32()
            claimed_sum = r.u64()
            q_commit = r.bytes_(32)
            lasso_extras[table_id] = {
                "claimed_sum": claimed_sum,
                "query_commitment": q_commit,
            }
        logup_nonce = r.u64()
        logup_sum = self._read_ext(r)
        lookup_validity = self._read_lookup_validity(r)
        regcheck = self._read_regcheck(r)
        memcheck = self._read_memcheck(r)
        bytecode = self._read_bytecode(r)
        witness_evals = None
        if version >= 4:
            from ..constraints.witness import WITNESS_POLY_NAMES

            witness_evals = {name: self._read_ext(r)
                             for name in sorted(WITNESS_POLY_NAMES)}
        unified = self._read_unified(r)
        return V2Section(zerocheck=zerocheck,
                         column_evals=zerocheck.column_evals,
                         lasso_extras=lasso_extras,
                         logup_nonce=logup_nonce, logup_sum=logup_sum,
                         lookup_validity=lookup_validity, regcheck=regcheck,
                         memcheck=memcheck, bytecode=bytecode,
                         witness_evals=witness_evals, unified=unified)

    # -- deserialize -------------------------------------------------------
    def deserialize_path(self, path: str) -> Proof:
        """Deserialize a proof file without reading it into memory up
        front: the file is mmap'd and pages stream in on demand (the
        compact-Lasso fast path slices it zero-copy)."""
        import mmap

        with open(path, "rb") as f:
            size = f.seek(0, 2)
            if size == 0:
                raise SerializationError("InvalidData")
            with mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mapped:
                return self.deserialize(mapped)

    def deserialize(self, data: bytes) -> Proof:
        F = self.F
        r = _Reader(data)

        magic = r.bytes_(4)
        if magic != MAGIC:
            raise SerializationError("InvalidMagicNumber")
        version = r.u32()
        if version not in (1, 2, 3, 4):
            raise SerializationError("UnsupportedVersion")
        field_modulus = r.u64()
        num_steps = r.u64()
        num_vars = r.u32()
        r.u32()  # reserved
        if field_modulus != F.MODULUS:
            raise SerializationError("FieldMismatch")

        proof = Proof.create(F, num_steps)
        proof.metadata = ProofMetadata(
            num_steps=num_steps, num_vars=num_vars, field_modulus=field_modulus, version=version
        )

        proof.public_io = self._read_public_io(r)
        if version < 2:
            self._read_sumcheck(r, proof.constraint_proof)
        self._read_lasso_proofs(r, proof)
        if version < 4:
            self._read_witness_commitments(r, proof)
        else:
            proof.witness_commitments = []
        if version >= 2:
            proof.v2 = self._read_v2_section(r, version)
        return proof

    def _read_public_io(self, r: _Reader) -> PublicIO:
        program_hash = r.bytes_(32)
        initial_pc = r.u64()
        final_pc = r.u64()
        n = r.u32()
        initial_regs = [r.u64() for _ in range(n)] if n > 0 else None
        n = r.u32()
        final_regs = [r.u64() for _ in range(n)] if n > 0 else None
        num_steps = r.u64()
        n = r.u32()
        outputs = [r.u64() for _ in range(n)] if n > 0 else None
        return PublicIO(
            program_hash=program_hash,
            initial_pc=initial_pc,
            initial_regs=initial_regs,
            final_pc=final_pc,
            final_regs=final_regs,
            num_steps=num_steps,
            initial_memory=None,
            outputs=outputs,
        )

    def _read_sumcheck(self, r: _Reader, sc: PipelineSumcheckProof) -> None:
        F = self.F
        for poly in sc.round_polynomials:
            for i in range(len(poly)):
                poly[i] = F(r.u64())
        for i in range(len(sc.final_point)):
            sc.final_point[i] = F(r.u64())
        sc.final_eval = F(r.u64())

    def _read_lasso_proofs(self, r: _Reader, proof: Proof) -> None:
        F = self.F
        count = r.u32()
        # Fast path: if the whole block matches the uniform filler pattern
        # (table_id == index, num_lookups == 1, num_vars == 0, eval == 0),
        # keep it compact instead of materializing `count` objects.
        if count > 0 and r.pos + 24 * count <= len(r.data):
            import numpy as np

            # Zero-copy view (works over bytes and mmap alike); `rec`
            # must not outlive r.data — all uses below copy or reduce.
            rec = np.frombuffer(
                r.data,
                dtype=[("id", "<u4"), ("nl", "<u8"), ("nv", "<u4"), ("fe", "<u8")],
                count=count,
                offset=r.pos,
            )
            if (
                np.array_equal(rec["id"], np.arange(count, dtype=np.uint32))
                and np.all(rec["nl"] == 1)
                and np.all(rec["nv"] == 0)
                and np.all(rec["fe"] == 0)
            ):
                r.pos += 24 * count
                proof.lookup_proofs = CompactLassoList(F, count)
                return
        proof.lookup_proofs = []
        for _ in range(count):
            table_id = r.u32()
            num_lookups = r.u64()
            num_vars = r.u32()
            lasso = PipelineLassoProof.create(F, table_id, num_lookups, num_vars)
            self._read_sumcheck(r, lasso.multiset_proof)
            proof.lookup_proofs.append(lasso)

    def _read_witness_commitments(self, r: _Reader, proof: Proof) -> None:
        F = self.F
        for c in proof.witness_commitments:
            c.commitment = r.bytes_(32)
            for i in range(len(c.point)):
                c.point[i] = F(r.u64())
            c.value = F(r.u64())
            c.proof = self._read_merkle_proof(r, c.point)

    def _read_merkle_proof(self, r: _Reader, point) -> OpeningProof:
        F = self.F
        proof_value = F(r.u64())
        index = r.u64()
        merkle_value = F(r.u64())
        path_len = r.u32()
        siblings = [r.bytes_(32) for _ in range(path_len)]
        directions = [r.u8() != 0 for _ in range(path_len)]
        return OpeningProof(
            point=list(point),
            value=proof_value,
            merkle_proof=MerkleOpening(
                index=index,
                value=merkle_value,
                path=MerklePath(siblings=siblings, directions=directions),
            ),
        )
