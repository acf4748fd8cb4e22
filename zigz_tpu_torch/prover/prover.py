"""The end-to-end proving pipeline (v1, wire-compatible with the reference).

Reference: zigz src/prover/prover.zig.  The transcript schedule
below is the proof-bytes contract (SURVEY.md §3.2) and is replicated to the
byte:

1.  fresh SHA3 Fiat-Shamir transcript per proof (:91);
2.  bind SHA-256(program), F(entry_pc), F(reg) for each initial reg (:97-110);
3.  run the VM (InvalidInstruction == clean halt; other VM errors propagate,
    :117-148); EmptyTrace if no steps;
4.  witness: 43 MLEs over v = ceil_log2(steps) vars (:156-162);
5.  constraint metadata (:169-175);
6.  sumcheck phase: "SUMCHECK_BEGIN", F(num_steps), F(num_vars); per round
    absorb 4 ZERO coefficients, then squeeze the round challenge into
    final_point (:250-288 — the v1 constraint sumcheck is a structural
    placeholder; final_eval = 0);
7.  Lasso phase: "LASSO_BEGIN"; per traced lookup i: "LASSO_TABLE", F(i),
    then a 0-round degree-2 multiset proof (num_lookups=1 ⇒ num_vars=0, so
    the seeded Xoshiro256++ filler stream is never consumed) (:292-363);
8.  commitments, 4-phase: (1) Merkle-commit all 43 witness MLEs;
    (2) "POLY_COMMITMENTS" + all 43 roots; (3) per poly derive v challenges
    as the opening point, evaluate, Merkle-open at point[0] mod 2^v;
    (4) "OPENING_CLAIMS" + all 43 values — the Jolt pull request 981 binding
    (:371-467);
9.  package PublicIO incl. the guest's output tape (:513-559).

Counterpart of zigz_tpu/prover/prover.py, a class of its own with the
device work on a torch device: ``Prover(BabyBear, device="cuda",
protocol_version=1 or 2)``.  The witness is rebuilt on the device from the
native trace's columns (ops/witness_dev.py), the 43 Merkle trees are built
and opened there (commitments/device_forest.py, kernels K1 and K2), and the
v2 pipeline commits, runs its zerochecks and runs the Lasso rounds there
(prover/unified.py, ops/zerocheck_dev_ext.py, lookups/pipeline_lasso.py).
There is no size gate, no environment switch and no backend probe: the
device paths run on the smallest traces too, and ``device="cpu"`` runs the
same code with the kernels' plain PyTorch versions.  ``group=`` (a
``TraceGroup`` of parallel/multihost.py) shards that device work over the
ranks of a process group, each rank one process, in place of the JAX
package's ``mesh=``; every rank repeats the host phases and ends with the
same proof bytes as the unsharded prove.  The transcript itself
stays on the host: it is sequential, cheap, and consensus-critical.
Protocol v3 is v2 with Poseidon2-over-BabyBear as the hash of the forest
and of both Ligero commitments (ops/poseidon2.py: the CUDA kernels P1-P3 on the card);
protocol v4 is v2 with the 43 witness MLEs as ``w:<name>`` columns of the
DATA commitment and no forest (constraints/core_arg.py).  ``device``
defaults to the card and raises where there is none.
"""

from __future__ import annotations

import itertools
from typing import List, Optional

import numpy as np

from ..commitments.commit import OpeningProof as SchemeOpening
from ..commitments.device_forest import DeviceMerkleForest
from ..constraints.builder import ConstraintSystem
from ..constraints.witness import WitnessGenerator
from ..core.hash import FiatShamirTranscript, sha256
from ..core.xoshiro import Xoshiro256
from ..device import resolve_device, synchronize
from ..elf import Segment
from ..isa.rv64i import InvalidInstruction
from ..ops import babybear as bb
from ..ops import mle, witness_dev
from ..parallel import dist
from ..utils import profiling
from ..utils.profiling import span
from ..vm.state import VMState
from .proof import CompactLassoList, Proof, PublicIO

__all__ = ["Prover", "EmptyTrace"]

_PROVE_IDS = itertools.count(1)  # every prove of the process, numbered


class EmptyTrace(Exception):
    pass


class Prover:
    """Prover(F) twin (prover.zig:27-561)."""

    def __init__(self, F, *, device="cuda", group=None, seed: int = 0, verbose: bool = False,
                 use_native_vm: Optional[bool] = None, protocol_version: int = 1):
        if protocol_version not in (1, 2, 3, 4):
            raise ValueError(f"protocol_version={protocol_version}: expected 1, 2, 3 or 4")
        # v1 runs over every field below 2^31 and over Goldilocks and
        # Mersenne61, as zigz_tpu proves them (mle.check_device_modulus: an
        # int32 witness below 2^31, u64 words and kernel E1 for the two
        # 64-bit fields); v2 raises at prove time (constraints/core_arg.py),
        # v3 and v4 here, as zigz_tpu does.
        if protocol_version in (3, 4) and F.MODULUS != bb.P:
            name = "Poseidon2 commitments" if protocol_version == 3 else "Ligero witness PCS"
            raise ValueError(f"protocol_version={protocol_version} ({name}) is BabyBear-only")
        mle.check_device_modulus(F.MODULUS)
        if group is not None and F.MODULUS != bb.P:
            raise ValueError(f"a sharded prove is BabyBear-only (p = {bb.P}), not {F.MODULUS}: zigz_tpu's "
                             "mesh path builds its witness and evaluations in BabyBear")
        self.F = F
        self.device = resolve_device(device)
        # Optional process group (parallel/multihost.py TraceGroup): shards
        # the hypercube-axis device work (witness build, Merkle forest,
        # opening evaluations, the v2 commits, batch evaluation and Lasso
        # rounds) over its ranks, with byte-identical proofs on every rank
        # (tests/test_torch_group_prove.py).  None is the unsharded path.
        if group is not None and group.device != self.device:
            raise ValueError(f"the group's rank runs on {group.device}, the prover on {self.device}")
        self.group = group
        self.rng = Xoshiro256(seed)
        self.transcript = FiatShamirTranscript()
        self.verbose = verbose
        # Native (C++) interpreter: auto-detect unless pinned; produces
        # identical traces/proof bytes.
        if use_native_vm is None:
            from ..runtime import native_vm

            use_native_vm = native_vm.available()
        self.use_native_vm = use_native_vm
        # v1 = reference wire parity; v2 = real zerocheck + Lasso under two
        # Ligero commitments (SHA3); v3 = v2 with Poseidon2-over-BabyBear
        # commitments; v4 = v2 with the 43 witness MLEs under the DATA
        # Ligero commitment, opened at the zerocheck point, in place of the
        # Merkle forest and its point-to-index openings.
        self.protocol_version = protocol_version
        self.last_timings = {}
        self.last_spans = profiling.SpanLog(None)

    def _hash_mode(self) -> str:
        return "poseidon2" if self.protocol_version == 3 else "sha3"

    def _log(self, msg: str) -> None:
        if self.verbose:
            print(msg)

    def prove(
        self,
        program: bytes,
        entry_pc: int,
        initial_regs: Optional[List[int]] = None,
        max_steps: int = 1 << 20,
        segments: Optional[List[Segment]] = None,
        input_tape: Optional[List[int]] = None,
    ) -> Proof:
        """Prove one execution.  ``last_spans`` then holds this prove's
        spans (utils/profiling.py) and ``last_timings`` the seconds read
        from them; the proof carries the prove's id as ``prove_id``, which
        the serializer's spans take (the proof bytes do not)."""
        prove_id = next(_PROVE_IDS)
        self.last_timings = timings = {}
        with profiling.root("prove", prove_id) as spans:
            self.last_spans = spans
            proof = self._prove(program, entry_pc, initial_regs, max_steps, segments, input_tape)
        proof.prove_id = prove_id
        phases = {s.name: s for s in spans.children(spans[0])}
        for name in ("execute", "witness", "sumcheck_lasso", "commitments"):
            timings[f"{name}_s"] = phases[name].seconds
        timings.update({
            "total_s": spans[0].seconds,
            "num_steps": proof.metadata.num_steps,
            "num_vars": proof.metadata.num_vars,
            "gc_s": spans.gc_s,
            "gc_collections": spans.gc_collections,
        })
        return proof

    def _prove(self, program, entry_pc, initial_regs, max_steps, segments, input_tape) -> Proof:
        F = self.F
        with span("execute"):
            # ELF convenience: callers handing raw ELF bytes without segments
            # would otherwise execute the ELF header as instructions and fail
            # with a misleading UnimplementedInstruction.  Deriving segments
            # here matches the CLI (cli.py _load_program); the transcript still
            # binds the full program bytes and the caller's entry_pc.
            if segments is None:
                from .. import elf

                if elf.is_elf(program):
                    segments = elf.load(program).segments

            # Fresh transcript per proof (prover.zig:91).
            self.transcript = FiatShamirTranscript()
            transcript = self.transcript

            # Bind public inputs FIRST (prover.zig:97-110).
            program_hash = sha256(program)
            transcript.append_bytes(program_hash)
            transcript.append_field_element(F, F(entry_pc))
            if initial_regs is not None:
                for reg_val in initial_regs:
                    transcript.append_field_element(F, F(reg_val))

            # STEP 1: execute (prover.zig:117-148).
            if self.use_native_vm:
                trace, final_state = self._execute_native(
                    program, entry_pc, initial_regs, max_steps, segments, input_tape
                )
                lookup_count = trace.num_lookups()
            else:
                vm = self._execute_python(program, entry_pc, initial_regs, max_steps, segments, input_tape)
                trace = vm.trace
                final_state = {
                    "final_pc": vm.pc,
                    "final_regs": [vm.regs.read(i) for i in range(32)],
                    "output_tape": list(vm.output_tape),
                }
                lookup_count = sum(1 for t in trace.lookup_tables if t is not None)

            num_steps = trace.step_count()
            self._log(f"Execution complete: {num_steps} steps")
            if num_steps == 0:
                raise EmptyTrace()

        # STEP 2: witness (prover.zig:156-162).  On the v1 path the host
        # matrix is never needed (commitments, evals, and openings all use
        # the device-built witness), so materialize lazily.
        with span("witness"):
            witness = _LazyWitness(F, trace)

        # STEP 3-5: constraint metadata (prover.zig:169-175), then the
        # constraint sumcheck + lookups: v1 placeholders (prover.zig:250-363)
        # or the v2+ real argument pipeline under the unified commitment
        # harness (prover/unified.py).
        with span("sumcheck_lasso", outer=True):
            if self.protocol_version >= 2:
                proof = self._proof_shell(witness, num_steps)
                proof.metadata.version = self.protocol_version
                self._generate_v2_unified(proof, witness, trace, program,
                                          entry_pc, segments, initial_regs,
                                          final_state)
            else:
                with span("filler"):
                    proof = self._proof_shell(witness, num_steps)
                    self._generate_sumcheck_proof(proof, witness)
                with span("lasso_absorb") as absorb:
                    self._generate_lasso_proofs(proof, lookup_count)
                self.last_timings["lasso_absorb_s"] = absorb.seconds

        # STEP 6: commitments (prover.zig:371-467).  v4 replaces the 43
        # Merkle trees + point-to-index openings with the Ligero witness
        # PCS already emitted in the zerocheck phase.
        with span("commitments", outer=True):
            if self.protocol_version < 4:
                self._generate_commitments(proof, witness)
            else:
                proof.witness_commitments = []

        # STEP 7: public IO (prover.zig:513-559), the prove span's self time.
        self._package_public_io(proof, program, final_state, entry_pc, initial_regs)
        return proof

    def _proof_shell(self, witness, num_steps: int) -> Proof:
        """The constraint metadata (prover.zig:169-175) and an empty proof."""
        ConstraintSystem().builder.build_all(self.F, witness)
        return Proof.create(self.F, num_steps)

    # ------------------------------------------------------------------
    def _generate_v2_unified(self, proof: Proof, witness, trace, program,
                             entry_pc, segments, initial_regs, final_state) -> None:
        """Protocol v2+ (round 3): the real argument pipeline under the
        unified commitment harness.  Transcript schedule:

          public inputs (prover.zig order) ->
          per-argument public blocks (SUMCHECK_BEGIN / LV / RC / MC / BC)
          -> "V2_DATA" + one mixed Ligero root over EVERY argument's
          challenge-independent columns -> per-argument extension
          challenge draws (nonce retry loops) -> per-argument logUp sums
          -> "V2_ADVICE" + one root over every inverse/multiplicity
          advice column -> per-argument zerochecks -> the batch-eval
          reduction (proofs/batch_eval.py) -> two LigeroMixedClaim
          openings at the reduced point -> "LASSO_BEGIN" + the per-table
          pipeline Lasso sumchecks.

        The commitments, the zerochecks and the Lasso rounds run on
        ``self.device``."""
        from ..constraints.bytecode import BytecodeArgument
        from ..constraints.core_arg import CoreV2Argument
        from ..constraints.memcheck import (
            MemcheckArgument,
            extract_byte_accesses,
            initial_memory_map,
        )
        from ..constraints.regcheck import RegcheckArgument, extract_access_columns
        from ..lookups.pipeline_lasso import (
            extract_table_queries,
            instruction_registers,
            operand_values,
            prove_pipeline_lasso,
            system_read_override,
            write_access_values,
        )
        from ..lookups.validity import ValidityArgument
        from ..prover.unified import prove_unified
        from .proof import V2Section

        F = self.F
        transcript = self.transcript
        num_vars = proof.metadata.num_vars
        with span("unified", outer=True) as unified_span:
            core = CoreV2Argument(F, witness, trace, self.protocol_version)

            queries = extract_table_queries(trace)
            validity = ValidityArgument(F, queries)

            rs1, rs2, rd = instruction_registers(trace)
            rv1, rv2, _rd_after, _rd_before = operand_values(trace, rs1, rs2, rd)
            wr, ov, wv = write_access_values(trace)
            # SYSTEM steps read (a7, a0) so the syscall dispatch state is a
            # proven column (consumed by the bytecode argument).
            rs1, rs2, rv1, rv2 = system_read_override(trace, rs1, rs2, rv1, rv2)
            access = extract_access_columns(rs1, rs2, wr, rv1, rv2, ov, wv)
            reg = RegcheckArgument(
                F, access, num_vars, initial_regs, final_state["final_regs"],
            )

            init_mem = initial_memory_map(program, entry_pc, segments)
            mc_access = extract_byte_accesses(trace, init_mem)
            mem = MemcheckArgument(F, mc_access, init_mem)

            bc = BytecodeArgument(
                F, trace, program, entry_pc, segments, num_vars, reg, core,
                validity, mem, outputs=final_state["output_tape"],
                final_pc=final_state["final_pc"],
            )

            unified = prove_unified(
                F, transcript, [core, validity, reg, mem, bc],
                self._hash_mode(), timings=self.last_timings, device=self.device,
                group=self.group,
            )
        self.last_timings["unified_s"] = unified_span.seconds

        # Lasso phase: real per-table sumchecks over the trace's actual
        # operand/result multisets (lookups/pipeline_lasso.py).
        transcript.append_bytes(b"LASSO_BEGIN")
        with span("lasso") as lasso_span:
            lookup_proofs, extras = prove_pipeline_lasso(F, transcript, queries, device=self.device,
                                                          group=self.group)
        proof.lookup_proofs = lookup_proofs
        self.last_timings["lasso_s"] = lasso_span.seconds

        proof.v2 = V2Section(
            zerocheck=core.zc,
            column_evals=core.zc.column_evals,
            lasso_extras=extras,
            logup_nonce=core.logup_nonce,
            logup_sum=core.logup_sum,
            lookup_validity=validity.proof,
            regcheck=reg.proof,
            memcheck=mem.proof,
            bytecode=bc.proof,
            witness_evals=core.witness_evals,
            unified=unified,
        )

    def _execute_python(self, program, entry_pc, initial_regs, max_steps, segments, input_tape):
        if segments is not None:
            vm = VMState.init_from_segments(segments, entry_pc, input_tape)
        else:
            vm = VMState.init(program, entry_pc, input_tape)
        if initial_regs is not None:
            for i, value in enumerate(initial_regs):
                if i < 32:
                    vm.regs.write(i, value)
            vm.trace.set_initial_regs(vm.regs.regs)
        step_count = 0
        while not vm.halted and step_count < max_steps:
            try:
                vm.step()
            except InvalidInstruction:
                break
            step_count += 1
        return vm

    def _execute_native(self, program, entry_pc, initial_regs, max_steps, segments, input_tape):
        from ..runtime.native_vm import NativeVM, raise_for_status

        nvm = NativeVM()
        if segments is not None:
            for seg in segments:
                nvm.load_segment(seg.vaddr, seg.data)
        else:
            nvm.load_segment(entry_pc, program)
        result = nvm.run(entry_pc, max_steps, initial_regs, input_tape)
        raise_for_status(result["status"])  # non-halt errors propagate
        return result["trace"], result

    def _generate_sumcheck_proof(self, proof: Proof, witness) -> None:
        F = self.F
        transcript = self.transcript
        num_vars = witness.num_vars

        transcript.append_bytes(b"SUMCHECK_BEGIN")
        transcript.append_field_element(F, F(witness.num_steps))
        transcript.append_field_element(F, F(num_vars))

        proof.constraint_proof.final_eval = F.zero()
        zero_coeff_bytes = b"\x00" * 8 * 4  # four zero coefficients
        for rnd in range(num_vars):
            for i in range(4):
                proof.constraint_proof.round_polynomials[rnd][i] = F.zero()
            transcript.append_bytes(zero_coeff_bytes)
            proof.constraint_proof.final_point[rnd] = transcript.challenge(F)

    def _generate_lasso_proofs(self, proof: Proof, lookup_count: int) -> None:
        """One filler proof per traced lookup (prover.zig:292-363).

        Every proof is uniform (table_id = i, num_lookups = 1 ⇒ num_vars =
        log2_ceil(1) = 0, so the seeded RNG filler draws nothing), which
        lets us batch the transcript absorption into one update and store
        the proofs compactly.  Byte stream per lookup:
        "LASSO_TABLE" + LE64(table_id mod p)."""
        F = self.F
        transcript = self.transcript
        transcript.append_bytes(b"LASSO_BEGIN")

        if lookup_count > 0:
            from ..runtime import native_lasso_id_stream

            stream = native_lasso_id_stream(lookup_count, F.MODULUS)
            if stream is not None:
                # numpy buffers satisfy the buffer protocol — absorb with
                # no intermediate bytes copy.
                transcript._hasher.update(stream)
            else:
                ids = np.arange(lookup_count, dtype=np.uint64)
                if lookup_count > F.MODULUS:
                    # uint64 vector mod is ~2s at 2^22 and a no-op below p.
                    ids %= np.uint64(F.MODULUS)
                stream = np.empty((lookup_count, 19), dtype=np.uint8)
                stream[:, :11] = np.frombuffer(b"LASSO_TABLE", dtype=np.uint8)
                stream[:, 11:] = (
                    np.frombuffer(
                        np.ascontiguousarray(ids, dtype="<u8").tobytes(), dtype=np.uint8
                    ).reshape(lookup_count, 8)
                )
                transcript.append_bytes(stream.tobytes())

        proof.lookup_proofs = CompactLassoList(F, lookup_count)

    def _generate_commitments(self, proof: Proof, witness) -> None:
        # Every span here ends where the host waits for the device: at a
        # synchronize, or at a device-to-host read, so that it covers the
        # device work and not only its launches.
        trace = witness._trace
        before = witness_dev.UPLOADED["bytes"]
        with span("witness_dev", outer=True) as witness_span:
            if hasattr(trace, "columns"):
                # Spans pack, upload and build; build ends at a synchronize.
                lo = witness_dev.build_witness(trace, trace.initial_regs, witness.num_vars, self.device,
                                               group=self.group, p=self.F.MODULUS)
            else:  # the Python interpreter's trace: upload the host matrix, or this rank's columns of it
                matrix = witness.matrix  # canonical uint64: u32 words below 2^31, u64 over a 64-bit field
                if self.group is not None:
                    witness_dev.check_slice_width(matrix.shape[1], self.group.world_size)
                    matrix = np.ascontiguousarray(dist.shard_rows(self.group, matrix))
                if not mle.is_wide(self.F.MODULUS):
                    matrix = matrix.astype(np.uint32)
                lo = witness_dev.from_numpy(matrix, self.device, p=self.F.MODULUS)
                synchronize(self.device)
        t = self.last_timings
        t["witness_dev_s"] = witness_span.seconds
        t.update({f"witness_{s.name}_s": s.seconds for s in self.last_spans.children(witness_span)})
        t["witness_upload_bytes"] = witness_dev.UPLOADED["bytes"] - before

        with span("forest") as forest_span:
            forest = DeviceMerkleForest(self.F, lo=lo, hash_mode=self._hash_mode(), group=self.group)
            synchronize(self.device)
        t["forest_s"] = forest_span.seconds
        t["forest_plan"] = forest.plan()
        self._generate_commitments_forest(proof, witness, forest)

    def _generate_commitments_forest(self, proof: Proof, witness, forest) -> None:
        """All 43 Merkle trees built in bulk on the device; only roots and
        opened sibling paths are consumed.  Byte-identical to the per-poly
        scheme (commitments/commit.py; tests/test_torch_forest.py)."""
        F = self.F
        transcript = self.transcript
        num_vars = witness.num_vars
        t = self.last_timings

        # PHASE 1: bulk forest build.  The roots' device-to-host read waits
        # for the device.
        with span("roots") as sp:
            roots = forest.roots()
        t["roots_s"] = sp.seconds
        for i, root in enumerate(roots):
            proof.witness_commitments[i].commitment = root

        # PHASE 2: bind all roots.
        transcript.append_bytes(b"POLY_COMMITMENTS")
        for root in roots:
            transcript.append_bytes(root)

        # PHASE 3: challenges (sequential, host transcript), evals, openings.
        with span("points") as sp:
            points = [[transcript.challenge(F) for _ in range(num_vars)] for _ in range(43)]
        t["points_s"] = sp.seconds
        # The forest evaluates from its device-resident witness: the lazy
        # host matrix is not touched.  With no variable (one step) the
        # points are (43, 0) and the values are the witness's first column.
        # The evaluations and the openings each end in a device-to-host read.
        with span("evals") as sp:
            pts_arr = np.array([[c.value for c in pt] for pt in points], dtype=np.uint64).reshape(43, num_vars)
            values = forest.eval_backend(None, pts_arr)
        t["evals_s"] = sp.seconds
        indices = np.array(
            [(points[i][0].value % (1 << num_vars)) if num_vars else 0 for i in range(43)],
            dtype=np.int64,
        )
        with span("opens") as sp:
            merkle_openings = forest.open_all(indices)
        t["opens_s"] = sp.seconds
        for i in range(43):
            wc = proof.witness_commitments[i]
            wc.value = F.from_reduced(int(values[i]))
            wc.proof = SchemeOpening(
                point=points[i], value=wc.value, merkle_proof=merkle_openings[i]
            )
            wc.point = wc.proof.point

        # PHASE 4: bind all opening claims.
        transcript.append_bytes(b"OPENING_CLAIMS")
        for opening in proof.witness_commitments:
            transcript.append_field_element(F, opening.value)

    def _package_public_io(self, proof: Proof, program: bytes, final_state: dict, entry_pc, initial_regs) -> None:
        outputs = final_state["output_tape"] or None
        proof.public_io = PublicIO(
            program_hash=sha256(program),
            initial_pc=entry_pc,
            initial_regs=list(initial_regs) if initial_regs is not None else None,
            final_pc=final_state["final_pc"],
            final_regs=list(final_state["final_regs"]),
            num_steps=proof.metadata.num_steps,
            initial_memory=None,
            outputs=outputs,
        )


class _LazyWitness:
    """Witness facade: metadata immediately, host matrix on first access
    (the v2 constraint arguments read it; the v1 path never does)."""

    def __init__(self, F, trace):
        from ..constraints.witness import num_vars_for_steps

        self.F = F
        self._trace = trace
        self.num_steps = trace.step_count()
        self.num_vars = num_vars_for_steps(self.num_steps)
        self._host = None

    @property
    def matrix(self):
        return self._host_witness().matrix

    def polynomials(self):
        return self._host_witness().polynomials()

    def _host_witness(self):
        if self._host is None:
            self._host = WitnessGenerator.generate(self.F, self._trace)
        return self._host
