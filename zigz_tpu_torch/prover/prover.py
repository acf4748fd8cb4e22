"""The v1 and v2 provers with their device work on a torch device.

Counterpart of the device branches of zigz_tpu/prover/prover.py.  The class
subclasses the JAX package's ``Prover`` and inherits everything on the host:
the native VM, the SHA3 transcript and its schedule, the v1 placeholder
sumcheck, the Lasso filler with its seeded Xoshiro stream, the v2
arguments, and ``_generate_commitments_forest`` (roots, challenge points,
evaluations, openings, claims).  It overrides only where the device work is
chosen and built:

* ``_use_device_commitments`` is True at every size: the port has no size
  gate, no environment switch and no backend probe, so the kernels run on
  the smallest traces too;
* ``_generate_commitments`` builds the witness with the port's
  ``build_witness`` (or uploads the host matrix when the trace is not
  native-columnar) and the port's ``DeviceMerkleForest``;
* ``_generate_v2_unified`` (protocol v2) runs the port's ``prove_unified``,
  whose DATA and ADVICE Ligero commitments are encoded and hashed on the
  device.

The proof bytes are the JAX package's (tests/test_torch_prover.py).
"""

from __future__ import annotations

import time

import numpy as np

from zigz_tpu.prover.prover import Prover as ReferenceProver

from ..commitments.device_forest import DeviceMerkleForest
from ..device import resolve_device, synchronize
from ..ops import babybear as bb
from ..ops import witness_dev

__all__ = ["Prover", "ReferenceProver"]


class Prover(ReferenceProver):
    """``Prover(BabyBear, device="cuda", protocol_version=1 or 2)`` on one device."""

    def __init__(self, F, *, device, seed: int = 0, verbose: bool = False,
                 use_native_vm=None, protocol_version: int = 1):
        if protocol_version not in (1, 2):
            raise NotImplementedError(
                f"protocol_version={protocol_version} is not ported yet: v3 and v4 come "
                "with slice 4 (Poseidon2, the v4 witness PCS)"
            )
        if F.MODULUS != bb.P:
            raise ValueError(f"the port's field is BabyBear (p = {bb.P}), not {F.MODULUS}")
        self.device = resolve_device(device)
        super().__init__(F, seed=seed, verbose=verbose, use_native_vm=use_native_vm,
                         protocol_version=protocol_version)

    def _use_device_commitments(self, num_steps: int = None) -> bool:
        return True

    def _generate_commitments(self, proof, witness) -> None:
        # Each phase time is read after a synchronize, so that it covers the
        # device work and not only its launches.
        t0 = time.perf_counter()
        trace = witness._trace
        if hasattr(trace, "columns"):
            lo = witness_dev.build_witness(trace, trace.initial_regs, witness.num_vars, self.device)
        else:
            lo = witness_dev.from_numpy(witness.matrix.astype(np.uint32), self.device)
        synchronize(self.device)
        self.last_timings["witness_dev_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        forest = DeviceMerkleForest(self.F, lo=lo)
        synchronize(self.device)
        self.last_timings["forest_s"] = time.perf_counter() - t0

        # evals_s and opens_s are timed by the inherited method around calls
        # that end in a device-to-host copy, which waits for the device.
        self._generate_commitments_forest(proof, witness, forest)

    def _generate_v2_unified(self, proof, witness, trace, program, entry_pc, segments,
                             initial_regs, final_state) -> None:
        """Protocol v2: zigz_tpu's argument pipeline and transcript schedule
        (zigz_tpu/prover/prover.py ``_generate_v2_unified``), with the
        port's ``prove_unified``.

        The pipeline Lasso runs with ``device=False``: its device rounds
        (zigz_tpu/lookups/pipeline_lasso.py ``_sumcheck_rounds_device``) are
        JAX and are ported with slice 3 (ROADMAP A15).  The inherited method
        would pass ``_use_device_commitments``, which is True here."""
        from zigz_tpu.constraints.bytecode import BytecodeArgument
        from zigz_tpu.constraints.core_arg import CoreV2Argument
        from zigz_tpu.constraints.memcheck import (
            MemcheckArgument,
            extract_byte_accesses,
            initial_memory_map,
        )
        from zigz_tpu.constraints.regcheck import RegcheckArgument, extract_access_columns
        from zigz_tpu.lookups.pipeline_lasso import (
            extract_table_queries,
            instruction_registers,
            operand_values,
            prove_pipeline_lasso,
            system_read_override,
            write_access_values,
        )
        from zigz_tpu.lookups.validity import ValidityArgument
        from zigz_tpu.prover.proof import V2Section

        from .unified import prove_unified

        F = self.F
        transcript = self.transcript
        num_vars = proof.metadata.num_vars
        t0 = time.perf_counter()

        core = CoreV2Argument(F, witness, trace, self.protocol_version)
        queries = extract_table_queries(trace)
        validity = ValidityArgument(F, queries)

        rs1, rs2, rd = instruction_registers(trace)
        rv1, rv2, _rd_after, _rd_before = operand_values(trace, rs1, rs2, rd)
        wr, ov, wv = write_access_values(trace)
        rs1, rs2, rv1, rv2 = system_read_override(trace, rs1, rs2, rv1, rv2)
        access = extract_access_columns(rs1, rs2, wr, rv1, rv2, ov, wv)
        reg = RegcheckArgument(F, access, num_vars, initial_regs, final_state["final_regs"])

        init_mem = initial_memory_map(program, entry_pc, segments)
        mem = MemcheckArgument(F, extract_byte_accesses(trace, init_mem), init_mem)

        bc = BytecodeArgument(
            F, trace, program, entry_pc, segments, num_vars, reg, core, validity, mem,
            outputs=final_state["output_tape"], final_pc=final_state["final_pc"],
        )

        unified = prove_unified(F, transcript, [core, validity, reg, mem, bc], self._hash_mode(),
                                timings=self.last_timings, device=self.device)
        self.last_timings["unified_s"] = time.perf_counter() - t0

        transcript.append_bytes(b"LASSO_BEGIN")
        t0 = time.perf_counter()
        lookup_proofs, extras = prove_pipeline_lasso(F, transcript, queries, device=False)
        proof.lookup_proofs = lookup_proofs
        self.last_timings["lasso_s"] = time.perf_counter() - t0

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
