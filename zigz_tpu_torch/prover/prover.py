"""The v1 prover with its device work on a torch device.

Counterpart of the device branch of zigz_tpu/prover/prover.py.  The class
subclasses the JAX package's ``Prover`` and inherits everything on the host:
the native VM, the SHA3 transcript and its schedule, the v1 placeholder
sumcheck, the Lasso filler with its seeded Xoshiro stream, and
``_generate_commitments_forest`` (roots, challenge points, evaluations,
openings, claims).  It overrides only where the device work is chosen and
built:

* ``_use_device_commitments`` is True at every size: the port has no size
  gate, no environment switch and no backend probe, so the kernels run on
  the smallest traces too;
* ``_generate_commitments`` builds the witness with the port's
  ``build_witness`` (or uploads the host matrix when the trace is not
  native-columnar) and the port's ``DeviceMerkleForest``.

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
    """``Prover(BabyBear, device="cuda")``: protocol v1 on one device."""

    def __init__(self, F, *, device, seed: int = 0, verbose: bool = False,
                 use_native_vm=None, protocol_version: int = 1):
        if protocol_version != 1:
            raise NotImplementedError(
                f"protocol_version={protocol_version} is not ported yet: v2 comes with "
                "slices 2-3 (Ligero commitments, prover rounds), v3 and v4 with slice 4"
            )
        if F.MODULUS != bb.P:
            raise ValueError(f"the port's field is BabyBear (p = {bb.P}), not {F.MODULUS}")
        self.device = resolve_device(device)
        super().__init__(F, seed=seed, verbose=verbose, use_native_vm=use_native_vm,
                         protocol_version=1)

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
