"""Verifier benchmark suite.

Reference: zigz src/verifier/benchmarks.zig.  NOP programs of
16..16384 steps, prove once, verify x10 warm; reports size / time /
steps-per-second and the O(log n) scaling analysis (:42-177).

Counterpart of zigz_tpu/verifier/benchmarks.py over the port's ``Prover``
and ``Verifier``; the device is explicit (``"cuda"`` by default, which
raises without a card; ``"cpu"`` runs the kernels' plain versions).
``nop_program`` and ``timed_prove`` are the pieces that bench_torch.py and
scripts/torch_prove_once.py time their proves with.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import List, Optional

import torch

from ..core.field import BabyBear
from ..device import synchronize
from ..prover.prover import Prover
from ..prover.serialization import BinarySerializer
from ..verifier.verifier import Verifier

__all__ = ["BenchmarkResult", "BenchmarkSuite", "nop_program", "timed_prove"]

DEFAULT_SIZES = (16, 64, 256, 1024, 4096, 16384)


def nop_program(n: int) -> bytes:
    """n NOP instructions (``addi x0, x0, 0``), entered at 0x1000."""
    return bytes([0x13, 0x00, 0x00, 0x00] * n)


def timed_prove(prover: Prover, program: bytes, max_steps: int):
    """One prove of ``program`` at 0x1000, timed by the host clock once the
    device's queue has drained (the work, not its enqueue).  Returns
    (proof, seconds, peaks): peaks is the card's ``max_memory_allocated``
    and ``max_memory_reserved`` over the prove, in bytes, None on the CPU."""
    dev = prover.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    proof = prover.prove(program, 0x1000, None, max_steps, None, None)
    synchronize(dev)
    seconds = time.perf_counter() - t0
    peaks: Optional[dict] = None
    if dev.type == "cuda":
        peaks = {"max_memory_allocated_B": torch.cuda.max_memory_allocated(dev),
                 "max_memory_reserved_B": torch.cuda.max_memory_reserved(dev)}
    return proof, seconds, peaks


@dataclass
class BenchmarkResult:
    num_steps: int
    prove_s: float
    verify_s: float
    proof_size_bytes: int
    steps_per_s: float


class BenchmarkSuite:
    """benchmarks.zig:16-177."""

    def __init__(self, F=BabyBear, verify_iters: int = 10, *, device="cuda"):
        self.F = F
        self.device = device
        self.verify_iters = verify_iters
        self.results: List[BenchmarkResult] = []

    def run(self, sizes=DEFAULT_SIZES) -> List[BenchmarkResult]:
        ser = BinarySerializer(self.F)
        self.results = []
        for n in sizes:
            program = nop_program(n)
            prover = Prover(self.F, seed=0, device=self.device)
            proof, prove_s, _peaks = timed_prove(prover, program, max(n * 2, 1 << 10))

            proof_bytes = ser.serialize(proof)

            verifier = Verifier(self.F)
            t0 = time.perf_counter()
            for _ in range(self.verify_iters):
                result = verifier.verify(proof, program)
                assert result == "Accept"
            verify_s = (time.perf_counter() - t0) / self.verify_iters

            self.results.append(
                BenchmarkResult(
                    num_steps=n,
                    prove_s=prove_s,
                    verify_s=verify_s,
                    proof_size_bytes=len(proof_bytes),
                    steps_per_s=n / prove_s,
                )
            )
        return self.results

    def print_results(self) -> None:
        """benchmarks.zig:128-144."""
        print(f"{'steps':>8} {'prove (ms)':>12} {'verify (us)':>12} {'size (B)':>10} {'steps/s':>12}")
        for r in self.results:
            print(
                f"{r.num_steps:>8} {r.prove_s * 1e3:>12.1f} {r.verify_s * 1e6:>12.1f} "
                f"{r.proof_size_bytes:>10} {r.steps_per_s:>12.0f}"
            )

    def analyze_scaling(self) -> bool:
        """O(log n) check: verify-time ratio should track log(step ratio),
        and proof size should grow sublinearly (<2x per 4x steps within
        (1, 3), benchmarks.zig:146-177, :236-241)."""
        ok = True
        for a, b in zip(self.results, self.results[1:]):
            step_ratio = b.num_steps / a.num_steps
            size_ratio = b.proof_size_bytes / a.proof_size_bytes
            if not (1.0 < size_ratio < 3.0):
                print(
                    f"size scaling violation {a.num_steps}->{b.num_steps}: "
                    f"x{size_ratio:.2f} for x{step_ratio:.0f} steps"
                )
                ok = False
        return ok


def main():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    suite = BenchmarkSuite(device=ap.parse_args().device)
    suite.run()
    suite.print_results()
    log_ok = suite.analyze_scaling()
    print("scaling:", "O(log n) consistent" if log_ok else "VIOLATION")


if __name__ == "__main__":
    main()
