"""Command line of the port: ``prove`` runs the port's prover on a device.

    python -m zigz_tpu_torch.cli prove <program.bin|program.elf> --device cuda
                                 [--entry 0x1000] [--max-steps N] [--out proof.bin] [--input v1,v2,...]
                                 [--v2]

``--v2`` selects protocol v2.  ``execute``, ``verify``, ``new`` and
``build`` are zigz_tpu's own commands (they run no device code).  ``--v3``,
``--v4`` and ``--supervise`` are not ported yet and exit non-zero.
"""

from __future__ import annotations

import sys
import time

from zigz_tpu import cli as reference_cli
from zigz_tpu.cli import DEFAULT_ENTRY, DEFAULT_MAX_STEPS, _load_program, _parse_str, _parse_u64
from zigz_tpu.core.field import BabyBear as F
from zigz_tpu.prover.serialization import BinarySerializer

from .prover.prover import Prover

USAGE = """zigz-tpu-torch — the zigz_tpu v1 and v2 provers on PyTorch and CUDA

  python -m zigz_tpu_torch.cli prove <program.bin|program.elf> --device cuda|cpu
      [--entry 0x1000] [--max-steps N] [--out proof.bin] [--input v1,v2,...] [--v2]

  execute | verify | new | build: as python -m zigz_tpu.cli
"""

_NOT_PORTED = ("--v3", "--v4", "--supervise")


def cmd_prove(args) -> int:
    if not args or args[0].startswith("-"):
        print("error: prove requires <program.bin|program.elf>", file=sys.stderr)
        print(USAGE)
        return 1
    for flag in _NOT_PORTED:
        if flag in args:
            print(f"error: {flag} is not yet ported to zigz_tpu_torch (protocols v1 and v2 only)",
                  file=sys.stderr)
            return 1
    device = _parse_str(args, "--device")
    if device is None:
        print("error: prove requires --device cuda|cpu", file=sys.stderr)
        return 1
    program, elf_entry, segments = _load_program(args[0])
    entry_pc = elf_entry if elf_entry is not None else _parse_u64(args, "--entry", DEFAULT_ENTRY)
    max_steps = _parse_u64(args, "--max-steps", DEFAULT_MAX_STEPS)
    out_path = _parse_str(args, "--out")
    input_str = _parse_str(args, "--input")
    input_tape = [int(v) for v in input_str.split(",")] if input_str else None

    protocol_version = 2 if "--v2" in args else 1
    prover = Prover(F, seed=0, device=device, protocol_version=protocol_version)
    t0 = time.perf_counter()
    proof = prover.prove(program, entry_pc, None, max_steps, segments, input_tape)
    prove_ms = (time.perf_counter() - t0) * 1000

    if out_path:
        with open(out_path, "wb") as f:
            proof_size = BinarySerializer(F).serialize_to(proof, f)
    else:
        proof_size = len(BinarySerializer(F).serialize(proof))
    print(f"prove: {prove_ms:.0f} ms, proof size {proof_size} bytes, "
          f"steps {proof.metadata.num_steps}, protocol v{protocol_version}, device {prover.device}")
    if proof.public_io.outputs:
        print(f"outputs: {proof.public_io.outputs}")
    if out_path:
        print(f"wrote proof to {out_path}")
    return 0


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(USAGE)
        return 0
    if argv[0] != "prove":
        return reference_cli.main(argv)
    try:
        return cmd_prove(argv[1:])
    except FileNotFoundError as e:
        print(f"error: cannot open {e.filename}", file=sys.stderr)
        return 1
    except (ValueError, RuntimeError) as e:  # bad input, no CUDA device, kernel build
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
