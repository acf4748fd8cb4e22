"""Command-line interface of the port: execute / prove / verify / new / build.

Counterpart of zigz_tpu/cli.py (reference: zigz src/main.zig).  Same
subcommands, flags and defaults (entry 0x1000, max-steps 2^20); ``prove``
takes the device its work runs on:

    python -m zigz_tpu_torch.cli execute <program.bin|program.elf> [--entry 0x1000] [--max-steps N]
    python -m zigz_tpu_torch.cli prove   <program> [--device cuda|cpu] [--entry 0x1000] [--max-steps N]
                                         [--out proof.bin] [--input v1,v2,...] [--v2|--v3|--v4]
    python -m zigz_tpu_torch.cli verify  <proof.bin> <program>
    python -m zigz_tpu_torch.cli new     <name>
    python -m zigz_tpu_torch.cli build   [path]

``--device`` defaults to ``cuda`` (the card; an error where there is none),
``--device cpu`` runs the kernels' plain versions.  ``--v2``, ``--v3`` and
``--v4`` select the protocol version.  ``--supervise`` is not ported yet and
exits non-zero.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

from . import elf
from .core.field import BabyBear as F
from .prover.prover import Prover
from .prover.serialization import BinarySerializer, SerializationError
from .verifier.verifier import ProgramHashMismatch, Verifier
from .vm.state import VMState
from .isa.rv64i import InvalidInstruction

DEFAULT_ENTRY = 0x1000
DEFAULT_MAX_STEPS = 1 << 20

USAGE = """zigz-tpu-torch — the zigz_tpu zkVM on PyTorch and CUDA (sumcheck + Lasso)

  python -m zigz_tpu_torch.cli execute <program.bin|program.elf> [--entry 0x1000] [--max-steps N]
    Run VM only (no proof). ELF: entry from file; raw .bin: use --entry.

  python -m zigz_tpu_torch.cli prove <program.bin|program.elf> [--device cuda|cpu]
      [--entry 0x1000] [--max-steps N] [--out proof.bin] [--input v1,v2,...] [--v2|--v3|--v4]
    Generate proof on the device (default cuda). ELF: entry and segments from file.
    --v2 real constraint zerocheck, lookups and memory checks;
    --v3 adds Poseidon2 commitments;
    --v4 unified Ligero witness PCS (no per-column Merkle forest).

  python -m zigz_tpu_torch.cli verify <proof.bin> <program.bin|program.elf>
    Verify proof. Program must match the one used to prove.

  python -m zigz_tpu_torch.cli new <name>
    Create a new guest project template in directory <name>.

  python -m zigz_tpu_torch.cli build [path]
    Build project (RISC-V ELF). Default path: current directory.
    Output: <path>/out/program (ELF for execute/prove).
"""

_NOT_PORTED = ("--supervise",)


def _parse_u64(args, flag, default):
    for i, arg in enumerate(args):
        if arg == flag and i + 1 < len(args):
            v = args[i + 1]
            return int(v, 16) if v.startswith("0x") else int(v)
    return default


def _parse_str(args, flag):
    for i, arg in enumerate(args):
        if arg == flag and i + 1 < len(args):
            return args[i + 1]
    return None


def _load_program(path: str):
    with open(path, "rb") as f:
        program = f.read()
    if elf.is_elf(program):
        result = elf.load(program)
        return program, result.entry_pc, result.segments
    return program, None, None


def cmd_execute(args) -> int:
    if not args:
        print("error: execute requires <program.bin|program.elf>", file=sys.stderr)
        print(USAGE)
        return 1
    program, elf_entry, segments = _load_program(args[0])
    entry_pc = elf_entry if elf_entry is not None else _parse_u64(args, "--entry", DEFAULT_ENTRY)
    max_steps = _parse_u64(args, "--max-steps", DEFAULT_MAX_STEPS)

    if segments is not None:
        vm = VMState.init_from_segments(segments, entry_pc, None)
    else:
        vm = VMState.init(program, entry_pc, None)

    steps = 0
    while not vm.halted and steps < max_steps:
        try:
            vm.step()
        except InvalidInstruction:
            break
        steps += 1

    print(f"execute: {steps} steps (entry_pc=0x{entry_pc:x}, max_steps={max_steps})")
    if vm.output_tape:
        print(f"outputs: {vm.output_tape}")
    return 0


def cmd_prove(args) -> int:
    if not args or args[0].startswith("-"):
        print("error: prove requires <program.bin|program.elf>", file=sys.stderr)
        print(USAGE)
        return 1
    for flag in _NOT_PORTED:
        if flag in args:
            print(f"error: {flag} is not yet ported to zigz_tpu_torch", file=sys.stderr)
            return 1
    device = _parse_str(args, "--device") or "cuda"
    program, elf_entry, segments = _load_program(args[0])
    entry_pc = elf_entry if elf_entry is not None else _parse_u64(args, "--entry", DEFAULT_ENTRY)
    max_steps = _parse_u64(args, "--max-steps", DEFAULT_MAX_STEPS)
    out_path = _parse_str(args, "--out")
    input_str = _parse_str(args, "--input")
    input_tape = [int(v) for v in input_str.split(",")] if input_str else None

    protocol_version = 1
    for flag, pv in (("--v2", 2), ("--v3", 3), ("--v4", 4)):
        if flag in args:
            protocol_version = pv
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


def cmd_verify(args) -> int:
    if len(args) < 2:
        print("error: verify requires <proof.bin> <program.bin>", file=sys.stderr)
        print(USAGE)
        return 1
    with open(args[1], "rb") as f:
        program = f.read()

    proof = BinarySerializer(F).deserialize_path(args[0])
    t0 = time.perf_counter()
    result = Verifier(F).verify(proof, program)
    verify_ms = (time.perf_counter() - t0) * 1000
    print(f"verify: {result} ({verify_ms:.0f} ms)")
    return 0 if result == "Accept" else 2


_GUEST_TEMPLATE = '''"""Guest program for the zigz_tpu_torch zkVM.

Build: python -m zigz_tpu_torch.cli build      (writes out/program as a RISC-V ELF)
Run:   python -m zigz_tpu_torch.cli execute out/program
Prove: python -m zigz_tpu_torch.cli prove out/program
"""

from zigz_tpu_torch.guest.asm import Assembler


def build() -> bytes:
    a = Assembler(base=0x1000)
    # n = io.read(); io.commit(n * 2)
    a.io_read("t0")
    a.add("t0", "t0", "t0")
    a.io_commit("t0")
    a.ebreak()
    return a.to_elf()


if __name__ == "__main__":
    import os, sys

    project_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out_dir = os.path.join(project_root, "out")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "program")
    with open(path, "wb") as f:
        f.write(build())
    print(f"wrote {path}")
'''


def cmd_new(args) -> int:
    if not args or not args[0] or args[0].startswith("-"):
        print("error: new requires <name>", file=sys.stderr)
        return 1
    name = args[0]
    os.makedirs(os.path.join(name, "src"), exist_ok=True)
    with open(os.path.join(name, "src", "main.py"), "w") as f:
        f.write(_GUEST_TEMPLATE)
    print(f'Created project "{name}".')
    print(f"  cd {name} && python -m zigz_tpu_torch.cli build && python -m zigz_tpu_torch.cli execute out/program")
    return 0


def cmd_build(args) -> int:
    path = args[0] if args else "."
    main_py = os.path.join(path, "src", "main.py")
    if not os.path.exists(main_py):
        print(f'error: no src/main.py in "{path}"', file=sys.stderr)
        return 1
    result = subprocess.run(
        [sys.executable, os.path.abspath(main_py)], cwd=path, capture_output=True, text=True
    )
    if result.returncode != 0:
        sys.stderr.write(result.stderr)
        return result.returncode
    sys.stdout.write(result.stdout)
    print(f"Build succeeded. ELF: {path}/out/program")
    return 0


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(USAGE)
        return 0
    cmd, rest = argv[0], argv[1:]
    handlers = {
        "execute": cmd_execute,
        "prove": cmd_prove,
        "verify": cmd_verify,
        "new": cmd_new,
        "build": cmd_build,
    }
    if cmd not in handlers:
        print("zigz-tpu-torch — the zigz_tpu zkVM on PyTorch and CUDA (sumcheck + Lasso)")
        print("Usage: python -m zigz_tpu_torch.cli <execute|prove|verify|new|build> [args...]")
        return 0
    try:
        return handlers[cmd](rest)
    except FileNotFoundError as e:
        print(f"error: cannot open {e.filename}", file=sys.stderr)
        return 1
    except ProgramHashMismatch:
        print("verify: RejectInvalidPublicIO (program hash mismatch)", file=sys.stderr)
        return 2
    except SerializationError as e:
        print(f"error: invalid proof file ({e})", file=sys.stderr)
        return 1
    except (ValueError, RuntimeError) as e:  # bad input, no CUDA device, kernel build
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
