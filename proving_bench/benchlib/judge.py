"""Deciding `correct`: the kept proofs against the plain reference.

For each kept proof the reference (`reference/`, plain NumPy and PyTorch)
executes the same guest on the same input, builds the 43 witness columns
and their Merkle forest, and compares what the proof says:

* `execution`: header and public IO against the reference's run (step
  count, variables, program hash, pcs, the 32 final registers, the output
  tape), one count a field that differs;
* `roots`: the 43 witness roots, one count a root that differs;
* `openings`: the 43 openings (index = point[0] mod 2^v, leaf value,
  siblings, directions, and the value against the column's multilinear
  extension at the proof's point), one count an opening with any fault;
* `proof_bytes`: the bytes that differ from the reference's whole proof
  (protocol v1, its transcript and placeholder sections included), length
  difference included.

Every number is a count whose limit is 0: the proof is exact.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Set, Tuple

import numpy as np

from reference import proof as refproof

NAMES = ("execution", "roots", "openings", "proof_bytes")
LIMITS = {name: 0 for name in NAMES}


def compare(data: bytes, exp: refproof.Expected, program: bytes, p: int, device) -> Dict[str, int]:
    """The counts for one proof's bytes against the reference's `exp`."""
    out = {name: 0 for name in NAMES}
    ref = exp.proof
    size = min(len(data), len(ref))
    diff = np.frombuffer(data[:size], np.uint8) != np.frombuffer(ref[:size], np.uint8)
    out["proof_bytes"] = int(diff.sum()) + abs(len(data) - len(ref))
    try:
        got = refproof.parse(data)
    except (refproof.ParseError, ValueError) as exc:
        out.update(execution=1, roots=refproof.COLUMNS, openings=refproof.COLUMNS)
        out["unreadable"] = str(exc)
        return out
    ex, v = exp.execution, exp.num_vars
    want = dict(version=refproof.VERSION, modulus=p, steps=ex.steps, num_vars=v, io_steps=ex.steps,
                program_hash=hashlib.sha256(program).digest(), initial_pc=ex.entry_pc,
                final_pc=ex.final_pc, initial_regs=[])
    out["execution"] = sum(getattr(got, k) != w for k, w in want.items())
    out["execution"] += sum(a != b for a, b in zip(got.final_regs, ex.final_regs)) + abs(len(got.final_regs) - 32)
    out["execution"] += sum(a != b for a, b in zip(got.outputs, ex.outputs)) + abs(len(got.outputs) - len(ex.outputs))
    out["roots"] = sum(o.root != r for o, r in zip(got.openings, exp.roots))
    if got.num_vars != v:
        out["openings"] = refproof.COLUMNS
        return out
    from reference import forest

    points = np.stack([o.point for o in got.openings]) if v else np.zeros((refproof.COLUMNS, 0), np.uint64)
    values = forest.evaluate(exp.matrix, points, p, device)
    index = np.array([o.index for o in got.openings], dtype=np.int64)
    bad = (index < 0) | (index >= 1 << v)
    siblings = exp.forest.siblings(np.where(bad, 0, index))
    for i, o in enumerate(got.openings):
        ok = not bad[i] and o.index == (int(o.point[0]) % (1 << v) if v else 0)
        ok = ok and o.leaf == int(exp.matrix[i, o.index]) and o.value == int(values[i]) == o.proof_value
        ok = ok and o.siblings == siblings[i].tobytes()
        ok = ok and o.directions == bytes((o.index >> k) & 1 for k in range(v))
        out["openings"] += not ok
    return out


def control_bytes(program: bytes, input_tape, max_steps: int, p: int, device) -> bytes:
    """The control in the program's place: the reference's whole proof with
    the reduction after each fold of an evaluation left out (a shortcut that
    breaks the exactness the configuration states)."""
    return refproof.expect(program, input_tape, max_steps, p, device, lazy=True).proof


def judge(kept: Dict[int, bytes], inputs: Dict[int, int], program: bytes, max_steps: int, p: int,
          device, control: bool = False) -> Tuple[Dict[str, int], Set[int]]:
    """The counts summed over the kept proofs (or their controls), and the
    indices of the proofs with a count over its limit."""
    total: Dict[str, int] = {}
    bad: Set[int] = set()
    for i, data in sorted(kept.items()):
        exp = refproof.expect(program, [inputs[i]], max_steps, p, device)
        if control:
            data = control_bytes(program, [inputs[i]], max_steps, p, device)
        counts = {k: v for k, v in compare(data, exp, program, p, device).items() if isinstance(v, int)}
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        if not verdict(counts):
            bad.add(i)
        del exp
    return total, bad


def verdict(numbers: Dict[str, int]) -> bool:
    return bool(numbers) and all(numbers[k] <= LIMITS[k] for k in numbers)


def lines(numbers: Dict[str, int]) -> List[str]:
    return [f"compared {k} {numbers[k]} limit {LIMITS[k]}" for k in NAMES if k in numbers]
