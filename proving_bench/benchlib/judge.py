"""Deciding `correct`: the kept proofs against the plain reference of the
cell's protocol.

The reference is the module `reference/v<protocol_version>.py` that
`cell.load` finds and checks (`Cell.reference`, `cell.REFERENCE_API`). For
each kept proof that module works out what the proof must be from the same
guest and input, and counts what the proof says differently, each count
under one of its `NAMES`. Here the counts are summed over the kept proofs
and held to the module's `LIMITS`; nothing here knows a protocol.
"""

from __future__ import annotations

from types import ModuleType
from typing import Dict, List, Set, Tuple


def judge(ref: ModuleType, kept: Dict[int, bytes], inputs: Dict[int, int], program: bytes, max_steps: int,
          config: dict, device, control: bool = False) -> Tuple[Dict[str, int], Set[int]]:
    """The counts of reference `ref` summed over the kept proofs (or over its
    controls in their place), and the indices of the proofs with a count
    over its limit."""
    total: Dict[str, int] = {}
    bad: Set[int] = set()
    for i, data in sorted(kept.items()):
        exp = ref.expect(program, [inputs[i]], max_steps, config, device)
        if control:
            data = ref.control(program, [inputs[i]], max_steps, config, device)
        out = ref.compare(data, exp, program, config, device)
        counts = {k: out[k] for k in ref.NAMES}
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        if not verdict(counts, ref):
            bad.add(i)
        del exp
    return total, bad


def verdict(numbers: Dict[str, int], ref: ModuleType) -> bool:
    return bool(numbers) and all(numbers[k] <= ref.LIMITS[k] for k in numbers)


def compared(numbers: Dict[str, int], ref: ModuleType) -> Dict[str, dict]:
    """Each number compared beside its limit, in the order of the reference's names."""
    return {k: {"value": numbers[k], "limit": ref.LIMITS[k]} for k in ref.NAMES if k in numbers}


def lines(numbers: Dict[str, int], ref: ModuleType) -> List[str]:
    return [f"compared {k} {c['value']} limit {c['limit']}" for k, c in compared(numbers, ref).items()]
