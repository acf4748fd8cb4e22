"""A kernel group's share of its roofline: the least time its work needs
over the time its kernels took.

The least time is the larger of the bytes over the card's HBM rate (3.35
TB/s, the H100 SXM data sheet) and the integer instructions over 132 SMs x
64 INT32 lanes x the card's max SM clock (nvidia-smi). The work comes from
`work/<group>.py`, counted from the protocol's shapes; the time is the
traced window's device time of the group's kernels, by name.
"""

from typing import Optional

from . import card


def least_seconds(work: dict, sm_clock_mhz: float) -> float:
    return max(work["bytes"] / card.HBM_BYTES_PER_S, work["instructions"] / card.int32_per_s(sm_clock_mhz))


def share_pct(run, group: str, works) -> Optional[float]:
    """100 x the least time of `works` (one work count a prove of the
    traced window) over the device time of the group's kernels; None where
    the trace saw none of them."""
    if run.trace is None or not works:
        return None
    kernels = run.work(group).KERNELS
    seconds = run.trace.kernels_matching(kernels)
    if seconds <= 0:
        return None
    least = sum(least_seconds(w, run.card["sm_clock_max_mhz"]) for w in works)
    return 100.0 * least / seconds
