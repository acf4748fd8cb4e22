"""The 43-row v1 witness built on the device from compact trace columns.

Counterpart of zigz_tpu/ops/witness_dev.py.  The host packs the native
trace's columns (``pack_trace_columns``, rewritten here because the JAX
package's module imports JAX), splitting u64 words into 32-bit lo/hi halves
in numpy, and the device rebuilds the witness rows:

* u64 -> mod-p reduction of the UNSIGNED value from its halves;
* the 32 register rows by forward-filling the per-step write deltas: a
  ``torch.cummax`` of the last-write step index per register, then a
  gather (the JAX package uses ``lax.associative_scan``);
* instruction and memory rows padded with zero, pc padded with its last
  value.

Output: (43, 2^v) canonical values in the commitment row order of
constraints/witness.py (0 = pc, 1..32 = x0..x31, 33..39 = opcode, rd, rs1,
rs2, funct3, funct7, imm, 40..42 = mem addr, value, is_read).

The modulus ``p`` is the field's (``F.MODULUS``, BabyBear's by default).
Below 2^31 (:func:`mle.check_modulus`) the values are int32 words, reduced
in int64, where (hi mod p) (2^32 mod p) < p^2 < 2^62.  Over the two 64-bit
fields (``mle.WIDE_MODULI``, Goldilocks and Mersenne61) they are int64
words holding the canonical value's u64 bits, a Goldilocks value of 2^63
or more a negative int64 (:func:`_mod_u64_wide`); the group path
(``_slice_columns``) stays BabyBear-only, as the sharded prove is.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .babybear import P
from . import mle
from .field64 import GOLDILOCKS_P, from_halves

__all__ = ["pack_trace_columns", "build_witness", "from_numpy", "check_slice_width", "NUM_ROWS"]

NUM_ROWS = 43
_FILL_VALUES = 1 << 27  # int64 values per transient of the register forward fill
_M32 = np.uint64(0xFFFFFFFF)
_U32_COLUMNS = (
    "pc_lo", "pc_hi", "imm_lo", "wr_val_lo", "wr_val_hi",
    "mem_addr_lo", "mem_addr_hi", "mem_val_lo", "mem_val_hi", "initial_regs",
)


def pack_trace_columns(trace, initial_regs, num_vars: int, p: int = P) -> dict:
    """Native trace columns -> padded compact numpy arrays.

    Padding to 2^v: pc repeats its last value (witness.zig:79-91); the
    register write columns pad with wr_idx = 0, "no write", so the forward
    fill carries each register's last value (witness.zig:113-123);
    instruction and memory columns pad with zero (witness.zig:173-182,
    :248-253).  u64 columns are split into uint32 (lo, hi) halves; the
    initial registers are reduced mod ``p``."""
    cols = trace.columns
    n = trace.step_count()
    padded = 1 << num_vars
    if n > padded:
        raise ValueError(f"{n} steps do not fit 2^{num_vars} rows")

    def pad_last(arr):
        out = np.zeros(padded, dtype=arr.dtype)
        out[:n] = arr
        if padded > n and n > 0:
            out[n:] = arr[n - 1]
        return out

    def pad_zero(arr, dtype=None):
        out = np.zeros(padded, dtype=dtype or arr.dtype)
        out[:n] = arr
        return out

    def split64(arr):
        a = np.asarray(arr, dtype=np.uint64)
        return (a & _M32).astype(np.uint32), (a >> np.uint64(32)).astype(np.uint32)

    pc_lo, pc_hi = split64(pad_last(np.asarray(cols["pc"], dtype=np.uint64)))
    # imm is a sign-extended immediate of at most 32 bits, bitcast to u64:
    # its high half follows from bit 31 of the low half, rebuilt on device.
    imm_lo, _ = split64(pad_zero(np.asarray(cols["imm"]).astype(np.uint64)))
    wr_val_lo, wr_val_hi = split64(pad_zero(np.asarray(cols["reg_write_val"], dtype=np.uint64)))
    has_mem = np.asarray(cols["mem_flag"]) != 0
    mem_addr_lo, mem_addr_hi = split64(pad_zero(np.where(has_mem, cols["mem_addr"], 0).astype(np.uint64)))
    mem_val_lo, mem_val_hi = split64(pad_zero(np.where(has_mem, cols["mem_val"], 0).astype(np.uint64)))
    regs = np.asarray(initial_regs, dtype=np.uint64) % np.uint64(p)  # exact on uint64
    return {
        "pc_lo": pc_lo, "pc_hi": pc_hi,
        # Instruction fields fit u8: opcode < 128, registers < 32, funct7 < 128.
        "opcode": pad_zero(np.asarray(cols["opcode"]).astype(np.uint8)),
        "rd": pad_zero(np.asarray(cols["rd"]).astype(np.uint8)),
        "rs1": pad_zero(np.asarray(cols["rs1"]).astype(np.uint8)),
        "rs2": pad_zero(np.asarray(cols["rs2"]).astype(np.uint8)),
        "funct3": pad_zero(np.asarray(cols["funct3"]).astype(np.uint8)),
        "funct7": pad_zero(np.asarray(cols["funct7"]).astype(np.uint8)),
        "imm_lo": imm_lo,
        "wr_idx": pad_zero(np.asarray(cols["reg_write_idx"]).astype(np.uint8)),
        "wr_val_lo": wr_val_lo, "wr_val_hi": wr_val_hi,
        "mem_flag": pad_zero(np.asarray(cols["mem_flag"]).astype(np.uint8)),
        "mem_addr_lo": mem_addr_lo, "mem_addr_hi": mem_addr_hi,
        "mem_val_lo": mem_val_lo, "mem_val_hi": mem_val_hi,
        "initial_regs": regs if mle.is_wide(p) else regs.astype(np.uint32),
    }


def _upload(packed: dict, device: torch.device) -> dict:
    """numpy columns -> int64 device tensors (uint32 travels as int32 bits,
    uint64 as int64 bits)."""
    out = {}
    for key, arr in packed.items():
        if arr.dtype == np.uint64:
            out[key] = torch.from_numpy(np.ascontiguousarray(arr).view(np.int64)).to(device)
        elif key in _U32_COLUMNS:
            t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int32)).to(device)
            out[key] = t.to(torch.int64) & 0xFFFFFFFF
        else:
            out[key] = torch.from_numpy(np.ascontiguousarray(arr)).to(device).to(torch.int64)
    return out


def _mod_u64(lo: torch.Tensor, hi: torch.Tensor, p: int) -> torch.Tensor:
    """(lo + 2^32 hi) mod p of the unsigned u64 value, from int64 halves in
    [0, 2^32).  (hi % p) * (2^32 % p) < p^2 < 2^62, plus lo % p < p."""
    return (lo % p + (hi % p) * ((1 << 32) % p)) % p


def _mod_u64_wide(lo: torch.Tensor, hi: torch.Tensor, p: int) -> torch.Tensor:
    """(lo + 2^32 hi) mod p of the unsigned u64 value, from int64 halves in
    [0, 2^32), for a field of ``mle.WIDE_MODULI`` -> int64 holding the
    canonical value's u64 bits.  Exact for values of 2^63 and more: no
    int64 product wraps and no ``%`` sees a negative int64.

    Goldilocks: v >= p only when hi = 2^32 - 1 and lo >= 1, and then
    v - p = lo - 1.  Mersenne61: (v & p) + (v >> 61), then one conditional
    subtract; both terms come straight from the halves."""
    if p == GOLDILOCKS_P:
        return torch.where((hi == 0xFFFFFFFF) & (lo >= 1), lo - 1, from_halves(hi, lo))
    v = (((hi & ((1 << 29) - 1)) << 32) | lo) + (hi >> 29)  # < 2^61 + 8
    return torch.where(v >= p, v - p, v)


def _slice_columns(packed: dict, first: int, count: int, p: int) -> dict:
    """The packed columns of steps ``first .. first + count`` as a trace of
    their own: every per-step column is cut, and ``initial_regs`` becomes the
    register file as it stands BEFORE step ``first`` (the value of the last
    write to each register at an earlier step, else its initial value), so
    the forward fill of the slice carries the right value into a register
    that is never written inside it.  Computed from the host columns, which
    every rank holds whole."""
    out = {key: (arr if key == "initial_regs" else arr[first : first + count])
           for key, arr in packed.items()}
    regs = packed["initial_regs"].copy()
    if first:
        idx = packed["wr_idx"][:first]
        for r in range(1, 32):
            hits = np.flatnonzero(idx == r)
            if hits.size:
                t = int(hits[-1])
                lo, hi = int(packed["wr_val_lo"][t]), int(packed["wr_val_hi"][t])
                regs[r] = (lo + (hi << 32)) % p
    out["initial_regs"] = regs
    return out


def build_witness(trace, initial_regs, num_vars: int, device, group=None, p: int = P) -> torch.Tensor:
    """Native columnar trace -> (43, 2^v) witness on ``device``, canonical
    mod ``p`` (the field's modulus): int32 below 2^31, int64 u64 bits over a
    field of ``mle.WIDE_MODULI``.

    Under a ``group`` (parallel/multihost.py ``TraceGroup``) every rank
    builds its CONTIGUOUS columns ``[rank * N/D, (rank + 1) * N/D)`` only and
    returns that (43, N/D) slice; a slice of fewer than 2 steps raises."""
    device = resolve_device(device)
    wide = mle.is_wide(mle.check_device_modulus(p))
    packed = pack_trace_columns(trace, initial_regs, num_vars, p)
    n = 1 << num_vars
    if group is not None:
        if wide:
            raise ValueError(f"the group path of the witness takes fields below 2^31, not p = {p}")
        if group.device != device:
            raise ValueError(f"group on {group.device}, witness on {device}")
        n = check_slice_width(n, group.world_size)
        packed = _slice_columns(packed, group.rank * n, n, p)
    d = _upload(packed, device)

    mod_u64 = _mod_u64_wide if wide else _mod_u64
    imm_hi = (d["imm_lo"] >> 31) * 0xFFFFFFFF  # sign extension of bit 31
    wr_val = mod_u64(d["wr_val_lo"], d["wr_val_hi"], p)

    out = torch.empty((NUM_ROWS, n), dtype=torch.int64 if wide else torch.int32, device=device)
    out[0] = mod_u64(d["pc_lo"], d["pc_hi"], p)

    # Registers: row r at step t holds the value of the last write to r at a
    # step <= t, or r's initial value when there was none; x0 is zero.
    # A pass fills as many registers as keep its int64 transients at 2^27
    # values (1 GiB) each: all 32 up to 2^22 steps, 4 at 2^25.
    steps = torch.arange(n, dtype=torch.int64, device=device)
    per_pass = max(1, min(32, _FILL_VALUES // n))
    for r0 in range(0, 32, per_pass):
        regs = torch.arange(r0, r0 + per_pass, dtype=torch.int64, device=device)[:, None]
        written_at = torch.where(d["wr_idx"][None, :] == regs, steps[None, :], -1)  # (per_pass, n)
        last = torch.cummax(written_at, dim=1).values
        del written_at
        out[1 + r0 : 1 + r0 + per_pass] = torch.where(
            last >= 0, wr_val[last.clamp_min(0)], d["initial_regs"][r0 : r0 + per_pass, None])
    out[1] = 0

    for row, key in enumerate(("opcode", "rd", "rs1", "rs2", "funct3", "funct7"), start=33):
        out[row] = d[key] if wide else d[key] % p  # below 2^7: a wide p never reduces them
    out[39] = mod_u64(d["imm_lo"], imm_hi, p)
    out[40] = mod_u64(d["mem_addr_lo"], d["mem_addr_hi"], p)
    out[41] = mod_u64(d["mem_val_lo"], d["mem_val_hi"], p)
    out[42] = d["mem_flag"] == 1
    return out


def check_slice_width(n: int, world_size: int) -> int:
    """N / D, the steps a rank holds; fewer than 2 cannot be sharded."""
    per = n // world_size
    if per < 2 or per * world_size != n:
        raise ValueError(f"{n} steps over {world_size} ranks leave {n / world_size:g} a rank: "
                         "a rank needs at least 2")
    return per


def from_numpy(matrix: np.ndarray, device, p: int = P) -> torch.Tensor:
    """A (43, 2^v) witness from the host, canonical mod ``p``: uint32 below
    2^31 (for example the JAX package's ``np.asarray(build_witness_device(...))``)
    -> the port's int32 tensor on ``device``; uint64 over a field of
    ``mle.WIDE_MODULI`` (``WitnessGenerator``'s matrix) -> its int64 tensor
    of u64 bits."""
    arr = np.ascontiguousarray(matrix)
    if not arr.flags.writeable:  # a JAX array's host view is read-only
        arr = arr.copy()
    wide = mle.is_wide(mle.check_device_modulus(p))
    dtype = np.uint64 if wide else np.uint32
    if arr.dtype != dtype or arr.ndim != 2:
        raise ValueError(f"expected a 2-D {np.dtype(dtype)} array for p = {p}, got {arr.dtype} {arr.shape}")
    if arr.size and int(arr.max()) >= p:  # the max of an unsigned array, exact
        raise ValueError("witness values must be canonical (< p)")
    return torch.from_numpy(arr.view(np.int64 if wide else np.int32)).to(resolve_device(device))
