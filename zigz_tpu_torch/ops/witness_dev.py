"""The 43-row v1 witness built on the device from the native VM's columns.

Counterpart of zigz_tpu/ops/witness_dev.py.  The host packs nothing: it
hands over the native trace's columns as the VM wrote them, ``num_steps``
entries each (views, no copy), and copies them to the device in their own
dtypes, u64 as int64 bits and u8 as uint8.  The device builds the rows:

* kernel W1 (csrc/witness_kernels.cu over csrc/witness.cuh,
  :func:`witness_rows`) writes rows 0 and 33-42 and the reduced write value
  and write index in one pass: the UNSIGNED u64 -> mod-p reduction, the
  padding to 2^v (pc repeats the trace's last pc, every other row zero) and
  the masking of the memory rows by ``mem_flag``, which the JAX package's
  host ``pack_trace_columns`` and ``_build_witness_jit`` did between them;
* the 32 register rows by forward-filling the per-step write deltas: a
  ``torch.cummax`` of the last-write step index per register, then a
  gather (the JAX package uses ``lax.associative_scan``).

Output: (43, 2^v) canonical values in the commitment row order of
constraints/witness.py (0 = pc, 1..32 = x0..x31, 33..39 = opcode, rd, rs1,
rs2, funct3, funct7, imm, 40..42 = mem addr, value, is_read).

The modulus ``p`` is the field's (``F.MODULUS``, BabyBear's by default).
Below 2^31 (:func:`mle.check_modulus`) the values are int32 words.  Over
the two 64-bit fields (``mle.WIDE_MODULI``, Goldilocks and Mersenne61)
they are int64 words holding the canonical value's u64 bits, a Goldilocks
value of 2^63 or more a negative int64 (:func:`_mod_u64_wide`); the group
path (``_slice_columns``) stays BabyBear-only, as the sharded prove is.

Dispatch of W1: a CPU tensor takes its plain version
(:func:`_witness_rows_plain`); a CUDA tensor launches the kernel or
raises.  There is no fallback from one to the other.  ``ROWS`` counts the
kernel's launches and the real steps they covered.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..device import resolve_device, synchronize
from ..utils.profiling import counter_table, span
from .babybear import P
from . import _build, mle
from .field64 import GOLDILOCKS_P, from_halves

__all__ = ["build_witness", "witness_rows", "from_numpy", "check_slice_width", "NUM_ROWS", "U64_COLUMNS",
           "U8_COLUMNS", "UPLOADED", "ROWS"]

NUM_ROWS = 43
_FILL_VALUES = 1 << 27  # int64 values per transient of the register forward fill
_M32 = 0xFFFFFFFF
# The trace's columns that W1 reads, in the order of its launcher's arrays.
U64_COLUMNS = ("pc", "imm", "reg_write_val", "mem_addr", "mem_val")
U8_COLUMNS = ("opcode", "rd", "rs1", "rs2", "funct3", "funct7", "reg_write_idx", "mem_flag")
_SMALL_ROW = 33  # opcode's row; rd .. funct7 follow
_ALIGN = {torch.int64: 16, torch.uint8: 4}  # W1's vector loads of a column
UPLOADED = counter_table("witness_upload", ["bytes"])  # host bytes copied to the device
# W1's launches and the real trace steps they covered; the plain version does not count.
ROWS = counter_table("witness_rows", ["launches", "steps"])


def _trace_columns(trace, num_vars: int) -> tuple:
    """The native trace's columns that W1 reads, as the VM wrote them: numpy
    views of their first ``num_steps`` entries (u64 columns uint64, imm
    int64, the rest uint8; :func:`witness_rows` refuses other dtypes), the
    step count and the last pc (0 for an empty trace)."""
    n_real = trace.step_count()
    if n_real > 1 << num_vars:
        raise ValueError(f"{n_real} steps do not fit 2^{num_vars} rows")
    cols = {key: np.asarray(trace.columns[key])[:n_real] for key in U64_COLUMNS + U8_COLUMNS}
    return cols, n_real, int(cols["pc"][-1]) if n_real else 0


def _upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A numpy column -> its device tensor, uint64 as int64 bits, any other
    dtype as it is.  A copy from pageable host memory returns once the host
    has staged it, so the host's time here is the copies'."""
    UPLOADED["bytes"] += arr.nbytes
    return torch.from_numpy(arr.view(np.int64) if arr.dtype == np.uint64 else arr).to(device)


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


def _witness_rows_plain(cols: dict, n_real: int, last_pc: int, out: torch.Tensor, p: int) -> tuple:
    """Plain version of W1: the same rows of ``out`` from the same raw
    columns, the u64 values reduced from their int64 halves, in torch ops
    on ``out``'s device (the wrapper takes it for CPU tensors only)."""
    n = out.shape[1]
    mod = _mod_u64_wide if mle.is_wide(p) else _mod_u64

    def reduce(x: torch.Tensor) -> torch.Tensor:  # int64 u64 bits (or u8) -> canonical int64
        x = x.to(torch.int64)
        return mod(x & _M32, (x >> 32) & _M32, p)

    real = {key: col[:n_real] for key, col in cols.items()}
    has_mem = real["mem_flag"] != 0
    out[0, :n_real] = reduce(real["pc"])
    last = torch.tensor([last_pc - (1 << 64) if last_pc >= 1 << 63 else last_pc], device=out.device)  # int64 bits
    out[0, n_real:] = reduce(last)
    for row, key in enumerate(U8_COLUMNS[:6], start=_SMALL_ROW):
        out[row, :n_real] = reduce(real[key])
    out[39, :n_real] = reduce(real["imm"])
    out[40, :n_real] = torch.where(has_mem, reduce(real["mem_addr"]), 0)
    out[41, :n_real] = torch.where(has_mem, reduce(real["mem_val"]), 0)
    out[42, :n_real] = real["mem_flag"] == 1
    out[_SMALL_ROW:, n_real:] = 0
    wr_val = torch.zeros(n, dtype=out.dtype, device=out.device)
    wr_val[:n_real] = reduce(real["reg_write_val"])
    wr_idx = torch.zeros(n, dtype=torch.uint8, device=out.device)
    wr_idx[:n_real] = real["reg_write_idx"]
    return wr_val, wr_idx


def witness_rows(cols: dict, n_real: int, last_pc: int, out: torch.Tensor, p: int) -> tuple:
    """Rows 0 and 33-42 of ``out`` ((43, n), int32 below 2^31, int64 u64
    bits over a 64-bit field) from the trace's raw columns ``cols`` (the
    keys of ``U64_COLUMNS``, int64, and ``U8_COLUMNS``, uint8, each of at
    least ``n_real`` entries, on ``out``'s device); steps past ``n_real``
    are padding, pc ``last_pc`` and the rest zero.  Returns the reduced
    write value (n,) in ``out``'s dtype and the write index (n,) uint8, 0
    past ``n_real``, for the register fill.  One launch of W1 on the card."""
    wide = mle.is_wide(mle.check_device_modulus(p))
    n = out.shape[1] if out.dim() == 2 else -1
    if out.dim() != 2 or out.shape[0] != NUM_ROWS or out.dtype != (torch.int64 if wide else torch.int32):
        raise ValueError(f"witness_rows: expected ({NUM_ROWS}, n) {'int64' if wide else 'int32'} rows for p = {p}, "
                         f"got {tuple(out.shape)} {out.dtype}")
    if not 0 <= n_real <= n or not 0 <= last_pc < 1 << 64:
        raise ValueError(f"witness_rows: {n_real} real steps of {n}, last pc {last_pc}")
    for key in U64_COLUMNS + U8_COLUMNS:
        col = cols[key]
        dtype = torch.uint8 if key in U8_COLUMNS else torch.int64
        if col.dtype != dtype or col.dim() != 1 or col.shape[0] < n_real or col.device != out.device:
            raise ValueError(f"witness_rows: column {key} must be 1-D {dtype} of at least {n_real} entries on "
                             f"{out.device}, got {col.dtype} {tuple(col.shape)} on {col.device}")
    if out.device.type == "cpu":
        return _witness_rows_plain(cols, n_real, last_pc, out, p)
    if out.device.type != "cuda":
        raise ValueError(f"witness_rows: unsupported device {out.device}")
    if not out.is_contiguous() or any(not cols[k].is_contiguous() or cols[k].data_ptr() % _ALIGN[cols[k].dtype]
                                      for k in U64_COLUMNS + U8_COLUMNS):
        raise ValueError("witness_rows: expected contiguous columns aligned to 16 (int64) and 4 (uint8) bytes")
    _build.load()  # build, or raise, before anything touches the card
    wr_val = torch.empty(n, dtype=out.dtype, device=out.device)
    wr_idx = torch.empty(n, dtype=torch.uint8, device=out.device)
    u64 = (ctypes.c_void_p * len(U64_COLUMNS))(*(cols[k].data_ptr() for k in U64_COLUMNS))
    u8 = (ctypes.c_void_p * len(U8_COLUMNS))(*(cols[k].data_ptr() for k in U8_COLUMNS))
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        _build.launch("zigz_witness_rows", u64, u8, n_real, n, last_pc, p, out.data_ptr(), wr_val.data_ptr(),
                      wr_idx.data_ptr(), stream)
    ROWS["launches"] += 1
    ROWS["steps"] += n_real
    return wr_val, wr_idx


def _fill_registers(out: torch.Tensor, wr_val: torch.Tensor, wr_idx: torch.Tensor, regs: torch.Tensor) -> None:
    """Rows 1-32: row r at step t holds the value of the last write to r at
    a step <= t, or r's initial value (``regs``, canonical, ``out``'s dtype)
    when there was none; x0 is zero.  A pass fills as many registers as keep
    its int64 transients at 2^27 values (1 GiB) each: all 32 up to 2^22
    steps, 4 at 2^25."""
    n = out.shape[1]
    steps = torch.arange(n, dtype=torch.int64, device=out.device)
    per_pass = max(1, min(32, _FILL_VALUES // n))
    for r0 in range(0, 32, per_pass):
        ids = torch.arange(r0, r0 + per_pass, dtype=torch.int64, device=out.device)[:, None]
        written_at = torch.where(wr_idx[None, :] == ids, steps[None, :], -1)  # (per_pass, n)
        last = torch.cummax(written_at, dim=1).values
        del written_at
        out[1 + r0 : 1 + r0 + per_pass] = torch.where(last >= 0, wr_val[last.clamp_min(0)],
                                                      regs[r0 : r0 + per_pass, None])
    out[1] = 0


def _slice_columns(cols: dict, n_real: int, regs: np.ndarray, first: int, count: int, p: int) -> tuple:
    """Steps ``first .. first + count`` of the padded trace as a trace of
    their own: views of the real steps among them (none where the slice
    lies past the trace's end), their count, and the register file as it
    stands BEFORE step ``first`` (the value of the last write to each
    register at an earlier step, else its initial value), so the forward
    fill of the slice carries the right value into a register that is never
    written inside it.  Computed from the host columns, which every rank
    holds whole; the padding's pc stays the whole trace's last pc."""
    lo, hi = min(first, n_real), min(first + count, n_real)
    regs = regs.copy()
    idx = cols["reg_write_idx"][:lo]
    for r in range(1, 32):
        hits = np.flatnonzero(idx == r)
        if hits.size:
            regs[r] = cols["reg_write_val"][hits[-1]] % np.uint64(p)
    return {key: arr[lo:hi] for key, arr in cols.items()}, hi - lo, regs


def build_witness(trace, initial_regs, num_vars: int, device, group=None, p: int = P) -> torch.Tensor:
    """Native columnar trace -> (43, 2^v) witness on ``device``, canonical
    mod ``p`` (the field's modulus): int32 below 2^31, int64 u64 bits over a
    field of ``mle.WIDE_MODULI``.  Returns once the device has built it, in
    three spans: ``pack`` (the host's views of the columns and the initial
    registers mod p), ``upload`` (the copies) and ``build`` (W1 and the
    register fill, to a synchronize).

    Under a ``group`` (parallel/multihost.py ``TraceGroup``) every rank
    builds its CONTIGUOUS columns ``[rank * N/D, (rank + 1) * N/D)`` only and
    returns that (43, N/D) slice; a slice of fewer than 2 steps raises."""
    device = resolve_device(device)
    wide = mle.is_wide(mle.check_device_modulus(p))
    n = 1 << num_vars
    if group is not None:
        if wide:
            raise ValueError(f"the group path of the witness takes fields below 2^31, not p = {p}")
        if group.device != device:
            raise ValueError(f"group on {group.device}, witness on {device}")
        n = check_slice_width(n, group.world_size)
    with span("pack"):
        cols, n_real, last_pc = _trace_columns(trace, num_vars)
        regs = np.asarray(initial_regs, dtype=np.uint64) % np.uint64(p)  # exact on uint64
        if group is not None:
            cols, n_real, regs = _slice_columns(cols, n_real, regs, group.rank * n, n, p)
    with span("upload"):
        d = {key: _upload(arr, device) for key, arr in cols.items()}
        d_regs = _upload(regs.view(np.int64) if wide else regs.astype(np.int32), device)
    with span("build"):
        out = torch.empty((NUM_ROWS, n), dtype=torch.int64 if wide else torch.int32, device=device)
        wr_val, wr_idx = witness_rows(d, n_real, last_pc, out, p)
        _fill_registers(out, wr_val, wr_idx, d_regs)
        synchronize(device)
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
    UPLOADED["bytes"] += arr.nbytes
    return torch.from_numpy(arr.view(np.int64 if wide else np.int32)).to(resolve_device(device))
