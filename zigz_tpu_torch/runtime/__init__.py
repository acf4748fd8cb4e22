"""Native runtime: threaded batch SHA3 for Merkle construction.

Builds ``libzigz_sha3.so`` from sha3.cpp on first import (cached next to the
source) and installs it as the hashing backend of
commitments.merkle.  Falls back silently to the pure-Python
backend if no C++ toolchain is available.  The native output is validated
against hashlib at load time (self-test) and continuously by the test
suite — any mismatch would break proof bytes, so we refuse to install a
backend that fails the self-test.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import tempfile

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "sha3.cpp")
_LIB = os.path.join(_HERE, "libzigz_sha3.so")

_lib = None
# Keccak benefits from SMT: ~1.3x at 2x threads-per-core on this workload.
NUM_THREADS = min(2 * (os.cpu_count() or 1), 16)


def _compile(flags, src: str, lib: str) -> bool:
    """``g++ src -> lib`` through a temporary name in the library's own
    directory and an atomic rename, so that processes that build at the same
    time (test workers) never load a half-written library."""
    fd, tmp = tempfile.mkstemp(prefix=".build-", suffix=".so", dir=os.path.dirname(lib))
    os.close(fd)
    try:
        result = subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", *flags, src, "-o", tmp],
            capture_output=True,
            timeout=300,
        )
        if result.returncode != 0:
            return False
        os.replace(tmp, lib)
        return True
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _build() -> bool:
    try:
        if os.path.exists(_LIB) and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC):
            return True
        return _compile(["-pthread"], _SRC, _LIB)
    except Exception:
        return False


def _self_test(lib) -> bool:
    vals = np.array([0, 1, 0x1000, (1 << 64) - 1], dtype=np.uint64)
    out = np.empty(len(vals) * 32, dtype=np.uint8)
    lib.zigz_sha3_leaves_u64(
        vals.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_size_t(len(vals)),
        out.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int(1),
    )
    got = out.tobytes()
    for i, v in enumerate(vals):
        expected = hashlib.sha3_256(int(v).to_bytes(8, "little")).digest()
        if got[i * 32 : (i + 1) * 32] != expected:
            return False
    # merge self-test
    pair = got[:64]
    mout = np.empty(32, dtype=np.uint8)
    buf = np.frombuffer(pair, dtype=np.uint8)
    lib.zigz_sha3_merge(
        buf.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_size_t(1),
        mout.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int(1),
    )
    return mout.tobytes() == hashlib.sha3_256(pair).digest()


def _load():
    global _lib
    if not _build():
        return None
    try:
        lib = ctypes.CDLL(_LIB)
    except OSError:
        return None
    for name in ("zigz_sha3_leaves_u64", "zigz_sha3_merge", "zigz_sha3_batch",
                 "zigz_sha3_tree", "zigz_sha3_long_batch",
                 "zigz_sha3_matrix_columns", "zigz_sha3_matrix_columns_u32le"):
        getattr(lib, name).restype = None
    if not _self_test(lib):
        sys.stderr.write("zigz_tpu_torch.runtime: native SHA3 failed self-test; using Python backend\n")
        return None
    _lib = lib
    return lib


def native_batch_leaf_hashes(values: np.ndarray) -> bytes:
    vals = np.ascontiguousarray(values, dtype=np.uint64)
    out = np.empty(len(vals) * 32, dtype=np.uint8)
    _lib.zigz_sha3_leaves_u64(
        vals.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_size_t(len(vals)),
        out.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int(NUM_THREADS),
    )
    return out.tobytes()


def native_batch_merge_hashes(level: bytes) -> bytes:
    n = len(level) // 64
    buf = np.frombuffer(level, dtype=np.uint8)
    out = np.empty(n * 32, dtype=np.uint8)
    _lib.zigz_sha3_merge(
        buf.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_size_t(n),
        out.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int(NUM_THREADS),
    )
    return out.tobytes()


def native_batch_build_levels(leaf_bytes: bytes):
    """All internal tree levels in one native call (zigz_sha3_tree)."""
    n = len(leaf_bytes) // 32
    if n <= 1:
        return [leaf_bytes]
    leaves = np.frombuffer(leaf_bytes, dtype=np.uint8)
    total_internal = n - 1  # n/2 + n/4 + ... + 1
    out = np.empty(total_internal * 32, dtype=np.uint8)
    _lib.zigz_sha3_tree(
        leaves.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_size_t(n),
        out.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int(NUM_THREADS),
    )
    blob = out.tobytes()
    levels = [leaf_bytes]
    offset = 0
    level_n = n // 2
    while level_n >= 1:
        levels.append(blob[offset * 32 : (offset + level_n) * 32])
        offset += level_n
        if level_n == 1:
            break
        level_n //= 2
    return levels


def install() -> bool:
    """Build+load the native library and register it as the Merkle hashing
    backend.  Returns True when the native backend is active."""
    if _lib is None and _load() is None:
        return False
    from ..commitments import merkle

    merkle.set_hash_backend(
        native_batch_leaf_hashes, native_batch_merge_hashes, native_batch_build_levels
    )
    return True


NATIVE_AVAILABLE = install()


# ---------------------------------------------------------------------------
# Optional: batch XXH3 Lasso-query hashing (lasso_hash.cpp).  Needs the
# canonical xxhash.h, found among installed packages' vendored headers.
# ---------------------------------------------------------------------------

_LASSO_SRC = os.path.join(_HERE, "lasso_hash.cpp")
_LASSO_LIB = os.path.join(_HERE, "libzigz_lasso.so")
_lasso_lib = None


def _find_xxhash_include():
    vendored = os.path.join("pyarrow", "include", "arrow", "vendored", "xxhash")
    for path in [os.path.join(entry, vendored) for entry in sys.path if entry] + ["/usr/include"]:
        if os.path.exists(os.path.join(path, "xxhash.h")):
            return path
    return None


def _load_lasso():
    global _lasso_lib
    if _lasso_lib is not None:
        return _lasso_lib
    try:
        if not (
            os.path.exists(_LASSO_LIB)
            and os.path.getmtime(_LASSO_LIB) >= os.path.getmtime(_LASSO_SRC)
        ):
            include = _find_xxhash_include()
            if include is None:
                return None
            if not _compile([f"-I{include}"], _LASSO_SRC, _LASSO_LIB):
                return None
        lib = ctypes.CDLL(_LASSO_LIB)
        lib.zigz_lasso_hash_rows.restype = None
        lib.zigz_operand_values.restype = None
        # Self-test against the python xxhash module.
        import xxhash as _xx

        ins = np.array([[3, 5]], dtype=np.uint64)
        outs = np.array([[8]], dtype=np.uint64)
        res = np.zeros(1, dtype=np.uint64)
        lib.zigz_lasso_hash_rows(
            ins.ctypes.data_as(ctypes.c_void_p), outs.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_size_t(1), ctypes.c_size_t(2), ctypes.c_size_t(1),
            ctypes.c_uint64(2013265921), res.ctypes.data_as(ctypes.c_void_p),
        )
        h = 0
        for v in (3, 5, 8):
            h ^= v
            h = _xx.xxh3_64_intdigest(h.to_bytes(8, "little"), seed=0)
        if int(res[0]) != h % 2013265921:
            return None
        _lasso_lib = lib
        return lib
    except Exception:
        return None


def native_operand_values(write_idx, write_val, initial_regs, rs1, rs2, rd):
    """(rs1_val, rs2_val, rd_after) via one native replay of the write log,
    or None when the native lib is unavailable."""
    lib = _load_lasso()
    if lib is None:
        return None
    n = len(write_idx)
    widx = np.ascontiguousarray(write_idx, dtype=np.uint8)
    wval = np.ascontiguousarray(write_val, dtype=np.uint64)
    init = np.ascontiguousarray(initial_regs, dtype=np.uint64)
    r1 = np.ascontiguousarray(rs1, dtype=np.uint8)
    r2 = np.ascontiguousarray(rs2, dtype=np.uint8)
    rdd = np.ascontiguousarray(rd, dtype=np.uint8)
    rs1_val = np.empty(n, dtype=np.uint64)
    rs2_val = np.empty(n, dtype=np.uint64)
    rd_after = np.empty(n, dtype=np.uint64)
    lib.zigz_operand_values(
        widx.ctypes.data_as(ctypes.c_void_p), wval.ctypes.data_as(ctypes.c_void_p),
        init.ctypes.data_as(ctypes.c_void_p),
        r1.ctypes.data_as(ctypes.c_void_p), r2.ctypes.data_as(ctypes.c_void_p),
        rdd.ctypes.data_as(ctypes.c_void_p), ctypes.c_size_t(n),
        rs1_val.ctypes.data_as(ctypes.c_void_p), rs2_val.ctypes.data_as(ctypes.c_void_p),
        rd_after.ctypes.data_as(ctypes.c_void_p),
    )
    return rs1_val, rs2_val, rd_after


def native_lasso_hash_rows(inputs, outputs, modulus):
    """Vectorized XXH3 chain (or None when the native lib is unavailable)."""
    lib = _load_lasso()
    if lib is None:
        return None
    ins = np.ascontiguousarray(inputs, dtype=np.uint64)
    outs = np.ascontiguousarray(outputs, dtype=np.uint64)
    n = ins.shape[0]
    res = np.empty(n, dtype=np.uint64)
    lib.zigz_lasso_hash_rows(
        ins.ctypes.data_as(ctypes.c_void_p), outs.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_size_t(n), ctypes.c_size_t(ins.shape[1]), ctypes.c_size_t(outs.shape[1]),
        ctypes.c_uint64(modulus), res.ctypes.data_as(ctypes.c_void_p),
    )
    return res


# ---------------------------------------------------------------------------
# Optional: threaded NTT row encoding (ntt.cpp) for the Ligero PCS.
# ---------------------------------------------------------------------------

_NTT_SRC = os.path.join(_HERE, "ntt.cpp")
_NTT_LIB = os.path.join(_HERE, "libzigz_ntt.so")
_ntt_lib = None
_ntt_checked = False


def _load_ntt():
    global _ntt_lib, _ntt_checked
    if _ntt_checked:
        return _ntt_lib
    _ntt_checked = True
    try:
        if not (
            os.path.exists(_NTT_LIB)
            and os.path.getmtime(_NTT_LIB) >= os.path.getmtime(_NTT_SRC)
        ):
            if not _compile(["-pthread"], _NTT_SRC, _NTT_LIB):
                return None
        lib = ctypes.CDLL(_NTT_LIB)
        lib.zigz_ntt_rows.restype = None
        if hasattr(lib, "zigz_ntt_rows32"):
            lib.zigz_ntt_rows32.restype = None
        _ntt_lib = lib
        return lib
    except Exception:
        return None


def native_ntt_rows(rows: np.ndarray, n_out: int, twiddles_flat: np.ndarray,
                    bitrev: np.ndarray):
    """(rows, n_in) -> (rows, n_out) NTT per row, or None when the native
    lib is unavailable.  twiddles_flat/bitrev come from the caller's cache
    (commitments/ligero.py) so both backends share one table source."""
    lib = _load_ntt()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, dtype=np.uint64)
    tw = np.ascontiguousarray(twiddles_flat, dtype=np.uint64)
    br = np.ascontiguousarray(bitrev, dtype=np.int64)
    nrows, n_in = rows.shape
    out = np.empty((nrows, n_out), dtype=np.uint64)
    lib.zigz_ntt_rows(
        rows.ctypes.data_as(ctypes.c_void_p), ctypes.c_size_t(nrows),
        ctypes.c_size_t(n_in), out.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_size_t(n_out), tw.ctypes.data_as(ctypes.c_void_p),
        br.ctypes.data_as(ctypes.c_void_p), ctypes.c_int(NUM_THREADS),
    )
    return out


def native_ntt_rows32(rows: np.ndarray, n_out: int, twiddles_flat: np.ndarray,
                      bitrev: np.ndarray):
    """Like native_ntt_rows but stores the encoded output as uint32
    (canonical BabyBear values always fit) — same arithmetic, half the
    output memory.  Returns None when the native lib lacks the symbol."""
    lib = _load_ntt()
    if lib is None or not hasattr(lib, "zigz_ntt_rows32"):
        return None
    rows = np.ascontiguousarray(rows, dtype=np.uint64)
    tw = np.ascontiguousarray(twiddles_flat, dtype=np.uint64)
    br = np.ascontiguousarray(bitrev, dtype=np.int64)
    nrows, n_in = rows.shape
    out = np.empty((nrows, n_out), dtype=np.uint32)
    lib.zigz_ntt_rows32(
        rows.ctypes.data_as(ctypes.c_void_p), ctypes.c_size_t(nrows),
        ctypes.c_size_t(n_in), out.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_size_t(n_out), tw.ctypes.data_as(ctypes.c_void_p),
        br.ctypes.data_as(ctypes.c_void_p), ctypes.c_int(NUM_THREADS),
    )
    return out


def native_sha3_long_batch(msgs: np.ndarray):
    """SHA3-256 over the rows of a 2-D uint8 array (equal-length messages),
    or None when unavailable.  Self-tested against hashlib on first use."""
    global _long_batch_ok
    if _lib is None or not hasattr(_lib, "zigz_sha3_long_batch"):
        return None
    if "_long_batch_ok" not in globals():
        probe = np.frombuffer(bytes(range(256)) * 2, dtype=np.uint8).reshape(2, 256)
        out = np.empty(2 * 32, dtype=np.uint8)
        _lib.zigz_sha3_long_batch(
            probe.ctypes.data_as(ctypes.c_void_p), ctypes.c_size_t(256),
            ctypes.c_size_t(2), out.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_int(1),
        )
        _long_batch_ok = all(
            out.tobytes()[i * 32 : (i + 1) * 32]
            == hashlib.sha3_256(probe[i].tobytes()).digest()
            for i in range(2)
        )
    if not _long_batch_ok:
        return None
    msgs = np.ascontiguousarray(msgs, dtype=np.uint8)
    n, length = msgs.shape
    out = np.empty(n * 32, dtype=np.uint8)
    _lib.zigz_sha3_long_batch(
        msgs.ctypes.data_as(ctypes.c_void_p), ctypes.c_size_t(length),
        ctypes.c_size_t(n), out.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int(NUM_THREADS),
    )
    return out.tobytes()


def native_sha3_matrix_columns_u32le(matrix: np.ndarray):
    """Per-column SHA3-256 digests with the NARROW leaf preimage: each
    canonical value absorbed as a 4-byte LE word (the Ligero column-leaf
    encoding, protocol v2+; half the Keccak blocks of the u64 encoding).
    Returns None when unavailable."""
    if _lib is None or not hasattr(_lib, "zigz_sha3_matrix_columns_u32le"):
        return None
    if native_sha3_long_batch(np.zeros((1, 8), dtype=np.uint8)) is None:
        return None  # reuse the long-batch self-test gate
    matrix = np.ascontiguousarray(matrix, dtype=np.uint32)
    rows, n = matrix.shape
    out = np.empty(n * 32, dtype=np.uint8)
    _lib.zigz_sha3_matrix_columns_u32le(
        matrix.ctypes.data_as(ctypes.c_void_p), ctypes.c_size_t(rows),
        ctypes.c_size_t(n), out.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int(NUM_THREADS),
    )
    return out.tobytes()


def native_sha3_matrix_columns(matrix: np.ndarray):
    """Per-column SHA3-256 digests of a row-major (rows, n) matrix (no
    transpose copy), or None when unavailable.  uint32 matrices use the
    u32 entry point, which widens each value to the same LE u64 preimage
    bytes — digests are identical either way."""
    if _lib is None or not hasattr(_lib, "zigz_sha3_matrix_columns"):
        return None
    if native_sha3_long_batch(np.zeros((1, 8), dtype=np.uint8)) is None:
        return None  # reuse the long-batch self-test gate
    if matrix.dtype == np.uint32 and hasattr(_lib, "zigz_sha3_matrix_columns_u32"):
        matrix = np.ascontiguousarray(matrix, dtype=np.uint32)
        rows, n = matrix.shape
        out = np.empty(n * 32, dtype=np.uint8)
        _lib.zigz_sha3_matrix_columns_u32(
            matrix.ctypes.data_as(ctypes.c_void_p), ctypes.c_size_t(rows),
            ctypes.c_size_t(n), out.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_int(NUM_THREADS),
        )
        return out.tobytes()
    matrix = np.ascontiguousarray(matrix, dtype=np.uint64)
    rows, n = matrix.shape
    out = np.empty(n * 32, dtype=np.uint8)
    _lib.zigz_sha3_matrix_columns(
        matrix.ctypes.data_as(ctypes.c_void_p), ctypes.c_size_t(rows),
        ctypes.c_size_t(n), out.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int(NUM_THREADS),
    )
    return out.tobytes()


_p2_consts = None
_p2_ok = None


def _p2_constants():
    """ctypes-ready Poseidon2 constant arrays from the Python generator
    (core/poseidon2.py — the single source of truth)."""
    global _p2_consts
    if _p2_consts is None:
        from ..core import poseidon2 as p2

        _p2_consts = (
            np.ascontiguousarray(p2._RC_EXTERNAL, dtype=np.uint64),
            np.ascontiguousarray(p2._RC_INTERNAL, dtype=np.uint64),
            np.ascontiguousarray(p2._MU, dtype=np.uint64),
        )
    return _p2_consts


def _p2_selftest() -> bool:
    """One-time parity check of the native sponge vs the numpy twin."""
    global _p2_ok
    if _p2_ok is None:
        try:
            probe = np.arange(24, dtype=np.uint64).reshape(3, 8) * np.uint64(97)
            got = _p2_columns_raw(probe)
            from ..core import poseidon2 as p2

            want = bytearray()
            for j in range(probe.shape[1]):
                want += p2.hash_field_values([int(v) for v in probe[:, j]])
            _p2_ok = got == bytes(want)
        except Exception:
            _p2_ok = False
    return _p2_ok


def _p2_columns_raw(matrix: np.ndarray):
    rc_ext, rc_int, mu = _p2_constants()
    rows, n = matrix.shape
    out = np.empty(n * 32, dtype=np.uint8)
    if matrix.dtype == np.uint32:
        matrix = np.ascontiguousarray(matrix, dtype=np.uint32)
        fn = _lib.zigz_p2_matrix_columns_u32
    else:
        matrix = np.ascontiguousarray(matrix, dtype=np.uint64)
        fn = _lib.zigz_p2_matrix_columns
    fn(
        matrix.ctypes.data_as(ctypes.c_void_p), ctypes.c_size_t(rows),
        ctypes.c_size_t(n), rc_ext.ctypes.data_as(ctypes.c_void_p),
        rc_int.ctypes.data_as(ctypes.c_void_p),
        mu.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p), ctypes.c_int(NUM_THREADS),
    )
    return out.tobytes()


def native_p2_matrix_columns(matrix: np.ndarray):
    """Per-column Poseidon2 sponge digests of a row-major (rows, n)
    matrix (uint64 or uint32 storage), byte-identical to the numpy
    sponge in commitments/ligero._hash_columns; None when unavailable."""
    if _lib is None or not hasattr(_lib, "zigz_p2_matrix_columns"):
        return None
    if not _p2_selftest():
        return None
    return _p2_columns_raw(matrix)


def native_p2_merge(level: bytes):
    """Poseidon2 merges of consecutive 32-byte digest pairs (internal
    Merkle nodes), twin of core/poseidon2.np_batch_merge_hashes; None
    when unavailable."""
    if _lib is None or not hasattr(_lib, "zigz_p2_merge"):
        return None
    if not _p2_selftest():
        return None
    rc_ext, rc_int, mu = _p2_constants()
    k = len(level) // 64
    buf = np.frombuffer(level, dtype=np.uint8)
    out = np.empty(k * 32, dtype=np.uint8)
    _lib.zigz_p2_merge(
        buf.ctypes.data_as(ctypes.c_void_p), ctypes.c_size_t(k),
        rc_ext.ctypes.data_as(ctypes.c_void_p),
        rc_int.ctypes.data_as(ctypes.c_void_p),
        mu.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p), ctypes.c_int(NUM_THREADS),
    )
    return out.tobytes()


_id_stream_ok = None
_id_stream_buf = None


def native_lasso_id_stream(count: int, p: int):
    """The v1 Lasso phase's "LASSO_TABLE" + LE64(i % p) byte stream as one
    native buffer (a reused module-level scratch — consume before the next
    call), or None when unavailable.  Self-tested against the numpy
    construction on first use."""
    global _id_stream_ok, _id_stream_buf
    lib = _load_ntt()
    if lib is None or not hasattr(lib, "zigz_lasso_id_stream"):
        return None
    if _id_stream_ok is None:
        probe = np.empty(3 * 19, dtype=np.uint8)
        lib.zigz_lasso_id_stream(
            ctypes.c_uint64(3), ctypes.c_uint64(2), probe.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_int(1),
        )
        want = b"".join(
            b"LASSO_TABLE" + (i % 2).to_bytes(8, "little") for i in range(3)
        )
        _id_stream_ok = probe.tobytes() == want
    if not _id_stream_ok:
        return None
    # Reuse one scratch buffer: a fresh 80 MB np.empty page-faults ~0.3 s
    # at 2^22 rows, 40x the fill itself.
    if _id_stream_buf is None or _id_stream_buf.size < count * 19:
        _id_stream_buf = np.empty(count * 19, dtype=np.uint8)
    out = _id_stream_buf[: count * 19]
    lib.zigz_lasso_id_stream(
        ctypes.c_uint64(count), ctypes.c_uint64(p),
        out.ctypes.data_as(ctypes.c_void_p), ctypes.c_int(NUM_THREADS),
    )
    return out


def native_mod_vecmat(a: np.ndarray, matrix: np.ndarray, p: int):
    """out[j] = sum_i a[i]*M[i, j] mod p (128-bit accumulate), or None."""
    lib = _load_ntt()
    if lib is None or not hasattr(lib, "zigz_mod_vecmat"):
        return None
    a = np.ascontiguousarray(a, dtype=np.uint64)
    matrix = np.ascontiguousarray(matrix, dtype=np.uint64)
    K, n = matrix.shape
    out = np.empty(n, dtype=np.uint64)
    lib.zigz_mod_vecmat(
        a.ctypes.data_as(ctypes.c_void_p),
        matrix.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_size_t(K), ctypes.c_size_t(n), ctypes.c_uint64(p),
        out.ctypes.data_as(ctypes.c_void_p), ctypes.c_int(NUM_THREADS),
    )
    return out


def native_batch_inv(values: np.ndarray, p: int):
    """Montgomery batch inversion mod p (zeros map to zero), or None.
    Segmented across threads (one modpow per segment) when available."""
    lib = _load_ntt()
    if lib is None or not hasattr(lib, "zigz_batch_inv"):
        return None
    vals = np.ascontiguousarray(values, dtype=np.uint64)
    out = np.empty(vals.shape, dtype=np.uint64)
    if hasattr(lib, "zigz_batch_inv_mt"):
        lib.zigz_batch_inv_mt(
            vals.ctypes.data_as(ctypes.c_void_p), ctypes.c_size_t(vals.size),
            ctypes.c_uint64(p), out.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_int(NUM_THREADS),
        )
        return out
    lib.zigz_batch_inv(
        vals.ctypes.data_as(ctypes.c_void_p), ctypes.c_size_t(vals.size),
        ctypes.c_uint64(p), out.ctypes.data_as(ctypes.c_void_p),
    )
    return out


# ---------------------------------------------------------------------------
# Traced-combiner DAG executor (dag.cpp) — threaded zerocheck round sweeps
# over symtrace DAGs (ops/symtrace.py node opcodes).
# ---------------------------------------------------------------------------

_DAG_SRC = os.path.join(_HERE, "dag.cpp")
_DAG_LIB = os.path.join(_HERE, "libzigz_dag.so")
_dag_lib = None
_dag_checked = False


def _load_dag():
    global _dag_lib, _dag_checked
    if _dag_checked:
        return _dag_lib
    _dag_checked = True
    try:
        if not (
            os.path.exists(_DAG_LIB)
            and os.path.getmtime(_DAG_LIB) >= os.path.getmtime(_DAG_SRC)
        ):
            if not _compile(["-pthread"], _DAG_SRC, _DAG_LIB):
                return None
        lib = ctypes.CDLL(_DAG_LIB)
        lib.zigz_dag_round.restype = None
        lib.zigz_dag_fold.restype = None
        lib.zigz_dag_round_multi.restype = None
        lib.zigz_dag_fold_ext.restype = None
        lib.zigz_dag_fold_base_to_ext.restype = None
        lib.zigz_dag_fold_ext_to.restype = None
        _dag_lib = lib
        return lib
    except Exception:
        return None


def native_dag_available() -> bool:
    return _load_dag() is not None


def native_dag_round(stacked: np.ndarray, width: int, nodes, consts: np.ndarray,
                     out_slot: int, eq_row: int, degree: int):
    """One zerocheck round over a traced combiner DAG: returns
    [g(0), g(2), ..., g(degree)] as ints, or None when unavailable.

    ``stacked`` is the (nrows, stride) canonical uint32 table matrix (the
    current width occupies each row's prefix); ``nodes`` is the
    (ops, arg_a, arg_b, slot, col_row, num_slots) tuple prepared by
    ops/zerocheck_native.py."""
    lib = _load_dag()
    if lib is None:
        return None
    ops, arga, argb, slot, colrow, num_slots = nodes
    out = np.empty(degree, dtype=np.uint64)
    lib.zigz_dag_round(
        stacked.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_size_t(stacked.shape[1]), ctypes.c_size_t(stacked.shape[0]),
        ctypes.c_size_t(width),
        ops.ctypes.data_as(ctypes.c_void_p),
        arga.ctypes.data_as(ctypes.c_void_p),
        argb.ctypes.data_as(ctypes.c_void_p),
        slot.ctypes.data_as(ctypes.c_void_p),
        colrow.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_size_t(len(ops)), ctypes.c_size_t(num_slots),
        consts.ctypes.data_as(ctypes.c_void_p), ctypes.c_int32(out_slot),
        ctypes.c_int32(eq_row), ctypes.c_int(degree),
        out.ctypes.data_as(ctypes.c_void_p), ctypes.c_int(NUM_THREADS),
    )
    return [int(x) for x in out]


def native_dag_round_multi(stacked: np.ndarray, width: int, nodes,
                           consts: np.ndarray, out_slots, degree: int):
    """Extension-zerocheck round over a traced coordinate-lowered DAG:
    returns a (degree, num_out) list of lists [t][coord] for t in
    (0, 2, ..., degree), or None when unavailable.  No eq-row product —
    the eq*C multiplication lives inside the DAG (4 output slots)."""
    lib = _load_dag()
    if lib is None:
        return None
    ops, arga, argb, slot, colrow, num_slots = nodes
    num_out = len(out_slots)
    outs = np.asarray(out_slots, dtype=np.int32)
    out = np.empty(degree * num_out, dtype=np.uint64)
    lib.zigz_dag_round_multi(
        stacked.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_size_t(stacked.shape[1]), ctypes.c_size_t(stacked.shape[0]),
        ctypes.c_size_t(width),
        ops.ctypes.data_as(ctypes.c_void_p),
        arga.ctypes.data_as(ctypes.c_void_p),
        argb.ctypes.data_as(ctypes.c_void_p),
        slot.ctypes.data_as(ctypes.c_void_p),
        colrow.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_size_t(len(ops)), ctypes.c_size_t(num_slots),
        consts.ctypes.data_as(ctypes.c_void_p),
        outs.ctypes.data_as(ctypes.c_void_p), ctypes.c_int(num_out),
        ctypes.c_int(degree),
        out.ctypes.data_as(ctypes.c_void_p), ctypes.c_int(NUM_THREADS),
    )
    return [[int(out[t * num_out + e]) for e in range(num_out)]
            for t in range(degree)]


def native_dag_fold_ext(stacked: np.ndarray, width: int, r4) -> bool:
    """In-place MSB fold with a BabyBear^4 challenge; rows are 4-row
    coordinate groups.  Returns True on success."""
    lib = _load_dag()
    if lib is None:
        return False
    assert stacked.shape[0] % 4 == 0
    rc = np.asarray([int(x) for x in r4], dtype=np.uint64)
    lib.zigz_dag_fold_ext(
        stacked.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_size_t(stacked.shape[1]),
        ctypes.c_size_t(stacked.shape[0] // 4),
        ctypes.c_size_t(width),
        rc.ctypes.data_as(ctypes.c_void_p), ctypes.c_int(NUM_THREADS),
    )
    return True


def native_dag_fold(stacked: np.ndarray, width: int, r: int):
    """In-place MSB fold of every row's width-prefix; returns True on
    success (False -> caller falls back to numpy)."""
    lib = _load_dag()
    if lib is None:
        return False
    lib.zigz_dag_fold(
        stacked.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_size_t(stacked.shape[1]), ctypes.c_size_t(stacked.shape[0]),
        ctypes.c_size_t(width), ctypes.c_uint64(r), ctypes.c_int(NUM_THREADS),
    )
    return True


# ---------------------------------------------------------------------------
# Native BabyBear^4 vector kernels (ext4.cpp) — wired into core/ext4.py.

_EXT4_SRC = os.path.join(_HERE, "ext4.cpp")
_EXT4_LIB = os.path.join(_HERE, "libzigz_ext4.so")
_ext4_lib = None
_ext4_checked = False


def _load_ext4():
    global _ext4_lib, _ext4_checked
    if _ext4_checked:
        return _ext4_lib
    _ext4_checked = True
    try:
        if not (
            os.path.exists(_EXT4_LIB)
            and os.path.getmtime(_EXT4_LIB) >= os.path.getmtime(_EXT4_SRC)
        ):
            if not _compile(["-pthread"], _EXT4_SRC, _EXT4_LIB):
                return None
        lib = ctypes.CDLL(_EXT4_LIB)
        for name in ("zigz_ext4_mul", "zigz_ext4_scale_base",
                     "zigz_ext4_dot_base", "zigz_ext4_inv",
                     "zigz_ext4_vecmat", "zigz_ext4_mul_base",
                     "zigz_ext4_addsub", "zigz_ext4_scale_base_multi",
                     "zigz_ext4_dot_base_multi"):
            getattr(lib, name).restype = None
        _ext4_lib = lib
        return lib
    except Exception:
        return None


def native_ext4_available() -> bool:
    return _load_ext4() is not None


def _c64(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.c_void_p)


def native_ext4_mul(a: np.ndarray, b: np.ndarray, b_scalar: bool):
    """a (4, n) * b ((4, n) or (4,)) canonical u64 -> (4, n), or None."""
    lib = _load_ext4()
    if lib is None:
        return None
    n = a.shape[1]
    out = np.empty_like(a)
    lib.zigz_ext4_mul(_c64(a), _c64(b), ctypes.c_int(1 if b_scalar else 0),
                      _c64(out), ctypes.c_size_t(n), ctypes.c_int(NUM_THREADS))
    return out


def native_ext4_scale_base(coeff: np.ndarray, col: np.ndarray,
                           out: np.ndarray = None, accumulate: bool = False):
    """coeff (4,) * col (n,) -> (4, n); accumulates into ``out`` when asked."""
    lib = _load_ext4()
    if lib is None:
        return None
    n = len(col)
    if out is None:
        out = np.empty((4, n), dtype=np.uint64)
    lib.zigz_ext4_scale_base(_c64(coeff), _c64(col), _c64(out),
                             ctypes.c_size_t(n),
                             ctypes.c_int(1 if accumulate else 0),
                             ctypes.c_int(NUM_THREADS))
    return out


def native_ext4_scale_base_multi(coeffs, cols, out: np.ndarray,
                                 accumulate: bool = False):
    """out (4, n) = sum_k coeffs[k] (4,) * cols[k] (n,) in one fused pass.
    ``coeffs`` is a (k, 4) canonical u64 array; ``cols`` a sequence of k
    contiguous u64 arrays with values < 2^32.  Returns out, or None when
    the native runtime is unavailable."""
    lib = _load_ext4()
    if lib is None:
        return None
    k = len(cols)
    n = out.shape[1]
    coeffs = np.ascontiguousarray(coeffs, dtype=np.uint64)
    assert coeffs.shape == (k, 4)
    ptrs = np.empty(k, dtype=np.uint64)
    for j, col in enumerate(cols):
        assert col.dtype == np.uint64 and col.flags.c_contiguous and len(col) == n
        ptrs[j] = col.ctypes.data
    lib.zigz_ext4_scale_base_multi(
        _c64(coeffs), _c64(ptrs), ctypes.c_size_t(k), _c64(out),
        ctypes.c_size_t(n), ctypes.c_int(1 if accumulate else 0),
        ctypes.c_int(NUM_THREADS),
    )
    return out


def native_ext4_dot_base_multi(eq: np.ndarray, cols):
    """(k, 4) dots: out[j] = sum_i eq[., i] * cols[j][i] for one shared
    (4, n) extension weight table and k base columns (< 2^32), or None."""
    lib = _load_ext4()
    if lib is None:
        return None
    k = len(cols)
    n = eq.shape[1]
    ptrs = np.empty(max(k, 1), dtype=np.uint64)
    for j, col in enumerate(cols):
        assert col.dtype == np.uint64 and col.flags.c_contiguous and len(col) == n
        ptrs[j] = col.ctypes.data
    out = np.empty((k, 4), dtype=np.uint64)
    lib.zigz_ext4_dot_base_multi(
        _c64(eq), _c64(ptrs), ctypes.c_size_t(k), _c64(out),
        ctypes.c_size_t(n), ctypes.c_int(NUM_THREADS),
    )
    return out


def native_ext4_mul_base(a: np.ndarray, col: np.ndarray):
    """a (4, n) * col (n,) elementwise -> (4, n), or None."""
    lib = _load_ext4()
    if lib is None:
        return None
    n = len(col)
    out = np.empty((4, n), dtype=np.uint64)
    lib.zigz_ext4_mul_base(_c64(a), _c64(col), _c64(out),
                           ctypes.c_size_t(n), ctypes.c_int(NUM_THREADS))
    return out


def native_ext4_dot_base(a: np.ndarray, col: np.ndarray):
    """sum_i a[., i] * col[i] -> (4,), or None."""
    lib = _load_ext4()
    if lib is None:
        return None
    out = np.empty(4, dtype=np.uint64)
    lib.zigz_ext4_dot_base(_c64(a), _c64(col), _c64(out),
                           ctypes.c_size_t(len(col)), ctypes.c_int(NUM_THREADS))
    return out


def native_ext4_inv(a: np.ndarray, sigma: int):
    """Batched Frobenius-norm inversion of (4, n) canonical u64, or None."""
    lib = _load_ext4()
    if lib is None:
        return None
    n = a.shape[1]
    out = np.empty_like(a)
    lib.zigz_ext4_inv(_c64(a), _c64(out), ctypes.c_size_t(n),
                      ctypes.c_uint64(sigma), ctypes.c_int(NUM_THREADS))
    return out


def native_ext4_vecmat(a: np.ndarray, mat: np.ndarray):
    """a (4, rows) x mat (rows, n) -> (4, n), or None."""
    lib = _load_ext4()
    if lib is None:
        return None
    rows, n = mat.shape
    out = np.empty((4, n), dtype=np.uint64)
    lib.zigz_ext4_vecmat(_c64(a), _c64(mat), _c64(out),
                         ctypes.c_size_t(rows), ctypes.c_size_t(n),
                         ctypes.c_int(NUM_THREADS))
    return out


def native_dag_fold_hybrid(base: np.ndarray, ext_groups: np.ndarray,
                           out: np.ndarray, width: int, r4) -> bool:
    """Round-1 layout transition: fold the (B, n) base-row matrix and the
    (4E, n) ext-group matrix into the (4(B+E), n/2-strided) output —
    base rows first (4-row groups), ext groups after."""
    lib = _load_dag()
    if lib is None:
        return False
    rc = np.asarray([int(x) for x in r4], dtype=np.uint64)
    nb = base.shape[0]
    lib.zigz_dag_fold_base_to_ext(
        base.ctypes.data_as(ctypes.c_void_p), ctypes.c_size_t(base.shape[1]),
        ctypes.c_size_t(nb), ctypes.c_size_t(width),
        out.ctypes.data_as(ctypes.c_void_p), ctypes.c_size_t(out.shape[1]),
        rc.ctypes.data_as(ctypes.c_void_p), ctypes.c_int(NUM_THREADS),
    )
    ne = ext_groups.shape[0] // 4
    if ne:
        out_ext = out[4 * nb :]
        lib.zigz_dag_fold_ext_to(
            ext_groups.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_size_t(ext_groups.shape[1]), ctypes.c_size_t(ne),
            ctypes.c_size_t(width),
            out_ext.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_size_t(out.shape[1]),
            rc.ctypes.data_as(ctypes.c_void_p), ctypes.c_int(NUM_THREADS),
        )
    return True


def native_ext4_addsub(a: np.ndarray, b: np.ndarray, b_scalar: bool,
                       is_sub):
    """a +/- b for (4, n) canonical coordinate arrays (is_sub=2 computes
    the reversed b - a with scalar b), or None."""
    lib = _load_ext4()
    if lib is None:
        return None
    n = a.shape[1]
    out = np.empty_like(a)
    lib.zigz_ext4_addsub(_c64(a), _c64(b), ctypes.c_int(1 if b_scalar else 0),
                         ctypes.c_int(int(is_sub)), _c64(out),
                         ctypes.c_size_t(n), ctypes.c_int(NUM_THREADS))
    return out
