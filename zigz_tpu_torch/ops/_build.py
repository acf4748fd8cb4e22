"""Builds the port's CUDA kernels and loads them through ctypes.

The sources are ``zigz_tpu_torch/csrc/*.cu`` (and the headers they include)
and nothing else.  At first use, ``nvcc`` compiles each unit for ``sm_90a``
into an object file, one process per unit, all started together, then links
the objects into one shared library with a plain C interface, under
``build/zigz_tpu_torch/`` in the checkout.  The library's file name carries a
hash of the sources and flags, so an edit rebuilds and an unchanged tree
reuses the library.

Generated units (Z1, one per DAG program: ops/dag_codegen.py) are built
beside it: :func:`start_generated` writes the source to
``build/zigz_tpu_torch/dag/<hash>.cu`` and starts ``nvcc`` on it without
waiting, into a library of its own, ``<hash>.so``, with ``<hash>.log`` (the
ptxas report) beside it; :meth:`GeneratedBuild.wait` finishes the build and
loads the library.  ``<hash>`` covers the source, the headers of ``csrc/``
and the flags, so a later process reuses the library, and equal programs
share one.

Every failure raises :class:`KernelBuildError` (nvcc missing, a compile error
with nvcc's stderr, a timeout, a library that does not load) or
:class:`KernelLaunchError` (a launcher that returned a CUDA error).  Nothing
returns ``None`` and nothing falls back to the plain versions.
"""

from __future__ import annotations

import atexit
import ctypes
import hashlib
import os
import re
import shutil
import signal
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

__all__ = [
    "KernelBuildError",
    "KernelLaunchError",
    "Kernels",
    "GeneratedBuild",
    "find_nvcc",
    "load",
    "launch",
    "check",
    "start_generated",
    "ptxas_report",
]

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "zigz_tpu_torch"
GENERATED_SUBDIR = "dag"  # generated units, under BUILD_DIR
# The toolkit's default install prefix, tried after CUDA_HOME and PATH.
DEFAULT_CUDA_HOME = "/usr/local/cuda"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers and spills of each kernel, kept in Kernels.log
)
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")
# NVVM optimises a generated unit's functions (its body's segments) on as
# many threads as there are cores (0); see PERF.md, PR 9.
GENERATED_FLAGS = ("--split-compile=0",)
NVCC_TIMEOUT_S = 600

# name -> (argtypes, restype) of every extern "C" function in csrc/.
_PTR, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_LAUNCHER = ([_PTR, _PTR, _I64, _PTR], _INT)
_SYMBOLS = {
    "zigz_sha3_leaves": _LAUNCHER,
    "zigz_sha3_merge": _LAUNCHER,
    "zigz_sha3_columns": ([_PTR, _PTR, _I64, _I64, _PTR], _INT),
    "zigz_sha3_absorb": ([_PTR, _PTR, _I64, _I64, _I64, _I64, _I64, _PTR], _INT),
    "zigz_field_mul_chain": ([_PTR, _PTR, _I64, _PTR, _PTR], _INT),
    "zigz_ext_fold": ([_PTR, _I64, _PTR, _INT, _PTR, _PTR, _PTR], _INT),
    "zigz_p2_leaves": ([_PTR, _PTR, _I64, _PTR, _PTR], _INT),
    "zigz_p2_merge": ([_PTR, _PTR, _I64, _PTR, _PTR], _INT),
    "zigz_p2_absorb": ([_PTR, _PTR, _I64, _I64, _PTR, _PTR], _INT),
    "zigz_p2_absorb_blocks_per_sm": ([ctypes.POINTER(_INT)], _INT),
    "zigz_mle_fold_u64": ([_PTR, _PTR, _PTR, _I64, _I64, ctypes.c_uint64, _PTR], _INT),
    "zigz_ntt_tile": ([_PTR, _PTR, _PTR, _I64, _I64, _I64, _PTR], _INT),
    "zigz_ntt_pass": ([_PTR, _PTR, _I64, _I64, _I64, _I64, _PTR], _INT),
    "zigz_ntt_passes": ([_I64, _I64, ctypes.POINTER(_I64), ctypes.POINTER(_I64)], _INT),
    "zigz_witness_rows": ([ctypes.POINTER(_PTR), ctypes.POINTER(_PTR), _I64, _I64, ctypes.c_uint64, ctypes.c_uint64,
                           _PTR, _PTR, _PTR, _PTR], _INT),
    "zigz_cuda_error_string": ([_INT], ctypes.c_char_p),
}
# The launcher of every generated unit (csrc/dag_round.cuh).
_GENERATED_SYMBOLS = {"zigz_dag_round_sums": ([_PTR, _I64, _INT, _INT, _PTR, _INT, _PTR, _PTR], _INT)}


class KernelBuildError(RuntimeError):
    """The kernels could not be compiled or loaded."""


class KernelLaunchError(RuntimeError):
    """A kernel launcher returned a CUDA error."""


@dataclass
class Kernels:
    lib: ctypes.CDLL
    path: Path
    build_s: float  # nvcc wall time in this process; 0.0 when reused
    log: str  # nvcc's output of the build (ptxas register report)


def find_nvcc():
    """Path of nvcc from CUDA_HOME / CUDA_PATH, PATH, then the default
    prefix; None when there is none."""
    for var in ("CUDA_HOME", "CUDA_PATH"):
        home = os.environ.get(var)
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(DEFAULT_CUDA_HOME) / "bin" / "nvcc"
    return str(default) if default.is_file() else None


def _sources():
    units = sorted(CSRC.glob("*.cu"))
    headers = sorted(CSRC.glob("*.cuh"))
    if not units:
        raise KernelBuildError(f"no CUDA sources under {CSRC}")
    return units, headers


def _library_path(units, headers) -> Path:
    h = hashlib.sha256()
    for path in units + headers:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    return BUILD_DIR / f"libzigz_tpu_torch_{h.hexdigest()[:16]}.so"


def _kill(proc) -> None:
    """Kill nvcc and the compilers it started (its own process group)."""
    if proc.poll() is None:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    proc.communicate()


def _run_nvcc(procs) -> str:
    """Wait for every (cmd, Popen) in ``procs``, NVCC_TIMEOUT_S at most;
    raise on the first failure.  Returns their output, in order."""
    log = []
    failed = None
    deadline = time.monotonic() + NVCC_TIMEOUT_S
    for cmd, proc in procs:
        try:
            out, err = proc.communicate(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for _, other in procs:
                _kill(other)
            raise KernelBuildError(f"nvcc timed out after {NVCC_TIMEOUT_S} s: {' '.join(cmd)}") from None
        log.append(err + out)
        if proc.returncode != 0 and failed is None:
            failed = KernelBuildError(f"nvcc failed (rc {proc.returncode}): {' '.join(cmd)}\n{err}{out}")
    if failed is not None:
        raise failed
    return "".join(log)


def _start(cmd):
    try:
        return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                     start_new_session=True)
    except OSError as exc:
        raise KernelBuildError(f"could not run nvcc ({cmd[0]}): {exc}") from exc


def _compile(nvcc: str, units, out: Path) -> tuple:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objects = [BUILD_DIR / f"{tag}.{unit.stem}.o" for unit in units]
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    procs = []
    try:
        for unit, obj in zip(units, objects):
            procs.append(_start([nvcc, *NVCC_FLAGS, "-c", str(unit), "-o", str(obj)]))
        log = _run_nvcc(procs)
        log += _run_nvcc([_start([nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objects)])])
    except KernelBuildError:
        for _, proc in procs:  # a unit that could not start leaves the others running
            _kill(proc)
        tmp.unlink(missing_ok=True)
        raise
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    # Atomic publish: a concurrent process never loads a half-written file.
    os.replace(tmp, out)
    return seconds, log


def _build_and_load() -> Kernels:
    units, headers = _sources()
    path = _library_path(units, headers)
    build_s, log = 0.0, ""
    if not path.is_file():
        nvcc = find_nvcc()
        if nvcc is None:
            raise KernelBuildError(
                "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
                "kernels cannot be built and the port has no fallback for CUDA tensors"
            )
        build_s, log = _compile(nvcc, units, path)
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as exc:
        raise KernelBuildError(f"could not load {path}: {exc}") from exc
    for name, (argtypes, restype) in _SYMBOLS.items():
        try:
            fn = getattr(lib, name)
        except AttributeError as exc:
            raise KernelBuildError(f"{path} lacks symbol {name}") from exc
        fn.argtypes = argtypes
        fn.restype = restype
    return Kernels(lib=lib, path=path, build_s=build_s, log=log)


_LOADED = None
_LOCK = threading.Lock()


def load() -> Kernels:
    """Build (once per source hash) and load the kernels; cached per process."""
    global _LOADED
    with _LOCK:
        if _LOADED is None:
            _LOADED = _build_and_load()
        return _LOADED


def check(status: int, name: str) -> None:
    """Raise if launcher ``name`` returned a CUDA error."""
    if status != 0:
        msg = load().lib.zigz_cuda_error_string(status).decode(errors="replace")
        raise KernelLaunchError(f"{name} failed: CUDA error {status} ({msg})")


def launch(name: str, *args) -> None:
    """Call launcher ``name``; raise if it reports a CUDA error."""
    check(getattr(load().lib, name)(*args), name)


# -- generated units -----------------------------------------------------------


def _generated_hash(source: str) -> str:
    h = hashlib.sha256(source.encode())
    for path in sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS + GENERATED_FLAGS + LINK_FLAGS).encode())
    return h.hexdigest()[:20]


def _publish(path: Path, data: str) -> None:
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    tmp.write_text(data)
    os.replace(tmp, path)


class GeneratedBuild:
    """The build of one generated unit: started on construction (nvcc runs
    in the background, a thread collecting its output, unless the library
    is already built), finished by :meth:`wait`, which loads the library
    once and returns it.  ``build_s`` is nvcc's wall time in this process
    (0.0 when the library was reused), ``waited_s`` the time callers spent
    blocked in :meth:`wait`, ``log`` nvcc's output (the ptxas report), kept
    beside the library."""

    def __init__(self, source: str):
        self.key = _generated_hash(source)
        self.dir = BUILD_DIR / GENERATED_SUBDIR
        self.path = self.dir / f"{self.key}.so"
        self.build_s = 0.0
        self.waited_s = 0.0
        self.log = ""
        self._lib = None
        self._error = None
        self._nvcc = None  # the thread that waits for nvcc
        self._lock = threading.Lock()
        if self.path.is_file():
            return
        nvcc = find_nvcc()
        if nvcc is None:
            raise KernelBuildError(
                "nvcc not found (set CUDA_HOME or put nvcc on PATH); the generated round-sum "
                "kernel cannot be built and the port has no fallback for CUDA tensors"
            )
        self.dir.mkdir(parents=True, exist_ok=True)
        src = self.dir / f"{self.key}.cu"
        _publish(src, source)
        self._tmp = self.path.with_name(f"{self.path.name}.{os.getpid()}.{id(self)}.tmp")
        started = _start([nvcc, *NVCC_FLAGS, *GENERATED_FLAGS, "-shared", "-I", str(CSRC), "-o", str(self._tmp),
                          str(src)])
        self._proc = started[1]
        self._output = KernelBuildError(f"nvcc ended without a result: {' '.join(started[0])}")
        self._nvcc = threading.Thread(target=self._collect, args=(started, time.perf_counter()), daemon=True)
        self._nvcc.start()

    def _collect(self, proc, t0: float) -> None:
        try:
            self._output = _run_nvcc([proc])
        except KernelBuildError as exc:
            self._output = exc
        self.build_s = time.perf_counter() - t0

    def done(self) -> bool:
        """True once nvcc has exited (or was never needed)."""
        return self._nvcc is None or not self._nvcc.is_alive()

    def wait(self) -> ctypes.CDLL:
        """The loaded library; raises KernelBuildError where nvcc failed,
        timed out or the library does not load (and again on every call)."""
        t0 = time.perf_counter()
        with self._lock:
            try:
                if self._error is None and self._lib is None:
                    self._finish()
            finally:
                self.waited_s += time.perf_counter() - t0
            if self._error is not None:
                raise self._error
            return self._lib

    def _finish(self) -> None:
        try:
            if self._nvcc is not None:
                self._nvcc.join()
                if isinstance(self._output, KernelBuildError):
                    self._tmp.unlink(missing_ok=True)
                    raise self._output
                self.log = self._output
                _publish(self.path.with_suffix(".log"), self.log)
                os.replace(self._tmp, self.path)
            elif self.path.with_suffix(".log").is_file():
                self.log = self.path.with_suffix(".log").read_text()
            try:
                lib = ctypes.CDLL(str(self.path))
            except OSError as exc:
                raise KernelBuildError(f"could not load {self.path}: {exc}") from exc
            for name, (argtypes, restype) in _GENERATED_SYMBOLS.items():
                try:
                    fn = getattr(lib, name)
                except AttributeError as exc:
                    raise KernelBuildError(f"{self.path} lacks symbol {name}") from exc
                fn.argtypes = argtypes
                fn.restype = restype
            self._lib = lib
        except KernelBuildError as exc:
            self._error = exc


_GENERATED = {}
_GENERATED_LOCK = threading.Lock()


def _stop_generated() -> None:
    """At exit: kill the nvcc of every build still running in this process."""
    for build in list(_GENERATED.values()):
        if not build.done():
            _kill(build._proc)


def start_generated(source: str) -> GeneratedBuild:
    """The build of ``source``, started now or found: one per hash and
    process, so equal programs share one build and one library."""
    key = _generated_hash(source)
    with _GENERATED_LOCK:
        build = _GENERATED.get(key)
        if build is None:
            if not _GENERATED:
                atexit.register(_stop_generated)
            build = _GENERATED[key] = GeneratedBuild(source)
        return build


def ptxas_report(log: str) -> dict:
    """What ``-Xptxas -v`` says of one generated unit (``log``): the most
    registers a function uses, the largest stack frame, and the spill bytes
    of all its functions together (the kernel and, where the body is cut,
    its segments), a thread."""
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    frames = [tuple(map(int, f)) for f in
              re.findall(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", log)]
    return {"registers": max(regs, default=None), "functions": len(regs),
            "stack_frame_B": max((f[0] for f in frames), default=None),
            "spill_stores_B": sum(f[1] for f in frames), "spill_loads_B": sum(f[2] for f in frames)}
