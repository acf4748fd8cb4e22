"""Builds the port's CUDA kernels and loads them through ctypes.

The sources are ``zigz_tpu_torch/csrc/*.cu`` (and the headers they include)
and nothing else.  ``nvcc`` compiles them for ``sm_90a`` into one shared
library with a plain C interface, at first use, under
``build/zigz_tpu_torch/`` in the checkout.  The library's file name carries a
hash of the sources and flags, so an edit rebuilds and an unchanged tree
reuses the library.

Every failure raises :class:`KernelBuildError` (nvcc missing, a compile error
with nvcc's stderr, a library that does not load) or
:class:`KernelLaunchError` (a launcher that returned a CUDA error).  Nothing
returns ``None`` and nothing falls back to the plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

__all__ = [
    "KernelBuildError",
    "KernelLaunchError",
    "Kernels",
    "find_nvcc",
    "load",
    "launch",
]

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "zigz_tpu_torch"
# The toolkit's default install prefix, tried after CUDA_HOME and PATH.
DEFAULT_CUDA_HOME = "/usr/local/cuda"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers and spills of each kernel, kept in Kernels.log
)
NVCC_TIMEOUT_S = 600

# name -> (argtypes, restype) of every extern "C" function in csrc/.
_LAUNCHER = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p], ctypes.c_int)
_SYMBOLS = {
    "zigz_sha3_leaves": _LAUNCHER,
    "zigz_sha3_merge": _LAUNCHER,
    "zigz_cuda_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


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
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libzigz_tpu_torch_{h.hexdigest()[:16]}.so"


def _compile(nvcc: str, units, out: Path) -> tuple:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, units)]
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=NVCC_TIMEOUT_S)
    except subprocess.TimeoutExpired as exc:
        raise KernelBuildError(f"nvcc timed out after {NVCC_TIMEOUT_S} s: {' '.join(cmd)}") from exc
    except OSError as exc:
        raise KernelBuildError(f"could not run nvcc ({nvcc}): {exc}") from exc
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"nvcc failed (rc {res.returncode}): {' '.join(cmd)}\n{res.stderr}{res.stdout}"
        )
    # Atomic publish: a concurrent process never loads a half-written file.
    os.replace(tmp, out)
    return seconds, res.stderr + res.stdout


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


def launch(name: str, *args) -> None:
    """Call launcher ``name``; raise if it reports a CUDA error."""
    lib = load().lib
    status = getattr(lib, name)(*args)
    if status != 0:
        msg = lib.zigz_cuda_error_string(status).decode(errors="replace")
        raise KernelLaunchError(f"{name} failed: CUDA error {status} ({msg})")
