"""JAX-free access to zigz_tpu's host submodules under ``zigz_tpu/ops/``.

The v2 prove reuses zigz_tpu host code that lives in ``zigz_tpu.ops``: the
zerocheck provers' symbolic tracer (``ops/symtrace.py``), the native C++
zerocheck twins (``ops/zerocheck_native.py``, ``zerocheck_native_ext.py``)
and the device-engagement probes (``zerocheck_gen.py``,
``zerocheck_dev_ext.py``), which zigz_tpu's zerocheck dispatch imports
outside any ``try``.  Those submodules import JAX only lazily, inside
``try`` blocks, but the package's ``__init__`` runs ``import jax`` at load
to configure JAX's compilation cache.  So where JAX cannot be imported
(the port's GPU machine has none), every v2 prove would die on
``import zigz_tpu.ops``, the reference's own host path included.

:func:`register_reference_ops` registers ``zigz_tpu.ops`` as a bare package
module: its ``__path__`` is the real ``zigz_tpu/ops/`` directory and its
``__init__`` is skipped.  The submodules then load from their own files,
and their lazy ``import jax`` fails inside their own ``try`` blocks, which
selects zigz_tpu's host backends.  Where JAX can be imported nothing is
registered, and nothing in zigz_tpu is patched either way.
"""

from __future__ import annotations

import importlib.machinery
import importlib.util
import sys
from pathlib import Path

__all__ = ["jax_importable", "register_reference_ops"]

OPS = "zigz_tpu.ops"


def jax_importable() -> bool:
    """False when ``sys.modules["jax"]`` is None (imports of it are blocked)
    or no ``jax`` package is found; JAX itself is never imported here."""
    if "jax" in sys.modules:
        return sys.modules["jax"] is not None
    return importlib.util.find_spec("jax") is not None


def register_reference_ops() -> bool:
    """Register the bare ``zigz_tpu.ops`` package where JAX cannot be
    imported and ``zigz_tpu.ops`` is not loaded yet.  Returns True when it
    registered the module."""
    if OPS in sys.modules or jax_importable():
        return False
    import zigz_tpu

    spec = importlib.machinery.ModuleSpec(OPS, None, is_package=True)
    spec.submodule_search_locations = [str(Path(zigz_tpu.__file__).resolve().parent / "ops")]
    module = importlib.util.module_from_spec(spec)
    sys.modules[OPS] = module
    zigz_tpu.ops = module
    return True
