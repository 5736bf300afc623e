"""Build/load accounting for the port's hand-built binaries.

The reference counts, per registered ``jax.jit`` kernel, the lowerings
jax caches; a count that grows between two snapshots is a recompile.
Torch eager keeps no lowering cache, and the port's device work is torch
ops plus two binaries built from the checkout: the CUDA mask kernel
(``csrc/mask.cu``, nvcc) and the native CSV scanner
(``native/scanner.cpp``, g++).  So here each count is **how many times
that binary was built or loaded into this process** — the event a warm
pass must never repeat.  The names and the workflow are the
reference's::

    @register_kernel("mask.cu")
    def _open_library(): ...      # build if missing, then dlopen

    with RecompileWatch() as w:
        ...warm passes...
    w.assert_zero()        # raises naming every binary loaded again

A binary's count starts at 0 when its module is imported and rises by
one each time the decorated loader returns; nothing else moves it.
:class:`RecompileWatch` also reads the plan cache's ``lowered`` counter
when one is passed.
"""

from __future__ import annotations

import functools
import threading
from typing import Callable, Dict, Optional

_REGISTRY_LOCK = threading.Lock()
_COUNTS: Dict[str, int] = {}


def register_kernel(name: str) -> Callable:
    """Decorator for the function that builds (if needed) and loads the
    binary *name*: registers *name* with a count of 0 and adds one to it
    every time the decorated function returns."""
    with _REGISTRY_LOCK:
        _COUNTS.setdefault(name, 0)

    def deco(fn):
        @functools.wraps(fn)
        def counted(*args, **kwargs):
            out = fn(*args, **kwargs)
            with _REGISTRY_LOCK:
                _COUNTS[name] += 1
            return out

        return counted

    return deco


def registered_kernels() -> Dict[str, int]:
    """Name -> builds/loads so far (a snapshot of the registry)."""
    with _REGISTRY_LOCK:
        return dict(_COUNTS)


def compile_counts() -> Dict[str, Optional[int]]:
    """Per-binary count of builds/loads in this process."""
    return dict(registered_kernels())


class RecompileWatch:
    """Asserts that a region loads no binary again.

    Snapshot on ``__enter__``; :meth:`delta` reports every binary whose
    count grew (plus the plan cache's ``lowered`` counter when one was
    passed); :meth:`assert_zero` raises ``AssertionError`` naming the
    offenders.  A binary registered inside the region counts from zero.
    """

    def __init__(self, plancache=None):
        self._plancache = plancache
        self._before: Dict[str, Optional[int]] = {}
        self._plan_before = 0

    def __enter__(self) -> "RecompileWatch":
        self._before = compile_counts()
        if self._plancache is not None:
            self._plan_before = self._plancache.stats()["lowered"]
        return self

    def __exit__(self, *exc) -> None:
        pass

    def delta(self) -> Dict[str, int]:
        """Binaries (and ``plancache``) whose count grew since
        ``__enter__``; an empty dict means the invariant held."""
        out: Dict[str, int] = {}
        for name, n in compile_counts().items():
            base = self._before.get(name, 0)
            if n > base:
                out[name] = n - base
        if self._plancache is not None:
            grew = self._plancache.stats()["lowered"] - self._plan_before
            if grew > 0:
                out["plancache"] = grew
        return out

    def observable(self) -> bool:
        """True once any binary is registered."""
        return bool(compile_counts())

    def assert_zero(self, context: str = "warm pass") -> None:
        d = self.delta()
        if d:
            detail = ", ".join(f"{k}:+{v}" for k, v in sorted(d.items()))
            raise AssertionError(
                f"binaries built or loaded again during {context}: {detail}"
            )
