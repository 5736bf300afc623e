"""Build a CUDA C++ source of ``csrc/`` with ``nvcc`` for ``sm_90a`` into
``_build/``, as a shared library with a plain C interface for ``ctypes``.

The library's file name carries a hash of the source, so an edited kernel
never loads a stale build; a concurrent build writes its own temporary file
and renames it into place.  A failed build raises ``RuntimeError``: no
kernel of the port falls back to its plain version on a CUDA tensor.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")


def nvcc_build(source: Path, stem: str) -> Path:
    """Compile *source* for ``sm_90a`` into ``_build/<stem>_<hash>.so``
    (once per source text) and return the library's path."""
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"{stem}_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [
        _nvcc(),
        "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-o", str(tmp), str(source),
    ]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name} ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    return out
