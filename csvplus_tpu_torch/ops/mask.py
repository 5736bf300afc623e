"""Fused multi-column equality mask: the CUDA kernel's wrapper and its
plain PyTorch version.

Port of ``csvplus_tpu/ops/pallas_mask.py``, whose ``_fused_mask_call`` is
the repo's only TPU (Pallas) kernel.  It computes

    mask[i] = OP_j ( OR_{t in T_j} codes_j[i] == t )

over up to :data:`MAX_COLS` int32 columns, OP being AND (``"all"``) or
OR (``"any"``, where each column carries an IN-list of targets).  A
column is dictionary codes (-1 = absent) or a typed column's value lanes,
where any int32 is a value: nothing here treats a negative value as
absent or out of range.

* On a CUDA tensor, :func:`fused_equality_mask` launches the hand-written
  kernel of ``csrc/mask.cu`` (built with ``nvcc`` for ``sm_90a`` at first
  use, loaded with ``ctypes``) or raises.  It never falls back.
* On a CPU tensor it runs :func:`fused_equality_mask_plain`, the same
  function as ``==``/``|``/``&`` tensor ops.  The CPU tests use it, and
  ``chip_smoke.py`` holds the kernel against it on the card.

The kernel reads each column once and writes one byte per row; its bound
is ``(4k + 1) * n`` bytes over the card's memory rate (see the source).
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import List, Sequence, Tuple

import torch

from ..obs.recompile import register_kernel
from .cubuild import nvcc_build

MAX_COLS = 8

#: Kernel launches made through :func:`fused_equality_mask` — one per
#: launch, nowhere else.  ``chip_smoke.py`` zeroes it before the main
#: path and reads it after, to show the path went through the kernel.
launches = 0

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "mask.cu"

_lib = None
_lib_lock = threading.Lock()


def build() -> Path:
    """Compile ``csrc/mask.cu`` for ``sm_90a`` into ``_build/`` and return
    the shared library's path (see :func:`.cubuild.nvcc_build`)."""
    return nvcc_build(SOURCE, "libcsvplus_mask")


@register_kernel("mask.cu")
def _open_library():
    """Build ``csrc/mask.cu`` if needed and load it (counted in
    :mod:`..obs.recompile`)."""
    lib = ctypes.CDLL(str(build()))
    fn = lib.csvplus_fused_mask
    fn.argtypes = [
        ctypes.POINTER(ctypes.c_void_p),  # column pointers
        ctypes.c_int,  # k
        ctypes.c_void_p,  # offsets + targets table
        ctypes.c_int,  # number of targets
        ctypes.c_longlong,  # rows
        ctypes.c_int,  # 1 = "all", 0 = "any"
        ctypes.c_void_p,  # out
        ctypes.c_void_p,  # stream
    ]
    fn.restype = ctypes.c_int
    return lib


def _load():
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                _lib = _open_library()
    return _lib


def _normalize(target_codes, k: int) -> Tuple[Tuple[int, ...], ...]:
    """One tuple of int targets per column (a bare int is a one-target
    list), each non-empty."""
    if len(target_codes) != k:
        raise ValueError(f"{k} code columns but {len(target_codes)} target lists")
    norm = tuple(
        tuple(int(x) for x in t) if isinstance(t, (list, tuple)) else (int(t),)
        for t in target_codes
    )
    if any(not t for t in norm):
        raise ValueError("empty target list in fused_equality_mask")
    return norm


def fused_equality_mask_plain(
    code_arrays: Sequence[torch.Tensor],
    target_codes: "Sequence[int] | Sequence[Sequence[int]]",
    mode: str = "all",
) -> torch.Tensor:
    """The plain PyTorch version of the kernel: the same function as
    element-wise tensor ops, on any device."""
    targets = _normalize(target_codes, len(code_arrays))
    acc = None
    for codes, col_targets in zip(code_arrays, targets):
        eq = None
        for t in col_targets:
            e = codes == t
            eq = e if eq is None else (eq | e)
        acc = eq if acc is None else (acc & eq if mode == "all" else acc | eq)
    return acc


def fused_equality_mask(
    code_arrays: Sequence[torch.Tensor],
    target_codes: "Sequence[int] | Sequence[Sequence[int]]",
    nrows: int,
    mode: str = "all",
) -> torch.Tensor:
    """``bool[nrows]`` mask over 1..MAX_COLS int32 code columns.

    Each entry of *target_codes* is one target (or, in ``"any"`` mode, a
    list of targets: IN-list membership) for the matching column.  CUDA
    tensors go through the kernel; CPU tensors through the plain version.
    Anything the kernel does not take raises ``ValueError``."""
    global launches
    k = len(code_arrays)
    if not 1 <= k <= MAX_COLS:
        raise ValueError(f"fused_equality_mask takes 1..{MAX_COLS} columns, got {k}")
    if mode not in ("all", "any"):
        raise ValueError(f"unknown mask mode {mode!r}")
    targets = _normalize(target_codes, k)
    device = code_arrays[0].device
    for c in code_arrays:
        if c.dtype != torch.int32 or c.dim() != 1 or c.shape[0] != nrows:
            raise ValueError(
                f"mask columns must be int32[{nrows}], got {c.dtype}{list(c.shape)}"
            )
        if c.device != device:
            raise ValueError("mask columns lie on different devices")
    if device.type == "cpu":
        return fused_equality_mask_plain(code_arrays, targets, mode)
    if device.type != "cuda":
        raise ValueError(f"fused_equality_mask: unsupported device {device}")
    if not all(c.is_contiguous() for c in code_arrays):
        raise ValueError("mask columns must be contiguous")
    out = torch.empty(nrows, dtype=torch.bool, device=device)
    if nrows == 0:
        return out
    flat: List[int] = [0]
    for t in targets:
        flat.append(flat[-1] + len(t))
    n_targets = flat[-1]
    for t in targets:
        flat.extend(t)
    # a pinned buffer and a non-blocking copy: a pageable upload would make
    # the host wait for the stream to drain, idling the card per call
    table = torch.tensor(flat, dtype=torch.int32).pin_memory()
    table = table.to(device, non_blocking=True)
    lib = _load()
    ptrs = (ctypes.c_void_p * k)(*[c.data_ptr() for c in code_arrays])
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.csvplus_fused_mask(
            ptrs, k, table.data_ptr(), n_targets, nrows,
            1 if mode == "all" else 0, out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"fused mask kernel launch failed: CUDA error {err}")
    launches += 1
    return out
