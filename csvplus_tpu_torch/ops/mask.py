"""Fused multi-column equality mask: the CUDA kernel's wrapper and its
plain PyTorch version.

Port of ``csvplus_tpu/ops/pallas_mask.py``, whose ``_fused_mask_call`` is
the repo's only TPU (Pallas) kernel.  It computes

    mask[i] = OP_j ( codes_j[i] in T_j )

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
It tests membership through a per-predicate target table
(:func:`build_table`: one register compare, a bitmap or a sorted search
a column), which :func:`device_table` uploads once per (targets, device)
and keeps in a bounded LRU, as the reference keeps one jitted executable
per predicate (``targets`` is a static argument there).
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from collections import OrderedDict
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np
import torch

from ..obs.recompile import register_kernel
from .cubuild import nvcc_build

MAX_COLS = 8

#: The table's header: MAX_COLS x {kind, offset, count, value} int32 words.
HDR_WORDS = 4 * MAX_COLS
KIND_ONE, KIND_BITMAP, KIND_SEARCH, KIND_GLOBAL = 0, 1, 2, 4
#: A column's IN-list becomes a bitmap when its span (max - min + 1) is at
#: most max(BITMAP_MIN_BITS, 32 |T|) bits: 8 KB a column, or no more words
#: than the sorted list would take.
BITMAP_MIN_BITS = 1 << 16
#: The most dynamic shared memory a block has on sm_90 (232,448 bytes), in
#: int32 words: the header and the bodies staged there (SMEM_MAX_WORDS in
#: ``csrc/mask.cu``); a body past it is searched in global memory.
SMEM_MAX_WORDS = 232_448 // 4
#: Entries of the device-table cache.
TABLE_CACHE_SIZE = 256

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
        ctypes.c_void_p,  # target table (build_table)
        ctypes.c_int,  # its words staged in shared memory
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


def canonical_targets(targets: Sequence[Sequence[int]]) -> Tuple[Tuple[int, ...], ...]:
    """Each column's IN-list sorted and deduplicated: the table cache's key."""
    return tuple(tuple(sorted(set(t))) for t in targets)


def build_table(targets: Sequence[Sequence[int]]) -> Tuple[np.ndarray, int]:
    """The kernel's target table for canonical *targets* (sorted, distinct,
    int32) and the number of its leading words to stage in shared memory.

    Header word ``4j`` is column j's kind, then the offset of its body in
    words, its count (bitmap: span in bits; search: targets) and its value
    (one: the target; bitmap: the minimum).  Bodies are staged smallest
    first while the table's head fits :data:`SMEM_MAX_WORDS`; the rest
    follow, flagged :data:`KIND_GLOBAL`."""
    hdr = np.zeros(HDR_WORDS, dtype=np.int32)
    bodies = []
    for j, t in enumerate(targets):
        arr = np.asarray(t, dtype=np.int64)
        if arr.size and (arr.min() < -(2**31) or arr.max() >= 2**31):
            raise ValueError("mask targets must be int32")
        if arr.size == 1:
            hdr[4 * j : 4 * j + 4] = (KIND_ONE, 0, 1, arr[0])
            continue
        span = int(arr[-1] - arr[0]) + 1
        if span <= max(BITMAP_MIN_BITS, min(32 * arr.size, 2**31 - 1)):
            d = arr - arr[0]
            words = np.zeros((span + 31) // 32, dtype=np.uint32)
            np.bitwise_or.at(words, d >> 5, (np.uint32(1) << (d & 31).astype(np.uint32)))
            hdr[4 * j : 4 * j + 4] = (KIND_BITMAP, 0, span, arr[0])
            bodies.append((j, words.view(np.int32)))
        else:
            hdr[4 * j : 4 * j + 4] = (KIND_SEARCH, 0, arr.size, 0)
            bodies.append((j, arr.astype(np.int32)))
    bodies.sort(key=lambda jb: jb[1].size)
    parts = [hdr]
    n_stage = off = HDR_WORDS
    for j, body in bodies:
        if off == n_stage and n_stage + body.size <= SMEM_MAX_WORDS:
            n_stage += body.size
        else:
            hdr[4 * j] |= KIND_GLOBAL
        hdr[4 * j + 1] = off
        parts.append(body)
        off += body.size
    return np.concatenate(parts), n_stage


class DeviceTable:
    """One predicate's target table on one device.  On a card the upload
    goes through a pinned staging copy, which the entry holds until the
    copy's event has fired; a stream other than the upload's waits on
    that event once before its first kernel and is recorded on the
    tensor, so an evicted table outlives the kernels that read it."""

    __slots__ = ("tensor", "n_stage", "_pinned", "_event", "_streams")

    def __init__(self, table: np.ndarray, n_stage: int, device: torch.device):
        self.n_stage = n_stage
        self._pinned = self._event = None
        self._streams = set()
        host = torch.from_numpy(table)
        if device.type != "cuda":
            self.tensor = host.to(device)
            return
        self._pinned = host.pin_memory()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device)
            self.tensor = self._pinned.to(device, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(stream)
        self._streams.add(stream.cuda_stream)

    def ready_on(self, stream) -> None:
        """Order *stream* after the upload, and drop the staging copy once
        it is done."""
        if self._pinned is not None and self._event.query():
            self._pinned = None
        if stream.cuda_stream not in self._streams:
            stream.wait_event(self._event)
            self.tensor.record_stream(stream)
            self._streams.add(stream.cuda_stream)


_tables: "OrderedDict[tuple, DeviceTable]" = OrderedDict()
_tables_lock = threading.Lock()


def device_table(targets: Tuple[Tuple[int, ...], ...], device: torch.device) -> DeviceTable:
    """The cached :class:`DeviceTable` of *targets* (one tuple of ints a
    column, in any order, duplicates allowed) on *device*, built from
    :func:`canonical_targets` and uploaded on the first use.  The entry is
    filed under the canonical targets and, when they differ, under
    *targets* as given too, so a repeated call neither sorts nor builds
    (an LRU of :data:`TABLE_CACHE_SIZE` keys; safe from any thread)."""
    key = (device, targets)
    with _tables_lock:
        entry = _tables.get(key)
        if entry is not None:
            _tables.move_to_end(key)
            return entry
    canon = canonical_targets(targets)
    ckey = (device, canon)
    with _tables_lock:
        entry = _tables.get(ckey)
    if entry is None:
        entry = DeviceTable(*build_table(canon), device)
    with _tables_lock:
        entry = _tables.setdefault(ckey, entry)  # a racing thread's copy wins
        _tables.move_to_end(ckey)
        _tables[key] = entry
        _tables.move_to_end(key)
        while len(_tables) > TABLE_CACHE_SIZE:
            _tables.popitem(last=False)
    return entry


def clear_table_cache() -> None:
    """Drop every cached device table (the next call of each predicate
    builds and uploads its table again)."""
    with _tables_lock:
        _tables.clear()


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
    table = device_table(targets, device)
    lib = _load()
    ptrs = (ctypes.c_void_p * k)(*[c.data_ptr() for c in code_arrays])
    stream = torch.cuda.current_stream(device)
    table.ready_on(stream)
    # the launch goes to the thread's current device: the columns' own
    current = device.index == torch.cuda.current_device()
    with contextlib.nullcontext() if current else torch.cuda.device(device):
        err = lib.csvplus_fused_mask(
            ptrs, k, table.tensor.data_ptr(), table.n_stage, nrows,
            1 if mode == "all" else 0, out.data_ptr(), stream.cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused mask kernel launch failed: CUDA error {err}")
    launches += 1
    return out
