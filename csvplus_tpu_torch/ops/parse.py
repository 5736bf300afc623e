"""Device-side CSV parsing: the bytes as a ``uint8`` tensor, the dictionary
encode on the device.

Port of ``csvplus_tpu/ops/parse.py``.  The division of labour is the
reference's:

* the separator scan, field offsets and per-record counts run in numpy
  (:func:`_offsets_np`): the host consumes them at once (header policy,
  column slicing);
* the byte buffer goes to the device once, and the dictionary encode, the
  heavy part, runs there (:func:`encode_column_device`): each field of at
  most 32 bytes is packed big-endian into 2, 4 or 8 sign-flipped int32
  lanes (signed order == byte order), the lanes are sorted, run
  boundaries become dense ranks, and the ranks go back to row order.  Only
  the unique values reach the host, to build the sorted dictionary.

The pack is a hand-written CUDA kernel on the card (``csrc/parse.cu``,
:func:`pack_field_lanes`) and its plain PyTorch version on the CPU
(:func:`pack_field_lanes_plain`); the sort, the ranks and the scatters are
torch ops.

Scope: simple rectangular CSV (no quote, no CR, no NUL, no blank line, no
leading newline); anything else is declined before any upload and the
native tiers handle it.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from ..obs.recompile import register_kernel
from .cubuild import nvcc_build
from .lanes import lanes_for_width, unpack_host

_NL = 10

#: Kernel launches made through :func:`pack_field_lanes`, one per launch
#: and nowhere else; ``chip_smoke.py`` zeroes it before a path and reads
#: it after.
launches = 0

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "parse.cu"

_lib = None
_lib_lock = threading.Lock()


def build() -> Path:
    """Compile ``csrc/parse.cu`` for ``sm_90a`` into ``_build/`` and return
    the shared library's path (see :func:`.cubuild.nvcc_build`)."""
    return nvcc_build(SOURCE, "libcsvplus_parse")


@register_kernel("parse.cu")
def _open_library():
    """Build ``csrc/parse.cu`` if needed and load it (counted in
    :mod:`..obs.recompile`)."""
    lib = ctypes.CDLL(str(build()))
    fn = lib.csvplus_pack_field_lanes
    fn.argtypes = [
        ctypes.c_void_p,  # data
        ctypes.c_longlong,  # n bytes
        ctypes.c_void_p,  # starts
        ctypes.c_void_p,  # lens
        ctypes.c_longlong,  # m fields
        ctypes.c_int,  # lanes
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


def _offsets_np(host_arr: np.ndarray, delim_byte: int, trailing_nl: bool):
    """Field starts/ends and per-record field counts, in numpy (the host
    consumes them at once, so they are never computed on the device)."""
    n = host_arr.shape[0]
    nl_mask = host_arr == _NL
    dl_mask = host_arr == delim_byte
    sep_pos = np.flatnonzero(nl_mask | dl_mask)
    nl_pos = np.flatnonzero(nl_mask)
    n_sep = sep_pos.shape[0]

    n_fields = n_sep + (0 if trailing_nl else 1)
    starts = np.zeros(n_fields, dtype=np.int64)
    starts[1:] = (sep_pos + 1)[: n_fields - 1]
    ends = np.append(sep_pos, n)[:n_fields]

    # fields per record: delimiters before each newline, differenced
    dl_cum = np.cumsum(dl_mask)
    dl_at_nl = dl_cum[nl_pos]
    rec_counts = np.diff(dl_at_nl, prepend=0) + 1
    if not trailing_nl:
        total_dl = int(dl_cum[-1]) if n else 0
        last = total_dl - (int(dl_at_nl[-1]) if nl_pos.size else 0) + 1
        rec_counts = np.append(rec_counts, last)
    return starts, ends, rec_counts.astype(np.int32)


def parse_simple_csv_device(
    data: bytes, delimiter: str = ",", device="cuda"
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, torch.Tensor]]:
    """Scan a simple CSV buffer and upload its bytes.

    Returns ``(field_starts, field_lens, rec_counts, device uint8 data)``
    as the native scanner's contract has them, or None when the buffer
    needs the full state machine (quotes, CR, NUL, blank lines, a leading
    newline) or is empty; those checks run on the host bytes before any
    upload, in the reference's order.

    The reference pads the upload to a size bucket to bound XLA's compile
    cache; torch eager has no such cache, so the exact length goes up.
    Nothing downstream reads past a field (the pack kernel masks by field
    length and by the buffer's end), so the outputs are the same, which
    ``tests/test_torch_device_parse.py`` holds against the reference."""
    from ..columnar.table import resolve_device

    if not data:
        return None
    if len(data) >= 2**31:
        return None  # int32 offsets would wrap; the int64 scanners handle it
    if (
        b'"' in data
        or b"\r" in data
        or b"\x00" in data
        or b"\n\n" in data
        or data.startswith(b"\n")
    ):
        return None
    dev = resolve_device(device)
    host_arr = np.frombuffer(data, dtype=np.uint8)
    arr = upload_bytes(data, dev)
    starts, ends, rec_counts = _offsets_np(host_arr, ord(delimiter), data.endswith(b"\n"))
    lens_np = (ends - starts).astype(np.int32)
    return starts, lens_np, rec_counts, arr


def upload_bytes(data, device: torch.device) -> torch.Tensor:
    """*data* (bytes or a ``uint8`` array) as a ``uint8`` tensor on
    *device*: one host copy into (on a CUDA device, pinned) memory, then a
    copy that does not block the host."""
    src = np.frombuffer(data, dtype=np.uint8)
    pinned = device.type == "cuda"
    host = torch.empty(src.shape[0], dtype=torch.uint8, pin_memory=pinned)
    host.numpy()[:] = src
    return host.to(device, non_blocking=pinned) if pinned else host


def pack_field_lanes_plain(
    data: torch.Tensor, starts: torch.Tensor, lens: torch.Tensor, lanes: int
) -> torch.Tensor:
    """The plain PyTorch version of the pack kernel: ``int32[lanes, m]``,
    lane *w* of field *i* the big-endian word of bytes ``4w .. 4w+3`` of
    the NUL-padded field, XOR ``0x80000000``, as the reference's
    ``_encode_column_kernel`` builds its ``words`` (``ops/parse.py:90-103``:
    an index matrix, a byte matrix, shift-or passes).  A byte past the
    field or past the buffer reads as NUL; a field inside the buffer (every
    field a scan makes) is therefore packed as the reference packs it."""
    width = 4 * lanes
    m = starts.shape[0]
    n = data.shape[0]
    pos = torch.arange(width, dtype=torch.int64, device=data.device)
    idx = starts.to(torch.int64)[:, None] + pos[None, :]
    mask = (pos[None, :] < lens.to(torch.int64)[:, None]) & (idx < n) & (idx >= 0)
    safe = idx.clamp(0, max(n - 1, 0))
    if n == 0:
        data = torch.zeros(1, dtype=torch.uint8, device=data.device)
    mat = torch.where(mask, data[safe], torch.zeros((), dtype=torch.uint8,
                                                    device=data.device)).to(torch.int64)
    out = torch.empty((lanes, m), dtype=torch.int32, device=data.device)
    for w in range(lanes):
        word = torch.zeros(m, dtype=torch.int64, device=data.device)
        for b in range(4):
            word |= mat[:, 4 * w + b] << (8 * (3 - b))
        # (word ^ 0x80000000) as a signed 32-bit value
        out[w] = (word - 0x80000000).to(torch.int32)
    return out


def pack_field_lanes(
    data: torch.Tensor, starts: torch.Tensor, lens: torch.Tensor, lanes: int
) -> torch.Tensor:
    """``int32[lanes, m]`` packed lanes of the fields ``(starts, lens)`` of
    the ``uint8`` buffer *data* (see :func:`pack_field_lanes_plain`).

    CUDA tensors go through the hand-written kernel of ``csrc/parse.cu``
    (built at first use; a failed build or launch raises), CPU tensors
    through the plain version.  Anything the kernel does not take raises
    ``ValueError``."""
    global launches
    if lanes not in (2, 4, 8):
        raise ValueError(f"pack_field_lanes takes 2, 4 or 8 lanes, got {lanes}")
    if data.dtype != torch.uint8 or data.dim() != 1:
        raise ValueError(f"data must be uint8[n], got {data.dtype}{list(data.shape)}")
    m = starts.shape[0]
    for name, t in (("starts", starts), ("lens", lens)):
        if t.dtype != torch.int32 or t.dim() != 1 or t.shape[0] != m:
            raise ValueError(f"{name} must be int32[{m}], got {t.dtype}{list(t.shape)}")
        if t.device != data.device:
            raise ValueError("pack_field_lanes inputs lie on different devices")
    device = data.device
    if device.type == "cpu":
        return pack_field_lanes_plain(data, starts, lens, lanes)
    if device.type != "cuda":
        raise ValueError(f"pack_field_lanes: unsupported device {device}")
    if not (data.is_contiguous() and starts.is_contiguous() and lens.is_contiguous()):
        raise ValueError("pack_field_lanes inputs must be contiguous")
    out = torch.empty((lanes, m), dtype=torch.int32, device=device)
    if m == 0:
        return out
    lib = _load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.csvplus_pack_field_lanes(
            data.data_ptr(), data.shape[0], starts.data_ptr(), lens.data_ptr(),
            m, lanes, out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"field pack kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def _sort_lanes(words: torch.Tensor) -> torch.Tensor:
    """The permutation that sorts the fields by their lanes (byte order):
    least-significant lane pair first, one stable int64 sort per pair of
    lanes (``hi << 32 | lo + 2^31`` orders like ``(hi, lo)``)."""
    lanes, m = words.shape
    perm = None
    for w in range(lanes - 2, -1, -2):
        hi = words[w].to(torch.int64)
        lo = words[w + 1].to(torch.int64) + 0x80000000
        key = (hi << 32) | lo
        if perm is not None:
            key = key[perm]
        order = torch.sort(key, stable=True).indices
        perm = order if perm is None else perm[order]
    return perm


def encode_lanes(words: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(codes, n_uniq, uniq_first)`` of the packed fields, as the
    reference's kernel returns them: int32 dense ranks in byte order per
    row, the number of distinct fields (a 0-d tensor) and, per rank, the
    first row holding that value (``m`` past the last rank).  None of the
    three depends on the sort's stability: ranks are dense in byte order
    and the first row is a minimum."""
    lanes, m = words.shape
    dev = words.device
    if m == 0:
        z = torch.zeros(0, dtype=torch.int32, device=dev)
        return z, torch.zeros((), dtype=torch.int64, device=dev), z
    pos_s = _sort_lanes(words)
    ws = words[:, pos_s]
    new_run = torch.ones(m, dtype=torch.bool, device=dev)
    new_run[1:] = (ws[:, 1:] != ws[:, :-1]).any(dim=0)
    rank = torch.cumsum(new_run, 0, dtype=torch.int32) - 1
    codes = torch.empty(m, dtype=torch.int32, device=dev)
    codes[pos_s] = rank
    n_uniq = rank[-1].to(torch.int64) + 1
    uniq_rows = torch.where(new_run, pos_s.to(torch.int32), torch.full_like(rank, m))
    uniq_first = torch.full((m,), m, dtype=torch.int32, device=dev).scatter_reduce(
        0, rank.to(torch.int64), uniq_rows, reduce="amin", include_self=True)
    return codes, n_uniq, uniq_first


def dictionary_from_lanes(lanes_host: np.ndarray, itemsize: int) -> np.ndarray:
    """The ``S<itemsize>`` dictionary of the downloaded lanes of the unique
    values (``int32[lanes, k]``, in rank order): each value's NUL-padded
    bytes, whose trailing NULs numpy's ``S`` dtype drops (the tier rejected
    NUL inside the data, so a value's own bytes hold none)."""
    return unpack_host(list(lanes_host)).astype(f"S{itemsize}")


def encode_column_device(
    data_dev: torch.Tensor,
    starts: np.ndarray,
    lens: np.ndarray,
) -> Optional[Tuple[np.ndarray, torch.Tensor]]:
    """Dictionary-encode one column on the device (fields of at most 32
    bytes, packed into 2, 4 or 8 int32 lanes by the column's widest field).

    Returns ``(sorted bytes dictionary, int32 codes)`` with
    ``encode_strings``' contract and the reference's dictionary dtype and
    itemsize; the codes stay on *data_dev*'s device.  None for wider
    fields.  Two host syncs, both counted with ``telemetry.count_sync``:
    the unique count and the download of the unique values' lanes (the
    dictionary is built from those lanes, not by one Python slice per
    value as in the reference, which is why the reference's host-bytes
    argument is not taken)."""
    from ..utils.observe import telemetry

    if starts.shape[0] == 0:
        return np.empty(0, dtype="S1"), torch.empty(0, dtype=torch.int32, device=data_dev.device)
    max_len = int(lens.max())
    lanes = lanes_for_width(max_len)
    if lanes is None:
        return None
    dev = data_dev.device
    st = torch.from_numpy(np.ascontiguousarray(starts, dtype=np.int32)).to(dev)
    ln = torch.from_numpy(np.ascontiguousarray(lens, dtype=np.int32)).to(dev)
    words = pack_field_lanes(data_dev, st, ln, lanes)
    codes, n_uniq, uniq_first = encode_lanes(words)
    k = int(n_uniq)
    telemetry.count_sync(1)
    first = uniq_first[:k].to(torch.int64)
    lanes_host = words.index_select(1, first).cpu().numpy()
    telemetry.count_sync(lanes_host.size)
    dictionary = dictionary_from_lanes(lanes_host, max(max_len, 1))
    if dictionary.size == 0:
        dictionary = np.empty(0, dtype="S1")
    return dictionary, codes
