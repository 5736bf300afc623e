"""Order-sensitive column checksums for whole-result verification.

Port of ``checksum_host_rows`` and ``checksum_device_table`` from
``csvplus_tpu/utils/checksum.py``, giving the same numbers:

* per value: 32-bit FNV-1a over its UTF-8 bytes, computed on the host
  over a column's dictionary (each distinct value hashed once);
* per column: the sum mod 2^32 of every row's value hash, an absent cell
  contributing 0; with ``positional=True`` row i's hash is first
  multiplied by the odd weight ``2*i + 1``, so a permutation of rows
  changes the sum with high probability.

On the device the hashing runs in int64 with ``& 0xFFFFFFFF``, because
torch has no usable uint32 arithmetic: a dictionary column costs one
gather, one weighted product and one sum, and the whole table one
transfer.  A typed affix-int32 column has no dictionary: its rows are
hashed on the device from the value lanes
(:func:`fnv1a_affix_int_device`), byte-identical to hashing
``prefix + decimal(value)``; a lane-dictionary column hashes its
dictionary on the device from the packed lanes
(:func:`fnv1a_lanes_device`), sorted or not, with no download.
"""

from __future__ import annotations

import contextlib

from typing import Dict, Optional, Sequence

import numpy as np
import torch

_FNV_OFFSET = np.uint32(2166136261)
_FNV_PRIME = np.uint32(16777619)
_M32 = 0xFFFFFFFF


def fnv1a_values(values: np.ndarray) -> np.ndarray:
    """Vectorized 32-bit FNV-1a over each entry of an 'S' bytes array
    (trailing NUL padding excluded)."""
    values = np.asarray(values)
    if values.dtype.kind == "U":
        values = np.char.encode(values, "utf-8")
    n = values.size
    if n == 0:
        return np.empty(0, dtype=np.uint32)
    width = values.dtype.itemsize
    mat = np.frombuffer(values.tobytes(), dtype=np.uint8).reshape(n, width)
    lens = np.char.str_len(values)
    h = np.full(n, _FNV_OFFSET, dtype=np.uint32)
    with np.errstate(over="ignore"):
        for i in range(width):
            live = i < lens
            nh = (h ^ mat[:, i]) * _FNV_PRIME
            h = np.where(live, nh, h)
    return h


def checksum_host_rows(
    rows: Sequence, columns: Sequence[str], positional: bool = False
) -> Dict[str, int]:
    """Per-column row-hash sums (mod 2^32) over host Row dicts; an absent
    cell contributes 0."""
    out = {}
    for c in columns:
        vals = [r.get(c) for r in rows]
        present = np.array([v is not None for v in vals], dtype=bool)
        hashes = np.zeros(len(vals), dtype=np.uint32)
        if present.any():
            # UTF-8 bytes straight into an 'S' array: the bytes a 'U'
            # array would encode to, without numpy's per-element encode
            arr = np.array([v.encode("utf-8") for v in vals if v is not None], dtype="S")
            hashes[present] = fnv1a_values(arr)
        if positional and hashes.size:
            with np.errstate(over="ignore"):
                hashes = hashes * (
                    2 * np.arange(hashes.size, dtype=np.uint32) + np.uint32(1)
                )
        out[c] = int(np.add.reduce(hashes, dtype=np.uint32))
    return out


def _mul32(h: torch.Tensor, w: "torch.Tensor | int") -> torch.Tensor:
    """(h * w) mod 2^32 for int64 values < 2^32 (*w* a tensor or an int),
    without overflowing int64: h is split into 16-bit halves."""
    lo = (h & 0xFFFF) * w
    hi = (((h >> 16) * w) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fnv_step(h: torch.Tensor, byte) -> torch.Tensor:
    """One FNV-1a round, ``(h ^ byte) * prime mod 2^32``, on int64 tensors
    holding values < 2^32."""
    return _mul32(h ^ byte, int(_FNV_PRIME))


def _affix_rows_ops(h0: int, v: torch.Tensor) -> torch.Tensor:
    """Per-row FNV-1a of ``prefix + decimal(value)`` from the seed *h0*
    (the prefix folded on the host): an optional '-', then the up-to-10
    decimal digits most significant first, through pow10.  int64
    throughout; no typed cell is INT32_MIN, so |v| fits."""
    v = v.to(torch.int64)
    neg = v < 0
    av = torch.where(neg, -v, v)
    h = torch.full_like(v, h0)
    h = torch.where(neg, _fnv_step(h, ord("-")), h)
    pow10 = torch.tensor([10**k for k in range(10)], dtype=torch.int64, device=v.device)
    nd = torch.ones_like(v)
    for k in range(1, 10):
        nd = nd + (av >= 10**k).to(torch.int64)
    for i in range(10):
        div = torch.index_select(pow10, 0, (nd - 1 - i).clamp(0, 9))
        byte = ord("0") + torch.div(av, div, rounding_mode="floor") % 10
        h = torch.where(i < nd, _fnv_step(h, byte), h)
    return h


def _affix_seed(prefix: bytes) -> int:
    """FNV-1a state after hashing the constant *prefix*."""
    h0 = int(_FNV_OFFSET)
    for b in prefix:
        h0 = ((h0 ^ b) * int(_FNV_PRIME)) & _M32
    return h0


def fnv1a_affix_int_device(prefix: bytes, values: torch.Tensor) -> torch.Tensor:
    """32-bit FNV-1a per row of a typed affix-int32 column, computed on its
    device from the value lanes (int64 tensor of values < 2^32):
    byte-identical to :func:`fnv1a_values` over ``prefix +
    decimal(value)``, with no formatting and no dictionary."""
    return _affix_rows_ops(_affix_seed(prefix), values)


def fnv1a_lanes_device(lane_arrays) -> torch.Tensor:
    """32-bit FNV-1a per dictionary entry (int64 tensor of values < 2^32),
    computed on the device from the sign-flipped int32 lane packing
    (:mod:`..ops.lanes`): byte-identical to :func:`fnv1a_values` on the
    unpacked dictionary.  Bytes come out big-endian per lane word; the
    trailing NUL padding is excluded through each entry's last non-NUL
    byte."""
    from ..ops.lanes import _SIGN

    n = int(lane_arrays[0].shape[0])
    dev = lane_arrays[0].device
    if n == 0:
        return torch.empty(0, dtype=torch.int64, device=dev)
    byte_cols = []
    for lane in lane_arrays:
        word = (lane ^ int(_SIGN)).to(torch.int64) & _M32
        for shift in (24, 16, 8, 0):
            byte_cols.append((word >> shift) & 0xFF)
    length = torch.zeros(n, dtype=torch.int64, device=dev)
    for pos, b in enumerate(byte_cols):
        length = torch.maximum(length, torch.where(b != 0, pos + 1, 0))
    h = torch.full((n,), int(_FNV_OFFSET), dtype=torch.int64, device=dev)
    for pos, b in enumerate(byte_cols):
        h = torch.where(pos < length, _fnv_step(h, b), h)
    return h


def checksum_device_table(
    table,
    columns: Optional[Sequence[str]] = None,
    limit: Optional[int] = None,
    positional: bool = False,
) -> Dict[str, int]:
    """Per-column row-hash sums (mod 2^32) of a DeviceTable over its first
    *limit* rows (all by default), computed where the rows lie: a
    row-sharded table hashes each shard's rows below its padding (and
    below *limit* in global order) on that shard's device, positional
    weights offset to the rows' global numbers, and the per-shard sums
    add on the first device.  The whole table comes back in one
    transfer."""
    names = list(columns) if columns is not None else list(table.columns)
    n = table.nrows if limit is None else min(limit, table.nrows)
    if not names:
        return {}
    mesh = table.mesh
    devices = [table.device] if mesh is None else list(mesh.devices)
    # logical rows per block, cut at n
    lens, left = [], n
    for m in ([n] if mesh is None else table.shard_lens()):
        lens.append(max(0, min(m, left)))
        left -= lens[-1]
    offs = np.concatenate(([0], np.cumsum(lens)[:-1])).tolist()
    dev0 = devices[0]
    sums = []
    for c in names:
        col = table.columns[c]
        htab = _hash_table(col)  # before the codes: see _hash_table
        st = col.storage
        blocks = (st,) if mesh is None else st.shards
        htabs: dict = {}  # one copy of the hash table a distinct device
        total = torch.zeros((), dtype=torch.int64, device=dev0)
        for i, (dev, blk, m, off) in enumerate(zip(devices, blocks, lens, offs)):
            if not m:
                continue
            with (mesh.on(i) if mesh is not None else contextlib.nullcontext()):
                if htab is not None and dev not in htabs:
                    htabs[dev] = htab.to(dev)
                h = _row_hashes(col, blk[:m], htabs.get(dev), dev)
                if positional:
                    w = 2 * (torch.arange(m, dtype=torch.int64, device=dev) + off) + 1
                    h = _mul32(h, w & _M32)
                total = total + (h.sum() & _M32).to(dev0)
        sums.append(total & _M32)
    return {c: int(v) for c, v in zip(names, torch.stack(sums).tolist())}


def _hash_table(col) -> "torch.Tensor | None":
    """A dictionary column's per-entry hashes (None for a typed column,
    whose rows hash from their values).  A lane dictionary hashes on its
    device; read it before the codes, since reading it remaps them if a
    sibling copy sorted the shared lane state meanwhile."""
    if col.kind == "int":
        return None
    if col.dev_dictionary is not None and col._dictionary is None:
        return fnv1a_lanes_device(col.dev_dictionary)
    return torch.from_numpy(fnv1a_values(col.dictionary).astype(np.int64))


def _row_hashes(col, codes_or_values, htab, device):
    """Per-row hashes of one block of a column (int64 values < 2^32).
    Typed value lanes hash per row (no dictionary, no demotion); every
    typed cell is present by the typed invariant."""
    if col.kind == "int":
        return fnv1a_affix_int_device(col.prefix, codes_or_values)
    codes = codes_or_values
    if htab.numel():
        g = torch.index_select(htab, 0, codes.clamp(min=0))
        return torch.where(codes >= 0, g, 0)
    return torch.zeros(codes.shape[0], dtype=torch.int64, device=device)
