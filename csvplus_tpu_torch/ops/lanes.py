"""Device-resident dictionaries as packed byte lanes.

Port of ``csvplus_tpu/ops/lanes.py``.  A dictionary column normally keeps
its sorted unique values as a host numpy bytes array
(:mod:`..columnar.table`).  For a high-cardinality column (a unique
``order_id``) that host array is what would break the streamed ingest's
bounded host memory, so such a dictionary lives on the device instead:
fields of up to 32 bytes packed big-endian into 2, 4 or 8 **sign-flipped
int32 lanes**, so that signed lexicographic lane order equals byte order.
On that representation this module provides

* host <-> lane packing and unpacking (the lazy host dictionary at the
  sink, and single probe values),
* a k-lane vectorized binary search, and one ``torch.searchsorted`` of
  a folded int64 key for two-lane dictionaries (fields of up to 8
  bytes),
* a device union of sorted (or unsorted) chunk dictionaries: one stable
  multi-key sort and a run-rank pass give the sorted union and each
  chunk's translation table, without the union touching the host.

The reference's ``jax.lax.sort(..., num_keys=n_lanes, is_stable=True)``
becomes least-significant-lane-first stable ``torch.sort`` passes; its
out-of-range ``.at[].set(mode="drop")`` scatter becomes a scatter into
one spare slot that is sliced off.  ``union_device``'s union size is its
only host sync, as in the reference.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

_SIGN = np.int32(-0x80000000)  # sign-flip bias: signed order == byte order
MAX_LANE_BYTES = 32  # 8 int32 lanes


def lanes_for_width(width: int) -> Optional[int]:
    """Lane count (2/4/8) for a max field width, or None past the cap."""
    if width > MAX_LANE_BYTES:
        return None
    lanes = 2
    while 4 * lanes < width:
        lanes *= 2
    return lanes


def pack_host(dictionary: np.ndarray, lanes: int) -> "List[np.ndarray]":
    """Pack a host 'S' bytes array into sign-flipped int32 lane arrays
    (big-endian, NUL padded)."""
    n = dictionary.shape[0]
    width = 4 * lanes
    if n == 0:
        return [np.empty(0, dtype=np.int32) for _ in range(lanes)]
    mat = (
        np.frombuffer(dictionary.astype(f"S{width}").tobytes(), dtype=np.uint8)
        .reshape(n, width)
        .astype(np.int32)
    )
    out = []
    for w in range(lanes):
        word = (
            (mat[:, 4 * w] << 24)
            | (mat[:, 4 * w + 1] << 16)
            | (mat[:, 4 * w + 2] << 8)
            | mat[:, 4 * w + 3]
        )
        out.append((word ^ _SIGN).astype(np.int32))
    return out


def unpack_host(lane_arrays: "List[np.ndarray]") -> np.ndarray:
    """Inverse of :func:`pack_host`: host lane arrays back to an 'S'
    bytes array (trailing NULs trimmed by the dtype)."""
    lanes = len(lane_arrays)
    n = lane_arrays[0].shape[0]
    if n == 0:
        return np.empty(0, dtype="S1")
    # undo the sign flip, then each row's lanes as big-endian words are
    # its bytes in order
    words = np.empty((n, lanes), dtype=">u4")
    for w, lane in enumerate(lane_arrays):
        words[:, w] = lane.astype(np.int32) ^ _SIGN
    return words.view(f"S{4 * lanes}").ravel()


def extend_lanes_host(lane_arrays: "List[np.ndarray]", lanes: int):
    """Widen a host lane list to *lanes* lanes: the extra lanes hold the
    packed NUL padding (0 ^ sign flip), keeping order and equality."""
    n = lane_arrays[0].shape[0]
    fill = np.full(n, _SIGN, dtype=np.int32)
    return list(lane_arrays) + [fill] * (lanes - len(lane_arrays))


def widen_lanes_device(lanes: Tuple, n_lanes: int) -> Tuple:
    """The device form of :func:`extend_lanes_host` (the one definition
    of the packed-NUL fill for device lane tuples)."""
    if len(lanes) >= n_lanes:
        return tuple(lanes)
    fill = torch.full(
        (lanes[0].shape[0],), int(_SIGN), dtype=torch.int32, device=lanes[0].device
    )
    return tuple(lanes) + (fill,) * (n_lanes - len(lanes))


def searchsorted_lanes(keys: Tuple, qs: Tuple, side: str = "left") -> torch.Tensor:
    """Vectorized binary search of the lane tuples *qs* in the sorted lane
    tuples *keys*: branchless, a fixed trip count of bit_length(n), a
    lexicographic compare across lanes.  int32 positions."""
    n = int(keys[0].shape[0])
    shape = qs[0].shape
    dev = qs[0].device
    lo_idx = torch.zeros(shape, dtype=torch.int64, device=dev)
    if n == 0:  # every position is 0; torch cannot gather from an empty key
        return lo_idx.to(torch.int32)
    hi_idx = torch.full(shape, n, dtype=torch.int64, device=dev)
    for _ in range(max(n.bit_length(), 1)):
        active = lo_idx < hi_idx
        mid = (lo_idx + hi_idx) >> 1
        safe = mid.clamp(0, n - 1)
        lt = torch.zeros(shape, dtype=torch.bool, device=dev)
        eq = torch.ones(shape, dtype=torch.bool, device=dev)
        for k, q in zip(keys, qs):
            kv = torch.index_select(k, 0, safe)
            lt = lt | (eq & (kv < q))
            eq = eq & (kv == q)
        descend = (lt | eq) if side == "right" else lt
        lo_idx = torch.where(active & descend, mid + 1, lo_idx)
        hi_idx = torch.where(active & ~descend, mid, hi_idx)
    return lo_idx.to(torch.int32)


def _union_kernel(concat_lanes: Tuple, n_lanes: int, k_real: int):
    """Union of concatenated chunk dictionaries (any entries past
    *k_real* are padding of lane maxima, which sort last): a stable
    multi-key sort, a run-rank pass and two scatters.

    Returns (mapping[k] in concatenation order -> union slot, union lanes
    padded to k, union size as a 0-d device tensor)."""
    k = int(concat_lanes[0].shape[0])
    dev = concat_lanes[0].device
    # lax.sort(num_keys=n_lanes, is_stable=True): stable passes from the
    # least significant lane up, carrying the permutation
    perm = torch.arange(k, dtype=torch.int64, device=dev)
    for lane in reversed(concat_lanes[:n_lanes]):
        _, order = torch.sort(torch.index_select(lane, 0, perm), stable=True)
        perm = torch.index_select(perm, 0, order)
    sorted_lanes = [torch.index_select(lane, 0, perm) for lane in concat_lanes]
    neq = torch.zeros(max(k - 1, 0), dtype=torch.bool, device=dev)
    for lane_s in sorted_lanes:
        neq = neq | (lane_s[1:] != lane_s[:-1])
    new_run = torch.ones(k, dtype=torch.bool, device=dev)
    new_run[1:] = neq
    rank = torch.cumsum(new_run, 0, dtype=torch.int32) - 1
    mapping = torch.zeros(k, dtype=torch.int32, device=dev)
    mapping[perm] = rank
    # compact: each run's first sorted entry takes its rank's slot; the
    # others aim at spare slot k (the reference drops them out of range,
    # where torch's scatter would raise) which is sliced off
    run_slot = torch.where(new_run, rank, k).to(torch.int64)
    uniq = []
    for lane_s in sorted_lanes:
        u = torch.zeros(k + 1, dtype=torch.int32, device=dev)
        u[run_slot] = lane_s
        uniq.append(u[:k])
    size = (mapping[:k_real].max() + 1) if k_real else torch.zeros((), dtype=torch.int32)
    return mapping, tuple(uniq), size


def union_device(chunk_lanes: "List[Tuple[torch.Tensor, ...]]"):
    """Union per-chunk dictionary lanes on the device.

    Returns (sorted union lanes, per-chunk translation tables mapping
    chunk slot -> union slot).  The only host sync is the union size.
    The reference pads the concatenation to a power of two to bound XLA's
    recompiles; eager torch has no such need and sorts the entries as
    they are."""
    n_lanes = max(len(c) for c in chunk_lanes)
    widened = [widen_lanes_device(c, n_lanes) for c in chunk_lanes]
    sizes = [int(c[0].shape[0]) for c in widened]
    concat = tuple(torch.cat([c[i] for c in widened]) for i in range(n_lanes))
    mapping, uniq_lanes, size = _union_kernel(concat, n_lanes, sum(sizes))
    u = int(size)  # the one host sync
    union = tuple(lane[:u] for lane in uniq_lanes)
    tables = []
    off = 0
    for s in sizes:
        tables.append(mapping[off : off + s])
        off += s
    return union, tables


def fold_lanes(lanes: Tuple) -> Tuple:
    """The search form of a sorted lane dictionary: two lanes fold into
    one order-preserving int64 key, ``(lane0 << 32) + (lane1 + 2**31)``,
    which one ``torch.searchsorted`` searches; wider tuples stay lanes
    for the k-lane search.  Both sides of a search fold alike, so their
    dtypes match."""
    if len(lanes) != 2:
        return tuple(lanes)
    hi, lo = lanes
    return (torch.add(lo.to(torch.int64), hi.to(torch.int64), alpha=1 << 32).add_(1 << 31),)


def _translate_kernel(build_keys: Tuple, query_keys: Tuple) -> torch.Tensor:
    """query dictionary slot -> build dictionary slot (or -1) on the
    search forms (:func:`fold_lanes`) of two dictionaries, the build's
    sorted: one ``torch.searchsorted`` of a folded key or the k-lane
    search, then a gather and an equality check a key, on the device.
    The launches are fixed by the key count and, for the k-lane search,
    the build's size."""
    n = int(build_keys[0].shape[0])
    if n == 0:
        return torch.full(query_keys[0].shape, -1, dtype=torch.int32,
                          device=query_keys[0].device)
    (b0, *b_rest), (q0, *q_rest) = build_keys, query_keys
    if b_rest:
        pos = searchsorted_lanes(build_keys, query_keys, side="left")
    else:
        pos = torch.searchsorted(b0, q0, out_int32=True)
    safe = pos.clamp(max=n - 1)
    ok = torch.index_select(b0, 0, safe) == q0
    for b, q in zip(b_rest, q_rest):
        ok = ok & (torch.index_select(b, 0, safe) == q)
    return torch.where(ok, safe, -1)


def translate_lanes(build_lanes: Tuple, query_lanes: Tuple) -> torch.Tensor:
    """Translation table between two sorted lane dictionaries, on the
    device; lane counts are reconciled by widening the narrower, and two
    lanes fold into one int64 key (:func:`fold_lanes`)."""
    n_lanes = max(len(build_lanes), len(query_lanes))
    return _translate_kernel(
        fold_lanes(widen_lanes_device(build_lanes, n_lanes)),
        fold_lanes(widen_lanes_device(query_lanes, n_lanes)),
    )
