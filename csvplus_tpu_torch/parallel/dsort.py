"""Distributed sample sort over a mesh (explicit all-to-all).

Port of ``csvplus_tpu/parallel/dsort.py``: a classic sample sort whose
only cross-shard traffic is one slot-aligned exchange per lane, the same
exchange shape the partitioned join uses (:mod:`.pjoin`).

Algorithm (static shapes per attempt):

1. each shard sorts its block, stably;
2. every shard contributes an evenly spaced sample; the gathered pool,
   sorted, gives N-1 equal-depth splitters;
3. each element routes to ``searchsorted(splitters, x, side="right")``
   and its rank within its destination group fills an ``(N, C)`` slot
   buffer per lane (payload and validity ride extra lanes);
4. the buffers are exchanged and each shard sorts what it received,
   invalid slots last;
5. the per-shard valid prefixes, concatenated in flat shard order, are
   the sorted array; a gather packs them into a dense row-sharded result
   of the input length with no host stitch.

Validity is a lane of its own, not a sentinel value, so INT32_MAX sorts
as an ordinary key: the launcher's padding is identified by global row
position.  Narrow keys are one int32 lane; wide (<= 62-bit) keys travel
as two nonnegative 31-bit lanes compared lexicographically.  Capacity
``C`` is fixed per attempt; a shard whose rows overflow their slots
reports -1 as its count, and the caller retries with doubled capacity
after ONE scalar host sync.  Every sort is stable and equal keys route to
one destination, so the payload permutation is the stable sort
permutation.

The reference runs steps 1-4 as one body per shard under ``shard_map``;
one process drives every shard here, so :func:`_dsort_shard_kernel` runs
them as phases over all shards with the exchange between.  ``lax.sort``'s
multi-key sorts become stable ``torch.sort`` passes over one packed int64
key where the keys fit (see :func:`_lane_key`).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from .mesh import (Mesh, ShardedRows, all_gather, all_to_all, even_blocks, replicate,
                   shard_rows)
from .pjoin import _DROP_SLOTS, _scatter, _search

_MASK31 = (1 << 31) - 1


def _lane_key(lanes: Sequence[torch.Tensor]) -> torch.Tensor:
    """A key whose order is the lexicographic order of the int32 *lanes*:
    the lane itself, or for (hi, lo) one int64 ``hi << 32 | (lo + 2^31)``
    (``lo + 2^31`` is the low word as an unsigned 32-bit value)."""
    if len(lanes) == 1:
        return lanes[0]
    return (lanes[0].to(torch.int64) << 32) | (lanes[1].to(torch.int64) + (1 << 31))


def _stable_order(key: torch.Tensor) -> torch.Tensor:
    return torch.sort(key, stable=True).indices


def _invalid_last_order(valid: torch.Tensor, lanes: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable order by (invalid, lanes...): every valid entry first, in
    key order, whatever its key value."""
    inv = (~valid).to(torch.int64)
    if len(lanes) == 1:
        return _stable_order((inv << 32) | (lanes[0].to(torch.int64) + (1 << 31)))
    order = _stable_order(_lane_key(lanes))  # least significant key first
    return order[_stable_order(torch.index_select(inv, 0, order))]


def _dsort_shard_kernel(mesh: Mesh, capacity: int, samples: int, n_lanes: int, n_true: int,
                        lanes, payload):
    """Steps 1-4 over every shard.  *lanes* is one list of per-shard
    blocks per key lane, *payload* a list of per-shard blocks; global row
    positions at or past *n_true* are padding.  Returns per shard
    ``(lanes, payload, count)``: the received slots sorted with the valid
    ones first, and the valid count (-1 when this shard's rows
    overflowed their slots)."""
    n, c, s = mesh.size, capacity, samples
    m = int(payload[0].shape[0])

    # 1. local sort.  The reference sorts by (lanes, invalid); padding sits
    # at the end of the row order with every lane at INT32_MAX (the
    # largest key), so a stable sort by the lanes alone orders it the same
    local = []
    for i in range(n):
        with mesh.on(i):
            order = _stable_order(_lane_key([lane[i] for lane in lanes]))
            lanes_s = [torch.index_select(lane[i], 0, order) for lane in lanes]
            p_s = torch.index_select(payload[i], 0, order)
            v_s = order + i * m < n_true
            local.append((lanes_s, p_s, v_s))

    # 2. evenly spaced local samples -> gathered pool -> N-1 splitters
    step = max(m // s, 1)
    take = np.minimum(np.arange(s, dtype=np.int64) * step + step // 2, m - 1)
    takes = replicate(mesh, take)
    pools = [all_gather(mesh, [torch.index_select(local[i][0][k], 0, takes[i]) for i in range(n)])
             for k in range(n_lanes)]
    total = n * s
    cut = np.arange(1, n, dtype=np.int64) * (total // n)
    by_device = {}
    for i, dev in enumerate(mesh.devices):
        if dev not in by_device:
            pool = [p[i] for p in pools]
            order = _stable_order(_lane_key(pool))
            at = torch.from_numpy(cut).to(dev)
            by_device[dev] = [torch.index_select(torch.index_select(p, 0, order), 0, at)
                              for p in pool]
    splitters = [by_device[dev] for dev in mesh.devices]

    # 3. route by destination range (invalid rows go nowhere: dest N).  The
    # reference stable-sorts the rows by dest; dest is non-decreasing in
    # the local sort order already (valid rows in key order, padding last
    # with dest N), so that sort is the identity and is skipped
    sends: List[List[torch.Tensor]] = [[] for _ in range(n_lanes + 2)]
    overflow = []
    for i in range(n):
        with mesh.on(i):
            lanes_s, p_s, v_s = local[i]
            dest = torch.where(v_s, _search(splitters[i], lanes_s, "right"), n)
            routed = dest < n
            group_start = torch.searchsorted(
                dest, torch.arange(n + 1, dtype=torch.int32, device=dest.device), out_int32=True)
            rank = torch.arange(m, dtype=torch.int32, device=dest.device) - \
                torch.index_select(group_start, 0, dest)
            ok = routed & (rank < c)
            drop = n * c + torch.arange(m, device=dest.device) % _DROP_SLOTS
            slot = torch.where(ok, dest.clamp(max=n - 1).to(torch.int64) * c + rank, drop)
            for k, lane in enumerate(lanes_s + [p_s]):
                sends[k].append(_scatter(n, c, slot, lane, 0))
            sends[-1].append(_scatter(n, c, slot, torch.ones_like(p_s), 0))
            overflow.append((routed & (rank >= c)).any())
    local = None

    # 4. one exchange per lane, then sort what arrived: validity first, so
    # every real element precedes the empty slots whatever its value
    recv = [all_to_all(mesh, b) for b in sends]
    del sends
    out = []
    for d in range(n):
        with mesh.on(d):
            rv = recv[-1][d].reshape(-1) > 0
            r_lanes = [recv[k][d].reshape(-1) for k in range(n_lanes)]
            order = _invalid_last_order(rv, r_lanes)
            out_lanes = [torch.index_select(lane, 0, order) for lane in r_lanes]
            out_p = torch.index_select(recv[n_lanes][d].reshape(-1), 0, order)
            count = torch.where(overflow[d], -1, rv.sum())
            out.append((out_lanes, out_p, count))
    return out


def _dsort_spmd(mesh: Mesh, n_shards: int, capacity: int, samples: int, n_lanes: int,
                n_true: int, lanes, payload):
    """One attempt: pad to mesh divisibility on the devices, run the
    shard phases, then pack the valid slots into the first *n_true*
    positions (the reference's global cumsum compaction, as a gather).
    Returns ``(dense lanes..., dense payload, overflow flag)``: the dense
    arrays as :class:`ShardedRows` of ``ceil(n_true / N)`` rows a shard
    (the tail shorter)."""
    lane_blocks = [even_blocks(mesh, lane, _MASK31)[0] for lane in lanes]
    pay_blocks = even_blocks(mesh, payload, -1)[0]
    per_shard = _dsort_shard_kernel(mesh, capacity, samples, n_lanes, n_true, lane_blocks,
                                    pay_blocks)
    dev0 = mesh.devices[0]
    counts = torch.stack([p[2].to(dev0) for p in per_shard]).to(torch.int64)
    overflow = (counts < 0).any()
    # shard-major valid prefixes -> dense positions: output row p comes
    # from shard src(p), slot p - start[src]
    counts = counts.clamp(min=0)
    ends = torch.cumsum(counts, 0)
    starts = ends - counts
    width = int(per_shard[0][1].shape[0])  # N * C slots a shard
    ends_on, starts_on = replicate(mesh, ends), replicate(mesh, starts)
    q = -(-n_true // n_shards)
    cols = [[p[0][k] for p in per_shard] for k in range(n_lanes)] + [[p[1] for p in per_shard]]
    del per_shard
    # every shard's slots on each distinct device (one copy on one card)
    stacked = {dev: [torch.cat([x.to(dev) for x in col]) for col in cols]
               for dev in mesh.distinct_devices}
    del cols
    dense: List[List[torch.Tensor]] = [[] for _ in range(n_lanes + 1)]
    for i, dev in enumerate(mesh.devices):
        with mesh.on(i):
            pos = torch.arange(min(i * q, n_true), min((i + 1) * q, n_true), dtype=torch.int64,
                               device=dev)
            src = torch.searchsorted(ends_on[i], pos, right=True).clamp(max=n_shards - 1)
            j = (pos - torch.index_select(starts_on[i], 0, src)).clamp(0, width - 1)
            flat = src * width + j
            for k, full in enumerate(stacked[dev]):
                dense[k].append(torch.index_select(full, 0, flat))
    out = tuple(ShardedRows(mesh, d) for d in dense)
    return out + (overflow,)


def _capacity_plan(n: int, n_shards: int, capacity: "int | None") -> Tuple[int, int, int]:
    """(initial capacity, max capacity, samples) for *n* global rows."""
    padded = n + ((-n) % n_shards)
    m_per_shard = max(padded // n_shards, 1)
    if capacity is None:
        # balanced routing sends ~m_per_shard/N to each destination; the
        # retry doubles toward the always-sufficient m_per_shard
        capacity = max(64, 4 * ((m_per_shard + n_shards - 1) // n_shards))
    capacity = 1 << (int(capacity) - 1).bit_length()
    cap_max = 1 << (m_per_shard - 1).bit_length()
    capacity = min(capacity, cap_max)
    samples = min(64, max(8, m_per_shard))
    return capacity, cap_max, samples


def distributed_sort_device(
    mesh: Mesh,
    lanes: Tuple,
    payload,
    capacity: "int | None" = None,
) -> Tuple[Tuple[ShardedRows, ...], ShardedRows]:
    """Device-resident sample sort: *lanes* (1 int32 lane, or 2
    nonnegative 31-bit lanes in (hi, lo) order) and an int32 *payload*
    (tensors or :class:`ShardedRows`) stay on the devices end to end; the
    only host sync is one overflow scalar per capacity attempt.  Returns
    (sorted lanes, permuted payload) as dense :class:`ShardedRows` of the
    input length."""
    from ..utils.observe import telemetry

    n_shards = mesh.size
    n = int(lanes[0].shape[0])
    if n == 0:
        return lanes, payload
    capacity, cap_max, samples = _capacity_plan(n, n_shards, capacity)
    while True:
        out = _dsort_spmd(mesh, n_shards, capacity, samples, len(lanes), n, tuple(lanes),
                          payload)
        telemetry.count_sync(1)
        if not bool(out[-1]):  # one O(1) scalar sync an attempt
            return out[: len(lanes)], out[len(lanes)]
        if capacity >= cap_max:
            # C = m_per_shard always suffices (a source shard cannot send
            # more rows than it holds): this guards a logic regression
            raise RuntimeError("distributed_sort: capacity overflow at maximum")
        capacity *= 2


def distributed_sort(
    mesh: Mesh,
    values: np.ndarray,
    payload: "np.ndarray | None" = None,
    capacity: "int | None" = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Globally sort an int32 or int64 (<= 62-bit packed) value array,
    with an optional int32 payload permuted alongside, through the sample
    sort.  Host-facing wrapper over :func:`distributed_sort_device`: int64
    keys travel as dual 31-bit lanes.  Returns ``(sorted_values,
    permuted_payload)``; with no *payload* it is the sort permutation."""
    values = np.asarray(values)
    n = values.shape[0]
    if payload is None:
        payload = np.arange(n, dtype=np.int32)
    payload = np.asarray(payload)
    if payload.dtype != np.int32:
        # payloads are row ids; refuse loudly rather than truncate
        raise TypeError(f"distributed_sort: int32 payload required, got {payload.dtype}")
    if n == 0:
        return values, payload
    dev0 = mesh.devices[0]

    def put(a):
        if n % mesh.size == 0:
            return shard_rows(mesh, a)
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev0)

    if values.dtype == np.int64:
        if (values < 0).any() or (values >= (1 << 62)).any():
            raise TypeError("distributed_sort: int64 keys must fit 62 bits")
        from .pjoin import split_lanes

        hi, lo = split_lanes(values)
        (out_hi, out_lo), pays = distributed_sort_device(mesh, (put(hi), put(lo)), put(payload),
                                                         capacity)
        vals = (out_hi.numpy().astype(np.int64) << 31) | out_lo.numpy()
        return vals, pays.numpy()
    if values.dtype != np.int32:
        raise TypeError(f"distributed_sort: int32/int64 values required, got {values.dtype}")
    (out,), pays = distributed_sort_device(mesh, (put(values),), put(payload), capacity)
    return out.numpy(), pays.numpy()
