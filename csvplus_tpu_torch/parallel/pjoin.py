"""Partitioned lookup join: the all-to-all key shuffle over a mesh.

Port of ``csvplus_tpu/parallel/pjoin.py`` (BASELINE.json config 5's
"8-way sharded orders.csv join ... with all-to-all key shuffle").

Design, as in the reference (static shapes, no data-dependent control
flow between launches):

* the build side is **range-partitioned over its UNIQUE packed keys**:
  each shard owns a contiguous equal-size slice of the distinct keys, and
  every key carries its precomputed global answer (first-match row, run
  length) as an int32 payload, so duplicates never travel and build-side
  skew costs a heavy key's owner one slot;
* each shard routes its probe keys to the owning shard, ranks them within
  their destination group in row order, scatters them into an ``(N, C)``
  slot buffer and the buffers are exchanged (:func:`.mesh.all_to_all`);
* the owner answers every received probe with ``(global lower bound,
  match count)`` from a local binary search, and a reverse exchange
  returns the answers through the same slots;
* capacity ``C`` (slots per destination) is fixed per attempt; overflow
  shows as a -1 count and the probe retries with doubled capacity after
  ONE scalar host sync;
* probe-side heavy hitters are detected from a bounded strided sample
  (:func:`_detect_hot`) and answered once through a replicated broadcast
  tier, and the tail's capacity shrinks by their share
  (:func:`_skew_capacity`); ``CSVPLUS_JOIN_SKEW=0`` turns the tier off.

The reference runs one body per shard under ``shard_map`` with
``lax.all_to_all`` inside it.  One process drives every shard here, so
:func:`_probe_shard_kernel` runs that body as five phases over all shards
(route and scatter; exchange; local search; exchange back; gather the
answers), each phase keeping the reference's shapes.  Results are
:class:`~.mesh.ShardedRows`.  The reference's ``_renamed_rows`` has no
counterpart: it re-labels a GSPMD result's sharding, and a
``ShardedRows`` carries its mesh already.  ``register_kernel`` (the
reference's compile-cache bookkeeping) has none either: nothing here is
traced.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..utils.env import env_int, env_str
from .mesh import Mesh, ShardedRows, all_to_all, even_blocks, replicate, shard_rows, unpad

_SENTINEL = np.int32(np.iinfo(np.int32).max)
# 62-bit sentinel for wide (int64) keys: packed keys keep headroom below
# it (DeviceIndex's bit budget reserves a slot above every code range)
_SENT62 = np.int64((1 << 62) - 1)
# Scatter slots past the (N, C) buffer that take the dropped writes (the
# reference's ``mode="drop"``; torch raises on an out-of-range index).
# Spread over many slots so a mostly-dropped scatter does not pile its
# stores onto one address.
_DROP_SLOTS = 1024


def partition_tier_selected(
    n_keys: int, *, full_width: bool = True, stream_sharded: bool = True,
    min_keys: "int | None" = None,
) -> bool:
    """The one policy predicate for choosing the range-partitioned tier
    over broadcast replication: a full-width probe of at least
    ``min_keys`` build keys by a mesh-sharded stream.  The plan verifier's
    placement rule calls it, so the static model and the executor share
    one threshold."""
    if min_keys is None:
        from ..ops.join import DeviceIndex

        min_keys = DeviceIndex.PARTITION_MIN_KEYS
    return bool(full_width and stream_sharded and int(n_keys) >= int(min_keys))


def _sentinel_for(dtype) -> "np.int32 | np.int64":
    return _SENT62 if np.dtype(dtype) == np.int64 else _SENTINEL


def split_lanes(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """int64 keys -> two nonnegative 31-bit int32 lanes; -1 -> (-1, -1).
    The 62-bit sentinel maps to (MASK31, MASK31), still the maximum in
    lane order."""
    hi = (x >> 31).astype(np.int32)
    lo = (x & np.int64((1 << 31) - 1)).astype(np.int32)
    neg = x < 0
    if neg.any():
        hi = np.where(neg, np.int32(-1), hi)
        lo = np.where(neg, np.int32(-1), lo)
    return hi, lo


def partition_build_keys(
    keys: np.ndarray, n_shards: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Range-partition a sorted build key array (int32 or int64) into
    equal slices of its UNIQUE keys, each key carrying its precomputed
    global answer.

    Returns (uniq_local[(N, k)] padded with the dtype's sentinel,
    lower_local[(N, k)] int32 global first-match row, count_local[(N, k)]
    int32 run length, splits[(N,)] = first unique key per shard)."""
    sent = _sentinel_for(keys.dtype)
    uniq, first, counts = np.unique(keys, return_index=True, return_counts=True)
    u = uniq.shape[0]
    if u == 0:
        return (
            np.full((n_shards, 1), sent, dtype=keys.dtype),
            np.zeros((n_shards, 1), dtype=np.int32),
            np.zeros((n_shards, 1), dtype=np.int32),
            np.full(n_shards, sent, dtype=keys.dtype),
        )
    bounds = (np.arange(n_shards, dtype=np.int64) * u) // n_shards
    ends = np.append(bounds[1:], u)
    sizes = ends - bounds
    k = max(int(sizes.max()), 1)
    local = np.full((n_shards, k), sent, dtype=keys.dtype)
    lower = np.zeros((n_shards, k), dtype=np.int32)
    count = np.zeros((n_shards, k), dtype=np.int32)
    for s in range(n_shards):
        local[s, : sizes[s]] = uniq[bounds[s] : ends[s]]
        lower[s, : sizes[s]] = first[bounds[s] : ends[s]]
        count[s, : sizes[s]] = counts[bounds[s] : ends[s]]
    # splits must be non-decreasing for the routing search: an empty shard
    # inherits the NEXT non-empty shard's first key, so equal splits route
    # (side='right') to the right-most shard, the actual owner
    splits = np.full(n_shards, sent, dtype=keys.dtype)
    nxt = sent
    for s in range(n_shards - 1, -1, -1):
        if sizes[s] > 0:
            nxt = local[s, 0]
        splits[s] = nxt
    return local, lower, count, splits


# -- the per-shard phases ----------------------------------------------------


def _search(sorted_lanes: Sequence[torch.Tensor], q_lanes: Sequence[torch.Tensor],
            side: str) -> torch.Tensor:
    """int32 searchsorted of one lane, or of (hi, lo) lane pairs compared
    lexicographically (``ops/join._searchsorted2``)."""
    if len(sorted_lanes) == 1:
        return torch.searchsorted(sorted_lanes[0], q_lanes[0], right=side == "right",
                                  out_int32=True)
    from ..ops.join import _searchsorted2

    return _searchsorted2(sorted_lanes[0], sorted_lanes[1], q_lanes[0], q_lanes[1],
                          side=side).to(torch.int32)


def _group_rank(dest: torch.Tensor, n: int) -> torch.Tensor:
    """Each row's rank within its destination group, in row order (the
    reference's one-hot running count).  One int32 running count per
    destination keeps the working set at one column, where the one-hot
    matrix would hold N columns of every shard's rows at once.  Rows with
    dest N (not routed) get rank 0; nothing reads it."""
    rank = torch.zeros_like(dest)
    for d in range(n):
        hit = dest == d
        rank = torch.where(hit, torch.cumsum(hit, 0, dtype=torch.int32) - 1, rank)
    return rank


def _slots(n: int, capacity: int, dest: torch.Tensor, routed: torch.Tensor):
    """(safe dest, rank, ok, flat slot) of each row: slot ``dest * C +
    rank`` for a routed row within capacity, else one of the drop slots
    past the buffer."""
    safe_dest = dest.clamp(max=n - 1)
    rank = _group_rank(dest, n)
    ok = routed & (rank < capacity)
    drop = n * capacity + torch.arange(dest.shape[0], device=dest.device) % _DROP_SLOTS
    slot = torch.where(ok, safe_dest.to(torch.int64) * capacity + rank, drop)
    return safe_dest, rank, ok, slot


def _scatter(n: int, capacity: int, slot: torch.Tensor, values: torch.Tensor, fill: int):
    """The ``(N, C)`` slot buffer holding *values* at their slots; rows
    whose slot is a drop slot are dropped."""
    buf = torch.full((n * capacity + _DROP_SLOTS,), fill, dtype=values.dtype,
                     device=values.device)
    buf[slot] = values
    return buf[: n * capacity].view(n, capacity)


def _probe_exchange(mesh: Mesh, capacity: int, q_lanes, uniq_lanes, lower, count, split_lanes_):
    """The per-shard body of the reference's probe kernels, run as phases
    over every shard.  Each argument is a list of per-shard tensors
    (``q_lanes``/``uniq_lanes``/``split_lanes_`` one list per key lane).
    Returns per-shard (lo, ct) lists: ``lo`` the global first match (-1
    where none or overflowed), ``ct`` the run length (0 for an invalid
    probe, -1 for a routed probe that overflowed its slots)."""
    n, c = mesh.size, capacity
    # 1. route and scatter
    routes = []
    sends: List[List[torch.Tensor]] = [[] for _ in q_lanes]
    for i in range(n):
        with mesh.on(i):
            q = [lane[i] for lane in q_lanes]
            valid = q[0] >= 0
            dest = (_search([s[i] for s in split_lanes_], q, "right") - 1).clamp(0, n - 1)
            # invalid probes (absent keys, hot keys answered elsewhere) get
            # dest N: they take no slot and answer (-1, 0)
            dest = torch.where(valid, dest, n)
            safe_dest, rank, ok, slot = _slots(n, c, dest, valid)
            routes.append((valid, safe_dest, rank, ok))
            for k, lane in enumerate(q):
                sends[k].append(_scatter(n, c, slot, lane, -1))
    # 2. exchange
    recv = [all_to_all(mesh, s) for s in sends]
    del sends
    # 3. local search over each shard's unique-key slice; the answer is
    # the key's precomputed (global lower, run length) payload
    resp_lo, resp_ct = [], []
    for d in range(n):
        with mesh.on(d):
            qd = [r[d].reshape(-1) for r in recv]
            k = int(uniq_lanes[0][d].shape[0])
            idx = _search([u[d] for u in uniq_lanes], qd, "left").clamp(max=k - 1)
            found = qd[0] >= 0
            for u, qq in zip(uniq_lanes, qd):
                found = found & (torch.index_select(u[d], 0, idx) == qq)
            resp_lo.append(torch.where(found, torch.index_select(lower[d], 0, idx), -1).view(n, c))
            resp_ct.append(torch.where(found, torch.index_select(count[d], 0, idx), 0).view(n, c))
    del recv
    # 4. answers ride home through the same slots
    back_lo = all_to_all(mesh, resp_lo)
    back_ct = all_to_all(mesh, resp_ct)
    del resp_lo, resp_ct
    # 5. gather: ranks are in row order already, so no un-permute
    out_lo, out_ct = [], []
    for i in range(n):
        with mesh.on(i):
            valid, safe_dest, rank, ok = routes[i]
            flat = safe_dest.to(torch.int64) * c + rank.clamp(0, c - 1)
            got_lo = torch.where(ok, torch.index_select(back_lo[i].reshape(-1), 0, flat), -1)
            got_ct = torch.where(
                valid, torch.where(ok, torch.index_select(back_ct[i].reshape(-1), 0, flat), -1), 0)
            out_lo.append(got_lo)
            out_ct.append(got_ct)
    return out_lo, out_ct


def _probe_shard_kernel(mesh: Mesh, capacity: int, qk, uniq_local, lower_local, count_local,
                        splits):
    """Narrow (int32) probe over the mesh: :func:`_probe_exchange` with
    one key lane.  *qk*, *uniq_local*, *lower_local*, *count_local* and
    *splits* are per-shard tensor lists."""
    return _probe_exchange(mesh, capacity, [qk], [uniq_local], lower_local, count_local,
                           [splits])


def _probe_shard_kernel2(mesh: Mesh, capacity: int, qh, ql, uniq_hi, uniq_lo, lower_local,
                         count_local, splits_hi, splits_lo):
    """Dual-lane (62-bit key) variant of :func:`_probe_shard_kernel`: the
    same routing and exchange with the key carried as two nonnegative
    31-bit int32 lanes, every comparison lexicographic over (hi, lo); one
    more ``(N, C)`` exchange for the second lane."""
    return _probe_exchange(mesh, capacity, [qh, ql], [uniq_hi, uniq_lo], lower_local,
                           count_local, [splits_hi, splits_lo])


def _probe_spmd(mesh, n_shards, capacity, qk_sharded: ShardedRows, uniq, lower, count, splits):
    """One exchange of an evenly sharded probe array (the hot tier's)."""
    lo, ct = _probe_shard_kernel(mesh, capacity, qk_sharded.shards, uniq.shards, lower.shards,
                                 count.shards, splits)
    return ShardedRows(mesh, lo), ShardedRows(mesh, ct)


def _probe_spmd2(mesh, n_shards, capacity, qh: ShardedRows, ql: ShardedRows, uniq_hi, uniq_lo,
                 lower, count, splits_hi, splits_lo):
    lo, ct = _probe_shard_kernel2(mesh, capacity, qh.shards, ql.shards, uniq_hi.shards,
                                  uniq_lo.shards, lower.shards, count.shards, splits_hi,
                                  splits_lo)
    return ShardedRows(mesh, lo), ShardedRows(mesh, ct)


def prepare_partitioned(mesh: Mesh, index_keys_sorted: np.ndarray):
    """Range-partition and upload the build keys once; reusable across
    probes.

    int32 keys -> a 4-tuple (uniq, lower, count, splits); int64 (wide,
    62-bit) keys -> a 6-tuple with the unique keys and splits as dual
    31-bit lanes (uniq_hi, uniq_lo, lower, count, splits_hi, splits_lo).
    The per-shard slices are :class:`~.mesh.ShardedRows`, the splits
    replicated tuples (one tensor per distinct device)."""
    from ..utils.observe import telemetry

    n_shards = mesh.size
    with telemetry.stage("join:partition", int(index_keys_sorted.shape[0])) as _p:
        _p["n_shards"] = n_shards
        if np.dtype(index_keys_sorted.dtype) == np.int64:
            local, lower, count, splits = partition_build_keys(index_keys_sorted, n_shards)
            lh, ll = split_lanes(local.reshape(-1))
            sh, sl = split_lanes(splits)
            out = (shard_rows(mesh, lh), shard_rows(mesh, ll), shard_rows(mesh, lower.reshape(-1)),
                   shard_rows(mesh, count.reshape(-1)), replicate(mesh, sh), replicate(mesh, sl))
        else:
            local, lower, count, splits = partition_build_keys(
                index_keys_sorted.astype(np.int32), n_shards)
            out = (shard_rows(mesh, local.reshape(-1)), shard_rows(mesh, lower.reshape(-1)),
                   shard_rows(mesh, count.reshape(-1)), replicate(mesh, splits))
        telemetry.barrier(_tensors(out))
        return out


def _tensors(values) -> tuple:
    """Every tensor of a tuple of tensors, ShardedRows and replicated
    tuples (for ``telemetry.barrier``)."""
    flat = []
    for v in values:
        if isinstance(v, ShardedRows):
            flat.extend(v.shards)
        elif isinstance(v, (tuple, list)):
            flat.extend(v)
        else:
            flat.append(v)
    return tuple(flat)


def partitioned_probe(
    mesh: Mesh,
    stream_keys: np.ndarray,
    index_keys_sorted: np.ndarray,
    capacity: "int | None" = None,
    prepared=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """All-to-all partitioned probe: for every stream key, the global
    ``[lower, lower+count)`` match range in the sorted index key array.

    Host-facing numpy shim over :func:`partitioned_probe_device` /
    ``_wide``, which own the padding, the hot-key short circuit and the
    capacity retry.  Keys are packed keys with -1 for invalid probes:
    int32 for narrow keys, int64 for wide (<= 62-bit) keys, which travel
    as dual 31-bit lanes.  *prepared* skips the partition and upload
    (:func:`prepare_partitioned`).  The keys go up to the mesh's first
    device, as the reference's go to the default device."""
    wide = np.dtype(stream_keys.dtype) == np.int64
    if prepared is None:
        prepared = prepare_partitioned(mesh, index_keys_sorted)
    if len(prepared) != (6 if wide else 4):
        raise ValueError("partitioned_probe: prepared build side and key dtype mismatch")
    dev0 = mesh.devices[0]
    if wide:
        qh, ql = split_lanes(stream_keys)
        lo, ct = partitioned_probe_device_wide(
            mesh, torch.from_numpy(qh).to(dev0), torch.from_numpy(ql).to(dev0), prepared,
            capacity)
    else:
        qk = torch.from_numpy(np.ascontiguousarray(stream_keys, dtype=np.int32)).to(dev0)
        lo, ct = partitioned_probe_device(mesh, qk, prepared, capacity)
    return lo.numpy(), ct.numpy()


# -- device-resident orchestration -----------------------------------------
#
# Probe keys, answers, the hot-key merge, the padding and the overflow flag
# stay on the devices: the only host syncs are a bounded hot-key sample and
# one overflow scalar per attempt (two scalars, one transfer, when the
# attempt carries the hot tier).


def _hot_mask(mesh: Mesh, n_hot: int, q_lanes, hot_lanes):
    """Per shard: (hit mask, hot slot) of each probe row against the
    replicated sorted hot values."""
    out = []
    for i in range(mesh.size):
        with mesh.on(i):
            q = [lane[i] for lane in q_lanes]
            h = [lane[i] for lane in hot_lanes]
            idxc = _search(h, q, "left").clamp(max=n_hot - 1)
            hit = q[0] >= 0
            for hh, qq in zip(h, q):
                hit = hit & (torch.index_select(hh, 0, idxc) == qq)
            out.append((hit, idxc))
    return out


def _probe_dev(mesh, n_hot, q_lanes_in, kernel, hot_lanes, hot_lo, hot_ct):
    """Shared body of :func:`_probe_spmd_dev` / ``2``: hot-key mask ->
    pad -> exchange -> hot-key merge -> un-pad -> overflow flag (and the
    broadcast tier's row count when it is on)."""
    blocks = []
    m = 0
    for lane in q_lanes_in:
        b, m = even_blocks(mesh, lane, -1)
        blocks.append(b)
    hits = _hot_mask(mesh, n_hot, blocks, hot_lanes) if n_hot else None
    if hits is not None:
        blocks = [[torch.where(hits[i][0], -1, lane[i]) for i in range(mesh.size)]
                  for lane in blocks]
    lo, ct = kernel(blocks)
    if hits is not None:
        for i, (hit, idxc) in enumerate(hits):
            with mesh.on(i):
                h_lo = torch.index_select(hot_lo[i], 0, idxc)
                h_ct = torch.index_select(hot_ct[i], 0, idxc)
                lo[i] = torch.where(hit, torch.where(h_ct > 0, h_lo, -1), lo[i])
                ct[i] = torch.where(hit, h_ct, ct[i])
    lo, ct = unpad(lo, m), unpad(ct, m)
    dev0 = mesh.devices[0]
    overflow = torch.stack([(c < 0).any().to(dev0) for c in ct]).any()
    res = (ShardedRows(mesh, lo), ShardedRows(mesh, ct), overflow)
    if hits is None:
        return res
    n_hit = torch.stack([hit.sum().to(dev0) for hit, _ in hits]).sum()
    return res + (n_hit,)


def _probe_spmd_dev(mesh, n_shards, capacity, n_hot, qk, uniq, lower, count, splits,
                    hot_vals, hot_lo, hot_ct):
    """One attempt of the narrow device probe.  *n_hot* = 0 runs without
    the hot tier (the hot operands are unused) and returns ``(lo, ct,
    overflow)``; *n_hot* > 0 also returns the number of probe rows the
    broadcast tier answered, read with the overflow flag in one
    transfer."""
    def kernel(blocks):
        return _probe_shard_kernel(mesh, capacity, blocks[0], uniq.shards, lower.shards,
                                   count.shards, splits)

    return _probe_dev(mesh, n_hot, [qk], kernel, [hot_vals], hot_lo, hot_ct)


def _probe_spmd_dev2(mesh, n_shards, capacity, n_hot, qh, ql, uniq_hi, uniq_lo, lower, count,
                     splits_hi, splits_lo, hot_hi, hot_lo_lane, hot_ans_lo, hot_ans_ct):
    """Wide-key (dual 31-bit lane) variant of :func:`_probe_spmd_dev`."""
    def kernel(blocks):
        return _probe_shard_kernel2(mesh, capacity, blocks[0], blocks[1], uniq_hi.shards,
                                    uniq_lo.shards, lower.shards, count.shards, splits_hi,
                                    splits_lo)

    return _probe_dev(mesh, n_hot, [qh, ql], kernel, [hot_hi, hot_lo_lane],
                      hot_ans_lo, hot_ans_ct)


def _pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def _default_capacity(m: int, n_shards: int) -> int:
    m_per_shard = (m + n_shards - 1) // n_shards
    return _pow2(max(64, 2 * ((m_per_shard + n_shards - 1) // n_shards)))


def skew_enabled() -> bool:
    """``CSVPLUS_JOIN_SKEW=0`` disables all hot-key handling (the parity
    hatch): no detection, no broadcast tier, default tail capacity.  Read
    per call so one process can flip it between runs."""
    return env_str("CSVPLUS_JOIN_SKEW", "1") != "0"


def skew_threshold(n_shards: int) -> float:
    """Heavy-hitter share threshold tau (``CSVPLUS_JOIN_SKEW_THRESHOLD``,
    default ``1/(2*n_shards)``): a key with that share adds a 50 %
    overload to its owner under repartition, where the slot buffer must
    grow a power of two, while broadcasting it costs one replicated
    answer slot."""
    v = env_str("CSVPLUS_JOIN_SKEW_THRESHOLD")
    if v:
        return max(float(v), 1e-6)
    return 1.0 / (2.0 * max(int(n_shards), 1))


def _skew_sample_cap() -> int:
    """Sample-size cap (``CSVPLUS_JOIN_SKEW_SAMPLE``, default 4096, the
    bound the sync-accounting tests pin)."""
    return max(env_int("CSVPLUS_JOIN_SKEW_SAMPLE", 4096), 64)


def _strided_host(x, step: int) -> np.ndarray:
    """``x[::step]`` of the logical array *x* (a tensor or
    :class:`ShardedRows`) on the host: each shard gives its own rows of
    the global stride."""
    if isinstance(x, torch.Tensor):
        return x[::step].cpu().numpy()
    parts = []
    off = 0
    for s in x.shards:
        parts.append(s[(-off) % step::step].cpu().numpy())
        off += int(s.shape[0])
    return np.concatenate(parts)


def _detect_hot(qk_dev, n_shards: int, wide: bool):
    """Sketch-driven heavy-hitter detection over a bounded strided device
    sample: a host transfer bounded by the sample cap, not the probe
    length.

    The sample's (value, count) aggregate feeds a :class:`SpaceSaving`
    sketch with ``k = ceil(4/tau)`` tracked keys; a key is heavy only when
    its guaranteed lower bound clears ``count - err >= max(8,
    tau*sample/2)``, so every key whose sample share reaches tau survives
    and every key that clears the bar holds at least tau/2.

    Returns ``(hot, hot_share)``: sorted distinct hot values (int64 wide,
    int32 narrow) or None, and their share of the sample from the exact
    sample counts (the tail-capacity hint must never overshoot)."""
    from ..obs.sketch import SpaceSaving
    from ..utils.observe import telemetry

    if not skew_enabled():
        return None, 0.0
    m = int(qk_dev[0].shape[0] if wide else qk_dev.shape[0])
    if m < 4 * n_shards:
        return None, 0.0
    tau = skew_threshold(n_shards)
    with telemetry.stage("join:skew-detect", m) as _d:
        cap = _skew_sample_cap()
        step = max(1, -(-m // cap))  # ceil: the sample stays <= cap elements
        if wide:
            hi = _strided_host(qk_dev[0], step)
            lo = _strided_host(qk_dev[1], step)
            telemetry.count_sync(hi.size + lo.size)
            sample = (hi.astype(np.int64) << 31) | np.where(lo >= 0, lo, 0)
            sample = sample[hi >= 0]
        else:
            sample = _strided_host(qk_dev, step)
            telemetry.count_sync(sample.size)
            sample = sample[sample >= 0]
        _d["threshold"] = round(tau, 6)
        _d["sample"] = int(sample.size)
        _d["hot_keys"] = 0
        if not sample.size:
            return None, 0.0
        vals, cnts = np.unique(sample, return_counts=True)
        sk = SpaceSaving(k=min(max(int(math.ceil(4.0 / tau)), 8), 4096))
        sk.offer_counts(vals, cnts)
        bar = max(8.0, tau * sample.size / 2.0)
        hot_list = [key for key, c, e in sk.topk() if (c - e) >= bar]
        _d["hot_keys"] = len(hot_list)
        if not hot_list:
            return None, 0.0
        hot = np.sort(np.asarray(hot_list, dtype=np.int64 if wide else np.int32))
        hot_share = float(cnts[np.isin(vals, hot)].sum()) / float(sample.size)
        _d["hot_share"] = round(hot_share, 4)
        return hot, hot_share


def _skew_capacity(m: int, n_shards: int, hot_share: float) -> int:
    """Sketch-informed tail capacity: the broadcast tier removes
    ``hot_share`` of the rows from the exchange, so the slots cover the
    tail with 1.5x slack; clamped to the skew-naive default and floored
    like it (an undershoot costs one retry, never correctness)."""
    tail = max(1.0 - hot_share, 0.0)
    m_per_shard = (m + n_shards - 1) // n_shards
    want = int(math.ceil(1.5 * tail * m_per_shard / n_shards))
    return min(_pow2(max(64, want)), _default_capacity(m, n_shards))


def _note_skew(label, m: int, hot_keys: int, rows_broadcast: int, capacity: int,
               threshold: float) -> None:
    """The routing split of one skew-engaged probe: a ``join:skew`` row in
    the stage table (``seconds=0``: an accounting record) and the
    process-global ``csvplus_join_*`` counters."""
    from ..obs.joinskew import joinskew
    from ..utils.observe import telemetry

    rows_repartitioned = int(m) - int(rows_broadcast)
    telemetry.add_stage(
        "join:skew", m, m, 0.0,
        hot_keys=int(hot_keys),
        rows_broadcast=int(rows_broadcast),
        rows_repartitioned=rows_repartitioned,
        capacity=int(capacity),
        threshold=round(float(threshold), 6),
    )
    joinskew.on_join(label or "packed", int(hot_keys), int(rows_broadcast), rows_repartitioned)


def _hot_answers_device(mesh: Mesh, hot: np.ndarray, prepared, wide: bool):
    """Answer the few distinct hot values themselves through the same
    exchange (capacity = the padded hot count: it cannot overflow).
    Returns replicated (value lanes, lo, ct), padded to a power of two:
    the values by repeating the last real one (the array stays sorted and
    a left search always lands on a real slot), the answers with (-1, 0)."""
    n_shards = mesh.size
    n_hot = _pow2(hot.size)
    padded = max(n_hot, n_shards) if n_hot % n_shards else n_hot
    padded = padded + ((-padded) % n_shards)
    cap = _pow2(padded)  # worst case: every hot value routes to one shard
    if wide:
        hv = np.full(padded, -1, dtype=np.int64)
        hv[: hot.size] = hot
        qh, ql = split_lanes(hv)
        uh, ul, lower, count, sh, sl = prepared
        lo, ct = _probe_spmd2(mesh, n_shards, cap, shard_rows(mesh, qh), shard_rows(mesh, ql),
                              uh, ul, lower, count, sh, sl)
        hh, hl = split_lanes(hot)
        pad_hi = np.full(n_hot, hh[-1], np.int32)
        pad_lo = np.full(n_hot, hl[-1], np.int32)
        pad_hi[: hot.size] = hh
        pad_lo[: hot.size] = hl
        vals = (replicate(mesh, pad_hi), replicate(mesh, pad_lo))
    else:
        hv = np.full(padded, -1, dtype=np.int32)
        hv[: hot.size] = hot
        uniq, lower, count, splits = prepared
        lo, ct = _probe_spmd(mesh, n_shards, cap, shard_rows(mesh, hv), uniq, lower, count,
                             splits)
        pad_v = np.full(n_hot, hot[-1], np.int32)
        pad_v[: hot.size] = hot
        vals = (replicate(mesh, pad_v),)
    dev0 = mesh.devices[0]
    ans_lo = lo.gather(dev0)[: hot.size]
    ans_ct = ct.gather(dev0)[: hot.size]
    if hot.size < n_hot:
        ans_lo = torch.cat([ans_lo, torch.full((n_hot - hot.size,), -1, dtype=torch.int32,
                                               device=dev0)])
        ans_ct = torch.cat([ans_ct, torch.zeros(n_hot - hot.size, dtype=torch.int32,
                                                device=dev0)])
    return vals, replicate(mesh, ans_lo), replicate(mesh, ans_ct)


def _retry_probe_device(mesh: Mesh, m: int, capacity: "int | None", launch):
    """Shared retry loop: geometric capacity doubling keyed off ONE
    overflow scalar per attempt (the loop's only host sync; the hot tier's
    row count rides the same transfer).  Returns ``((lo, ct),
    rows_broadcast, capacity)``."""
    from ..utils.observe import telemetry

    n_shards = mesh.size
    if capacity is None:
        capacity = _default_capacity(m, n_shards)
    padded_m = m + ((-m) % n_shards)
    retries = 0
    # the exchange stage covers the whole attempt: shuffle, local probe,
    # answer return and hot merge
    with telemetry.stage("join:all_to_all", m) as _x:
        while True:
            res = launch(capacity)
            lo, ct, overflow = res[0], res[1], res[2]
            if len(res) > 3:
                ov, hits = torch.stack([overflow.to(torch.int64), res[3].to(torch.int64)]).tolist()
                telemetry.count_sync(2)
                overflowed, rows_broadcast = bool(ov), int(hits)
            else:
                telemetry.count_sync(1)
                overflowed, rows_broadcast = bool(overflow), 0  # one O(1) scalar sync
            if not overflowed:
                _x["capacity"] = capacity
                _x["retries"] = retries
                telemetry.barrier(lo.shards + ct.shards)
                return (lo, ct), rows_broadcast, capacity
            if capacity >= max(padded_m, 1):
                raise RuntimeError("partitioned probe: capacity overflow at maximum")
            capacity *= 2
            retries += 1


def _note_part_info(info, capacity, hot, rows_broadcast) -> None:
    """Fold one partitioned probe's outcome into a multiway join's shared
    *info* dict: the largest settled capacity (the next dimension's first
    attempt starts there) and the summed hot-routing tallies."""
    if info is None:
        return
    info["capacity"] = max(int(capacity), int(info.get("capacity") or 0))
    info["dims"] = info.get("dims", 0) + 1
    info["hot_keys"] = info.get("hot_keys", 0) + (int(hot.size) if hot is not None else 0)
    info["rows_broadcast"] = info.get("rows_broadcast", 0) + int(rows_broadcast)


def partitioned_probe_device(
    mesh: Mesh, qk, prepared, capacity: "int | None" = None,
    label: "str | None" = None, info: "dict | None" = None,
) -> Tuple[ShardedRows, ShardedRows]:
    """Device-resident narrow-key partitioned probe: *qk* (int32, -1 =
    invalid; a tensor or :class:`ShardedRows`) stays on the devices end to
    end; the answers come back as :class:`ShardedRows`.

    Host syncs: one bounded hot-key sample and one scalar per capacity
    attempt.  *label* names the probed index in the skew-routing evidence
    (``csvplus_join_*`` counters, ``join:skew`` row); *info* collects the
    settled capacity and hot-routing split (:func:`_note_part_info`)."""
    n_shards = mesh.size
    uniq, lower, count, splits = prepared
    m = int(qk.shape[0])

    hot, hot_share = _detect_hot(qk, n_shards, wide=False)
    n_hot = 0
    hot_vals = hot_lo = hot_ct = None
    if hot is not None:
        from ..utils.observe import telemetry

        with telemetry.stage("join:broadcast", int(hot.size)) as _b:
            n_hot = _pow2(hot.size)  # a power-of-two bucket of the hot count
            (hot_vals,), hot_lo, hot_ct = _hot_answers_device(mesh, hot, prepared, wide=False)
            _b["n_hot"] = n_hot
            telemetry.barrier(hot_vals + hot_lo + hot_ct)
        if capacity is None:
            capacity = _skew_capacity(m, n_shards, hot_share)

    def launch(cap):
        return _probe_spmd_dev(mesh, n_shards, cap, n_hot, qk, uniq, lower, count, splits,
                               hot_vals, hot_lo, hot_ct)

    out, rows_broadcast, cap_used = _retry_probe_device(mesh, m, capacity, launch)
    if hot is not None:
        _note_skew(label, m, int(hot.size), rows_broadcast, cap_used, skew_threshold(n_shards))
    _note_part_info(info, cap_used, hot, rows_broadcast)
    return out


def partitioned_probe_device_wide(
    mesh: Mesh, q_hi, q_lo, prepared, capacity: "int | None" = None,
    label: "str | None" = None, info: "dict | None" = None,
) -> Tuple[ShardedRows, ShardedRows]:
    """Device-resident wide-key (62-bit dual-lane) partitioned probe.
    Invalid probes carry (-1, -1) lanes."""
    n_shards = mesh.size
    uh, ul, lower, count, sh, sl = prepared
    m = int(q_hi.shape[0])

    hot, hot_share = _detect_hot((q_hi, q_lo), n_shards, wide=True)
    n_hot = 0
    hot_hi = hot_lo_lane = hot_ans_lo = hot_ans_ct = None
    if hot is not None:
        from ..utils.observe import telemetry

        with telemetry.stage("join:broadcast", int(hot.size)) as _b:
            n_hot = _pow2(hot.size)
            (hot_hi, hot_lo_lane), hot_ans_lo, hot_ans_ct = _hot_answers_device(
                mesh, hot, prepared, wide=True)
            _b["n_hot"] = n_hot
            telemetry.barrier(hot_hi + hot_lo_lane + hot_ans_lo + hot_ans_ct)
        if capacity is None:
            capacity = _skew_capacity(m, n_shards, hot_share)

    def launch(cap):
        return _probe_spmd_dev2(mesh, n_shards, cap, n_hot, q_hi, q_lo, uh, ul, lower, count,
                                sh, sl, hot_hi, hot_lo_lane, hot_ans_lo, hot_ans_ct)

    out, rows_broadcast, cap_used = _retry_probe_device(mesh, m, capacity, launch)
    if hot is not None:
        _note_skew(label, m, int(hot.size), rows_broadcast, cap_used, skew_threshold(n_shards))
    _note_part_info(info, cap_used, hot, rows_broadcast)
    return out


def _broadcast_block(keys: torch.Tensor, qk: torch.Tensor):
    lower = torch.searchsorted(keys, qk, out_int32=True)
    upper = torch.searchsorted(keys, qk, right=True, out_int32=True)
    return lower, torch.where(qk >= 0, upper - lower, 0)


def broadcast_probe(index_keys, qk_sharded):
    """Small-build-side fast path: the sorted key array is replicated to
    every shard and each shard binary-searches its own rows, with no
    exchange.  *index_keys* is a tensor or the tuple :func:`.mesh.replicate`
    gives; *qk_sharded* a :class:`ShardedRows` (answers come back sharded
    the same way) or one tensor."""
    if not isinstance(qk_sharded, ShardedRows):
        return _broadcast_block(index_keys, qk_sharded)
    mesh = qk_sharded.mesh
    keys = index_keys if isinstance(index_keys, tuple) else replicate(mesh, index_keys)
    lo, ct = [], []
    for i, q in enumerate(qk_sharded.shards):
        with mesh.on(i):
            a, b = _broadcast_block(keys[i], q)
        lo.append(a)
        ct.append(b)
    return ShardedRows(mesh, lo), ShardedRows(mesh, ct)
