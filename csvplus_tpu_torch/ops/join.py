"""Device lookup join: packed sorted keys + vectorized probe.

Port of the single-join subset of ``csvplus_tpu/ops/join.py``.

* The build side (an :class:`~csvplus_tpu_torch.index.Index`) is
  columnar, sorted by its key columns, and its key codes are **packed into
  one integer per row**: each key column takes a bit field sized to its
  dictionary.  Sorted dictionaries make packed order == the reference's
  lexicographic string order, so the packed array is sorted too.
* The probe side translates its key columns into the build dictionaries
  (host translation table + device gather; a lane-dictionary column on
  either side translates by a device lane search instead; a typed probe
  column looks its value lanes up in the numerically parsed build
  dictionary, so it is never demoted), packs them the same way, and
  answers every row's ``[lower, lower + count)`` match range at once.
* Fan-out is data-dependent, so only ``(total, max count)`` crosses to the
  host — one transfer — and the gather index vectors are built on device.
* A run of joins can execute as ONE pass (:func:`multiway_join`): every
  build side is probed over the original stream rows and the
  cross-product fan-out expands once, with no intermediate table; the
  fused probe (:func:`multiway_join_selected`) probes a selection without
  materializing it first.  Only the rewriter (``analysis/rewrite.py``,
  through the plan cache) emits the plan nodes that reach them.
* :func:`except_mask` is the anti-join's keep-mask.
* A row-sharded stream (:class:`~csvplus_tpu_torch.parallel.mesh.ShardedRows`
  storage) is translated, packed, probed, expanded and gathered per
  shard, each on its shard's device.  A build side of at least
  ``PARTITION_MIN_KEYS`` keys probed by a stream sharded over more than
  one shard takes the range-partitioned all-to-all tier
  (:mod:`..parallel.pjoin`); below it the build keys and columns are
  copied once per distinct device of the mesh (the broadcast tier).  The
  test is the mesh's shard count, not its device set: eight shards on
  one card take the partitioned tier, as eight devices do in the
  reference.

Key tiers, kept as in the reference so tier choice matches:

* <= 23 packed bits: the dictionary-direct tier, two gathers from a
  ``cum`` table over the key universe;
* <= 31 bits: ``int32`` keys and ``searchsorted``;
* <= 62 bits: two nonnegative 31-bit ``int32`` lanes (hi, lo) and a
  branchless two-lane binary search;
* wider: unsupported, the chain runs on the host path.
"""

from __future__ import annotations

import threading
from collections import Counter
from dataclasses import dataclass
from typing import ClassVar, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..columnar.table import DeviceTable, StringColumn, gather_storage, merge_with_fallback
from ..parallel.mesh import Mesh, Replicated, ShardedRows, assemble, relayout, smap, to_device
from ..utils.env import env_int

_MASK31 = (1 << 31) - 1

#: Joins this process ran, counted by expansion path ("unique-identity",
#: "unique-partial", "fan-out", prefixed "multiway-" or "fused-" for the
#: single-pass operators) — counted where the path is chosen, nowhere
#: else.  Every probe tier answers on the device: no path expands on the
#: host.  ``chip_smoke.py`` and the tests read it.
expand_paths: Counter = Counter()

#: Probes this process ran, counted by tier where :meth:`DeviceIndex.probe`
#: chooses it: "direct", "i32" or "wide" (two lanes) for a stream on one
#: device; for a sharded stream "partitioned" / "partitioned-wide" (the
#: all-to-all tier) or "replicated-direct" / "replicated-i32" /
#: "replicated-wide" (the build keys copied to every device of the mesh).
probe_tiers: Counter = Counter()


def _bits_for(n: int) -> int:
    """Bits needed to store codes 0..n-1 plus the sentinel 0 slot."""
    return max(int(n + 1).bit_length(), 1)


def _pack_qk(codes: Sequence[torch.Tensor], shifts: Sequence[int]) -> torch.Tensor:
    """Packed int32 key from per-column codes; any negative code (a miss)
    makes the whole row -1."""
    ok = None
    qk = None
    for c, s in zip(codes, shifts):
        present = c >= 0
        part = torch.where(present, c, 0).to(torch.int32) << s
        ok = present if ok is None else ok & present
        qk = part if qk is None else qk | part
    return torch.where(ok, qk, -1).to(torch.int32)


def pack_lanes(codes, shifts, bits) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack per-column codes into two nonnegative 31-bit int32 lanes
    (hi = key >> 31, lo = key & 0x7FFFFFFF): each column lands in one lane
    or straddles both.  Signed (hi, lo) order equals the 62-bit key order
    because both lanes are nonnegative."""
    hi = None
    lo = None

    def _or(acc, v):
        return v if acc is None else acc | v

    for c, s, b in zip(codes, shifts, bits):
        c = c.to(torch.int32)
        if s >= 31:
            hi = _or(hi, c << (s - 31))
        elif s + b <= 31:
            lo = _or(lo, c << s)
        else:  # straddles the lane boundary
            k = 31 - s
            lo = _or(lo, (c & ((1 << k) - 1)) << s)
            hi = _or(hi, c >> k)
    if hi is None:
        hi = torch.zeros_like(lo)
    if lo is None:
        lo = torch.zeros_like(hi)
    return hi, lo


def _searchsorted2(keys_hi, keys_lo, q_hi, q_lo, side: str = "left") -> torch.Tensor:
    """searchsorted over (hi, lo) lane pairs: a branchless binary search
    with a fixed trip count of bit_length(n).  *side* follows numpy's
    searchsorted semantics."""
    n = int(keys_hi.shape[0])
    lo_idx = torch.zeros(q_hi.shape, dtype=torch.int64, device=q_hi.device)
    if n == 0:  # nothing to gather from; every probe lands at 0
        return lo_idx
    hi_idx = torch.full(q_hi.shape, n, dtype=torch.int64, device=q_hi.device)
    for _ in range(max(n.bit_length(), 1)):
        active = lo_idx < hi_idx
        mid = (lo_idx + hi_idx) >> 1
        safe = mid.clamp(0, max(n - 1, 0))
        kh = torch.index_select(keys_hi, 0, safe)
        kl = torch.index_select(keys_lo, 0, safe)
        if side == "left":
            descend = (kh < q_hi) | ((kh == q_hi) & (kl < q_lo))
        else:
            descend = (kh < q_hi) | ((kh == q_hi) & (kl <= q_lo))
        lo_idx = torch.where(active & descend, mid + 1, lo_idx)
        hi_idx = torch.where(active & ~descend, mid, hi_idx)
    return lo_idx


def _probe_i32pair(keys_hi, keys_lo, q_hi, q_lo, range_size: int, ok):
    """Wide-key range probe: lower at the query, upper at query + range,
    the 31-bit carry taken from the low-lane sum."""
    n = int(keys_hi.shape[0])
    lower = _searchsorted2(keys_hi, keys_lo, q_hi, q_lo)
    lo2 = q_lo + (range_size & _MASK31)
    # two 31-bit values can sum to 2^31, wrapping int32 negative; the carry
    # is the unsigned bit 31, not the arithmetic sign fill
    carry = (lo2 >> 31) & 1
    lo2 = lo2 & _MASK31
    hi2 = q_hi + (range_size >> 31) + carry
    upper = _searchsorted2(keys_hi, keys_lo, hi2, lo2)
    upper = torch.where(hi2 < 0, n, upper)  # range walked off the 62-bit top
    counts = torch.where(ok, upper - lower, 0)
    return lower.to(torch.int32), counts.to(torch.int32)


def direct_probe_parts(
    cum: torch.Tensor, qk: torch.Tensor, range_size: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dictionary-direct range probe: ``cum[j]`` = number of build keys
    < j over the packed-key universe U (U + 1 slots), so ``cum[q]`` IS
    searchsorted-left(keys, q) and a probe is two gathers.  ``jnp.take``
    clips an out-of-range index where torch raises, so the query is
    clamped into [0, U] first, as the reference clamps it."""
    U = int(cum.shape[0]) - 1
    q = qk.to(torch.int64).clamp(0, U)
    lower = torch.index_select(cum, 0, q)
    upper = torch.index_select(cum, 0, (q + range_size).clamp(max=U))
    counts = torch.where(qk >= 0, upper - lower, 0)
    return lower.to(torch.int32), counts.to(torch.int32)


def _probe_i32(keys: torch.Tensor, qk: torch.Tensor, range_size: int):
    """Range probe over sorted int32 packed keys (searchsorted at qk and
    at qk + range, in int64 so the one-past-top bound cannot wrap)."""
    keys64 = keys.to(torch.int64)
    q = qk.to(torch.int64)
    lower = torch.searchsorted(keys64, q)
    upper = torch.searchsorted(keys64, q + range_size)
    counts = torch.where(qk >= 0, upper - lower, 0)
    return lower.to(torch.int32), counts.to(torch.int32)


def _build_direct_cum(keys: torch.Tensor, total_bits: int) -> torch.Tensor:
    """cum[j] = number of build keys strictly below j, for every packed
    key j in [0, 2^total_bits]: one histogram and one int32 cumsum.
    The reference's scatter-add wraps a negative slot from the end and
    drops what is still out of range (``mode="drop"``); ``bincount``
    would grow instead, so the slots are wrapped and masked first."""
    U = 1 << total_bits
    slot = keys.to(torch.int64) + 1
    slot = torch.where(slot < 0, slot + (U + 1), slot)
    slot = slot[(slot >= 0) & (slot <= U)]
    hist = torch.bincount(slot, minlength=U + 1)
    return torch.cumsum(hist, 0, dtype=torch.int32)


def device_index_static_info(index):
    """Static shape of an index's device copy, for the plan verifier and
    the cost model: ``(column -> lane kind, key column tuple, supported,
    meta)``, or ``None`` when the index carries no device table (the
    executor then raises ``UnsupportedPlan`` and the chain falls back to
    the host path).  ``meta`` holds ``placement`` (where the packed key
    array lives, :func:`~csvplus_tpu_torch.analysis.schema.placement_of_array`),
    ``packed_keys`` (the build-side key count) and ``partition_min_keys``
    (the partitioned tier's threshold, read through the live class).
    Reads only metadata; never touches device data."""
    dev = getattr(index, "device_table", None)
    if dev is None:
        return None
    if not getattr(dev, "supported", False):
        # an unsupported device copy may hold no packed table at all
        return ({}, (), False, None)
    from ..analysis.schema import placement_of_array

    packed = getattr(dev, "packed_i32", None)
    if packed is None:
        packed = getattr(dev, "packed_hi", None)
    meta = {
        "placement": placement_of_array(packed),
        "packed_keys": int(packed.shape[0]) if packed is not None else None,
        "partition_min_keys": int(
            getattr(dev, "PARTITION_MIN_KEYS", DeviceIndex.PARTITION_MIN_KEYS)
        ),
    }
    return (
        {n: c.kind for n, c in dev.table.columns.items()},
        tuple(dev.key_columns),
        True,
        meta,
    )


def _decode_sample(col: StringColumn, codes: np.ndarray) -> list:
    """Values of a few dictionary slots of *col*.  A lane dictionary
    still on the device gathers and unpacks only those slots (the
    column's host dictionary would unpack every entry); the values are
    the ones ``decode_codes`` gives."""
    if col._dictionary is None:
        from .lanes import unpack_host

        idx = torch.from_numpy(codes).to(col.codes.device)
        lanes = [torch.index_select(lane, 0, idx).cpu().numpy() for lane in col.dev_dictionary]
        return [v.decode("utf-8") for v in unpack_host(lanes).tolist()]
    return col.decode_codes(codes)


@dataclass
class DeviceIndex:
    """Columnar build side of a join: key-sorted table + packed keys."""

    table: DeviceTable
    key_columns: List[str]
    shifts: Optional[List[int]]  # bit offset per key column (None: unsupported)
    bits: Optional[List[int]] = None  # bit width per key column
    packed_i32: Optional[torch.Tensor] = None  # narrow keys, sorted
    packed_hi: Optional[torch.Tensor] = None  # wide keys: 31-bit hi lane
    packed_lo: Optional[torch.Tensor] = None  # wide keys: 31-bit lo lane
    direct_bits: Optional[int] = None  # packed-key universe bits (direct tier)

    # Universes up to 2^DIRECT_MAX_BITS get the dictionary-direct probe
    # table (2^23 + 1 int32 = 32 MB at the cap); larger ones search.
    # Read at import, as the reference reads it.
    DIRECT_MAX_BITS: ClassVar[int] = env_int("CSVPLUS_DIRECT_PROBE_MAX_BITS", 23)

    # Build sides with at least this many keys, probed by a stream sharded
    # over more than one shard, take the range-partitioned all-to-all tier
    # (parallel/pjoin.py); below it the keys are copied to every device of
    # the mesh (broadcast).  Read at import, as the reference reads it; a
    # class attribute, so a caller may set it for one run.
    PARTITION_MIN_KEYS: ClassVar[int] = env_int("CSVPLUS_PARTITION_MIN_KEYS", 4_000_000)

    # Build-side key sample offered to the cost model's sketch, at most.
    BUILD_SAMPLE: ClassVar[int] = 4096

    # Point lookups (find/sub_index/has) search a host int32 mirror of the
    # sorted keys up to this many keys (64 MB), made once, instead of
    # paying a device round trip per lookup; above it they search on the
    # device.
    POINT_MIRROR_MAX_KEYS: ClassVar[int] = env_int("CSVPLUS_POINT_MIRROR_MAX_KEYS", 16_000_000)

    @classmethod
    def build(cls, table: DeviceTable, key_columns: Sequence[str]) -> "DeviceIndex":
        """The index over *table*, sorted by *key_columns*: the key codes
        packed into sorted lanes (the stage ``index:pack``)."""
        from ..utils.observe import telemetry

        with telemetry.stage("index:pack", table.nrows):
            index = cls._build(table, list(key_columns))
            telemetry.barrier(_flat([index.packed_i32, index.packed_hi, index.packed_lo]))
        return index

    @classmethod
    def _build(cls, table: DeviceTable, key_columns: List[str]) -> "DeviceIndex":
        cols = [table.columns[c] for c in key_columns]
        for c in cols:
            # packed keys need code order == value order and one code per
            # value: a deferred lane dictionary is sorted here
            c._ensure_sorted_lanes()
        bits = [_bits_for(c.dict_size) for c in cols]
        total = sum(bits)
        if total > 62:
            return cls(table, key_columns, None)
        shifts: List[int] = []
        acc = 0
        for b in reversed(bits):
            shifts.insert(0, acc)
            acc += b
        codes = [c.codes for c in cols]
        if total <= 31:
            # build codes are never negative (the index build checked
            # every key cell), so the pack's miss masking is the identity
            direct = total if total <= cls.DIRECT_MAX_BITS else None
            return cls(
                table, key_columns, shifts, bits,
                packed_i32=_pack_qk(codes, shifts), direct_bits=direct,
            )
        hi, lo = pack_lanes(codes, shifts, bits)
        return cls(table, key_columns, shifts, bits, packed_hi=hi, packed_lo=lo)

    def __post_init__(self):
        # serializes the once-per-index build-side sample
        self._aux_lock = threading.Lock()
        self._skew_offered = False
        # for sharded probes: (name, device) -> (source tensor, its copy
        # there), and (mesh, range-partitioned keys)
        self._repl: dict = {}
        self._part_cache = None

    def _replicated(self, mesh: Mesh, name: str, tensor: torch.Tensor):
        """*tensor* (a packed key lane, the direct table or a build
        column) on every shard's device of *mesh*: one copy per distinct
        device, cached on the index (the reference's ``_lanes_for`` /
        ``_aligned_codes``); none where it already lies."""
        per_dev = {}
        for dev in mesh.distinct_devices:
            if isinstance(tensor, torch.Tensor) and tensor.device == dev:
                per_dev[dev] = tensor
                continue
            key = (name, dev)
            got = self._repl.get(key)
            if got is None or got[0] is not tensor:
                # a sharded build column (an index built by the sample
                # sort) is assembled once a device: counted
                got = self._repl[key] = (tensor, assemble(tensor, dev))
            per_dev[dev] = got[1]
        return Replicated(per_dev[d] for d in mesh.devices)

    def _partitioned_for(self, mesh: Mesh):
        """Range-partitioned build keys for *mesh*, made once per mesh
        (the host partitioning and upload happen once, not per probe).
        Keyed by the mesh itself: two meshes over one card with other
        shard counts partition differently."""
        cached = self._part_cache
        if cached is not None and cached[0] is mesh:
            return cached[1]
        from ..parallel.pjoin import prepare_partitioned

        keys = (self.packed_i32.cpu().numpy() if self.packed_i32 is not None
                else self._packed_i64_host())
        prepared = prepare_partitioned(mesh, keys)
        self._part_cache = (mesh, prepared)
        return prepared

    @property
    def supported(self) -> bool:
        return self.shifts is not None

    def _decode_packed(self, packed: np.ndarray) -> list:
        """Decode packed build keys back to their column values: each key
        column's code is its bit field, decoded through the column
        dictionary (only the sampled codes).  Single-column keys unwrap
        to the scalar."""
        parts = []
        p64 = packed.astype(np.int64)
        for name, s, b in zip(self.key_columns, self.shifts, self.bits):
            codes = (p64 >> s) & ((1 << b) - 1)
            parts.append(_decode_sample(self.table.columns[name], codes))
        if len(parts) == 1:
            return list(parts[0])
        return [tuple(vs) for vs in zip(*parts)]

    def offer_build_sample(self) -> None:
        """Once per index: a strided sample of the SORTED packed build keys
        (at most ``BUILD_SAMPLE``, ``step = ceil(n / BUILD_SAMPLE)``),
        decoded and offered into the process-global build-side sketch
        (:mod:`..obs.joinskew`) that the cost model reads.  Sorted order
        makes the strided sample a share estimator.  The download is one
        bounded ``.cpu()``; after the first call this is one attribute
        read."""
        if self._skew_offered or not self.supported:
            return
        with self._aux_lock:
            if self._skew_offered:
                return
            self._skew_offered = True
        n = int(self.table.nrows)
        if n == 0:
            return
        from ..utils.observe import telemetry

        step = max(1, -(-n // self.BUILD_SAMPLE))
        if self.packed_i32 is not None:
            sample = self.packed_i32[::step].cpu().numpy()
            telemetry.count_sync(sample.size)
        else:
            pair = torch.stack([self.packed_hi[::step], self.packed_lo[::step]]).cpu().numpy()
            telemetry.count_sync(pair.size)
            sample = (pair[0].astype(np.int64) << 31) | pair[1].astype(np.int64)
        vals, cnts = np.unique(sample, return_counts=True)
        from ..obs.joinskew import joinskew

        joinskew.offer_build(",".join(self.key_columns), self._decode_packed(vals), cnts)

    @property
    def direct_cum(self) -> Optional[torch.Tensor]:
        """The direct tier's ``cum`` table, built on first probe; None
        when the universe exceeds ``DIRECT_MAX_BITS``."""
        if self.direct_bits is None:
            return None
        cum = getattr(self, "_direct_cum", None)
        if cum is None:
            cum = self._direct_cum = _build_direct_cum(self.packed_i32, self.direct_bits)
        return cum

    def _packed_host_mirror(self) -> np.ndarray:
        """Host int32 mirror of the sorted packed keys (the point-lookup
        tier up to ``POINT_MIRROR_MAX_KEYS``), built once under the
        lock."""
        host = getattr(self, "_packed_host", None)
        if host is None:
            with self._aux_lock:
                host = getattr(self, "_packed_host", None)
                if host is None:
                    host = self._packed_host = self.packed_i32.cpu().numpy()
        return host

    def _packed_i64_host(self) -> np.ndarray:
        """Host int64 keys of the two-lane tier, ``(hi << 31) | lo``,
        built once under the lock.  The reference keeps this array on
        the host from the build on; its point lookups search it there."""
        host = getattr(self, "_packed_i64", None)
        if host is None:
            with self._aux_lock:
                host = getattr(self, "_packed_i64", None)
                if host is None:
                    hi = self.packed_hi.cpu().numpy().astype(np.int64)
                    host = (hi << 31) | self.packed_lo.cpu().numpy().astype(np.int64)
                    self._packed_i64 = host
        return host

    def _search_packed(self, qk: np.ndarray, top: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Bounds of the packed key ranges ``[qk, top)`` (int64 arrays), in
        the tier the index's size picks: an int32 host mirror up to
        ``POINT_MIRROR_MAX_KEYS`` keys (one O(n) download, then numpy
        searches), ``torch.searchsorted`` on the table's device above it
        (the lowers and uppers go up in one upload and come back in one
        transfer), or the two-lane tier's int64 host keys."""
        if self.packed_i32 is None:
            keys = self._packed_i64_host()
            return (np.searchsorted(keys, qk, side="left"),
                    np.searchsorted(keys, top, side="left"))
        n = int(self.packed_i32.shape[0])
        over = top > _MASK31  # one past the top of a 31-bit universe: the upper is n
        # int32 probes against the int32 keys: a wider probe would make
        # numpy or torch widen a copy of all n keys per call
        q = np.concatenate([qk, np.where(over, 0, top)]).astype(np.int32)
        if n <= self.POINT_MIRROR_MAX_KEYS:
            res = self._packed_host_mirror().searchsorted(q, side="left")
        else:
            qt = torch.from_numpy(q).to(self.packed_i32.device)
            res = torch.searchsorted(self.packed_i32, qt).cpu().numpy()
        m = qk.shape[0]
        return res[:m], np.where(over, n, res[m:])

    def point_bounds(self, values: List[str]) -> Tuple[int, int]:
        """[lower, upper) range for one key-prefix probe — the device form
        of the reference's two binary searches (csvplus.go:881-887).

        Values translate to codes through the dictionaries, then the
        packed keys are searched in the index's tier
        (:meth:`_search_packed`).
        """
        if len(values) > len(self.key_columns):
            raise ValueError("too many columns in Index.find()")
        assert self.supported
        if not values:
            return 0, self.table.nrows
        qk = 0
        for v, name, s in zip(values, self.key_columns, self.shifts):
            code = self.table.columns[name].find_code(v)
            if code < 0:
                return 0, 0  # value not in the index at all
            qk |= code << s
        top = qk + (1 << self.shifts[len(values) - 1])
        lower, upper = self._search_packed(np.array([qk], np.int64), np.array([top], np.int64))
        return int(lower[0]), int(upper[0])

    def point_bounds_many(
        self, probes: Sequence[Sequence[str]]
    ) -> List[Tuple[int, int]]:
        """Batched :meth:`point_bounds`: one vectorized code translation
        per key column (``find_codes``) and ONE search over all probes
        (:meth:`_search_packed`).  Semantics equal a loop of single
        ``point_bounds`` calls."""
        assert self.supported
        self.offer_build_sample()
        m = len(probes)
        if m == 0:
            return []
        n = int(self.table.nrows)
        karr = np.array([len(p) for p in probes], dtype=np.int64)
        if int(karr.max()) > len(self.key_columns):
            raise ValueError("too many columns in Index.find()")
        qk = np.zeros(m, dtype=np.int64)
        ok = np.ones(m, dtype=bool)
        for j, (name, s) in enumerate(zip(self.key_columns, self.shifts)):
            col = self.table.columns[name]
            if int(karr.min()) > j:  # every probe has column j
                codes = col.find_codes([p[j] for p in probes])
                ok &= codes >= 0
                qk |= np.where(codes >= 0, codes, 0) << s
                continue
            sel = np.flatnonzero(karr > j)
            if sel.size == 0:
                break
            codes = col.find_codes([probes[i][j] for i in sel])
            ok[sel] &= codes >= 0
            qk[sel] |= np.where(codes >= 0, codes, 0) << s
        shifts = np.array(self.shifts, dtype=np.int64)
        range_size = np.where(karr > 0, 1 << shifts[np.maximum(karr, 1) - 1], 0)
        lower, upper = self._search_packed(qk, qk + range_size)
        lower = np.where(ok, lower, 0).astype(np.int64)
        upper = np.where(ok, upper, 0).astype(np.int64)
        empty = karr == 0  # an empty prefix bounds the whole table
        lower = np.where(empty, 0, lower)
        upper = np.where(empty, n, upper)
        return list(zip(lower.tolist(), upper.tolist()))

    def probe(
        self, probe_cols: List[StringColumn], nrows: int, part_info: "dict | None" = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(lower, counts) per probe row, both int32 on the probe's device
        (:class:`ShardedRows` in the stream's layout for a sharded stream).
        Fewer probe columns than key columns = a prefix probe.

        *part_info* is a multiway join's shared partitioned-tier state:
        one dict threads through every dimension's probe, so the exchange
        capacity settled on one dimension seeds the next one's first
        attempt (``partitioned_probe_device``'s *info*)."""
        from ..utils.observe import telemetry

        self.offer_build_sample()
        k = len(probe_cols)
        with telemetry.stage("join:translate", nrows) as stage:
            tally = stage if telemetry.live() else None
            # a typed probe column translates its value lanes against the
            # parsed build dictionary: the probe side is never demoted
            codes = [
                pc.renumbered_to_col(self.table.columns[name], tally)
                for pc, name in zip(probe_cols, self.key_columns[:k])
            ]
            telemetry.barrier(_flat(codes))
        mesh = codes[0].mesh if codes and isinstance(codes[0], ShardedRows) else None
        range_size = 1 << (self.shifts[k - 1] if k else 0)
        from ..parallel.pjoin import partition_tier_selected

        if self.packed_i32 is not None:
            with telemetry.stage("join:pack", nrows):
                if mesh is not None:
                    shifts = self.shifts[:k]
                    qk = smap(mesh, lambda *cs: _pack_qk(cs, shifts), *codes)
                elif codes:
                    qk = _pack_qk(codes, self.shifts[:k])
                else:
                    qk = torch.zeros(nrows, dtype=torch.int32, device=self.table.device)
                telemetry.barrier(_flat([qk]))
            if mesh is not None and partition_tier_selected(
                int(self.packed_i32.shape[0]), full_width=k == len(self.key_columns),
                stream_sharded=mesh.size > 1, min_keys=self.PARTITION_MIN_KEYS,
            ):
                from ..parallel.pjoin import partitioned_probe_device

                probe_tiers["partitioned"] += 1
                lo, ct = partitioned_probe_device(
                    mesh, qk, self._partitioned_for(mesh),
                    capacity=(part_info or {}).get("capacity"),
                    label=",".join(self.key_columns), info=part_info,
                )
                return _in_layout(lo, qk), _in_layout(ct, qk)
            cum = self.direct_cum
            probe_tiers[("replicated-" if mesh is not None else "")
                        + ("direct" if cum is not None else "i32")] += 1
            with telemetry.stage("join:probe", nrows) as out:
                if cum is not None:
                    out["tier"] = "direct"
                    if mesh is not None:
                        ans = smap(mesh, lambda c, q: direct_probe_parts(c, q, range_size),
                                   self._replicated(mesh, "direct_cum", cum), qk)
                    else:
                        ans = direct_probe_parts(cum, qk, range_size)
                else:
                    out["tier"] = "broadcast-i32"
                    if mesh is not None:
                        ans = smap(mesh, lambda kk, q: _probe_i32(kk, q, range_size),
                                   self._replicated(mesh, "packed_i32", self.packed_i32), qk)
                    else:
                        ans = _probe_i32(self.packed_i32, qk, range_size)
                telemetry.barrier(_flat(ans))
            return ans
        # the two-lane tier records no pack or probe stage, as in the
        # reference
        shifts, bits = self.shifts, self.bits

        def lanes(*cs):
            ok = torch.ones(cs[0].shape, dtype=torch.bool, device=cs[0].device)
            clamped = []
            for c in cs:
                ok = ok & (c >= 0)
                clamped.append(torch.where(c >= 0, c, 0))
            q_hi, q_lo = pack_lanes(clamped, shifts, bits)
            return q_hi, q_lo, ok

        if mesh is None:
            probe_tiers["wide"] += 1
            q_hi, q_lo, ok = lanes(*codes)
            return _probe_i32pair(self.packed_hi, self.packed_lo, q_hi, q_lo, range_size, ok)
        q_hi, q_lo, ok = smap(mesh, lanes, *codes)
        if partition_tier_selected(
            int(self.packed_hi.shape[0]), full_width=k == len(self.key_columns),
            stream_sharded=mesh.size > 1, min_keys=self.PARTITION_MIN_KEYS,
        ):
            from ..parallel.pjoin import partitioned_probe_device_wide

            probe_tiers["partitioned-wide"] += 1
            # invalid probes carry (-1, -1) lanes
            q_hi_m = smap(mesh, lambda h, o: torch.where(o, h, -1), q_hi, ok)
            q_lo_m = smap(mesh, lambda v, o: torch.where(o, v, -1), q_lo, ok)
            lo, ct = partitioned_probe_device_wide(
                mesh, q_hi_m, q_lo_m, self._partitioned_for(mesh),
                capacity=(part_info or {}).get("capacity"),
                label=",".join(self.key_columns), info=part_info,
            )
            return _in_layout(lo, q_hi), _in_layout(ct, q_hi)
        probe_tiers["replicated-wide"] += 1
        return smap(
            mesh, lambda kh, kl, h, v, o: _probe_i32pair(kh, kl, h, v, range_size, o),
            self._replicated(mesh, "packed_hi", self.packed_hi),
            self._replicated(mesh, "packed_lo", self.packed_lo), q_hi, q_lo, ok,
        )


def _flat(values) -> tuple:
    """Every tensor of a list of tensors, ShardedRows and tuples of them
    (for ``telemetry.barrier``)."""
    out = []
    for v in values:
        if isinstance(v, ShardedRows):
            out.extend(v.shards)
        elif isinstance(v, (tuple, list)):
            out.extend(_flat(v))
        elif v is not None:
            out.append(v)
    return tuple(out)


def _in_layout(x: ShardedRows, like: ShardedRows) -> ShardedRows:
    """*x* (the partitioned tier's answers, in equal blocks) re-cut into
    the probe stream's own shard layout, shard to shard."""
    if x.lens == like.lens:
        return x
    return ShardedRows(like.mesh, relayout(like.mesh, x, like.lens))


def _expand_kernel(lower: torch.Tensor, counts: torch.Tensor, total: int):
    """Fan-out expansion to exactly *total* output slots: an exclusive
    int32 prefix sum locates each probe row's segment, a scatter of
    segment markers + running max fills each slot with its probe row.
    The reference scatters empty segments out of bounds and lets
    ``mode="drop"`` discard them; torch raises on that, so only the
    non-empty segments' markers are scattered."""
    ends = torch.cumsum(counts, 0, dtype=torch.int32)
    starts = ends - counts
    nonempty = counts > 0
    ids = torch.arange(counts.shape[0], dtype=torch.int32, device=counts.device)
    seg = torch.zeros(total, dtype=torch.int32, device=counts.device)
    # segment starts strictly increase over non-empty segments: no collisions
    seg[starts[nonempty].to(torch.int64)] = ids[nonempty]
    probe_ids = torch.cummax(seg, 0).values.to(torch.int64)
    out_pos = torch.arange(total, dtype=torch.int32, device=counts.device)
    group_base = torch.index_select(starts, 0, probe_ids)
    build_ids = torch.index_select(lower, 0, probe_ids) + (out_pos - group_base)
    return probe_ids, build_ids.to(torch.int64)


def expand_matches_device(
    lower: torch.Tensor, counts: torch.Tensor, total: "int | None" = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(probe row ids, build row ids) per match, on device; only the
    total crosses to host (a caller that already has it passes it)."""
    if counts.shape[0] == 0:
        empty = torch.zeros(0, dtype=torch.int64, device=counts.device)
        return empty, empty
    if total is None:
        total = int(counts.sum().item())
    return _expand_kernel(lower, counts, total)


def _probe_stats(counts: torch.Tensor) -> Tuple[int, int]:
    """(total matches, max run length) in one host transfer."""
    from ..utils.observe import telemetry

    if counts.shape[0] == 0:
        return 0, 0
    stats = torch.stack([counts.sum(dtype=torch.int64), counts.max().to(torch.int64)])
    total, maxc = stats.tolist()
    telemetry.count_sync(2)
    return int(total), int(maxc)


def _compact_nonzero(mask: torch.Tensor) -> torch.Tensor:
    """Row ids where *mask* holds, compacted on the mask's device; the
    result's size is one host sync (the unique-partial compaction)."""
    from ..utils.observe import telemetry

    ids = torch.nonzero(mask).squeeze(1)
    telemetry.count_sync(1)
    return ids


def _checked_probe_cols(
    stream: DeviceTable, columns: Sequence[str]
) -> List[StringColumn]:
    """The stream's key columns, with host-parity errors: ``missing
    column`` when a column is absent from the stream, or wrapped with the
    row number of the first row lacking the cell."""
    from ..errors import DataSourceError
    from ..row import MissingColumnError

    out = []
    for c in columns:
        if c not in stream.columns:
            raise MissingColumnError(c)
        col = stream.columns[c]
        if col.has_absent:
            bad = col.codes < 0
            raise DataSourceError(int(torch.argmax(bad.to(torch.uint8))), MissingColumnError(c))
        out.append(col)
    return out


def _empty_sel(stream: DeviceTable):
    """An empty selection of *stream*'s rows (per shard when sharded)."""
    mesh = stream.mesh
    if mesh is None:
        return torch.zeros(0, dtype=torch.int64, device=stream.device)
    return ShardedRows(mesh, [torch.zeros(0, dtype=torch.int64, device=d) for d in mesh.devices])


def _gather_cols(cols, ids: torch.Tensor) -> List[torch.Tensor]:
    """Each storage array at the global positions *ids*, on *ids*' device
    (a sharded one, an index built by the sample sort, sends each shard's
    selected rows there)."""
    return [gather_storage(c, ids) for c in cols]


# -- sharded streams ----------------------------------------------------------
#
# Every shard expands its own rows: its matches land in its own output
# block, so the output keeps the stream's shard order and no row crosses
# shards.  One host transfer per join carries every shard's total and the
# global max (and the avoided rows, multiway), reduced on the first
# device: the reference's one ``(total, max)`` transfer with one total a
# shard.  Each shard's output size comes from it, so the per-shard
# compaction and expansion need no further sync.


def _shard_stats(mesh: Mesh, parts) -> Tuple[List[int], int, int]:
    """(per-shard totals, global max, summed avoided rows) from each
    shard's ``[total, max(, avoided)]`` device scalars, reduced on the
    first device and read in ONE transfer (counted as its elements)."""
    from ..utils.observe import telemetry

    dev0 = mesh.devices[0]
    st = torch.stack([to_device(torch.stack(p), dev0) for p in parts])
    row = torch.cat([st[:, 0], st[:, 1].max().reshape(1), st[:, 2:].sum(0)]).tolist()
    telemetry.count_sync(len(row))
    k = mesh.size
    return [int(t) for t in row[:k]], int(row[k]), int(row[k + 1]) if len(row) > k + 1 else 0


def _nonzero_sized(mask: torch.Tensor, size: int) -> torch.Tensor:
    """Row ids where *mask* holds, whose count the caller knows: no
    host sync for the output size."""
    return torch.nonzero_static(mask, size=size).squeeze(1)


def _sharded_ids(lowers: Sequence[ShardedRows], counts: Sequence[ShardedRows], nrows: int,
                 label: "str | None", stage: dict):
    """The expansion of :func:`join_tables` / :func:`_multiway_ids` per
    shard: (probe ids or None, per-build-side build ids, total, avoided
    intermediate rows), ids shard-local ShardedRows.  The path is chosen
    from the global statistics, as the reference chooses it."""
    mesh = counts[0].mesh
    multi = label is not None

    def stats(*cs):
        prod = cs[0].to(torch.int64)
        inter = torch.zeros((), dtype=torch.int64, device=prod.device)
        for c in cs[1:]:
            inter = inter + prod.sum()
            prod = prod * c.to(torch.int64)
        mx = prod.max() if prod.shape[0] else torch.zeros((), dtype=torch.int64,
                                                          device=prod.device)
        return [prod.sum(), mx, inter] if multi else [prod.sum(), mx]

    parts = [stats(*[c.shards[i] for c in counts]) for i in range(mesh.size)]
    totals, maxp, inter = _shard_stats(mesh, parts)
    total = sum(totals)
    prefix = f"{label}-" if multi else ""
    if maxp <= 1 and total == nrows:
        path = "unique-identity"
        probe_ids = None
        build = tuple(lo.map(lambda x: x.to(torch.int64)) for lo in lowers)
    elif maxp <= 1:
        path = "unique-partial"

        def compact(i, *cs):
            mask = cs[0] > 0
            for c in cs[1:]:
                mask = mask & (c > 0)
            return _nonzero_sized(mask, totals[i])

        probe_ids = ShardedRows(mesh, [
            compact(i, *[c.shards[i] for c in counts]) for i in range(mesh.size)])
        build = tuple(smap(mesh, lambda lo, p: torch.index_select(lo, 0, p).to(torch.int64),
                           lo, probe_ids) for lo in lowers)
    else:
        path = "fan-out"
        outs = []
        for i in range(mesh.size):
            with mesh.on(i):
                if multi:
                    p, b = _multiway_expand([lo.shards[i] for lo in lowers],
                                            [c.shards[i] for c in counts], totals[i])
                else:
                    p, b0 = _expand_kernel(lowers[0].shards[i], counts[0].shards[i], totals[i])
                    b = (b0,)
            outs.append((p, b))
        probe_ids = ShardedRows(mesh, [o[0] for o in outs])
        build = tuple(ShardedRows(mesh, [o[1][d] for o in outs]) for d in range(len(lowers)))
    path = prefix + path
    expand_paths[path] += 1
    stage["path"] = path
    stage["rows_out"] = total
    return probe_ids, build, total, inter


def _gather_build_sharded(dev_index: "DeviceIndex", ids: ShardedRows) -> dict:
    """The build side's columns at *ids* (shard-local outputs holding
    build row ids), each shard gathering from a copy of the build column
    on its device (one copy per distinct device, cached on the index)."""
    mesh = ids.mesh
    out = {}
    for n, c in dev_index.table.columns.items():
        src = dev_index._replicated(mesh, ("col", n), c.storage)
        out[n] = c.with_storage(smap(
            mesh, lambda t, i: torch.index_select(t, 0, i), src, ids))
    return out


def join_tables(
    stream: DeviceTable, dev_index: DeviceIndex, columns: Sequence[str]
) -> DeviceTable:
    """stream ⋈ index with the reference's merge semantics: result rows
    carry all columns of both sides; on a name collision the stream's
    value wins where the stream row has the cell (csvplus.go:560,
    571-583); stream order is kept and each row's matches come out in
    index order (csvplus.go:559)."""
    if stream.nrows == 0:
        empty = _empty_sel(stream)
        out_cols = {
            name: col.gather(empty)
            for name, col in {**dev_index.table.columns, **stream.columns}.items()
        }
        return DeviceTable(out_cols, 0, stream.device)

    from ..utils.observe import telemetry

    probe_cols = _checked_probe_cols(stream, columns)
    lower, counts = dev_index.probe(probe_cols, stream.nrows)
    if isinstance(counts, ShardedRows):
        return _join_sharded(stream, dev_index, lower, counts)
    with telemetry.stage("join:expand", stream.nrows) as _exp:
        probe_ids = None
        total, maxc = _probe_stats(counts)
        if maxc <= 1 and total == stream.nrows:
            # every stream row matched once: stream columns pass through
            # ungathered, build rows are addressed by the lower bounds
            build_ids = lower.to(torch.int64)
            path = "unique-identity"
        elif maxc <= 1:
            probe_ids = _compact_nonzero(counts > 0)
            build_ids = torch.index_select(lower, 0, probe_ids).to(torch.int64)
            path = "unique-partial"
        else:
            probe_ids, build_ids = expand_matches_device(lower, counts, total)
            path = "fan-out"
        expand_paths[path] += 1
        _exp["path"] = path
        _exp["rows_out"] = total
        telemetry.barrier((probe_ids, build_ids))

    build_names = list(dev_index.table.columns)
    stream_names = list(stream.columns)
    with telemetry.stage("join:merge", stream.nrows) as _mrg:
        # kind-agnostic storage arrays (dictionary codes or typed value
        # lanes): a typed payload column is never demoted by the join
        g_build = _gather_cols(
            [dev_index.table.columns[n].storage for n in build_names], build_ids
        )
        if probe_ids is None:
            g_stream = None
            n_out = stream.nrows
        else:
            g_stream = _gather_cols([stream.columns[n].storage for n in stream_names], probe_ids)
            n_out = total

        out_cols = {}
        for name, arr in zip(build_names, g_build):
            out_cols[name] = dev_index.table.columns[name].with_storage(arr)
        for i, name in enumerate(stream_names):  # the stream wins on collision...
            src = stream.columns[name]
            g = src if g_stream is None else src.with_storage(g_stream[i])
            if name in out_cols:
                # ...but an absent stream cell keeps the index value
                g = merge_with_fallback(g, out_cols[name])
            out_cols[name] = g
        _mrg["rows_out"] = n_out
        telemetry.barrier(tuple(c.storage for c in out_cols.values()))
    return DeviceTable(out_cols, n_out, stream.device)


def _join_sharded(stream: DeviceTable, dev_index: DeviceIndex, lower: ShardedRows,
                  counts: ShardedRows) -> DeviceTable:
    """:func:`join_tables`' expansion and merge for a sharded stream:
    the same stages, paths and merge, per shard."""
    from ..utils.observe import telemetry

    with telemetry.stage("join:expand", stream.nrows) as _exp:
        probe_ids, (build_ids,), total, _ = _sharded_ids([lower], [counts], stream.nrows,
                                                         None, _exp)
        telemetry.barrier(_flat([probe_ids, build_ids]))
    with telemetry.stage("join:merge", stream.nrows) as _mrg:
        out_cols = _gather_build_sharded(dev_index, build_ids)
        for name, src in stream.columns.items():  # the stream wins on collision...
            g = src if probe_ids is None else src.gather(probe_ids)
            if name in out_cols:
                # ...but an absent stream cell keeps the index value
                g = merge_with_fallback(g, out_cols[name])
            out_cols[name] = g
        n_out = stream.nrows if probe_ids is None else total
        _mrg["rows_out"] = n_out
        telemetry.barrier(_flat([c.storage for c in out_cols.values()]))
    return DeviceTable(out_cols, n_out, stream.device)


# -- single-pass multiway join ---------------------------------------------
#
# A run of cascaded binary joins over one stream materializes every
# intermediate table.  ``multiway_join`` replaces the run with ONE pass:
# every build side is probed over the ORIGINAL stream rows (a probe
# answer depends only on the key value, so probing the stream row equals
# probing the intermediate row that carries the same key), the
# cross-product fan-out per stream row expands once, and each build
# side's rows are addressed by a mixed-radix decomposition of the
# within-row output offset — build side 0 outermost, the cascade's
# nested emission order.  Row order, column order and merge semantics are
# bitwise those of folding ``join_tables`` left to right; the rewriter
# licenses the fusion only when every later join's key columns are
# provably PRESENT on the stream before the run.
#
# The reference's jitted kernels pad their outputs to powers of two to
# bound retraces and slice the result to the true total; here every
# array is sized to the total.  Row ids are int64, as the executor's
# selection vector is.


def _multiway_stats(counts: Sequence[torch.Tensor]) -> Tuple[int, int, int]:
    """(total matches, max fan-out, cascade intermediate rows avoided) in
    one host transfer.  The reference sums int32; these sums run in
    int64, which equals it at every size whose total fits in int32 (the
    reference's own limit), so the fast-path decisions agree."""
    prod = counts[0].to(torch.int64)
    inter = torch.zeros((), dtype=torch.int64, device=prod.device)
    for c in counts[1:]:
        inter = inter + prod.sum()
        prod = prod * c.to(torch.int64)
    maxp = prod.max() if prod.shape[0] else torch.zeros((), dtype=torch.int64, device=prod.device)
    total, maxp, inter = torch.stack([prod.sum(), maxp, inter]).tolist()
    from ..utils.observe import telemetry

    telemetry.count_sync(3)
    return int(total), int(maxp), int(inter)


def _multiway_expand(
    lowers: Sequence[torch.Tensor], counts: Sequence[torch.Tensor], total: int
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Cross-product fan-out to exactly *total* output slots: the per-row
    fan-out (product of the build sides' match counts) drives the
    exclusive-prefix-sum + segment-marker + running-max inversion of
    ``_expand_kernel``; the within-row offset then decomposes in mixed
    radix (build side 0 major, suffix products as the radices) into one
    build-row offset per build side."""
    cs = [c.to(torch.int64) for c in counts]
    prod = cs[0]
    for c in cs[1:]:
        prod = prod * c
    dev = prod.device
    ends = torch.cumsum(prod, 0)
    starts = ends - prod
    nonempty = prod > 0
    ids = torch.arange(prod.shape[0], dtype=torch.int64, device=dev)
    seg = torch.zeros(total, dtype=torch.int64, device=dev)
    # non-empty segment starts strictly increase: no collisions, and the
    # reference's dropped out-of-range marks of empty segments are simply
    # not written
    seg[starts[nonempty]] = ids[nonempty]
    probe_ids = torch.cummax(seg, 0).values
    r = torch.arange(total, dtype=torch.int64, device=dev) - torch.index_select(starts, 0, probe_ids)
    suffix = torch.ones_like(prod)
    sufs = []
    for c in reversed(cs):
        sufs.append(suffix)
        suffix = suffix * c
    sufs.reverse()
    build_ids = []
    for d, (lo, c, su) in enumerate(zip(lowers, cs, sufs)):
        o = r // torch.index_select(su.clamp(min=1), 0, probe_ids)
        if d > 0:  # build side 0 is the major digit: no wrap needed
            o = o % torch.index_select(c.clamp(min=1), 0, probe_ids)
        build_ids.append(torch.index_select(lo.to(torch.int64), 0, probe_ids) + o)
    return probe_ids, tuple(build_ids)


def _multiway_ids(lowers, counts, nrows: int, label: str, stage: dict):
    """(probe ids or None, per-build-side build ids, total, intermediate
    rows avoided) for the multiway fan-out, choosing the path as the
    reference does: every row matched once in every build side (stream
    side passes through), at most once (compaction, each build row is its
    lower bound), or the cross-product expansion.  Runs inside the
    caller's ``join:expand`` stage and records the path and the row
    count in *stage*."""
    if isinstance(counts[0], ShardedRows):
        return _sharded_ids(lowers, counts, nrows, label, stage)
    total, maxp, inter = _multiway_stats(counts)
    if maxp <= 1 and total == nrows:
        path = f"{label}-unique-identity"
        probe_ids, build = None, tuple(lo.to(torch.int64) for lo in lowers)
    elif maxp <= 1:
        mask = counts[0] > 0
        for c in counts[1:]:
            mask = mask & (c > 0)
        probe_ids = _compact_nonzero(mask)
        path = f"{label}-unique-partial"
        build = tuple(torch.index_select(lo, 0, probe_ids).to(torch.int64) for lo in lowers)
    else:
        path = f"{label}-fan-out"
        probe_ids, build = _multiway_expand(lowers, counts, total)
    expand_paths[path] += 1
    stage["path"] = path
    stage["rows_out"] = total
    return probe_ids, build, total, inter


def _merge_fold(cur: dict, gathered) -> dict:
    """The cascade's merge, left to right: level d inserts build side d's
    columns first, then overlays the running result with stream-wins /
    absent-cell-fallback semantics (``join_tables``' merge per level)."""
    for cols in gathered:
        new = dict(cols)
        for name, col in cur.items():
            if name in new:
                col = merge_with_fallback(col, new[name])
            new[name] = col
        cur = new
    return cur


def _gather_builds(specs, build_ids) -> list:
    """Every build side's columns gathered by its build row ids."""
    if build_ids and isinstance(build_ids[0], ShardedRows):
        return [_gather_build_sharded(di, ids) for (di, _), ids in zip(specs, build_ids)]
    return [
        {n: c.with_storage(torch.index_select(c.storage, 0, ids))
         for n, c in di.table.columns.items()}
        for (di, _), ids in zip(specs, build_ids)
    ]


def multiway_join(
    stream: DeviceTable, specs: "Sequence[Tuple[DeviceIndex, Sequence[str]]]"
) -> DeviceTable:
    """stream ⋈ index_1 ⋈ ... ⋈ index_k in ONE pass over the stream —
    bitwise ``join_tables`` applied left to right (row order, column
    order, values, errors), with no intermediate table.  *specs* lists
    the cascade's (DeviceIndex, key columns) pairs in cascade order."""
    from ..obs.joinskew import joinskew
    from ..utils.observe import telemetry

    if len(specs) == 1:  # degenerate run: exactly the binary join
        return join_tables(stream, specs[0][0], specs[0][1])
    if stream.nrows == 0:
        # an empty stream never errors: fold the cascade's empty result
        # per level so column order and kinds match it exactly
        out = stream
        empty = _empty_sel(stream)
        for dev_index, _cols in specs:
            cols = {**dev_index.table.columns, **out.columns}
            out = DeviceTable({n: c.gather(empty) for n, c in cols.items()}, 0, stream.device)
        return out

    # every build side's keys validate and probe over the ORIGINAL rows;
    # the fusion license makes that exactly the cascade's per-level checks
    part_info: dict = {}  # one partitioned-tier state for every dimension
    answers = [
        dev_index.probe(_checked_probe_cols(stream, cols), stream.nrows, part_info)
        for dev_index, cols in specs
    ]
    with telemetry.stage("join:expand", stream.nrows) as _exp:
        _exp["dims"] = len(specs)
        probe_ids, build_ids, total, inter = _multiway_ids(
            [lo for lo, _ in answers], [ct for _, ct in answers], stream.nrows,
            "multiway", _exp,
        )
        # every build side's answers live at once here (the cascade holds
        # one side's at a time): free them before the gathers
        del answers
        telemetry.barrier(_flat((probe_ids,) + build_ids))
    with telemetry.stage("join:merge", stream.nrows) as _mrg:
        if probe_ids is None:
            cur = dict(stream.columns)
            n_out = stream.nrows
        else:
            cur = {n: c.gather(probe_ids) for n, c in stream.columns.items()}
            n_out = total
        cur = _merge_fold(cur, _gather_builds(specs, build_ids))
        _mrg["rows_out"] = n_out
        telemetry.barrier(_flat([c.storage for c in cur.values()]))
    joinskew.on_multiway(
        "+".join(",".join(di.key_columns) for di, _ in specs),
        len(specs), stream.nrows, n_out, inter,
    )
    return DeviceTable(cur, n_out, stream.device)


def multiway_join_selected(
    cols: dict,
    sel: torch.Tensor,
    device: torch.device,
    specs: "Sequence[Tuple[DeviceIndex, Sequence[str]]]",
    identity: bool = False,
) -> DeviceTable:
    """selection(cols, sel) ⋈ index_1 ⋈ ... ⋈ index_k without ever
    materializing the selected stream — bitwise
    ``multiway_join(gather(cols, sel), specs)`` (and, for one spec,
    ``join_tables``).  *cols* maps names to FULL-length columns, *sel* is
    the selected row ids, *identity* says sel is the whole range in order
    (then the stream columns pass through, as ``materialize()`` does).

    Key columns gather down to the selection only for probing (the same
    arrays a staged materialize would probe, so every answer is
    identical); the emit gathers the stream columns from full-length
    storage by the composed ``sel[probe_ids]``, one gather where the
    staged chain gathers twice.  Typed value lanes and lane-dictionary
    columns go through ``with_storage`` and ``merge_with_fallback``
    exactly as in ``join_tables``.  A sharded *sel* (shard-local ids)
    probes, expands and gathers per shard, the build columns copied once
    per distinct device (the reference's ``_aligned_codes``).

    Caller contract: *sel* is nonempty, and every spec's key columns were
    validated over the selected rows (the executor raises the host-parity
    errors with the right row numbers)."""
    from ..obs.joinskew import joinskew
    from ..utils.observe import telemetry

    n_sel = int(sel.shape[0])
    part_info: dict = {}  # one partitioned-tier state for every dimension

    def key_col(c):
        if not identity:
            return cols[c].gather(sel)
        if isinstance(sel, ShardedRows):  # a padded table's leading rows
            from ..columnar.table import host_or_storage

            return cols[c].with_storage(host_or_storage(cols[c].storage, n_sel))
        return cols[c]

    answers = [
        dev_index.probe([key_col(c) for c in kcols], n_sel, part_info)
        for dev_index, kcols in specs
    ]
    with telemetry.stage("join:expand", n_sel) as _exp:
        _exp["dims"] = len(specs)
        probe_ids, build_ids, total, inter = _multiway_ids(
            [lo for lo, _ in answers], [ct for _, ct in answers], n_sel, "fused", _exp
        )
        del answers  # as in multiway_join: free the answers before the gathers
        telemetry.barrier(_flat((probe_ids,) + build_ids))
    with telemetry.stage("join:merge", n_sel) as _mrg:
        sharded = isinstance(sel, ShardedRows)
        if probe_ids is None:
            # every selected row matched once per build side: the stream
            # side is the selection itself (identity: no gather at all)
            emit = None if identity else sel
            n_out = n_sel
        else:
            if identity:
                emit = probe_ids
            elif sharded:
                emit = smap(sel.mesh, lambda s, p: torch.index_select(s, 0, p), sel, probe_ids)
            else:
                emit = torch.index_select(sel, 0, probe_ids)
            n_out = total
        if emit is None:
            cur = dict(cols)
            if sharded:  # a padded table's blocks lose their tail
                from ..columnar.table import host_or_storage

                cur = {n: c.with_storage(host_or_storage(c.storage, n_sel))
                       for n, c in cur.items()}
        else:
            cur = {n: c.gather(emit) for n, c in cols.items()}
        cur = _merge_fold(cur, _gather_builds(specs, build_ids))
        _mrg["rows_out"] = n_out
        telemetry.barrier(_flat([c.storage for c in cur.values()]))
    if len(specs) >= 2:  # counter parity: the staged binary join never ticks
        joinskew.on_multiway(
            "+".join(",".join(di.key_columns) for di, _ in specs),
            len(specs), n_sel, n_out, inter,
        )
    return DeviceTable(cur, n_out, device)


def except_mask(
    stream: DeviceTable, dev_index: DeviceIndex, columns: Sequence[str]
) -> torch.Tensor:
    """Boolean keep-mask of the anti-join (csvplus.go:585-608): True where
    the stream row's key has no match in the index."""
    if stream.nrows == 0:
        mesh = stream.mesh
        if mesh is not None:
            return ShardedRows(mesh, [torch.zeros(0, dtype=torch.bool, device=d)
                                      for d in mesh.devices])
        return torch.zeros(0, dtype=torch.bool, device=stream.device)
    _, counts = dev_index.probe(_checked_probe_cols(stream, columns), stream.nrows)
    if isinstance(counts, ShardedRows):
        return counts.map(lambda c: c == 0)
    return counts == 0
