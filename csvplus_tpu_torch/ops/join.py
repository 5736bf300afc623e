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

Key tiers, kept as in the reference so tier choice matches:

* <= 23 packed bits: the dictionary-direct tier, two gathers from a
  ``cum`` table over the key universe;
* <= 31 bits: ``int32`` keys and ``searchsorted``;
* <= 62 bits: two nonnegative 31-bit ``int32`` lanes (hi, lo) and a
  branchless two-lane binary search;
* wider: unsupported, the chain runs on the host path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..columnar.table import DeviceTable, StringColumn, merge_with_fallback

_MASK31 = (1 << 31) - 1


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


def _searchsorted2(keys_hi, keys_lo, q_hi, q_lo) -> torch.Tensor:
    """Left searchsorted over (hi, lo) lane pairs: a branchless binary
    search with a fixed trip count of bit_length(n)."""
    n = int(keys_hi.shape[0])
    lo_idx = torch.zeros(q_hi.shape, dtype=torch.int64, device=q_hi.device)
    hi_idx = torch.full(q_hi.shape, n, dtype=torch.int64, device=q_hi.device)
    for _ in range(max(n.bit_length(), 1)):
        active = lo_idx < hi_idx
        mid = (lo_idx + hi_idx) >> 1
        safe = mid.clamp(0, max(n - 1, 0))
        kh = torch.index_select(keys_hi, 0, safe)
        kl = torch.index_select(keys_lo, 0, safe)
        descend = (kh < q_hi) | ((kh == q_hi) & (kl < q_lo))
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
    DIRECT_MAX_BITS: ClassVar[int] = 23

    @classmethod
    def build(cls, table: DeviceTable, key_columns: Sequence[str]) -> "DeviceIndex":
        key_columns = list(key_columns)
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

    @property
    def supported(self) -> bool:
        return self.shifts is not None

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

    def _packed_host(self) -> np.ndarray:
        """Host int64 mirror of the sorted packed keys (point lookups)."""
        host = getattr(self, "_host_keys", None)
        if host is None:
            if self.packed_i32 is not None:
                host = self.packed_i32.cpu().numpy().astype(np.int64)
            else:
                hi = self.packed_hi.cpu().numpy().astype(np.int64)
                host = (hi << 31) | self.packed_lo.cpu().numpy().astype(np.int64)
            self._host_keys = host
        return host

    def point_bounds(self, values: List[str]) -> Tuple[int, int]:
        """[lower, upper) range for one key-prefix probe (the reference's
        two binary searches, csvplus.go:881-887), on a host mirror of the
        sorted packed keys."""
        if len(values) > len(self.key_columns):
            raise ValueError("too many columns in Index.find()")
        if not values:
            return 0, self.table.nrows
        qk = 0
        for v, name, s in zip(values, self.key_columns, self.shifts):
            code = self.table.columns[name].find_code(v)
            if code < 0:
                return 0, 0  # value not in the index at all
            qk |= code << s
        range_size = 1 << self.shifts[len(values) - 1]
        host = self._packed_host()
        lower = int(np.searchsorted(host, np.int64(qk), side="left"))
        upper = int(np.searchsorted(host, np.int64(qk + range_size), side="left"))
        return lower, upper

    def probe(
        self, probe_cols: List[StringColumn], nrows: int
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(lower, counts) per probe row, both int32 on the probe's device.
        Fewer probe columns than key columns = a prefix probe."""
        k = len(probe_cols)
        # a typed probe column translates its value lanes against the
        # parsed build dictionary: the probe side is never demoted
        codes = [
            pc.renumbered_to_col(self.table.columns[name])
            for pc, name in zip(probe_cols, self.key_columns[:k])
        ]
        range_size = 1 << (self.shifts[k - 1] if k else 0)
        if self.packed_i32 is not None:
            if codes:
                qk = _pack_qk(codes, self.shifts[:k])
            else:
                qk = torch.zeros(nrows, dtype=torch.int32, device=self.table.device)
            cum = self.direct_cum
            if cum is not None:
                return direct_probe_parts(cum, qk, range_size)
            return _probe_i32(self.packed_i32, qk, range_size)
        ok = torch.ones(nrows, dtype=torch.bool, device=self.table.device)
        clamped = []
        for c in codes:
            ok = ok & (c >= 0)
            clamped.append(torch.where(c >= 0, c, 0))
        q_hi, q_lo = pack_lanes(clamped, self.shifts, self.bits)
        return _probe_i32pair(
            self.packed_hi, self.packed_lo, q_hi, q_lo, range_size, ok
        )


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
    if counts.shape[0] == 0:
        return 0, 0
    stats = torch.stack([counts.sum(dtype=torch.int64), counts.max().to(torch.int64)])
    total, maxc = stats.tolist()
    return int(total), int(maxc)


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


def _gather_cols(cols: Sequence[torch.Tensor], ids: torch.Tensor) -> List[torch.Tensor]:
    return [torch.index_select(c, 0, ids) for c in cols]


def join_tables(
    stream: DeviceTable, dev_index: DeviceIndex, columns: Sequence[str]
) -> DeviceTable:
    """stream ⋈ index with the reference's merge semantics: result rows
    carry all columns of both sides; on a name collision the stream's
    value wins where the stream row has the cell (csvplus.go:560,
    571-583); stream order is kept and each row's matches come out in
    index order (csvplus.go:559)."""
    if stream.nrows == 0:
        empty = torch.zeros(0, dtype=torch.int64, device=stream.device)
        out_cols = {
            name: col.gather(empty)
            for name, col in {**dev_index.table.columns, **stream.columns}.items()
        }
        return DeviceTable(out_cols, 0, stream.device)

    probe_cols = _checked_probe_cols(stream, columns)
    lower, counts = dev_index.probe(probe_cols, stream.nrows)
    total, maxc = _probe_stats(counts)
    probe_ids = None
    if maxc <= 1 and total == stream.nrows:
        # every stream row matched once: stream columns pass through
        # ungathered, build rows are addressed by the lower bounds
        build_ids = lower.to(torch.int64)
    elif maxc <= 1:
        probe_ids = torch.nonzero(counts > 0).squeeze(1)
        build_ids = torch.index_select(lower, 0, probe_ids).to(torch.int64)
    else:
        probe_ids, build_ids = expand_matches_device(lower, counts, total)

    build_names = list(dev_index.table.columns)
    stream_names = list(stream.columns)
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
    return DeviceTable(out_cols, n_out, stream.device)
