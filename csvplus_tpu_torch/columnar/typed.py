"""Typed numeric value lanes: the affix-int32 column.

Port of ``csvplus_tpu/columnar/typed.py``.  A column qualifies when every
cell is ``prefix + canonical int32 suffix``: one constant prefix for the
whole column, the suffix in canonical decimal form ("0" or [1-9][0-9]*,
a sign only with an empty prefix), so that parse -> format round-trips
bitwise.  That covers plain integers ("42", "-7") and prefixed ids
("o123", "c45"); leading zeros join the prefix ("o007" = "o00" + 7).

As an :class:`IntColumn` such a column is one int32 tensor: ingest is a
C++ parse and an upload, gathers and joins carry 4 bytes a row, and
decode is a C++ itoa.

Representation:

* ``values``: int32[n] on the table's device, the *storage* array (the
  typed counterpart of ``StringColumn.codes``); row order == source order.
* ``prefix``: bytes, constant for the column.
* typed columns never hold absent cells (CSV cells always exist; an op
  that would introduce absence demotes first), so ``has_absent`` is
  always False.  :data:`PAD_VALUE` (INT32_MIN) is the reference's
  sharding-pad sentinel: the parser bounds |v| <= INT32_MAX, so it never
  collides with a real cell, and the translations map it to -2.

Whatever needs dictionary semantics (code order == byte order: sorts,
index builds, packed join keys, point lookups) calls :meth:`_demote`, a
one-time conversion to the equivalent ``StringColumn``: ``torch.unique``
over the values, a C++ format and a stable byte-order argsort of the
unique set only, then ``searchsorted`` and a gather on the device.  It
is the explicit slow path; every demotion adds to :data:`demotions`.
The hot paths (ingest, equality masks, payload gathers, probe
translation, decode, checksums) never demote.
"""

from __future__ import annotations

import threading
from typing import List, Optional

import numpy as np
import torch

from ..parallel.mesh import ShardedRows, assemble
from .table import (
    gather_storage, host_array, per_shard, split_like, storage_device, tally_counts,
)

PAD_VALUE = np.int32(np.iinfo(np.int32).min)

#: Demotions made in this process, one ``(prefix, rows)`` entry each —
#: added where :meth:`IntColumn._demote` converts, nowhere else.
#: ``chip_smoke.py`` clears it before the main path and reads it after,
#: to show that no orders-side column was demoted.
demotions: list = []


class IntColumn:
    """One affix-int32 typed column (see the module docstring)."""

    kind = "int"

    def __init__(self, prefix: bytes, values, _demoted=None):
        self.prefix = prefix
        self._values = values  # a tensor, or ShardedRows when row-sharded
        self._demoted = _demoted  # cached StringColumn after demotion
        self._distinct: Optional[int] = None  # cached distinct-value count
        self._demote_lock = threading.Lock()

    # ---- the storage protocol shared with StringColumn ----

    @property
    def values(self) -> torch.Tensor:
        """The value lanes as one tensor; a sharded column's are assembled
        on its first shard's device (counted)."""
        return assemble(self._values)

    @property
    def storage(self):
        """The row-indexed device array (the typed ``codes`` counterpart):
        a tensor, or a ``ShardedRows`` for a row-sharded column."""
        return self._values

    def with_storage(self, values) -> "IntColumn":
        return IntColumn(self.prefix, values)

    def shard(self, i: int) -> "IntColumn":
        """Shard *i* of a row-sharded column as a column of its own."""
        return IntColumn(self.prefix, self._values.shards[i])

    def gather(self, sel) -> "IntColumn":
        """New column of the selected row positions (device gather; see
        ``table.gather_storage`` for a sharded column or selection)."""
        return IntColumn(self.prefix, gather_storage(self._values, sel))

    @property
    def has_absent(self) -> bool:
        return False  # typed columns never hold absent cells

    @property
    def dev_dictionary(self):
        return None  # no lane dictionary: the value lanes are the storage

    @property
    def dict_size(self) -> int:
        """The dictionary size this column would demote to: its count of
        distinct values (the affix format is one-to-one on canonical
        values), which the cost model reads as the column's distinct
        count.  The reference demotes the column to answer; here one
        ``torch.unique`` counts them, cached, and nothing is demoted."""
        if self._demoted is not None:
            return self._demoted.dict_size
        if self._distinct is None:
            st = self._values
            if isinstance(st, ShardedRows):
                # distinct values per shard, then across shards on the
                # first device; sharding pads are no value
                dev0 = st.mesh.devices[0]
                u = torch.unique(torch.cat([torch.unique(s).to(dev0) for s in st.shards]))
            else:
                u = torch.unique(st)
            self._distinct = int(u.numel()) - int(bool(u.numel()) and int(u[0]) == int(PAD_VALUE))
        return self._distinct

    def _ensure_sorted_lanes(self) -> None:
        return None  # no deferred lane union to settle

    # ---- decode (no demotion) ----

    def formatted_host(self) -> np.ndarray:
        """Every row formatted to 'S' bytes through the C++ itoa (the CSV
        sink's fast path)."""
        return format_affix(self.prefix, host_array(self._values))

    def formatted_str(self) -> np.ndarray:
        """Every row formatted as a numpy str array."""
        digits = host_array(self._values).astype(np.str_)
        p = self.prefix.decode("utf-8")
        return np.char.add(p, digits) if p else digits

    def decode(self) -> List[Optional[str]]:
        """Materialize the values on the host as Python strings, through
        the C++ itoa."""
        return [v.decode("utf-8") for v in self.formatted_host().tolist()]

    def values_host(self) -> np.ndarray:
        """Host mirror of the value lanes (one download, cached): the
        point-lookup decodes then make no device call, like
        ``StringColumn.codes_host``."""
        got = getattr(self, "_values_host", None)
        if got is None:
            got = self._values_host = host_array(self._values)
        return got

    def decode_take(self, idx: np.ndarray) -> List[Optional[str]]:
        """Rows at *idx* decoded off the host mirror (the batched lookup
        engine's gather-then-decode path)."""
        digits = self.values_host()[idx].astype(np.str_)
        p = self.prefix.decode("utf-8")
        return (np.char.add(p, digits) if p else digits).tolist()

    def equality_term(self, value: str):
        """The int32 target *value* equals on this column, or None when no
        cell can ever equal it (wrong prefix or a non-canonical suffix:
        typed cells only ever hold canonical forms)."""
        try:
            raw = value.encode("utf-8")
        except (UnicodeEncodeError, AttributeError):
            return None
        if not raw.startswith(self.prefix):
            return None
        digits = raw[len(self.prefix) :]
        body = digits[1:] if (not self.prefix and digits[:1] == b"-") else digits
        if not body.isdigit():
            return None
        if body != b"0" and body[:1] == b"0":
            return None  # non-canonical: cells never hold leading zeros
        try:
            v = int(digits)
        except ValueError:
            return None
        if not (-(2**31) < v < 2**31):
            return None
        if digits[:1] == b"-" and v == 0:
            return None  # "-0" is never stored
        return v

    # ---- the dictionary protocol through demotion (the slow path) ----

    def _demote(self):
        """The equivalent StringColumn (cached, thread-safe): the same
        dictionary and codes as the reference's demotion."""
        got = self._demoted
        if got is not None:
            return got
        with self._demote_lock:
            if self._demoted is not None:
                return self._demoted
            from ..utils.observe import telemetry
            from .table import StringColumn

            values = self.values  # a sharded column demotes whole (assembled)
            with telemetry.stage("typed:demote", int(values.shape[0])):
                demotions.append((self.prefix, int(values.shape[0])))
                u = torch.unique(values, sorted=True)
                uu = u.cpu().numpy()
                # sharding pads (PAD_VALUE sorts first) never enter the
                # dictionary; their rows code as -2 below
                has_pad = bool(uu.size) and uu[0] == PAD_VALUE
                if has_pad:
                    uu = uu[1:]
                    u = u[1:]
                strs = format_affix(self.prefix, uu)
                order = np.argsort(strs, kind="stable")  # numeric -> byte order
                dictionary = strs[order]
                if uu.size == 0:  # an empty (or all-pad) column
                    codes = torch.full(
                        values.shape, -2 if has_pad else -1,
                        dtype=torch.int32, device=values.device,
                    )
                else:
                    code_of = np.empty(uu.shape[0], dtype=np.int32)
                    code_of[order] = np.arange(uu.shape[0], dtype=np.int32)
                    # numeric rank per row, then numeric slot -> byte-order code
                    pos = torch.searchsorted(u, values).clamp(max=int(uu.shape[0]) - 1)
                    codes = torch.index_select(
                        torch.from_numpy(code_of).to(values.device), 0, pos
                    )
                    if has_pad:
                        codes = torch.where(values == int(PAD_VALUE), -2, codes)
                self._demoted = StringColumn(
                    dictionary, split_like(codes, self._values),
                    _has_absent=False if not has_pad else None,
                )
        return self._demoted

    @property
    def codes(self) -> torch.Tensor:
        return self._demote().codes

    @property
    def dictionary(self) -> np.ndarray:
        return self._demote().dictionary

    def with_codes(self, codes: torch.Tensor):
        return self._demote().with_codes(codes)

    def codes_host(self) -> np.ndarray:
        return self._demote().codes_host()

    def decode_codes(self, codes: np.ndarray) -> List[Optional[str]]:
        return self._demote().decode_codes(codes)

    # A dense translation table is built when the build side's value range
    # is at most this multiple of its distinct count: one O(range) int32
    # array turns the per-row translation into a single gather.
    DENSE_RANGE_FACTOR = 16
    DENSE_RANGE_MAX = 1 << 24  # 64 MB of int32 at the cap

    @staticmethod
    def _build_translation(vals: np.ndarray, cand: np.ndarray, device: torch.device):
        """Device translation state from the build side's (values, codes):
        ('dense', base, table) when the value range is compact, else
        ('sorted', sorted_vals, code_of)."""
        if vals.size == 0:
            return ("sorted", torch.from_numpy(vals).to(device),
                    torch.from_numpy(cand).to(device))
        lo, hi = int(vals.min()), int(vals.max())
        rng = hi - lo + 1
        if rng <= IntColumn.DENSE_RANGE_MAX and rng <= max(
            vals.size * IntColumn.DENSE_RANGE_FACTOR, 1024
        ):
            table = np.full(rng, -1, dtype=np.int32)
            table[vals - lo] = cand
            return ("dense", lo, torch.from_numpy(table).to(device))
        order = np.argsort(vals, kind="stable")
        return ("sorted", torch.from_numpy(vals[order]).to(device),
                torch.from_numpy(cand[order]).to(device))

    def _translate_by_values(self, state) -> torch.Tensor:
        """Rows translated through a :meth:`_build_translation` state;
        miss -> -1, sharding pads -> -2."""
        if state[0] == "dense":
            _, lo, table = state
            return per_shard(lambda v, t: translate_dense(v, lo, t), self._values, table)
        _, sorted_vals, code_of = state
        if int(sorted_vals.shape[0]) == 0:
            return per_shard(translate_empty, self._values)
        return per_shard(translate_sorted, self._values, sorted_vals, code_of)

    def renumbered_to(self, other_dictionary: np.ndarray) -> torch.Tensor:
        """Rows translated into *other_dictionary*'s code space without
        demoting self: the (small) dictionary is parsed numerically and
        the value lanes looked up in it."""
        cand, vals = parse_affix_dictionary(other_dictionary, self.prefix)
        return self._translate_by_values(
            self._build_translation(vals, cand, storage_device(self._values))
        )

    def renumbered_to_col(self, other, tally: "dict | None" = None) -> torch.Tensor:
        """Rows translated into *other*'s code space (the probe side of a
        join).  A StringColumn *other* has its dictionary parsed
        numerically, so self stays value lanes; an IntColumn *other* is
        demoted first (build sides are index tables whose key columns
        hold code semantics).  The parsed table is cached on *other* per
        prefix, so repeated probes of one build side parse it once.

        *tally* (a stage's dict) gains ``host_entries``, the build
        dictionary's entries parsed on the host, and ``h2d_bytes``, the
        translation state sent up: both 0 when the cache serves."""
        if isinstance(other, IntColumn):
            other = other._demote()
        cache = getattr(other, "_affix_trans_cache", None)
        if cache is None:
            cache = other._affix_trans_cache = {}
        hit = cache.get(self.prefix)
        missed = hit is None
        if missed:
            cand, vals = parse_affix_dictionary(other.dictionary, self.prefix)
            hit = cache[self.prefix] = self._build_translation(
                vals, cand, storage_device(self._values)
            )
        if tally is not None:
            entries = int(other.dictionary.size) if missed else 0
            sent = sum(x.numel() * x.element_size() for x in hit[1:]
                       if isinstance(x, torch.Tensor)) if missed else 0
            tally_counts(tally, host_entries=entries, h2d_bytes=sent)
        return self._translate_by_values(hit)


def translate_dense(values: torch.Tensor, lo: int, table: torch.Tensor) -> torch.Tensor:
    """``table[values - lo]`` where in range, -1 elsewhere, -2 for pads.
    Pads are masked before the int32 subtraction: ``PAD_VALUE - lo``
    wraps and could land inside the table.  Torch's gather raises on an
    out-of-range index where ``jnp.take`` clips, so the index is clamped
    first."""
    is_pad = values == int(PAD_VALUE)
    idx = torch.where(is_pad, lo, values) - lo
    n = int(table.shape[0])
    ok = (idx >= 0) & (idx < n) & ~is_pad
    got = torch.index_select(table, 0, idx.clamp(0, n - 1))
    return torch.where(ok, got, torch.where(is_pad, -2, -1).to(torch.int32))


def translate_sorted(
    values: torch.Tensor, sorted_vals: torch.Tensor, code_of: torch.Tensor
) -> torch.Tensor:
    """``code_of[i]`` where ``sorted_vals[i] == value`` (left search, as
    ``jnp.searchsorted``), -1 on a miss, -2 for pads."""
    is_pad = values == int(PAD_VALUE)
    pos = torch.searchsorted(sorted_vals, values).clamp(max=int(sorted_vals.shape[0]) - 1)
    hit = (torch.index_select(sorted_vals, 0, pos) == values) & ~is_pad
    return torch.where(
        hit,
        torch.index_select(code_of, 0, pos),
        torch.where(is_pad, -2, -1).to(torch.int32),
    )


def translate_empty(values: torch.Tensor) -> torch.Tensor:
    """The translation into an empty build side: -1, or -2 for pads."""
    return torch.where(values == int(PAD_VALUE), -2, -1).to(torch.int32)


def format_affix(prefix: bytes, values: np.ndarray) -> np.ndarray:
    """'S' bytes array of ``prefix + decimal(value)`` per entry, through
    the C++ itoa (the inverse of the native ``csv_pack_int32`` parse)."""
    from ..native.scanner import format_i32_native

    values = np.ascontiguousarray(values, dtype=np.int32)
    plen = len(prefix)
    mat, _lens = format_i32_native(values)
    width = plen + mat.shape[1]
    out = np.zeros((values.shape[0], width), dtype=np.uint8)
    if plen:
        out[:, :plen] = np.frombuffer(prefix, dtype=np.uint8)
    out[:, plen:] = mat
    return np.ascontiguousarray(out).view(f"S{width}").ravel()


def parse_affix_dictionary(d: np.ndarray, prefix: bytes):
    """Which entries of the 'S' dictionary *d* have the affix form
    ``prefix + canonical int32``?  Returns (entry indices int32[], values
    int32[]), vectorized over the fixed-width byte matrix."""
    U = d.shape[0]
    plen = len(prefix)
    if U == 0:
        return np.empty(0, np.int32), np.empty(0, np.int32)
    width = d.dtype.itemsize
    lens = np.char.str_len(d).astype(np.int32)
    if width < plen + 1:
        return np.empty(0, np.int32), np.empty(0, np.int32)
    mat = np.frombuffer(np.ascontiguousarray(d).tobytes(), dtype=np.uint8).reshape(U, width)
    ok = lens > plen
    if plen:
        pref = np.frombuffer(prefix, dtype=np.uint8)
        ok &= (mat[:, :plen] == pref).all(axis=1)
    # an optional sign (empty prefix only)
    neg = np.zeros(U, dtype=bool)
    if plen == 0:
        neg = mat[:, 0] == ord("-")
        ok &= ~neg | (lens > 1)
    digit_start = plen + neg.astype(np.int32)
    sfx_len = lens - digit_start
    ok &= (sfx_len >= 1) & (sfx_len <= 10)
    colidx = np.arange(width, dtype=np.int32)
    in_sfx = (colidx >= digit_start[:, None]) & (colidx < lens[:, None])
    is_digit = (mat >= ord("0")) & (mat <= ord("9"))
    ok &= np.where(in_sfx, is_digit, True).all(axis=1)
    # canonical: no leading zero unless the suffix is "0"
    first = mat[np.arange(U), np.minimum(digit_start, width - 1)]
    ok &= (first != ord("0")) | (sfx_len == 1)
    if not ok.any():
        return np.empty(0, np.int32), np.empty(0, np.int32)
    exp = (lens[:, None] - 1 - colidx).astype(np.int64)
    w = np.where(in_sfx, 10 ** np.clip(exp, 0, 9), 0)
    vals = ((mat.astype(np.int64) - ord("0")) * w).sum(axis=1)
    vals = np.where(neg, -vals, vals)
    ok &= (vals < 2**31) & (vals > -(2**31)) & ~(neg & (vals == 0))
    cand = np.flatnonzero(ok).astype(np.int32)
    return cand, vals[ok].astype(np.int32)
