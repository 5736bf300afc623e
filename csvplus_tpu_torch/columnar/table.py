"""Device-resident columnar tables.

Port of ``csvplus_tpu/columnar/table.py``.  A column is either a typed
affix-int32 column (:class:`~csvplus_tpu_torch.columnar.typed.IntColumn`,
one int32 value per row, what the native ingest makes of every column of
the form ``prefix + canonical int32``) or a dictionary-encoded
:class:`StringColumn`:

* ``dictionary``: the column's unique values as a host numpy ``'S'``
  (UTF-8 bytes) array, sorted byte-lexicographically — Go's
  ``strings.Compare`` order, so code order == string order;
* ``codes``: an ``int32[n]`` tensor on the table's device mapping row ->
  dictionary slot; ``-1`` marks an absent cell.

A high-cardinality column from the streamed ingest keeps its dictionary
on the device instead, as packed int32 byte lanes (:mod:`..ops.lanes`),
possibly unsorted until an operation needs code order (see
:class:`StringColumn`).

Both kinds share one storage protocol (``kind``, ``storage``,
``with_storage``, ``gather``), so row-materializing ops (gathers, join
emits) carry either kind without converting it.  Predicates, joins and
sorts run on codes or value lanes; strings come back to the host only at
the sink boundary.  Every constructor takes an explicit
``device``: ``"cuda"`` (the default of the public entry points) or
``"cpu"``, and ``"cuda"`` raises when no card is present — nothing falls
back to the CPU quietly.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..parallel.mesh import Mesh, ShardedRows, assemble, relayout, replicate, smap
from ..row import Row
from ..utils.env import env_int

ABSENT = -1
#: The sharding pad of a dictionary code: never a slot, and distinct from
#: ``ABSENT`` so a pad row is never taken for a missing cell.
PAD_CODE = -2


def resolve_device(device: "str | torch.device") -> torch.device:
    """The torch device for *device* (``"cuda"``, ``"cuda:N"``, ``"cpu"``
    or a ``torch.device``).  A CUDA device with no card present raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but no CUDA card is present"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev


def _to_bytes_array(values) -> np.ndarray:
    """UTF-8 encode a sequence/array of str into an 'S' bytes array."""
    arr = np.asarray(values, dtype=np.str_)
    return np.char.encode(arr, "utf-8")


def encode_strings(values: Sequence[str]) -> "tuple[np.ndarray, np.ndarray]":
    """Dictionary-encode a string column: (sorted unique values, int32 codes).

    The same dictionary as ``csvplus_tpu.columnar.table.encode_strings``,
    bit for bit: index sort order and carried-over tables depend on it.
    ``None`` entries (absent cells) encode as code -1 and do not enter the
    dictionary.
    """
    if isinstance(values, np.ndarray) and values.dtype.kind in ("U", "S"):
        arr_b = values if values.dtype.kind == "S" else np.char.encode(values, "utf-8")
        dictionary, codes = np.unique(arr_b, return_inverse=True)
        return dictionary, codes.astype(np.int32)
    arr = np.asarray(values, dtype=object)
    present = np.array([v is not None for v in arr], dtype=bool)
    if present.all():
        dictionary, codes = np.unique(_to_bytes_array(values), return_inverse=True)
        return dictionary, codes.astype(np.int32)
    codes = np.full(len(arr), ABSENT, dtype=np.int32)
    if present.any():
        present_vals = _to_bytes_array([v for v in arr if v is not None])
        dictionary, inv = np.unique(present_vals, return_inverse=True)
        codes[present] = inv.astype(np.int32)
    else:
        dictionary = np.empty(0, dtype="S1")
    return dictionary, codes


def lookup_code(dictionary: np.ndarray, value: str) -> int:
    """Dictionary slot of *value*, or -1 when absent (host binary search)."""
    if dictionary.size == 0:
        return -1
    key = value.encode("utf-8") if dictionary.dtype.kind == "S" else value
    i = int(np.searchsorted(dictionary, key))
    if i < dictionary.size and dictionary[i] == key:
        return i
    return -1


def apply_code_translation(codes, trans: torch.Tensor):
    """``trans[codes]`` with negative codes (absent -1, pad -2) passed
    through unchanged; a sharded *codes* translates per shard against a
    copy of *trans* per distinct device.

    Torch indexing raises on an out-of-range index where ``jnp.take``
    clips, so the codes are clamped before the gather and the negative
    ones restored after it."""
    def one(c, t):
        got = torch.index_select(t, 0, c.clamp(min=0))
        return torch.where(c >= 0, got, c)

    return per_shard(one, codes, trans)


# -- sharded storage --------------------------------------------------------
#
# A row-sharded column's storage is a :class:`ShardedRows`: one block per
# shard of the mesh, in row order (the reference's ``NamedSharding`` of
# one global array).  A table made by ``with_sharding`` or the sharded
# ingest holds equal blocks of ``ceil(n / k)`` rows, the tail padded
# (``PAD_CODE`` / ``typed.PAD_VALUE``); a table an operation makes from
# selected rows holds blocks of any length and no pads.  Operations run
# per shard (:func:`per_shard`); the few that need the whole array on one
# device (``.codes`` / ``.values`` of a sharded column) assemble it, and
# every assembly is counted (``parallel.mesh.assemblies``).


def per_shard(fn, x, *args):
    """``fn(x, *args)`` for a tensor *x*; for a :class:`ShardedRows` *x*,
    ``fn`` per shard, with the shards of ShardedRows arguments and every
    tensor argument copied once per distinct device."""
    if not isinstance(x, ShardedRows):
        return fn(x, *args)
    mesh = x.mesh
    args = [replicate(mesh, a) if isinstance(a, torch.Tensor) else a for a in args]
    return smap(mesh, fn, x, *args)


def storage_device(x) -> torch.device:
    """The device of a storage array (a sharded one's first shard)."""
    return x.shards[0].device if isinstance(x, ShardedRows) else x.device


def host_array(x, n: "int | None" = None) -> np.ndarray:
    """The first *n* logical rows (all by default) of a storage array on
    the host; a sharded array downloads shard by shard, in order."""
    if not isinstance(x, ShardedRows):
        return (x if n is None else x[:n]).cpu().numpy()
    parts, left = [], x.nrows if n is None else n
    for s in x.shards:
        if left <= 0:
            break
        parts.append(s[:left].cpu().numpy())
        left -= int(s.shape[0])
    if not parts:
        return x.shards[0][:0].cpu().numpy()
    return np.concatenate(parts)


def sharded_any(parts: ShardedRows) -> bool:
    """True when any shard's 0-d bool holds: one transfer."""
    dev0 = parts.mesh.devices[0]
    return bool(torch.stack([p.to(dev0) for p in parts.shards]).any().item())


class GlobalRows(ShardedRows):
    """A sharded selection of GLOBAL row positions (the sample sort's
    permutation), where a plain :class:`ShardedRows` selection holds
    shard-local row ids."""


def gather_storage(x, sel):
    """*x* at the row positions *sel*.  A sharded *sel* holds shard-local
    row ids (the executor's selection): each shard gathers from its own
    block, or from a copy of an unsharded *x* per distinct device.  A
    :class:`GlobalRows` *sel* holds global positions: each shard gathers
    from a copy of *x* on its device (one a distinct device, counted
    when *x* is sharded), and the result is sharded as *sel* is.  A
    plain *sel* holds global positions: a sharded *x* sends each shard's
    selected rows to *sel*'s device (only those rows move)."""
    if isinstance(sel, GlobalRows):
        return smap(sel.mesh, lambda c, i: torch.index_select(c, 0, i),
                    replicate(sel.mesh, x), sel)
    if isinstance(sel, ShardedRows):
        if isinstance(x, ShardedRows):
            return smap(sel.mesh, lambda c, i: torch.index_select(c, 0, i), x, sel)
        return smap(sel.mesh, lambda c, i: torch.index_select(c, 0, i),
                    replicate(sel.mesh, x), sel)
    if not isinstance(x, ShardedRows):
        return torch.index_select(x, 0, sel)
    out = torch.empty(sel.shape, dtype=x.dtype, device=sel.device)
    for off, blk in zip(x.offsets(), x.shards):
        hit = (sel >= off) & (sel < off + int(blk.shape[0]))
        local = (sel[hit] - off).to(blk.device)
        out[hit] = torch.index_select(blk, 0, local).to(sel.device)
    return out


def split_like(x: torch.Tensor, like):
    """A tensor row-aligned with the storage *like* in *like*'s layout:
    sharded the same way when *like* is sharded."""
    if not isinstance(like, ShardedRows):
        return x
    return ShardedRows(like.mesh, relayout(like.mesh, x, like.lens))


#: Deferred lane-dictionary union sorts made in this process, one entry
#: (the concatenated dictionary's slot count) per sort — added where
#: :meth:`StringColumn._settle_locked` sorts, nowhere else.  Tests and
#: ``chip_smoke.py`` read it to show that a payload-only lane column never
#: sorts and that keying on one sorts it once.
lane_sorts: list = []


class _LaneState:
    """Shared mutable state of one device-lane dictionary.

    ``with_codes``/``gather`` copies of a column point at the same state,
    so the deferred union sort (:meth:`StringColumn._ensure_sorted_lanes`)
    runs once: after it, ``trans`` (old slot -> sorted slot) lets every
    other copy remap its codes with one gather.  The lock serializes the
    sort and the publication of ``trans``."""

    __slots__ = ("lanes", "sorted", "trans", "lock")

    def __init__(self, lanes: tuple, sorted_: bool):
        self.lanes = lanes
        self.sorted = sorted_
        self.trans = None
        self.lock = threading.Lock()


class _HostLanes:
    """Device search forms of one host dictionary, shared by every
    ``with_codes``/``gather``/``shard`` copy of a column, as
    :class:`_LaneState` is: a join's probe column is a fresh gather of a
    resident column at every query, with the same dictionary and this
    same state, so the dictionary is packed and uploaded once, not once
    a query.

    ``forms`` maps (device, lane count) to (search keys, slot map | None)
    (:meth:`StringColumn._search_form`).  The state holds the dictionary
    itself, which is never mutated, so a form never goes stale.  The
    lock serializes the packing: probes run on worker threads too."""

    __slots__ = ("dictionary", "forms", "lock")

    def __init__(self, dictionary: np.ndarray):
        self.dictionary = dictionary
        self.forms: dict = {}
        self.lock = threading.Lock()


class StringColumn:
    """One dictionary-encoded string column.

    The dictionary normally lives on the host (sorted 'S' bytes).  A
    high-cardinality column from the streamed ingest may carry it on the
    device instead, as sign-flipped int32 byte lanes (:mod:`..ops.lanes`)
    with ``dictionary=None``; reading ``.dictionary`` then downloads and
    unpacks the lanes once, the sink-boundary cost.  Such a lane
    dictionary may be **unsorted** (``dev_dict_sorted=False``: the
    streamed tier's concatenated chunk dictionaries, duplicates included,
    codes offset per chunk).  Decodes, gathers and checksums work on it
    as it is; whatever needs code order == byte order (``find_code``,
    joins, sorts, the host dictionary) calls :meth:`_ensure_sorted_lanes`
    first, which sorts the union on the device once per shared state.
    """

    kind = "str"

    def __init__(
        self,
        dictionary: "np.ndarray | None",
        codes: torch.Tensor,
        _has_absent: "bool | None" = None,
        dev_dictionary: "tuple | None" = None,
        dev_dict_sorted: bool = True,
        _lane_state: "_LaneState | None" = None,
        _host_lanes: "_HostLanes | None" = None,
    ):
        assert dictionary is not None or dev_dictionary is not None or _lane_state is not None
        self._dictionary = dictionary
        self._has_absent = _has_absent  # lazy cache: any absent cell?
        self._str_dict: "np.ndarray | None" = None  # lazy cache: decoded dict
        self._codes_host: "np.ndarray | None" = None  # lazy cache: host codes
        if _lane_state is not None:
            self._lane_state = _lane_state
        elif dev_dictionary is not None:
            self._lane_state = _LaneState(tuple(dev_dictionary), dev_dict_sorted)
        else:
            self._lane_state = None
        # a lane column's host dictionary, if it is ever downloaded, is not
        # searched: its lanes are
        if self._lane_state is not None:
            self._host_lanes = None
        else:
            self._host_lanes = _host_lanes if _host_lanes is not None else _HostLanes(dictionary)
        # (codes, codes index the settled lane order) publish as one tuple:
        # a copy made while a sibling settles on another thread must never
        # pair remapped codes with a stale flag
        self._codes_state = (codes, dev_dict_sorted if self._lane_state is not None else True)

    @property
    def codes(self) -> torch.Tensor:
        """The code array as one tensor; a sharded column's is assembled
        on its first shard's device (counted, see :func:`per_shard`)."""
        return assemble(self._codes_state[0])

    @property
    def storage(self) -> "torch.Tensor | ShardedRows":
        """The row-indexed device array (the protocol shared with
        ``IntColumn``, whose storage is its value lanes): a tensor, or a
        :class:`ShardedRows` for a row-sharded column."""
        return self._codes_state[0]

    def with_storage(self, codes) -> "StringColumn":
        return self.with_codes(codes)

    @property
    def _dev_dict_sorted(self) -> bool:
        return self._codes_state[1]

    @property
    def dev_dictionary(self) -> "tuple | None":
        """The device lane dictionary, coherent with ``self.codes``: if a
        sibling copy already settled the shared state, this copy's codes
        are remapped (one gather, no sort) before the lanes are exposed."""
        st = self._lane_state
        if st is None:
            return None
        if self._dev_dict_sorted:
            return st.lanes
        with st.lock:
            if st.sorted:
                self._settle_locked(st)  # remap only: the sort already ran
            return st.lanes

    @property
    def dictionary(self) -> np.ndarray:
        """The host dictionary; for a lane column it is downloaded and
        unpacked on first use (after the union is sorted), then cached."""
        if self._dictionary is None:
            from ..ops.lanes import unpack_host

            self._ensure_sorted_lanes()
            self._dictionary = unpack_host([lane.cpu().numpy() for lane in self._lane_state.lanes])
        return self._dictionary

    def _ensure_sorted_lanes(self) -> None:
        """Sort and dedupe a deferred (unsorted) lane dictionary on the
        device and remap this column's codes to the sorted slots.  The sort
        runs once per shared lane state; a column that is only gathered or
        checksummed never pays it."""
        st = self._lane_state
        if st is None or self._dev_dict_sorted:
            return
        with st.lock:
            self._settle_locked(st)

    def _settle_locked(self, st: "_LaneState") -> None:
        """Settle the shared state (once) and remap this copy's codes.
        The caller holds ``st.lock``."""
        if self._dev_dict_sorted:  # a sibling settled this copy meanwhile
            return
        if not st.sorted:
            from ..ops.lanes import union_device
            from ..utils.observe import telemetry

            with telemetry.stage("lane-dict:deferred-sort", int(st.lanes[0].shape[0])):
                lane_sorts.append(int(st.lanes[0].shape[0]))
                union, (trans,) = union_device([st.lanes])
                # st.sorted publishes: set it last, after trans and the lanes
                st.trans = trans
                st.lanes = union
                st.sorted = True
        self._codes_state = (apply_code_translation(self._codes_state[0], st.trans), True)

    @property
    def dict_size(self) -> int:
        """Dictionary slot count without building a host dictionary; an
        unsorted lane dictionary may overcount (duplicates across
        chunks) until it is settled."""
        if self._dictionary is not None:
            return int(self._dictionary.size)
        return int(self._lane_state.lanes[0].shape[0])

    def find_code(self, value: str) -> int:
        """Dictionary slot of *value* or -1: a host binary search, or for
        a lane column a device lane search with one scalar sync (no
        dictionary download)."""
        if self._dictionary is not None:
            return lookup_code(self._dictionary, value)
        return int(self.find_codes([value])[0])

    def find_codes(self, values: Sequence[str]) -> np.ndarray:
        """:meth:`find_code` over a batch of values: int64 codes, -1 where
        absent.  One ``np.searchsorted`` on a host dictionary, or one lane
        translation on the device for a lane dictionary."""
        m = len(values)
        if m == 0:
            return np.empty(0, dtype=np.int64)
        if self._dictionary is not None:
            d = self._dictionary
            if d.size == 0:
                return np.full(m, -1, dtype=np.int64)
            enc = np.array([v.encode("utf-8") for v in values], dtype="S")
            pos_c = np.clip(np.searchsorted(d, enc), 0, d.size - 1)
            return np.where(d[pos_c] == enc, pos_c, -1).astype(np.int64)
        from ..ops.lanes import MAX_LANE_BYTES, lanes_for_width, pack_host, translate_lanes

        self._ensure_sorted_lanes()  # the lane search needs sorted order
        lanes = self.dev_dictionary
        n_lanes = len(lanes)
        out = np.full(m, -1, dtype=np.int64)
        keys = [v.encode("utf-8") for v in values]
        # values wider than every stored entry cannot match
        fit = [
            i for i, k in enumerate(keys)
            if len(k) <= MAX_LANE_BYTES and lanes_for_width(len(k)) <= n_lanes
        ]
        if fit:
            sub = np.array([keys[i] for i in fit], dtype="S")
            dev = lanes[0].device
            qs = tuple(torch.from_numpy(q).to(dev) for q in pack_host(sub, n_lanes))
            out[fit] = translate_lanes(lanes, qs).cpu().numpy()
        return out

    @property
    def has_absent(self) -> bool:
        """True when any cell is absent (one cached scalar sync)."""
        if self._has_absent is None:
            st = self.storage
            if isinstance(st, ShardedRows):
                self._has_absent = sharded_any(st.map(lambda c: (c == ABSENT).any()))
            else:
                self._has_absent = bool((st == ABSENT).any())
        return self._has_absent

    @classmethod
    def from_values(cls, values: Sequence[str], device: torch.device) -> "StringColumn":
        dictionary, codes = encode_strings(values)
        has_absent = bool(codes.size) and bool(codes.min() < 0)
        return cls(dictionary, torch.from_numpy(codes).to(device), _has_absent=has_absent)

    @classmethod
    def constant(cls, value: str, n: int, device: torch.device) -> "StringColumn":
        return cls(
            np.asarray([value.encode("utf-8")], dtype="S"),
            torch.zeros(n, dtype=torch.int32, device=device),
            _has_absent=False,
        )

    @classmethod
    def constant_like(cls, value: str, like) -> "StringColumn":
        """A constant column laid out as the storage *like* (sharded the
        same way when it is sharded)."""
        if not isinstance(like, ShardedRows):
            return cls.constant(value, int(like.shape[0]), like.device)
        codes = like.map(lambda c: torch.zeros(c.shape[0], dtype=torch.int32, device=c.device))
        return cls(np.asarray([value.encode("utf-8")], dtype="S"), codes, _has_absent=False)

    def codes_host(self) -> np.ndarray:
        """Host mirror of the code array (one download, cached).  Point
        lookups on a device-lazy index decode matched ranges from it in
        numpy: one O(n) transfer buys lookups with no device round trip."""
        if self._codes_host is None:
            self._ensure_sorted_lanes()  # the mirror must be post-remap
            self._codes_host = host_array(self.storage)
        return self._codes_host

    def dictionary_str(self) -> np.ndarray:
        """The dictionary as python-str values (decoded lazily, cached)."""
        if self._str_dict is None:
            d = self.dictionary
            self._str_dict = (
                np.char.decode(d, "utf-8") if d.size else np.empty(0, np.str_)
            )
        return self._str_dict

    def with_codes(
        self, codes: torch.Tensor, dev_dict_sorted: "bool | None" = None
    ) -> "StringColumn":
        """A column over *codes* with this column's dictionary, lane state
        and decoded cache; ``has_absent`` carries over only when known
        False (a subset of a fully-present column is fully present).
        *dev_dict_sorted* is the flag read together with the codes
        *codes* came from; left out, the current flag is used."""
        out = StringColumn(
            self._dictionary,
            codes,
            dev_dict_sorted=self._dev_dict_sorted if dev_dict_sorted is None else dev_dict_sorted,
            _lane_state=self._lane_state,
            _host_lanes=self._host_lanes,
        )
        out._str_dict = self._str_dict
        if self._has_absent is False:
            out._has_absent = False
        return out

    def shard(self, i: int) -> "StringColumn":
        """Shard *i* of a row-sharded column as a column of its own (its
        block of codes, this column's dictionary)."""
        src, flag = self._codes_state
        return self.with_codes(src.shards[i], dev_dict_sorted=flag)

    def gather(self, sel: torch.Tensor) -> "StringColumn":
        """New column of the selected row positions (device gather)."""
        src, flag = self._codes_state  # one coherent pair
        return self.with_codes(gather_storage(src, sel), dev_dict_sorted=flag)

    def decode_codes(self, codes: np.ndarray) -> List[Optional[str]]:
        """Decode a host code slice; absent cells (negative codes) become
        None.  The codes must be read after :meth:`_ensure_sorted_lanes`.
        A slice with fewer rows than the dictionary has entries (lookups,
        a dedup's duplicate groups), while no decoded dictionary is
        cached, decodes only the entries it selects: from the host
        dictionary, or, for a lane column with none, from its lanes
        gathered on the device, so no host dictionary is built.  A larger
        slice decodes the whole dictionary once and caches it."""
        if self.dict_size == 0 or codes.shape[0] == 0:
            return [None] * codes.shape[0]
        pos = np.clip(codes, 0, self.dict_size - 1)
        if self._str_dict is None and codes.shape[0] < self.dict_size:
            if self._dictionary is None:
                from ..ops.lanes import unpack_host

                lanes = self.dev_dictionary
                sel = torch.from_numpy(pos.astype(np.int64)).to(lanes[0].device)
                vals = unpack_host([torch.index_select(lane, 0, sel).cpu().numpy()
                                    for lane in lanes])
            else:
                vals = self._dictionary[pos]
            out = [v.decode("utf-8") for v in vals.tolist()]
        else:
            out = self.dictionary_str()[pos].tolist()
        if (codes < 0).any():
            out = [None if c < 0 else v for c, v in zip(codes.tolist(), out)]
        return out

    def decode(self) -> List[Optional[str]]:
        """Materialize values on host; absent cells become None."""
        self._ensure_sorted_lanes()  # before the codes are read
        return self.decode_codes(host_array(self.storage))

    def _lane_count(self) -> int:
        """Lanes this dictionary packs into: a lane dictionary's own, or
        enough for a host dictionary's width (past ``MAX_LANE_BYTES`` too:
        two host dictionaries search at any width)."""
        from ..ops.lanes import lanes_for_width

        if self._host_lanes is None:
            return len(self.dev_dictionary)
        width = self._dictionary.dtype.itemsize if self._dictionary.size else 1
        return lanes_for_width(width) or -(-width // 4)

    def _search_form(self, n_lanes: int, dev: torch.device) -> tuple:
        """``(search keys, slot map | None, bytes uploaded)``: this
        dictionary packed into *n_lanes* lanes on *dev*, in the form
        ``ops.lanes.fold_lanes`` gives for the search.  A lane dictionary
        is widened and folded as it is (nothing goes up).  A host
        dictionary is packed and uploaded once per (device, lane count)
        and kept in the state every copy shares, so only its first call
        uploads.  Entries wider than *n_lanes* lanes (a host dictionary
        against a lane one, capped at ``MAX_LANE_BYTES``) can equal no
        lane entry: they are left out, and the slot map gives the packed
        entries' slots in the whole dictionary."""
        from ..ops.lanes import fold_lanes, pack_host, widen_lanes_device

        if self._host_lanes is None:
            self._ensure_sorted_lanes()  # translation needs sorted lanes
            lanes = tuple(x.to(dev) for x in self.dev_dictionary)
            return fold_lanes(widen_lanes_device(lanes, n_lanes)), None, 0
        st = self._host_lanes
        key = (dev, n_lanes)
        got = st.forms.get(key)
        if got is not None:
            return got + (0,)
        with st.lock:
            got = st.forms.get(key)
            if got is not None:
                return got + (0,)
            d, pos = st.dictionary, None
            if d.size and d.dtype.itemsize > 4 * n_lanes:
                keep = np.char.str_len(d) <= 4 * n_lanes
                pos = torch.from_numpy(np.flatnonzero(keep).astype(np.int32)).to(dev)
                d = d[keep]
            lanes = [torch.from_numpy(x).to(dev) for x in pack_host(d, n_lanes)]
            sent = sum(x.numel() * x.element_size() for x in lanes)
            sent += 0 if pos is None else pos.numel() * pos.element_size()
            got = st.forms[key] = (fold_lanes(lanes), pos)
        return got + (sent,)

    def renumbered_to_col(self, other, tally: "dict | None" = None) -> torch.Tensor:
        """This column's codes in *other*'s code space (the probe side of
        a join), translated on the device: both dictionaries in their
        search form (:meth:`_search_form`), one search of the probe's
        entries in the build's, a gather of the codes.  A host
        dictionary's form is built once and kept, so a probe uploads
        nothing after the first; the search runs every call.  Two lane
        dictionaries, or a lane dictionary and a host one, search at the
        wider's lane count, at most ``MAX_LANE_BYTES``; two host
        dictionaries at any width.  An ``IntColumn`` *other* is demoted
        to its dictionary.

        *tally* (a stage's dict) gains ``host_entries``, the dictionary
        entries searched on the host (0: none is), ``device_entries``,
        the probe dictionary's entries searched on the device, and
        ``h2d_bytes``, the lanes and slot maps this call uploaded."""
        from ..ops.lanes import MAX_LANE_BYTES, _translate_kernel

        if other.kind == "int":
            other = other._demote()
        self._ensure_sorted_lanes()  # a deferred lane dictionary remaps the codes first
        codes = self.storage
        if self.dict_size == 0:
            if tally is not None:
                tally_counts(tally, host_entries=0, device_entries=0, h2d_bytes=0)
            return codes
        dev = storage_device(codes)
        n_lanes = max(self._lane_count(), other._lane_count())
        if self._host_lanes is None or other._host_lanes is None:
            n_lanes = min(n_lanes, MAX_LANE_BYTES // 4)
        q_keys, q_pos, q_sent = self._search_form(n_lanes, dev)
        b_keys, b_pos, b_sent = other._search_form(n_lanes, dev)
        if tally is not None:
            tally_counts(tally, host_entries=0, device_entries=int(q_keys[0].shape[0]),
                         h2d_bytes=q_sent + b_sent)
        if b_keys[0].shape[0] == 0:  # nothing to match: present codes become absent
            return per_shard(lambda c: torch.where(c >= 0, ABSENT, c), codes)
        trans = _translate_kernel(b_keys, q_keys)
        if b_pos is not None:
            # subset slots of other -> other's full code space
            got = torch.index_select(b_pos, 0, trans.clamp(min=0))
            trans = torch.where(trans >= 0, got, -1)
        if q_pos is not None:
            # subset results back over self's full dictionary; wide
            # entries stay -1
            full = torch.full((self.dict_size,), -1, dtype=torch.int32, device=dev)
            full[q_pos.to(torch.int64)] = trans
            trans = full
        return apply_code_translation(codes, trans)

    def renumbered_to(self, other_dictionary: np.ndarray) -> torch.Tensor:
        """This column's codes in another dictionary's code space (host
        translation table + device gather); unmatched -> -1, negative
        codes pass through.  A row merge recodes both sides into their
        union this way; a join's probe translates on the device
        (:meth:`renumbered_to_col`), to the same codes."""
        if self.dictionary.size == 0:
            return self.storage
        pos = np.searchsorted(other_dictionary, self.dictionary)
        pos = np.clip(pos, 0, max(other_dictionary.size - 1, 0))
        ok = (
            other_dictionary[pos] == self.dictionary
            if other_dictionary.size
            else np.zeros(self.dictionary.size, dtype=bool)
        )
        trans = np.where(ok, pos, -1).astype(np.int32)
        codes = self.storage
        return apply_code_translation(codes, torch.from_numpy(trans).to(storage_device(codes)))


def tally_counts(tally: dict, **counts: int) -> None:
    """Add *counts* into a stage's dict.  Callers pass a tally only when
    the stage is recorded (``telemetry.live()``), so an unrecorded stage
    computes no count."""
    for k, v in counts.items():
        tally[k] = tally.get(k, 0) + v


def merge_with_fallback(primary: StringColumn, fallback: StringColumn) -> StringColumn:
    """Cell-wise merge: primary's value where present, else fallback's —
    the reference's row merge on a column-name collision
    (csvplus.go:571-583).  Both are recoded into the union dictionary."""
    if not primary.has_absent:
        return primary
    union = np.union1d(primary.dictionary, fallback.dictionary)
    p = primary.renumbered_to(union)
    f = fallback.renumbered_to(union)
    if isinstance(p, ShardedRows) or isinstance(f, ShardedRows):
        mesh = (p if isinstance(p, ShardedRows) else f).mesh
        if not isinstance(p, ShardedRows):
            p = ShardedRows(mesh, relayout(mesh, p, f.lens))
        if not isinstance(f, ShardedRows):
            f = ShardedRows(mesh, relayout(mesh, f, p.lens))
        return StringColumn(union, smap(mesh, lambda a, b: torch.where(a >= 0, a, b), p, f))
    return StringColumn(union, torch.where(p >= 0, p, f))


class DeviceTable:
    """An ordered set of equal-length columns resident on one device.

    ``row_base`` is the source row number of table row 0 (2 for a Reader
    ingest of a file with a header row, 1 for a headerless one, 0 for
    in-memory rows), meaningful while row i still IS source row i.
    """

    def __init__(
        self,
        columns: Dict[str, "StringColumn | IntColumn"],
        nrows: int,
        device: torch.device,
        row_base: int = 0,
    ):
        self.columns = columns
        self.nrows = nrows
        self.device = device
        self.row_base = row_base
        # (stream index of the first failing row, the error) of a terminal
        # Validate; fired by consumers only if streaming reaches that row
        self.deferred_error = None
        # the ingest tier that made this table from a CSV file ("streamed",
        # "native-encoded", "native-strings" or "python"; None otherwise)
        self.ingest_tier = None
        # the streamed tier's accounting: {"scan_wait": s, "place": s,
        # "chunks": n, "workers": K}; None for the other tiers
        self.ingest_seconds = None
        # the sharded streamed ingest placed this table's chunks on their
        # shards (``with_sharding`` then has nothing to do)
        self._pre_sharded = False
        # serializes the mirror-decode LRU (rows_from_mirror_many): even
        # a cache hit reorders the OrderedDict, so every access holds it
        self._mirror_lock = threading.Lock()

    @classmethod
    def from_pylists(
        cls, data: Dict[str, Sequence[str]], device: "str | torch.device"
    ) -> "DeviceTable":
        dev = resolve_device(device)
        cols = {}
        nrows = 0
        for name, values in data.items():
            cols[name] = StringColumn.from_values(values, dev)
            nrows = len(values)
        return cls(cols, nrows, dev)

    @classmethod
    def from_encoded(
        cls, data: Dict[str, object], nrows: int, device: "str | torch.device"
    ) -> "DeviceTable":
        """Build from encoded columns as the ingest tiers give them:
        ``(dictionary, codes)`` pairs and ``("int", prefix, values)``
        typed triples (numpy arrays, or tensors already on the device), or
        ready ``StringColumn``/``IntColumn`` values, which pass through."""
        from .typed import IntColumn

        dev = resolve_device(device)

        def put(arr):
            return arr if isinstance(arr, torch.Tensor) else torch.from_numpy(arr).to(dev)

        cols = {}
        for name, value in data.items():
            if isinstance(value, (StringColumn, IntColumn)):
                cols[name] = value
            elif len(value) == 3 and value[0] == "int":
                _, prefix, vals = value
                cols[name] = IntColumn(prefix, put(vals))
            else:
                dictionary, codes = value
                cols[name] = StringColumn(dictionary, put(codes))
        return cls(cols, nrows, dev)

    @classmethod
    def from_rows(cls, rows: Sequence[Row], device: "str | torch.device") -> "DeviceTable":
        """Columnarize possibly-heterogeneous rows; missing cells -> absent."""
        names: List[str] = []
        seen = set()
        for r in rows:
            for k in r:
                if k not in seen:
                    seen.add(k)
                    names.append(k)
        data = {n: [r.get(n) for r in rows] for n in names}
        t = cls.from_pylists(data, device)
        t.nrows = len(rows)
        return t

    def short_desc(self) -> str:
        return f"{self.nrows}x{len(self.columns)}[{','.join(self.columns)}]"

    @property
    def mesh(self) -> "Mesh | None":
        """The mesh this table's columns are row-sharded over, or None.
        The table's ``device`` is then the mesh's first device, as the
        reference's is ``mesh.devices.flat[0]``."""
        for col in self.columns.values():
            st = col.storage
            if isinstance(st, ShardedRows):
                return st.mesh
        return None

    @property
    def stored_len(self) -> int:
        """Rows the columns hold: above ``nrows`` when a sharded table's
        tail is padded to equal blocks."""
        if not self.columns:
            return self.nrows
        return int(next(iter(self.columns.values())).storage.shape[0])

    def shard_lens(self) -> "List[int] | None":
        """Logical rows per shard of a sharded table (its blocks without
        the tail padding), or None for an unsharded one."""
        for col in self.columns.values():
            st = col.storage
            if isinstance(st, ShardedRows):
                left, out = self.nrows, []
                for n in st.lens:
                    out.append(max(0, min(n, left)))
                    left -= out[-1]
                return out
        return None

    def sync(self) -> "DeviceTable":
        """Wait until the card has finished the work queued for this
        table's devices (a no-op on the CPU)."""
        mesh = self.mesh
        for dev in (mesh.distinct_devices if mesh is not None else [self.device]):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return self

    def with_sharding(self, mesh: Mesh) -> "DeviceTable":
        """The table row-sharded over *mesh*: every column's storage cut
        into ``ceil(n / k)``-row blocks, block i on shard i's device, the
        tail padded with ``PAD_CODE`` (codes) or ``typed.PAD_VALUE``
        (typed value lanes), which no selection ever reaches.  Blocks are
        made device to device; a block already on its shard's device is a
        view of the column, so a table on one card is not copied except
        for the padded tail block.  A deferred lane dictionary is settled
        first, so every shard's codes index the sorted lanes."""
        from .typed import PAD_VALUE

        n = self.nrows
        k = mesh.size
        b = -(-n // k)
        cols = {}
        for name, col in self.columns.items():
            col._ensure_sorted_lanes()
            st = col.storage
            if isinstance(st, ShardedRows) and st.mesh is mesh:
                cols[name] = col
                continue
            fill = int(PAD_VALUE) if col.kind == "int" else PAD_CODE
            blocks = ShardedRows(mesh, relayout(mesh, host_or_storage(st, n), [b] * k, fill))
            cols[name] = col.with_storage(blocks)
            if col.kind != "int":
                cols[name]._has_absent = col._has_absent
        out = DeviceTable(cols, n, mesh.devices[0], self.row_base)
        out.ingest_tier = self.ingest_tier
        out.ingest_seconds = self.ingest_seconds
        return out

    def shard_row_counts(self) -> "Dict[int, int]":
        """Rows held per shard (padding included), keyed by shard index
        for the first sharded column; empty when no column is sharded.
        The reference keys by ``str(device)``; a mesh here may place
        several shards on one device, so the shard index is the key."""
        for col in self.columns.values():
            st = col.storage
            if isinstance(st, ShardedRows):
                return dict(enumerate(st.lens))
        return {}

    def gather(self, sel) -> "DeviceTable":
        """The rows at *sel*: global positions (a tensor), or per-shard
        local row ids (a :class:`ShardedRows`, sharded tables)."""
        cols = {n: c.gather(sel) for n, c in self.columns.items()}
        return DeviceTable(cols, int(sel.shape[0]), self.device)

    def to_rows(self, sel: "torch.Tensor | None" = None) -> List[Row]:
        """Decode (a selection of) the table back into host Rows; absent
        cells are omitted from their row.  Typed columns decode through
        the C++ itoa, never through demotion."""
        cols = self.columns
        if sel is not None:
            # global positions; a sharded column assembles for them
            sel = torch.as_tensor(sel, dtype=torch.int64, device=self.device)
            cols = {n: c.gather(sel) for n, c in cols.items()}
            n = int(sel.shape[0])
        else:
            n = self.nrows
        decoded = {name: c.decode() for name, c in cols.items()}
        names = list(decoded)
        out = []
        for i in range(n):
            row = Row()
            for name in names:
                v = decoded[name][i]
                if v is not None:
                    row[name] = v
            out.append(row)
        return out

    def rows_from_mirror(self, lower: int, upper: int) -> List[Row]:
        """Decode the row range [lower, upper) from host mirrors of the
        columns (``codes_host`` / ``values_host``): after one download
        per column, every find is numpy work with no device call."""
        return self.rows_from_mirror_many([(lower, upper)])[0]

    # Decoded mirror blocks are cached per (lower, upper) range up to this
    # many rows; repeated probes of hot keys then skip the decode.  Read
    # per call (``CSVPLUS_MIRROR_LRU_ROWS``).
    MIRROR_LRU_ROWS_DEFAULT = 65536

    def _mirror_lru_cap(self) -> int:
        return env_int("CSVPLUS_MIRROR_LRU_ROWS", self.MIRROR_LRU_ROWS_DEFAULT)

    def rows_from_mirror_many(
        self, bounds: Sequence[Tuple[int, int]]
    ) -> List[List[Row]]:
        """Batched :meth:`rows_from_mirror`: ONE gather + decode per
        column over the union of all requested ranges, split back into
        per-range row blocks, with a bounded LRU over decoded blocks.

        Returned blocks share Row objects with the cache (and across
        duplicate ranges), as the host tier's ``rows[lower:upper]``
        slices do; every delivery path clones.  Thread-safe: the whole
        call holds ``_mirror_lock``, so concurrent callers get decodes
        equal to the serial order."""
        with self._mirror_lock:
            return self._rows_from_mirror_many_locked(bounds)

    def _rows_from_mirror_many_locked(
        self, bounds: Sequence[Tuple[int, int]]
    ) -> List[List[Row]]:
        lru = getattr(self, "_mirror_lru", None)
        if lru is None:
            lru = self._mirror_lru = OrderedDict()
            self._mirror_lru_rows = 0
        out: List[Optional[List[Row]]] = [None] * len(bounds)
        misses: Dict[Tuple[int, int], List[int]] = {}
        for i, (lo, hi) in enumerate(bounds):
            lo, hi = int(lo), int(hi)
            if hi <= lo:
                out[i] = []
                continue
            got = lru.get((lo, hi))
            if got is not None:
                lru.move_to_end((lo, hi))
                out[i] = got
            else:
                misses.setdefault((lo, hi), []).append(i)
        if misses:
            ranges = list(misses)
            starts = np.array([r[0] for r in ranges], dtype=np.int64)
            sizes = np.array([r[1] - r[0] for r in ranges], dtype=np.int64)
            # one arange re-based per range (an arange + concatenate per
            # range is pure overhead when most matches are single rows)
            offsets = np.concatenate(([0], np.cumsum(sizes)[:-1]))
            idx = np.arange(int(sizes.sum()), dtype=np.int64) + np.repeat(starts - offsets, sizes)
            decoded = {}
            for name, col in self.columns.items():
                if col.kind == "int":
                    decoded[name] = col.decode_take(idx)
                else:
                    decoded[name] = col.decode_codes(col.codes_host()[idx])
            names = list(decoded)
            off = 0
            for r in ranges:
                size = r[1] - r[0]
                block = [Row() for _ in range(size)]
                for name in names:
                    vals = decoded[name]
                    for j in range(size):
                        v = vals[off + j]
                        if v is not None:
                            block[j][name] = v
                off += size
                for i in misses[r]:
                    out[i] = block
                lru[r] = block
                self._mirror_lru_rows += size
            cap = self._mirror_lru_cap()
            while self._mirror_lru_rows > cap and len(lru) > 1:
                _, evicted = lru.popitem(last=False)
                self._mirror_lru_rows -= len(evicted)
        return out  # type: ignore[return-value]

    def iterate(self, fn) -> None:
        """Stream decoded rows (the escape hatch for opaque callbacks)."""
        from ..source import iterate

        iterate(self.to_rows(), fn)

    Iterate = iterate

    @property
    def plan(self):
        from ..plan import Scan

        return Scan(self)


def host_or_storage(st, n: int):
    """The first *n* rows of a storage array as a tensor or ShardedRows
    (dropping a sharded array's tail padding without copying)."""
    if isinstance(st, ShardedRows):
        left, shards = n, []
        for blk in st.shards:
            shards.append(blk[:max(0, min(int(blk.shape[0]), left))])
            left -= int(shards[-1].shape[0])
        return ShardedRows(st.mesh, shards)
    return st[:n]


def from_reference_arrays(
    columns: "Dict[str, tuple]",
    device: "str | torch.device",
) -> DeviceTable:
    """A :class:`DeviceTable` from numpy columns as the JAX package holds
    them, so one encoded table can feed both packages:

    * ``(dictionary, codes)`` pairs (``StringColumn.dictionary`` /
      ``codes_host()``);
    * ``("int", prefix, values)`` triples (``IntColumn.prefix`` / its
      value lanes);
    * ``("lanes", lane_arrays, codes[, sorted])`` lane-dictionary columns
      (``StringColumn.dev_dictionary`` as numpy int32 arrays, the codes,
      and whether the lanes are sorted; True when left out)."""
    from .typed import PAD_VALUE, IntColumn

    dev = resolve_device(device)

    def checked_codes(name, codes, size):
        codes = np.array(codes, dtype=np.int32)  # a writable copy
        if codes.ndim != 1:
            raise ValueError(f"column {name!r}: codes must be one-dimensional")
        if codes.size and (codes.min() < ABSENT or codes.max() >= size):
            raise ValueError(f"column {name!r}: codes out of dictionary range")
        return codes

    cols = {}
    nrows = None
    for name, value in columns.items():
        if len(value) == 3 and value[0] == "int":
            _, prefix, vals = value
            if not isinstance(prefix, bytes):
                raise ValueError(f"column {name!r}: the typed prefix must be bytes")
            vals = np.array(vals, dtype=np.int32)  # a writable copy
            if vals.ndim != 1:
                raise ValueError(f"column {name!r}: values must be one-dimensional")
            if vals.size and vals.min() == PAD_VALUE:
                raise ValueError(f"column {name!r}: INT32_MIN is not a typed value")
            n = int(vals.shape[0])
            col = IntColumn(prefix, torch.from_numpy(vals).to(dev))
        elif isinstance(value[0], str) and value[0] == "lanes":
            if len(value) not in (3, 4):
                raise ValueError(f"column {name!r}: expected ('lanes', lanes, codes[, sorted])")
            lanes = [np.array(x, dtype=np.int32) for x in value[1]]
            if len(lanes) not in (2, 4, 8) or len({x.shape for x in lanes}) != 1 \
                    or lanes[0].ndim != 1:
                raise ValueError(f"column {name!r}: 2, 4 or 8 equal one-dimensional lanes")
            sorted_ = bool(value[3]) if len(value) == 4 else True
            codes = checked_codes(name, value[2], lanes[0].shape[0])
            n = int(codes.shape[0])
            col = StringColumn(
                None, torch.from_numpy(codes).to(dev),
                dev_dictionary=tuple(torch.from_numpy(x).to(dev) for x in lanes),
                dev_dict_sorted=sorted_,
            )
        else:
            dictionary, codes = value
            dictionary = np.asarray(dictionary)
            if dictionary.dtype.kind == "U":
                dictionary = np.char.encode(dictionary, "utf-8")
            if dictionary.size > 1 and not bool(np.all(dictionary[:-1] < dictionary[1:])):
                raise ValueError(f"column {name!r}: dictionary is not sorted and unique")
            codes = checked_codes(name, codes, dictionary.size)
            n = int(codes.shape[0])
            col = StringColumn(dictionary, torch.from_numpy(codes).to(dev))
        if nrows is None:
            nrows = n
        elif n != nrows:
            raise ValueError(f"column {name!r}: {n} rows, expected {nrows}")
        cols[name] = col
    return DeviceTable(cols, nrows or 0, dev)
