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

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..row import Row

ABSENT = -1


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


def apply_code_translation(codes: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """``trans[codes]`` with negative codes passed through unchanged.

    Torch indexing raises on an out-of-range index where ``jnp.take``
    clips, so the codes are clamped before the gather and the negative
    ones restored after it."""
    got = torch.index_select(trans, 0, codes.clamp(min=0))
    return torch.where(codes >= 0, got, codes)


class StringColumn:
    """One dictionary-encoded string column (host dictionary, device codes)."""

    kind = "str"

    def __init__(
        self,
        dictionary: np.ndarray,
        codes: torch.Tensor,
        _has_absent: "bool | None" = None,
    ):
        self.dictionary = dictionary
        self.codes = codes
        self._has_absent = _has_absent  # lazy cache: any absent cell?
        self._str_dict: "np.ndarray | None" = None  # lazy cache: decoded dict

    @property
    def storage(self) -> torch.Tensor:
        """The row-indexed device array (the protocol shared with
        ``IntColumn``, whose storage is its value lanes)."""
        return self.codes

    def with_storage(self, codes: torch.Tensor) -> "StringColumn":
        return self.with_codes(codes)

    @property
    def dict_size(self) -> int:
        return int(self.dictionary.size)

    def find_code(self, value: str) -> int:
        """Dictionary slot of *value* or -1 (host binary search)."""
        return lookup_code(self.dictionary, value)

    @property
    def has_absent(self) -> bool:
        """True when any cell is absent (one cached scalar sync)."""
        if self._has_absent is None:
            self._has_absent = bool((self.codes == ABSENT).any())
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

    def dictionary_str(self) -> np.ndarray:
        """The dictionary as python-str values (decoded lazily, cached)."""
        if self._str_dict is None:
            d = self.dictionary
            self._str_dict = (
                np.char.decode(d, "utf-8") if d.size else np.empty(0, np.str_)
            )
        return self._str_dict

    def with_codes(self, codes: torch.Tensor) -> "StringColumn":
        """A column over *codes* with this column's dictionary and decoded
        cache; ``has_absent`` carries over only when known False (a subset
        of a fully-present column is fully present)."""
        out = StringColumn(self.dictionary, codes)
        out._str_dict = self._str_dict
        if self._has_absent is False:
            out._has_absent = False
        return out

    def gather(self, sel: torch.Tensor) -> "StringColumn":
        """New column of the selected row positions (device gather)."""
        return self.with_codes(torch.index_select(self.codes, 0, sel))

    def decode_codes(self, codes: np.ndarray) -> List[Optional[str]]:
        """Decode a host code slice; absent cells (negative codes) become None."""
        if self.dict_size == 0:
            return [None] * codes.shape[0]
        d = self.dictionary_str()
        out = d[np.clip(codes, 0, d.size - 1)].tolist()
        if (codes < 0).any():
            out = [None if c < 0 else v for c, v in zip(codes.tolist(), out)]
        return out

    def decode(self) -> List[Optional[str]]:
        """Materialize values on host; absent cells become None."""
        return self.decode_codes(self.codes.cpu().numpy())

    def renumbered_to_col(self, other) -> torch.Tensor:
        """This column's codes in *other*'s code space (the probe side of
        a join); an ``IntColumn`` *other* is demoted to its dictionary."""
        return self.renumbered_to(other.dictionary)

    def renumbered_to(self, other_dictionary: np.ndarray) -> torch.Tensor:
        """This column's codes in another dictionary's code space (host
        translation table + device gather); unmatched -> -1, negative
        codes pass through.  This is how a probe-side join key enters the
        index's key space."""
        if self.dictionary.size == 0:
            return self.codes
        pos = np.searchsorted(other_dictionary, self.dictionary)
        pos = np.clip(pos, 0, max(other_dictionary.size - 1, 0))
        ok = (
            other_dictionary[pos] == self.dictionary
            if other_dictionary.size
            else np.zeros(self.dictionary.size, dtype=bool)
        )
        trans = np.where(ok, pos, -1).astype(np.int32)
        return apply_code_translation(
            self.codes, torch.from_numpy(trans).to(self.codes.device)
        )


def merge_with_fallback(primary: StringColumn, fallback: StringColumn) -> StringColumn:
    """Cell-wise merge: primary's value where present, else fallback's —
    the reference's row merge on a column-name collision
    (csvplus.go:571-583).  Both are recoded into the union dictionary."""
    if not primary.has_absent:
        return primary
    union = np.union1d(primary.dictionary, fallback.dictionary)
    p = primary.renumbered_to(union)
    f = fallback.renumbered_to(union)
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
        # the ingest tier that made this table from a CSV file
        # ("native-encoded", "native-strings" or "python"; None otherwise)
        self.ingest_tier = None

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
        cls, data: Dict[str, tuple], nrows: int, device: "str | torch.device"
    ) -> "DeviceTable":
        """Build from encoded host columns, as the native ingest tier
        gives them: ``(dictionary, codes)`` pairs and ``("int", prefix,
        values)`` typed triples."""
        from .typed import IntColumn

        dev = resolve_device(device)
        cols = {}
        for name, value in data.items():
            if len(value) == 3 and value[0] == "int":
                _, prefix, vals = value
                cols[name] = IntColumn(prefix, torch.from_numpy(vals).to(dev))
            else:
                dictionary, codes = value
                cols[name] = StringColumn(dictionary, torch.from_numpy(codes).to(dev))
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

    def gather(self, sel: torch.Tensor) -> "DeviceTable":
        cols = {n: c.gather(sel) for n, c in self.columns.items()}
        return DeviceTable(cols, int(sel.shape[0]), self.device)

    def to_rows(self, sel: "torch.Tensor | None" = None) -> List[Row]:
        """Decode (a selection of) the table back into host Rows; absent
        cells are omitted from their row.  Typed columns decode through
        the C++ itoa, never through demotion."""
        cols = self.columns
        if sel is not None:
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

    def iterate(self, fn) -> None:
        """Stream decoded rows (the escape hatch for opaque callbacks)."""
        from ..source import iterate

        iterate(self.to_rows(), fn)

    Iterate = iterate

    @property
    def plan(self):
        from ..plan import Scan

        return Scan(self)


def from_reference_arrays(
    columns: "Dict[str, tuple]",
    device: "str | torch.device",
) -> DeviceTable:
    """A :class:`DeviceTable` from numpy columns as the JAX package holds
    them — ``(dictionary, codes)`` pairs (``StringColumn.dictionary`` /
    ``codes_host()``) and ``("int", prefix, values)`` triples
    (``IntColumn.prefix`` / its value lanes) — so one encoded table can
    feed both packages."""
    from .typed import PAD_VALUE, IntColumn

    dev = resolve_device(device)
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
        else:
            dictionary, codes = value
            dictionary = np.asarray(dictionary)
            if dictionary.dtype.kind == "U":
                dictionary = np.char.encode(dictionary, "utf-8")
            if dictionary.size > 1 and not bool(np.all(dictionary[:-1] < dictionary[1:])):
                raise ValueError(f"column {name!r}: dictionary is not sorted and unique")
            codes = np.array(codes, dtype=np.int32)  # a writable copy
            if codes.ndim != 1:
                raise ValueError(f"column {name!r}: codes must be one-dimensional")
            if codes.size and (codes.min() < ABSENT or codes.max() >= dictionary.size):
                raise ValueError(f"column {name!r}: codes out of dictionary range")
            n = int(codes.shape[0])
            col = StringColumn(dictionary, torch.from_numpy(codes).to(dev))
        if nrows is None:
            nrows = n
        elif n != nrows:
            raise ValueError(f"column {name!r}: {n} rows, expected {nrows}")
        cols[name] = col
    return DeviceTable(cols, nrows or 0, dev)
