"""The Row type: one record of a data source.

A ``Row`` is a mapping from column names to string values — columns are
addressed by name, never by position (reference: ``type Row map[string]string``
csvplus.go:59 and README.md:76-79).  It subclasses ``dict`` so that plain
dicts and Rows interoperate freely; all reference accessors (csvplus.go:61-205)
exist both under Go-style names (``HasColumn``) and Python-style names
(``has_column``).
"""

from __future__ import annotations

from typing import Iterable, List, Tuple


class MissingColumnError(KeyError):
    """A named column is absent from a row.

    Message format pinned by the reference: ``missing column %q``
    (csvplus.go:129, 144, 171).
    """

    def __init__(self, name: str):
        self.column = name
        # KeyError repr-quotes its sole arg; store formatted message instead.
        super().__init__(name)
        self._msg = f'missing column "{name}"'

    def __str__(self) -> str:  # noqa: D105
        return self._msg


class ConversionError(ValueError):
    """A cell value failed a numeric conversion.

    Message format pinned by reference tests (csvplus_test.go:932, 954):
    ``column "x": cannot convert "v" to integer: invalid syntax``.
    """


class Row(dict):
    """One line from a data source: column name -> string value."""

    __slots__ = ()

    # -- predicates / safe access (csvplus.go:61-75) ----------------------

    def has_column(self, col: str) -> bool:
        """True when the specified column is present (csvplus.go:62-65)."""
        return col in self

    def safe_get_value(self, col: str, subst: str = "") -> str:
        """Value under *col* if present, else *subst* (csvplus.go:69-75)."""
        return self.get(col, subst)

    # -- canonical forms (csvplus.go:77-104) ------------------------------

    def header(self) -> List[str]:
        """All column names, sorted (csvplus.go:78-87)."""
        return sorted(self.keys())

    def __str__(self) -> str:
        """Canonical string form (csvplus.go:90-104): sorted-key JSON-ish."""
        if not self:
            return "{}"
        parts = ", ".join(f'"{k}" : "{self[k]}"' for k in self.header())
        return "{ " + parts + " }"

    def __repr__(self) -> str:  # keep dict repr for debugging
        return f"Row({dict.__repr__(self)})"

    # -- projection (csvplus.go:106-150) ----------------------------------

    def select_existing(self, *cols: str) -> "Row":
        """New Row with only the listed columns that exist (csvplus.go:108-118)."""
        return Row({c: self[c] for c in cols if c in self})

    def select(self, *cols: str) -> "Row":
        """New Row with exactly the listed columns; raises
        :class:`MissingColumnError` if any is absent (csvplus.go:122-134)."""
        r = Row()
        for c in cols:
            try:
                r[c] = self[c]
            except KeyError:
                raise MissingColumnError(c) from None
        return r

    def select_values(self, *cols: str) -> List[str]:
        """Values of the listed columns in order; raises
        :class:`MissingColumnError` if any is absent (csvplus.go:138-150)."""
        try:
            return [self[c] for c in cols]
        except KeyError as e:
            raise MissingColumnError(e.args[0]) from None

    def clone(self) -> "Row":
        """Shallow copy (csvplus.go:153-161)."""
        return Row(self)

    # -- typed getters (csvplus.go:163-205) --------------------------------

    def value_as_int(self, column: str) -> int:
        """Value of *column* as int (csvplus.go:165-183).

        Unlike Python's ``int()``, the reference's ``strconv.Atoi`` rejects
        surrounding whitespace and underscores, and is 64-bit: values
        outside int64 are a ``value out of range`` error, not a bignum.
        """
        if column not in self:
            raise MissingColumnError(column)
        val = self[column]
        if not _GO_INT_RE.match(val):
            raise ConversionError(
                f'column "{column}": cannot convert "{val}" to integer: invalid syntax'
            )
        # avoid CPython's 4300-digit int() limit: only the significant
        # digits matter (Go parses any number of leading zeros)
        digits = val.lstrip("+-").lstrip("0")
        if len(digits) > 19:  # > int64 for sure
            v = None
        else:
            v = int(digits or "0", 10)
            if val[0] == "-":
                v = -v
        if v is not None and -(1 << 63) <= v < (1 << 63):
            return v
        raise ConversionError(
            f'column "{column}": cannot convert "{val}" to integer: value out of range'
        )

    def value_as_float(self, column: str) -> float:
        """Value of *column* as float (csvplus.go:187-205), accepting the
        full ``strconv.ParseFloat`` grammar — decimal/exponent forms,
        inf/infinity/nan spellings, hex floats, underscore separators."""
        if column not in self:
            raise MissingColumnError(column)
        val = self[column]
        res = parse_go_float(val)
        if isinstance(res, float):
            return res
        raise ConversionError(
            f'column "{column}": cannot convert "{val}" to float: {res}'
        )

    # Go-style aliases (the reference API names, csvplus.go:61-205) --------
    HasColumn = has_column
    SafeGetValue = safe_get_value
    Header = header
    SelectExisting = select_existing
    Select = select
    SelectValues = select_values
    Clone = clone
    ValueAsInt = value_as_int
    ValueAsFloat64 = value_as_float


import re as _re

# strconv.Atoi: optional sign + decimal digits only (no underscores —
# Atoi parses with an explicit base, where Go disallows separators).
_GO_INT_RE = _re.compile(r"^[+-]?[0-9]+$")
# ParseFloat specials: inf/infinity take an optional sign, nan does NOT
# (Go's special() only matches a bare "nan").
_GO_SPECIAL_RE = _re.compile(r"^(?:[+-]?(?i:inf(?:inity)?)|(?i:nan))$")
# Hex float: binary ("p") exponent REQUIRED, >=1 mantissa digit overall.
_GO_HEX_RE = _re.compile(
    r"^[+-]?0[xX](?P<i>[0-9a-fA-F]*)(?:\.(?P<f>[0-9a-fA-F]*))?[pP][+-]?[0-9]+$"
)
# Decimal: >=1 mantissa digit; exponent digits required when e present.
_GO_DEC_RE = _re.compile(r"^[+-]?(?:[0-9]+(?:\.[0-9]*)?|\.[0-9]+)(?:[eE][+-]?[0-9]+)?$")


def _underscores_ok(s: str) -> bool:
    """Go's digit-separator placement rule for numeric literals: every
    underscore sits between two digits, or between the base prefix and a
    digit (strconv's underscoreOK semantics)."""
    if s[:1] in ("+", "-"):
        s = s[1:]
    saw = "^"  # ^ start, 0 digit/base-prefix, _ underscore, ! other
    i = 0
    is_hex = False
    if len(s) >= 2 and s[0] == "0" and s[1] in "bBoOxX":
        i = 2
        saw = "0"  # the base prefix counts as a digit for separators
        is_hex = s[1] in "xX"
    while i < len(s):
        c = s[i]
        if "0" <= c <= "9" or (is_hex and c in "abcdefABCDEF"):
            saw = "0"
        elif c == "_":
            if saw != "0":
                return False
            saw = "_"
        else:
            if saw == "_":
                return False
            saw = "!"
        i += 1
    return saw != "_"


def parse_go_float(s: str):
    """``strconv.ParseFloat(s, 64)`` (Go grammar and range semantics).

    Returns the parsed float, or the Go error suffix as a plain string —
    ``"invalid syntax"`` or ``"value out of range"`` (overflow to ±Inf
    and complete underflow to 0 are range errors in Go).
    """
    if _GO_SPECIAL_RE.match(s):
        low = s.lstrip("+-").lower()
        if low == "nan":
            return float("nan")
        return float("-inf") if s[0] == "-" else float("inf")
    t = s
    if "_" in t:
        if not _underscores_ok(t):
            return "invalid syntax"
        t = t.replace("_", "")
    m = _GO_HEX_RE.match(t)
    if m:
        mantissa = (m.group("i") or "") + (m.group("f") or "")
        if not mantissa:
            return "invalid syntax"  # "0x.p1" — no mantissa digits
        try:
            v = float.fromhex(t)
        except OverflowError:
            return "value out of range"
        except ValueError:
            return "invalid syntax"
    elif _GO_DEC_RE.match(t):
        mantissa = _re.split(r"[eE]", t, maxsplit=1)[0]
        try:
            v = float(t)
        except (ValueError, OverflowError):
            return "value out of range"
    else:
        return "invalid syntax"
    if v in (float("inf"), float("-inf")):
        return "value out of range"
    if v == 0.0 and any(c in "123456789abcdefABCDEF" for c in mantissa):
        return "value out of range"
    return v


def merge_rows(left: Row, right: Row) -> Row:
    """Merged row; on column-name collision the *right* value wins.

    Reference: ``mergeRows`` csvplus.go:571-583 — Join merges
    ``(indexRow, streamRow)`` so the stream row's value survives
    (csvplus.go:560).
    """
    r = Row(left)
    r.update(right)
    return r


def equal_rows(columns: Iterable[str], r1: Row, r2: Row) -> bool:
    """True when the listed columns have equal values in both rows
    (reference: ``equalRows`` csvplus.go:759-767)."""
    return all(r1.get(c) == r2.get(c) for c in columns)


def all_columns_unique(columns: Tuple[str, ...]) -> bool:
    """True when the column list has no duplicates (csvplus.go:770-782)."""
    return len(set(columns)) == len(columns)
