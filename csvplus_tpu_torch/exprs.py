"""Symbolic row-transform expressions for Map/Transform stages.

The reference's ``Map`` takes an opaque Go closure (csvplus.go:290-296,
e.g. README.md:25 renames a value in place).  Opaque callbacks cannot run
on a TPU, so common transforms get symbolic counterparts: callable objects
that work exactly like a hand-written ``row -> row`` function on the host
path, while the device executor lowers them to columnar metadata updates
or vectorized kernels (renaming a column on a columnar table is free; a
constant write is a broadcast).
"""

from __future__ import annotations

from typing import Callable, Mapping

from .row import Row


class RowExpr:
    """Base: a callable row transform that is also a symbolic expr."""

    __plan_expr__ = True
    __slots__ = ()

    def __call__(self, row: Row) -> Row:  # pragma: no cover - abstract
        raise NotImplementedError


class SetValue(RowExpr):
    """Set ``row[column] = value`` (the README.md:25 idiom: replace the
    value under an existing or new column)."""

    __slots__ = ("column", "value")

    def __init__(self, column: str, value: str):
        self.column = column
        self.value = value

    def __call__(self, row: Row) -> Row:
        row[self.column] = self.value
        return row

    def __repr__(self) -> str:
        return f"SetValue({self.column!r}, {self.value!r})"


class Rename(RowExpr):
    """Rename columns: mapping of old name -> new name."""

    __slots__ = ("mapping",)

    def __init__(self, mapping: Mapping[str, str]):
        if not mapping:
            raise ValueError("empty mapping in Rename()")
        self.mapping = dict(mapping)

    def __call__(self, row: Row) -> Row:
        for old, new in self.mapping.items():
            if old in row:
                row[new] = row.pop(old)
        return row

    def __repr__(self) -> str:
        return f"Rename({self.mapping!r})"


class Update(RowExpr):
    """Chain several symbolic transforms left to right."""

    __slots__ = ("exprs",)

    def __init__(self, *exprs: Callable[[Row], Row]):
        self.exprs = tuple(exprs)

    def __call__(self, row: Row) -> Row:
        for e in self.exprs:
            row = e(row)
        return row

    def __repr__(self) -> str:
        return f"Update{self.exprs!r}"

    @property
    def symbolic(self) -> bool:
        return all(getattr(e, "__plan_expr__", False) for e in self.exprs)
