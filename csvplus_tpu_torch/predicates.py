"""Predicate combinator DSL: All / Any / Not / Like.

Reference: csvplus.go:1240-1293.  In the reference these return opaque Go
closures.  Here they are *callable objects* — they work anywhere a plain
``row -> bool`` function works (host path), but they are also **symbolic**
(``__plan_expr__ = True``): the device executor can introspect them and
lower the whole boolean expression to a fused vectorized kernel over
columnar data instead of calling back into Python per row.
"""

from __future__ import annotations

from typing import Callable, Mapping, Union

from .row import Row

PredLike = Union[Callable[[Row], bool], "Predicate"]


class Predicate:
    """Base class: a callable row predicate that is also a symbolic expr."""

    __plan_expr__ = True
    __slots__ = ()

    def __call__(self, row: Row) -> bool:  # pragma: no cover - abstract
        raise NotImplementedError

    # boolean-algebra sugar (not in the reference, natural in Python)
    def __and__(self, other: PredLike) -> "All":
        return All(self, other)

    def __or__(self, other: PredLike) -> "Any_":
        return Any_(self, other)

    def __invert__(self) -> "Not":
        return Not(self)


class Like(Predicate):
    """True when the input row matches every (column, value) pair of the
    match row (csvplus.go:1279-1293)."""

    __slots__ = ("match",)

    def __init__(self, match: Mapping[str, str]):
        if not match:
            raise ValueError("empty match row in Like() predicate")
        self.match = dict(match)

    def __call__(self, row: Row) -> bool:
        for key, val in self.match.items():
            if key not in row or row[key] != val:
                return False
        return True

    def __repr__(self) -> str:
        return f"Like({self.match!r})"


class All(Predicate):
    """Logical AND of the given predicates (csvplus.go:1243-1253)."""

    __slots__ = ("preds",)

    def __init__(self, *preds: PredLike):
        self.preds = tuple(preds)

    def __call__(self, row: Row) -> bool:
        return all(p(row) for p in self.preds)

    def __repr__(self) -> str:
        return f"All{self.preds!r}"

    @property
    def symbolic(self) -> bool:
        return all(getattr(p, "__plan_expr__", False) for p in self.preds)


class Any_(Predicate):
    """Logical OR of the given predicates (csvplus.go:1258-1268)."""

    __slots__ = ("preds",)

    def __init__(self, *preds: PredLike):
        self.preds = tuple(preds)

    def __call__(self, row: Row) -> bool:
        return any(p(row) for p in self.preds)

    def __repr__(self) -> str:
        return f"Any{self.preds!r}"

    @property
    def symbolic(self) -> bool:
        return all(getattr(p, "__plan_expr__", False) for p in self.preds)


class Not(Predicate):
    """Logical negation of the given predicate (csvplus.go:1271-1275)."""

    __slots__ = ("pred",)

    def __init__(self, pred: PredLike):
        self.pred = pred

    def __call__(self, row: Row) -> bool:
        return not self.pred(row)

    def __repr__(self) -> str:
        return f"Not({self.pred!r})"

    @property
    def symbolic(self) -> bool:
        return getattr(self.pred, "__plan_expr__", False)
