"""Symbolic plan IR for device execution.

The port's subset of ``csvplus_tpu/plan.py``: the nodes the executor
(:mod:`csvplus_tpu_torch.columnar.exec`) lowers — ``Scan``, ``Filter``,
``Validate``, ``Top``, ``SelectCols``, ``DropCols``, ``MapExpr`` and
``Join``.  Every lazy combinator of :mod:`csvplus_tpu_torch.source` tries
to record one of these nodes; when the argument is an opaque Python
callable (or the stage has no node here yet) the plan becomes ``None`` and
the chain runs on the host streaming path, exactly as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple


class PlanNode:
    """Base class for plan IR nodes."""

    __slots__ = ()


def linearize(root: "PlanNode") -> "List[PlanNode]":
    """The plan chain in execution order: ``[Scan, stage1, ..., root]``.

    Plans are single-child chains (a Join references its build side as an
    attribute, not a child)."""
    chain: List[PlanNode] = []
    node = root
    while not isinstance(node, Scan):
        chain.append(node)
        node = node.child  # type: ignore[attr-defined]
    chain.append(node)
    chain.reverse()
    return chain


@dataclass(frozen=True)
class Scan(PlanNode):
    """Origin: a device columnar table."""

    table: Any  # columnar.table.DeviceTable

    def __repr__(self) -> str:
        return f"Scan({self.table.short_desc()})"


@dataclass(frozen=True)
class Filter(PlanNode):
    child: PlanNode
    pred: Any  # symbolic predicate (predicates.Like / All / Any / Not)

    def __repr__(self) -> str:
        return f"Filter({self.pred!r}) <- {self.child!r}"


@dataclass(frozen=True)
class Validate(PlanNode):
    """Symbolic per-row check: every selected row must satisfy ``pred``
    or the pipeline aborts with ``message`` at the first failing row."""

    child: PlanNode
    pred: Any
    message: str

    def __repr__(self) -> str:
        return f"Validate({self.pred!r}) <- {self.child!r}"


@dataclass(frozen=True)
class MapExpr(PlanNode):
    child: PlanNode
    expr: Any  # symbolic row transform (exprs.Rename / SetValue / Update)

    def __repr__(self) -> str:
        return f"Map({self.expr!r}) <- {self.child!r}"


@dataclass(frozen=True)
class SelectCols(PlanNode):
    child: PlanNode
    columns: Tuple[str, ...]

    def __repr__(self) -> str:
        return f"Select({list(self.columns)}) <- {self.child!r}"


@dataclass(frozen=True)
class DropCols(PlanNode):
    child: PlanNode
    columns: Tuple[str, ...]

    def __repr__(self) -> str:
        return f"DropCols({list(self.columns)}) <- {self.child!r}"


@dataclass(frozen=True)
class Top(PlanNode):
    child: PlanNode
    n: int


@dataclass(frozen=True)
class Join(PlanNode):
    child: PlanNode
    index: Any  # index.Index backed by a device table
    columns: Tuple[str, ...]


def _is_symbolic(obj: Any) -> bool:
    """A stage argument is symbolic when it opts in via ``__plan_expr__``
    (combinators report their nested symbolic-ness via ``symbolic``)."""
    if getattr(obj, "__plan_expr__", False) is not True:
        return False
    return bool(getattr(obj, "symbolic", True))


def filter_plan(child: Optional[PlanNode], pred: Any) -> Optional[PlanNode]:
    if child is not None and _is_symbolic(pred):
        return Filter(child, pred)
    return None


def validate_plan(
    child: Optional[PlanNode], vf: Any, message: str
) -> Optional[PlanNode]:
    if child is not None and _is_symbolic(vf):
        return Validate(child, vf, message)
    return None


def map_plan(child: Optional[PlanNode], mf: Any) -> Optional[PlanNode]:
    if child is not None and _is_symbolic(mf):
        return MapExpr(child, mf)
    return None


def select_columns_plan(
    child: Optional[PlanNode], columns: Sequence[str]
) -> Optional[PlanNode]:
    return SelectCols(child, tuple(columns)) if child is not None else None


def drop_columns_plan(
    child: Optional[PlanNode], columns: Sequence[str]
) -> Optional[PlanNode]:
    return DropCols(child, tuple(columns)) if child is not None else None


def top_plan(child: Optional[PlanNode], n: int) -> Optional[PlanNode]:
    return Top(child, n) if child is not None else None


def join_plan(
    child: Optional[PlanNode], index: Any, columns: Sequence[str]
) -> Optional[PlanNode]:
    if child is not None and getattr(index, "device_table", None) is not None:
        return Join(child, index, tuple(columns))
    return None
