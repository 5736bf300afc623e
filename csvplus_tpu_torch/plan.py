"""Symbolic plan IR for device execution.

Port of ``csvplus_tpu/plan.py``.  Every lazy combinator of
:mod:`csvplus_tpu_torch.source` tries to record one of these nodes; when
the argument is an opaque Python callable the plan becomes ``None`` and
the chain runs on the host streaming path, exactly as in the reference.
The device executor (:mod:`csvplus_tpu_torch.columnar.exec`) lowers the
chain; the static verifier, the provenance and cost domains and the
rewriter (:mod:`csvplus_tpu_torch.analysis`) walk it.

``MultiwayJoin`` and ``FusedProbe`` are physical operators that only the
rewriter emits (through the plan cache, :mod:`csvplus_tpu_torch.serve`).

Stage helpers return ``None`` (= not device-executable) when either the
upstream plan is ``None`` or the stage argument is not symbolic.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterator, List, Optional, Sequence, Tuple


class PlanNode:
    """Base class for plan IR nodes."""

    __slots__ = ()

    def describe(self, indent: int = 0) -> str:
        return " " * indent + repr(self)


def linearize(root: "PlanNode") -> "List[PlanNode]":
    """The plan chain in EXECUTION order: ``[Scan, stage1, ..., root]``.

    Plans are single-child chains (every combinator wraps exactly one
    upstream; Join/Except reference their build side as an *attribute*,
    not a child), so this is the one canonical traversal — shared by the
    device executor and the static verifier so they can never disagree
    about stage order.
    """
    chain: List[PlanNode] = []
    node = root
    while not isinstance(node, (Scan, Lookup)):
        chain.append(node)
        node = node.child  # type: ignore[attr-defined]
    chain.append(node)
    chain.reverse()
    return chain


def walk(root: "PlanNode") -> "Iterator[PlanNode]":
    """Yield every node of the chain in execution order."""
    yield from linearize(root)


def stage_label(pos: int, node: "PlanNode") -> str:
    """The canonical ``Type[pos]`` label for chain position *pos* —
    shared by the static verifier's diagnostics and the analysis CLI's
    JSON payload so a diagnostic's ``stage`` field always addresses the
    same :func:`linearize` slot."""
    return f"{type(node).__name__}[{pos}]"


@dataclass(frozen=True)
class Scan(PlanNode):
    """Origin: a device columnar table (or a future streaming scan)."""

    table: Any  # columnar.table.DeviceTable

    def __repr__(self) -> str:
        return f"Scan({self.table.short_desc()})"


@dataclass(frozen=True)
class Lookup(PlanNode):
    """Origin: one contiguous row range [lower, upper) of a sorted
    device index table — the leaf behind ``Index.find``/``find_many``
    results (index matches are always contiguous in key order).  A
    Scan restricted to a statically-known range; downstream symbolic
    stages lower exactly as they would over a full Scan."""

    table: Any  # columnar.table.DeviceTable (the index's sorted copy)
    lower: int
    upper: int

    def __repr__(self) -> str:
        return f"Lookup([{self.lower},{self.upper}) of {self.table.short_desc()})"


@dataclass(frozen=True)
class Filter(PlanNode):
    child: PlanNode
    pred: Any  # symbolic predicate (predicates.Like / All / Any / Not)

    def __repr__(self) -> str:
        return f"Filter({self.pred!r}) <- {self.child!r}"


@dataclass(frozen=True)
class Validate(PlanNode):
    """Symbolic per-row check: every selected row must satisfy ``pred``
    or the pipeline aborts with ``message`` at the first failing row
    (device form of csvplus.go:300-310 with a predicate instead of an
    opaque error-returning callback)."""

    child: PlanNode
    pred: Any  # symbolic predicate
    message: str

    def __repr__(self) -> str:
        return f"Validate({self.pred!r}) <- {self.child!r}"


@dataclass(frozen=True)
class MapExpr(PlanNode):
    child: PlanNode
    expr: Any  # symbolic row transform (exprs.Rename / SetValue / ...)

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
class DropRows(PlanNode):
    child: PlanNode
    n: int


@dataclass(frozen=True)
class TakeWhile(PlanNode):
    child: PlanNode
    pred: Any


@dataclass(frozen=True)
class DropWhile(PlanNode):
    child: PlanNode
    pred: Any


@dataclass(frozen=True)
class Join(PlanNode):
    child: PlanNode
    index: Any  # index.Index backed by a device table
    columns: Tuple[str, ...]


@dataclass(frozen=True)
class Except(PlanNode):
    child: PlanNode
    index: Any
    columns: Tuple[str, ...]


@dataclass(frozen=True)
class MultiwayJoin(PlanNode):
    """Fused physical operator for a run of consecutive :class:`Join`
    stages: ONE pass over the stream resolves bounds against every build
    index and emits the cross-product fanout directly — no materialized
    intermediate table between the joins.  ``joins`` holds the original
    cascade's ``(index, key columns)`` pairs in cascade order, so the
    result is bitwise-identical (row order, column order, merge
    semantics) to applying the binary joins in sequence.  Never built by
    user combinators: only the rewriter emits it, behind a cost-model
    choice and a provenance license (every later join's key columns must
    be PRESENT on the stream side, proving the cascade could not have
    errored in between)."""

    child: PlanNode
    joins: Tuple[Tuple[Any, Tuple[str, ...]], ...]

    def __repr__(self) -> str:
        keys = [list(cols) for _, cols in self.joins]
        return f"MultiwayJoin({keys}) <- {self.child!r}"


@dataclass(frozen=True)
class FusedProbe(PlanNode):
    """Fused physical operator for a licensed Filter/Map/projection run
    ending in a probe: the row-linear ``ops`` evaluate
    against the executor's lazy selection view and the join(s) then
    probe the SELECTED rows directly — the pre-join ``materialize()``
    (a full-width gather of every live column down to the selection)
    never happens, and the emit gather composes the selection into the
    probe ids instead (``take(take(S, sel), ids) == take(S, take(sel,
    ids))``, so the result is bitwise the staged chain's).

    ``ops`` is a tuple of data-only ``(kind, payload)`` pairs —
    ``("filter", pred)``, ``("map", expr)``, ``("select", columns)``,
    ``("drop", columns)`` — in original chain order; ``joins`` mirrors
    :class:`MultiwayJoin`'s ``(index, key columns)`` pairs (one pair =
    a fused binary join).  Never built by user combinators: only the
    rewriter emits it, behind the per-placement fusion pricing rule
    (``analysis/cost.py choose_fusion``) and the provenance license
    that every absorbed op is row-linear with a known footprint."""

    child: PlanNode
    ops: Tuple[Tuple[str, Any], ...]
    joins: Tuple[Tuple[Any, Tuple[str, ...]], ...]

    def __repr__(self) -> str:
        kinds = [k for k, _ in self.ops]
        keys = [list(cols) for _, cols in self.joins]
        return f"FusedProbe({kinds} -> {keys}) <- {self.child!r}"


def fused_op_node(kind: str, payload: Any) -> Optional[PlanNode]:
    """The equivalent standalone stage for one :class:`FusedProbe` op
    entry, with ``child=None`` (never traversed).  Shared by the
    provenance and verifier transfer functions so the fused stage's
    abstract semantics are BY CONSTRUCTION the composition of the
    staged ops it absorbed — the two analyses can never model an
    absorbed op differently from its standalone form.  Returns ``None``
    for an unknown kind (total barrier for the caller)."""
    if kind == "filter":
        return Filter(None, payload)
    if kind == "map":
        return MapExpr(None, payload)
    if kind == "select":
        return SelectCols(None, tuple(payload))
    if kind == "drop":
        return DropCols(None, tuple(payload))
    return None


def _is_symbolic(obj: Any) -> bool:
    """A stage argument is symbolic when it opts in via ``__plan_expr__``.

    Combinators like ``All(Like(...), some_python_fn)`` report their own
    nested symbolic-ness via a ``symbolic`` property.
    """
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


def transform_plan(child: Optional[PlanNode], trans: Any) -> Optional[PlanNode]:
    # A symbolic transform behaves like a symbolic map for planning purposes.
    if child is not None and _is_symbolic(trans):
        return MapExpr(child, trans)
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


def drop_plan(child: Optional[PlanNode], n: int) -> Optional[PlanNode]:
    return DropRows(child, n) if child is not None else None


def take_while_plan(child: Optional[PlanNode], pred: Any) -> Optional[PlanNode]:
    if child is not None and _is_symbolic(pred):
        return TakeWhile(child, pred)
    return None


def drop_while_plan(child: Optional[PlanNode], pred: Any) -> Optional[PlanNode]:
    if child is not None and _is_symbolic(pred):
        return DropWhile(child, pred)
    return None


def join_plan(
    child: Optional[PlanNode], index: Any, columns: Sequence[str]
) -> Optional[PlanNode]:
    if child is not None and getattr(index, "device_table", None) is not None:
        return Join(child, index, tuple(columns))
    return None


def except_plan(
    child: Optional[PlanNode], index: Any, columns: Sequence[str]
) -> Optional[PlanNode]:
    if child is not None and getattr(index, "device_table", None) is not None:
        return Except(child, index, tuple(columns))
    return None


def explain(plan: Optional[PlanNode]) -> str:
    """Human-readable plan description; shows where device execution breaks."""
    if plan is None:
        return "(host streaming path — no device plan)"
    return repr(plan)
