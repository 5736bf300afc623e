"""Column-provenance/dependency domain over the plan IR.

Port of ``csvplus_tpu/analysis/provenance.py``.  Per plan stage it
answers: which columns does the stage READ; which does it WRITE or
REMOVE; does it keep row ORDER and MULTIPLICITY (``preserve`` /
``narrow`` / ``expand``) and is each output row produced by one input
row (``row_linear``); can it raise a PER-ROW error or abort the
pipeline (``Validate``)?

Every fact is STRUCTURAL: derived from node types and symbolic
predicate/expr shapes only, never from table data.  Two details go
beyond flat read/write sets because the executor's semantics demand
them:

* ``keeps_only`` — ``SelectCols`` removes *the complement* of its list;
* ``fallback_writes`` — ``Join`` merges with stream-wins semantics: an
  index column colliding with a stream column overwrites ONLY cells the
  stream row lacks.  A predicate over such a column may only cross the
  join when the verifier proves the stream cells PRESENT.  ``None``
  means the index schema is unknown and nothing may cross.

The rewriter (:mod:`.rewrite`) cites a proof from this domain for every
rewrite it applies and a typed :class:`ProvenanceDiagnostic` naming the
blocking stage for every refusal.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .. import plan as P
from ..exprs import Rename, SetValue, Update
from ..ops.filter import predicate_columns
from ..ops.join import device_index_static_info

__all__ = [
    "ExprFacts",
    "StageFacts",
    "ProvenanceDiagnostic",
    "delta_safe",
    "expr_facts",
    "key_clobbers",
    "stage_facts",
    "plan_facts",
    "live_columns",
    "prove_swap_before",
]

#: Multiplicity verdicts (how output row count relates to input).
PRESERVE = "preserve"
NARROW = "narrow"
EXPAND = "expand"

_EMPTY: frozenset = frozenset()


@dataclass(frozen=True)
class ExprFacts:
    """Read/write/remove footprint of one symbolic Map expr."""

    reads: frozenset
    writes: frozenset
    removes: frozenset
    known: bool  # False: unrecognized expr — assume it may touch anything


def expr_facts(expr) -> ExprFacts:
    """Column footprint of a Map/Transform expr, matching the host
    ``__call__`` semantics in :mod:`csvplus_tpu_torch.exprs` exactly:

    * ``SetValue(c, v)`` writes ``c`` (constant — reads nothing);
    * ``Rename(mapping)`` removes the old names and writes the new ones;
      it also READS both (the executor's merge-with-fallback consults an
      existing column under the new name when the moved one has absent
      cells), so renames never commute with writes to either side;
    * ``Update(*exprs)`` is the sequential union of its parts;
    * anything else is unknown: not a license to rewrite around it.
    """
    if isinstance(expr, SetValue):
        return ExprFacts(_EMPTY, frozenset((expr.column,)), _EMPTY, True)
    if isinstance(expr, Rename):
        olds = frozenset(expr.mapping)
        news = frozenset(expr.mapping.values())
        return ExprFacts(olds | news, news, olds, True)
    if isinstance(expr, Update):
        parts = [expr_facts(e) for e in expr.exprs]
        return ExprFacts(
            frozenset().union(*(p.reads for p in parts)) if parts else _EMPTY,
            frozenset().union(*(p.writes for p in parts)) if parts else _EMPTY,
            frozenset().union(*(p.removes for p in parts)) if parts else _EMPTY,
            all(p.known for p in parts),
        )
    return ExprFacts(_EMPTY, _EMPTY, _EMPTY, False)


@dataclass(frozen=True)
class StageFacts:
    """Structural provenance facts for ONE chain stage."""

    label: str
    op: str
    reads: Optional[frozenset]  # None: unknown (unlowerable pred/expr)
    writes: frozenset = _EMPTY
    removes: frozenset = _EMPTY
    #: SelectCols: only these names survive (complement is removed).
    keeps_only: Optional[frozenset] = None
    #: Join: index columns that fill ONLY absent stream cells
    #: (stream-wins merge).  None: index schema unknown.
    fallback_writes: Optional[frozenset] = _EMPTY
    row_linear: bool = True
    order_preserving: bool = True
    multiplicity: str = PRESERVE
    may_error: bool = False
    aborting: bool = False
    #: Unknown semantics: blocks every rewrite across this stage.
    barrier: bool = False

    @property
    def clobbers(self) -> frozenset:
        """Columns whose per-row values do NOT pass through unchanged
        (written or removed; ``keeps_only`` handled by callers)."""
        return self.writes | self.removes


def _pred_reads(pred) -> Optional[frozenset]:
    cols = predicate_columns(pred)
    return None if cols is None else frozenset(cols)


def stage_facts(pos: int, node: P.PlanNode) -> StageFacts:
    """Provenance facts for chain position *pos* (structural only)."""
    label = P.stage_label(pos, node)
    op = type(node).__name__
    if isinstance(node, (P.Scan, P.Lookup)):
        return StageFacts(label, op, _EMPTY)
    if isinstance(node, P.Filter):
        return StageFacts(label, op, _pred_reads(node.pred),
                          multiplicity=NARROW)
    if isinstance(node, P.Validate):
        # 1:1 passthrough, but aborts mid-stream at the first failing
        # row — no rewrite may change which rows it sees, or when.
        return StageFacts(label, op, _pred_reads(node.pred),
                          may_error=True, aborting=True)
    if isinstance(node, P.MapExpr):
        ef = expr_facts(node.expr)
        if not ef.known:
            return StageFacts(label, op, None, barrier=True)
        return StageFacts(label, op, ef.reads, writes=ef.writes,
                          removes=ef.removes)
    if isinstance(node, P.SelectCols):
        # Per-row existence check with host-parity errors: the executor
        # raises at the FIRST streamed row lacking a selected cell, so
        # the select list is read, not just projected.
        keep = frozenset(node.columns)
        return StageFacts(label, op, keep, keeps_only=keep, may_error=True)
    if isinstance(node, P.DropCols):
        # Pure dict filter, no error semantics (metadata only).
        return StageFacts(label, op, _EMPTY,
                          removes=frozenset(node.columns))
    if isinstance(node, (P.Top, P.DropRows)):
        return StageFacts(label, op, _EMPTY, row_linear=False,
                          multiplicity=NARROW)
    if isinstance(node, (P.TakeWhile, P.DropWhile)):
        # Prefix-dependent: a row's visibility depends on EARLIER rows.
        return StageFacts(label, op, _pred_reads(node.pred),
                          row_linear=False, multiplicity=NARROW)
    if isinstance(node, (P.Join, P.Except)):
        keys = frozenset(node.columns)
        if isinstance(node, P.Except):
            # Anti-join: narrows the selection, adds no columns.
            return StageFacts(label, op, keys, multiplicity=NARROW,
                              may_error=True)
        info = device_index_static_info(node.index)
        if info is None or not info[2]:
            fallback: Optional[frozenset] = None  # index schema unknown
        else:
            fallback = frozenset(info[0]) - keys
        # Key columns are NOT writes: every surviving row had its key
        # cells present (``_check_key_cells`` errors otherwise — the
        # ``may_error`` obligation makes any proof across this stage
        # demand proven key presence), and the matched values are the
        # stream's own, so key values pass through bitwise.
        return StageFacts(label, op, keys,
                          fallback_writes=fallback, multiplicity=EXPAND,
                          may_error=True)
    if isinstance(node, P.MultiwayJoin):
        # The fused operator inherits the cascade's facts dimension-wise:
        # it reads every dimension's keys, and a column may be filled
        # from ANY build side whose schema carries it as a non-key (the
        # per-dimension stream-wins merges compose left to right, so the
        # union of the per-join fallback sets is the sound fused set).
        # Key pass-through is identical to the cascade: every surviving
        # row had ALL key cells present, values bitwise the stream's own.
        keys = frozenset().union(
            *(frozenset(cols) for _idx, cols in node.joins)
        )
        fallback: Optional[frozenset] = _EMPTY
        for idx, cols in node.joins:
            info = device_index_static_info(idx)
            if info is None or not info[2]:
                fallback = None  # a build-side schema is unknown
                break
            fallback = fallback | (frozenset(info[0]) - frozenset(cols))
        return StageFacts(label, op, keys,
                          fallback_writes=fallback, multiplicity=EXPAND,
                          may_error=True)
    if isinstance(node, P.FusedProbe):
        # The fused probe pass composes its absorbed ops'
        # facts via ``fused_op_node`` — each op contributes exactly what
        # its standalone stage would, BY CONSTRUCTION — then folds the
        # probe dimensions like MultiwayJoin.  ``keeps_only`` intersects
        # the absorbed selects (sound over-approximation: the true kept
        # set is the last select's list minus later removes, a subset of
        # the intersection's complement's complement — every consumer of
        # ``keeps_only`` treats it as "at most these survive").
        reads: set = set()
        writes: set = set()
        removes: set = set()
        keeps_only: Optional[frozenset] = None
        may_error = False
        for kind, payload in node.ops:
            sub = P.fused_op_node(kind, payload)
            if sub is None:
                return StageFacts(label, op, None, row_linear=False,
                                  order_preserving=False, barrier=True)
            f = stage_facts(pos, sub)
            if f.barrier or f.reads is None:
                return StageFacts(label, op, None, row_linear=False,
                                  order_preserving=False, barrier=True)
            reads |= f.reads
            writes |= f.writes
            removes |= f.removes
            if f.keeps_only is not None:
                keeps_only = (
                    f.keeps_only if keeps_only is None
                    else keeps_only & f.keeps_only
                )
            may_error = may_error or f.may_error
        keys = frozenset().union(
            *(frozenset(cols) for _idx, cols in node.joins)
        )
        reads |= keys
        fallback: Optional[frozenset] = _EMPTY
        for idx, cols in node.joins:
            info = device_index_static_info(idx)
            if info is None or not info[2]:
                fallback = None  # a build-side schema is unknown
                break
            fallback = fallback | (frozenset(info[0]) - frozenset(cols))
        return StageFacts(label, op, frozenset(reads),
                          writes=frozenset(writes),
                          removes=frozenset(removes),
                          keeps_only=keeps_only,
                          fallback_writes=fallback, multiplicity=EXPAND,
                          may_error=True)
    # Unknown node type: total barrier — and no row-linearity claim.
    return StageFacts(label, op, None, row_linear=False,
                      order_preserving=False, barrier=True)


def plan_facts(root: P.PlanNode) -> List[StageFacts]:
    """Facts for every :func:`~csvplus_tpu_torch.plan.linearize` slot of *root*."""
    return [stage_facts(i, n) for i, n in enumerate(P.linearize(root))]


# ---------------------------------------------------------------------------
# Delta-rule facts (consumed by views/rules.py)


def delta_safe(facts: StageFacts) -> bool:
    """Does the stage admit a per-tier delta rule?  Exactly the
    row-linear + order-preserving + non-aborting ops of the bag algebra
    (``views/rules.py``'s module docstring): ``Filter``/``MapExpr``/
    ``SelectCols``/``DropCols``/``Join``/``Except`` qualify; positional
    windows and ``Validate`` do not.  (A Map with an unknown expr still
    returns True here: the delta gate rejects it at the key-survival
    level with its own diagnostic.)"""
    return facts.row_linear and not facts.aborting


def key_clobbers(facts: StageFacts,
                 key_columns: Sequence[str]) -> Tuple[List[str], List[str]]:
    """Which source key columns this stage fails to carry through:
    ``(clobbered_by_write_or_remove, projected_away)``.  Join's
    ``fallback_writes``/key writes do not count: the matched key VALUES
    are the stream's own, so retraction by key still addresses the same
    rows."""
    keys = list(key_columns)
    if facts.op in ("Join", "Except", "MultiwayJoin"):
        return ([], [])
    clobbered = [k for k in keys if k in facts.clobbers]
    projected = []
    if facts.keeps_only is not None:
        projected = [k for k in keys
                     if k not in facts.keeps_only and k not in clobbered]
    return (clobbered, projected)


# ---------------------------------------------------------------------------
# Rewrite proofs


@dataclass(frozen=True)
class ProvenanceDiagnostic:
    """A typed refusal: why a rewrite is NOT provenance-proven, naming
    the blocking stage by its canonical ``Type[pos]`` label."""

    rule: str  # e.g. "predicate-pushdown"
    stage: str  # blocking stage label
    message: str

    def __str__(self) -> str:
        return f"{self.rule}: blocked by {self.stage}: {self.message}"


def _present(presence_ok, cols) -> bool:
    """True when *presence_ok* proves every column in *cols* PRESENT at
    the relevant position; ``presence_ok`` is a callable injected by the
    rewriter (closed over the verifier's abstract states)."""
    return all(presence_ok(c) for c in cols)


def prove_swap_before(
    rule: str,
    mover: StageFacts,
    below: StageFacts,
    presence_below_in,
) -> Optional[ProvenanceDiagnostic]:
    """Prove that a row-NARROWING stage *mover* (Filter or Except) may
    move from directly after *below* to directly before it, bitwise.

    *presence_below_in(col)* must return True only when the verifier
    proves *col* PRESENT in every row entering *below* — the input the
    mover would run over after the swap.

    The proof obligations, each tied to executor semantics
    (``columnar/exec.py`` / ``ops/join.py``):

    * *below* has known semantics and is row-linear + order-preserving
      (positional windows change meaning if the row set changes first;
      Validate's abort position is observable);
    * the mover's read columns are not written/removed/projected by
      *below* — their per-row values are identical on either side;
    * read columns in *below*'s ``fallback_writes`` (Join stream-wins
      merge) additionally need PRESENT stream cells, else the join
      would have filled them from the index after the mover ran;
    * *below*'s own per-row error, if any, must be impossible
      (its read columns PRESENT): narrowing first could skip the row
      that errored, changing observable behavior;
    * if the mover itself checks key cells (Except), those must be
      PRESENT at the swapped position: rows *below* would have
      removed/never-produced could otherwise trip the check.
    """

    def blocked(msg: str) -> ProvenanceDiagnostic:
        return ProvenanceDiagnostic(rule, below.label, msg)

    if below.barrier:
        return blocked(f"{below.op} has unknown semantics")
    if not below.row_linear or not below.order_preserving:
        return blocked(
            f"{below.op} is positional/prefix-dependent — narrowing the "
            f"row set first changes which rows it keeps")
    if below.aborting:
        return blocked(
            f"{below.op} aborts at the first failing row — narrowing "
            f"first can move or suppress the abort")
    if mover.reads is None:
        return ProvenanceDiagnostic(
            rule, mover.label,
            f"{mover.op} reads an unlowerable predicate — its column "
            f"footprint is unknown")
    hit = mover.reads & below.clobbers
    if hit:
        return blocked(
            f"{below.op} writes/removes {sorted(hit)} which the "
            f"{mover.op} predicate reads")
    if below.keeps_only is not None:
        outside = mover.reads - below.keeps_only
        if outside:
            return blocked(
                f"{below.op} projects away {sorted(outside)} which the "
                f"{mover.op} predicate reads")
    if below.fallback_writes is None:
        return blocked(f"{below.op} build-side schema is unknown")
    shadow = mover.reads & below.fallback_writes
    if shadow and not _present(presence_below_in, shadow):
        return blocked(
            f"{below.op} may fill absent cells of {sorted(shadow)} from "
            f"its build side (stream-wins merge); stream presence is "
            f"not proven")
    if below.may_error and below.reads is not None:
        if not _present(presence_below_in, below.reads):
            return blocked(
                f"{below.op} raises per-row errors on missing "
                f"{sorted(below.reads)} cells; presence is not proven, "
                f"so narrowing first could suppress or reorder the error")
    if mover.may_error and mover.reads:
        if not _present(presence_below_in, mover.reads):
            return ProvenanceDiagnostic(
                rule, mover.label,
                f"{mover.op} checks {sorted(mover.reads)} cells per row; "
                f"presence at the earlier position is not proven")
    return None


def live_columns(facts: Sequence[StageFacts],
                 final_schema: Sequence[str]) -> Optional[frozenset]:
    """The set of leaf columns that can influence execution or output:
    every column any stage reads or writes, plus the final output
    schema.  A leaf column OUTSIDE this set is dead — no stage's
    behavior (including per-row error checks, which only consult read
    columns) or result can depend on it, so dropping it at the Scan is
    bitwise-invisible.  Written columns are kept too: overwriting an
    existing column preserves its schema position, while recreating a
    dropped one appends at the end.  Returns ``None`` when any stage
    has an unknown footprint (no liveness claim is sound)."""
    live = set(final_schema)
    for f in facts:
        if f.barrier or f.reads is None:
            return None
        live |= f.reads | f.writes
        if f.fallback_writes is None and f.op in (
            "Join", "MultiwayJoin", "FusedProbe"
        ):
            return None
    return frozenset(live)
