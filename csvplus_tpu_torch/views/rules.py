"""The delta-rule gate: which verified plans may become live views.

Port of ``csvplus_tpu/views/rules.py``, with the same diagnostics string
for string.  A registered plan is maintained incrementally
(``view.py``): each append batch runs the plan over ONLY the new tier's
rows, each delete retracts previously emitted rows by source key.  That
algebra (the bag-semantics delta rules of arxiv 2502.06988) is sound
exactly for the ops that are **row-linear** (each output row is produced
by one input row, independently of every other input row) and
**order-preserving** (output order is input order, with per-row
expansions kept contiguous):

* ``Filter``: a row passes or not on its own; Δout = Filter(Δin).
* ``MapExpr``: per-row rewrite; Δout = Map(Δin), PROVIDED the source
  key columns survive untouched (retraction addresses output rows by
  source key, see below).
* ``SelectCols`` / ``DropCols``: per-row projection, same proviso.
* ``Join``: against a FROZEN device-indexed dimension,
  Δout = Δin ⋈ dim; the existing bounds/gather join path executes it.
* ``Except``: anti-join against a frozen index; Δout = Δin ▷ dim.

Everything else is rejected **typed at registration**
(:class:`ViewRejected`), each shape with its own diagnostic:

* ``Top`` / ``DropRows`` / ``TakeWhile`` / ``DropWhile``: positional
  or prefix-dependent; one appended row can flip the visibility of
  arbitrarily many OLD rows, so no per-tier delta exists.
* ``Validate``: raises mid-stream on the first failing row; a delta
  batch cannot reproduce the from-scratch abort position.
* a ``Lookup`` leaf: bounds are data pinned to one frozen table; the
  view's whole point is a leaf that moves.
* a plan that renames, overwrites, projects away, or otherwise fails
  to carry every SOURCE KEY COLUMN to the output: retraction keys
  output rows by the source key, so losing it breaks deletes.
* an ``"upsert"``-mode source: newest-wins appends retract rows the
  delta stream never names; the append-mode multiset algebra above
  does not cover it.
* a mutable Join/Except build side: the delta rules hold for a
  changing STREAM against frozen dimensions, not the converse.

Static verification itself is NOT re-implemented here: registration
routes the re-rooted plan through the plan cache's admission path
(``analysis.verify_plan``), so a view plan passes both gates or raises
typed at registration.
"""

from __future__ import annotations

from typing import List, Sequence

from .. import plan as P
from ..analysis import provenance as PV
from ..errors import CsvPlusError
from ..exprs import Rename, Update

__all__ = ["ViewRejected", "check_view_plan"]


class ViewRejected(CsvPlusError):
    """Plan shape has no incremental delta rule (or the source cannot
    feed one); the view was never registered."""

    def __init__(self, diagnostics: Sequence[str]):
        self.diagnostics = list(diagnostics)
        detail = "; ".join(self.diagnostics) or "(no diagnostics)"
        super().__init__(f"plan rejected for view maintenance: {detail}")


#: Chain ops with a per-tier delta rule (see the module docstring).
#: The tuple is documentation/export; the gate itself decides from the
#: provenance domain's facts (``analysis.provenance.delta_safe``, the
#: same row-linear/order-preserving/non-aborting classification,
#: defined once), so the two can never drift.
DELTA_OPS = (P.Filter, P.MapExpr, P.SelectCols, P.DropCols, P.Join, P.Except)


def _expr_diags(label: str, expr, key_columns: Sequence[str]) -> List[str]:
    """Why a Map stage's expr would break source-key survival ([] = safe).

    The column footprint (which names the expr writes or removes) comes
    from the provenance domain (:func:`~csvplus_tpu_torch.analysis.
    provenance.expr_facts`), one definition shared with the rewriter;
    only the per-shape diagnostic wording lives here."""
    keys = set(key_columns)
    if isinstance(expr, Update):
        out: List[str] = []
        for sub in expr.exprs:
            out.extend(_expr_diags(label, sub, key_columns))
        return out
    ef = PV.expr_facts(expr)
    if not ef.known:
        return [
            f"{label}: no delta rule for map expr {type(expr).__name__!r} "
            f"(known-safe: Rename/SetValue/Update off the key columns)"
        ]
    bad = keys & (ef.writes | ef.removes)
    if isinstance(expr, Rename):
        # Rename READS both sides of every pair (merge-with-fallback),
        # so a key appearing as old OR new name is touched.
        if bad:
            return [
                f"{label}: Rename touches source key column(s) "
                f"{sorted(bad)} — retraction needs them intact"
            ]
        return []
    if bad:  # SetValue (the only other known expr writes one column)
        return [
            f"{label}: SetValue overwrites source key column "
            f"{expr.column!r} — retraction needs it intact"
        ]
    return []


def check_view_plan(root: P.PlanNode, key_columns: Sequence[str],
                    mode: str = "append") -> None:
    """Raise :class:`ViewRejected` unless every stage of *root* has a
    delta rule AND the source key columns survive to the output.

    *key_columns* are the source MutableIndex's key columns; *mode* its
    visibility mode (only ``"append"`` is maintainable)."""
    diags: List[str] = []
    if mode != "append":
        diags.append(
            f"source mode {mode!r}: only append-mode sources have the "
            f"multiset delta algebra (upsert retractions are implicit)"
        )
    chain = P.linearize(root)
    leaf = chain[0]
    if not isinstance(leaf, P.Scan):
        diags.append(
            f"{P.stage_label(0, leaf)}: view plans must scan the mutable "
            f"source (Lookup leaves pin data-dependent bounds)"
        )
    for pos, node in enumerate(chain[1:], start=1):
        label = P.stage_label(pos, node)
        facts = PV.stage_facts(pos, node)
        if not PV.delta_safe(facts):
            diags.append(
                f"{label}: no incremental delta rule for "
                f"{type(node).__name__} (positional/aborting ops cannot "
                f"be maintained per-tier)"
            )
            continue
        if isinstance(node, P.MapExpr):
            diags.extend(_expr_diags(label, node.expr, key_columns))
        elif isinstance(node, P.SelectCols):
            _, missing = PV.key_clobbers(facts, key_columns)
            if missing:
                diags.append(
                    f"{label}: projects away source key column(s) "
                    f"{missing} — retraction needs them in the output"
                )
        elif isinstance(node, P.DropCols):
            dropped, _ = PV.key_clobbers(facts, key_columns)
            if dropped:
                diags.append(
                    f"{label}: drops source key column(s) {dropped} — "
                    f"retraction needs them in the output"
                )
        elif isinstance(node, (P.Join, P.Except)):
            impl = getattr(node.index, "_impl", None)
            if impl is not None and hasattr(impl, "tiers"):
                diags.append(
                    f"{label}: build side is a MutableIndex — delta "
                    f"rules cover a changing stream against FROZEN "
                    f"dimensions only"
                )
    if diags:
        raise ViewRejected(diags)
