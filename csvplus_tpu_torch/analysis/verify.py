"""Static verifier for the symbolic plan IR.

Port of ``csvplus_tpu/analysis/verify.py``: the same rules, the same
diagnostics (rule, severity, stage, message).  It walks a plan chain
(:mod:`csvplus_tpu_torch.plan`) BEFORE device lowering and checks, per
node, against the abstract domain in :mod:`.schema`:

* **resolution** — every column named by ``SelectCols``, predicate
  stages and ``Join``/``Except`` keys resolves in the inferred schema,
  with the host path's per-streamed-row semantics: a missing name over
  a statically empty relation is not an error, over a provably nonempty
  relation it is a deterministic runtime error, and in between a
  data-dependent risk.  The verifier never turns a host-runtime error
  into a static rejection; it makes the outcome known before lowering.
* **lane-flow** — dictionary-code vs typed-int32 lanes through every
  operator (a rename-merge of a typed lane onto a dictionary column, a
  typed stream key probing a packed dictionary index).
* **empty-relation** — every operator at the ``nrows == 0`` lattice
  point against an explicit :class:`ExecutorModel` of the executor's
  empty-input guarantees.
* **placement-flow** — per-column placement (host / device) through
  every operator, and the cross-placement hazards the reference
  predicts (a host-placed stream probing a device index, a host stage
  sandwiched between device stages).
* **divergence-risk** — plan shapes outside the reference's random
  differential coverage, as info.

Verdict contract: no ``error``/``warn`` diagnostics => host and device
both succeed; ``predicts_empty`` => both produce zero rows; a host-side
runtime column error => a ``resolution`` diagnostic exists.

``verify_before_lower`` is the executor hook: unlowerable plans raise
:class:`~csvplus_tpu_torch.columnar.exec.UnsupportedPlan` up front (the
fallback the executor would take mid-plan, minus the wasted device
work).  ``CSVPLUS_VERIFY=0`` disables the hook.  Every verified plan
and each of its diagnostics is counted in the telemetry counters
(``verify.plans``, ``verify.<rule>.<severity>``) while collecting.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Tuple

from .. import plan as P
from ..exprs import Rename, SetValue, Update
from ..predicates import All, Any_, Like, Not
from ..utils.env import env_flag
from .schema import (
    PLACE_UNKNOWN,
    Card,
    ColInfo,
    NodeState,
    Presence,
    demoted,
    placeholder_col,
    scan_state,
)

__all__ = [
    "Diagnostic",
    "ExecutorModel",
    "EXECUTOR_MODEL",
    "PlanReport",
    "verify_plan",
    "verify_before_lower",
]


# The reference's random differential generator's coverage envelope
# (its ``stages()``): anything outside it gets a divergence-risk note.
# Kept as the reference's, so both packages give the same diagnostics.
DIFF_COVERED_STAGES = frozenset(
    [
        "Filter",
        "SelectCols",
        "DropCols",
        "Top",
        "DropRows",
        "MapExpr",
        "TakeWhile",
        "DropWhile",
        "Join",
        "Except",
        "Validate",
    ]
)
DIFF_MAX_STAGES = 4


@dataclass(frozen=True)
class ExecutorModel:
    """The empty-input guarantees the device executor is modelled to
    uphold; each flag names a concrete code location.  Flipping a flag
    off models an executor without that guarantee — the verifier then
    reports the hazard as an ``empty-relation`` (or placement) finding.
    """

    # columnar/exec.py _sel_mask: an empty selection short-circuits to an
    # empty mask instead of gathering row 0 of a 0-length column.
    empty_selection_masks: bool = True
    # ops/join.py join_tables: nrows == 0 stream returns an empty result
    # before any key validation (csvplus.go:553-556 parity).
    join_empty_total: bool = True
    # ops/join.py except_mask reached through a 0-row key view is total.
    except_empty_total: bool = True
    # The reference's partitioned all_to_all tier answers on the mesh;
    # kept so the model (and its diagnostics) stay the reference's.
    partitioned_probe_device_resident: bool = True
    # Below the partition threshold the build side replicates onto the
    # probe mesh with no host hop (the reference's broadcast tier).
    broadcast_replication_on_device: bool = True


EXECUTOR_MODEL = ExecutorModel()


@dataclass(frozen=True)
class Diagnostic:
    rule: str  # "resolution" | "lane-flow" | "placement-flow" | "empty-relation" | "divergence-risk" | "unlowerable"
    severity: str  # "error" | "warn" | "info"
    stage: str  # e.g. "Filter[2]" — node type + 0-based chain position
    message: str

    def __str__(self) -> str:
        return f"[{self.severity}] {self.rule} @ {self.stage}: {self.message}"


class _Truth(enum.Enum):
    FALSE = 0
    TRUE = 1
    UNKNOWN = 2


def _pred_truth(pred, state: NodeState) -> _Truth:
    """Constant-fold a DSL predicate against the abstract schema.

    The only static facts are structural: ``Like`` over an ABSENT column
    is constant-false for every row (host semantics: a row without the
    key never matches, csvplus.go:1284-1292).  Everything else is
    data-dependent and stays UNKNOWN.
    """
    if isinstance(pred, Like):
        if any(state.presence(c) is Presence.ABSENT for c in pred.match):
            return _Truth.FALSE
        return _Truth.UNKNOWN
    if isinstance(pred, All):
        vals = [_pred_truth(p, state) for p in pred.preds]
        if _Truth.FALSE in vals:
            return _Truth.FALSE
        return _Truth.TRUE if all(v is _Truth.TRUE for v in vals) else _Truth.UNKNOWN
    if isinstance(pred, Any_):
        vals = [_pred_truth(p, state) for p in pred.preds]
        if _Truth.TRUE in vals:
            return _Truth.TRUE
        return _Truth.FALSE if vals and all(v is _Truth.FALSE for v in vals) else _Truth.UNKNOWN
    if isinstance(pred, Not):
        v = _pred_truth(pred.pred, state)
        if v is _Truth.FALSE:
            return _Truth.TRUE
        if v is _Truth.TRUE:
            return _Truth.FALSE
    return _Truth.UNKNOWN


@dataclass
class PlanReport:
    """Everything the verifier derived from one plan."""

    diagnostics: List[Diagnostic] = field(default_factory=list)
    # abstract state AFTER each chain node, aligned with plan.linearize
    states: List[NodeState] = field(default_factory=list)

    @property
    def final(self) -> NodeState:
        return self.states[-1]

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "error"]

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "warn"]

    def by_rule(self, rule: str) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.rule == rule]

    @property
    def predicts_empty(self) -> bool:
        """True when the verifier proves the plan yields zero rows on
        the success path AND no deterministic/ data-dependent error was
        flagged — i.e. host and device must both return exactly []."""
        return self.final.card is Card.EMPTY and not self.errors and not self.warnings

    @property
    def ok(self) -> bool:
        return not self.errors

    def describe(self) -> str:
        if not self.diagnostics:
            return "(plan verifies clean)"
        return "\n".join(str(d) for d in self.diagnostics)


class _Verifier:
    def __init__(self, model: ExecutorModel):
        self.model = model
        self.report = PlanReport()
        self._stage_label = "Scan[0]"

    def diag(self, rule: str, severity: str, message: str) -> None:
        self.report.diagnostics.append(
            Diagnostic(rule, severity, self._stage_label, message)
        )

    # ---- per-rule helpers -------------------------------------------

    def _resolve_required(self, state: NodeState, name: str, what: str) -> None:
        """Resolution rule for a column the host path demands per
        streamed row (SelectCols / Join / Except keys)."""
        presence = state.presence(name)
        if presence is Presence.ABSENT:
            if state.card is Card.NONEMPTY:
                self.diag(
                    "resolution",
                    "warn",
                    f'{what} of missing column "{name}" over a provably nonempty '
                    "relation — deterministic runtime error on host and device",
                )
            elif state.card is Card.MAYBE_EMPTY:
                self.diag(
                    "resolution",
                    "warn",
                    f'{what} of column "{name}" absent from the schema — errors '
                    "on the first streamed row if any row survives upstream",
                )
            else:
                self.diag(
                    "resolution",
                    "info",
                    f'{what} of missing column "{name}" over a statically empty '
                    "relation normalizes to an empty result (placeholder column)",
                )
        elif presence is Presence.MAYBE:
            self.diag(
                "resolution",
                "info",
                f'{what} of column "{name}" with possibly-absent cells — '
                "data-dependent per-row error",
            )

    def _check_pred(self, state: NodeState, pred, what: str) -> Optional[List[str]]:
        """Shared predicate checks; returns referenced columns or None
        when the predicate is unlowerable."""
        from ..ops.filter import predicate_columns

        cols = predicate_columns(pred)
        if cols is None:
            self.diag(
                "unlowerable",
                "error",
                f"{what} predicate {pred!r} cannot be lowered to a device mask",
            )
            return None
        for c in cols:
            info = state.schema.get(c)
            if info is None:
                # host semantics: Like over a missing column is False —
                # legal, and often the source of a statically empty branch
                self.diag(
                    "resolution",
                    "info",
                    f'{what} references column "{c}" absent from the schema '
                    "(constant-false Like term — host semantics)",
                )
            else:
                if info.placeholder:
                    self._check_empty_gather(state, c, what)
                # typed int32 lanes under predicates are inside the random
                # differential envelope of the reference — no divergence
                # note
        return cols

    def _check_empty_gather(self, state: NodeState, name: str, what: str) -> None:
        """Empty-relation rule: a predicate gather over a placeholder
        column is only defined when the executor short-circuits empty
        selections."""
        if self.model.empty_selection_masks:
            self.diag(
                "empty-relation",
                "info",
                f'{what} over placeholder column "{name}" at the nrows==0 '
                "lattice point — normalized by the executor's empty-selection "
                "short-circuit (_sel_mask)",
            )
        else:
            self.diag(
                "empty-relation",
                "error",
                f'{what} over 0-length placeholder column "{name}" with an '
                "empty selection: the narrow-selection pad gathers row 0 from "
                "an empty axis (device crash; host returns no rows)",
            )

    # ---- transfer functions -----------------------------------------

    def transfer(self, node: P.PlanNode, state: NodeState, is_last: bool) -> NodeState:
        if isinstance(node, P.Filter):
            cols = self._check_pred(state, node.pred, "Filter")
            if cols is None:
                return state.with_card(state.card.narrowed())
            t = _pred_truth(node.pred, state)
            if t is _Truth.FALSE:
                return state.with_card(Card.EMPTY)
            if t is _Truth.TRUE:
                return state
            return state.with_card(state.card.narrowed())

        if isinstance(node, P.Validate):
            if not is_last:
                self.diag(
                    "unlowerable",
                    "error",
                    "Validate is device-lowered only as the last stage "
                    "(host push semantics upstream of other stages)",
                )
            self._check_pred(state, node.pred, "Validate")
            # unless the predicate is statically TRUE (or no row can
            # reach it), a clean report does NOT imply the run succeeds:
            # validation aborts are data-dependent by design
            if (
                state.card is not Card.EMPTY
                and _pred_truth(node.pred, state) is not _Truth.TRUE
            ):
                self.diag(
                    "data-dependent",
                    "info",
                    "Validate may abort the pipeline on any failing row "
                    "(identical error on both executors)",
                )
            return state

        if isinstance(node, (P.TakeWhile, P.DropWhile)):
            kind = type(node).__name__
            self._check_pred(state, node.pred, kind)
            t = _pred_truth(node.pred, state)
            if isinstance(node, P.TakeWhile):
                if t is _Truth.FALSE:  # cut at row 0
                    return state.with_card(Card.EMPTY)
                if t is _Truth.TRUE:
                    return state
            else:
                if t is _Truth.TRUE:  # drops every row
                    return state.with_card(Card.EMPTY)
                if t is _Truth.FALSE:
                    return state
            return state.with_card(state.card.narrowed())

        if isinstance(node, P.Top):
            if node.n <= 0:
                return state.with_card(Card.EMPTY)
            return state  # top(n>=1) preserves NONEMPTY

        if isinstance(node, P.DropRows):
            if node.n <= 0:
                return state
            return state.with_card(state.card.narrowed())

        if isinstance(node, P.SelectCols):
            for c in node.columns:
                self._resolve_required(state, c, "select_columns")
            out: Dict[str, ColInfo] = {}
            card = state.card
            for c in node.columns:
                info = state.schema.get(c)
                if info is None:
                    out[c] = placeholder_col()
                    # the success path of select-of-missing is the empty
                    # relation (per-row error otherwise)
                    card = Card.EMPTY
                else:
                    # success implies every streamed row had the cell
                    out[c] = replace(info, presence=Presence.PRESENT)
            return NodeState(out, card)

        if isinstance(node, P.DropCols):
            out = {
                n: i for n, i in state.schema.items() if n not in set(node.columns)
            }
            return NodeState(out, state.card)

        if isinstance(node, P.MapExpr):
            return self._transfer_map(node.expr, state)

        if isinstance(node, P.Join):
            return self._transfer_join(node, state)

        if isinstance(node, P.MultiwayJoin):
            return self._transfer_multiway(node, state)

        if isinstance(node, P.FusedProbe):
            return self._transfer_fused(node, state)

        if isinstance(node, P.Except):
            return self._transfer_except(node, state)

        self.diag(
            "unlowerable",
            "error",
            f"no device lowering for {type(node).__name__}",
        )
        return state

    def _transfer_map(self, expr, state: NodeState) -> NodeState:
        if isinstance(expr, Update):
            for e in expr.exprs:
                state = self._transfer_map(e, state)
            return state
        if isinstance(expr, SetValue):
            out = dict(state.schema)
            prev = out.get(expr.column)
            if prev is not None and prev.lane == "int":
                self.diag(
                    "lane-flow",
                    "info",
                    f'SetValue replaces typed int32 lane "{expr.column}" with a '
                    "dictionary constant column",
                )
            # the constant column materializes on the stream's layout
            out[expr.column] = ColInfo(
                "str", Presence.PRESENT, placement=state.row_placement()
            )
            return NodeState(out, state.card)
        if isinstance(expr, Rename):
            out = dict(state.schema)
            for old, new in expr.mapping.items():
                if old not in out:
                    continue  # host: row-level no-op when the cell is absent
                moved = out.pop(old)
                existing = out.pop(new, None)
                if existing is not None and moved.presence is not Presence.PRESENT:
                    # exec merges with fallback only when the moved column
                    # can have absent cells; mixed lanes demote to codes
                    if moved.lane != existing.lane:
                        self.diag(
                            "lane-flow",
                            "warn",
                            f'rename "{old}"->"{new}" merges a {moved.lane} lane '
                            f"onto a {existing.lane} lane — demotion to "
                            "dictionary codes at lowering",
                        )
                        moved = demoted(moved)
                    if (
                        moved.placement.known
                        and existing.placement.known
                        and moved.placement != existing.placement
                    ):
                        self.diag(
                            "placement-flow",
                            "warn",
                            f'rename "{old}"->"{new}" merges a '
                            f"{moved.placement!r}-placed column onto a "
                            f"{existing.placement!r}-placed column — the "
                            "fallback merge implies a transfer to one layout",
                        )
                out[new] = moved
            return NodeState(out, state.card)
        self.diag(
            "unlowerable", "error", f"cannot lower map expression {expr!r} to device"
        )
        return state

    def _index_info(
        self, index, kind: str
    ) -> "Optional[Tuple[Dict[str, str], Tuple[str, ...], bool, Optional[dict]]]":
        from ..ops.join import device_index_static_info

        info = device_index_static_info(index)
        if info is None or not info[2]:
            self.diag(
                "unlowerable",
                "error",
                f"{kind} build side has no packed device index",
            )
            return None
        return info

    def _check_placement_probe(
        self, state: NodeState, meta: "Optional[dict]", what: str
    ) -> None:
        """placement-flow rule for a probe (Join/Except) stage: compare
        where the stream rows live against where the build side's packed
        keys live and predict the executor's tier choice."""
        if meta is None:
            return
        stream = state.row_placement()
        idx_place = meta.get("placement", PLACE_UNKNOWN)
        if not stream.known or not idx_place.known:
            return
        if stream.is_sharded and not idx_place.is_sharded:
            from ..parallel.pjoin import partition_tier_selected

            n_keys = meta.get("packed_keys")
            min_keys = meta.get("partition_min_keys") or 0
            if n_keys is not None and partition_tier_selected(
                n_keys, stream_sharded=True, min_keys=min_keys
            ):
                if self.model.partitioned_probe_device_resident:
                    self.diag(
                        "placement-flow",
                        "warn",
                        f"sharded stream probes a {idx_place.kind}-placed "
                        f"{what} index of {n_keys} keys — the partitioned "
                        "tier implies a full all_to_all reshard of the "
                        "probe keys",
                    )
                else:
                    self.diag(
                        "placement-flow",
                        "warn",
                        f"sharded stream probes a {idx_place.kind}-placed "
                        f"{what} index of {n_keys} keys — modelled "
                        "partitioned tier syncs answers through host "
                        "(full gather)",
                    )
            elif self.model.broadcast_replication_on_device:
                self.diag(
                    "placement-flow",
                    "info",
                    f"sharded stream probes a {idx_place.kind}-placed "
                    f"{what} index — build side replicates onto the probe "
                    "mesh (benign broadcast, no host hop)",
                )
            else:
                self.diag(
                    "placement-flow",
                    "warn",
                    f"sharded stream probes a {idx_place.kind}-placed "
                    f"{what} index — modelled broadcast tier gathers the "
                    "probe keys to one device",
                )
        elif stream.kind == "host" and idx_place.on_device:
            self.diag(
                "placement-flow",
                "warn",
                f"host-placed stream probes a {idx_place!r} {what} index — "
                "implied full upload of the probe keys at lowering",
            )
        elif stream.on_device and idx_place.kind == "host":
            self.diag(
                "placement-flow",
                "warn",
                f"{stream!r} stream probes a host-placed {what} index — "
                "implied full gather of the probe keys at lowering",
            )
        elif stream.kind == "device" and idx_place.is_sharded:
            self.diag(
                "placement-flow",
                "info",
                f"single-device stream probes a {idx_place!r} {what} index "
                "— answers replicate back to the stream device (benign)",
            )

    def _check_keys(
        self, columns, state: NodeState, what: str, index_kinds
    ) -> None:
        for c in columns:
            self._resolve_required(state, c, f"{what} key")
            info = state.schema.get(c)
            if info is not None:
                if info.placeholder:
                    self.diag(
                        "divergence-risk",
                        "info",
                        f'placeholder column "{c}" flows into a {what} key — '
                        "no differential coverage for this shape",
                    )
                if info.lane == "int" and index_kinds is not None:
                    # packed index keys are dictionary-coded by build
                    # (DeviceIndex.build demands code order == value order)
                    self.diag(
                        "lane-flow",
                        "warn",
                        f'typed int32 stream key "{c}" probes a packed '
                        f"dictionary {what} index — demotion (or host "
                        "fallback) at lowering",
                    )

    def _join_schema_step(
        self, index, columns, state: NodeState, what: str
    ) -> NodeState:
        """One build side's full join transfer: key resolution, probe
        placement, empty-stream model check, and the output schema.  The
        unit ``Join`` applies once and ``MultiwayJoin`` folds per
        dimension IN SPEC ORDER — the fused operator's abstract
        semantics are exactly the cascade's (same card lattice walk,
        same presence/lane/placement outcomes), which is what makes the
        rewriter's verdict-equivalence re-check hold by construction."""
        info = self._index_info(index, what)
        index_kinds = info[0] if info is not None else None
        self._check_keys(columns, state, what, index_kinds)
        self._check_placement_probe(
            state, info[3] if info is not None else None, what
        )
        if not self.model.join_empty_total and state.card.may_be_empty:
            self.diag(
                "empty-relation",
                "error",
                f"{what} over a possibly-empty stream requires the executor's "
                "nrows==0 early-out (join_tables)",
            )
        # the joined relation materializes on the STREAM's layout (the
        # build side replicates or answers through the partitioned
        # shuffle; either way output columns follow the probe rows)
        stream_place = state.row_placement()
        out: Dict[str, ColInfo] = {}
        if index_kinds is not None:
            for n, kind in index_kinds.items():
                out[n] = ColInfo(kind, Presence.MAYBE, placement=stream_place)
        for n, i in state.schema.items():
            if n in out and out[n].lane != i.lane:
                # stream-wins merge across lanes settles on codes
                out[n] = ColInfo("str", Presence.MAYBE, placement=stream_place)
            else:
                out[n] = replace(i, presence=Presence.MAYBE)
        for c in columns:
            if c in out:
                out[c] = replace(out[c], presence=Presence.PRESENT)
        card = Card.EMPTY if state.card is Card.EMPTY else Card.MAYBE_EMPTY
        return NodeState(out, card)

    def _transfer_join(self, node: P.Join, state: NodeState) -> NodeState:
        return self._join_schema_step(node.index, node.columns, state, "join")

    def _transfer_multiway(
        self, node: P.MultiwayJoin, state: NodeState
    ) -> NodeState:
        for index, columns in node.joins:
            state = self._join_schema_step(index, columns, state, "join")
        return state

    def _transfer_fused(
        self, node: P.FusedProbe, state: NodeState
    ) -> NodeState:
        """The fused probe pass folds its absorbed ops'
        transfers via ``fused_op_node`` — each op's abstract step IS its
        standalone stage's, BY CONSTRUCTION — then the join schema step
        per dimension like MultiwayJoin.  The rewriter's verdict
        re-check therefore holds structurally: fusing a licensed run
        folds exactly the transfers the staged chain folded, in the
        same order (diagnostics attribute to the FusedProbe's label)."""
        for kind, payload in node.ops:
            sub = P.fused_op_node(kind, payload)
            if sub is None:
                self.diag(
                    "unlowerable",
                    "error",
                    f"no device lowering for fused op {kind!r}",
                )
                continue
            state = self.transfer(sub, state, is_last=False)
        for index, columns in node.joins:
            state = self._join_schema_step(index, columns, state, "join")
        return state

    def _transfer_except(self, node: P.Except, state: NodeState) -> NodeState:
        info = self._index_info(node.index, "except")
        index_kinds = info[0] if info is not None else None
        self._check_keys(node.columns, state, "except", index_kinds)
        self._check_placement_probe(
            state, info[3] if info is not None else None, "except"
        )
        if not self.model.except_empty_total and state.card.may_be_empty:
            self.diag(
                "empty-relation",
                "error",
                "except over a possibly-empty stream requires a total "
                "empty-input anti-join mask (except_mask)",
            )
        return state.with_card(state.card.narrowed())

    # ---- the walk over the chain ---------------------------------------

    def run(self, root: P.PlanNode) -> PlanReport:
        chain = P.linearize(root)
        scan = chain[0]
        assert isinstance(scan, (P.Scan, P.Lookup))
        state = scan_state(scan.table)
        if isinstance(scan, P.Lookup):
            # the leaf is a statically-known [lower, upper) row range of
            # the index table: its cardinality is exact, not the table's
            state = state.with_card(
                Card.NONEMPTY if scan.upper > scan.lower else Card.EMPTY
            )
        self.report.states.append(state)
        n_stages = len(chain) - 1
        for pos, node in enumerate(chain[1:], start=1):
            self._stage_label = P.stage_label(pos, node)
            state = self.transfer(node, state, is_last=pos == n_stages)
            self.report.states.append(state)
        self._host_sandwich(chain)
        self._divergence_risk(chain)
        self._publish_counters()
        return self.report

    def _host_sandwich(self, chain: List[P.PlanNode]) -> None:
        """placement-flow rule: a host-placed stage output between two
        device-placed ones means the lowered pipeline would gather off
        the device mid-chain and re-upload — the one placement shape
        that costs TWO transfers instead of zero."""
        places = [s.row_placement() for s in self.report.states]
        on_dev = [p.on_device for p in places]
        for i in range(1, len(places) - 1):
            if places[i].kind != "host":
                continue
            if any(on_dev[:i]) and any(on_dev[i + 1 :]):
                self._stage_label = P.stage_label(i, chain[i])
                self.diag(
                    "placement-flow",
                    "warn",
                    "host-placed stage sandwiched between device stages — "
                    "implied mid-chain gather + re-upload at lowering",
                )

    def _divergence_risk(self, chain: List[P.PlanNode]) -> None:
        self._stage_label = "plan"
        n_stages = len(chain) - 1
        if n_stages > DIFF_MAX_STAGES:
            self.diag(
                "divergence-risk",
                "info",
                f"chain of {n_stages} stages exceeds the random differential "
                f"vocabulary (max {DIFF_MAX_STAGES})",
            )
        uncovered = sorted(
            {
                type(n).__name__
                for n in chain[1:]
                if type(n).__name__ not in DIFF_COVERED_STAGES
            }
        )
        for name in uncovered:
            self.diag(
                "divergence-risk",
                "info",
                f"stage {name} has no random differential coverage "
                "(fixed-shape tests only)",
            )

    def _publish_counters(self) -> None:
        """Count the plan and each diagnostic by rule and severity in
        the telemetry counters (``verify.plans``,
        ``verify.<rule>.<severity>``); a no-op unless collecting."""
        from ..utils.observe import telemetry

        telemetry.count("verify.plans")
        for d in self.report.diagnostics:
            telemetry.count(f"verify.{d.rule}.{d.severity}")


def verify_plan(
    root: P.PlanNode, model: ExecutorModel = EXECUTOR_MODEL
) -> PlanReport:
    """Statically verify a plan chain; see the module docstring for the
    rule set and the verdict contract."""
    return _Verifier(model).run(root)


def _verify_enabled() -> bool:
    return env_flag("CSVPLUS_VERIFY")


def verify_before_lower(root: P.PlanNode) -> "Optional[PlanReport]":
    """Executor hook: verify *root* and raise ``UnsupportedPlan`` for
    plans the executor could not lower anyway — BEFORE any device work.

    Resolution/lane/empty findings never raise here: their runtime
    outcome (including exact host-parity error row numbers) belongs to
    the executor.  ``CSVPLUS_VERIFY=0`` bypasses verification entirely.
    """
    if not _verify_enabled():
        return None
    report = verify_plan(root)
    unlowerable = report.by_rule("unlowerable")
    if unlowerable:
        from ..columnar.exec import UnsupportedPlan

        raise UnsupportedPlan(unlowerable[0].message)
    return report
