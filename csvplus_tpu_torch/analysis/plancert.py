"""Exhaustive plan-space certification of the rewriter.

Port of ``csvplus_tpu/analysis/plancert.py``, giving the same summary.
Soundness of the rewriter is certified over the plan *space* (the
rewrite-algebra framing of arxiv 2502.06988): this module enumerates
EVERY plan chain up to a size bound over a small canonical schema, runs
``verify -> optimize`` on each, and discharges four obligations per
plan:

1. **Verdict equality**: re-verifying the rewritten plan must produce
   the same verdict (``ok`` and ``predicts_empty``) as the original;
   a :class:`~csvplus_tpu_torch.analysis.rewrite.RewriteVerdictMismatch`
   is a certification failure, not an exception.
2. **Licensed steps**: every applied recipe step is INDEPENDENTLY
   re-proven here from the provenance primitives
   (:func:`~csvplus_tpu_torch.analysis.provenance.prove_swap_before`,
   :func:`~csvplus_tpu_torch.analysis.provenance.live_columns`, stage
   facts), replaying the recipe one step at a time so each step is
   checked against the exact intermediate chain it addressed.
3. **Bitwise parity**: every plan the rewriter touched executes both
   forms over the seeded corpus: equal positional per-column
   checksums, equal column order, and raising plans must raise the
   SAME exception type on both sides.
4. **Real refusal stages**: every typed refusal
   (:class:`~csvplus_tpu_torch.analysis.provenance.ProvenanceDiagnostic`)
   must name a stage label that exists in the original (or rewritten)
   chain; a refusal naming a phantom stage is a prover bug.

Verifier-rejected trees (unknown columns, key mismatches, ...) are
COUNTED, not crashed: the certifier proves the optimizer never turns a
rejection into an acceptance or vice versa.

Bounds: ``CSVPLUS_PLANCERT_N`` (default 3) is the max chain size
including the leaf; ``CSVPLUS_PLANCERT_BUDGET_S`` (default 60) is the
wall-clock budget, and exceeding it FAILS the run.  The corpus is built
once per device and memoized.  It lives on *device* (``"cuda"`` by
default; the reference builds it on the CPU), so on the card the plans'
filters launch the mask kernel and their joins run there.

Like the reference, :func:`certify` lets the rewriter's cost model read
the process-wide build-side sketches (``obs.joinskew``): run after joins
that left hot build-side keys behind, the rewriter may rank a join ahead
of an ``Except`` and the licensed-steps obligation then fails ("permute
moves non-mover Join[2]"), in both packages alike.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from .. import plan as P
from ..utils.env import env_float, env_int
from . import provenance as PV
from .rewrite import PlanRecipe, RewriteVerdictMismatch, apply_recipe
from .schema import Presence

__all__ = ["CertSummary", "certify", "summary_json", "DEFAULT_N"]

DEFAULT_N = 3


@dataclass
class CertSummary:
    """Deterministic certification counts (the analyze payload embeds
    these; wall-clock numbers stay OUT so snapshots are stable)."""

    n: int
    budget_s: float
    plans_total: int = 0
    verified_ok: int = 0
    verifier_rejected: int = 0
    predicts_empty: int = 0
    rewritten: int = 0
    executed_pairs: int = 0
    raised_pairs: int = 0
    refusals_checked: int = 0
    failures: List[str] = field(default_factory=list)
    budget_exceeded: bool = False

    @property
    def ok(self) -> bool:
        return not self.failures and not self.budget_exceeded

    def describe(self) -> str:
        lines = [
            f"plan-cert: N={self.n} -> {self.plans_total} plans "
            f"({self.verified_ok} ok, {self.verifier_rejected} rejected, "
            f"{self.predicts_empty} predict-empty)",
            f"  rewritten: {self.rewritten}  executed pairs: "
            f"{self.executed_pairs} ({self.raised_pairs} raising)  "
            f"refusals checked: {self.refusals_checked}",
        ]
        if self.budget_exceeded:
            lines.append(f"  FAILED: budget {self.budget_s}s exceeded")
        for f in self.failures[:20]:
            lines.append(f"  FAILED: {f}")
        if len(self.failures) > 20:
            lines.append(f"  ... and {len(self.failures) - 20} more")
        if self.ok:
            lines.append("  all obligations hold")
        return "\n".join(lines)


def summary_json(s: CertSummary) -> Dict:
    return {
        "n": s.n,
        "plans_total": s.plans_total,
        "verified_ok": s.verified_ok,
        "verifier_rejected": s.verifier_rejected,
        "predicts_empty": s.predicts_empty,
        "rewritten": s.rewritten,
        "executed_pairs": s.executed_pairs,
        "raised_pairs": s.raised_pairs,
        "refusals_checked": s.refusals_checked,
        "failures": list(s.failures),
        "ok": s.ok,
    }


# ---------------------------------------------------------------------------
# Canonical corpus: two leaves, ~a dozen stage constructors.  Memoized per
# device: the enumeration shares ONE fact table and two build indices, so
# the executor's caches amortize across every plan.

_corpus_cache: Dict[str, Tuple] = {}


def _corpus(device="cuda"):
    key = str(device)
    if key in _corpus_cache:
        return _corpus_cache[key]
    from .. import source as cp
    from ..columnar.table import DeviceTable
    from ..exprs import Rename, SetValue
    from ..predicates import Like

    n = 24
    fact = DeviceTable.from_pylists(
        {
            "id": [str(i % 10) for i in range(n)],
            "cat": [f"k{i % 3}" for i in range(n)],
            "val": [str(i) for i in range(n)],
        },
        device=device,
    )
    dim = cp.take(
        DeviceTable.from_pylists(
            # ids 0..7: ids 8/9 of the fact stream MISS -> join narrows
            {"id": [str(i) for i in range(8)],
             "region": [f"r{i % 2}" for i in range(8)]},
            device=device,
        )
    ).index_on("id").sync()
    dim2 = cp.take(
        DeviceTable.from_pylists(
            {"cat": ["k0", "k1", "k2"], "label": ["a", "b", "c"]},
            device=device,
        )
    ).index_on("cat").sync()

    leaves: List[Tuple[str, Callable[[], P.PlanNode]]] = [
        ("scan", lambda: P.Scan(fact)),
        # a Lookup leaf is a Scan restricted to a contiguous range of a
        # sorted index table (index.py Index.find) — enumerate it too
        ("lookup", lambda: P.Lookup(dim.device_table.table, 1, 6)),
    ]
    stages: List[Tuple[str, Callable[[P.PlanNode], P.PlanNode]]] = [
        ("filter_cat", lambda c: P.Filter(c, Like({"cat": "k1"}))),
        ("filter_id", lambda c: P.Filter(c, Like({"id": "3"}))),
        ("validate", lambda c: P.Validate(c, Like({"cat": "k1"}),
                                          "cert: cat must be k1")),
        ("map_set", lambda c: P.MapExpr(c, SetValue("flag", "x"))),
        ("map_rename", lambda c: P.MapExpr(c, Rename({"val": "v"}))),
        ("select", lambda c: P.SelectCols(c, ("id", "cat"))),
        # valid only downstream of the dim join — most placements are
        # verifier-rejected, which the certifier must COUNT, not crash
        ("select_region", lambda c: P.SelectCols(c, ("region",))),
        ("drop", lambda c: P.DropCols(c, ("val",))),
        ("top", lambda c: P.Top(c, 5)),
        ("join_dim", lambda c: P.Join(c, dim, ("id",))),
        ("join_cat", lambda c: P.Join(c, dim2, ("cat",))),
        ("except_dim", lambda c: P.Except(c, dim, ("id",))),
        ("multiway", lambda c: P.MultiwayJoin(
            c, ((dim, ("id",)), (dim2, ("cat",))))),
    ]
    _corpus_cache[key] = (leaves, stages)
    return _corpus_cache[key]


def _enumerate_plans(n: int, device="cuda"):
    """Every (name, root) chain of size <= n (leaf included), in a
    deterministic order."""
    leaves, stages = _corpus(device)
    frontier: List[Tuple[str, P.PlanNode]] = [
        (name, mk()) for name, mk in leaves
    ]
    for name, root in frontier:
        yield name, root
    for _ in range(max(n - 1, 0)):
        nxt: List[Tuple[str, P.PlanNode]] = []
        for name, root in frontier:
            for sname, mk in stages:
                plan = (f"{name}>{sname}", mk(root))
                nxt.append(plan)
                yield plan
        frontier = nxt


# ---------------------------------------------------------------------------
# Obligation 2: independent licensing re-check, one recipe step at a
# time against the exact intermediate chain it addressed.


def _presence_fn(facts, leaf_present, upto: int):
    """Stable-presence oracle for the input of chain slot *upto* —
    the same proof the replay-time leaf check re-establishes (see
    rewrite._stable_presence_fn; re-derived here so the certifier does
    not trust the rewriter's own oracle)."""

    def ok(col: str) -> bool:
        if col not in leaf_present:
            return False
        for q in range(1, upto):
            f = facts[q]
            if f.barrier or f.reads is None:
                return False
            if col in f.writes or col in f.removes:
                return False
            if f.keeps_only is not None and col not in f.keeps_only:
                return False
        return True

    return ok


def _check_step(step: Tuple, cur_root: P.PlanNode, leaf_present,
                final_schema) -> List[str]:
    """License one recipe step against the chain it is about to
    rewrite.  Returns human-readable obligation failures."""
    fails: List[str] = []
    chain = P.linearize(cur_root)
    facts = PV.plan_facts(cur_root)
    kind = step[0]
    if kind == "permute":
        slots = list(step[1])
        if sorted(slots) != list(range(len(chain))) or slots[0] != 0:
            return [f"permute {slots} is not a leaf-fixed permutation"]
        # every inversion means some stage moved over another: the
        # moved-up stage must be a narrowing mover and the swap must be
        # provenance-proven against the stage it crossed
        for out_pos, i in enumerate(slots):
            for j in slots[out_pos + 1:]:
                if j >= i:
                    continue
                # original slot i now runs BEFORE original slot j < i
                mover, below = facts[i], facts[j]
                if mover.op not in ("Filter", "Except"):
                    fails.append(
                        f"permute moves non-mover {mover.label}")
                    continue
                d = PV.prove_swap_before(
                    "plan-cert", mover, below,
                    _presence_fn(facts, leaf_present, j),
                )
                if d is not None:
                    fails.append(
                        f"unlicensed swap {mover.label} before "
                        f"{below.label}: {d.message}")
    elif kind == "fuse_joins":
        lo, k = int(step[1]), int(step[2])
        run = chain[lo:lo + k]
        if len(run) != k or not all(isinstance(s, P.Join) for s in run):
            return [f"fuse_joins [{lo},{lo + k}) is not a Join run"]
        # license: every LATER join's key columns must be stably
        # present on the stream side entering the run (the cascade
        # cannot have errored in between)
        ok = _presence_fn(facts, leaf_present, lo)
        for s in run[1:]:
            for col in s.columns:
                if not ok(col):
                    fails.append(
                        f"fuse_joins: key {col!r} of a later join is "
                        "not stably present at the fuse point")
    elif kind == "fuse_chain":
        s0, m = int(step[1]), int(step[2])
        run = chain[s0:s0 + m]
        if len(run) != m or m < 2:
            return [f"fuse_chain [{s0},{s0 + m}) is not a chain run"]
        if not isinstance(run[-1], (P.Join, P.MultiwayJoin)):
            return ["fuse_chain run does not end in a probe"]
        for pos in range(s0, s0 + m - 1):
            f = facts[pos]
            if f.barrier or f.reads is None or not f.row_linear:
                fails.append(
                    f"fuse_chain absorbs {f.label} without a known "
                    "row-linear footprint")
    elif kind == "drop_after_leaf":
        cols = set(step[1])
        live = PV.live_columns(facts, list(final_schema))
        if live is None:
            fails.append("drop_after_leaf with unknown liveness")
        elif cols & live:
            fails.append(
                f"drop_after_leaf drops LIVE columns {sorted(cols & live)}")
    else:
        fails.append(f"unknown recipe step kind {kind!r}")
    return fails


def _check_recipe(root: P.PlanNode, recipe: PlanRecipe, report) -> List[str]:
    leaf_present = frozenset(
        name for name, info in report.states[0].schema.items()
        if info.presence is Presence.PRESENT
    )
    final_schema = list(report.states[-1].schema)
    fails: List[str] = []
    cur = root
    for step in recipe.steps:
        fails.extend(_check_step(step, cur, leaf_present, final_schema))
        try:
            cur = apply_recipe(cur, PlanRecipe(steps=(step,)))
        except ValueError as e:  # malformed step: structural refusal
            fails.append(f"recipe step {step[0]!r} failed to apply: {e}")
            break
    return fails


# ---------------------------------------------------------------------------
# Obligation 3: bitwise differential execution.


def _execute(root: P.PlanNode):
    """("ok", table) | ("raise", exception type name)."""
    from ..columnar.exec import execute_plan_view

    try:
        return ("ok", execute_plan_view(root).materialize())
    except Exception as e:  # noqa: BLE001 - parity compares the TYPE
        return ("raise", type(e).__name__)


def _parity(name: str, original: P.PlanNode,
            rewritten: P.PlanNode) -> Tuple[List[str], bool]:
    from ..utils.checksum import checksum_device_table

    a_kind, a = _execute(original)
    b_kind, b = _execute(rewritten)
    if a_kind != b_kind:
        return ([f"{name}: original {a_kind}({a if a_kind == 'raise' else ''})"
                 f" vs rewritten {b_kind}"
                 f"({b if b_kind == 'raise' else ''})"], False)
    if a_kind == "raise":
        if a != b:
            return ([f"{name}: raises {a} vs {b}"], True)
        return ([], True)
    if a.nrows != b.nrows or list(a.columns) != list(b.columns):
        return ([f"{name}: shape {a.nrows}x{list(a.columns)} vs "
                 f"{b.nrows}x{list(b.columns)}"], False)
    if checksum_device_table(a, positional=True) != checksum_device_table(
            b, positional=True):
        return ([f"{name}: positional checksums differ"], False)
    return ([], False)


# ---------------------------------------------------------------------------


def certify(n: Optional[int] = None,
            budget_s: Optional[float] = None,
            device="cuda") -> CertSummary:
    """Certify the whole plan space up to size *n* over the corpus on
    *device* (see module doc).  ``"cuda"`` with no card raises."""
    from .rewrite import optimize_plan
    from .verify import verify_plan

    if n is None:
        n = env_int("CSVPLUS_PLANCERT_N", DEFAULT_N)
    if budget_s is None:
        budget_s = env_float("CSVPLUS_PLANCERT_BUDGET_S", 60.0)
    s = CertSummary(n=n, budget_s=budget_s)
    t0 = time.monotonic()
    for name, root in _enumerate_plans(n, device):
        if time.monotonic() - t0 > budget_s:
            s.budget_exceeded = True
            break
        s.plans_total += 1
        report = verify_plan(root)
        if report.ok:
            s.verified_ok += 1
        else:
            s.verifier_rejected += 1
        if report.predicts_empty:
            s.predicts_empty += 1

        try:
            result = optimize_plan(root, report)
        except RewriteVerdictMismatch as e:
            s.failures.append(f"{name}: verdict mismatch: {e}")
            continue
        except Exception as e:  # noqa: BLE001 - a crash is a cert failure
            s.failures.append(
                f"{name}: optimize_plan crashed: {type(e).__name__}: {e}")
            continue

        # (1) verdict equality, independently of the rewriter's check
        if (result.report.ok != report.ok
                or result.report.predicts_empty != report.predicts_empty):
            s.failures.append(
                f"{name}: verdict drift ok={report.ok}->"
                f"{result.report.ok} empty={report.predicts_empty}->"
                f"{result.report.predicts_empty}")

        # (4) every typed refusal names a real stage
        labels = {
            P.stage_label(i, nd)
            for i, nd in enumerate(P.linearize(root))
        } | {
            P.stage_label(i, nd)
            for i, nd in enumerate(P.linearize(result.root))
        }
        for d in result.blocked:
            s.refusals_checked += 1
            if d.stage not in labels:
                s.failures.append(
                    f"{name}: refusal names phantom stage {d.stage!r}")

        if not result.recipe:
            continue
        s.rewritten += 1

        # (2) every applied step independently licensed
        s.failures.extend(
            f"{name}: {msg}"
            for msg in _check_recipe(root, result.recipe, report)
        )

        # (3) bitwise parity on every rewritten plan the verifier
        # accepts (rejected plans have no defined execution to compare)
        if report.ok:
            fails, raised = _parity(name, root, result.root)
            s.executed_pairs += 1
            if raised:
                s.raised_pairs += 1
            s.failures.extend(fails)
    return s
