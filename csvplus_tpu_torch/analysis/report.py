"""Machine-readable analysis reports: the ``--json`` CLI payload (port of
``csvplus_tpu/analysis/report.py``).

``json_payload`` bundles (a) the AST lint over the port's package tree
and (b) per-plan analysis for a fixed set of example chains mirroring
``examples/quickstart.py`` and ``examples/sharded_join.py``, built over
tiny deterministic corpora so the payload is stable and committable.
Each plan entry carries the verifier report, the provenance table
(:mod:`.provenance`), the cost table (:mod:`.cost`; sketches pinned
empty so the payload never depends on process history), and the rewrite
decision (:mod:`.rewrite`).  ``python -m csvplus_tpu_torch.analysis
--snapshot tests/data/analyze_snapshot_torch.json`` compares the payload
against the committed file, so diagnostic drift shows up as a diff.

The tables live on an explicit *device* (``"cuda"`` by default; ``"cuda"``
with no card raises).  The reference builds its mesh-sharded chain only
where JAX sees 8 devices; the port builds it on an 8-shard mesh over
*device* (``make_mesh(8, devices=[device] * 8)``), so it is never
skipped.  No placement in the payload names a device, so a payload made
on the card equals one made on the CPU.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

from .astlint import lint_paths
from .verify import PlanReport, verify_plan

SCHEMA_VERSION = 3

_PACKAGE_DIR = Path(__file__).resolve().parent.parent
_REPO_ROOT = _PACKAGE_DIR.parent


def default_lint_paths() -> List[Path]:
    """The package tree itself, resolved from THIS file (not the cwd), so
    the lint can never miss a newly added module."""
    return [_PACKAGE_DIR]


def lint_json(paths: Optional[List] = None) -> List[dict]:
    # the global checks (allowlist staleness, registry and doc drift) only
    # make sense over the whole package tree
    findings = lint_paths(
        paths if paths is not None else default_lint_paths(),
        global_checks=paths is None,
    )
    out = []
    for f in findings:
        p = Path(f.path)
        try:
            rel = p.resolve().relative_to(_REPO_ROOT).as_posix()
        except ValueError:
            rel = p.as_posix()
        out.append(
            {"code": f.code, "path": rel, "line": f.line, "message": f.message}
        )
    return out


def report_json(report: PlanReport) -> dict:
    return {
        "diagnostics": [
            {
                "rule": d.rule,
                "severity": d.severity,
                "stage": d.stage,
                "message": d.message,
            }
            for d in report.diagnostics
        ],
        "final_card": report.final.card.value,
        "row_placement": repr(report.final.row_placement()),
        "predicts_empty": report.predicts_empty,
        "ok": report.ok,
    }


def _mini_corpus():
    people = [
        {"id": str(i), "name": n, "surname": s}
        for i, (n, s) in enumerate(
            [("Amelia", "Smith"), ("Amelia", "Jones"), ("Jack", "Taylor")]
        )
    ]
    stock = [
        {"prod_id": "0", "product": "orange", "price": "0.03"},
        {"prod_id": "1", "product": "apple", "price": "0.02"},
    ]
    orders = [
        {
            "order_id": str(i),
            "cust_id": str(i % 3),
            "prod_id": str(i % 2),
            "qty": str(i % 9 + 1),
        }
        for i in range(64)
    ]
    return people, stock, orders


def example_plans(device="cuda") -> Dict[str, object]:
    """Plan roots per example chain name, with every table on *device*:
    the corpus ``--json`` and ``explain`` both analyze."""
    from .. import plan as P
    from ..columnar.table import DeviceTable
    from ..exprs import SetValue
    from ..parallel.mesh import make_mesh
    from ..predicates import Like
    from ..row import Row
    from ..source import take_rows

    people, stock, orders = _mini_corpus()

    def index_on(rows, *cols):
        idx = take_rows([Row(r) for r in rows]).index_on(*cols)
        idx.on_device(device)
        return idx

    people_t = DeviceTable.from_rows(people, device=device)
    orders_t = DeviceTable.from_rows(orders, device=device)
    cust_idx = index_on(people, "id")
    prod_idx = index_on(stock, "prod_id")

    out: Dict[str, object] = {}
    # examples/quickstart.py example 1: filter + map + projection
    out["quickstart-filter-map"] = P.SelectCols(
        P.MapExpr(
            P.Filter(P.Scan(people_t), Like({"name": "Amelia"})),
            SetValue("name", "Julia"),
        ),
        ("name", "surname"),
    )
    # examples/quickstart.py example 2: the 3-table join
    out["quickstart-join"] = P.Join(
        P.Join(P.Scan(orders_t), cust_idx, ("cust_id",)), prod_idx, ()
    )
    # the probe-fusion shape: a filter + map on the fact side absorbed
    # into the probe pass
    out["fused-probe-chain"] = P.Join(
        P.MapExpr(
            P.Filter(P.Scan(orders_t), Like({"qty": "3"})),
            SetValue("src", "bench"),
        ),
        cust_idx,
        ("cust_id",),
    )
    # examples/sharded_join.py: a mesh-sharded stream probing a
    # single-device index, here on 8 shards of *device*
    sharded_t = orders_t.with_sharding(make_mesh(8, devices=[device] * 8))
    out["sharded-join"] = P.Top(
        P.Filter(
            P.Join(
                P.SelectCols(P.Scan(sharded_t), ("cust_id", "qty")),
                cust_idx,
                ("cust_id",),
            ),
            Like({"name": "Amelia"}),
        ),
        5,
    )
    # the serving tier's plan-query shape: a Lookup leaf with a
    # downstream filter + projection (needs a lazy device index, hence
    # the on_device-then-index_on build order)
    serve_idx = take_rows([Row(r) for r in people]).on_device(device).index_on("id")
    lookup_plan = serve_idx.find("1").plan
    if lookup_plan is not None:
        out["serve-lookup-filter"] = P.SelectCols(
            P.Filter(lookup_plan, Like({"name": "Amelia"})),
            ("name", "surname"),
        )
    else:
        out["serve-lookup-filter"] = "skipped: index has no device plan"
    return out


def example_plan_reports(device="cuda") -> Dict[str, object]:
    """Verifier reports (or a skip-reason string) per example chain."""
    return {
        name: p if isinstance(p, str) else verify_plan(p)
        for name, p in example_plans(device).items()
    }


def provenance_json(root) -> List[dict]:
    """The provenance table: one dict per chain slot (None = unknown
    footprint, the conservative lattice top)."""
    from . import provenance as PV

    def cols(s):
        return None if s is None else sorted(s)

    return [
        {
            "stage": f.label,
            "reads": cols(f.reads),
            "writes": cols(f.writes),
            "removes": cols(f.removes),
            "keeps_only": cols(f.keeps_only),
            "fallback_writes": cols(f.fallback_writes),
            "row_linear": f.row_linear,
            "order_preserving": f.order_preserving,
            "multiplicity": f.multiplicity,
            "may_error": f.may_error,
            "aborting": f.aborting,
            "barrier": f.barrier,
        }
        for f in PV.plan_facts(root)
    ]


def cost_json(root) -> List[dict]:
    """The cost table: one estimate dict per chain slot.  Sketches are
    pinned EMPTY so the payload never depends on what joins this process
    happened to run."""
    from .cost import estimate_plan

    return [e.as_dict() for e in estimate_plan(root, sketches={})]


def rewrite_json(root, report) -> dict:
    """The rewrite decision: what applied, what each blocked rule was
    stopped by, and the replayable recipe (sketches pinned empty)."""
    from .rewrite import RewriteVerdictMismatch, optimize_plan

    try:
        result = optimize_plan(root, report, sketches={})
    except RewriteVerdictMismatch as exc:  # prover bug: keep it visible
        return {"error": str(exc)}
    recipe = None
    if result.recipe is not None:
        recipe = {
            # fuse_joins carries scalar args; permute/drop carry tuples
            "steps": [
                [step[0]]
                + [list(a) if isinstance(a, (list, tuple)) else a
                   for a in step[1:]]
                for step in result.recipe.steps
            ],
            "require_present": list(result.recipe.require_present),
            "join_order": list(result.recipe.join_order),
        }
    return {
        "applied": list(result.applied),
        "blocked": [
            {"rule": d.rule, "stage": d.stage, "message": d.message}
            for d in result.blocked
        ],
        "recipe": recipe,
    }


def plan_analysis_json(root) -> dict:
    """Everything the suite knows about one plan: verifier verdict,
    provenance table, cost table, join-order ranking, join operator,
    fusion and rewrite decision."""
    from .cost import choose_fusion, choose_join_operator, rank_join_orders

    report = verify_plan(root)
    d = report_json(report)
    d["provenance"] = provenance_json(root)
    d["cost"] = cost_json(root)
    d["join_orders"] = rank_join_orders(root, report, sketches={})
    d["join_operator"] = choose_join_operator(root, sketches={})
    d["fusion"] = choose_fusion(root, sketches={})
    d["rewrite"] = rewrite_json(root, report)
    return d


def _colset(v) -> str:
    if v is None:
        return "?"
    return ",".join(v) if v else "-"


def explain_text(name: str, root) -> str:
    """Human-readable per-node provenance/cost/placement tables for one
    plan: the ``explain`` CLI's default output."""
    d = plan_analysis_json(root)
    lines = [
        f"explain: {name}",
        f"verdict: ok={d['ok']} predicts_empty={d['predicts_empty']}"
        f" final_card={d['final_card']} rows@{d['row_placement']}",
        "",
        f"{'stage':<16} {'reads':<18} {'writes':<12} {'removes':<12}"
        f" {'mult':<5} flags",
    ]
    for row in d["provenance"]:
        flags = [
            k
            for k, on in (
                ("may-error", row["may_error"]),
                ("aborting", row["aborting"]),
                ("barrier", row["barrier"]),
                ("nonlinear", not row["row_linear"]),
                ("unordered", not row["order_preserving"]),
            )
            if on
        ]
        writes = _colset(row["writes"])
        if row["fallback_writes"]:
            writes += f"(+{_colset(row['fallback_writes'])})"
        removes = _colset(row["removes"])
        if row["keeps_only"] is not None:
            removes = f"keep:{_colset(row['keeps_only'])}"
        lines.append(
            f"{row['stage']:<16} {_colset(row['reads']):<18} {writes:<12}"
            f" {removes:<12} {row['multiplicity']:<5}"
            f" {','.join(flags) or '-'}"
        )
    lines += [
        "",
        f"{'stage':<16} {'rows':>10} {'host B':>10} {'device B':>10}"
        f" {'repl B':>10} {'sel':>8}  note",
    ]
    for row in d["cost"]:
        sel = "-" if "selectivity" not in row else f"{row['selectivity']:.4f}"
        lines.append(
            f"{row['stage']:<16} {row['rows']:>10.1f} {row['bytes_host']:>10.1f}"
            f" {row['bytes_device']:>10.1f} {row['bytes_replicated']:>10.1f}"
            f" {sel:>8}  {row.get('note', '')}"
        )
    if d["join_orders"]:
        lines += ["", "join orders (est Σ intermediate rows; * = submitted):"]
        for cand in d["join_orders"]:
            mark = "*" if cand["submitted"] else (
                "provable" if cand["provable"] else "unprovable")
            lines.append(
                f"  {' -> '.join(cand['order']):<48}"
                f" {cand['est_intermediate_rows']:>12.1f}  {mark}"
            )
    op = d.get("join_operator")
    if op is not None:
        lines += [
            "",
            "physical join operator (cascaded vs single-pass multiway):",
            f"  run: {' -> '.join(op['run'])} ({op['dims']} dims, "
            f"est {op['est_rows_in']:.0f} rows in -> "
            f"{op['est_rows_out']:.0f} out)",
            f"  cascaded   : {op['cascade_intermediate_bytes']:>14.1f} B "
            f"intermediate tables + per-level bounds",
            f"  multiway   : {op['multiway_bytes']:>14.1f} B per-dimension "
            f"bounds, no intermediate",
            f"  chosen     : {op['chosen']}",
        ]
    fu = d.get("fusion")
    if fu is not None:
        lines += [
            "",
            "probe-pass fusion (staged materialize vs fused key gathers):",
            f"  run: {' -> '.join(fu['run'])} ({len(fu['ops'])} op(s) + "
            f"{fu['dims']}-dim probe, est {fu['est_rows_in']:.0f} rows in"
            f" -> {fu['est_rows_selected']:.0f} selected)",
            f"  staged     : {fu['staged_bytes_host']:>14.1f} B host /"
            f" {fu['staged_bytes_device']:>14.1f} B device materialized",
            f"  fused      : {fu['fused_bytes_host']:>14.1f} B host /"
            f" {fu['fused_bytes_device']:>14.1f} B device key gathers",
            f"  chosen     : {fu['chosen']} ({fu['note']})",
        ]
        if fu.get("blocked_by"):
            lines.append(f"  blocked by : {fu['blocked_by']}")
    rw = d["rewrite"]
    lines.append("")
    if "error" in rw:
        lines.append(f"rewrite ERROR: {rw['error']}")
    else:
        lines.append(
            "rewrite: " + ("; ".join(rw["applied"]) or "nothing applied"))
        for b in rw["blocked"]:
            lines.append(f"  blocked {b['rule']} by {b['stage']}: {b['message']}")
        if rw["recipe"] is not None:
            steps = ", ".join(
                s[0] + "(" + ",".join(
                    "[" + ",".join(map(str, a)) + "]"
                    if isinstance(a, list) else str(a)
                    for a in s[1:]
                ) + ")"
                for s in rw["recipe"]["steps"]
            )
            lines.append(
                f"  recipe: {steps}; require_present="
                f"{rw['recipe']['require_present']}"
            )
    return "\n".join(lines)


def plancert_json(device="cuda") -> dict:
    """A small-N plan-space certification summary for the payload:
    deterministic counts only, at a fixed N=2, with the budget pinned
    effectively infinite so the payload never depends on machine speed.
    ``certify`` reads the process-wide build-side sketches (a defect kept
    from the reference): reset ``obs.joinskew.joinskew`` first."""
    from .plancert import certify, summary_json

    return summary_json(certify(n=2, budget_s=1e9, device=device))


def json_payload(paths: Optional[List] = None, device="cuda") -> dict:
    """The full ``--json`` CLI payload (the reference's schema 3)."""
    plans = {}
    for name, p in sorted(example_plans(device).items()):
        plans[name] = (
            {"skipped": p} if isinstance(p, str) else plan_analysis_json(p)
        )
    return {
        "schema": SCHEMA_VERSION,
        "lint": lint_json(paths),
        "plans": plans,
        "plan_cert": plancert_json(device),
    }
