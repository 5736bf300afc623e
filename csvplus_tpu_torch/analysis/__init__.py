"""Static analysis of device plans: the port of ``csvplus_tpu/analysis/``
that the plan cache needs.

* :mod:`.verify` + :mod:`.schema` — the plan-IR static verifier
  (presence / cardinality / lane / placement domains), run by the
  executor before every plain-API lowering (``CSVPLUS_VERIFY=0``
  disables) and once per shape by the plan cache;
* :mod:`.provenance` + :mod:`.cost` — the rewrite-proving domains:
  per-stage column footprints precise enough to PROVE a rewrite
  bitwise-safe, and advisory cardinality / per-placement-bytes
  estimates that rank the candidates;
* :mod:`.rewrite` — the verifier-checked optimizer: applies only
  provenance-proven rewrites, re-verifies, asserts the equivalence
  verdict (``CSVPLUS_OPTIMIZE=0`` disables).

* :mod:`.plancert` — the plan-space certifier: every plan chain up to a
  size bound through verify -> optimize, four obligations per plan
  (imported as a module, as in the reference);
* :mod:`.astlint` + :mod:`.jitlint` — the port's AST lint (the
  reference's framework-free rules, EAGER001 and SYNC001 redesigned for
  eager torch), run by ``python -m csvplus_tpu_torch.analysis``;
* :mod:`.report` — the ``--json`` payload (lint + example-chain analysis)
  snapshot-compared against ``tests/data/analyze_snapshot_torch.json``,
  and the ``explain`` CLI's tables.
"""

from .astlint import LintFinding, lint_file, lint_paths, lint_source
from .cost import (
    CostEstimate,
    choose_fusion,
    choose_join_operator,
    estimate_plan,
    rank_join_orders,
)
from .provenance import (
    ProvenanceDiagnostic,
    StageFacts,
    live_columns,
    plan_facts,
    prove_swap_before,
    stage_facts,
)
from .report import json_payload, plan_analysis_json
from .rewrite import (
    PlanRecipe,
    RewriteResult,
    RewriteVerdictMismatch,
    apply_recipe,
    leaf_presence_ok,
    optimize_enabled,
    optimize_plan,
)
from .schema import (
    PLACE_DEVICE,
    PLACE_HOST,
    PLACE_UNKNOWN,
    Card,
    ColInfo,
    NodeState,
    Placement,
    Presence,
    placement_of_array,
    placement_of_column,
    sharded_placement,
)
from .verify import (
    EXECUTOR_MODEL,
    Diagnostic,
    ExecutorModel,
    PlanReport,
    verify_before_lower,
    verify_plan,
)

__all__ = [
    "Card",
    "ColInfo",
    "CostEstimate",
    "Diagnostic",
    "EXECUTOR_MODEL",
    "ExecutorModel",
    "LintFinding",
    "NodeState",
    "PLACE_DEVICE",
    "PLACE_HOST",
    "PLACE_UNKNOWN",
    "Placement",
    "PlanRecipe",
    "PlanReport",
    "Presence",
    "ProvenanceDiagnostic",
    "RewriteResult",
    "RewriteVerdictMismatch",
    "StageFacts",
    "apply_recipe",
    "choose_fusion",
    "choose_join_operator",
    "estimate_plan",
    "json_payload",
    "leaf_presence_ok",
    "lint_file",
    "lint_paths",
    "lint_source",
    "live_columns",
    "optimize_enabled",
    "optimize_plan",
    "plan_facts",
    "placement_of_array",
    "placement_of_column",
    "plan_analysis_json",
    "prove_swap_before",
    "rank_join_orders",
    "sharded_placement",
    "stage_facts",
    "verify_before_lower",
    "verify_plan",
]
