"""Stage-table regression differ: ``python -m csvplus_tpu_torch.obs diff``.

Port of ``csvplus_tpu/obs/diff.py`` (pure host code).  It compares two
runs' per-stage tables mechanically, the way a warm-join regression is
found by hand (a stage such as ``join:translate`` grown from noise to
dominant):

* a stage's **time share** (its seconds over the table's total) and its
  **per-row time** (seconds over rows) are both computed per side; the
  per-row metric makes tables from different row tiers comparable;
* a stage is **flagged** when either metric moved by more than
  ``--threshold`` (default 2x) in either direction AND the stage is big
  enough to matter on at least one side (``--min-share``, default 0.5%
  of total time): tiny stages jitter, and a 3x move on 0.1% of the
  run is not a diagnosis;
* stages present on only one side are reported separately (a renamed or
  newly-instrumented stage is signal too, just different signal);
* when both sides carry an ``rss_peak_mb`` extra for a stage (the
  :func:`csvplus_tpu_torch.obs.memory.watch_memory` column), its ratio
  is diffed under the same threshold.

Accepted inputs: any JSON file whose top level is a stage list, or an
artifact dict carrying one under ``stage_table`` / ``stage_table_auto``
/ ``stage_table_serial`` / ``stages`` (first match; override with
``--key``).  Each stage row needs ``stage`` and ``seconds``; ``rows_in``
/ ``rows_out`` enable the per-row metric.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence

#: Artifact keys probed, in order, for the embedded stage table.
STAGE_TABLE_KEYS = (
    "stage_table",
    "stage_table_auto",
    "stage_table_serial",
    "stages",
)

DEFAULT_THRESHOLD = 2.0
DEFAULT_MIN_SHARE = 0.005


def load_stage_table(
    path: str, key: Optional[str] = None
) -> List[Dict[str, Any]]:
    """The stage list embedded in *path* (see the module docstring for
    the accepted shapes).  Raises ``ValueError`` with the keys that
    were probed when the artifact carries no stage table."""
    with open(path) as f:
        obj = json.load(f)
    if isinstance(obj, list):
        table = obj
    elif isinstance(obj, dict):
        keys = (key,) if key else STAGE_TABLE_KEYS
        table = next((obj[k] for k in keys if obj.get(k)), None)
        if table is None:
            raise ValueError(
                f"{path}: no stage table under {', '.join(k for k in keys if k)}"
                " — pass --key for a nonstandard artifact"
            )
    else:
        raise ValueError(f"{path}: top level is {type(obj).__name__}")
    out = []
    for row in table:
        if not isinstance(row, dict) or "stage" not in row or "seconds" not in row:
            raise ValueError(f"{path}: stage row missing stage/seconds: {row!r}")
        out.append(row)
    return out


def _stage_facts(table: Sequence[Dict[str, Any]]) -> Dict[str, Dict[str, float]]:
    total = sum(float(r["seconds"]) for r in table) or 1.0
    facts: Dict[str, Dict[str, float]] = {}
    for r in table:
        sec = float(r["seconds"])
        rows = max(int(r.get("rows_in", 0)), int(r.get("rows_out", 0)))
        facts[str(r["stage"])] = {
            "seconds": sec,
            "share": sec / total,
            "ns_per_row": (sec / rows * 1e9) if rows > 0 else None,
            "rss_peak_mb": r.get("rss_peak_mb"),
        }
    return facts


def _ratio(a: Optional[float], b: Optional[float]) -> Optional[float]:
    if a is None or b is None or a <= 0 or b <= 0:
        return None
    return a / b


def diff_stage_tables(
    table_a: Sequence[Dict[str, Any]],
    table_b: Sequence[Dict[str, Any]],
    *,
    threshold: float = DEFAULT_THRESHOLD,
    min_share: float = DEFAULT_MIN_SHARE,
) -> Dict[str, Any]:
    """Compare two stage tables; see the module docstring for the
    flagging rule.  Returns a JSON-safe dict with per-stage ``rows``,
    the ``flagged`` stages (worst movement first, each tagged with the
    side it regressed in), and the one-sided stage lists."""
    fa, fb = _stage_facts(table_a), _stage_facts(table_b)
    rows: List[Dict[str, Any]] = []
    flagged: List[Dict[str, Any]] = []
    for stage in [s for s in fa if s in fb]:
        a, b = fa[stage], fb[stage]
        share_ratio = _ratio(a["share"], b["share"])
        row_ratio = _ratio(a["ns_per_row"], b["ns_per_row"])
        rss_ratio = _ratio(a["rss_peak_mb"], b["rss_peak_mb"])
        # movement = the larger departure from 1.0 among the metrics,
        # measured symmetrically (2.0 and 0.5 are the same movement)
        movement = max(
            (max(r, 1.0 / r) for r in (share_ratio, row_ratio, rss_ratio) if r),
            default=1.0,
        )
        big_enough = max(a["share"], b["share"]) >= min_share
        flag = big_enough and movement >= threshold
        # the side whose cost is HIGHER is the regressed side; per-row
        # time decides when available (scale-invariant), share otherwise
        decider = row_ratio if row_ratio is not None else share_ratio
        regressed_in = None
        if flag and decider is not None:
            regressed_in = "A" if decider > 1.0 else "B"
        row = {
            "stage": stage,
            "share_a": round(a["share"], 4),
            "share_b": round(b["share"], 4),
            "ns_per_row_a": _rnd(a["ns_per_row"]),
            "ns_per_row_b": _rnd(b["ns_per_row"]),
            "movement": round(movement, 2),
            "flagged": flag,
            "regressed_in": regressed_in,
        }
        if rss_ratio is not None:
            row["rss_peak_mb_a"] = a["rss_peak_mb"]
            row["rss_peak_mb_b"] = b["rss_peak_mb"]
        rows.append(row)
        if flag:
            flagged.append(row)
    flagged.sort(key=lambda r: -r["movement"])
    return {
        "threshold": threshold,
        "min_share": min_share,
        "rows": rows,
        "flagged": flagged,
        "only_in_a": [s for s in fa if s not in fb],
        "only_in_b": [s for s in fb if s not in fa],
    }


def _rnd(v: Optional[float]) -> Optional[float]:
    return None if v is None else round(v, 3)


def format_diff(result: Dict[str, Any], label_a: str, label_b: str) -> str:
    """Human-readable report (the CLI's default output)."""
    lines = [
        f"stage-table diff: A={label_a}  B={label_b}",
        f"threshold {result['threshold']}x, min share"
        f" {result['min_share'] * 100:.1f}%",
        "",
        f"{'stage':<24} {'share A':>8} {'share B':>8} {'ns/row A':>10}"
        f" {'ns/row B':>10} {'move':>6}  flag",
    ]
    for r in result["rows"]:
        nra = "-" if r["ns_per_row_a"] is None else f"{r['ns_per_row_a']:.2f}"
        nrb = "-" if r["ns_per_row_b"] is None else f"{r['ns_per_row_b']:.2f}"
        mark = f"REGRESSED in {r['regressed_in']}" if r["flagged"] else ""
        lines.append(
            f"{r['stage']:<24} {r['share_a'] * 100:>7.2f}%"
            f" {r['share_b'] * 100:>7.2f}% {nra:>10} {nrb:>10}"
            f" {r['movement']:>5.2f}x  {mark}"
        )
    for side, stages in (("A", result["only_in_a"]), ("B", result["only_in_b"])):
        if stages:
            lines.append(f"only in {side}: {', '.join(stages)}")
    if result["flagged"]:
        worst = ", ".join(
            f"{r['stage']} ({r['movement']:.1f}x in {r['regressed_in']})"
            for r in result["flagged"]
        )
        lines.append(f"flagged: {worst}")
    else:
        lines.append("flagged: none")
    return "\n".join(lines)


def diff_files(
    path_a: str,
    path_b: str,
    *,
    threshold: float = DEFAULT_THRESHOLD,
    min_share: float = DEFAULT_MIN_SHARE,
    key: Optional[str] = None,
) -> Dict[str, Any]:
    """Load both artifacts and diff their stage tables."""
    return diff_stage_tables(
        load_stage_table(path_a, key),
        load_stage_table(path_b, key),
        threshold=threshold,
        min_share=min_share,
    )


# -- bench-record mode --------------------------------------------------------
#
# The mesh artifact is the only family carrying a stage table; the
# wal/delta/serve/view bench records are nested dicts of scalar
# measurements (rows_per_sec, p99_ms, fsyncs...).  ``diff_bench_records``
# mechanizes regression triage for THOSE: flatten both records to dotted
# numeric leaves, ratio every shared leaf, flag symmetric movement
# beyond the threshold.  Direction is reported, not judged — whether
# "higher" is a regression depends on the metric (rows/s vs p99_ms), so
# each flagged row says which side is higher and the reader applies the
# sign.

#: Flattened-path substrings excluded from the bench diff: host-shape
#: facts and identifiers, not measurements (the names the committed
#: bench artifacts use).
BENCH_DIFF_SKIP = (
    "host_cpus",
    "jax_device_count",
    "schema_version",
)

DEFAULT_BENCH_THRESHOLD = 1.5


def flatten_numeric(obj: Any, prefix: str = "") -> Dict[str, float]:
    """Dotted-path -> value map of every numeric leaf (bools excluded;
    list elements indexed)."""
    out: Dict[str, float] = {}
    if isinstance(obj, bool):
        return out
    if isinstance(obj, (int, float)):
        out[prefix or "value"] = float(obj)
        return out
    if isinstance(obj, dict):
        for k, v in obj.items():
            p = f"{prefix}.{k}" if prefix else str(k)
            out.update(flatten_numeric(v, p))
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            out.update(flatten_numeric(v, f"{prefix}[{i}]"))
    return out


def diff_bench_records(
    rec_a: Dict[str, Any],
    rec_b: Dict[str, Any],
    *,
    threshold: float = DEFAULT_BENCH_THRESHOLD,
) -> Dict[str, Any]:
    """Compare two same-family bench records leaf by leaf.  Returns a
    JSON-safe dict: per-metric ``rows`` (a, b, ratio b/a, symmetric
    movement, flagged, higher side), ``flagged`` sorted worst first,
    one-sided metric lists, and a family note when the records' top
    ``metric`` keys disagree."""
    fam_a, fam_b = rec_a.get("metric"), rec_b.get("metric")
    fa = {
        k: v for k, v in flatten_numeric(rec_a).items()
        if not any(s in k for s in BENCH_DIFF_SKIP)
    }
    fb = {
        k: v for k, v in flatten_numeric(rec_b).items()
        if not any(s in k for s in BENCH_DIFF_SKIP)
    }
    rows: List[Dict[str, Any]] = []
    flagged: List[Dict[str, Any]] = []
    for metric in [k for k in fa if k in fb]:
        a, b = fa[metric], fb[metric]
        ratio = _ratio(b, a)  # b over a: >1 = grew in B
        movement = max(ratio, 1.0 / ratio) if ratio else 1.0
        flag = ratio is not None and movement >= threshold
        row = {
            "metric": metric,
            "a": a,
            "b": b,
            "ratio": None if ratio is None else round(ratio, 4),
            "movement": round(movement, 2),
            "flagged": flag,
            "higher_in": (
                None if ratio is None or ratio == 1.0
                else ("B" if ratio > 1.0 else "A")
            ),
        }
        rows.append(row)
        if flag:
            flagged.append(row)
    flagged.sort(key=lambda r: -r["movement"])
    return {
        "mode": "bench",
        "family_a": fam_a,
        "family_b": fam_b,
        "family_match": (fam_a == fam_b) if (fam_a and fam_b) else None,
        "threshold": threshold,
        "rows": rows,
        "flagged": flagged,
        "only_in_a": [k for k in fa if k not in fb],
        "only_in_b": [k for k in fb if k not in fa],
    }


def format_bench_diff(
    result: Dict[str, Any], label_a: str, label_b: str
) -> str:
    """Human-readable bench-record report (flagged rows only, plus
    one-sided metrics — a full leaf table would be hundreds of lines)."""
    lines = [
        f"bench diff: A={label_a}  B={label_b}",
        f"family A={result['family_a']!r} B={result['family_b']!r}"
        + ("" if result["family_match"] in (True, None)
           else "  (FAMILY MISMATCH)"),
        f"threshold {result['threshold']}x over"
        f" {len(result['rows'])} shared metrics",
    ]
    if result["flagged"]:
        lines.append("")
        lines.append(
            f"{'metric':<48} {'A':>12} {'B':>12} {'move':>6}  higher"
        )
        for r in result["flagged"]:
            lines.append(
                f"{r['metric']:<48} {r['a']:>12.4g} {r['b']:>12.4g}"
                f" {r['movement']:>5.2f}x  {r['higher_in']}"
            )
    else:
        lines.append("flagged: none")
    for side in ("a", "b"):
        only = result[f"only_in_{side}"]
        if only:
            shown = ", ".join(only[:8]) + (" ..." if len(only) > 8 else "")
            lines.append(f"only in {side.upper()}: {shown}")
    return "\n".join(lines)


def diff_bench_files(
    path_a: str,
    path_b: str,
    *,
    threshold: float = DEFAULT_BENCH_THRESHOLD,
) -> Dict[str, Any]:
    """Load two bench artifacts and diff their numeric leaves."""
    with open(path_a) as f:
        rec_a = json.load(f)
    with open(path_b) as f:
        rec_b = json.load(f)
    if not isinstance(rec_a, dict) or not isinstance(rec_b, dict):
        raise ValueError("bench diff needs dict-shaped artifacts")
    return diff_bench_records(rec_a, rec_b, threshold=threshold)
