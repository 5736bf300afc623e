"""CLI for the port's static analysis suite (port of
``csvplus_tpu/analysis/__main__.py``).

``python -m csvplus_tpu_torch.analysis [paths...]``
    AST lint; with no paths it walks the INSTALLED PACKAGE TREE (resolved
    from the package itself, not the cwd), so a newly added module can
    never bypass the gate.  Prints ``path:line: CODE message`` per
    finding; exit 1 when any finding survives suppression.

``python -m csvplus_tpu_torch.analysis --json [--snapshot FILE] [--device D]``
    Machine-readable payload (lint findings + per-plan analysis over the
    example chains, the reference's schema 3).  ``--snapshot`` compares
    the payload against a committed file and exits 3 on drift;
    ``--write-snapshot FILE`` regenerates it.

``python -m csvplus_tpu_torch.analysis explain [name...] [--json] [--list] [--device D]``
    The per-node provenance/cost/placement tables, ranked join orders,
    the join-operator and fusion comparisons and the rewrite decision for
    the named example chains (all of them with no names; ``--list``
    prints the names).  Unknown names exit 2.

``python -m csvplus_tpu_torch.analysis lint [--json] [paths...]``
    The bare lint, with a ``--json`` mode that prints only the findings.

``python -m csvplus_tpu_torch.analysis env [--write FILE]``
    Render the port's environment-variable registry (``utils/env.py``) as
    ``docs/ENV_TORCH.md``; ``--write`` regenerates the committed file the
    ENV001-R lint checks for drift.

``python -m csvplus_tpu_torch.analysis plan-cert [--json] [--device D]``
    Certify the plan space up to ``CSVPLUS_PLANCERT_N``
    (:mod:`.plancert`).  Exit 1 if any obligation fails or the budget is
    exceeded.

``--device`` (default ``cuda``) places the tables of the modes that build
them (``--json``, ``--snapshot``, ``--write-snapshot``, ``explain``,
``plan-cert``); ``cuda`` with no card raises, nothing runs on the CPU
unless asked.
"""

from __future__ import annotations

import json
import sys


def _pop_device(args) -> str:
    if "--device" in args:
        i = args.index("--device")
        device = args[i + 1]
        del args[i : i + 2]
        return device
    return "cuda"


def _explain(args) -> int:
    device = _pop_device(args)
    as_json = "--json" in args
    if as_json:
        args.remove("--json")
    list_only = "--list" in args
    if list_only:
        args.remove("--list")

    from .report import example_plans, explain_text, plan_analysis_json

    plans = example_plans(device)
    if list_only:
        for name in sorted(plans):
            print(name)
        return 0
    names = args or sorted(plans)
    unknown = [n for n in names if n not in plans]
    if unknown:
        print(
            f"unknown plan(s): {', '.join(unknown)} — known: "
            f"{', '.join(sorted(plans))}",
            file=sys.stderr,
        )
        return 2
    payload = {}
    blocks = []
    for name in names:
        p = plans[name]
        if isinstance(p, str):
            payload[name] = {"skipped": p}
            blocks.append(f"explain: {name}\n{p}")
        else:
            payload[name] = plan_analysis_json(p)
            blocks.append(explain_text(name, p))
    if as_json:
        print(json.dumps(payload, indent=2, sort_keys=True))
    else:
        print("\n\n".join(blocks))
    return 0


def _print_lint(paths) -> int:
    from .astlint import lint_paths
    from .report import default_lint_paths

    findings = lint_paths(
        paths if paths is not None else default_lint_paths(),
        global_checks=paths is None,
    )
    for f in findings:
        print(f)
    if findings:
        print(f"{len(findings)} finding(s)", file=sys.stderr)
    return 1 if findings else 0


def _lint(args, as_json: bool) -> int:
    paths = args or None
    if as_json:
        from .report import lint_json

        findings = lint_json(paths)
        print(json.dumps(findings, indent=2, sort_keys=True))
        return 1 if findings else 0
    return _print_lint(paths)


def _env(args) -> int:
    from ..utils.env import render_env_md

    text = render_env_md()
    if "--write" in args:
        i = args.index("--write")
        target = args[i + 1]
        with open(target, "w", encoding="utf-8") as fh:
            fh.write(text)
        print(f"wrote {target}", file=sys.stderr)
        return 0
    print(text, end="")
    return 0


def _plan_cert(args) -> int:
    device = _pop_device(args)
    from .plancert import certify, summary_json

    summary = certify(device=device)
    if "--json" in args:
        print(json.dumps(summary_json(summary), indent=2, sort_keys=True))
    else:
        print(summary.describe())
    return 0 if summary.ok else 1


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if args and args[0] == "explain":
        return _explain(args[1:])
    if args and args[0] == "lint":
        rest = args[1:]
        as_json = "--json" in rest
        if as_json:
            rest.remove("--json")
        return _lint(rest, as_json)
    if args and args[0] == "env":
        return _env(args[1:])
    if args and args[0] == "plan-cert":
        return _plan_cert(args[1:])
    device = _pop_device(args)
    as_json = "--json" in args
    if as_json:
        args.remove("--json")
    snapshot = write_snapshot = None
    if "--snapshot" in args:
        i = args.index("--snapshot")
        snapshot = args[i + 1]
        del args[i : i + 2]
    if "--write-snapshot" in args:
        i = args.index("--write-snapshot")
        write_snapshot = args[i + 1]
        del args[i : i + 2]
    paths = args or None

    if not (as_json or snapshot or write_snapshot):
        return _print_lint(paths)

    from .report import json_payload

    payload = json_payload(paths, device=device)
    text = json.dumps(payload, indent=2, sort_keys=True)
    if write_snapshot:
        with open(write_snapshot, "w", encoding="utf-8") as fh:
            fh.write(text + "\n")
        print(f"wrote {write_snapshot}", file=sys.stderr)
    if as_json:
        print(text)
    rc = 1 if payload["lint"] else 0
    if snapshot:
        with open(snapshot, "r", encoding="utf-8") as fh:
            expected = json.load(fh)
        if expected != payload:
            print(
                f"analysis payload drifted from {snapshot} — review and "
                "regenerate with --write-snapshot",
                file=sys.stderr,
            )
            return 3
        print(f"payload matches {snapshot}", file=sys.stderr)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
