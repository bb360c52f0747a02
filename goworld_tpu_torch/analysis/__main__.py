"""CLI entry point: ``python -m goworld_tpu_torch.analysis <paths>``.

Exit status: 0 clean, 1 findings, 2 configuration error (unparseable
suppression file, no inputs, bad --changed-only ref).  Default output is
``path:line:col: [rule] message`` so editors annotate directly; see
``--format`` for json / SARIF / GitHub workflow commands.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from .core import find_repo_root, run

_SARIF_VERSION = "2.1.0"
_SARIF_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
                 "master/Schemata/sarif-schema-2.1.0.json")


def _changed_files(ref: str, root: str) -> set[str] | None:
    """Repo-relative .py paths changed vs ``ref`` (plus untracked ones).

    Returns None when git can't resolve the ref -- a config error, not an
    empty filter (silently scanning nothing would hide findings).
    """
    def _git(*args: str) -> list[str] | None:
        try:
            out = subprocess.run(
                ["git", *args], cwd=root, capture_output=True, text=True,
                timeout=30)
        except (OSError, subprocess.TimeoutExpired):
            return None
        if out.returncode != 0:
            return None
        return out.stdout.splitlines()

    diff = _git("diff", "--name-only", ref, "--", "*.py")
    if diff is None:
        return None
    untracked = _git("ls-files", "--others", "--exclude-standard", "--",
                     "*.py") or []
    return {p.strip() for p in diff + untracked if p.strip()}


def _emit_json(findings) -> str:
    return json.dumps(
        [{"rule": f.rule, "path": f.path, "line": f.line, "col": f.col,
          "symbol": f.symbol, "message": f.message} for f in findings],
        indent=2)


def _emit_sarif(findings) -> str:
    from . import RULES
    doc = {
        "$schema": _SARIF_SCHEMA,
        "version": _SARIF_VERSION,
        "runs": [{
            "tool": {"driver": {
                "name": "gwlint",
                "informationUri":
                    "goworld_tpu_torch/analysis/__init__.py",
                "rules": [{"id": name} for name in RULES],
            }},
            "results": [{
                "ruleId": f.rule,
                "level": "error",
                "message": {"text": f.message},
                "locations": [{"physicalLocation": {
                    "artifactLocation": {"uri": f.path},
                    "region": {"startLine": f.line,
                               "startColumn": max(f.col, 1)},
                }}],
            } for f in findings],
        }],
    }
    return json.dumps(doc, indent=2)


def _emit_github(findings) -> str:
    # GitHub workflow commands: the Actions runner turns these lines into
    # inline PR annotations with no extra upload step.
    lines = []
    for f in findings:
        lines.append(
            f"::error file={f.path},line={f.line},col={max(f.col, 1)},"
            f"title=gwlint {f.rule}::[{f.rule}] {f.message}")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="gwlint",
        description="goworld_tpu_torch repo-specific static analysis")
    ap.add_argument("paths", nargs="+",
                    help="files or directories to scan")
    ap.add_argument("--root", default=None,
                    help="repo root (default: auto-detected from paths)")
    ap.add_argument("--tests-dir", default=None,
                    help="tests directory whose test_torch_*.py the "
                         "coverage rules read (default: <root>/tests)")
    ap.add_argument("--suppressions", default=None,
                    help="suppression file (default: the port's "
                         "goworld_tpu_torch/analysis/suppressions.txt)")
    ap.add_argument("--profile", action="store_true",
                    help="print per-rule wall time and the parse ledger "
                         "to stderr")
    ap.add_argument("--changed-only", metavar="GIT_REF", default=None,
                    help="report findings only in .py files changed vs "
                         "GIT_REF (whole-program rules still scan the "
                         "full tree)")
    ap.add_argument("--format", choices=("text", "json", "sarif", "github"),
                    default="text",
                    help="findings output format (default: text)")
    args = ap.parse_args(argv)

    root = args.root or find_repo_root(args.paths[0])
    only_files = None
    if args.changed_only is not None:
        only_files = _changed_files(args.changed_only, root)
        if only_files is None:
            print(f"gwlint: config error: cannot resolve git ref "
                  f"{args.changed_only!r} under {root}", file=sys.stderr)
            return 2

    profile: dict | None = {} if args.profile else None
    findings, config_errors = run(
        args.paths, root=root, tests_dir=args.tests_dir,
        suppressions=args.suppressions, profile=profile,
        only_files=only_files)

    for err in config_errors:
        print(f"gwlint: config error: {err}", file=sys.stderr)

    if args.format == "json":
        print(_emit_json(findings))
    elif args.format == "sarif":
        print(_emit_sarif(findings))
    elif args.format == "github":
        out = _emit_github(findings)
        if out:
            print(out)
    else:
        for f in findings:
            print(f.render())

    if profile is not None:
        width = max((len(name) for name, _t in profile.get("rules", [])),
                    default=0)
        for name, secs in sorted(profile.get("rules", []),
                                 key=lambda r: -r[1]):
            print(f"gwlint: profile: {name:<{width}} {secs * 1e3:8.2f} ms",
                  file=sys.stderr)
        print(f"gwlint: profile: {profile.get('files', 0)} files, "
              f"{profile.get('parses', 0)} parses "
              f"(parse-once: {'yes' if profile.get('parses') == profile.get('files') else 'NO'})",
              file=sys.stderr)

    if config_errors:
        return 2
    if findings:
        print(f"gwlint: {len(findings)} finding(s)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
