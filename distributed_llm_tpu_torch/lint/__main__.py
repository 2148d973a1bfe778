"""CLI: ``python -m distributed_llm_tpu_torch.lint [targets...] [options]``.

Exit 0 = zero unsuppressed findings; 1 = findings; 2 = usage error.
Runs without torch or JAX (pure AST passes), so it is safe on any CPU
box and cheap enough for the test suite and pre-commit hooks.

``--changed [REF]`` scopes REPORTING to files changed vs the git ref
REF (default HEAD: working tree + index) plus untracked files; the port
reads no environment knob, so the ref is an argument.  The ANALYSIS
still loads the full project — the call-graph checkers are only sound
over the whole graph — and whole-project checkers (locks, recapture,
transfer, thread_lifecycle, config_drift, ...) auto-widen to full
reporting, because an edit in one file can create a finding in another.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

from . import all_checkers, run_lint
from .core import filter_changed, repo_root


def _git_changed_files(root: str, base: str):
    """Changed + untracked .py files, repo-relative with '/' seps.
    Returns None when git itself is unusable (not a repo, no base)."""
    def run(*args):
        return subprocess.run(
            ["git", *args], cwd=root, capture_output=True, text=True,
            timeout=30)

    try:
        diff = run("diff", "--name-only", base, "--")
        if diff.returncode != 0:
            return None
        untracked = run("ls-files", "--others", "--exclude-standard")
    except (OSError, subprocess.SubprocessError):
        # No git binary / hung git: unusable, same as a failed diff.
        return None
    names = diff.stdout.splitlines()
    if untracked.returncode == 0:
        names += untracked.stdout.splitlines()
    return sorted({n.strip() for n in names
                   if n.strip().endswith(".py")})


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m distributed_llm_tpu_torch.lint",
        description="dllm-lint: repo static-analysis suite")
    parser.add_argument("targets", nargs="*",
                        help="files/dirs relative to the repo root "
                             "(default: the standard project set)")
    parser.add_argument("--rule", action="append", dest="rules",
                        metavar="RULE",
                        help="only report these rule ids (repeatable)")
    parser.add_argument("--changed", nargs="?", const="HEAD",
                        default=None, metavar="REF",
                        help="report only findings in files changed vs "
                             "the git REF (default HEAD); whole-project "
                             "checkers still report everywhere")
    parser.add_argument("--list-rules", action="store_true",
                        help="list checkers and rule ids, then exit")
    parser.add_argument("--show-suppressed", action="store_true",
                        help="also print suppressed findings")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="machine-readable output: a JSON object "
                             "with a stable per-finding schema (rule, "
                             "path, line, message, suppressed) so CI "
                             "and bench tooling can diff finding sets "
                             "across rounds; exit codes unchanged")
    args = parser.parse_args(argv)

    if args.list_rules:
        for checker in all_checkers():
            print(f"{checker.name}:"
                  + (" [whole-project]" if checker.whole_project else ""))
            for rule in checker.rules:
                print(f"  {rule}")
            print(f"  scope: {', '.join(checker.scope)}")
        return 0

    changed = None
    if args.changed is not None:
        if args.targets:
            print("dllm-lint: --changed and explicit targets are "
                  "mutually exclusive", file=sys.stderr)
            return 2
        base = args.changed
        changed = _git_changed_files(repo_root(), base)
        if changed is None:
            print(f"dllm-lint: git diff against {base!r} failed — "
                  f"running the full project instead", file=sys.stderr)
        elif not changed:
            print(f"dllm-lint: no Python files changed vs {base} — "
                  f"nothing to lint")
            return 0

    try:
        # --changed still LOADS the full project: graph soundness.
        result = run_lint(targets=args.targets or None, rules=args.rules)
    except FileNotFoundError as exc:
        print(f"dllm-lint: {exc}", file=sys.stderr)
        return 2
    if changed:
        result = filter_changed(result, changed, all_checkers())
    if args.as_json:
        # Stable schema — additions only, never renames: tooling diffs
        # finding sets across lint versions.  Suppressed findings are
        # ALWAYS included (flagged), so a suppression shows up in the
        # diff the same round it lands.
        payload = {
            "findings": [
                {"rule": f.rule, "path": f.path, "line": f.line,
                 "message": f.message, "suppressed": False}
                for f in result.findings
            ] + [
                {"rule": f.rule, "path": f.path, "line": f.line,
                 "message": f.message, "suppressed": True}
                for f, _kind in result.suppressed
            ],
            "counts": {"findings": len(result.findings),
                       "suppressed": len(result.suppressed)},
            "ok": result.ok,
        }
        json.dump(payload, sys.stdout, indent=2, sort_keys=True)
        sys.stdout.write("\n")
        return 0 if result.ok else 1
    for finding in result.findings:
        print(finding.render())
    if args.show_suppressed:
        for finding, kind in result.suppressed:
            print(f"[suppressed:{kind}] {finding.render()}")
    n, s = len(result.findings), len(result.suppressed)
    mode = f" ({len(changed)} changed file(s))" if changed else ""
    print(f"dllm-lint: {n} finding(s), {s} suppressed{mode}")
    return 0 if result.ok else 1


if __name__ == "__main__":
    sys.exit(main())
