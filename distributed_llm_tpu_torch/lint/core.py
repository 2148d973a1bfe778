"""dllm-lint core: project loading, suppressions, checker protocol.

The framework is deliberately stdlib-only (no torch, no JAX): the test
suite runs it on CPU boxes, and the AST passes must not pay (or depend
on) an accelerator-stack import.  A checker receives the whole ``Project``
(parsed modules keyed by repo-relative path) and returns ``Finding``s;
the runner applies suppression comments and the mandatory-justification
policy uniformly.

Suppression grammar (grep-able, justification REQUIRED)::

    something_flagged()   # dllm-lint: disable=<rule>[,<rule>] -- why

    # dllm-lint: disable-file=<rule> -- why          (file-scoped, any line)

A ``disable`` comment suppresses matching findings on its own line and,
when it stands alone on a line, on the next line (for statements too
long to share a line with their justification).  A suppression without
the ``-- <justification>`` tail is itself a finding
(``suppression-missing-justification``) — the whole point is that every
silenced rule carries its reviewable why inline.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
import tokenize
from io import StringIO
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

SUPPRESS_RE = re.compile(
    r"#\s*dllm-lint:\s*(disable|disable-file)=([A-Za-z0-9_,\-]+)"
    r"(?:\s*--\s*(\S.*))?")

# ``def _loop(self):  # dllm-lint: hot-path`` (same line or the line
# above the def) marks a function as a host-transfer-discipline root:
# the transfer checker flags device syncs/round-trips in everything the
# function transitively calls, project-wide.
HOT_PATH_RE = re.compile(r"#\s*dllm-lint:\s*hot-path\b")

JUSTIFICATION_RULE = "suppression-missing-justification"
PARSE_RULE = "parse-error"


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str            # repo-relative
    line: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


class Suppressions:
    """Parsed suppression comments for one module."""

    def __init__(self) -> None:
        self.by_line: Dict[int, set] = {}     # line -> {rules}
        self.file_level: set = set()
        self.malformed: List[Tuple[int, str]] = []   # (line, rules-text)
        self.hot_path_lines: set = set()      # '# dllm-lint: hot-path'

    @classmethod
    def parse(cls, source: str) -> "Suppressions":
        sup = cls()
        # tokenize (not a line regex) so a '#' inside a string literal
        # can never read as a suppression comment.
        try:
            tokens = list(tokenize.generate_tokens(StringIO(source).readline))
        except (tokenize.TokenError, IndentationError, SyntaxError):
            tokens = []
        comment_only_lines = set()
        code_lines = set()
        for tok in tokens:
            if tok.type == tokenize.COMMENT:
                continue
            if tok.type in (tokenize.NL, tokenize.NEWLINE, tokenize.INDENT,
                            tokenize.DEDENT, tokenize.ENDMARKER):
                continue
            code_lines.add(tok.start[0])
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            if HOT_PATH_RE.search(tok.string):
                sup.hot_path_lines.add(tok.start[0])
            m = SUPPRESS_RE.search(tok.string)
            if not m:
                continue
            kind, rules_text, justification = m.groups()
            line = tok.start[0]
            if line not in code_lines:
                comment_only_lines.add(line)
            if not justification:
                sup.malformed.append((line, rules_text))
                continue
            rules = {r.strip() for r in rules_text.split(",") if r.strip()}
            if kind == "disable-file":
                sup.file_level |= rules
            else:
                sup.by_line.setdefault(line, set()).update(rules)
                if line in comment_only_lines:
                    # Standalone comment: also covers the next line.
                    sup.by_line.setdefault(line + 1, set()).update(rules)
        return sup

    def covers(self, rule: str, line: int) -> bool:
        if rule in self.file_level:
            return True
        return rule in self.by_line.get(line, set())


class Module:
    """One parsed source file."""

    def __init__(self, relpath: str, source: str):
        self.relpath = relpath
        self.source = source
        self.lines = source.splitlines()
        self.parse_error: Optional[str] = None
        try:
            self.tree: Optional[ast.Module] = ast.parse(source,
                                                        filename=relpath)
        except SyntaxError as exc:
            self.tree = None
            self.parse_error = str(exc)
        self.suppressions = Suppressions.parse(source)


class Project:
    """The module set a lint run sees, keyed by repo-relative path.

    ``complete`` records whether the FULL default target set was loaded:
    absence-of-a-reader checks (config-env-stale) are only meaningful
    then — a narrowed run (``lint distributed_llm_tpu_torch/serving``) must
    not report every knob it didn't load as dead.
    """

    def __init__(self, root: str, modules: Dict[str, Module],
                 complete: bool = True):
        self.root = root
        self.modules = modules
        self.complete = complete

    def in_dirs(self, prefixes: Sequence[str]) -> List[Module]:
        """Modules whose relpath starts with any prefix (or equals a file
        prefix exactly); prefixes use '/' separators."""
        out = []
        for rel, mod in sorted(self.modules.items()):
            for p in prefixes:
                if rel == p or rel.startswith(p.rstrip("/") + "/"):
                    out.append(mod)
                    break
        return out

    def get(self, relpath: str) -> Optional[Module]:
        return self.modules.get(relpath)


# Everything the repo-wide run parses: the port's package (its bench
# lives inside it).  tests/ stays out: fixture snippets deliberately
# contain known-bad code.
DEFAULT_TARGETS: Tuple[str, ...] = (
    "distributed_llm_tpu_torch",
)

_SKIP_DIRS = {"__pycache__", ".git", "node_modules", ".claude"}


def load_project(root: str,
                 targets: Optional[Sequence[str]] = None) -> Project:
    complete = not targets or list(targets) == list(DEFAULT_TARGETS)
    targets = list(targets) if targets else list(DEFAULT_TARGETS)
    modules: Dict[str, Module] = {}

    def add_file(abspath: str) -> bool:
        """True if the file is (now or already) part of the project."""
        rel = os.path.relpath(abspath, root).replace(os.sep, "/")
        if rel in modules:
            return True
        try:
            with open(abspath, encoding="utf-8") as f:
                modules[rel] = Module(rel, f.read())
        except OSError:
            return False
        return True

    for target in targets:
        abspath = os.path.join(root, target)
        matched = False
        if os.path.isfile(abspath) and abspath.endswith(".py"):
            matched = add_file(abspath)
        else:
            for dirpath, dirnames, filenames in os.walk(abspath):
                dirnames[:] = [d for d in dirnames if d not in _SKIP_DIRS]
                for fname in sorted(filenames):
                    if fname.endswith(".py"):
                        matched |= add_file(os.path.join(dirpath, fname))
        # A target that matched no Python files is a usage error, not a
        # clean run: a typo'd or renamed-away path in CI would otherwise
        # lint nothing and pass forever.
        if not matched:
            raise FileNotFoundError(
                f"lint target {target!r} matched no Python files "
                f"under {root}")
    return Project(root, modules, complete=complete)


class Checker:
    """Plugin API: subclass, set ``name``/``rules``, implement check().

    ``scope`` is the path-prefix set the checker examines; the runner
    passes the full project so cross-module checkers (locks, drift) can
    still see everything.

    ``whole_project`` marks checkers whose verdicts depend on the whole
    call graph or registry, not just the file a finding lands in: a
    ``--changed`` (git-diff-scoped) run auto-widens these to full
    reporting, because an edit in one file can create or cure a finding
    in another (cross-module blocking-under-lock, a knob losing its
    last reader, a hot-path callee growing a sync).
    """

    name: str = ""
    rules: Tuple[str, ...] = ()
    scope: Tuple[str, ...] = ("distributed_llm_tpu_torch",)
    whole_project: bool = False

    def check(self, project: Project) -> List[Finding]:  # pragma: no cover
        raise NotImplementedError


@dataclasses.dataclass
class LintResult:
    findings: List[Finding]              # unsuppressed (the failures)
    suppressed: List[Tuple[Finding, str]]   # (finding, "line"|"file")

    @property
    def ok(self) -> bool:
        return not self.findings


def run_checkers(project: Project, checkers: Iterable[Checker],
                 rules: Optional[Sequence[str]] = None) -> LintResult:
    raw: List[Finding] = []
    for checker in checkers:
        raw.extend(checker.check(project))
    if rules:
        wanted = set(rules)
        raw = [f for f in raw if f.rule in wanted]

    # Policy findings from the suppression machinery itself: a
    # suppression without justification, anywhere in the project.
    for rel, mod in sorted(project.modules.items()):
        for line, rules_text in mod.suppressions.malformed:
            raw.append(Finding(
                JUSTIFICATION_RULE, rel, line,
                f"suppression for '{rules_text}' has no justification — "
                f"append ' -- <why>'"))
        if mod.parse_error is not None:
            raw.append(Finding(PARSE_RULE, rel, 1,
                               f"failed to parse: {mod.parse_error}"))

    findings: List[Finding] = []
    suppressed: List[Tuple[Finding, str]] = []
    for f in sorted(raw, key=lambda f: (f.path, f.line, f.rule)):
        mod = project.get(f.path)
        if (mod is not None and f.rule != JUSTIFICATION_RULE
                and mod.suppressions.covers(f.rule, f.line)):
            kind = ("file" if f.rule in mod.suppressions.file_level
                    else "line")
            suppressed.append((f, kind))
        else:
            findings.append(f)
    return LintResult(findings=findings, suppressed=suppressed)


def filter_changed(result: LintResult, changed: Iterable[str],
                   checkers: Iterable[Checker]) -> LintResult:
    """The ``--changed`` reporting filter: keep findings that land in a
    changed file, plus EVERY finding of a ``whole_project`` checker —
    those analyses already ran over the full project (a narrowed load
    would be unsound for them), and their findings can be caused by a
    changed file while landing in an unchanged one.  Parse errors and
    naked suppressions are never filtered either: a module that fails
    to parse is invisible to every whole-project analysis, so hiding
    its finding would report a green the graph checkers cannot back."""
    changed_set = set(changed)
    wide_rules = {r for c in checkers if c.whole_project for r in c.rules}
    wide_rules |= {PARSE_RULE, JUSTIFICATION_RULE}
    keep = [f for f in result.findings
            if f.path in changed_set or f.rule in wide_rules]
    return LintResult(findings=keep, suppressed=result.suppressed)


def repo_root() -> str:
    """The repo checkout this package sits in."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
