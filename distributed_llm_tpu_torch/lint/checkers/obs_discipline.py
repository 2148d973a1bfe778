"""Observability-feed discipline: the SLO monitor has ONE feed site,
and profiler stamps never run inside a captured body.

Rule ``slo-feed-outside-finish``: ``SLOMonitor.record_request``
(obs/slo.py) counts a finished request into the sliding goodput
windows.  Its correctness contract is exactly-once-per-request, which
the serving stack gets structurally by feeding it ONLY from
``Router._finish_request`` — the single exit that already runs exactly
once on every path of both pipelines (sync, stream, exception).  A
second feed site anywhere in serving/ or engine/ would double-count
requests, halve every goodput reading, and fire phantom overload
incidents — and nothing at runtime would look obviously wrong.
Matching is receiver-chain-based (the chain must contain a ``slo``
segment), so an unrelated object's ``record_request`` method does not
false-positive.

Rule ``profiler-hook-in-captured-code`` (JAX's
``profiler-hook-in-traced-code``): the tick-phase profiler
(obs/profiler.py) stamps ``perf_counter`` around device-call seams ON
THE HOST.  A profiler call inside a body captured into a CUDA graph runs
once, at capture: no replay is ever timed, and every phase table built
from it is silently skewed.  Any call on a receiver chain containing a
``profiler``/``prof`` segment is flagged when it sits in the
PROJECT-WIDE captured closure (``symbols.captured_closure``, the set
capture purity and recapture reason over), in a captured lambda or in a
``with torch.cuda.graph(...)`` block, anywhere in the package.
Deliberate limits, same conservatism as the call graph: a profiler
object reached through a differently-named local (``p = self.profiler;
p.phase(...)``) is not matched (the idiom is always the attribute
chain), and only bodies the closure can prove captured are checked, so
the rule adds no false findings.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional

from ..core import Checker, Finding, Project
from ..symbols import capture_roots_for, project_symbols

FEED_ATTR = "record_request"
ALLOWED_FUNC = "_finish_request"

# Receiver-chain segments that mark a tick-profiler stamp.  "prof" is
# included for the conventional local name in helper signatures
# (obs/profiler.py's own docs use it); anything else is a deliberate
# limit documented above.
PROFILER_SEGMENTS = {"profiler", "prof"}


def _chain(node: ast.expr) -> List[str]:
    """Attribute-chain segments of a receiver, innermost-last
    (``self.obs.slo`` -> ["slo", "obs", "self"])."""
    out: List[str] = []
    while isinstance(node, ast.Attribute):
        out.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        out.append(node.id)
    return out


def _is_slo_feed(call: ast.Call) -> bool:
    fn = call.func
    if not (isinstance(fn, ast.Attribute) and fn.attr == FEED_ATTR):
        return False
    return "slo" in _chain(fn.value)


def _is_profiler_call(call: ast.Call) -> bool:
    fn = call.func
    if not isinstance(fn, ast.Attribute):
        return False
    return bool(PROFILER_SEGMENTS & set(_chain(fn.value)))


def _own_nodes(node: ast.AST) -> Iterable[ast.AST]:
    """Walk a function body WITHOUT descending into nested def/async
    def (each is its own call-graph function and, when traced, its own
    closure member — descending would double-report).  Lambdas ARE
    walked: they are not separate graph nodes, so this is their only
    chance to be seen."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        child = stack.pop()
        yield child
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        stack.extend(ast.iter_child_nodes(child))


class ObsDisciplineChecker(Checker):
    """The per-file rule (``slo-feed-outside-finish``): its verdict
    depends only on the file a finding lands in, so ``--changed`` may
    filter it to changed files.  The traced-closure profiler rule lives
    in its own whole-project checker below — folding it in here would
    widen THIS rule's reporting too and break the changed-files-only
    contract."""

    name = "obs_discipline"
    rules = ("slo-feed-outside-finish",)
    scope = ("distributed_llm_tpu_torch/serving", "distributed_llm_tpu_torch/engine")

    def check(self, project: Project) -> List[Finding]:
        findings: List[Finding] = []
        for mod in project.in_dirs(self.scope):
            if mod.tree is None:
                continue
            self._visit(mod.tree, None, mod.relpath, findings)
        return findings

    # -- slo-feed-outside-finish -------------------------------------------

    def _visit(self, node: ast.AST, func: Optional[str], path: str,
               findings: List[Finding]) -> None:
        for child in ast.iter_child_nodes(node):
            child_func = func
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                child_func = child.name
            elif isinstance(child, ast.Lambda):
                # A lambda inherits its enclosing function's identity: a
                # feed hidden in a callback defined INSIDE
                # _finish_request is still the sanctioned site.
                child_func = func
            if (isinstance(child, ast.Call) and _is_slo_feed(child)
                    and func != ALLOWED_FUNC):
                findings.append(Finding(
                    "slo-feed-outside-finish", path, child.lineno,
                    f"SLO feed `slo.{FEED_ATTR}(...)` outside "
                    f"`{ALLOWED_FUNC}` — the goodput windows count "
                    f"requests exactly once, on the router's single "
                    f"completion exit; a second feed site double-counts"))
            self._visit(child, child_func, path, findings)


class ProfilerDisciplineChecker(Checker):
    """``profiler-hook-in-captured-code``, as its own checker: the
    captured closure crosses modules (a body in engine/ reaches helpers
    in models/ and ops/), so an edit in one file can create a finding in
    another -- ``whole_project`` widens it under ``--changed``.  Kept
    separate from ObsDisciplineChecker so that widening does not leak
    onto the per-file slo-feed rule."""

    name = "profiler_discipline"
    rules = ("profiler-hook-in-captured-code",)
    scope = ("distributed_llm_tpu_torch",)
    whole_project = True

    def check(self, project: Project) -> List[Finding]:
        findings: List[Finding] = []
        ps = project_symbols(project)
        sites = [(gf.relpath, gf.qualname, gf.info.node)
                 for gf in (ps.functions[g]
                            for g in sorted(ps.captured_closure()))]
        for rel in sorted(ps.mods):
            cap = capture_roots_for(project.get(rel), ps.mods[rel])
            sites += [(rel, "<lambda>", lam) for lam in cap.lambdas]
            sites += [(rel, "a torch.cuda.graph block", block)
                      for _scope, block in cap.blocks]
        for rel, where, root in sites:
            for node in _own_nodes(root):
                if isinstance(node, ast.Call) and _is_profiler_call(node):
                    findings.append(Finding(
                        "profiler-hook-in-captured-code", rel, node.lineno,
                        f"profiler stamp inside a captured body "
                        f"(`{where}`): perf_counter runs once, at "
                        f"capture, and no replay is timed -- stamp "
                        f"around the replay on the host side instead"))
        return findings
