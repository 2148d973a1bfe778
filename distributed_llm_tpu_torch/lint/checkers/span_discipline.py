"""Span-discipline checker — every span enter has a structural exit.

Every span ENTER must have a matching EXIT on every return/raise path.
obs/spans.py makes that structural — spans are context managers — so the
discipline reduces to two statically checkable rules for the
instrumented layers (serving/, engine/):

- ``span-not-with``: every call to a ``span(...)`` factory (``trace.span``,
  ``parent.span``, ``spans.span``) and to the PhaseTimer's ``phase(...)``
  must appear ONLY as a ``with``-statement context item — a bare call
  would open a span whose exit depends on later code reaching it.  A
  function that RETURNS such a call (the batched engine's ``_stamp``
  and ``_tick_phase``, which return a phase or a null context) hands
  the span to its caller and becomes a factory of the module: its own
  calls must then be ``with`` items.
- ``span-manual-enter``: manual enter APIs (``start_span`` /
  ``begin_span`` / explicit ``__enter__``) are forbidden outside obs/
  itself; long-lived work that cannot be ``with``-scoped uses the token
  timeline / completion-callback pattern instead (obs/spans.py).

``check_source`` / ``check_tree`` keep the JAX lint's string-list API
for one module's source or the instrumented layers.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Set

from ..core import Checker, Finding, Module, Project
from ..symbols import call_name as _call_name

# Context-manager factories that MUST be with-items.
WITH_ONLY = {"span", "phase"}
# Manual-enter APIs that must not appear at all in instrumented layers.
FORBIDDEN = {"start_span", "begin_span", "__enter__"}


def _delegated(tree: ast.Module, with_only: Set[str]) -> Dict[int, str]:
    """``return <factory>(...)`` sites: id(call) -> the function that
    returns it.  Such a function hands its span to its caller's ``with``
    (the port's ``_stamp``, which returns a profiler phase or a null
    context), so it is a with-only factory itself."""
    out: Dict[int, str] = {}
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        stack = list(fn.body)
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue
            stack.extend(ast.iter_child_nodes(node))
            if (isinstance(node, ast.Return)
                    and isinstance(node.value, ast.Call)
                    and _call_name(node.value) in with_only):
                out[id(node.value)] = fn.name
    return out


def _findings_for_tree(tree: ast.Module, path: str) -> List[Finding]:
    with_items = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                if isinstance(item.context_expr, ast.Call):
                    with_items.add(id(item.context_expr))
    with_only = set(WITH_ONLY)
    while True:                 # a factory of a factory is one too
        delegated = _delegated(tree, with_only)
        grown = with_only | set(delegated.values())
        if grown == with_only:
            break
        with_only = grown

    out: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = _call_name(node)
        if name in FORBIDDEN:
            out.append(Finding(
                "span-manual-enter", path, node.lineno,
                f"manual span enter `{name}(...)` — use "
                f"`with ....span(...)` so the exit is structural"))
        elif (name in with_only and id(node) not in with_items
              and id(node) not in delegated):
            out.append(Finding(
                "span-not-with", path, node.lineno,
                f"`{name}(...)` called outside a `with` item — the "
                f"span/phase would have no guaranteed exit on "
                f"raise/return paths"))
    return out


class SpanDisciplineChecker(Checker):
    name = "span_discipline"
    rules = ("span-not-with", "span-manual-enter")
    scope = ("distributed_llm_tpu_torch/serving", "distributed_llm_tpu_torch/engine")

    def check(self, project: Project) -> List[Finding]:
        findings: List[Finding] = []
        for mod in project.in_dirs(self.scope):
            if mod.tree is None:
                continue
            findings.extend(_findings_for_tree(mod.tree, mod.relpath))
        return findings


# -- legacy string-list API (tests/test_obs.py's back-compat pin) ------------

def check_source(src: str, path: str = "<string>") -> List[str]:
    """Violation strings for one module's source (empty = clean).
    Honors the framework's suppression comments, so the shim and the
    checker agree on what "clean" means."""
    mod = Module(path, src)
    if mod.tree is None:
        return [f"{path}: failed to parse: {mod.parse_error}"]
    return [f"{f.path}:{f.line}: {f.message}"
            for f in _findings_for_tree(mod.tree, path)
            if not mod.suppressions.covers(f.rule, f.line)]


def check_tree(dirs=None) -> List[str]:
    """Violation strings over the instrumented layers (legacy surface)."""
    from ..core import repo_root
    root = repo_root()
    if dirs is None:
        dirs = (os.path.join(root, "distributed_llm_tpu_torch", "serving"),
                os.path.join(root, "distributed_llm_tpu_torch", "engine"))
    out: List[str] = []
    for root_dir in dirs:
        for dirpath, _dirnames, filenames in os.walk(root_dir):
            if "__pycache__" in dirpath:
                continue
            for fname in sorted(filenames):
                if not fname.endswith(".py"):
                    continue
                path = os.path.join(dirpath, fname)
                with open(path, encoding="utf-8") as f:
                    out.extend(check_source(f.read(),
                                            os.path.relpath(path, root)))
    return out
