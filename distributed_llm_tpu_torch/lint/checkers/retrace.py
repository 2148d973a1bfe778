"""Recapture hazards: a CUDA graph captured more often than its program.

The port's counterpart of the JAX package's ``retrace`` checker
(``distributed_llm_tpu/lint/checkers/retrace.py``).  On the card a
capture is the port's compile: an engine builds each program once
(``_built``: one graph per program key and rung, kept in
``self._programs``) and replays it on every tick.  A capture on a path
that runs per request or per tick stalls every active slot for the
capture's length and grows the graph pool without bound, and nothing
errors: throughput just sags.

A capture is ``capture_program(...)``, ``TickProgram(...)`` given a
graph, ``self._capture(...)``, ``torch.cuda.CUDAGraph()`` or ``with
torch.cuda.graph(...)`` (``symbols.is_capture_call``).

Rules:

- ``recapture-in-loop`` (JAX ``retrace-wrap-in-loop``): a capture inside
  a ``for``/``while`` body -- a fresh graph every iteration.  Replaying
  a built program in a loop is the warm path and stays silent, and so
  does a loop inside a captured body (it unrolls into the one graph).
- ``recapture-per-call`` (JAX ``retrace-per-call-wrap``): in a function
  reachable from a ``# dllm-lint: hot-path`` root, a capture whose
  result is replayed or dropped in the same expression
  (``capture_program(body, ...).run()``) -- never kept, so every tick
  captures again.  Keep it in the engine's program table.
- ``recapture-unbounded-key`` (JAX ``retrace-dynamic-shape``): a program
  key or rung at ``_built(...)`` computed from an unbounded length
  (``len(prompt)``, ``x.shape[i]``): each distinct length is a new
  capture.  Key programs by a rung of a bounded ladder (a prefill
  bucket, a cache rung, a γ bucket).  A deliberately bounded family
  carries a suppression whose justification states the bound.
- ``recapture-shape-cache-key`` (JAX ``retrace-shape-cache-key``): a
  mapping key built from a tensor's ``.shape`` -- a shape-keyed cache
  declares one program per shape.  Slicing to a shape bound and indexing
  by a shape-derived scalar stay silent.

Scope: the serving stack (engine/ops/serving/models/parallel/obs); the
bench and training capture per measurement case by design.  Functions
named ``*warmup*`` are exempt: capturing every program the engine can
touch is warmup's job.
"""

from __future__ import annotations

import ast
import re
from typing import List, Optional, Set, Tuple

from ..core import Checker, Finding, Project
from ..symbols import (call_name, hot_path_roots, is_capture_call,
                       project_symbols, symbols_for)

EXEMPT_RE = re.compile(r"warmup|prewarm", re.IGNORECASE)

# The program-table lookups whose arguments are the program's key.
KEYED_BUILDS = {"_built"}
# A kept program is stored; a replayed-at-once one is run or replayed.
RUN_NAMES = {"run", "replay"}


def _is_exempt(qual: Optional[str]) -> bool:
    return bool(qual and EXEMPT_RE.search(qual))


def _shape_in_key(sub: ast.Subscript) -> bool:
    """True when the subscript KEY (not a slice bound) uses an
    ``.shape`` attribute AS A VALUE -- the whole tuple, directly or
    inside a tuple/f-string key (``cache[x.shape]``,
    ``cache[(x.shape, dtype)]``, ``cache[f"prog-{x.shape}"]``).  A
    shape INDEXED down to a scalar (``tables[q.shape[0]]``) is ordinary
    tensor indexing, not a mapping key, and stays silent."""
    indexed: Set[int] = set()
    hits: List[ast.Attribute] = []
    stack = [sub.slice]
    while stack:
        node = stack.pop()
        if isinstance(node, ast.Slice):
            continue                  # slicing to a shape bound is fine
        if isinstance(node, ast.Subscript) \
                and isinstance(node.value, ast.Attribute) \
                and node.value.attr == "shape":
            indexed.add(id(node.value))
        if isinstance(node, ast.Attribute) and node.attr == "shape":
            hits.append(node)
        stack.extend(ast.iter_child_nodes(node))
    return any(id(h) not in indexed for h in hits)


def _unbounded(expr: ast.expr) -> Optional[str]:
    """'len(...)' / '.shape[...]' / '.size(...)' when the expression is,
    or holds in a tuple or arithmetic, an unbounded length."""
    stack = [expr]
    while stack:
        node = stack.pop()
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "len"):
            return "len(...)"
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "size"):
            return ".size(...)"
        if (isinstance(node, ast.Subscript)
                and isinstance(node.value, ast.Attribute)
                and node.value.attr == "shape"):
            return ".shape[...]"
        if isinstance(node, (ast.BinOp, ast.UnaryOp, ast.Tuple,
                             ast.List)):
            stack.extend(ast.iter_child_nodes(node))
    return None


class RetraceChecker(Checker):
    name = "recapture"
    rules = ("recapture-in-loop", "recapture-per-call",
             "recapture-unbounded-key", "recapture-shape-cache-key")
    scope = ("distributed_llm_tpu_torch/engine",
             "distributed_llm_tpu_torch/ops",
             "distributed_llm_tpu_torch/serving",
             "distributed_llm_tpu_torch/models",
             "distributed_llm_tpu_torch/parallel",
             "distributed_llm_tpu_torch/obs")
    whole_project = True     # captured/hot reachability crosses modules

    def check(self, project: Project) -> List[Finding]:
        ps = project_symbols(project)
        captured = ps.captured_closure()
        hot = ps.closure(hot_path_roots(ps))
        findings: List[Finding] = []
        for mod in project.in_dirs(self.scope):
            syms = symbols_for(mod)
            if syms is None:
                continue
            findings.extend(self._check_module(mod, syms, captured, hot))
        return findings

    def _check_module(self, mod, syms, captured: Set[str],
                      hot: Set[str]) -> List[Finding]:
        findings: List[Finding] = []
        rel = mod.relpath
        parents = {}
        for parent in ast.walk(mod.tree):
            for child in ast.iter_child_nodes(parent):
                parents[id(child)] = parent
        scopes: List[Tuple[Optional[str], list]] = [(None, mod.tree.body)]
        scopes += [(qual, info.node.body)
                   for qual, info in syms.functions.items()
                   if isinstance(info.node.body, list)]
        for qual, body in scopes:
            gid = f"{rel}:{qual}" if qual else None
            if _is_exempt(qual):
                continue
            stack: List[Tuple[ast.AST, int]] = [(n, 0) for n in body]
            while stack:
                node, loops = stack.pop()
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    continue           # separate scope entry
                depth = loops + (1 if isinstance(node, (ast.For,
                                                        ast.While))
                                 else 0)
                stack.extend((c, depth)
                             for c in ast.iter_child_nodes(node))
                if isinstance(node, ast.Subscript) and _shape_in_key(node):
                    findings.append(Finding(
                        "recapture-shape-cache-key", rel, node.lineno,
                        "mapping key built from a tensor's `.shape` -- a "
                        "shape-keyed cache captures one program per "
                        "shape; key it by a bounded rung instead"))
                if isinstance(node, ast.Call):
                    findings.extend(self._check_call(
                        rel, node, gid, loops, captured, hot, parents))
        return findings

    def _check_call(self, rel: str, node: ast.Call, gid: Optional[str],
                    loops: int, captured: Set[str], hot: Set[str],
                    parents) -> List[Finding]:
        out: List[Finding] = []
        if is_capture_call(node):
            what = call_name(node)
            if loops > 0 and (gid is None or gid not in captured):
                out.append(Finding(
                    "recapture-in-loop", rel, node.lineno,
                    f"`{what}(...)` inside a loop captures a fresh CUDA "
                    f"graph every iteration -- capture once, keep the "
                    f"program, and replay it in the loop"))
            if gid is not None and gid in hot and gid not in captured:
                parent = parents.get(id(node))
                up = parents.get(id(parent))
                replayed = (isinstance(parent, ast.Attribute)
                            and parent.attr in RUN_NAMES
                            and isinstance(up, ast.Call)
                            and up.func is parent)
                if replayed or isinstance(parent, ast.Expr):
                    out.append(Finding(
                        "recapture-per-call", rel, node.lineno,
                        f"`{what}(...)` captured and "
                        f"{'replayed' if replayed else 'dropped'} in one "
                        f"expression on a hot path: every call captures "
                        f"again -- keep the program in the engine's "
                        f"table and replay it"))
            return out
        if call_name(node) in KEYED_BUILDS:
            for arg in node.args:
                why = _unbounded(arg)
                if why is not None:
                    out.append(Finding(
                        "recapture-unbounded-key", rel, node.lineno,
                        f"program key from an unbounded length {why} at "
                        f"`{call_name(node)}(...)`: every distinct value "
                        f"captures a new graph -- key it by a bounded "
                        f"rung (bucket, cache rung), or justify the "
                        f"bound in a suppression"))
                    break
        return out
