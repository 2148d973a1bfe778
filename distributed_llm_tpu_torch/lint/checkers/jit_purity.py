"""Capture purity: host work inside a body captured into a CUDA graph.

The port's counterpart of the JAX package's ``jit_purity`` checker
(``distributed_llm_tpu/lint/checkers/jit_purity.py``).  Where JAX traces
a jitted function once and runs the compiled program, the port captures
a program body once into a CUDA graph (``engine/programs.py``) and
replays the graph.  Python in a captured body runs ONCE, at capture:

A CAPTURE ROOT is the body argument of ``capture_program(...)``,
``TickProgram(...)`` or ``self._capture(...)``, whatever a ``_body(key,
rung)`` provider returns, or the block of a ``with torch.cuda.graph(g)``
(``symbols.capture_roots_for``).  The checker walks the roots and
everything they transitively call, project-wide (a body calls into
``models/``, ``ops/`` and ``parallel/``).

Rules:

- ``capture-host-impurity`` (JAX ``jit-host-impurity``): ``time.*``,
  ``print``, host RNG (``random.*`` / ``np.random.*``) and ``open(...)``
  in a captured body run at capture only; every replay reuses what they
  computed then.  Draw device noise from a registered
  ``torch.Generator`` instead.
- ``capture-host-sync`` (JAX ``jit-traced-concretization``): a host sync
  -- ``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy(force=True)``,
  ``.synchronize()``, ``torch.cuda.synchronize()``, a ``.to("cpu")`` --
  or ``bool()`` / ``int()`` / ``float()`` of a tensor expression (a
  ``torch.*`` call or a reduction such as ``.any()``).  Inside a capture
  a sync is illegal (the capture fails) or, where it slips through on a
  host copy, bakes the capture-time value into every replay.
"""

from __future__ import annotations

import ast
from typing import Dict, List

from ..core import Checker, Finding, Project
from ..symbols import (attr_chain, call_name, capture_roots_for,
                       project_symbols)

# Method calls that wait for the device and read its value on the host
# (``.numpy()`` only with ``force=True``: see ``sync_method``).
SYNC_METHODS = {"item", "cpu", "tolist", "synchronize"}
PULL_WRAPPERS = {"bool", "int", "float"}
# Tensor reductions whose result a pull wrapper syncs on.
TENSOR_REDUCTIONS = {"any", "all", "sum", "max", "min", "argmax",
                     "argmin", "mean", "count_nonzero"}


class _ImportMap(ast.NodeVisitor):
    """name -> source module for top-level imports, to tell stdlib
    ``random`` apart from ``torch.random`` and ``np`` from anything
    else."""

    def __init__(self, tree: ast.Module):
        self.modules: Dict[str, str] = {}
        self.visit(tree)

    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            self.modules[alias.asname or alias.name.split(".")[0]] = \
                alias.name

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        for alias in node.names:
            base = node.module or ""
            self.modules[alias.asname or alias.name] = \
                f"{base}.{alias.name}".lstrip(".")


def is_to_cpu(node: ast.Call) -> bool:
    """``x.to("cpu")`` / ``x.to(device="cpu")``, not ``non_blocking``."""
    if call_name(node) != "to" or not isinstance(node.func, ast.Attribute):
        return False
    if any(kw.arg == "non_blocking" and not (
            isinstance(kw.value, ast.Constant) and not kw.value.value)
           for kw in node.keywords):
        return False
    vals = list(node.args) + [kw.value for kw in node.keywords
                              if kw.arg == "device"]
    return any(isinstance(v, ast.Constant) and v.value == "cpu"
               for v in vals)


def sync_method(node: ast.Call) -> str:
    """The name of the host sync this call is, or ''."""
    if not isinstance(node.func, ast.Attribute):
        return ""
    name = node.func.attr
    if name == "numpy":
        # ``.numpy()`` of a CUDA tensor raises, so only ``force=True``
        # (copy off the card first) can sync; plain ``.numpy()`` is the
        # host staging arrays' view.
        forced = any(kw.arg == "force" and not (
            isinstance(kw.value, ast.Constant) and not kw.value.value)
            for kw in node.keywords)
        return "numpy(force=True)" if forced else ""
    if name == "synchronize" or (name in SYNC_METHODS and not node.args
                                 and not node.keywords):
        return f"{name}()"
    if is_to_cpu(node):
        return 'to("cpu")'
    return ""


def tensor_expr(expr: ast.expr) -> bool:
    """Whether the expression computes a tensor: a call rooted at
    ``torch.`` or a tensor reduction (``x.any()``, ``x.max()``)."""
    for node in ast.walk(expr):
        if not isinstance(node, ast.Call):
            continue
        chain = attr_chain(node.func) or ""
        if chain.split(".", 1)[0] == "torch" or (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in TENSOR_REDUCTIONS):
            return True
    return False


class JitPurityChecker(Checker):
    name = "capture_purity"
    rules = ("capture-host-impurity", "capture-host-sync")
    scope = ("distributed_llm_tpu_torch",)
    whole_project = True      # a body's callees live in other modules

    def check(self, project: Project) -> List[Finding]:
        ps = project_symbols(project)
        findings: List[Finding] = []
        imports: Dict[str, _ImportMap] = {}

        def imap(mod) -> _ImportMap:
            if mod.relpath not in imports:
                imports[mod.relpath] = _ImportMap(mod.tree)
            return imports[mod.relpath]

        for gid in sorted(ps.captured_closure()):
            gf = ps.functions[gid]
            mod = project.get(gf.relpath)
            body = (gf.info.node.body
                    if isinstance(gf.info.node.body, list)
                    else [gf.info.node.body])
            findings.extend(self._scan(mod, imap(mod), body, gf.qualname))
        for rel in sorted(ps.mods):
            mod = project.get(rel)
            cap = capture_roots_for(mod, ps.mods[rel])
            for lam in cap.lambdas:
                findings.extend(self._scan(mod, imap(mod), [lam.body],
                                           "<lambda>"))
            for _scope, block in cap.blocks:
                findings.extend(self._scan(mod, imap(mod), block.body,
                                           "a torch.cuda.graph block"))
        return sorted(set(findings), key=lambda f: (f.path, f.line, f.rule))

    def _scan(self, mod, imports: _ImportMap, body: list,
              where: str) -> List[Finding]:
        findings: List[Finding] = []
        stack = list(body)
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue          # its own closure member when captured
            stack.extend(ast.iter_child_nodes(node))
            if isinstance(node, ast.Call):
                findings.extend(self._check_call(mod, imports, node, where))
        return findings

    def _check_call(self, mod, imports: _ImportMap, node: ast.Call,
                    where: str) -> List[Finding]:
        out: List[Finding] = []
        chain = attr_chain(node.func) or ""
        root = chain.split(".", 1)[0]
        root_module = imports.modules.get(root, "")
        name = call_name(node)

        def flag(rule: str, msg: str) -> None:
            out.append(Finding(rule, mod.relpath, node.lineno, msg))

        if root_module == "time" or chain.startswith("time."):
            flag("capture-host-impurity",
                 f"`{chain}(...)` in a captured body (`{where}`) runs once, "
                 f"at capture: every replay reuses that reading")
        elif isinstance(node.func, ast.Name) and name == "print":
            flag("capture-host-impurity",
                 f"`print(...)` in a captured body (`{where}`) fires at "
                 f"capture only, never on a replay")
        elif (chain.startswith("random.")
              and imports.modules.get("random", "random") == "random"):
            flag("capture-host-impurity",
                 f"host RNG `{chain}(...)` in a captured body (`{where}`) "
                 f"draws once, at capture -- draw on the device from a "
                 f"registered torch.Generator")
        elif ".random." in f"{chain}." and root_module == "numpy":
            flag("capture-host-impurity",
                 f"host RNG `{chain}(...)` in a captured body (`{where}`) "
                 f"draws once, at capture -- draw on the device from a "
                 f"registered torch.Generator")
        elif isinstance(node.func, ast.Name) and name == "open":
            flag("capture-host-impurity",
                 f"`open(...)` in a captured body (`{where}`) is host I/O "
                 f"at capture only")
        sync = sync_method(node)
        if sync:
            flag("capture-host-sync",
                 f"`.{sync}` in a captured body (`{where}`): a host sync "
                 f"fails the capture, or bakes the capture-time value "
                 f"into every replay")
        elif (isinstance(node.func, ast.Name) and name in PULL_WRAPPERS
              and node.args and tensor_expr(node.args[0])):
            flag("capture-host-sync",
                 f"`{name}(...)` of a tensor in a captured body "
                 f"(`{where}`) syncs to read it on the host -- keep the "
                 f"branch on the device (torch.where)")
        return out
