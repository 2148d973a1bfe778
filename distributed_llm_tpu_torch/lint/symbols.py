"""Shared walker + symbol tables for dllm-lint checkers.

One pass over a module yields:

- every function/method (nested defs included) with a stable qualname
  (``Class.method``, ``Class.method.<locals>.worker``, ``func``),
- declared locks (``self._x = threading.Lock()`` instance attrs,
  module-level ``_lock = threading.Lock()``, and function-local
  ``state_lock = threading.Lock()``), keyed so usage sites resolve to
  the same identity,
- a module-local call graph: edges a checker can actually trust —
  ``name(...)`` to a local/module function, ``self.m(...)`` to a method
  of the same class.

On top of the per-module tables, ``ProjectSymbols`` (built once per
``Project``, cached, shared by every checker in a run) assembles the
WHOLE-PROJECT call graph: import-aware resolution of ``module.fn(...)``
(plain, dotted, and aliased imports), ``from m import fn`` (including
relative imports and one-hop re-export chains through ``__init__``
modules), ``self.method`` within a class, and ``Thread(target=...)``
worker roots whose target lives in another file.  Resolution is
strictly conservative: an edge exists only when an import chain proves
it — two modules defining the same bare name NEVER edge to each other.
Unresolvable receivers (callbacks, dispatch dicts, duck-typed objects)
stay unresolved; checkers must treat "no edge" as "unknown", not
"safe/unsafe".

Checkers layer semantics (blocking-ness, purity, guarded regions) on
top; this module only answers "what functions exist and who calls whom".
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Set, Tuple

LOCK_FACTORIES = {"Lock", "RLock", "Condition", "Semaphore",
                  "BoundedSemaphore"}


def call_name(node: ast.Call) -> str:
    """The bare called name: ``f`` for ``f(...)``/``a.b.f(...)``."""
    fn = node.func
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return ""


def attr_chain(node: ast.expr) -> Optional[str]:
    """Dotted source text for Name/Attribute chains (``self._lock``,
    ``os.environ``); None for anything dynamic."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_lock_factory(value: ast.expr) -> bool:
    if not isinstance(value, ast.Call):
        return False
    chain = attr_chain(value.func)
    if chain is None:
        return False
    leaf = chain.rsplit(".", 1)[-1]
    return leaf in LOCK_FACTORIES


@dataclasses.dataclass
class FuncInfo:
    qualname: str
    node: ast.AST                   # FunctionDef | AsyncFunctionDef | Lambda
    class_name: Optional[str]       # nearest enclosing class
    parent: Optional[str]           # enclosing function qualname


class ModuleSymbols(ast.NodeVisitor):
    """One module's functions, locks, and call edges."""

    def __init__(self, tree: ast.Module):
        self.functions: Dict[str, FuncInfo] = {}
        # lock id -> declaration line.  Ids:
        #   "Class.self._x"  instance attr (any method of Class)
        #   "<module>.name"  module-level
        #   "<func qualname>.name"  function-local
        self.locks: Dict[str, int] = {}
        # call edges: caller qualname -> [(callee qualname | None,
        #                                  bare name, Call node)]
        self.calls: Dict[str, List[Tuple[Optional[str], str, ast.Call]]] = {}
        self._class_stack: List[str] = []
        self._func_stack: List[str] = []
        # (caller, enclosing class, node): resolution is deferred until
        # the whole module is walked — resolving mid-walk silently
        # dropped every edge to a callee defined LATER in the file.
        self._pending: List[Tuple[str, Optional[str], ast.Call]] = []
        self.visit(tree)
        for caller, cls, node in self._pending:
            callee = resolve_local_callable(
                self, caller if caller != "<module>" else None, cls,
                node.func)
            self.calls.setdefault(caller, []).append(
                (callee, call_name(node), node))
        del self._pending

    # -- scope bookkeeping -------------------------------------------------

    def _qual(self, name: str) -> str:
        if self._func_stack:
            return f"{self._func_stack[-1]}.<locals>.{name}"
        if self._class_stack:
            return f"{self._class_stack[-1]}.{name}"
        return name

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._class_stack.append(node.name)
        self.generic_visit(node)
        self._class_stack.pop()

    def _visit_func(self, node) -> None:
        qual = self._qual(node.name)
        self.functions[qual] = FuncInfo(
            qualname=qual, node=node,
            class_name=self._class_stack[-1] if self._class_stack else None,
            parent=self._func_stack[-1] if self._func_stack else None)
        self._func_stack.append(qual)
        self.generic_visit(node)
        self._func_stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    # -- locks -------------------------------------------------------------

    def visit_Assign(self, node: ast.Assign) -> None:
        if _is_lock_factory(node.value):
            for target in node.targets:
                chain = attr_chain(target)
                if chain is None:
                    continue
                if chain.startswith("self.") and self._class_stack:
                    self.locks[f"{self._class_stack[-1]}.{chain}"] = \
                        node.lineno
                elif "." not in chain:
                    if self._func_stack:
                        self.locks[f"{self._func_stack[-1]}.{chain}"] = \
                            node.lineno
                    else:
                        self.locks[f"<module>.{chain}"] = node.lineno
        self.generic_visit(node)

    # -- calls -------------------------------------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        caller = self._func_stack[-1] if self._func_stack else "<module>"
        self._pending.append(
            (caller,
             self._class_stack[-1] if self._class_stack else None,
             node))
        self.generic_visit(node)

    # -- queries -----------------------------------------------------------

    def resolve_lock(self, expr: ast.expr, func_qual: str,
                     class_name: Optional[str]) -> Optional[str]:
        """Map a with-item / .acquire() receiver back to a declared lock
        id, walking the enclosing-function chain for locals (closures)."""
        chain = attr_chain(expr)
        if chain is None:
            return None
        if chain.startswith("self.") and class_name:
            cand = f"{class_name}.{chain}"
            return cand if cand in self.locks else None
        if "." in chain:
            return None
        scope: Optional[str] = func_qual
        while scope:
            cand = f"{scope}.{chain}"
            if cand in self.locks:
                return cand
            info = self.functions.get(scope)
            scope = info.parent if info else None
        cand = f"<module>.{chain}"
        return cand if cand in self.locks else None

    def local_closure(self, roots: Set[str]) -> Set[str]:
        """roots + every module-local function transitively reachable
        through resolved call edges."""
        seen = set(roots)
        frontier = list(roots)
        while frontier:
            cur = frontier.pop()
            for callee, _name, _node in self.calls.get(cur, ()):
                if callee is not None and callee not in seen:
                    seen.add(callee)
                    frontier.append(callee)
        return seen


def symbols_for(module) -> Optional[ModuleSymbols]:
    """ModuleSymbols for a core.Module (None when it failed to parse),
    cached on the module object."""
    if module.tree is None:
        return None
    cached = getattr(module, "_dllm_symbols", None)
    if cached is None:
        cached = ModuleSymbols(module.tree)
        module._dllm_symbols = cached
    return cached


def resolve_local_callable(syms: ModuleSymbols, scope_qual: Optional[str],
                           class_name: Optional[str],
                           expr: ast.expr) -> Optional[str]:
    """Resolve a callable REFERENCE (not a call) in a module: a bare
    ``Name`` against the enclosing-function <locals> chain then the
    module level, or ``self.m`` against the enclosing class.  This is
    the Thread(target=...)-style resolution: strictly scoped, so a
    same-named method on an unrelated class never matches."""
    if isinstance(expr, ast.Name):
        scope = scope_qual
        while scope:
            cand = f"{scope}.<locals>.{expr.id}"
            if cand in syms.functions:
                return cand
            info = syms.functions.get(scope)
            scope = info.parent if info else None
        if expr.id in syms.functions:
            return expr.id
        return None
    if (isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self" and class_name):
        cand = f"{class_name}.{expr.attr}"
        if cand in syms.functions:
            return cand
    return None


# ---------------------------------------------------------------------------
# Whole-project call graph
# ---------------------------------------------------------------------------

def module_dotted_name(relpath: str) -> str:
    """``distributed_llm_tpu_torch/serving/router.py`` ->
    ``distributed_llm_tpu_torch.serving.router``; ``pkg/__init__.py`` ->
    ``pkg``; a top-level ``tool.py`` -> ``tool``."""
    p = relpath[:-3] if relpath.endswith(".py") else relpath
    if p.endswith("/__init__"):
        p = p[: -len("/__init__")]
    return p.replace("/", ".")


class ModuleImports(ast.NodeVisitor):
    """All import bindings of one module (function-level imports
    included — the repo lazy-imports heavily; binding them module-wide
    is sound for resolution ONLY while the name binds one target: a
    name two imports bind to different targets is poisoned and never
    resolves (edge-only-when-proven — last-writer-wins would silently
    mis-edge every call site of the other import)."""

    def __init__(self, tree: ast.Module, package: str):
        # local name -> dotted module path ("import a.b as m",
        # "from a import submodule")
        self.module_aliases: Dict[str, str] = {}
        # local name -> (dotted module, attr) ("from a.b import fn")
        self.from_names: Dict[str, Tuple[str, str]] = {}
        # dotted paths reachable by their FULL dotted chain
        # ("import a.b.c" makes a.b.c.fn(...) resolvable)
        self.plain: Set[str] = set()
        self._ambiguous: Set[str] = set()
        self._package = package
        self.visit(tree)

    def _bind(self, table: Dict, local: str, target) -> None:
        if local in self._ambiguous:
            return
        for t in (self.module_aliases, self.from_names):
            prev = t.get(local)
            if prev is not None and (t is not table or prev != target):
                self._ambiguous.add(local)
                t.pop(local, None)
                return
        table[local] = target

    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            if alias.asname:
                self._bind(self.module_aliases, alias.asname, alias.name)
            else:
                # ``import a.b.c`` binds ``a`` and makes every prefix
                # importable as a chain.
                parts = alias.name.split(".")
                for i in range(1, len(parts) + 1):
                    self.plain.add(".".join(parts[:i]))

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        base = node.module or ""
        if node.level:
            # Relative import: level 1 = the containing package.
            pkg_parts = self._package.split(".") if self._package else []
            keep = len(pkg_parts) - (node.level - 1)
            if keep < 0:
                return                       # beyond the project root
            prefix = ".".join(pkg_parts[:keep])
            base = f"{prefix}.{base}".rstrip(".") if base else prefix
        if not base:
            return
        for alias in node.names:
            local = alias.asname or alias.name
            if alias.name == "*":
                continue
            self._bind(self.from_names, local, (base, alias.name))


@dataclasses.dataclass
class GlobalFunc:
    gid: str                 # "<relpath>:<qualname>"
    relpath: str
    qualname: str
    info: FuncInfo


class ProjectSymbols:
    """The whole-project call graph, built once per lint run and shared
    by every graph-based checker (locks, recapture, transfer,
    thread_lifecycle).  Functions are keyed by a global id
    ``<relpath>:<qualname>``.

    Resolution rules (deliberately conservative):

    - module-local edges come straight from ``ModuleSymbols`` (bare name
      in the enclosing scope chain, ``self.method`` on the own class);
    - ``fn(...)`` where ``fn`` was ``from m import fn``-imported edges to
      ``m:fn`` when m is a project module defining ``fn`` (one-hop
      re-exports through ``__init__`` are followed);
    - ``alias.fn(...)`` / ``pkg.mod.fn(...)`` edges through ``import``
      aliases and plain dotted imports the same way;
    - everything else (method calls on objects, callbacks, dispatch
      tables) stays unresolved — never matched by bare name.
    """

    def __init__(self, project) -> None:
        self.project = project
        self.mods: Dict[str, ModuleSymbols] = {}
        self.imports: Dict[str, ModuleImports] = {}
        self.by_name: Dict[str, str] = {}          # dotted name -> relpath
        self.functions: Dict[str, GlobalFunc] = {}
        # gid -> [(callee gid | None, bare name, Call node)]
        self.calls: Dict[str, List[Tuple[Optional[str], str, ast.Call]]] = {}
        # (relpath, id(Call node)) -> callee gid, for checkers that walk
        # bodies themselves and need per-site resolution.
        self.node_callee: Dict[Tuple[str, int], str] = {}

        for rel, mod in sorted(project.modules.items()):
            syms = symbols_for(mod)
            if syms is None:
                continue
            self.mods[rel] = syms
            dotted = module_dotted_name(rel)
            self.by_name[dotted] = rel
            package = dotted if rel.endswith("__init__.py") \
                else dotted.rsplit(".", 1)[0] if "." in dotted else ""
            self.imports[rel] = ModuleImports(mod.tree, package)
            for qual, info in syms.functions.items():
                gid = f"{rel}:{qual}"
                self.functions[gid] = GlobalFunc(gid, rel, qual, info)

        for rel, syms in self.mods.items():
            for caller, edges in syms.calls.items():
                caller_gid = f"{rel}:{caller}"
                out = self.calls.setdefault(caller_gid, [])
                info = syms.functions.get(caller)
                candidates: Optional[Dict[str, List[ast.expr]]] = None
                for local, bare, node in edges:
                    gid: Optional[str] = None
                    if local is not None:
                        gid = f"{rel}:{local}"
                    else:
                        gid = self.resolve_func_expr(rel, node.func)
                    if gid is None and isinstance(node.func, ast.Name) \
                            and info is not None:
                        # Value flow: ``op = mod.fn if c else mod.g``
                        # then ``op(...)`` — resolve every candidate the
                        # function's own scope binds to the name (the
                        # paged_kv attn-hook idiom).  Multi-valued: each
                        # resolvable candidate becomes an edge.
                        if candidates is None:
                            candidates = _value_candidates(info.node)
                        extra = []
                        for expr in candidates.get(node.func.id, ()):
                            cand = self.resolve_func_expr(rel, expr)
                            if cand is None:
                                local_cand = resolve_local_callable(
                                    syms, caller, info.class_name, expr)
                                if local_cand is not None:
                                    cand = f"{rel}:{local_cand}"
                            if cand is not None and cand not in extra:
                                extra.append(cand)
                        if extra:
                            gid = extra[0]
                            for cand in extra[1:]:
                                out.append((cand, bare, node))
                    if gid is not None:
                        self.node_callee[(rel, id(node))] = gid
                    out.append((gid, bare, node))

    # -- resolution --------------------------------------------------------

    def _module_level_func(self, rel: str, name: str,
                           _depth: int = 0) -> Optional[str]:
        """gid of module-level function ``name`` in module ``rel``,
        following re-export chains (``from .x import name`` in an
        ``__init__``) up to 4 hops."""
        syms = self.mods.get(rel)
        if syms is not None:
            info = syms.functions.get(name)
            if info is not None and info.parent is None \
                    and info.class_name is None:
                return f"{rel}:{name}"
        if _depth >= 4:
            return None
        imp = self.imports.get(rel)
        if imp is not None and name in imp.from_names:
            src_mod, src_name = imp.from_names[name]
            src_rel = self.by_name.get(src_mod)
            if src_rel is not None:
                return self._module_level_func(src_rel, src_name,
                                               _depth + 1)
        return None

    def resolve_func_expr(self, rel: str,
                          expr: ast.expr) -> Optional[str]:
        """Cross-module resolution of a function-valued expression
        (``fn`` from-imported, ``mod.fn``, ``pkg.mod.fn``) to a gid.
        Returns None for anything an import chain cannot prove."""
        imp = self.imports.get(rel)
        if imp is None:
            return None
        if isinstance(expr, ast.Name):
            entry = imp.from_names.get(expr.id)
            if entry is None:
                return None
            src_rel = self.by_name.get(entry[0])
            if src_rel is None:
                return None
            return self._module_level_func(src_rel, entry[1])
        chain = attr_chain(expr)
        if chain is None or "." not in chain:
            return None
        head, leaf = chain.rsplit(".", 1)
        modname = imp.module_aliases.get(head)
        if modname is None and head in imp.from_names:
            src_mod, src_name = imp.from_names[head]
            cand = f"{src_mod}.{src_name}"
            if cand in self.by_name:
                modname = cand                  # ``from pkg import mod``
        if modname is None and head in imp.plain:
            modname = head                      # ``import a.b.c`` chains
        if modname is None:
            return None
        target_rel = self.by_name.get(modname)
        if target_rel is None:
            return None
        return self._module_level_func(target_rel, leaf)

    # -- queries -----------------------------------------------------------

    def closure(self, roots: Set[str]) -> Set[str]:
        """roots + every function transitively reachable through
        resolved project-wide call edges."""
        seen = set(roots)
        frontier = list(roots)
        while frontier:
            cur = frontier.pop()
            for callee, _bare, _node in self.calls.get(cur, ()):
                if callee is not None and callee not in seen:
                    seen.add(callee)
                    frontier.append(callee)
        return seen

    def callee_of(self, rel: str, node: ast.Call) -> Optional[str]:
        """The resolved callee gid of a specific call site (module-local
        or cross-module), if any."""
        return self.node_callee.get((rel, id(node)))

    def thread_target_gids(self) -> Dict[str, List[Tuple[str, int]]]:
        """Every ``threading.Thread(target=X)`` whose target resolves —
        in the spawning scope (bare name / self.method, the strict local
        rules) or cross-module through imports.  Returns target gid ->
        [(spawning relpath, lineno)]."""
        out: Dict[str, List[Tuple[str, int]]] = {}
        for rel, syms in self.mods.items():
            for caller, edges in syms.calls.items():
                info = syms.functions.get(caller)
                for _callee, bare, node in edges:
                    if bare != "Thread":
                        continue
                    for kw in node.keywords:
                        if kw.arg != "target":
                            continue
                        local = resolve_local_callable(
                            syms, caller if info else None,
                            info.class_name if info else None, kw.value)
                        gid = (f"{rel}:{local}" if local is not None
                               else self.resolve_func_expr(rel, kw.value))
                        if gid is not None:
                            out.setdefault(gid, []).append(
                                (rel, node.lineno))
        return out

    # -- captured (CUDA graph) reachability ------------------------------

    def captured_closure(self) -> Set[str]:
        """Every function reachable, project-wide, from any capture root
        in any module (``capture_roots_for``) -- the set whose bodies run
        ONCE, at capture, and are then replayed from the recorded graph.
        Nested defs of a captured function count as captured too: a body
        passes its helpers around by value as often as it calls them."""
        cached = getattr(self, "_captured_closure", None)
        if cached is not None:
            return cached
        roots: Set[str] = set()
        for rel, syms in self.mods.items():
            mod = self.project.get(rel)
            cap = capture_roots_for(mod, syms)
            roots |= {f"{rel}:{q}" for q in cap.roots}
            for _scope, block in cap.blocks:
                for sub in _own_walk(block.body):
                    if isinstance(sub, ast.Call):
                        gid = self.callee_of(rel, sub)
                        if gid is not None:
                            roots.add(gid)
        children: Dict[str, List[str]] = {}
        for gid, gf in self.functions.items():
            if gf.info.parent is not None:
                children.setdefault(f"{gf.relpath}:{gf.info.parent}",
                                    []).append(gid)
        closed = self.closure(roots)
        while True:
            nested = {c for gid in closed
                      for c in children.get(gid, ()) if c not in closed}
            if not nested:
                break
            closed = self.closure(closed | nested)
        self._captured_closure = closed
        return closed


def hot_path_roots(ps: ProjectSymbols) -> Set[str]:
    """gids of every function annotated ``# dllm-lint: hot-path`` (on
    the ``def`` line, the line above it, or a decorator line) — the
    transfer checker's root set, and recapture's per-request context."""
    roots: Set[str] = set()
    for rel, syms in ps.mods.items():
        mod = ps.project.get(rel)
        marked = getattr(getattr(mod, "suppressions", None),
                         "hot_path_lines", None)
        if not marked:
            continue
        for qual, info in syms.functions.items():
            node = info.node
            lines = {getattr(node, "lineno", -1),
                     getattr(node, "lineno", 0) - 1}
            for deco in getattr(node, "decorator_list", []):
                lines.add(deco.lineno)
                lines.add(deco.lineno - 1)
            if lines & marked:
                roots.add(f"{rel}:{qual}")
    return roots


def project_symbols(project) -> ProjectSymbols:
    """The ProjectSymbols for a core.Project, built once and cached on
    the project object — every graph-based checker in a run shares one
    graph (and, through ``symbols_for``, one parsed AST per file)."""
    cached = getattr(project, "_dllm_project_symbols", None)
    if cached is None:
        cached = ProjectSymbols(project)
        project._dllm_project_symbols = cached
    return cached


# ---------------------------------------------------------------------------
# capture-root discovery (shared by capture purity, recapture, profiler)
# ---------------------------------------------------------------------------

# Calls whose first argument is a body captured into a CUDA graph
# (engine/programs.py: ``capture_program(body, ...)``,
# ``TickProgram(body, graph, ...)``, an engine's ``self._capture(body)``).
CAPTURE_CALLS = {"capture_program", "TickProgram", "_capture"}
# Methods whose RETURN is a program body (``_body(key, rung)``).
BODY_PROVIDERS = {"_body"}
# The graph objects and the capture context itself.
GRAPH_FACTORY = "CUDAGraph"


def is_graph_context(expr: ast.expr) -> bool:
    """``torch.cuda.graph(g)`` (any receiver chain ending in
    ``cuda.graph``): a ``with`` over it captures its block."""
    if not isinstance(expr, ast.Call):
        return False
    chain = attr_chain(expr.func) or ""
    return chain == "graph" or chain.endswith("cuda.graph")


def is_capture_call(node: ast.Call) -> bool:
    """A call that captures (or builds the graph of) a program:
    ``capture_program(...)``, ``TickProgram(...)`` given a graph,
    ``self._capture(...)``, ``torch.cuda.CUDAGraph()`` and
    ``torch.cuda.graph(...)``."""
    name = call_name(node)
    if name == "TickProgram":
        return len(node.args) > 1 or any(kw.arg == "graph"
                                         for kw in node.keywords)
    return (name in ("capture_program", "_capture", GRAPH_FACTORY)
            or is_graph_context(node))


def unwrap_partial(node: ast.expr) -> ast.expr:
    """partial(f, ...) -> f (functools.partial / partial)."""
    if isinstance(node, ast.Call):
        leaf = attr_chain(node.func)
        if leaf is not None and leaf.rsplit(".", 1)[-1] == "partial":
            if node.args:
                return node.args[0]
    return node


def _own_walk(body) -> List[ast.AST]:
    """Every node of a statement list, nested def/lambda bodies
    excluded (their own scopes)."""
    out: List[ast.AST] = []
    stack = list(body)
    while stack:
        n = stack.pop()
        out.append(n)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(n))
    return out


def _value_candidates(func_node) -> Dict[str, List[ast.expr]]:
    """name -> function-valued RHS expressions assigned to it in this
    function's own scope (nested defs are their own scopes).  IfExp
    branches flatten (``op = a.f if c else a.g`` yields both) and
    ``partial(f, ...)`` unwraps to ``f``."""
    out: Dict[str, List[ast.expr]] = {}

    def flatten(expr: ast.expr) -> List[ast.expr]:
        expr = unwrap_partial(expr)
        if isinstance(expr, ast.IfExp):
            return flatten(expr.body) + flatten(expr.orelse)
        if isinstance(expr, (ast.Name, ast.Attribute)):
            return [expr]
        return []

    for n in _own_walk(getattr(func_node, "body", [])):
        if (isinstance(n, ast.Assign) and len(n.targets) == 1
                and isinstance(n.targets[0], ast.Name)):
            out.setdefault(n.targets[0].id, []).extend(flatten(n.value))
    return out


@dataclasses.dataclass
class CaptureRoots:
    roots: Set[str]                       # qualnames of captured bodies
    lambdas: List[ast.Lambda]             # lambda bodies captured
    blocks: List[Tuple[Optional[str], ast.With]]   # ``with ...graph(g):``


class _BodyResolver:
    """Which functions a body-valued expression denotes, module-locally:
    a nested def or module function by name, ``self.m``, a lambda, and
    the return values of a called provider (``self._decode_body(wb)``,
    ``{"a": self._a_body}[kind](*args)``), followed through returns."""

    def __init__(self, syms: ModuleSymbols):
        self.syms = syms
        self.roots: Set[str] = set()
        self.lambdas: List[ast.Lambda] = []
        self._returned: Set[str] = set()

    def expr(self, expr: ast.expr, scope: Optional[str],
             cls: Optional[str]) -> None:
        expr = unwrap_partial(expr)
        if isinstance(expr, ast.Lambda):
            self.lambdas.append(expr)
            return
        if isinstance(expr, ast.IfExp):
            self.expr(expr.body, scope, cls)
            self.expr(expr.orelse, scope, cls)
            return
        if isinstance(expr, ast.Call):
            fn = expr.func
            if isinstance(fn, ast.Subscript) and isinstance(fn.value,
                                                            ast.Dict):
                for value in fn.value.values:
                    self._provider(value, scope, cls)
            else:
                self._provider(fn, scope, cls)
            return
        qual = resolve_local_callable(self.syms, scope, cls, expr)
        if qual is not None:
            self.roots.add(qual)

    def _provider(self, fn: ast.expr, scope: Optional[str],
                  cls: Optional[str]) -> None:
        qual = resolve_local_callable(self.syms, scope, cls, fn)
        if qual is not None:
            self.returns_of(qual)

    def returns_of(self, qual: str) -> None:
        """Every body the function ``qual`` returns."""
        if qual in self._returned:
            return
        self._returned.add(qual)
        info = self.syms.functions[qual]
        body = info.node.body if isinstance(info.node.body, list) else []
        for n in _own_walk(body):
            if isinstance(n, ast.Return) and n.value is not None:
                self.expr(n.value, qual, info.class_name)


def capture_roots_for(module, syms: ModuleSymbols) -> CaptureRoots:
    """The CAPTURE ROOTS of a module: the body argument of every
    ``capture_program`` / ``TickProgram`` / ``self._capture`` call, what
    every ``_body(...)`` provider returns, and every ``with
    torch.cuda.graph(...)`` block.  Cached on the module object: capture
    purity, recapture and the profiler rule share one discovery pass."""
    cached = getattr(module, "_dllm_capture_roots", None)
    if cached is not None:
        return cached
    res = _BodyResolver(syms)
    blocks: List[Tuple[Optional[str], ast.With]] = []
    for qual, info in syms.functions.items():
        if qual.rsplit(".", 1)[-1] in BODY_PROVIDERS:
            res.returns_of(qual)
    scopes: List[Tuple[Optional[str], Optional[str], list]] = [
        (None, None, module.tree.body)]
    scopes += [(qual, info.class_name, info.node.body)
               for qual, info in syms.functions.items()
               if isinstance(info.node.body, list)]
    for qual, cls, body in scopes:
        for n in _own_walk(body):
            if isinstance(n, (ast.With, ast.AsyncWith)) and any(
                    is_graph_context(i.context_expr) for i in n.items):
                blocks.append((qual, n))
            if (isinstance(n, ast.Call) and n.args
                    and call_name(n) in CAPTURE_CALLS):
                res.expr(n.args[0], qual, cls)
    result = CaptureRoots(res.roots, res.lambdas, blocks)
    module._dllm_capture_roots = result
    return result
