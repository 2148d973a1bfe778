"""Lock-discipline / race detector: a lock held through a compile, made
structural.

Three rules over ``serving/`` + ``engine/`` + ``obs/``:

- ``lock-blocking-call``: a blocking operation is reachable while a
  ``threading`` lock is held.  Blocking = the repo's known long calls by
  NAME (engine ``generate``/``generate_stream``/``warmup``,
  ``start_server``/``stop_server``, checkpoint loads, ``time.sleep``,
  socket/HTTP reads) plus the unbounded wait forms ``.join()`` /
  ``.wait()`` / ``.get()`` / ``.acquire()`` called with no
  timeout/arguments, and the port's compile: a CUDA graph capture
  (``capture_program``, ``self._capture``, ``torch.cuda.graph(...)``),
  the nvcc build a kernel's first launch waits on (``ops/_build.py``'s
  ``proc.communicate()``) and every ``.synchronize()`` — propagated transitively through the WHOLE-PROJECT
  call graph (symbols.ProjectSymbols), so ``with self._lock:
  self.start_server()`` is flagged even when the compile lives two
  calls down IN ANOTHER FILE (import-resolved: ``from m import fn``,
  ``module.fn``, ``self.method``; bare-name coincidences never edge).
  The shape this catches: a health probe blocking on the lifecycle
  lock through a multi-minute warmup or capture reads as a dead tier,
  and the replicated tiers split exactly these paths across modules.
- ``lock-order-inversion``: lock B acquired while A is held in one
  place and A while B is held in another (static deadlock pair).
  Acquisition-under-lock is collected transitively through resolvable
  module-local calls.
- ``lock-mixed-guard``: an instance attribute that is (a) written from
  code reachable by a worker thread (``threading.Thread(target=...)``
  entries and their module-local closure) and (b) guarded by a lock at
  SOME access sites, but read or written bare at others — the
  inconsistent-discipline race (the checker stays silent on attributes
  never guarded anywhere: those are presumed single-writer by design,
  e.g. a scheduler thread's private state with GIL-safe snapshot reads).
  Container mutation through the attribute (``self._refs[b] = ...``,
  ``del self._refs[b]``) counts as a write: the refcounted allocator's
  table races exactly this way — a bare incref against a
  locked reaper — while the attribute binding itself never changes.
  The rule fires only when the WORKER holds a lock at some write site
  (a discipline exists but missed a site); a worker whose writes are
  ALL bare is presumed single-writer even if another site locks, since
  that shape is statically indistinguishable from the scheduler's
  owned-state pattern (bare `_slots` everywhere + a post-join read
  under the unrelated lifecycle lock) — a deliberate limit, which the
  JAX lint's fixtures pin (held by tests/test_torch_lint.py).

Heuristics are deliberately name-based where cross-module types are
unknowable statically; intended violations carry inline suppressions
with justifications.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ..core import Checker, Finding, Project
from ..symbols import (ModuleSymbols, ProjectSymbols,
                       call_name, is_graph_context, module_dotted_name,
                       project_symbols, symbols_for)

# Long-running by name, wherever they are called (receiver-insensitive:
# cross-module receivers cannot be typed statically).
BLOCKING_NAMES = {
    "sleep",                    # time.sleep
    "generate", "generate_stream",   # engine device calls (minutes on a
    "warmup",                        # wedged chip)
    "start_server", "stop_server",   # lifecycle: build + compile + warm
    "drain",                         # graceful drain: waits out in-flight
                                     # work, then calls stop_server — under
                                     # the lifecycle lock it deadlocks
    "load_params_for_tier",          # checkpoint restore
    "urlopen", "getresponse", "recv", "accept",   # socket/HTTP
    # The port's compile: a CUDA graph capture (engine/programs.py) and
    # the nvcc build a kernel's first launch waits on (ops/_build.py).
    "capture_program", "_capture", "communicate",
    "synchronize",                   # torch.cuda / Event / Stream waits
}

# Zero-argument forms of these are unbounded waits.
UNBOUNDED_WAIT_NAMES = {"join", "wait", "get", "acquire"}


def _is_blocking_call(node: ast.Call) -> Optional[str]:
    name = call_name(node)
    if name in BLOCKING_NAMES:
        return f"`{name}(...)`"
    if is_graph_context(node):
        return "a CUDA graph capture `torch.cuda.graph(...)`"
    if (name in UNBOUNDED_WAIT_NAMES and not node.args
            and not node.keywords):
        return f"unbounded `{name}()` (no timeout)"
    return None


class _FuncScan(ast.NodeVisitor):
    """One function body: blocking calls, lock events with held context,
    and plain self-attribute accesses.  Nested defs are skipped (they
    are separate functions that run later, on their own thread/stack)."""

    def __init__(self, syms: ModuleSymbols, func_qual: str,
                 class_name: Optional[str]):
        self.syms = syms
        self.func_qual = func_qual
        self.class_name = class_name
        self.acquires: Set[str] = set()          # locks this func takes
        # (held_lock, acquired_lock, node) ordered pairs seen directly
        self.order_pairs: List[Tuple[str, str, ast.AST]] = []
        # blocking candidates under a held lock:
        #   (node, reason, held_lock, resolved_callee | None)
        self.held_calls: List[Tuple[ast.Call, Optional[str], str,
                                    Optional[str]]] = []
        # plain self.X accesses: (attr, node, is_write, held_locks)
        self.attr_accesses: List[Tuple[str, ast.AST, bool,
                                       Tuple[str, ...]]] = []
        self._held: List[str] = []
        self._rest_held: Set[str] = set()   # .acquire() → rest of function
        self._skip_root = None

    def run(self, node) -> "_FuncScan":
        self._skip_root = node
        for stmt in node.body:
            self.visit(stmt)
        return self

    # -- scope fences ------------------------------------------------------

    def visit_FunctionDef(self, node):            # nested def: don't descend
        pass

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef

    def _held_now(self) -> Tuple[str, ...]:
        return tuple(self._held) + tuple(self._rest_held)

    # -- with-blocks -------------------------------------------------------

    def visit_With(self, node: ast.With) -> None:
        pushed = 0
        for item in node.items:
            expr = item.context_expr
            # ``with lock:`` and ``with lock.acquire_timeout(...)``-style
            # wrappers: resolve the lock receiver.
            target = expr
            if isinstance(expr, ast.Call):
                self.visit(expr)
                continue
            lock = self.syms.resolve_lock(target, self.func_qual,
                                          self.class_name)
            if lock is not None:
                self._note_acquire(lock, node)
                self._held.append(lock)
                pushed += 1
        for stmt in node.body:
            self.visit(stmt)
        for _ in range(pushed):
            self._held.pop()

    visit_AsyncWith = visit_With

    def _note_acquire(self, lock: str, node: ast.AST) -> None:
        self.acquires.add(lock)
        for held in self._held_now():
            if held != lock:
                self.order_pairs.append((held, lock, node))

    # -- calls -------------------------------------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        name = call_name(node)
        if name == "release" and isinstance(node.func, ast.Attribute):
            # Manual release ends the rest-of-function held region a
            # manual acquire opened (source order — conservative both
            # ways, and exact for the acquire/try/finally idiom).
            lock = self.syms.resolve_lock(node.func.value, self.func_qual,
                                          self.class_name)
            if lock is not None:
                self._rest_held.discard(lock)
            self.generic_visit(node)
            return
        if (name in ("acquire",) and isinstance(node.func, ast.Attribute)):
            lock = self.syms.resolve_lock(node.func.value, self.func_qual,
                                          self.class_name)
            if lock is not None:
                self._note_acquire(lock, node)
                bounded = bool(node.args or node.keywords)
                held = self._held_now()
                if held and not bounded and lock not in held:
                    self.held_calls.append(
                        (node, f"unbounded `{lock}.acquire()`",
                         held[0], None))
                # Held for the remainder of the function: a manual
                # acquire has no structural exit.
                self._rest_held.add(lock)
                self.generic_visit(node)
                return
        reason = _is_blocking_call(node)
        held = self._held_now()
        if held:
            resolved = None
            for callee, cname, cnode in self.syms.calls.get(
                    self.func_qual, ()):
                if cnode is node:
                    resolved = callee
                    break
            # EVERY call under a held lock is recorded: module-locally
            # unresolvable callees may still resolve cross-module
            # through the project graph at check time.
            self.held_calls.append((node, reason, held[0], resolved))
        self.generic_visit(node)

    # -- attribute accesses ------------------------------------------------

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if (isinstance(node.value, ast.Name) and node.value.id == "self"):
            is_write = isinstance(node.ctx, (ast.Store, ast.Del))
            self.attr_accesses.append(
                (node.attr, node, is_write, self._held_now()))
        self.generic_visit(node)

    def visit_Subscript(self, node: ast.Subscript) -> None:
        # Mutating a container THROUGH a self attribute
        # (``self._refs[b] = ...``, ``del self._refs[b]``,
        # ``self._refs[b] += 1``) is a WRITE to the shared state the
        # attribute names, even though the attribute itself is only
        # loaded — the refcount-table shape: a bare incref
        # racing a locked reaper tears the count.  Rebinding-only
        # tracking missed this class entirely.
        if (isinstance(node.ctx, (ast.Store, ast.Del))
                and isinstance(node.value, ast.Attribute)
                and isinstance(node.value.value, ast.Name)
                and node.value.value.id == "self"):
            self.attr_accesses.append(
                (node.value.attr, node, True, self._held_now()))
        self.generic_visit(node)


def _plain_accesses(scan: _FuncScan, tree_parents: Dict[int, ast.AST]
                    ) -> List[Tuple[str, ast.AST, bool, Tuple[str, ...]]]:
    """Filter out method-call receivers (``self.x.m()``): calling a
    method on a shared object is that object's own thread-safety story,
    not a rebinding race on the attribute."""
    out = []
    for attr, node, is_write, held in scan.attr_accesses:
        parent = tree_parents.get(id(node))
        if (isinstance(parent, ast.Attribute)
                and isinstance(tree_parents.get(id(parent)), ast.Call)
                and tree_parents[id(parent)].func is parent):
            continue
        out.append((attr, node, is_write, held))
    return out


def _first_direct_blocking(func_node) -> Optional[Tuple[ast.Call, str]]:
    """The first (by line) blocking call in a function body, nested defs
    skipped — the seed of the project-wide blocking fixpoint."""
    best: Optional[Tuple[ast.Call, str]] = None
    body = (func_node.body if isinstance(func_node.body, list)
            else [func_node.body])
    stack = list(body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        if isinstance(node, ast.Call):
            reason = _is_blocking_call(node)
            if reason is not None and (best is None
                                       or node.lineno < best[0].lineno):
                best = (node, reason)
        stack.extend(ast.iter_child_nodes(node))
    return best


def _display(gid: str, from_rel: str) -> str:
    """How a callee reads in a finding message: bare qualname inside the
    same module, ``dotted.module.qualname`` across modules."""
    rel, qual = gid.split(":", 1)
    if rel == from_rel:
        return qual
    return f"{module_dotted_name(rel)}.{qual}"


def _global_blocking(ps: ProjectSymbols) -> Dict[str, str]:
    """gid -> human-readable witness for every function that blocks,
    directly or transitively through the project-wide call graph."""
    blocking: Dict[str, str] = {}
    for gid, gf in ps.functions.items():
        if isinstance(gf.info.node, ast.Lambda):
            continue
        hit = _first_direct_blocking(gf.info.node)
        if hit is not None:
            blocking[gid] = f"{hit[1]} at line {hit[0].lineno}"
    changed = True
    while changed:
        changed = False
        for gid, edges in ps.calls.items():
            if gid in blocking:
                continue
            for callee, _bare, _node in edges:
                if callee is not None and callee in blocking:
                    rel = gid.split(":", 1)[0]
                    blocking[gid] = (f"calls `{_display(callee, rel)}` "
                                     f"({blocking[callee]})")
                    changed = True
                    break
    return blocking


class LockChecker(Checker):
    name = "locks"
    rules = ("lock-blocking-call", "lock-order-inversion",
             "lock-mixed-guard")
    scope = ("distributed_llm_tpu_torch/serving", "distributed_llm_tpu_torch/engine",
             "distributed_llm_tpu_torch/obs")
    whole_project = True      # an edit elsewhere can make a callee block

    def check(self, project: Project) -> List[Finding]:
        findings: List[Finding] = []
        ps = project_symbols(project)
        blocking = _global_blocking(ps)
        # (relpath, lockA, lockB) -> first site, for inversion detection
        pair_sites: Dict[Tuple[str, str, str], Tuple[str, int]] = {}

        for mod in project.in_dirs(self.scope):
            syms = symbols_for(mod)
            if syms is None:
                continue
            findings.extend(self._check_module(mod, syms, ps, blocking,
                                               pair_sites))

        # Lock-order inversions across all collected pairs (locks are
        # module-scoped, so pairs only collide within one module).
        reported = set()
        for (rel, a, b), (path, line) in sorted(pair_sites.items()):
            if (rel, b, a) in pair_sites and (rel, b, a) not in reported:
                other = pair_sites[(rel, b, a)]
                reported.add((rel, a, b))
                findings.append(Finding(
                    "lock-order-inversion", path, line,
                    f"lock order inversion: {b} acquired while holding "
                    f"{a} here, but {a} acquired while holding {b} at "
                    f"{other[0]}:{other[1]} — static deadlock pair"))
        return findings

    # -- per-module --------------------------------------------------------

    def _check_module(self, mod, syms: ModuleSymbols, ps: ProjectSymbols,
                      blocking: Dict[str, str],
                      pair_sites) -> List[Finding]:
        findings: List[Finding] = []
        rel = mod.relpath
        scans: Dict[str, _FuncScan] = {}
        for qual, info in syms.functions.items():
            if isinstance(info.node, ast.Lambda):
                continue
            scans[qual] = _FuncScan(syms, qual,
                                    info.class_name).run(info.node)

        # Transitive lock acquisition (fixpoint over resolved
        # module-local call edges — lock identity is module-scoped, so
        # cross-module edges cannot contribute inversion pairs).
        acquires: Dict[str, Set[str]] = {q: set(s.acquires)
                                         for q, s in scans.items()}
        changed = True
        while changed:
            changed = False
            for qual in scans:
                for callee, _n, _c in syms.calls.get(qual, ()):
                    if callee is None or callee not in scans:
                        continue
                    extra = acquires[callee] - acquires[qual]
                    if extra:
                        acquires[qual] |= extra
                        changed = True

        # Rule: blocking under a held lock — direct, via a local callee,
        # or via a callee in ANOTHER module (the project graph's
        # import-resolved edge; blocking-ness came from the global
        # fixpoint).  Plus transitive order pairs through local calls.
        for qual, scan in scans.items():
            for held, acquired, node in scan.order_pairs:
                key = (rel, held, acquired)
                pair_sites.setdefault(key, (rel, node.lineno))
            for node, reason, held_lock, resolved in scan.held_calls:
                gid = (f"{rel}:{resolved}" if resolved is not None
                       else ps.callee_of(rel, node))
                if reason is not None:
                    findings.append(Finding(
                        "lock-blocking-call", rel, node.lineno,
                        f"blocking {reason} while holding {held_lock}"))
                elif gid is not None and gid in blocking:
                    findings.append(Finding(
                        "lock-blocking-call", rel, node.lineno,
                        f"call to `{_display(gid, rel)}` while holding "
                        f"{held_lock} — transitively blocking: "
                        f"{blocking[gid]}"))
                if resolved is not None:
                    held = {held_lock}
                    for lock in acquires.get(resolved, ()):
                        for h in held:
                            if h != lock:
                                key = (rel, h, lock)
                                pair_sites.setdefault(
                                    key, (rel, node.lineno))

        findings.extend(self._mixed_guard(mod, syms, scans))
        return findings

    # -- rule: mixed guard discipline --------------------------------------

    def _mixed_guard(self, mod, syms: ModuleSymbols,
                     scans: Dict[str, _FuncScan]) -> List[Finding]:
        findings: List[Finding] = []
        parents: Dict[int, ast.AST] = {}
        for parent in ast.walk(mod.tree):
            for child in ast.iter_child_nodes(parent):
                parents[id(child)] = parent

        # Worker entries: threading.Thread(target=X), resolved in the
        # SPAWNING call's own scope — a Name target binds to a local def
        # visible from the enclosing function chain, a `self.m` target
        # to the spawning class's method.  Matching by bare name across
        # the module would mark unrelated classes' same-named methods
        # worker-reachable and manufacture mixed-guard findings there.
        worker_roots: Set[str] = set()
        for caller, edges in syms.calls.items():
            info = syms.functions.get(caller)
            for _callee, name, node in edges:
                if name != "Thread":
                    continue
                for kw in node.keywords:
                    if kw.arg != "target":
                        continue
                    target = kw.value
                    if isinstance(target, ast.Name) and info is not None:
                        scope: Optional[str] = caller
                        while scope:
                            cand = f"{scope}.<locals>.{target.id}"
                            if cand in syms.functions:
                                worker_roots.add(cand)
                                break
                            parent = syms.functions.get(scope)
                            scope = parent.parent if parent else None
                    elif (isinstance(target, ast.Attribute)
                          and isinstance(target.value, ast.Name)
                          and target.value.id == "self"
                          and info is not None and info.class_name):
                        cand = f"{info.class_name}.{target.attr}"
                        if cand in syms.functions:
                            worker_roots.add(cand)
        if not worker_roots:
            return findings
        worker_funcs = syms.local_closure(worker_roots)

        # Per class: guarded attrs, worker-side writes, bare accesses.
        classes = {i.class_name for i in syms.functions.values()
                   if i.class_name}
        for cls in sorted(classes):
            guarded: Dict[str, Set[str]] = {}
            worker_guarded_writes: Set[str] = set()
            bare: List[Tuple[str, ast.AST, str]] = []
            for qual, scan in scans.items():
                info = syms.functions[qual]
                if info.class_name != cls:
                    continue
                is_init = qual.split(".")[-1] == "__init__"
                for attr, node, is_write, held in _plain_accesses(
                        scan, parents):
                    if held:
                        guarded.setdefault(attr, set()).update(held)
                    # The discipline signal: the WORKER code itself
                    # locks this attr at some write site.  A worker
                    # that never locks it anywhere is the presumed
                    # single-writer pattern (the batching scheduler's
                    # slot list with GIL-safe snapshot reads, where an
                    # unrelated lifecycle lock happens to be held at a
                    # post-join site) — mixed-guard is about a
                    # discipline that EXISTS but missed a site.
                    if (is_write and held and qual in worker_funcs
                            and not is_init):
                        worker_guarded_writes.add(attr)
                    if not held and not is_init:
                        bare.append((attr, node, qual))
            for attr, node, qual in bare:
                if attr in worker_guarded_writes:
                    locks = ", ".join(sorted(guarded[attr]))
                    findings.append(Finding(
                        "lock-mixed-guard", mod.relpath, node.lineno,
                        f"`self.{attr}` is written from worker-thread "
                        f"code under {locks}, but accessed here without "
                        f"any lock"))
        return findings
