"""Thread/lock lifecycle leak checker.

The serving stack spawns threads in many modules (schedulers, replica
and health monitors, the spill copier, samplers).  The failure modes are
quiet: a non-daemon worker no shutdown path joins keeps the process
alive after SIGTERM; a manual ``acquire()`` without an exception-safe
release deadlocks the NEXT request, not this one; a module-scope
recorder that owns a thread but has no stop hook outlives every drain.
This checker makes all three structural, over the project-wide call
graph.

Rules:

- ``thread-no-reclaim``: every ``threading.Thread(...)`` must be
  ``daemon=True`` or have a ``.join`` reachable from a reclaim path:
  either in the spawning function itself (the bench fan-out idiom —
  spawn, start, join in one scope; the join must name THIS thread's
  binding or an alias/loop variable no spawn is bound to, so joining
  worker A never silences a never-joined worker B in the same scope),
  or — for threads parked on ``self.X`` — a ``self.X.join(...)`` in a
  method of the same class that is itself a stop/close/drain/shutdown-
  family function or project-reachable from one.  A join in a random
  method that no shutdown path calls does not count: nothing runs it
  when the process is asked to die.
- ``thread-acquire-leak``: a manual ``lock.acquire()`` whose enclosing
  function has no ``lock.release()`` inside a ``finally`` block — on an
  exception between acquire and release the lock is held forever (the
  next request deadlocks, not this one).  The sanctioned shapes are
  ``with lock:`` and acquire-then-``try/finally``-release; anything
  else carries a suppression whose justification names the release
  owner (e.g. a stream object that releases on close).
- ``thread-ring-no-stop``: a module-scope singleton of a class that
  starts threads must define a stop/close/shutdown hook AND that hook
  must be called from somewhere a drain/stop path reaches — otherwise
  a drained process keeps sampling/recording forever.

Stop-family = a function whose name starts with stop/close/drain/
shutdown/terminate/__exit__ (``stop_server`` counts), plus everything
those functions transitively call, project-wide.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from ..core import Checker, Finding, Project
from ..symbols import (ProjectSymbols, attr_chain, call_name,
                       project_symbols, symbols_for)

STOP_NAME_RE = re.compile(
    r"^(stop|close|drain|shutdown|terminate|__exit__|__del__|atexit)")


def _stop_reachable(ps: ProjectSymbols) -> Set[str]:
    roots = {gid for gid, gf in ps.functions.items()
             if STOP_NAME_RE.match(gf.qualname.split(".")[-1])}
    return ps.closure(roots)


def _daemon_true(call: ast.Call) -> bool:
    for kw in call.keywords:
        if kw.arg == "daemon":
            return not (isinstance(kw.value, ast.Constant)
                        and kw.value.value in (False, None))
    return False


def _thread_like_join(call: ast.Call) -> bool:
    """Only thread-shaped joins count as reclamation: no args, or a
    timeout (keyword, or one positional that isn't an iterable literal/
    comprehension).  ``", ".join(names)`` — a string receiver or an
    iterable-literal argument — is the formatting idiom and must NOT
    silence thread-no-reclaim for an unrelated Thread in the same
    function."""
    recv = call.func.value
    if isinstance(recv, ast.Constant):          # ", ".join(...)
        return False
    if len(call.args) > 1:
        return False
    if call.args:
        arg = call.args[0]
        if isinstance(arg, (ast.List, ast.Tuple, ast.Set, ast.ListComp,
                            ast.SetComp, ast.GeneratorExp)):
            return False
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            return False
    return True


_POOL_WRAPPERS = {"list", "tuple", "sorted", "reversed", "enumerate"}


def _pool_iter_chain(it: ast.expr) -> Optional[str]:
    """The attr chain of a for-loop iterable that is a thread POOL
    container: ``self.X`` directly, ``list(self.X)``-style wrappers, or
    ``self.X.values()``."""
    if isinstance(it, ast.Call):
        if (isinstance(it.func, ast.Name)
                and it.func.id in _POOL_WRAPPERS and len(it.args) == 1):
            it = it.args[0]
        elif (isinstance(it.func, ast.Attribute)
              and it.func.attr == "values" and not it.args):
            it = it.func.value
    chain = attr_chain(it)
    return chain if chain and chain.startswith("self.") else None


def _loop_pool_vars(mod) -> Dict[int, str]:
    """id(join-call-node) -> pool attr chain, for every ``v.join(...)``
    whose receiver ``v`` is the loop variable of an enclosing ``for v in
    self.X`` (or a list()/values() wrapper of it) — the worker-pool
    reclamation idiom the per-replica drain fan-out uses."""
    out: Dict[int, str] = {}
    for loop in ast.walk(mod.tree):
        if not isinstance(loop, ast.For):
            continue
        target = loop.target
        var = None
        if isinstance(target, ast.Name):
            var = target.id
        elif (isinstance(target, ast.Tuple) and target.elts
              and isinstance(target.elts[-1], ast.Name)):
            var = target.elts[-1].id          # `for i, t in enumerate(...)`
        if var is None:
            continue
        pool = _pool_iter_chain(loop.iter)
        if pool is None:
            continue
        for n in ast.walk(loop):
            if (isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)
                    and n.func.attr == "join"
                    and isinstance(n.func.value, ast.Name)
                    and n.func.value.id == var):
                out[id(n)] = pool
    return out


def _parents_of(mod) -> Dict[int, ast.AST]:
    cached = getattr(mod, "_dllm_parents", None)
    if cached is None:
        cached = {}
        for parent in ast.walk(mod.tree):
            for child in ast.iter_child_nodes(parent):
                cached[id(child)] = parent
        mod._dllm_parents = cached
    return cached


class ThreadLifecycleChecker(Checker):
    name = "thread_lifecycle"
    rules = ("thread-no-reclaim", "thread-acquire-leak",
             "thread-ring-no-stop")
    scope = ("distributed_llm_tpu_torch",)
    whole_project = True

    def check(self, project: Project) -> List[Finding]:
        ps = project_symbols(project)
        stop_set = _stop_reachable(ps)
        findings: List[Finding] = []
        for mod in project.in_dirs(self.scope):
            syms = symbols_for(mod)
            if syms is None:
                continue
            findings.extend(self._check_threads(mod, syms, ps, stop_set))
            findings.extend(self._check_acquires(mod, syms))
            findings.extend(self._check_rings(mod, syms, ps, stop_set))
        return findings

    # -- rule: thread-no-reclaim -------------------------------------------

    def _check_threads(self, mod, syms, ps: ProjectSymbols,
                       stop_set: Set[str]) -> List[Finding]:
        findings: List[Finding] = []
        rel = mod.relpath
        parents = _parents_of(mod)

        # function qual -> set of attr-chain receivers joined there.  A
        # join on a FOR-loop variable iterating a self attribute (`for t
        # in self._workers: t.join()` — the per-replica worker-pool
        # idiom) records the POOL's chain too, so a pool
        # drained by a stop-family loop counts as reclaimed.
        joins: Dict[str, Set[str]] = {}
        loop_pools = _loop_pool_vars(mod)
        for qual, edges in syms.calls.items():
            for _callee, bare, node in edges:
                if bare == "join" and isinstance(node.func, ast.Attribute) \
                        and _thread_like_join(node):
                    chain = attr_chain(node.func.value)
                    joins.setdefault(qual, set()).add(chain or "<dyn>")
                    pool = loop_pools.get(id(node))
                    if pool is not None:
                        joins[qual].add(pool)

        # Worker-pool appends (`t = Thread(...); self.X.append(t)` or
        # `self.X.append(Thread(...))`): the local binding resolves to
        # the POOL attr, so rule (b) — joined from a stop-family method
        # — applies to pooled per-replica workers exactly as to a
        # single `self.worker = Thread(...)`.
        pool_appends: Dict[str, Dict[str, str]] = {}
        for qual, edges in syms.calls.items():
            for _callee, bare, node in edges:
                if (bare != "append"
                        or not isinstance(node.func, ast.Attribute)
                        or len(node.args) != 1):
                    continue
                pool = attr_chain(node.func.value)
                if not (pool and pool.startswith("self.")):
                    continue
                arg = node.args[0]
                if isinstance(arg, ast.Name):
                    pool_appends.setdefault(qual, {})[arg.id] = pool

        # Assignment targets of every Thread(...) per function: a join
        # must name ITS thread (or an alias/loop variable no thread is
        # bound to) to reclaim it — "any join in the function" let a
        # second, never-joined worker in the same scope pass silently.
        thread_targets: Dict[str, Set[str]] = {}
        for qual, edges in syms.calls.items():
            for _callee, bare, node in edges:
                if bare != "Thread":
                    continue
                parent = parents.get(id(node))
                if (isinstance(parent, ast.Assign)
                        and len(parent.targets) == 1):
                    chain = attr_chain(parent.targets[0])
                    if chain:
                        thread_targets.setdefault(qual, set()).add(chain)

        for qual, edges in syms.calls.items():
            for _callee, bare, node in edges:
                if bare != "Thread":
                    continue
                if _daemon_true(node):
                    continue
                info = syms.functions.get(qual)
                parent = parents.get(id(node))
                target = None
                if (isinstance(parent, ast.Assign)
                        and len(parent.targets) == 1):
                    target = attr_chain(parent.targets[0])
                # (a) joined in the spawning function itself — on the
                # thread's own name, or on a receiver that is not any
                # spawned thread's target (the `for t in threads:
                # t.join()` loop-variable idiom).  Untargeted spawns
                # (list appends, inline starts) accept any
                # thread-shaped join: the binding is untraceable.
                fn_joins = joins.get(qual, set())
                if target is not None:
                    alias_joins = fn_joins - thread_targets.get(qual,
                                                                set())
                    if target in fn_joins or alias_joins:
                        continue
                elif fn_joins:
                    continue
                # (b) parked on self.X — directly, or pooled via
                # `self.X.append(t)` / `self.X.append(Thread(...))` —
                # and joined from a stop-family method of the same
                # class (a `for t in self.X: t.join()` loop there
                # reclaims the whole pool).
                attr = target if target and target.startswith("self.") \
                    else None
                if attr is None:
                    if target is not None:
                        attr = pool_appends.get(qual, {}).get(target)
                    else:
                        parent_call = parents.get(id(node))
                        if (isinstance(parent_call, ast.Call)
                                and isinstance(parent_call.func,
                                               ast.Attribute)
                                and parent_call.func.attr == "append"):
                            chain = attr_chain(parent_call.func.value)
                            if chain and chain.startswith("self."):
                                attr = chain
                reclaimed = False
                if attr is not None and info is not None \
                        and info.class_name:
                    for jqual, chains in joins.items():
                        jinfo = syms.functions.get(jqual)
                        if jinfo is None \
                                or jinfo.class_name != info.class_name:
                            continue
                        if attr not in chains:
                            continue
                        jgid = f"{rel}:{jqual}"
                        leaf = jqual.split(".")[-1]
                        if STOP_NAME_RE.match(leaf) or jgid in stop_set:
                            reclaimed = True
                            break
                if reclaimed:
                    continue
                findings.append(Finding(
                    "thread-no-reclaim", rel, node.lineno,
                    "non-daemon Thread is neither joined in its "
                    "spawning function nor joined from any "
                    "stop/close/drain path — it outlives shutdown and "
                    "blocks process exit; set daemon=True or wire the "
                    "join into the stop path"))
        return findings

    # -- rule: thread-acquire-leak -----------------------------------------

    def _check_acquires(self, mod, syms) -> List[Finding]:
        findings: List[Finding] = []
        rel = mod.relpath
        for qual, info in syms.functions.items():
            if isinstance(info.node, ast.Lambda):
                continue
            acquires: List[Tuple[ast.Call, str]] = []
            releases_in_finally: Set[str] = set()
            releases_anywhere: Set[str] = set()

            def scan(nodes, in_finally: bool) -> None:
                stack = [(n, in_finally) for n in nodes]
                while stack:
                    n, fin = stack.pop()
                    if isinstance(n, (ast.FunctionDef,
                                      ast.AsyncFunctionDef, ast.Lambda)):
                        continue
                    if isinstance(n, ast.Try):
                        scan(n.body, fin)
                        for h in n.handlers:
                            scan(h.body, fin)
                        scan(n.orelse, fin)
                        scan(n.finalbody, True)
                        continue
                    if isinstance(n, ast.Call) \
                            and isinstance(n.func, ast.Attribute) \
                            and n.func.attr in ("acquire", "release"):
                        lock = syms.resolve_lock(n.func.value, qual,
                                                 info.class_name)
                        if lock is not None:
                            if n.func.attr == "acquire":
                                acquires.append((n, lock))
                            else:
                                releases_anywhere.add(lock)
                                if fin:
                                    releases_in_finally.add(lock)
                    stack.extend((c, fin)
                                 for c in ast.iter_child_nodes(n))

            scan(info.node.body, False)
            for node, lock in acquires:
                if lock in releases_in_finally:
                    continue
                where = ("released only outside any `finally`"
                         if lock in releases_anywhere
                         else "never released in this function")
                findings.append(Finding(
                    "thread-acquire-leak", rel, node.lineno,
                    f"manual `{lock}.acquire()` is {where} — an "
                    f"exception between acquire and release holds the "
                    f"lock forever (the NEXT caller deadlocks); use "
                    f"`with` or try/finally, or justify who owns the "
                    f"release"))
        return findings

    # -- rule: thread-ring-no-stop -----------------------------------------

    def _check_rings(self, mod, syms, ps: ProjectSymbols,
                     stop_set: Set[str]) -> List[Finding]:
        findings: List[Finding] = []
        rel = mod.relpath

        # Local classes that start threads, and their stop-family
        # method names.
        owners: Dict[str, Tuple[ast.ClassDef, Set[str]]] = {}
        for node in mod.tree.body:
            if not isinstance(node, ast.ClassDef):
                continue
            starts_thread = any(
                isinstance(n, ast.Call) and call_name(n) == "Thread"
                for n in ast.walk(node))
            if not starts_thread:
                continue
            hooks = {m.name for m in node.body
                     if isinstance(m, (ast.FunctionDef,
                                       ast.AsyncFunctionDef))
                     and STOP_NAME_RE.match(m.name)}
            owners[node.name] = (node, hooks)
        if not owners:
            return findings

        # Module-scope instantiations of those classes.
        for node in mod.tree.body:
            value = None
            targets: List[ast.expr] = []
            if isinstance(node, ast.Assign):
                value, targets = node.value, node.targets
            elif isinstance(node, ast.AnnAssign):
                value, targets = node.value, [node.target]
            if not isinstance(value, ast.Call):
                continue
            cls_name = call_name(value)
            if cls_name not in owners:
                continue
            inst_names = {c.rsplit(".", 1)[-1] for c in
                          (attr_chain(t) for t in targets) if c}
            _cls, hooks = owners[cls_name]
            if not hooks:
                findings.append(Finding(
                    "thread-ring-no-stop", rel, node.lineno,
                    f"module-scope `{cls_name}` instance owns a thread "
                    f"but the class defines no stop/close/shutdown "
                    f"hook — a drained process cannot reclaim it"))
                continue
            # The hook must be CALLED, on THIS instance, from somewhere
            # a stop path reaches: hook-name match inside the stop
            # closure with the receiver's leaf naming the singleton
            # (receivers are untypeable statically — but a bare
            # name-only match let an unrelated `fh.close()` anywhere in
            # a drain path mark a never-stopped recorder reclaimed).
            called = False
            for gid in stop_set:
                for _c, bare, n in ps.calls.get(gid, ()):
                    if bare not in hooks \
                            or not isinstance(n.func, ast.Attribute):
                        continue
                    recv = attr_chain(n.func.value)
                    if recv and recv.rsplit(".", 1)[-1] in inst_names:
                        called = True
                        break
                if called:
                    break
            if not called:
                findings.append(Finding(
                    "thread-ring-no-stop", rel, node.lineno,
                    f"module-scope `{cls_name}` instance owns a thread; "
                    f"its {sorted(hooks)} hook is never called from any "
                    f"drain/stop path — a drained process keeps the "
                    f"thread alive"))
        return findings
