"""Per-function control-flow graphs with exception edges — the dataflow
substrate for the v3 ownership checker (lint/checkers/ownership.py).

The graph is statement-granular: one node per simple statement, one node
per atomic branch condition (``and``/``or`` chains are decomposed into
their short-circuit conjuncts so a guard like ``blocks is None and
pop_oldest() is not None`` refines ``blocks`` before the second conjunct
can run), plus three synthetic nodes — ENTRY, EXIT (normal completion:
``return`` or falling off the end) and RAISES (an exception escaping the
function).

Exception edges — what can raise
--------------------------------

Only statements that *contain a call* (plus ``raise``, ``assert`` and
``for``-iteration headers) get an exception edge.  Attribute reads,
subscripts and arithmetic can raise in principle, but modelling them
would hang an exceptional exit off nearly every line, and every such
edge is a potential leak report; a dataflow client that must not
manufacture findings needs the edge set to under-approximate, never
over-approximate (a missing edge hides a real leak — acceptable; an
impossible edge invents one — not).  Calls inside ``lambda``/nested
``def`` bodies do not count: building a closure raises nothing.

Where an exception lands:

- inside ``try`` with handlers: at the handler-dispatch node, which
  fans out to every handler head.  A handler set is *catch-all* when it
  includes a bare ``except``, ``except BaseException`` or ``except
  Exception`` — otherwise the dispatch keeps an extra edge outward
  (a non-matching exception keeps propagating).  Treating ``Exception``
  as catch-all is a deliberate approximation: the only traffic it
  misses is KeyboardInterrupt/SystemExit, and charging every
  ``except Exception: cleanup`` block with a phantom escape path would
  drown real findings in un-actionable ones.
- ``finally`` bodies are CLONED per completion class (normal /
  exceptional / return / break / continue), each clone wired to that
  class's continuation — precise routing, not a merged
  over-approximation.  Bodies are tiny in this repo; at most a handful
  of clones each.
- ``with`` blocks add no special routing: the context expression's
  calls can raise, body exceptions propagate outward.  A context
  manager that *suppresses* exceptions in ``__exit__`` is not modelled
  (none in this repo do).

Not built: ``match`` statements (none in the repo; the builder raises
:class:`UnsupportedFlow` so clients can skip the function rather than
analyze a graph with holes).  Generator and ``async`` bodies build
fine but callers should skip them — a suspended frame's lifetime is
not path-shaped (see the ownership checker's scope rules).
"""

from __future__ import annotations

import ast
from typing import Callable, Dict, List, Optional, Tuple

__all__ = [
    "CFG", "Node", "Edge", "UnsupportedFlow", "build_cfg", "stmt_raises",
    "contains_call",
]

# Node kinds.  "stmt" carries a simple statement; "test" an atomic branch
# condition; "for-iter" evaluates the iterable; "for-bind" rebinds the
# loop target each iteration; "with" evaluates context expressions and
# binds ``as`` targets; "except" binds a handler's ``as`` name; "join"
# is an empty wiring point (includes ENTRY); "exit"/"raises" terminate.
STMT, TEST, JOIN, EXIT, RAISES = "stmt", "test", "join", "exit", "raises"


class UnsupportedFlow(Exception):
    """Raised for control flow the builder does not model (``match``)."""


class Edge:
    """One successor edge.  ``exc`` marks exceptional flow.  ``refine``
    is ``(test_expr, branch_is_true)`` on the two out-edges of a test
    node so dataflow clients can narrow optional-acquire states."""

    __slots__ = ("dst", "exc", "refine")

    def __init__(self, dst: int, exc: bool = False,
                 refine: Optional[Tuple[ast.expr, bool]] = None):
        self.dst = dst
        self.exc = exc
        self.refine = refine

    def __repr__(self):  # pragma: no cover - debugging aid
        tag = "!" if self.exc else ""
        return f"->{tag}{self.dst}"


class Node:
    __slots__ = ("ix", "kind", "stmt", "expr", "succ")

    def __init__(self, ix: int, kind: str, stmt: Optional[ast.AST] = None,
                 expr: Optional[ast.expr] = None):
        self.ix = ix
        self.kind = kind
        self.stmt = stmt          # payload statement (STMT / for-* / with)
        self.expr = expr          # payload expression (TEST)
        self.succ: List[Edge] = []

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"<{self.kind}@{self.ix} {self.succ}>"


class CFG:
    """nodes[entry] is a JOIN; EXIT/RAISES have no successors."""

    def __init__(self):
        self.nodes: List[Node] = []
        self.entry = 0
        self.exit = 0
        self.raises = 0


def contains_call(node: ast.AST) -> bool:
    """True if evaluating ``node`` runs a call — calls under
    ``lambda``/nested ``def`` are building closures, not running them."""
    stack = [node]
    while stack:
        cur = stack.pop()
        if isinstance(cur, ast.Call):
            return True
        if isinstance(cur, (ast.Lambda, ast.FunctionDef,
                            ast.AsyncFunctionDef)) and cur is not node:
            continue                      # closure body: not executed now
        stack.extend(ast.iter_child_nodes(cur))
    return False


def stmt_raises(stmt: ast.stmt) -> bool:
    """Can executing this *simple* statement raise (see module doc)?"""
    if isinstance(stmt, (ast.Raise, ast.Assert)):
        return True
    return contains_call(stmt)


_SIMPLE = (ast.Assign, ast.AugAssign, ast.AnnAssign, ast.Expr, ast.Delete,
           ast.Pass, ast.Import, ast.ImportFrom, ast.Global, ast.Nonlocal,
           ast.Assert)


class _Builder:
    """Backward block builder: each statement is wired knowing the node
    that follows it.  Abrupt-completion targets (where ``raise``,
    ``return``, ``break``, ``continue`` land) are *thunks* so that
    entering a ``try/finally`` can wrap them with a freshly cloned
    ``finally`` body, memoized per (scope, continuation) pair."""

    def __init__(self):
        self.cfg = CFG()
        entry = self._node(JOIN)
        self.cfg.entry = entry.ix
        self.cfg.exit = self._node(EXIT).ix
        self.cfg.raises = self._node(RAISES).ix
        # Routing thunks: call → node index to jump to.
        self._exc: Callable[[], int] = lambda: self.cfg.raises
        self._ret: Callable[[], int] = lambda: self.cfg.exit
        self._loops: List[Tuple[Callable[[], int], Callable[[], int]]] = []

    # -- graph primitives --------------------------------------------------

    def _node(self, kind: str, stmt: Optional[ast.AST] = None,
              expr: Optional[ast.expr] = None) -> Node:
        n = Node(len(self.cfg.nodes), kind, stmt, expr)
        self.cfg.nodes.append(n)
        return n

    def _edge(self, src: int, dst: int, exc: bool = False,
              refine=None) -> None:
        self.cfg.nodes[src].succ.append(Edge(dst, exc, refine))

    # -- blocks ------------------------------------------------------------

    def build(self, func) -> CFG:
        body_entry = self._block(func.body, self.cfg.exit)
        self._edge(self.cfg.entry, body_entry)
        return self.cfg

    def _block(self, stmts: List[ast.stmt], follow: int) -> int:
        for st in reversed(stmts):
            follow = self._stmt(st, follow)
        return follow

    # -- statements --------------------------------------------------------

    def _stmt(self, st: ast.stmt, follow: int) -> int:
        if isinstance(st, _SIMPLE):
            n = self._node(STMT, stmt=st)
            self._edge(n.ix, follow)
            if stmt_raises(st):
                self._edge(n.ix, self._exc(), exc=True)
            return n.ix
        if isinstance(st, ast.Return):
            n = self._node(STMT, stmt=st)
            self._edge(n.ix, self._ret())
            if st.value is not None and contains_call(st.value):
                self._edge(n.ix, self._exc(), exc=True)
            return n.ix
        if isinstance(st, ast.Raise):
            n = self._node(STMT, stmt=st)
            self._edge(n.ix, self._exc(), exc=True)
            return n.ix
        if isinstance(st, ast.Break):
            n = self._node(STMT, stmt=st)
            self._edge(n.ix, self._loops[-1][0]())
            return n.ix
        if isinstance(st, ast.Continue):
            n = self._node(STMT, stmt=st)
            self._edge(n.ix, self._loops[-1][1]())
            return n.ix
        if isinstance(st, ast.If):
            true_ix = self._block(st.body, follow)
            false_ix = self._block(st.orelse, follow) if st.orelse else follow
            return self._test(st.test, true_ix, false_ix)
        if isinstance(st, ast.While):
            return self._while(st, follow)
        if isinstance(st, (ast.For, ast.AsyncFor)):
            return self._for(st, follow)
        if isinstance(st, (ast.With, ast.AsyncWith)):
            return self._with(st, follow)
        if isinstance(st, ast.Try):
            return self._try(st, follow)
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
            # Nested definition: the body is not executed here; the
            # decorators/defaults are.  One opaque node suffices —
            # escape analysis of closed-over names is the checker's job.
            n = self._node(STMT, stmt=st)
            self._edge(n.ix, follow)
            if any(contains_call(d) for d in getattr(st, "decorator_list",
                                                     ())):
                self._edge(n.ix, self._exc(), exc=True)
            return n.ix
        # match (3.10+) and anything newer: refuse rather than build a
        # graph with invisible inner flow.
        raise UnsupportedFlow(type(st).__name__)

    def _while(self, st: ast.While, follow: int) -> int:
        head = self._node(JOIN)
        # ``else`` runs on normal loop exhaustion, not on break.
        after_else = self._block(st.orelse, follow) if st.orelse else follow
        self._loops.append((lambda: follow, lambda: head.ix))
        try:
            body_entry = self._block(st.body, head.ix)
        finally:
            self._loops.pop()
        test_entry = self._test(st.test, body_entry, after_else)
        self._edge(head.ix, test_entry)
        return head.ix

    def _for(self, st, follow: int) -> int:
        # iter-node (evaluate the iterable) → dispatch ⇄ bind → body.
        dispatch = self._node(JOIN)
        after_else = self._block(st.orelse, follow) if st.orelse else follow
        self._loops.append((lambda: follow, lambda: dispatch.ix))
        try:
            body_entry = self._block(st.body, dispatch.ix)
        finally:
            self._loops.pop()
        bind = self._node("for-bind", stmt=st)
        self._edge(bind.ix, body_entry)
        self._edge(dispatch.ix, bind.ix)
        self._edge(dispatch.ix, after_else)
        it = self._node("for-iter", stmt=st)
        self._edge(it.ix, dispatch.ix)
        if contains_call(st.iter):
            self._edge(it.ix, self._exc(), exc=True)
        return it.ix

    def _with(self, st, follow: int) -> int:
        body_entry = self._block(st.body, follow)
        n = self._node("with", stmt=st)
        self._edge(n.ix, body_entry)
        if any(contains_call(item.context_expr) for item in st.items):
            self._edge(n.ix, self._exc(), exc=True)
        return n.ix

    # -- branch conditions -------------------------------------------------

    def _test(self, expr: ast.expr, true_ix: int, false_ix: int) -> int:
        """Short-circuit decomposition: one TEST node per atomic
        conjunct, refinement labels on its true/false edges."""
        if isinstance(expr, ast.BoolOp) and isinstance(expr.op, ast.And):
            for v in reversed(expr.values):
                true_ix = self._test(v, true_ix, false_ix)
            return true_ix
        if isinstance(expr, ast.BoolOp) and isinstance(expr.op, ast.Or):
            for v in reversed(expr.values):
                false_ix = self._test(v, true_ix, false_ix)
            return false_ix
        if isinstance(expr, ast.UnaryOp) and isinstance(expr.op, ast.Not):
            return self._test(expr.operand, false_ix, true_ix)
        const: Optional[bool] = None
        if isinstance(expr, ast.Constant):
            const = bool(expr.value)
        n = self._node(TEST, expr=expr)
        if const is None or const:
            self._edge(n.ix, true_ix, refine=(expr, True))
        if const is None or not const:
            self._edge(n.ix, false_ix, refine=(expr, False))
        if contains_call(expr):
            self._edge(n.ix, self._exc(), exc=True)
        return n.ix

    # -- try / except / finally --------------------------------------------

    def _try(self, st: ast.Try, follow: int) -> int:
        outer_exc, outer_ret = self._exc, self._ret
        outer_loops = list(self._loops)

        if st.finalbody:
            # Wrap every routing thunk with a clone of the finally body
            # whose continuation is that thunk's target; memoize per
            # continuation so e.g. fifty calls in the body share one
            # exceptional clone.
            cache: Dict[int, int] = {}

            def through_finally(target_thunk):
                def thunk():
                    target = target_thunk()
                    if target not in cache:
                        cache[target] = self._block(st.finalbody, target)
                    return cache[target]
                return thunk

            follow = through_finally(lambda: follow)()
            self._exc = through_finally(outer_exc)
            self._ret = through_finally(outer_ret)
            self._loops = [(through_finally(b), through_finally(c))
                           for (b, c) in self._loops]

        # From here the thunks are the finally-wrapped outer targets —
        # what handler bodies and the dispatch escape edge use.  Handlers
        # are built BEFORE the body override below, so an exception
        # raised inside a handler routes outward, never back to itself.
        if st.handlers:
            dispatch = self._node(JOIN)
            for h in st.handlers:
                head = self._node("except", stmt=h)
                self._edge(head.ix, self._block(h.body, follow))
                self._edge(dispatch.ix, head.ix)
            if not _catches_all(st.handlers):
                self._edge(dispatch.ix, self._exc(), exc=True)
            body_exc: Callable[[], int] = lambda: dispatch.ix
        else:
            body_exc = self._exc

        body_follow = self._block(st.orelse, follow) if st.orelse else follow
        self._exc = body_exc
        try:
            body_entry = self._block(st.body, body_follow)
        finally:
            self._exc, self._ret = outer_exc, outer_ret
            self._loops = outer_loops
        return body_entry


def _catches_all(handlers: List[ast.ExceptHandler]) -> bool:
    for h in handlers:
        if h.type is None:
            return True
        t = h.type
        names = ([_leaf(e) for e in t.elts] if isinstance(t, ast.Tuple)
                 else [_leaf(t)])
        if "BaseException" in names or "Exception" in names:
            return True
    return False


def _leaf(expr: ast.expr) -> Optional[str]:
    if isinstance(expr, ast.Name):
        return expr.id
    if isinstance(expr, ast.Attribute):
        return expr.attr
    return None


def build_cfg(func) -> CFG:
    """CFG for one ``FunctionDef``/``AsyncFunctionDef``.  Raises
    :class:`UnsupportedFlow` on ``match`` statements."""
    return _Builder().build(func)
