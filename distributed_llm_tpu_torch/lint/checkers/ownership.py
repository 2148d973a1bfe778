"""Ownership & lifecycle dataflow checker (v3).

PRs 10-17 paired every resource manually: refcounted block
``alloc``/``share``/``free``, prefix-entry ``take``/``untake``/
``share``/``unshare``/``pin``/``unpin``, spill-tier promotion
``claim``/``release``, admission permits, and warm-pool replica
handles.  Each pair is enforced only by tests on the happy path; the
failure shape that actually bites is an exception between acquire and
release — a silent pool leak, or a cleanup that runs twice and
corrupts the survivor.  This checker makes those paths structural: it
propagates an abstract ownership state for every locally-acquired
resource along a per-function CFG with exception edges (lint/cfg.py)
and reports exits where a resource is still owned, releases of
already-released resources, and uses after an ownership handoff.

Rules
-----

- ``own-leak-on-path``: an acquired resource (blocks, replica handle,
  admission permit) reaches a function exit — normal or exceptional —
  still owned, or its binding is overwritten/discarded while owned.
- ``own-pin-no-unpin``: the same, for pin-kind protocols (prefix-cache
  entry pins, spill promotion claims) whose release is a pin drop.
- ``own-double-release``: a release executes on a state that can only
  be already-released (``RELEASED`` possible, ``OWNED`` not) — the
  second ``free`` corrupts whoever reused the blocks.
- ``own-use-after-transfer``: a release or hand-off executes after
  ownership already moved (e.g. ``free`` after ``prefix_cache.put``
  parked the blocks, ``stop_server`` on a replica already published to
  the member list).

Abstract state — a MAY-set per variable over {OWNED, NONE, RELEASED,
TRANSFERRED, ESCAPED}:

- acquire sites bind ``{OWNED}`` (``{OWNED, NONE}`` for acquires that
  can return None; ``x = alloc(n) if flag else None`` works too), and
  ``x is None`` / ``x is not None`` / truthiness tests narrow the set
  per branch (an edge whose refinement empties the set is infeasible
  and not taken — that is the path sensitivity).
- anything the analysis cannot prove non-retaining ESCAPES: passing
  the variable to an unresolved call, storing it in a container or
  attribute, aliasing it, returning it, or referencing it from a
  nested ``def``/``lambda``.  Escaped resources are never reported —
  the v2 no-false-edge invariant: missing a leak is acceptable,
  inventing one is not.  A short whitelist of provably non-retaining
  callees (``len``, ``np.asarray``, …) keeps bookkeeping reads from
  killing tracking.
- interprocedural summaries ride the ProjectSymbols call graph: a
  resolved callee that releases/escapes its parameter summarizes as
  such (fixpoint over the graph); unresolved callees conservatively
  escape their arguments.
- exception edges apply a statement's effects *optimistically*
  (releases count, acquires do not bind) — again the FP-safe
  direction: a cleanup call that itself raises mid-release is treated
  as having released.

Deliberate limits:
may-set joins mean a double-release hidden behind ``OWNED`` on a
sibling path is not reported; resources carried in tuples past
unpacking, generator/async bodies, and ownership that begins at a
membership *removal* (``_pick_victim``) are untracked; admission
permits are checked on normal exits only (``exc_edges=False`` row) —
their release-on-error discipline is the router's ``finally`` and is
exercised dynamically.

Adding a protocol is one table row in ``PROTOCOLS`` below.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from ..cfg import UnsupportedFlow, build_cfg
from ..core import Checker, Finding, Project
from ..symbols import (FuncInfo, ProjectSymbols, _own_walk, attr_chain,
                       project_symbols, symbols_for)

OWN_LEAK = "own-leak-on-path"
OWN_DOUBLE = "own-double-release"
OWN_UAT = "own-use-after-transfer"
OWN_PIN = "own-pin-no-unpin"

# Abstract states (elements of a per-variable may-set).
OWNED, NONE, RELEASED, TRANSFERRED, ESCAPED = "O", "N", "R", "T", "E"

# Callee leaf names that provably do not retain their arguments —
# reads that copy values out (or mutate the container in place) and
# drop the reference.  Everything else escapes.
NON_RETAINING = frozenset({
    "len", "isinstance", "bool", "int", "float", "str", "repr", "id",
    "type", "hash", "abs", "round", "min", "max", "sum", "any", "all",
    "print", "format", "count", "index", "remove", "discard", "sorted",
    "asarray", "array", "get_event_loop", "debug", "info", "warning",
    "error", "exception",
})


@dataclass(frozen=True)
class Sig:
    """One acquire/release/transfer call signature.

    ``recv`` — receiver *leaf* names that identify the protocol object
    (``self.kv_spill.claim`` → leaf ``kv_spill``); empty = any.
    ``bind`` (acquires) — "result" binds the call result, "arg0" marks
    the first argument as acquired (``allocator.share(blocks)``).
    ``arg`` (releases/transfers) — "arg0": the resource is the first
    argument (a plain name, ``x[0]``, or ``[x]``); "any": any tracked
    argument; "recv_root": the resource is the *root* of the receiver
    chain (``victim.mgr.stop_server()``); "all": applies to every
    live resource of the protocol (``admission.release()`` names no
    handle).
    """

    method: str
    recv: Tuple[str, ...] = ()
    bind: str = "result"
    optional: bool = False
    arg: str = "arg0"


@dataclass(frozen=True)
class Protocol:
    name: str
    kind: str = "resource"            # "resource" | "pin" | "permit"
    acquires: Tuple[Sig, ...] = ()
    releases: Tuple[Sig, ...] = ()
    transfers: Tuple[Sig, ...] = ()
    exc_edges: bool = True
    none_is_acquired: bool = False    # try_admit: None result = held
    release_hint: str = ""


PROTOCOLS: Tuple[Protocol, ...] = (
    Protocol(
        name="kv-blocks",
        acquires=(Sig("alloc", recv=("allocator",), optional=True),
                  Sig("_alloc_evicting", recv=("self",), optional=True),
                  Sig("share", recv=("allocator",), bind="arg0")),
        releases=(Sig("free", recv=("allocator",)),),
        transfers=(Sig("put", recv=("prefix_cache",), arg="any"),),
        release_hint="self.allocator.free(blocks)",
    ),
    Protocol(
        name="prefix-pin", kind="pin",
        acquires=(Sig("take", recv=("prefix_cache",), optional=True),
                  Sig("share", recv=("prefix_cache",), optional=True)),
        releases=(Sig("untake", recv=("prefix_cache",)),
                  Sig("unshare", recv=("prefix_cache",)),
                  Sig("unpin", recv=("prefix_cache",)),
                  Sig("put", recv=("prefix_cache",))),
        release_hint="prefix_cache.untake/unshare/unpin(entry)",
    ),
    Protocol(
        name="spill-pin", kind="pin",
        acquires=(Sig("claim", recv=("kv_spill", "spill"),
                      optional=True),),
        releases=(Sig("release", recv=("kv_spill", "spill")),),
        release_hint="kv_spill.release(entry, promoted=...)",
    ),
    Protocol(
        name="admission-permit", kind="permit",
        acquires=(Sig("try_admit", recv=("admission",), optional=True),),
        releases=(Sig("release", recv=("admission",), arg="all"),),
        exc_edges=False, none_is_acquired=True,
        release_hint="self.admission.release(dt)",
    ),
    Protocol(
        name="replica-handle",
        acquires=(Sig("pop", recv=("_standby",)),
                  Sig("_build_replica", recv=("self",))),
        releases=(Sig("append", recv=("_standby",)),
                  Sig("stop_server", arg="recv_root"),
                  Sig("drain", arg="recv_root")),
        transfers=(Sig("append", recv=("_members",)),),
        release_hint="self._standby.append(r) or r.mgr.stop_server()",
    ),
    Protocol(
        # Crash rescue: a capture_requests() result is the
        # victim replica's in-flight work — live _Request objects with
        # callers blocked on done.wait().  It must reach exactly one
        # home: adopted by a sibling/restarted engine (transfer) or
        # failed with the engine-stopped shape (release).  A path that
        # drops the list strands callers forever; adopting twice would
        # decode the same stream on two engines.
        name="rescue-capture",
        acquires=(Sig("capture_requests"),),
        releases=(Sig("fail_captured", arg="arg0"),),
        transfers=(Sig("adopt_requests", arg="arg0"),),
        release_hint="engine.adopt_requests(captured) or "
                     "fail_captured(captured, tier_name)",
    ),
)

_LEAK_RULE = {"resource": OWN_LEAK, "permit": OWN_LEAK, "pin": OWN_PIN}


# -- call-shape matching ---------------------------------------------------

def _call_parts(call: ast.Call) -> Optional[List[str]]:
    chain = attr_chain(call.func)
    if chain is None:
        if isinstance(call.func, ast.Name):
            return [call.func.id]
        return None
    return chain.split(".")


def _sig_matches_call(sig: Sig, parts: List[str]) -> bool:
    if parts[-1] != sig.method:
        return False
    if not sig.recv:
        return True
    return len(parts) >= 2 and parts[-2] in sig.recv


# Call sites of permit WRAPPERS (``_derive_wrappers``), keyed by
# id(Call node) for the run in progress: an admission helper that returns
# the permit's verdict is an acquire at its callers, and a helper around
# the permit's release is a release there.
_WRAPPED: Dict[str, Dict[int, Tuple[Protocol, Sig]]] = {
    "acquires": {}, "releases": {}}


def match_acquire(call: ast.Call) -> Optional[Tuple[Protocol, Sig]]:
    wrapped = _WRAPPED["acquires"].get(id(call))
    if wrapped is not None:
        return wrapped
    parts = _call_parts(call)
    if parts is None:
        return None
    for proto in PROTOCOLS:
        for sig in proto.acquires:
            if _sig_matches_call(sig, parts):
                return proto, sig
    return None


def _match_in(call: ast.Call, table: str) -> List[Tuple[Protocol, Sig]]:
    wrapped = _WRAPPED.get(table, {}).get(id(call))
    if wrapped is not None:
        return [wrapped]
    parts = _call_parts(call)
    if parts is None:
        return []
    out = []
    for proto in PROTOCOLS:
        for sig in getattr(proto, table):
            if _sig_matches_call(sig, parts):
                out.append((proto, sig))
    return out


def _release_arg_names(call: ast.Call, sig: Sig) -> Set[str]:
    """Variable names a release/transfer sig designates in this call:
    args[0] as ``x``, ``x[0]`` (single index, not a slice) or ``[x]``
    for arg0 mode; every directly-named argument for "any" mode."""
    def name_of(expr: ast.expr) -> Optional[str]:
        if isinstance(expr, ast.Name):
            return expr.id
        if (isinstance(expr, ast.Subscript)
                and isinstance(expr.value, ast.Name)
                and not isinstance(expr.slice, ast.Slice)):
            return expr.value.id
        if (isinstance(expr, (ast.List, ast.Tuple)) and len(expr.elts) == 1
                and isinstance(expr.elts[0], ast.Name)):
            return expr.elts[0].id
        return None

    if sig.arg == "arg0":
        if call.args:
            n = name_of(call.args[0])
            return {n} if n else set()
        return set()
    if sig.arg == "any":
        out = set()
        for a in list(call.args) + [k.value for k in call.keywords]:
            n = name_of(a)
            if n:
                out.add(n)
        return out
    return set()


def _recv_root_release(call: ast.Call) -> List[Tuple[Protocol, Sig, str]]:
    """``victim.mgr.stop_server()`` → (replica-handle, sig, "victim")."""
    parts = _call_parts(call)
    if parts is None or len(parts) < 2:
        return []
    out = []
    for proto in PROTOCOLS:
        for sig in proto.releases:
            if sig.arg == "recv_root" and parts[-1] == sig.method:
                out.append((proto, sig, parts[0]))
    return out


# -- occurrence classification ---------------------------------------------

def _parent_map(root: ast.AST) -> Dict[int, ast.AST]:
    parents: Dict[int, ast.AST] = {}
    stack = [root]
    while stack:
        cur = stack.pop()
        for ch in ast.iter_child_nodes(cur):
            parents[id(ch)] = cur
            stack.append(ch)
    return parents


def _in_nested_def(node: ast.AST, stop: ast.AST,
                   parents: Dict[int, ast.AST]) -> bool:
    cur = parents.get(id(node))
    while cur is not None and cur is not stop:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda)):
            return True
        cur = parents.get(id(cur))
    return False


# Classification tokens.
PURE, ESCAPE = "pure", "escape"


def _classify_use(name: ast.Name, stmt: ast.stmt,
                  parents: Dict[int, ast.AST]):
    """Classify one Load occurrence of a tracked name.

    Returns one of: ("pure",) · ("escape",) · ("release", proto, sig) ·
    ("transfer", proto, sig) · ("acquire_arg", proto, sig) ·
    ("call_arg", call_node, pos_or_kwname).

    The walk ascends through *transparent* wrappers (subscripts,
    starred, f-string pieces) until a decisive context; attribute
    reads are terminal PURE — ``r.name`` projects a non-resource
    value, unlike ``blocks[0]`` which projects the resource itself.
    """
    if _in_nested_def(name, stmt, parents):
        return (ESCAPE,)        # closure capture: lifetime leaves scope
    node: ast.AST = name
    while True:
        parent = parents.get(id(node))
        if parent is None:
            return (PURE,)
        if isinstance(parent, ast.Attribute):
            # x.attr — maybe the receiver of a recv_root release
            # (victim.mgr.stop_server()); else a plain projection.
            chain_top: ast.AST = parent
            up = parents.get(id(chain_top))
            while isinstance(up, ast.Attribute):
                chain_top, up = up, parents.get(id(up))
            if (isinstance(up, ast.Call) and up.func is chain_top
                    and isinstance(name, ast.Name)):
                for proto, sig, root in _recv_root_release(up):
                    if root == name.id:
                        return ("release", proto, sig)
            return (PURE,)
        if isinstance(parent, (ast.Subscript, ast.Starred)):
            node = parent
            continue
        if isinstance(parent, (ast.FormattedValue, ast.JoinedStr)):
            return (PURE,)
        if isinstance(parent, ast.Call):
            if parent.func is node:
                return (PURE,)          # calling x() — a read
            return _classify_call_arg(name, node, parent)
        if isinstance(parent, ast.keyword):
            call = parents.get(id(parent))
            if isinstance(call, ast.Call):
                return _classify_call_arg(name, node, call,
                                          kwname=parent.arg)
            return (ESCAPE,)
        if isinstance(parent, ast.Return):
            return (ESCAPE,)
        if isinstance(parent, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            return (ESCAPE,)            # alias / stored value
        if isinstance(parent, (ast.List, ast.Tuple, ast.Set, ast.Dict)):
            return (ESCAPE,)            # stored in a container
        if isinstance(parent, ast.BinOp):
            return (ESCAPE,)            # list concat aliases contents
        if isinstance(parent, (ast.Compare, ast.BoolOp, ast.UnaryOp)):
            return (PURE,)
        if isinstance(parent, ast.IfExp):
            if parent.test is node:
                return (PURE,)
            return (ESCAPE,)
        if isinstance(parent, (ast.For, ast.AsyncFor)):
            return (PURE,)              # iteration reads elements
        if isinstance(parent, (ast.comprehension, ast.Slice, ast.Expr,
                               ast.If, ast.While, ast.withitem)):
            return (PURE,)
        if isinstance(parent, ast.Raise):
            return (ESCAPE,)
        return (PURE,)


def _classify_call_arg(name: ast.Name, arg_node: ast.AST, call: ast.Call,
                       kwname: Optional[str] = None):
    """``name`` reaches ``call`` as (possibly wrapped) argument
    ``arg_node``; decide what the call does with it."""
    direct = arg_node is name
    for proto, sig in _match_in(call, "releases"):
        if sig.arg in ("arg0", "any") and \
                name.id in _release_arg_names(call, sig):
            return ("release", proto, sig)
    for proto, sig in _match_in(call, "transfers"):
        if name.id in _release_arg_names(call, sig):
            return ("transfer", proto, sig)
    acq = match_acquire(call)
    if acq is not None and acq[1].bind == "arg0" and direct \
            and call.args and call.args[0] is name:
        return ("acquire_arg",) + acq
    parts = _call_parts(call)
    leaf = parts[-1] if parts else None
    if leaf in NON_RETAINING:
        return (PURE,)
    if direct:
        # Candidate for an interprocedural summary lookup.
        if kwname is not None:
            return ("call_arg", call, kwname)
        try:
            pos = call.args.index(name)
        except ValueError:
            return (ESCAPE,)
        return ("call_arg", call, pos)
    return (ESCAPE,)


# -- interprocedural parameter summaries -----------------------------------

# Effect lattice: pure < release:<proto> < escape.
def _join_effect(a: str, b: str) -> str:
    if ESCAPE in (a, b):
        return ESCAPE
    if a.startswith("release:"):
        return a
    if b.startswith("release:"):
        return b
    return PURE


def _param_names(fi: FuncInfo) -> List[str]:
    a = fi.node.args
    names = [x.arg for x in getattr(a, "posonlyargs", [])]
    names += [x.arg for x in a.args]
    names += [x.arg for x in a.kwonlyargs]
    return names


def _param_key(callee: FuncInfo, pos_or_kw, method_call: bool):
    names = _param_names(callee)
    if callee.class_name is not None and method_call and names:
        names = names[1:]               # drop self/cls
    if isinstance(pos_or_kw, int):
        if pos_or_kw < len(names):
            return names[pos_or_kw]
        return None                     # lands in *args — give up
    return pos_or_kw if pos_or_kw in names else None


def param_summaries(project: Project) -> Dict[str, Dict[str, str]]:
    """gid → {param name → "pure" | "release:<proto>" | "escape"},
    computed to fixpoint over the resolved call graph.  Cached on the
    project object (same idiom as project_symbols)."""
    cached = getattr(project, "_dllm_own_summaries", None)
    if cached is not None:
        return cached
    ps = project_symbols(project)
    # Dependencies: (gid, param) → effects list of either literal
    # effect strings or ("dep", callee_gid, param_key).
    raw: Dict[Tuple[str, str], List] = {}
    for gid, gf in ps.functions.items():
        fi = gf.info
        pnames = set(_param_names(fi))
        if not pnames:
            continue
        parents = _parent_map(fi.node)
        for sub in ast.walk(fi.node):
            if not (isinstance(sub, ast.Name) and sub.id in pnames
                    and isinstance(sub.ctx, ast.Load)):
                continue
            if _in_nested_def(sub, fi.node, parents):
                raw.setdefault((gid, sub.id), []).append(ESCAPE)
                continue
            stmt = sub
            while not isinstance(stmt, ast.stmt):
                nxt = parents.get(id(stmt))
                if nxt is None:
                    break
                stmt = nxt
            tok = _classify_use(sub, stmt, parents)
            if tok[0] == "release":
                raw.setdefault((gid, sub.id), []).append(
                    "release:" + tok[1].name)
            elif tok[0] in ("transfer", ESCAPE):
                raw.setdefault((gid, sub.id), []).append(ESCAPE)
            elif tok[0] == "call_arg":
                call, key = tok[1], tok[2]
                callee_gid = ps.callee_of(gf.relpath, call)
                if callee_gid is None:
                    raw.setdefault((gid, sub.id), []).append(ESCAPE)
                else:
                    callee = ps.functions[callee_gid].info
                    pk = _param_key(callee, key,
                                    isinstance(call.func, ast.Attribute))
                    if pk is None:
                        raw.setdefault((gid, sub.id), []).append(ESCAPE)
                    else:
                        raw.setdefault((gid, sub.id), []).append(
                            ("dep", callee_gid, pk))
            # acquire_arg / pure contribute nothing
    effects: Dict[Tuple[str, str], str] = {k: PURE for k in raw}
    changed = True
    while changed:
        changed = False
        for key, toks in raw.items():
            cur = effects[key]
            for tok in toks:
                if isinstance(tok, tuple):
                    dep = effects.get((tok[1], tok[2]), PURE)
                    cur = _join_effect(cur, dep)
                else:
                    cur = _join_effect(cur, tok)
            if cur != effects[key]:
                effects[key] = cur
                changed = True
    out: Dict[str, Dict[str, str]] = {}
    for (gid, p), eff in effects.items():
        out.setdefault(gid, {})[p] = eff
    project._dllm_own_summaries = out  # type: ignore[attr-defined]
    return out


# -- the per-function dataflow ---------------------------------------------

@dataclass
class _VarInfo:
    proto: Protocol
    lines: Set[int] = field(default_factory=set)
    inverted: bool = False


State = Dict[str, FrozenSet[str]]


def _acquire_value(value: ast.expr):
    """(call, proto, sig, optional) if this assigned value is an
    acquire — a matching Call, or an IfExp with a matching arm."""
    if isinstance(value, ast.Call):
        m = match_acquire(value)
        if m and m[1].bind == "result":
            return value, m[0], m[1], m[1].optional
    if isinstance(value, ast.IfExp):
        for arm in (value.body, value.orelse):
            if isinstance(arm, ast.Call):
                m = match_acquire(arm)
                if m and m[1].bind == "result":
                    return arm, m[0], m[1], True
    return None


class _FuncFlow:
    def __init__(self, mod, fi: FuncInfo, ps: ProjectSymbols,
                 summaries: Dict[str, Dict[str, str]]):
        self.mod = mod
        self.fi = fi
        self.ps = ps
        self.summaries = summaries
        self.vinfo: Dict[str, _VarInfo] = {}
        self.findings: List[Finding] = []
        self._seen: Set[Tuple] = set()
        self.parents = _parent_map(fi.node)
        self.verdict = verdict_wrapper(fi.node)
        # leak bookkeeping: (var, line) → set of exit kinds
        self._leaks: Dict[Tuple[str, int], Set[str]] = {}

    # -- findings ---------------------------------------------------------

    def _emit(self, rule: str, line: int, msg: str, key: Tuple) -> None:
        if key in self._seen:
            return
        self._seen.add(key)
        self.findings.append(Finding(rule, self.mod.relpath, line, msg))

    def _leak(self, var: str, kind: str) -> None:
        info = self.vinfo.get(var)
        if info is None:
            return
        for line in info.lines:
            self._leaks.setdefault((var, line), set()).add(kind)

    def flush_leaks(self) -> None:
        for (var, line), kinds in sorted(self._leaks.items()):
            info = self.vinfo[var]
            rule = _LEAK_RULE[info.proto.kind]
            noun = "pin" if info.proto.kind == "pin" else "resource"
            where = {"exc": "an exception path",
                     "normal": "a normal exit path",
                     "overwrite": "every path (its binding is "
                                  "overwritten while still owned)"}
            kinds_txt = " and ".join(where[k] for k in sorted(kinds))
            self._emit(
                rule, line,
                f"{info.proto.name} {noun} '{var}' acquired here is not "
                f"released on {kinds_txt} — pair the acquire with "
                f"{info.proto.release_hint} on every path, exception "
                f"edges included, or hand ownership off explicitly",
                (rule, var, line))

    # -- state helpers ----------------------------------------------------

    def _track(self, var: str, proto: Protocol, line: int) -> None:
        info = self.vinfo.get(var)
        if info is None or info.proto is not proto:
            self.vinfo[var] = info = _VarInfo(
                proto, inverted=proto.none_is_acquired)
        info.lines.add(line)

    def _release_var(self, S: dict, var: str, line: int,
                     via_summary: bool = False) -> None:
        cur = S.get(var)
        if cur is None:
            return
        info = self.vinfo[var]
        if not via_summary and RELEASED in cur and OWNED not in cur \
                and ESCAPED not in cur:
            self._emit(
                OWN_DOUBLE, line,
                f"{info.proto.name} resource '{var}' (acquired at line "
                f"{min(info.lines)}) is already released when it is "
                f"released again here — the first release's new owner "
                f"is corrupted by the second",
                (OWN_DOUBLE, var, line))
        if not via_summary and TRANSFERRED in cur and OWNED not in cur \
                and ESCAPED not in cur:
            self._emit(
                OWN_UAT, line,
                f"ownership of '{var}' was already transferred "
                f"(acquired at line {min(info.lines)}) when it is "
                f"released here — the new owner controls its lifecycle",
                (OWN_UAT, var, line))
        new = set()
        for s in cur:
            new.add({OWNED: RELEASED, NONE: NONE, RELEASED: RELEASED,
                     TRANSFERRED: TRANSFERRED, ESCAPED: ESCAPED}[s])
        S[var] = frozenset(new)

    def _transfer_var(self, S: dict, var: str, line: int) -> None:
        cur = S.get(var)
        if cur is None:
            return
        info = self.vinfo[var]
        if (TRANSFERRED in cur or RELEASED in cur) and OWNED not in cur \
                and ESCAPED not in cur:
            self._emit(
                OWN_UAT, line,
                f"'{var}' (acquired at line {min(info.lines)}) is handed "
                f"off here but ownership already moved on every path "
                f"reaching this line",
                (OWN_UAT, var, line))
        new = {ESCAPED if s == ESCAPED else
               (NONE if s == NONE else TRANSFERRED) for s in cur}
        S[var] = frozenset(new)

    def _escape_var(self, S: dict, var: str) -> None:
        if var in S:
            S[var] = frozenset({ESCAPED if s != NONE else NONE
                                for s in S[var]})

    def _overwrite(self, S: dict, var: str) -> None:
        cur = S.get(var)
        if cur is not None and OWNED in cur:
            self._leak(var, "overwrite")
        S.pop(var, None)

    # -- statement transfer ------------------------------------------------

    def _apply_uses(self, S: dict, st: ast.AST, line: int) -> None:
        """Releases / transfers / escapes / summaries for every tracked
        name read by this statement, plus arg="all" releases and
        deferred-release closures."""
        tracked = set(S)
        if tracked:
            for sub in ast.walk(st):
                if not (isinstance(sub, ast.Name) and sub.id in tracked
                        and isinstance(sub.ctx, ast.Load)):
                    continue
                var = sub.id
                info = self.vinfo[var]
                tok = _classify_use(sub, st, self.parents)
                ln = getattr(sub, "lineno", line)
                if tok[0] == "release":
                    if tok[1] is info.proto:
                        self._release_var(S, var, ln)
                    else:
                        self._escape_var(S, var)
                elif tok[0] == "transfer":
                    if tok[1] is info.proto:
                        self._transfer_var(S, var, ln)
                    else:
                        self._escape_var(S, var)
                elif tok[0] == "acquire_arg":
                    pass                 # handled as binding below
                elif tok[0] == "call_arg":
                    self._apply_summary(S, var, tok[1], tok[2], ln)
                elif tok[0] == ESCAPE:
                    self._escape_var(S, var)
        # arg="all" releases (admission.release()) and deferred-release
        # closures: a nested def containing a protocol release means
        # the release happens later — stop tracking that protocol.
        for sub in ast.walk(st):
            if isinstance(sub, ast.Call):
                in_closure = _in_nested_def(sub, st, self.parents)
                for proto, sig in _match_in(sub, "releases"):
                    if in_closure:
                        for var, info in list(self.vinfo.items()):
                            if info.proto is proto:
                                self._escape_var(S, var)
                    elif sig.arg == "all":
                        ln = getattr(sub, "lineno", line)
                        for var, info in list(self.vinfo.items()):
                            if info.proto is proto:
                                self._release_var(S, var, ln)

    def _closure_escape(self, S: dict, st: ast.AST) -> None:
        """A nested def/class statement: referenced tracked names and
        deferred-release protocols all escape."""
        protos = set()
        for sub in ast.walk(st):
            if isinstance(sub, ast.Name) and sub.id in S \
                    and isinstance(sub.ctx, ast.Load):
                self._escape_var(S, sub.id)
            if isinstance(sub, ast.Call):
                for proto, _sig in _match_in(sub, "releases"):
                    protos.add(proto)
        for var, info in list(self.vinfo.items()):
            if info.proto in protos:
                self._escape_var(S, var)

    def _apply_summary(self, S: dict, var: str, call: ast.Call,
                       key, line: int) -> None:
        gid = self.ps.callee_of(self.mod.relpath, call)
        if gid is None:
            self._escape_var(S, var)
            return
        callee = self.ps.functions[gid].info
        pk = _param_key(callee, key, isinstance(call.func, ast.Attribute))
        eff = PURE
        if pk is None:
            eff = ESCAPE
        else:
            eff = self.summaries.get(gid, {}).get(pk, PURE)
        if eff == ESCAPE:
            self._escape_var(S, var)
        elif eff.startswith("release:"):
            if eff.split(":", 1)[1] == self.vinfo[var].proto.name:
                self._release_var(S, var, line, via_summary=True)
            else:
                self._escape_var(S, var)

    def _bind_targets(self, S: dict, targets) -> None:
        for t in targets:
            for sub in ast.walk(t):
                if isinstance(sub, ast.Name):
                    self._overwrite(S, sub.id)

    def transfer(self, node) -> Tuple[Optional[dict], Optional[dict]]:
        """(normal out-state, exceptional out-state) for one node,
        given a mutable copy of the in-state bound to self._S."""
        S = self._S
        st = node.stmt
        kind = node.kind
        if kind == "test":
            self._apply_uses(S, node.expr,
                             getattr(node.expr, "lineno", 0))
            return S, dict(S)
        if kind in ("join", "exit", "raises"):
            return S, dict(S)
        line = getattr(st, "lineno", 0)
        if kind == "for-bind":
            self._bind_targets(S, [st.target])
            return S, dict(S)
        if kind == "for-iter":
            self._apply_uses(S, st.iter, line)
            return S, dict(S)
        if kind == "with":
            for item in st.items:
                self._apply_uses(S, item.context_expr, line)
            exc = dict(S)
            for item in st.items:
                if item.optional_vars is not None:
                    self._bind_targets(S, [item.optional_vars])
            return S, exc
        if kind == "except":
            if st.name:
                self._overwrite(S, st.name)
            return S, dict(S)
        # plain statements -------------------------------------------------
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
            # The whole statement is a deferred body: every tracked
            # name it references escapes into the closure, and a
            # protocol release inside it is a deferred release — stop
            # tracking that protocol's resources too.
            self._closure_escape(S, st)
            self._overwrite(S, st.name)
            return S, dict(S)
        self._apply_uses(S, st, line)
        if (isinstance(st, ast.Return) and self.verdict is not None
                and _returns_none([st])):
            # A verdict wrapper's None return hands the permit to the
            # caller, which tracks it from the call on.
            self._escape_var(S, self.verdict[1])
        exc = dict(S)
        # Acquire bindings & overwrites happen only on the normal edge.
        if isinstance(st, ast.Assign) and len(st.targets) == 1 \
                and isinstance(st.targets[0], ast.Name):
            var = st.targets[0].id
            acq = _acquire_value(st.value)
            if acq is not None:
                call, proto, sig, optional = acq
                self._overwrite(S, var)
                self._track(var, proto, line)
                S[var] = frozenset({OWNED, NONE} if optional
                                   else {OWNED})
            else:
                self._overwrite(S, var)
        elif isinstance(st, (ast.Assign, ast.AnnAssign)):
            targets = st.targets if isinstance(st, ast.Assign) \
                else [st.target]
            self._bind_targets(S, targets)
        elif isinstance(st, ast.Expr) and isinstance(st.value, ast.Call):
            m = match_acquire(st.value)
            if m is not None and m[1].bind == "result":
                proto = m[0]
                rule = _LEAK_RULE[proto.kind]
                self._emit(
                    rule, line,
                    f"result of {proto.name} acquire "
                    f"'{m[1].method}()' is discarded — the resource "
                    f"can never be released "
                    f"({proto.release_hint})",
                    (rule, "<discard>", line))
            # ``allocator.share(x)`` acquires its argument in place.
            if m is not None and m[1].bind == "arg0" and st.value.args \
                    and isinstance(st.value.args[0], ast.Name):
                var = st.value.args[0].id
                self._track(var, m[0], line)
                # Normal edge only — same rule as bind="result": if the
                # acquire call itself raises, the incref may never have
                # happened and an unwind release would corrupt refcounts.
                S[var] = frozenset({OWNED})
        elif isinstance(st, ast.Delete):
            for t in st.targets:
                if isinstance(t, ast.Name):
                    self._overwrite(S, t.id)
        return S, exc

    # -- edges ------------------------------------------------------------

    def refine(self, S: dict, expr: ast.expr,
               branch: bool) -> Optional[dict]:
        """Narrow S along a test edge; None = edge infeasible."""
        var, true_means_none = _none_test(expr)
        if var is None or var not in S:
            return S
        info = self.vinfo.get(var)
        if info is None:
            return S
        none_branch = true_means_none if branch else not true_means_none
        cur = S[var]
        if info.inverted:
            # try_admit: result None ⇔ permit held (OWNED).
            keep = ({OWNED, ESCAPED} if none_branch
                    else {NONE, RELEASED, TRANSFERRED, ESCAPED})
        else:
            keep = ({NONE, ESCAPED} if none_branch
                    else {OWNED, RELEASED, TRANSFERRED, ESCAPED})
        new = cur & frozenset(keep)
        if not new:
            return None
        out = dict(S)
        out[var] = new
        return out

    # -- driver ------------------------------------------------------------

    def run(self, cfg) -> List[Finding]:
        states: List[Optional[State]] = [None] * len(cfg.nodes)
        states[cfg.entry] = {}
        work = [cfg.entry]
        while work:
            ix = work.pop()
            node = cfg.nodes[ix]
            in_state = states[ix]
            if in_state is None:
                continue
            self._S = {k: v for k, v in in_state.items()}
            normal, exc = self.transfer(node)
            for e in node.succ:
                out = exc if e.exc else normal
                if out is None:
                    continue
                out2 = dict(out)
                if e.exc:
                    for var in list(out2):
                        if not self.vinfo[var].proto.exc_edges:
                            del out2[var]
                if e.refine is not None:
                    out2 = self.refine(out2, *e.refine)
                    if out2 is None:
                        continue
                tgt = states[e.dst]
                if tgt is None:
                    states[e.dst] = out2
                    work.append(e.dst)
                else:
                    changed = False
                    for var, vals in out2.items():
                        old = tgt.get(var, frozenset())
                        if not vals <= old:
                            tgt[var] = old | vals
                            changed = True
                    if changed:
                        work.append(e.dst)
        for kind, ix in (("normal", cfg.exit), ("exc", cfg.raises)):
            st = states[ix]
            if not st:
                continue
            for var, vals in st.items():
                if OWNED in vals:
                    self._leak(var, kind)
        self.flush_leaks()
        return self.findings


def _none_test(expr: ast.expr) -> Tuple[Optional[str], bool]:
    """(varname, true_branch_means_none) for the three refinable test
    shapes — ``x`` (truthy ⇒ non-None for the tracked value shapes:
    non-empty block lists, entries, tuples), ``x is None`` and
    ``x is not None``; (None, False) for anything else."""
    if isinstance(expr, ast.Name):
        return expr.id, False
    if (isinstance(expr, ast.Compare) and len(expr.ops) == 1
            and isinstance(expr.comparators[0], ast.Constant)
            and expr.comparators[0].value is None
            and isinstance(expr.left, ast.Name)):
        if isinstance(expr.ops[0], ast.Is):
            return expr.left.id, True
        if isinstance(expr.ops[0], ast.IsNot):
            return expr.left.id, False
    return None, False


# -- per-function driver ----------------------------------------------------

def _has_acquire(func_node: ast.AST) -> bool:
    for sub in ast.walk(func_node):
        if isinstance(sub, ast.Call) and match_acquire(sub) is not None:
            return True
    return False


def _is_generator(func_node: ast.AST) -> bool:
    stack = list(ast.iter_child_nodes(func_node))
    while stack:
        cur = stack.pop()
        if isinstance(cur, (ast.Yield, ast.YieldFrom)):
            return True
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(cur))
    return False


def analyze_function(mod, fi: FuncInfo, ps: ProjectSymbols,
                     summaries: Dict[str, Dict[str, str]]
                     ) -> List[Finding]:
    """Ownership dataflow over one function; [] when out of scope
    (no acquires, generator/async body, unsupported flow)."""
    node = fi.node
    if isinstance(node, (ast.AsyncFunctionDef, ast.Lambda)):
        return []
    if not _has_acquire(node) or _is_generator(node):
        return []
    try:
        cfg = build_cfg(node)
    except (UnsupportedFlow, RecursionError):
        return []
    flow = _FuncFlow(mod, fi, ps, summaries)
    return flow.run(cfg)


def _returns_none(stmts) -> bool:
    return any(isinstance(st, ast.Return) and (
        st.value is None or (isinstance(st.value, ast.Constant)
                             and st.value.value is None))
        for st in stmts)


def verdict_wrapper(fn: ast.AST) -> Optional[Tuple[Protocol, str]]:
    """(protocol, variable) when ``fn`` hands a permit's verdict to its
    caller: it binds ``v = <permit acquire>`` (a protocol whose None
    result means held) and returns None under ``if v is None:`` -- the
    caller then holds the permit exactly when the call returns None,
    as it would after the acquire itself."""
    if isinstance(fn, ast.Lambda):
        return None
    bound: Dict[str, Protocol] = {}
    nodes = _own_walk(fn.body)
    for node in nodes:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Call)):
            m = match_acquire(node.value)
            if m is not None and m[0].none_is_acquired:
                bound[node.targets[0].id] = m[0]
    for node in nodes:
        if isinstance(node, ast.If):
            var, true_means_none = _none_test(node.test)
            if var in bound and true_means_none \
                    and _returns_none(node.body):
                return bound[var], var
    return None


def _release_wrapper(fn: ast.AST) -> Optional[Tuple[Protocol, Sig]]:
    """A function that acquires nothing and releases a permit-kind
    protocol by its arg="all" release (``admission.release(dt)``)."""
    if isinstance(fn, ast.Lambda) or _has_acquire(fn):
        return None
    for node in _own_walk(fn.body):
        if isinstance(node, ast.Call):
            for proto, sig in _match_in(node, "releases"):
                if sig.arg == "all":
                    return proto, sig
    return None


def _derive_wrappers(ps: ProjectSymbols) -> None:
    """Fill ``_WRAPPED`` with every call site of a verdict wrapper (an
    acquire, its None result held) and of a release wrapper (an arg="all"
    release), resolved through the project call graph."""
    acq: Dict[str, Tuple[Protocol, Sig]] = {}
    rel: Dict[str, Tuple[Protocol, Sig]] = {}
    for gid, gf in ps.functions.items():
        wrapper = verdict_wrapper(gf.info.node)
        if wrapper is not None:
            acq[gid] = (wrapper[0], Sig(gf.qualname.rsplit(".", 1)[-1],
                                        optional=True))
            continue
        released = _release_wrapper(gf.info.node)
        if released is not None:
            rel[gid] = (released[0], Sig(gf.qualname.rsplit(".", 1)[-1],
                                         arg="all"))
    _WRAPPED["acquires"].clear()
    _WRAPPED["releases"].clear()
    for (relpath, node_id), gid in ps.node_callee.items():
        if gid in acq:
            _WRAPPED["acquires"][node_id] = acq[gid]
        elif gid in rel:
            _WRAPPED["releases"][node_id] = rel[gid]


class OwnershipChecker(Checker):
    """Path-sensitive resource ownership dataflow (see module doc)."""

    name = "ownership"
    rules = (OWN_LEAK, OWN_DOUBLE, OWN_UAT, OWN_PIN)
    scope = ("distributed_llm_tpu_torch",)
    whole_project = True

    def check(self, project: Project) -> List[Finding]:
        ps = project_symbols(project)
        _derive_wrappers(ps)
        try:
            summaries = param_summaries(project)
            findings: List[Finding] = []
            for mod in project.in_dirs(self.scope):
                if mod.tree is None:
                    continue
                for fi in symbols_for(mod).functions.values():
                    findings.extend(analyze_function(mod, fi, ps,
                                                     summaries))
        finally:
            _WRAPPED["acquires"].clear()
            _WRAPPED["releases"].clear()
        return findings
