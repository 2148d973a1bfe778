"""Host-device transfer discipline on annotated hot-path roots.

The port's counterpart of the JAX package's ``transfer`` checker
(``distributed_llm_tpu/lint/checkers/transfer.py``), in torch's
vocabulary.  Host/device overlap dies silently when a host sync creeps
into the decode tick or the scheduler thread: one stray ``.item()``
serializes the stream against Python, and nothing errors -- throughput
just sags.  A function annotated ``# dllm-lint: hot-path`` (the
scheduler loop, the sampler, the router's sampler collect) and
EVERYTHING it transitively calls -- project-wide, through the
import-resolved call graph -- must not sync with the device, except at
sites that carry an inline suppression naming why that sync is the
sanctioned one.

Rules:

- ``transfer-host-sync``: ``.item()``, ``.cpu()``, ``.tolist()``,
  ``.numpy(force=True)``, a blocking ``.to("cpu")``,
  ``torch.cuda.synchronize()`` or an ``Event``/``Stream``
  ``.synchronize()`` in the hot-path closure.  A plain ``.numpy()`` is
  no sync: on a CUDA tensor it raises, so it only views host arrays.
  The batched tick keeps exactly ONE -- ``_fetch_tick``, the tick
  boundary that makes a tick's tokens observable -- and that site's
  suppression says so; the first-token and chunk syncs of an admission
  are sanctioned by name as well (TTFT is the SLO).  Anything else is a
  new stall.
- ``transfer-host-round-trip``: ``np.asarray(...)`` / ``np.array(...)``
  / ``float()`` / ``int()`` / ``bool()`` over a device value in the
  closure -- an implicit device-to-host pull.  A device value is a
  ``torch.`` call, a program's replay (``prog.run()``), a call of a
  function annotated to return a ``Tensor``, or a local name bound to
  one of these.  Expressions holding an explicit sync are reported
  once, as the sync.
- ``transfer-sync-spill``: a sync whose tensor touches POOL DATA (a name
  matching ``pool``/``cache``/``kv*``/``buffer``) in the closure.  The
  spill copier (engine/kv_spill.py) is the only sanctioned
  device-to-host crossing for pool blocks.

JAX's ``transfer-undonated-buffer`` has no counterpart: the port parks
caches by copy and donates nothing.  Functions named ``*warmup*`` /
``*bench*`` are exempt: warmup syncs to force captures, benches sync to
measure.  Adding a hot-path root is one comment on (or directly above)
the ``def`` line: ``# dllm-lint: hot-path``.
"""

from __future__ import annotations

import ast
import re
from typing import List

from ..core import Checker, Finding, Project
from ..symbols import attr_chain, call_name, hot_path_roots, project_symbols
from .jit_purity import sync_method

EXEMPT_RE = re.compile(r"warmup|prewarm|bench|micro", re.IGNORECASE)

PULL_WRAPPERS = {"float", "int", "bool"}
BUFFER_PARAM_RE = re.compile(r"^(pool|cache|kv\w*|buffer)$")


def _touches_pool(expr: ast.expr) -> bool:
    """Whether the expression references a KV-pool-shaped value (a bare
    or attribute name matching the buffer pattern: ``pool`` /
    ``self.pool`` / ``kv*`` / ``cache`` / ``buffer``)."""
    for node in ast.walk(expr):
        if isinstance(node, ast.Name) and BUFFER_PARAM_RE.match(node.id):
            return True
        if isinstance(node, ast.Attribute) \
                and BUFFER_PARAM_RE.match(node.attr):
            return True
    return False


def _contains_sync(expr: ast.expr) -> bool:
    return any(isinstance(n, ast.Call) and sync_method(n)
               for n in ast.walk(expr))


def _returns_tensor(fn: ast.AST) -> bool:
    ann = getattr(fn, "returns", None)
    return ann is not None and any(
        (isinstance(n, ast.Attribute) and n.attr == "Tensor")
        or (isinstance(n, ast.Name) and n.id == "Tensor")
        for n in ast.walk(ann))


class _DeviceValues:
    """The device-value heuristic of one function body: which
    expressions hold a tensor on the card."""

    def __init__(self, ps, rel: str, fn: ast.AST):
        self.ps, self.rel = ps, rel
        self.names: set = set()
        body = fn.body if isinstance(getattr(fn, "body", None), list) else []
        assigns = [n for n in ast.walk(ast.Module(body=body, type_ignores=[]))
                   if isinstance(n, ast.Assign) and len(n.targets) == 1
                   and isinstance(n.targets[0], ast.Name)]
        for _ in range(2):             # one hop of aliasing each pass
            for n in assigns:
                if self.holds(n.value):
                    self.names.add(n.targets[0].id)

    def holds(self, expr: ast.expr) -> bool:
        """Whether ``expr``'s VALUE is a device tensor (an unknown call's
        arguments say nothing of what it returns)."""
        if isinstance(expr, ast.Name):
            return expr.id in self.names
        if isinstance(expr, (ast.Subscript, ast.Attribute)):
            return self.holds(expr.value)
        if isinstance(expr, ast.BinOp):
            return self.holds(expr.left) or self.holds(expr.right)
        if isinstance(expr, ast.UnaryOp):
            return self.holds(expr.operand)
        if not isinstance(expr, ast.Call):
            return False
        chain = attr_chain(expr.func) or ""
        if chain.split(".", 1)[0] == "torch":
            return True
        if (isinstance(expr.func, ast.Attribute) and expr.func.attr == "run"
                and not expr.args):
            return True
        if isinstance(expr.func, ast.Attribute) and self.holds(
                expr.func.value):
            return True                  # a tensor method: x.sum(), x.max()
        gid = self.ps.callee_of(self.rel, expr)
        return gid is not None and _returns_tensor(
            self.ps.functions[gid].info.node)


class TransferChecker(Checker):
    name = "transfer"
    rules = ("transfer-host-sync", "transfer-host-round-trip",
             "transfer-sync-spill")
    scope = ("distributed_llm_tpu_torch/engine",
             "distributed_llm_tpu_torch/serving",
             "distributed_llm_tpu_torch/obs",
             "distributed_llm_tpu_torch/ops",
             "distributed_llm_tpu_torch/models",
             "distributed_llm_tpu_torch/parallel")
    whole_project = True     # the hot-path closure crosses modules

    def check(self, project: Project) -> List[Finding]:
        ps = project_symbols(project)
        closure = ps.closure(hot_path_roots(ps))
        findings: List[Finding] = []
        # Closure rules fire wherever the callee LIVES (a hot tick
        # calling a syncing helper in utils/ is still a hot-path sync).
        for gid in sorted(closure):
            gf = ps.functions.get(gid)
            if gf is None or EXEMPT_RE.search(gf.qualname):
                continue
            mod = project.get(gf.relpath)
            if mod is None:
                continue
            findings.extend(self._scan_hot_body(mod, gf, ps))
        return findings

    def _scan_hot_body(self, mod, gf, ps) -> List[Finding]:
        findings: List[Finding] = []
        node = gf.info.node
        device = _DeviceValues(ps, gf.relpath, node)
        body = (node.body if isinstance(getattr(node, "body", None), list)
                else [node.body] if hasattr(node, "body") else [])
        stack = list(body)
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue          # own graph entries when actually called
            # Lambdas are NOT graph entries and cannot carry their own
            # hot-path annotation: scan their bodies as part of the
            # enclosing function, or a per-tick sync hides in one.
            stack.extend(ast.iter_child_nodes(n))
            if not isinstance(n, ast.Call):
                continue
            name = call_name(n)
            sync = sync_method(n)
            if sync:
                target = (n.func.value if sync != "synchronize()"
                          else None)
                if target is not None and _contains_sync(target):
                    continue         # reported once, as the inner sync
                if target is not None and _touches_pool(target):
                    findings.append(Finding(
                        "transfer-sync-spill", mod.relpath, n.lineno,
                        f"`.{sync}` pulls POOL data to the host on the "
                        f"hot path (via `{gf.qualname}`) -- the spill "
                        f"copier (engine/kv_spill.py) is the only "
                        f"sanctioned device-to-host crossing for pool "
                        f"blocks"))
                    continue
                findings.append(Finding(
                    "transfer-host-sync", mod.relpath, n.lineno,
                    f"`.{sync}` on the hot path (reachable from a "
                    f"`# dllm-lint: hot-path` root via `{gf.qualname}`) "
                    f"-- a device sync serializes the tick against the "
                    f"host; if this is the sanctioned sync, say so in a "
                    f"suppression justification"))
                continue
            chain = attr_chain(n.func) or ""
            is_pull = (chain in ("np.asarray", "np.array", "numpy.asarray",
                                 "numpy.array")
                       or (isinstance(n.func, ast.Name)
                           and name in PULL_WRAPPERS))
            if is_pull and n.args and device.holds(n.args[0]) \
                    and not _contains_sync(n.args[0]):
                findings.append(Finding(
                    "transfer-host-round-trip", mod.relpath, n.lineno,
                    f"`{name}(...)` over a device expression on the hot "
                    f"path (via `{gf.qualname}`) -- an implicit "
                    f"device-to-host transfer every call; keep the value "
                    f"on the device or move the pull to the tick "
                    f"boundary"))
        return findings
