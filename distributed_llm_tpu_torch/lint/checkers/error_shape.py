"""Error-shape conformance: every error-dict literal matches the schema.

The reference error path (serving/errors.py) is load-bearing parity
surface: ``src/app.py`` and ``routing_chatbot_tester.py`` both parse
``{"error": <str>}`` (plus the sanctioned ``retry_after_s`` extension).
This checker validates every dict LITERAL carrying the error key inside
the tier/router layers against the single schema constant:

- keys must all be static strings drawn from ``ALLOWED_KEYS``,
- the error value must be string-shaped (constant/f-string/concat/
  ``str(...)``/name — a nested dict or number breaks ``_extract_text``),
- ``retry_after_s`` must be numeric-shaped (constant/``round``/``float``
  /``int``/name).

Scope: serving/, engine/, and utils/faults.py — the layers whose dicts
flow into Router failover.  HTTP-layer bodies (utils/webapp.py) use
their own status-code envelope and are deliberately out of scope.
"""

from __future__ import annotations

import ast
from typing import List

from ..core import Checker, Finding, Project

# Imported for the single-source-of-truth constants; serving/errors.py
# is stdlib-only, so the lint CLI imports no torch.
from ...serving.errors import ALLOWED_KEYS, ERROR_KEY, NUMERIC_KEYS

_STRINGY = (ast.JoinedStr,)
_NUMERIC_CALLS = {"round", "float", "int"}


def _is_stringy(node: ast.expr) -> bool:
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str)
    if isinstance(node, _STRINGY):
        return True
    if isinstance(node, ast.BinOp):       # "a" + x, "%s" % x
        return _is_stringy(node.left) or _is_stringy(node.right)
    if isinstance(node, ast.Call):
        fn = node.func
        if isinstance(fn, ast.Name):
            return fn.id in ("str", "repr", "format")
        if isinstance(fn, ast.Attribute):   # "...".format(...), s.strip()
            return True
    # Names/attributes/subscripts can't be typed statically — trust them.
    return isinstance(node, (ast.Name, ast.Attribute, ast.Subscript,
                             ast.IfExp))


def _is_numericy(node: ast.expr) -> bool:
    if isinstance(node, ast.Constant):
        return isinstance(node.value, (int, float)) and not isinstance(
            node.value, bool)
    if isinstance(node, ast.Call):
        fn = node.func
        if isinstance(fn, ast.Name) and fn.id in _NUMERIC_CALLS:
            return True
        return isinstance(fn, ast.Attribute)    # max(...), math.ceil(...)
    if isinstance(node, ast.BinOp):
        return True
    if isinstance(node, ast.UnaryOp):
        return _is_numericy(node.operand)
    return isinstance(node, (ast.Name, ast.Attribute, ast.Subscript,
                             ast.IfExp))


class ErrorShapeChecker(Checker):
    name = "error_shape"
    rules = ("error-shape",)
    scope = ("distributed_llm_tpu_torch/serving", "distributed_llm_tpu_torch/engine",
             "distributed_llm_tpu_torch/utils/faults.py")

    def check(self, project: Project) -> List[Finding]:
        findings: List[Finding] = []
        for mod in project.in_dirs(self.scope):
            if mod.tree is None:
                continue
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.Dict):
                    continue
                keys = {}
                dynamic = False
                for k, v in zip(node.keys, node.values):
                    if (isinstance(k, ast.Constant)
                            and isinstance(k.value, str)):
                        keys[k.value] = v
                    elif k is not None:
                        dynamic = True
                if ERROR_KEY not in keys:
                    continue
                line = node.lineno
                if dynamic:
                    findings.append(Finding(
                        "error-shape", mod.relpath, line,
                        "error-shaped dict with a computed key — the "
                        "reference shape requires static keys "
                        "(serving/errors.py ALLOWED_KEYS)"))
                extra = set(keys) - ALLOWED_KEYS
                if extra:
                    findings.append(Finding(
                        "error-shape", mod.relpath, line,
                        f"error-shaped dict carries non-reference "
                        f"key(s) {sorted(extra)} — allowed: "
                        f"{sorted(ALLOWED_KEYS)} (serving/errors.py)"))
                if not _is_stringy(keys[ERROR_KEY]):
                    findings.append(Finding(
                        "error-shape", mod.relpath, line,
                        f"'{ERROR_KEY}' value must be a string "
                        f"(reference clients and _extract_text parse "
                        f"it); got "
                        f"{type(keys[ERROR_KEY]).__name__}"))
                for nk in NUMERIC_KEYS & set(keys):
                    if not _is_numericy(keys[nk]):
                        findings.append(Finding(
                            "error-shape", mod.relpath, line,
                            f"'{nk}' must be numeric (reference "
                            f"retry-after contract); got "
                            f"{type(keys[nk]).__name__}"))
        return findings
