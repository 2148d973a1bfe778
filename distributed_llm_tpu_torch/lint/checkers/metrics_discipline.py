"""Metrics discipline: emission sites and the metric registry must
agree, and every label must ride a cardinality bound.

``obs/metrics.py`` declares every ``dllm_*`` family ONCE as data
(``METRIC_REGISTRY`` rows — attribute, kind, name, labels, help) and
``ServingMetrics`` materializes the rows, so family creation cannot
drift from the table.  What CAN drift:

- an ad-hoc creation or lookup somewhere else —
  ``registry.counter("dllm_new_thing_total", …)`` in a serving module,
  ``metrics.get("dllm_renamed_total")`` in the bench — whose name,
  kind, or label set the registry never heard of
  (``metrics-unregistered``);
- a registry row minting a label name with no entry in
  ``BOUNDED_LABELS`` (``metrics-label-cardinality``): metric children
  are permanent, so an unbounded caller-supplied label value grows
  ``/metrics`` without bound (a per-session label is the classic).

The registry rows are read from the AST (``ast.literal_eval`` per
row), not imported — line numbers come free, a malformed (non-literal)
row is itself a finding, and lint fixtures can carry their own tiny
registry module.  Emission detection is call-shaped: a call whose
attribute leaf is ``counter``/``gauge``/``histogram``/``get``/
``_family`` with a string-constant first argument starting ``dllm_``.
Non-metric ``dllm_`` strings (ContextVar names, Flask app names,
extension keys) never match that shape, preserving the no-false-edge
invariant.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from ..core import Checker, Finding, Project

REGISTRY_PATH = "distributed_llm_tpu_torch/obs/metrics.py"
CREATE_LEAVES = ("counter", "gauge", "histogram", "get", "_family")
KIND_OF_LEAF = {"counter": "counter", "gauge": "gauge",
                "histogram": "histogram"}


def _call_leaf(call: ast.Call) -> Optional[str]:
    f = call.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return None


def _metric_name(call: ast.Call) -> Optional[str]:
    if (call.args and isinstance(call.args[0], ast.Constant)
            and isinstance(call.args[0].value, str)
            and call.args[0].value.startswith("dllm_")):
        return call.args[0].value
    return None


def _literal_labels(call: ast.Call, leaf: str) -> Optional[Tuple[str, ...]]:
    """The label-name tuple at a creation call, when statically literal
    (None = not stated / not literal — skip the label comparison)."""
    node: Optional[ast.expr] = None
    pos = 3 if leaf == "_family" else 2
    if len(call.args) > pos:
        node = call.args[pos]
    for kw in call.keywords:
        if kw.arg == "labels":
            node = kw.value
    if node is None:
        return () if len(call.args) > 1 or call.keywords else None
    try:
        val = ast.literal_eval(node)
    except (ValueError, SyntaxError):
        return None
    if isinstance(val, (tuple, list)) and all(
            isinstance(x, str) for x in val):
        return tuple(val)
    return None


def _registry_tables(mod) -> Tuple[Optional[ast.expr], Optional[ast.expr]]:
    """(METRIC_REGISTRY value node, BOUNDED_LABELS value node)."""
    reg = bounds = None
    for node in mod.tree.body:
        target = None
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            target = node.targets[0].id
        elif isinstance(node, ast.AnnAssign) \
                and isinstance(node.target, ast.Name):
            target = node.target.id
        if target == "METRIC_REGISTRY":
            reg = node.value
        elif target == "BOUNDED_LABELS":
            bounds = node.value
    return reg, bounds


class MetricsDisciplineChecker(Checker):
    name = "metrics_discipline"
    rules = ("metrics-unregistered", "metrics-label-cardinality")
    scope = ("distributed_llm_tpu_torch",)
    # A new emission anywhere must be checked against the (unchanged)
    # registry module, so --changed must not narrow the project.
    whole_project = True

    def check(self, project: Project) -> List[Finding]:
        findings: List[Finding] = []
        reg_mod = project.modules.get(REGISTRY_PATH)
        if reg_mod is None or reg_mod.tree is None:
            # Fixture projects carry their own tiny registry module.
            for mod in project.in_dirs(self.scope):
                if mod.tree is None:
                    continue
                if _registry_tables(mod)[0] is not None:
                    reg_mod = mod
                    break
        if reg_mod is None or reg_mod.tree is None:
            return findings
        reg_node, bounds_node = _registry_tables(reg_mod)
        rows: Dict[str, Tuple[str, Tuple[str, ...], int]] = {}
        if reg_node is not None and isinstance(reg_node, (ast.Tuple,
                                                          ast.List)):
            for elt in reg_node.elts:
                try:
                    row = ast.literal_eval(elt)
                except (ValueError, SyntaxError):
                    findings.append(Finding(
                        "metrics-unregistered", reg_mod.relpath,
                        elt.lineno,
                        "METRIC_REGISTRY row is not a pure literal — "
                        "the checker (and METRICS.md) read rows from "
                        "the AST, so computed rows are invisible"))
                    continue
                if (not isinstance(row, tuple) or len(row) != 5
                        or not all(isinstance(x, str) for x in
                                   (row[0], row[1], row[2], row[4]))
                        or not isinstance(row[3], tuple)):
                    findings.append(Finding(
                        "metrics-unregistered", reg_mod.relpath,
                        elt.lineno,
                        "METRIC_REGISTRY row shape must be (attr, "
                        "kind, name, label-tuple, help)"))
                    continue
                _attr, kind, name, labels, _help = row
                if name in rows:
                    findings.append(Finding(
                        "metrics-unregistered", reg_mod.relpath,
                        elt.lineno,
                        f"duplicate METRIC_REGISTRY row for {name} "
                        f"(first declared at line {rows[name][2]})"))
                    continue
                rows[name] = (kind, tuple(labels), elt.lineno)

        bounds: Dict[str, str] = {}
        if bounds_node is not None:
            try:
                val = ast.literal_eval(bounds_node)
                if isinstance(val, dict):
                    bounds = {str(k): str(v) for k, v in val.items()}
            except (ValueError, SyntaxError):
                pass

        # Registry-side label bounds: report at the first row minting
        # the unbounded label.
        flagged: set = set()
        for name, (kind, labels, line) in sorted(
                rows.items(), key=lambda kv: kv[1][2]):
            for lab in labels:
                if lab in bounds and bounds[lab].strip():
                    continue
                if lab in flagged:
                    continue
                flagged.add(lab)
                findings.append(Finding(
                    "metrics-label-cardinality", reg_mod.relpath, line,
                    f"label '{lab}' of {name} has no entry in "
                    f"BOUNDED_LABELS — metric children are permanent, "
                    f"so every label needs a stated cardinality bound "
                    f"(closed enum or a BoundedLabels set)"))

        # Emission sites project-wide vs the registry.
        for mod in project.in_dirs(self.scope):
            if mod.tree is None:
                continue
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.Call):
                    continue
                leaf = _call_leaf(node)
                if leaf not in CREATE_LEAVES:
                    continue
                name = _metric_name(node)
                if name is None:
                    continue
                if name not in rows:
                    findings.append(Finding(
                        "metrics-unregistered", mod.relpath, node.lineno,
                        f"metric {name} emitted here but not declared "
                        f"in obs/metrics.py METRIC_REGISTRY — add a "
                        f"row (or fix the name drift)"))
                    continue
                kind, labels, _line = rows[name]
                want_kind = KIND_OF_LEAF.get(leaf)
                if want_kind is not None and want_kind != kind:
                    findings.append(Finding(
                        "metrics-unregistered", mod.relpath, node.lineno,
                        f"metric {name} created as {want_kind} here "
                        f"but registered as {kind}"))
                    continue
                here = _literal_labels(node, leaf)
                if (leaf != "get" and here is not None
                        and here != labels):
                    findings.append(Finding(
                        "metrics-unregistered", mod.relpath, node.lineno,
                        f"metric {name} created with labels "
                        f"{here!r} but registered with {labels!r}"))
        return findings
