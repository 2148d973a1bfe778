"""Config/env drift: code and the config tables must agree both ways.

The port's counterpart of the JAX package's ``config_drift`` checker,
over the port's own tables (``lint/config_fields.py``):

- Every ``DLLM_*`` env var READ in the port (``os.environ.get``,
  ``os.getenv``, ``os.environ[...]``, ``"X" in os.environ``) must be
  registered in ``ENV_VARS`` — and every registered var must still have
  at least one reader.  The port has no env knobs, so ``ENV_VARS`` is
  empty and every such read is a finding.
- Every ``TierConfig``/``ClusterConfig`` dataclass field in the port's
  config.py must appear in ``CONFIG_FIELDS`` (the port's copy of JAX's
  one-liners) with a non-empty one-liner, and vice versa.
- Every ``ENV_VARS`` entry must carry a doc and consumer.

The tables are stdlib-only data, so importing them keeps the lint CLI
free of torch.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Set, Tuple

from ..core import Checker, Finding, Project
from ..config_fields import CONFIG_FIELDS, ENV_VARS

ENV_NAME_RE = re.compile(r"^DLLM_[A-Z0-9_]+$")
REGISTRY_PATH = "distributed_llm_tpu_torch/lint/config_fields.py"
CONFIG_PATH = "distributed_llm_tpu_torch/config.py"
CONFIG_CLASSES = ("TierConfig", "ClusterConfig")


def _env_chain(node: ast.expr) -> bool:
    """True for expressions ending in ``environ`` (os.environ,
    _os.environ, bare environ)."""
    if isinstance(node, ast.Attribute):
        return node.attr == "environ"
    return isinstance(node, ast.Name) and node.id == "environ"


def _const_env_name(node: ast.expr):
    if (isinstance(node, ast.Constant) and isinstance(node.value, str)
            and ENV_NAME_RE.match(node.value)):
        return node.value
    return None


class ConfigDriftChecker(Checker):
    name = "config_drift"
    rules = ("config-env-unregistered", "config-env-stale",
             "config-field-undocumented", "config-field-stale",
             "config-registry-incomplete")
    scope = ("distributed_llm_tpu_torch",)
    # An edit anywhere can strand a registry entry (delete the last
    # reader) — the finding then lands in the UNCHANGED registry file,
    # so --changed must not drop it.
    whole_project = True

    def check(self, project: Project) -> List[Finding]:
        findings: List[Finding] = []
        reads: Dict[str, Tuple[str, int]] = {}     # var -> first site

        for mod in project.in_dirs(self.scope):
            if mod.tree is None:
                continue
            for node in ast.walk(mod.tree):
                for var, line in self._env_uses(node):
                    reads.setdefault(var, (mod.relpath, line))
                    if var not in ENV_VARS:
                        findings.append(Finding(
                            "config-env-unregistered", mod.relpath, line,
                            f"env var {var} read here but not in "
                            f"lint/config_fields.ENV_VARS — the port reads "
                            f"no env knob: take it as an argument"))

        # No-reader detection needs the WHOLE project loaded: a narrowed
        # target run cannot prove absence, only presence.
        if getattr(project, "complete", True):
            for var in sorted(set(ENV_VARS) - set(reads)):
                findings.append(Finding(
                    "config-env-stale", REGISTRY_PATH, 1,
                    f"ENV_VARS entry {var} has no reader anywhere in "
                    f"the project — dead knob; remove it or wire it up"))

        for var, entry in sorted(ENV_VARS.items()):
            if not entry.doc.strip() or not entry.consumer.strip():
                findings.append(Finding(
                    "config-registry-incomplete", REGISTRY_PATH, 1,
                    f"ENV_VARS entry {var} is missing its doc/consumer "
                    f"— the registry IS the documentation"))

        findings.extend(self._check_fields(project))
        return findings

    # -- env read patterns -------------------------------------------------

    def _env_uses(self, node: ast.AST) -> List[Tuple[str, int]]:
        out: List[Tuple[str, int]] = []
        # os.environ.get("X", ...) / os.getenv("X", ...)
        if isinstance(node, ast.Call):
            fn = node.func
            if (isinstance(fn, ast.Attribute) and fn.attr == "get"
                    and _env_chain(fn.value) and node.args):
                name = _const_env_name(node.args[0])
                if name:
                    out.append((name, node.lineno))
            elif (isinstance(fn, ast.Attribute) and fn.attr == "getenv"
                    and node.args):
                name = _const_env_name(node.args[0])
                if name:
                    out.append((name, node.lineno))
            elif (isinstance(fn, ast.Name)
                    and fn.id in ("env_str", "env_int", "env_float",
                                  "env_flag", "getenv")
                    and node.args):
                name = _const_env_name(node.args[0])
                if name:
                    out.append((name, node.lineno))
        # os.environ["X"] (read or write — both are usage)
        elif isinstance(node, ast.Subscript) and _env_chain(node.value):
            sl = node.slice
            if isinstance(sl, ast.Index):           # py<3.9 compat
                sl = sl.value
            name = _const_env_name(sl)
            if name:
                out.append((name, node.lineno))
        # "X" in os.environ
        elif isinstance(node, ast.Compare):
            if (len(node.ops) == 1 and isinstance(node.ops[0],
                                                  (ast.In, ast.NotIn))
                    and _env_chain(node.comparators[0])):
                name = _const_env_name(node.left)
                if name:
                    out.append((name, node.lineno))
        return out

    # -- dataclass field coverage ------------------------------------------

    def _check_fields(self, project: Project) -> List[Finding]:
        findings: List[Finding] = []
        mod = project.get(CONFIG_PATH)
        if mod is None or mod.tree is None:
            return findings
        declared: Set[str] = set()
        for node in ast.walk(mod.tree):
            if (not isinstance(node, ast.ClassDef)
                    or node.name not in CONFIG_CLASSES):
                continue
            for stmt in node.body:
                if (isinstance(stmt, ast.AnnAssign)
                        and isinstance(stmt.target, ast.Name)):
                    field = f"{node.name}.{stmt.target.id}"
                    declared.add(field)
                    if not CONFIG_FIELDS.get(field, "").strip():
                        findings.append(Finding(
                            "config-field-undocumented", CONFIG_PATH,
                            stmt.lineno,
                            f"{field} is not documented in "
                            f"lint/config_fields.CONFIG_FIELDS"))
        for field in sorted(set(CONFIG_FIELDS) - declared):
            findings.append(Finding(
                "config-field-stale", REGISTRY_PATH, 1,
                f"CONFIG_FIELDS entry {field} does not exist on "
                f"{' / '.join(CONFIG_CLASSES)} any more — remove it"))
        return findings
