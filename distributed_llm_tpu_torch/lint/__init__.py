"""dllm-lint for the port: an AST static-analysis suite over
``distributed_llm_tpu_torch/``.

The JAX package's lint (``distributed_llm_tpu/lint``), copied and aimed at
the port's tree.  ``python -m distributed_llm_tpu_torch.lint`` runs twelve
checkers (no torch, no JAX and nothing of the JAX package imported;
CPU-only, about 12 s), sharing ONE parsed AST per file and ONE
whole-project call graph per run (symbols.ProjectSymbols, import-aware
cross-module resolution):

- ``locks``             lock discipline: blocking-ness (the port's
                        compile included: a capture, the nvcc build, a
                        ``.synchronize()``) propagated CROSS-MODULE
- ``capture_purity``    host work and host syncs in a body captured into
                        a CUDA graph (JAX's jit purity)
- ``error_shape``       reference error-dict conformance (parity surface)
- ``config_drift``      DLLM_* env reads (the port has no knobs) and the
                        config fields against their one-liners
- ``span_discipline``   span enter/exit pairing
- ``obs_discipline``    the SLO monitor's single-feed-site contract
- ``profiler_discipline``  no tick-profiler stamps inside a captured
                        body (they run once, at capture)
- ``recapture``         a CUDA graph captured in a loop, per call on a
                        hot path, or keyed by an unbounded length (JAX's
                        retrace)
- ``transfer``          torch's host syncs on ``# dllm-lint:
                        hot-path``-annotated roots
- ``thread_lifecycle``  non-daemon threads without a drain-reachable
                        join, acquire() without exception-safe release,
                        module-scope thread owners without a stop hook
- ``ownership``         pool blocks, prefix pins, spill claims,
                        admission permits and replica handles released
                        on every path, exception edges included
- ``metrics_discipline``  emissions against the metric registry, labels
                        against their cardinality bounds

Suppression: ``# dllm-lint: disable=<rule> -- <justification>`` (line or
file scope via ``disable-file``); the justification is mandatory and
enforced.  ``--changed [REF]`` scopes reporting to the git diff
(whole-project checkers auto-widen).  tests/test_torch_lint.py holds it
to the JAX lint's findings and runs it over the tree.
"""

from __future__ import annotations

from typing import Optional, Sequence

from .checkers import all_checkers
from .core import (DEFAULT_TARGETS, Checker, Finding, LintResult, Module,
                   Project, load_project, repo_root, run_checkers)

__all__ = [
    "Checker", "Finding", "LintResult", "Module", "Project",
    "DEFAULT_TARGETS", "all_checkers", "load_project", "repo_root",
    "run_checkers", "run_lint",
]


def run_lint(root: Optional[str] = None,
             targets: Optional[Sequence[str]] = None,
             rules: Optional[Sequence[str]] = None) -> LintResult:
    """One-call entry point: load the project and run every checker."""
    project = load_project(root or repo_root(), targets)
    return run_checkers(project, all_checkers(), rules=rules)
