"""Checker registry: add a checker by importing and listing it here.

Each checker is a ``core.Checker`` subclass with a unique ``name``, a
``rules`` tuple (the ids suppression comments reference), and a
``scope`` of path prefixes.

``JAX_RULES`` accounts for every rule id of the JAX package's lint
(``distributed_llm_tpu/lint/checkers``): the port's rule that checks the
same thing, under the same id where the meaning is the same and under a
name for what it checks in the port where torch changes the meaning, or
None with the reason it has no counterpart.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..core import Checker
from .config_drift import ConfigDriftChecker
from .error_shape import ErrorShapeChecker
from .jit_purity import JitPurityChecker
from .locks import LockChecker
from .metrics_discipline import MetricsDisciplineChecker
from .obs_discipline import (ObsDisciplineChecker,
                             ProfilerDisciplineChecker)
from .ownership import OwnershipChecker
from .retrace import RetraceChecker
from .span_discipline import SpanDisciplineChecker
from .thread_lifecycle import ThreadLifecycleChecker
from .transfer import TransferChecker

_SAME = "the same check, on the port's tree"

JAX_RULES: Dict[str, Tuple[Optional[str], str]] = {
    "lock-blocking-call": (
        "lock-blocking-call",
        "the same check; the blocking names add the port's compile: a "
        "CUDA graph capture, the nvcc build and .synchronize()"),
    "lock-order-inversion": ("lock-order-inversion", _SAME),
    "lock-mixed-guard": ("lock-mixed-guard", _SAME),
    "jit-host-impurity": (
        "capture-host-impurity",
        "host work in a body captured into a CUDA graph, which runs at "
        "capture only (JAX: at trace time only)"),
    "jit-traced-concretization": (
        "capture-host-sync",
        "a host sync in a captured body fails the capture or bakes in "
        "the capture-time value (JAX: concretizes a traced value)"),
    "error-shape": ("error-shape", _SAME),
    "config-env-unregistered": (
        "config-env-unregistered",
        "the same check against an empty registry: the port has no "
        "DLLM_* knobs, so every read is a finding"),
    "config-env-stale": (
        "config-env-stale",
        "the same check; it cannot fire while the registry is empty"),
    "config-field-undocumented": (
        "config-field-undocumented",
        "the same check, against the port's copy of JAX's one-liners"),
    "config-field-stale": (
        "config-field-stale",
        "the same check, against the port's copy of JAX's one-liners"),
    "config-registry-incomplete": (
        "config-registry-incomplete",
        "the same check; it cannot fire while the registry is empty"),
    "span-not-with": (
        "span-not-with",
        "the same check; a function returning a span or phase hands it "
        "to its caller's with and becomes a factory itself"),
    "span-manual-enter": ("span-manual-enter", _SAME),
    "slo-feed-outside-finish": ("slo-feed-outside-finish", _SAME),
    "profiler-hook-in-traced-code": (
        "profiler-hook-in-captured-code",
        "a profiler stamp inside a captured body (JAX: a traced one)"),
    "retrace-wrap-in-loop": (
        "recapture-in-loop",
        "a CUDA graph captured inside a loop (JAX: a jit wrap)"),
    "retrace-per-call-wrap": (
        "recapture-per-call",
        "a capture replayed or dropped in one expression on a hot path "
        "(JAX: a jit wrap invoked at once)"),
    "retrace-dynamic-shape": (
        "recapture-unbounded-key",
        "a program key or rung from an unbounded length at _built(...) "
        "(JAX: a varying operand shape into a jitted call)"),
    "retrace-shape-cache-key": (
        "recapture-shape-cache-key",
        "a mapping keyed by a tensor's shape: one capture per shape"),
    "transfer-host-sync": (
        "transfer-host-sync",
        "the same check in torch's syncs: .item(), .cpu(), .tolist(), "
        ".numpy(force=True), .to('cpu'), .synchronize()"),
    "transfer-host-round-trip": (
        "transfer-host-round-trip",
        "the same check over torch's device values"),
    "transfer-sync-spill": ("transfer-sync-spill", _SAME),
    "transfer-undonated-buffer": (
        None,
        "no counterpart: the port parks caches by copy and donates no "
        "buffer (torch has no donation)"),
    "thread-no-reclaim": ("thread-no-reclaim", _SAME),
    "thread-acquire-leak": ("thread-acquire-leak", _SAME),
    "thread-ring-no-stop": ("thread-ring-no-stop", _SAME),
    "own-leak-on-path": (
        "own-leak-on-path",
        "the same check; an admission helper that returns the permit's "
        "verdict hands the permit to its caller"),
    "own-double-release": ("own-double-release", _SAME),
    "own-use-after-transfer": ("own-use-after-transfer", _SAME),
    "own-pin-no-unpin": ("own-pin-no-unpin", _SAME),
    "metrics-unregistered": ("metrics-unregistered", _SAME),
    "metrics-label-cardinality": ("metrics-label-cardinality", _SAME),
}


def all_checkers() -> List[Checker]:
    return [
        LockChecker(),
        JitPurityChecker(),
        ErrorShapeChecker(),
        ConfigDriftChecker(),
        SpanDisciplineChecker(),
        ObsDisciplineChecker(),
        ProfilerDisciplineChecker(),
        RetraceChecker(),
        TransferChecker(),
        ThreadLifecycleChecker(),
        OwnershipChecker(),
        MetricsDisciplineChecker(),
    ]
