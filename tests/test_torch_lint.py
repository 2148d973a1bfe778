"""The port's dllm-lint (``distributed_llm_tpu_torch/lint``).

Three parts:

- **Parity.**  The checkers whose rules hold no JAX (locks, error shape,
  spans, the SLO feed, metrics, threads, ownership) and the call graph
  they share must read a source exactly as the JAX package's lint does.
  Every fixture the JAX lint's own tests feed those checkers
  (``tests/test_lint.py``) is harvested by running those tests with the
  fixture loader recorded; each fixture then goes through JAX's checker
  under ``distributed_llm_tpu/<layer>/`` and through the port's under
  ``distributed_llm_tpu_torch/<layer>/`` (the package name renamed in
  the source too, which keeps every line number), and the two must give
  the same ``(rule, line)`` lists.
- **The torch rules.**  Capture purity, recapture, torch's transfer
  syncs, the empty env registry, the profiler rule over captured
  bodies, the port's blocking names, the span-factory delegation and
  the admission-permit wrappers: each gets a fixture it must flag and a
  near-miss it must not.
- **The whole tree.**  ``python -m distributed_llm_tpu_torch.lint`` gives
  zero findings over the port, every suppression is justified and names
  a real rule, and a copy of the tree with one ``x.item()`` inserted into
  a real callee of the scheduler loop gives exactly one
  ``transfer-host-sync``.

Pure AST passes: no engine, no torch import in the lint itself.
"""

from __future__ import annotations

import ast
import importlib.util
import io
import json
import os
import re
import shutil
import subprocess
import sys
import textwrap
import tokenize

import pytest

from distributed_llm_tpu.lint import Module as JaxModule
from distributed_llm_tpu.lint import Project as JaxProject
from distributed_llm_tpu.lint import run_checkers as jax_run_checkers
from distributed_llm_tpu.lint.checkers import all_checkers as jax_checkers
from distributed_llm_tpu.lint.symbols import \
    project_symbols as jax_project_symbols
from distributed_llm_tpu_torch.lint import (Module, Project, all_checkers,
                                            load_project, repo_root,
                                            run_checkers)
from distributed_llm_tpu_torch.lint.checkers import JAX_RULES
from distributed_llm_tpu_torch.lint.core import SUPPRESS_RE
from distributed_llm_tpu_torch.lint.symbols import project_symbols

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TESTS = os.path.join(REPO, "tests", "test_lint.py")
PKG = re.compile(r"\bdistributed_llm_tpu\b")

# The checkers held to JAX's findings, by checker name (the same name on
# both sides).
PARITY_CHECKERS = ("locks", "error_shape", "span_discipline",
                   "obs_discipline", "metrics_discipline",
                   "thread_lifecycle", "ownership")
# The JAX lint tests whose fixtures feed those checkers or the graph.
PARITY_TESTS = ("test_lock_", "test_error_shape_", "test_span_discipline_",
                "test_obs_discipline_flags_slo",
                "test_obs_discipline_near_miss_unrelated",
                "test_suppression_", "test_callgraph_", "test_thread_",
                "test_ownership_", "test_metrics_flags_",
                "test_metrics_silent_", "test_metrics_get_",
                "test_hot_path_annotation_")


def _jax_parity_tests():
    """Names of the JAX lint tests that take no pytest fixture and whose
    name marks them as parity fixtures (an AST scan: cheap to collect)."""
    tree = ast.parse(open(JAX_TESTS, encoding="utf-8").read())
    return [n.name for n in tree.body
            if isinstance(n, ast.FunctionDef)
            and n.name.startswith(PARITY_TESTS)
            and not n.args.args]


def _jax_test_module():
    spec = importlib.util.spec_from_file_location("_jax_test_lint",
                                                  JAX_TESTS)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _harvest(name):
    """Run the JAX lint test ``name`` with its fixture loader recorded:
    every (sources, complete) it built."""
    mod = _jax_test_module()
    seen = []
    real = mod._project

    def recording(files, *, dedent=True, complete=True):
        project = real(files, dedent=dedent, complete=complete)
        seen.append(({p: m.source for p, m in project.modules.items()},
                     complete))
        return project

    mod._project = recording
    getattr(mod, name)()
    return seen


def _port(text):
    return PKG.sub("distributed_llm_tpu_torch", text)


def _keyed(findings):
    return sorted((f.rule, f.path, f.line) for f in findings)


@pytest.mark.parametrize("jax_test", _jax_parity_tests())
def test_checkers_match_jax_on_its_own_fixtures(jax_test):
    """Each fixture of the JAX test goes through every parity checker on
    both sides: the same findings and the same suppressed findings, rule
    for rule and line for line, and the same call graph."""
    fixtures = _harvest(jax_test)
    assert fixtures, f"{jax_test} built no fixture"
    jax_by_name = {c.name: c for c in jax_checkers()}
    port_by_name = {c.name: c for c in all_checkers()}
    for sources, complete in fixtures:
        jp = JaxProject("/", {p: JaxModule(p, s) for p, s in sources.items()},
                        complete=complete)
        pp = Project("/", {_port(p): Module(_port(p), _port(s))
                           for p, s in sources.items()}, complete=complete)
        for name in PARITY_CHECKERS:
            want = jax_run_checkers(jp, [jax_by_name[name]])
            got = run_checkers(pp, [port_by_name[name]])
            assert _keyed(got.findings) == [
                (r, _port(p), ln) for r, p, ln in _keyed(want.findings)], name
            assert _keyed(f for f, _ in got.suppressed) == [
                (r, _port(p), ln)
                for r, p, ln in _keyed(f for f, _ in want.suppressed)], name
        jg, pg = jax_project_symbols(jp), project_symbols(pp)
        assert {(_port(a), _port(b or "")) for a, e in jg.calls.items()
                for b, _, _ in e} == {(a, b or "") for a, e in pg.calls.items()
                                       for b, _, _ in e}
        assert {_port(g): [(_port(r), ln) for r, ln in v]
                for g, v in jg.thread_target_gids().items()} \
            == pg.thread_target_gids()


def test_every_jax_rule_is_accounted_for():
    """``checkers/__init__.py`` lists each rule id of the JAX lint beside
    the port rule that checks it, or marks it as having no counterpart,
    with the reason; every port rule it names exists."""
    jax_rules = {r for c in jax_checkers() for r in c.rules}
    port_rules = {r for c in all_checkers() for r in c.rules}
    assert set(JAX_RULES) == jax_rules
    for jax_rule, (port_rule, why) in JAX_RULES.items():
        assert why.strip(), jax_rule
        assert port_rule is None or port_rule in port_rules, jax_rule
    assert [r for r, (p, _) in JAX_RULES.items() if p is None] == [
        "transfer-undonated-buffer"]
    # Every port rule answers to a JAX rule: nothing new was invented.
    assert port_rules == {p for p, _ in JAX_RULES.values() if p}


# -- the torch rules ----------------------------------------------------------

ENGINE = "distributed_llm_tpu_torch/engine/fixture.py"
HELPER = "distributed_llm_tpu_torch/ops/helper.py"
SERVING = "distributed_llm_tpu_torch/serving/fixture.py"


def _project(files, complete=True):
    return Project("/", {p: Module(p, textwrap.dedent(s))
                         for p, s in files.items()}, complete=complete)


def _lint(files, rules=None, **kw):
    return run_checkers(_project(files, **kw), all_checkers(), rules=rules)


def _found(files, rules=None, **kw):
    return [(f.rule, f.path, f.line) for f in _lint(files, rules, **kw).findings]


CAPTURE_RULES = ("capture-host-impurity", "capture-host-sync")

CAPTURE_BAD = """
    import time
    import torch
    from .programs import capture_program

    class Engine:
        def _build(self):
            def body():
                n = self.lens.item()             # line 9: a host sync
                t = time.perf_counter()          # line 10: capture-time only
                if bool(torch.any(self.done)):   # line 11: a pull
                    return None
                return self.model(self.tokens)
            return capture_program(body, self.device, self.stream, self.pool)
"""

CAPTURE_NEAR_MISS = """
    import time
    import torch
    from .programs import capture_program

    class Engine:
        def _build(self):
            def body():
                return self.model(self.tokens)
            return capture_program(body, self.device, self.stream, self.pool)

        def tick(self, prog):
            t = time.perf_counter()              # host side of the replay
            out = prog.run()
            n = out.item()                       # after the replay: host code
            return n, time.perf_counter() - t
"""


def test_capture_purity_flags_sync_impurity_and_pull_in_a_captured_body():
    assert _found({ENGINE: CAPTURE_BAD}, CAPTURE_RULES) == [
        ("capture-host-sync", ENGINE, 9),
        ("capture-host-impurity", ENGINE, 10),
        ("capture-host-sync", ENGINE, 11)]


def test_capture_purity_near_miss_host_code_around_the_replay():
    assert _found({ENGINE: CAPTURE_NEAR_MISS}, CAPTURE_RULES) == []


@pytest.mark.parametrize("root", [
    # what a ``_body(key, rung)`` provider returns, through a dispatch dict
    """
    class Engine:
        def _body(self, stage, key):
            return {"decode": self._decode_body}[stage](key)

        def _decode_body(self, wb):
            def body():
                return self.x.cpu()
            return body
    """,
    # a lambda handed to TickProgram with a graph
    """
    from .programs import TickProgram

    class Engine:
        def _build(self, graph):
            return TickProgram(lambda: self.x.cpu(), graph, self.capture)
    """,
    # the engine's own capture helper
    """
    class Engine:
        def _prog(self):
            return self._capture(self._step)

        def _step(self):
            return self.x.cpu()
    """,
    # a ``with torch.cuda.graph(g)`` block
    """
    import torch

    def record(x):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            y = x.cpu()
        return g, y
    """,
])
def test_capture_roots_cover_every_capture_form(root):
    found = _found({ENGINE: root}, CAPTURE_RULES)
    assert [r for r, _, _ in found] == ["capture-host-sync"], found


def test_capture_purity_follows_a_body_into_another_module():
    files = {
        ENGINE: """
            from ..ops import helper
            from .programs import capture_program

            def build(dev, stream, pool, x):
                def body():
                    return helper.lengths(x)
                return capture_program(body, dev, stream, pool)
        """,
        HELPER: """
            def lengths(x):
                return x.tolist()
        """,
    }
    assert _found(files, CAPTURE_RULES) == [("capture-host-sync", HELPER, 3)]
    # Near miss: the same helper, called from host code only.
    files[ENGINE] = files[ENGINE].replace("return helper.lengths(x)",
                                          "return x + 1")
    assert _found(files, CAPTURE_RULES) == []


RECAPTURE_RULES = ("recapture-in-loop", "recapture-per-call",
                   "recapture-unbounded-key", "recapture-shape-cache-key")


def test_recapture_flags_a_capture_in_a_loop_and_warmup_is_exempt():
    src = """
        from .programs import capture_program

        class Engine:
            def serve(self, bodies):
                for body in bodies:
                    capture_program(body, self.dev, self.s, self.p).run()

            def warmup(self, bodies):
                for body in bodies:
                    self.progs.append(capture_program(body, self.dev,
                                                      self.s, self.p))

            def replay_all(self):
                for prog in self.progs:
                    prog.run()
    """
    assert _found({ENGINE: src}, RECAPTURE_RULES) == [
        ("recapture-in-loop", ENGINE, 7)]


def test_recapture_flags_a_per_call_capture_on_the_hot_path_only():
    src = """
        from .programs import capture_program

        class Engine:
            def _loop(self):     # dllm-lint: hot-path
                self._tick()
                self._tick_cached()

            def _tick(self):
                return capture_program(self._body, self.dev, self.s,
                                       self.p).run()

            def _tick_cached(self):
                prog = self._programs.get("decode")
                if prog is None:
                    prog = self._programs["decode"] = capture_program(
                        self._body, self.dev, self.s, self.p)
                return prog.run()

            def cold(self):
                return capture_program(self._body, self.dev, self.s,
                                       self.p).run()
    """
    assert _found({ENGINE: src}, RECAPTURE_RULES) == [
        ("recapture-per-call", ENGINE, 10)]


def test_recapture_flags_a_program_key_from_a_prompt_length():
    src = """
        class Engine:
            def admit(self, prompt, bucket, rung):
                self._built(("suffix", len(prompt)), rung).run()
                self._built(("suffix", bucket), rung).run()
                self._built("writer", prompt.shape[1] // 16).run()
    """
    assert _found({ENGINE: src}, RECAPTURE_RULES) == [
        ("recapture-unbounded-key", ENGINE, 4),
        ("recapture-unbounded-key", ENGINE, 6)]


def test_recapture_flags_a_shape_keyed_cache_not_a_slice_or_scalar():
    src = """
        class Engine:
            def prog(self, x, q, tables):
                p = self._progs[x.shape]
                y = x[: q.shape[1]]
                t = tables[q.shape[0]]
                return p, y, t
    """
    assert _found({ENGINE: src}, RECAPTURE_RULES) == [
        ("recapture-shape-cache-key", ENGINE, 4)]


TRANSFER_RULES = ("transfer-host-sync", "transfer-host-round-trip",
                  "transfer-sync-spill")

HOT_ENGINE = """
    import numpy as np
    import torch
    from ..ops import helper

    def _fetch_tick(x):
        # dllm-lint: disable=transfer-host-sync -- the one sanctioned sync per tick
        return x.cpu().numpy()

    class Engine:
        def _loop(self):          # dllm-lint: hot-path
            toks = _fetch_tick(self.prog.run())
            helper.pull(self.out)
            first = int(self._first())
            n = int(self.prog.run())
            host = self.staging.numpy()
            kv = self.pool.cpu()
            self.event.synchronize()
            torch.cuda.synchronize()
            return toks, first, n, host, kv, int(np.asarray(toks)[0])

        def _first(self) -> torch.Tensor:
            return self.prog.run()

        def warmup(self):
            return self.out.item()
"""


def test_transfer_flags_torch_syncs_across_modules_from_a_hot_root():
    files = {ENGINE: HOT_ENGINE, HELPER: """
        def pull(x):
            return x.item()
    """}
    assert _found(files, TRANSFER_RULES) == [
        ("transfer-host-round-trip", ENGINE, 14),   # int() of a Tensor fn
        ("transfer-host-round-trip", ENGINE, 15),   # int() of a replay
        ("transfer-sync-spill", ENGINE, 17),        # pool data to host
        ("transfer-host-sync", ENGINE, 18),         # Event.synchronize()
        ("transfer-host-sync", ENGINE, 19),         # torch.cuda.synchronize()
        ("transfer-host-sync", HELPER, 3),          # .item() one module away
    ]
    suppressed = _lint(files, TRANSFER_RULES).suppressed
    # _fetch_tick's suppression is honoured, and ``x.cpu().numpy()`` is
    # one sync (the .cpu()), not two.
    assert [(f.rule, f.line) for f, _ in suppressed] == [
        ("transfer-host-sync", 8)]


def test_transfer_near_miss_no_hot_root_and_warmup_exempt():
    files = {ENGINE: HOT_ENGINE.replace("# dllm-lint: hot-path", ""),
             HELPER: "def pull(x):\n    return x.item()\n"}
    assert _found(files, TRANSFER_RULES) == []


def test_config_drift_flags_every_dllm_env_read():
    src = """
        import os

        def knob():
            a = os.environ.get("DLLM_TP", "1")
            b = os.environ.get("HOME")
            return a, b, os.getenv("DLLM_NATIVE")
    """
    assert _found({ENGINE: src}, ("config-env-unregistered",)) == [
        ("config-env-unregistered", ENGINE, 5),
        ("config-env-unregistered", ENGINE, 7)]


def test_config_drift_holds_the_ports_fields_to_jaxs_one_liners():
    path = "distributed_llm_tpu_torch/config.py"
    src = open(os.path.join(REPO, path), encoding="utf-8").read()
    rules = ("config-field-undocumented", "config-field-stale")
    clean = run_checkers(Project("/", {path: Module(path, src)}),
                         all_checkers(), rules=rules)
    assert clean.findings == []
    extra = src.replace("class TierConfig:",
                        "class TierConfig:\n    lint_probe: int = 0", 1)
    flagged = run_checkers(Project("/", {path: Module(path, extra)}),
                           all_checkers(), rules=rules)
    assert [(f.rule, f.line) for f in flagged.findings] == [
        ("config-field-undocumented", extra.splitlines().index(
            "    lint_probe: int = 0") + 1)]


def test_profiler_stamp_in_a_captured_body_flagged_not_around_the_replay():
    src = """
        class Engine:
            def _body(self, stage, key):
                return self._decode_body(key)

            def _decode_body(self, wb):
                def body():
                    with self.profiler.phase("decode"):
                        return self.model(self.x)
                return body

            def tick(self, prog):
                with self.profiler.phase("decode"):
                    return prog.run()
    """
    assert _found({ENGINE: src}, ("profiler-hook-in-captured-code",)) == [
        ("profiler-hook-in-captured-code", ENGINE, 8)]


@pytest.mark.parametrize("blocking", [
    "capture_program(body, self.dev, self.s, self.p)",
    "self._capture(body)",
    "self.done.synchronize()",
    "torch.cuda.synchronize()",
    "_build.entry('ragged_decode')",
])
def test_lock_held_through_the_ports_compile_or_a_sync_is_flagged(blocking):
    """PR 2's shape in the port's words: a lock held through a capture,
    a device sync or the nvcc build a kernel's first launch waits on
    (``entry`` -> ``build`` -> ``proc.communicate()``, another module)."""
    files = {
        ENGINE: f"""
            import threading
            import torch
            from ..ops import _build
            from .programs import capture_program

            class Engine:
                def __init__(self):
                    self._lock = threading.Lock()

                def program(self, body):
                    with self._lock:
                        return {blocking}

                def program_unlocked(self, body):
                    return {blocking}
        """,
        "distributed_llm_tpu_torch/ops/_build.py": """
            import subprocess

            def build(names):
                proc = subprocess.Popen(["nvcc"])
                out, _ = proc.communicate()
                return out

            def entry(name):
                return build([name])
        """,
    }
    assert _found(files, ("lock-blocking-call",)) == [
        ("lock-blocking-call", ENGINE, 13)]


def test_a_span_returned_to_the_callers_with_is_a_factory():
    """The batched engine's ``_stamp`` returns a profiler phase (or a
    null context) for its caller's ``with``: the return is no bare span,
    and the helper's own calls must then be with items."""
    src = """
        import contextlib

        class Engine:
            def _stamp(self, name):
                if self._warming:
                    return contextlib.nullcontext()
                return self.profiler.phase(name)

            def _tick_phase(self):
                return self._stamp("decode")

            def tick(self):
                with self._stamp("upload"), self._tick_phase():
                    pass
                self._stamp("leak")
                self._tick_phase()
    """
    assert _found({ENGINE: src}, ("span-not-with",)) == [
        ("span-not-with", ENGINE, 16), ("span-not-with", ENGINE, 17)]


ADMIT_HELPER = """
    def create_app(admission):
        def admit():
            err = admission.try_admit()
            if err is None:
                return None
            return {"error": err}

        def release():
            admission.release()

        def handler():
            refused = admit()
            if refused is not None:
                return refused
            try:
                return work()
            finally:
                release()

        def leaky():
            refused = admit()
            if refused is not None:
                return refused
            return work()

        return handler, leaky
"""


def test_an_admission_helper_hands_its_permit_to_the_caller():
    """``admit()`` returns None exactly when the permit is held: it is no
    leak there, its callers own the permit from the call on, and a
    caller that never releases it is the leak."""
    found = _found({SERVING: ADMIT_HELPER}, ("own-leak-on-path",))
    assert found == [("own-leak-on-path", SERVING, 22)]


# -- the whole tree -----------------------------------------------------------

BLOCKED = ("torch", "jax", "jaxlib", "distributed_llm_tpu")


def _cli(*args, blocked=BLOCKED):
    """``python -m distributed_llm_tpu_torch.lint`` in a fresh process with
    torch, JAX and the JAX package blocked from import."""
    code = ("import sys\n"
            f"for name in {blocked!r}:\n"
            "    sys.modules[name] = None\n"
            "from distributed_llm_tpu_torch.lint.__main__ import main\n"
            f"sys.exit(main({list(args)!r}))\n")
    return subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)


@pytest.fixture(scope="module")
def port_project():
    """The port's tree, parsed once for the module (its call graph is
    cached on it)."""
    return load_project(repo_root())


@pytest.fixture(scope="module")
def tree_result(port_project):
    """One whole-tree run of every checker."""
    return run_checkers(port_project, all_checkers())


def test_the_port_lints_clean(tree_result):
    assert tree_result.findings == [], "\n".join(
        f.render() for f in tree_result.findings)


def test_the_lint_runs_without_torch_or_jax():
    """The CLI imports every checker with torch, JAX and the JAX package
    blocked, and lints a part of the tree."""
    out = _cli("--list-rules")
    assert out.returncode == 0, out.stderr
    out = _cli("--json", "distributed_llm_tpu_torch/serving")
    assert out.returncode == 0, out.stderr
    payload = json.loads(out.stdout)
    assert payload["ok"] and payload["counts"]["suppressed"] > 0


def _suppression_comments(mod):
    toks = tokenize.generate_tokens(io.StringIO(mod.source).readline)
    return [t.start[0] for t in toks if t.type == tokenize.COMMENT
            and SUPPRESS_RE.search(t.string)]


def test_every_suppression_is_justified_and_names_a_real_rule(
        port_project, tree_result):
    """Each suppression comment carries its why and names a rule some
    checker owns, and each one silences a finding: none is stale."""
    known = {r for c in all_checkers() for r in c.rules}
    lines = []
    for rel, mod in port_project.modules.items():
        assert not mod.suppressions.malformed, rel
        assert not mod.suppressions.file_level, rel
        for rules in mod.suppressions.by_line.values():
            assert rules <= known, (rel, rules)
        lines += [(rel, ln) for ln in _suppression_comments(mod)]
    used = set()
    for f, _kind in tree_result.suppressed:
        comment = f.line if (f.path, f.line) in lines else f.line - 1
        used.add((f.path, comment))
    assert sorted(used) == sorted(lines)
    assert len(tree_result.suppressed) == len(lines)


def test_the_hot_path_roots_are_the_three_counterparts_of_jaxs(
        port_project):
    ps = project_symbols(port_project)
    from distributed_llm_tpu_torch.lint.symbols import hot_path_roots
    assert hot_path_roots(ps) == {
        "distributed_llm_tpu_torch/engine/batching.py:"
        "ContinuousBatchingEngine._loop",
        "distributed_llm_tpu_torch/obs/sampler.py:"
        "SystemStateSampler.sample_once",
        "distributed_llm_tpu_torch/serving/router.py:Router._sampler_collect"}


def test_fetch_tick_is_the_suppressed_sync_of_the_tick(tree_result):
    syncs = [(f.path, f.message) for f, _ in tree_result.suppressed
             if f.rule == "transfer-host-sync"]
    assert any(p.endswith("engine/batching.py") and "`_fetch_tick`" in m
               for p, m in syncs), syncs


def test_one_item_in_a_callee_of_the_loop_is_one_host_sync(
        tmp_path, port_project):
    """Mutation check: a copy of the port's tree with ``.item()`` added to
    ``_stage_inputs`` (the tick's input staging, which the scheduler loop
    reaches through ``_decode_tick`` -> ``_stage``) gives exactly one new
    ``transfer-host-sync``, at the inserted line."""
    from distributed_llm_tpu_torch.lint.checkers.transfer import \
        TransferChecker
    src_pkg = os.path.join(REPO, "distributed_llm_tpu_torch")
    dst_pkg = tmp_path / "distributed_llm_tpu_torch"
    shutil.copytree(src_pkg, dst_pkg, ignore=lambda d, names: [
        n for n in names if not (n.endswith(".py")
                                 or os.path.isdir(os.path.join(d, n)))
        or n == "__pycache__"])
    path = dst_pkg / "engine" / "batching.py"
    lines = path.read_text(encoding="utf-8").split("\n")
    tree = ast.parse("\n".join(lines))
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
              and n.name == "_stage_inputs")
    at = fn.body[1].lineno            # the first statement after the doc
    indent = lines[at - 1][:len(lines[at - 1]) - len(lines[at - 1].lstrip())]
    lines.insert(at - 1, f"{indent}probe = self._tables_dev.item()")
    path.write_text("\n".join(lines), encoding="utf-8")

    def syncs(project):
        result = run_checkers(project, [TransferChecker()])
        return ([(f.rule, f.path, f.line) for f in result.findings],
                len(result.suppressed))

    clean, n_clean = syncs(port_project)
    mutated, n_mutated = syncs(load_project(str(tmp_path)))
    assert clean == []
    assert mutated == [("transfer-host-sync",
                        "distributed_llm_tpu_torch/engine/batching.py", at)]
    assert n_mutated == n_clean


def test_cli_lists_rules_and_refuses_bad_usage():
    out = _cli("--list-rules")
    assert out.returncode == 0, out.stderr
    for checker in all_checkers():
        assert f"{checker.name}:" in out.stdout
        for rule in checker.rules:
            assert f"  {rule}\n" in out.stdout
    assert _cli("no/such/target").returncode == 2
    assert _cli("--changed", "--",
                "distributed_llm_tpu_torch/serving").returncode == 2


def test_cli_exit_codes_and_json_schema(tmp_path, monkeypatch, capsys):
    from distributed_llm_tpu_torch import lint
    from distributed_llm_tpu_torch.lint.__main__ import main
    pkg = tmp_path / "distributed_llm_tpu_torch" / "engine"
    pkg.mkdir(parents=True)
    (pkg / "knob.py").write_text(
        "import os\n"
        "TP = os.environ.get('DLLM_TP')\n"
        "NATIVE = os.environ.get('DLLM_NATIVE')  "
        "# dllm-lint: disable=config-env-unregistered -- fixture\n",
        encoding="utf-8")
    monkeypatch.setattr(lint, "repo_root", lambda: str(tmp_path))
    assert main([]) == 1
    assert "knob.py:2: [config-env-unregistered]" in capsys.readouterr().out
    assert main(["--json"]) == 1
    payload = json.loads(capsys.readouterr().out)
    assert payload["counts"] == {"findings": 1, "suppressed": 1}
    assert not payload["ok"]
    assert sorted((f["line"], f["suppressed"]) for f in payload["findings"]) \
        == [(2, False), (3, True)]
    assert main(["--rule", "error-shape"]) == 0
