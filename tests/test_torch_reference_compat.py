"""The reference shims on the port (``distributed_llm_tpu_torch/
reference_compat/``) against root ``compat/`` on the JAX package.

- Each shim re-exports, under the reference's bare module name, the
  port's counterpart of every name its ``compat/`` twin re-exports; the
  directory is a path entry (no ``__init__.py``).
- The reduced reference program of ``tests/test_compat.py`` (chip_smoke's
  ``REFERENCE_REDUCTION`` is that program without its JAX prelude line)
  runs through ``reference_compat/`` in a subprocess, with the port's
  one-line CPU prelude, together with a reference-shaped Flask app over
  the port's ``utils/webapp.py`` (three ``/chat`` turns of one session,
  the second a prefix hit: the plain version of K3 runs on it), and its
  routing decision equals the JAX program's through ``compat/``.
- The unchanged-reference twins of ``tests/test_reference_unchanged.py``
  run the reference's own ``app.py``, ``main.py`` and both testers on
  the port; like the JAX package's, they skip when the reference
  checkout is not mounted.
"""

from __future__ import annotations

import ast
import importlib.util
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIMS = os.path.join(REPO, "distributed_llm_tpu_torch", "reference_compat")
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402


def _jax_test_module(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(REPO, "tests", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _imported_names(path: str):
    """(source module, names) of every ``from X import ...`` in a file."""
    tree = ast.parse(open(path).read())
    return sorted((node.module, tuple(sorted(a.name for a in node.names)))
                  for node in ast.walk(tree)
                  if isinstance(node, ast.ImportFrom))


@pytest.mark.parametrize("module", ["router", "query_router_engine",
                                    "query_sets", "cache", "token_counter"])
def test_each_shim_reexports_the_ports_counterparts(module):
    jax_side = _imported_names(os.path.join(REPO, "compat", f"{module}.py"))
    port_side = _imported_names(os.path.join(SHIMS, f"{module}.py"))
    assert [(m.replace("distributed_llm_tpu.", "distributed_llm_tpu_torch."),
             names) for m, names in jax_side] == port_side
    assert not os.path.exists(os.path.join(SHIMS, "__init__.py"))


def test_the_reduction_is_test_compats_program():
    program = _jax_test_module("test_compat").REFERENCE_STYLE_PROGRAM
    lines = program.strip("\n").splitlines()
    assert lines[0].startswith("import jax")
    assert chip_smoke.REFERENCE_REDUCTION.strip("\n").splitlines() == lines[1:]


def test_reference_program_runs_via_reference_compat_like_jax():
    ours = chip_smoke.reference_program("cpu")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [os.path.join(REPO, "compat"), REPO, os.environ.get("PYTHONPATH", "")]))
    res = subprocess.run(
        [sys.executable, "-c",
         _jax_test_module("test_compat").REFERENCE_STYLE_PROGRAM],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert res.returncode == 0, res.stderr[-2000:]
    jax_line = next(ln.split() for ln in res.stdout.splitlines()
                    if ln.startswith("COMPAT_OK"))
    assert ours["compat_ok"][0] == jax_line[1]
    assert [c["device"] for c in ours["chats"]] == ["nano"] * 3
    assert not any(ours["launches"].values())      # the CPU: plain versions


# -- the reference's own programs, unchanged -------------------------------

def _reference_src() -> str:
    """The reference checkout the JAX package's twins read."""
    return _jax_test_module("test_reference_unchanged").REFERENCE_SRC


@pytest.fixture
def reference_src():
    src = _reference_src()
    if not os.path.isdir(src):
        pytest.skip("reference checkout not mounted")
    return src


def _bootstrap(src: str) -> str:
    """The JAX twins' bootstrap on the port: the CPU prelude, the shims
    and the reference's src on the path, the port's webapp as flask and
    an inert pexpect (no Jetsons to SSH into)."""
    return chip_smoke.CPU_PRELUDE + f"""
import sys, types
sys.path.insert(0, {src!r})
sys.path.insert(0, {src + '/tests'!r})
sys.path.insert(0, {SHIMS!r})
from distributed_llm_tpu_torch.utils import webapp
flask_mod = types.ModuleType("flask")
flask_mod.Flask = webapp.Flask
flask_mod.request = webapp.request
flask_mod.jsonify = webapp.jsonify
sys.modules["flask"] = flask_mod
cors_mod = types.ModuleType("flask_cors")
cors_mod.CORS = lambda app, **kw: None
sys.modules["flask_cors"] = cors_mod
pexpect_mod = types.ModuleType("pexpect")
class _Match:
    def group(self, i=0):
        return "0"
class _Child:
    before = ""
    match = _Match()
    def expect(self, *a, **kw):
        return 0
    def sendline(self, *a, **kw):
        pass
    def wait(self):
        return 0
    def close(self, *a, **kw):
        pass
pexpect_mod.spawn = lambda *a, **kw: _Child()
pexpect_mod.TIMEOUT = type("TIMEOUT", (Exception,), {{}})
pexpect_mod.EOF = type("EOF", (Exception,), {{}})
sys.modules["pexpect"] = pexpect_mod
"""


def _run(src: str, body: str, cwd: str, timeout: int = 900) -> str:
    proc = subprocess.run(
        [sys.executable, "-c", _bootstrap(src) + body], cwd=cwd,
        capture_output=True, text=True, timeout=timeout,
        env={**os.environ, "PYTHONPATH": os.pathsep.join(
            p for p in (REPO, os.environ.get("PYTHONPATH", "")) if p)})
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-2000:])
    return proc.stdout


@pytest.mark.parametrize("name", ["test_reference_app_py_serves_unchanged",
                                  "test_reference_tester_runs_unchanged",
                                  "test_reference_cli_chatbot_runs_unchanged",
                                  "test_reference_legacy_tester_runs_unchanged"])
def test_reference_program_runs_unchanged_on_the_port(name, reference_src,
                                                      tmp_path):
    """Each JAX twin's program body, run on the port's bootstrap."""
    twin = getattr(_jax_test_module("test_reference_unchanged"), name)
    bodies = [node for node in ast.walk(ast.parse(
        open(os.path.join(REPO, "tests",
                          "test_reference_unchanged.py")).read()))
        if isinstance(node, ast.FunctionDef) and node.name == name]
    call = next(n for n in ast.walk(bodies[0]) if isinstance(n, ast.Call)
                and getattr(n.func, "id", None) == "_run")
    body = ast.literal_eval(call.args[0])
    marker = {"test_reference_app_py_serves_unchanged": "REFERENCE_APP_OK",
              "test_reference_tester_runs_unchanged": "REFERENCE_TESTER_OK",
              "test_reference_cli_chatbot_runs_unchanged": "REFERENCE_CLI_OK",
              "test_reference_legacy_tester_runs_unchanged":
              "REFERENCE_LEGACY_OK"}[name]
    assert twin.__doc__
    assert marker in _run(reference_src, body, str(tmp_path))
