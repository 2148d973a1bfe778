"""The port stands alone: it imports neither JAX nor the JAX package,
and reads no file of it.

A subprocess with ``jax`` and ``distributed_llm_tpu`` blocked in
``sys.modules`` imports the port's entry points (the ``/query`` and
``/chat`` servers, the router, the tier clients, the routing layer, the
bench and the tester, the roofline, telemetry and memory budget
utilities, the obs layer, int8 weights with the W1 kernel's wrapper and
the flagship cluster) and
``chip_smoke``; an AST scan of every port module and of chip_smoke.py
finds no import of either, and no string literal that points into
``distributed_llm_tpu/`` (docstrings aside, and chip_smoke's ``replaces``
citations of the TPU kernels): the routing weights and labels are the
port's own copies."""

from __future__ import annotations

import ast
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "distributed_llm_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "distributed_llm_tpu")


def _sources():
    for dirpath, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_no_module_imports_jax_or_the_jax_package():
    bad = []
    for path in _sources():
        tree = ast.parse(open(path, encoding="utf-8").read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            bad += [f"{os.path.relpath(path, REPO)}: {n}"
                    for n in names if _forbidden(n)]
    assert not bad, bad


_JAX_PATH = re.compile(r"\bdistributed_llm_tpu\b")


def _exempt_nodes(tree) -> set:
    """Docstrings, and every node under a ``"replaces"`` dict value."""
    ids = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if (isinstance(first, ast.Expr)
                    and isinstance(first.value, ast.Constant)):
                ids.add(id(first.value))
        if isinstance(node, ast.Dict):
            for key, value in zip(node.keys, node.values):
                if isinstance(key, ast.Constant) and key.value == "replaces":
                    ids.update(id(n) for n in ast.walk(value))
    return ids


def test_no_string_literal_points_into_the_jax_package():
    bad = []
    for path in _sources():
        tree = ast.parse(open(path, encoding="utf-8").read(), path)
        exempt = _exempt_nodes(tree)
        for node in ast.walk(tree):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and id(node) not in exempt
                    and _JAX_PATH.search(node.value)):
                bad.append(f"{os.path.relpath(path, REPO)}:{node.lineno}: "
                           f"{node.value[:60]!r}")
    assert not bad, bad


def test_the_routing_data_files_are_the_ports_own():
    for name in ("encoder_weights.npz", "semantic_labels.json"):
        path = os.path.join(PORT, "routing", name)
        assert os.path.isfile(path) and not os.path.islink(path), path


def test_entry_points_import_with_jax_blocked():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'distributed_llm_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import distributed_llm_tpu_torch\n"
        "import distributed_llm_tpu_torch.serving.gpu_api\n"
        "import distributed_llm_tpu_torch.serving.app\n"
        "import distributed_llm_tpu_torch.serving.router\n"
        "import distributed_llm_tpu_torch.serving.tiers\n"
        "import distributed_llm_tpu_torch.serving.breaker\n"
        "import distributed_llm_tpu_torch.routing\n"
        "from distributed_llm_tpu_torch.routing import embedder, encoder\n"
        "encoder.TrainedEncoder(device='cpu')\n"
        "embedder.get_embedder('hybrid-lexsem-v1', 'cpu').encode(['hi'])\n"
        "import distributed_llm_tpu_torch.engine.batching\n"
        "import distributed_llm_tpu_torch.engine.inference\n"
        "import distributed_llm_tpu_torch.engine.manager\n"
        "import distributed_llm_tpu_torch.engine.paged_kv\n"
        "import distributed_llm_tpu_torch.engine.prefix_cache\n"
        "import distributed_llm_tpu_torch.engine.speculative\n"
        "import distributed_llm_tpu_torch.models.convert\n"
        "import distributed_llm_tpu_torch.models.transformer\n"
        "import distributed_llm_tpu_torch.ops.attention\n"
        "import distributed_llm_tpu_torch.ops.flash_attention\n"
        "import distributed_llm_tpu_torch.ops.quant\n"
        "from distributed_llm_tpu_torch.ops import _build, launches\n"
        "assert 'w8_matmul' in launches.wrappers() and 'w8_matmul' in _build.SIGNATURES\n"
        "from distributed_llm_tpu_torch.config import flagship_cluster\n"
        "assert flagship_cluster(1).orin.quantize == 'int8'\n"
        "import distributed_llm_tpu_torch.ops.ragged_attention\n"
        "import distributed_llm_tpu_torch.ops.sampling\n"
        "import distributed_llm_tpu_torch.bench.headline\n"
        "import distributed_llm_tpu_torch.bench.query_sets\n"
        "import distributed_llm_tpu_torch.bench.tester\n"
        "import distributed_llm_tpu_torch.utils.roofline\n"
        "import distributed_llm_tpu_torch.utils.telemetry\n"
        "import distributed_llm_tpu_torch.utils.hbm_budget\n"
        "import distributed_llm_tpu_torch.obs\n"
        "from distributed_llm_tpu_torch.obs import (metrics, profiler,\n"
        "    recorder, sampler, slo, spans)\n"
        "import chip_smoke\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'distributed_llm_tpu.'))\n"
        "               for m, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
