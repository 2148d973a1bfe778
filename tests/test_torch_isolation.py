"""The port stands alone: it imports neither JAX nor the JAX package.

A subprocess with ``jax`` and ``distributed_llm_tpu`` blocked in
``sys.modules`` imports the port's entry points and ``chip_smoke``; an
AST scan of every port module and of chip_smoke.py finds no import of
either."""

from __future__ import annotations

import ast
import os
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


def test_entry_points_import_with_jax_blocked():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'distributed_llm_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import distributed_llm_tpu_torch\n"
        "import distributed_llm_tpu_torch.serving.gpu_api\n"
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
        "import distributed_llm_tpu_torch.ops.ragged_attention\n"
        "import distributed_llm_tpu_torch.ops.sampling\n"
        "import chip_smoke\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'distributed_llm_tpu.'))\n"
        "               for m, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
