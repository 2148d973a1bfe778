"""The port's ``GET /stats`` against the JAX package's: the same top-level
keys on ``with_default_checkpoints(tiny_cluster())`` on the CPU, with
``measured_tables`` among them (the backend, "none" for the attention
dispatch table the port does not have, and the tuning table's backend
where one was measured on it).
"""

from __future__ import annotations

from distributed_llm_tpu import config as jax_config
from distributed_llm_tpu.serving.app import create_app as jax_app
from distributed_llm_tpu_torch import config as torch_config
from distributed_llm_tpu_torch.bench import tune
from distributed_llm_tpu_torch.serving.app import create_app


def _stats(app, query: str = "") -> dict:
    resp = app.test_client().get("/stats" + query)
    assert resp.status_code == 200
    return resp.get_json() if hasattr(resp, "get_json") else resp.json


def test_stats_top_level_keys_match_jax():
    apps = {"jax": jax_app(cluster=jax_config.with_default_checkpoints(
                jax_config.tiny_cluster())),
            "torch": create_app(cluster=torch_config.with_default_checkpoints(
                torch_config.tiny_cluster()), device="cpu")}
    try:
        for query in ("", "?debug=1"):
            got = {who: _stats(app, query) for who, app in apps.items()}
            assert set(got["torch"]) == set(got["jax"]), query
        tables = got["torch"]["measured_tables"]
        assert set(tables) == set(got["jax"]["measured_tables"]) & {
            "backend", "dispatch", "tuning"} == {"backend", "dispatch",
                                                 "tuning"}
        assert tables == {"backend": "cpu", "dispatch": "none",
                          "tuning": "cpu" if tune.load_tuning("cpu")
                          else "none"}
    finally:
        for app in apps.values():
            app.extensions["dllm_state"]["router"].drain(timeout_s=10.0)
