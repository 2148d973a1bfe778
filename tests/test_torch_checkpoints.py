"""The port's trained weights (``checkpoint_path``) against the JAX
package's.

- The exporter (``port_tools/export_checkpoints.py``), run into a
  temporary directory on the committed Orbax checkpoints, reproduces the
  committed exports (``distributed_llm_tpu_torch/weights/*.npz``) byte
  for byte.
- ``models/checkpoint.load_params_for_tier`` gives, leaf for leaf, the
  weights the JAX package's ``utils/checkpoint.load_params_for_tier``
  restores, for nano_test (v500) and orin_test (v320).
- ``default_checkpoint`` and ``with_default_checkpoints`` return the JAX
  package's paths and clusters.
- Greedy tokens of the batched and the sequential engines of both
  packages on the trained tiers are identical, and one ``/chat`` reply
  through the JAX package's ``create_app()`` equals the port's
  ``create_app(device="cpu")`` reply text for text, for a nano-routed and
  an orin-routed message.  Both run at float32 copies of the tiny presets
  (the trained bf16 weights, held exactly): in bf16 the two packages'
  CPU math rounds at different points, and a greedy step whose top two
  logits tie in bf16 may go either way (``test_bf16_flips_are_ties``).
- A stale or missing export raises ``FileNotFoundError`` naming the
  exporter; nothing falls back to random weights.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "port_tools"))
import export_checkpoints  # noqa: E402

from distributed_llm_tpu import config as jax_config  # noqa: E402
from distributed_llm_tpu.utils import checkpoint as jax_ckpt  # noqa: E402
from distributed_llm_tpu_torch import config as torch_config  # noqa: E402
from distributed_llm_tpu_torch.models import checkpoint as torch_ckpt  # noqa: E402
from distributed_llm_tpu_torch.models import transformer as T  # noqa: E402
from test_torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


PRESETS = ("nano_test", "orin_test")
VERSIONS = {"nano_test": "v500", "orin_test": "v320"}
PROMPTS = ["what is the capital of france?",
           "explain how rivers form deltas near the sea",
           "write a python function that sorts a list",
           "a long question about rivers lakes mountains oceans deltas and "
           "the weather systems that move between them " * 3]
FOLLOW_UP = [{"role": "user", "content": PROMPTS[1]},
             {"role": "assistant", "content": "they carry silt"},
             {"role": "user", "content": "and what happens at the coast?"}]
NANO_MSG = "hello there"
ORIN_MSG = ("Implement a dynamic-programming solution to the knapsack "
            "problem and analyze its complexity")


@pytest.fixture
def float32_presets(monkeypatch):
    """nano_test and orin_test at float32 in both packages' preset tables
    (same names, so the checkpoints still resolve)."""
    for table in (jax_config.MODEL_PRESETS, torch_config.MODEL_PRESETS):
        for name in PRESETS:
            monkeypatch.setitem(table, name, dataclasses.replace(
                table[name], dtype="float32"))


def test_exporter_reproduces_the_committed_exports(tmp_path):
    for preset in PRESETS:
        path = export_checkpoints.export(preset, str(tmp_path))
        committed = os.path.join(torch_ckpt.WEIGHTS_DIR, f"{preset}.npz")
        with open(path, "rb") as a, open(committed, "rb") as b:
            assert a.read() == b.read(), preset
        tree = torch_ckpt.load_export(committed)
        assert (tree["preset"], tree["version"]) == (preset,
                                                     VERSIONS[preset])


@pytest.mark.parametrize("preset", PRESETS)
def test_weights_equal_the_jax_loaders(preset):
    path = torch_config.default_checkpoint(preset)
    assert path == jax_config.default_checkpoint(preset)
    cfg_j = jax_config.MODEL_PRESETS[preset]
    want = jax_ckpt.load_params_for_tier(path, cfg_j)
    model = torch_ckpt.load_params_for_tier(
        path, torch_config.MODEL_PRESETS[preset])
    assert model.embed.dtype == torch.bfloat16

    def same(got: torch.Tensor, ref) -> None:
        ref = np.asarray(ref, np.float32)
        assert np.array_equal(got.float().numpy(), ref)

    same(model.embed, want["embed"])
    same(model.final_ln, want["final_ln"])
    for key, leaf in want["layers"].items():
        for i, layer in enumerate(model.layers):
            same(getattr(layer, key), leaf[i])


def test_default_checkpoints_match_jax():
    for name in ("tiny_cluster", "tiny_batched_cluster", "bench_cluster"):
        got = torch_config.with_default_checkpoints(
            getattr(torch_config, name)())
        want = jax_config.with_default_checkpoints(
            getattr(jax_config, name)())
        if name != "bench_cluster":   # the JAX bench cluster's presets differ
            assert ([t.checkpoint_path for t in got.tiers()]
                    == [t.checkpoint_path for t in want.tiers()])
        for t in got.tiers():
            t.check_ported()          # checkpoint_path is ported
    assert torch_config.default_checkpoint("nano_1b") is None
    pinned = dataclasses.replace(
        torch_config.tiny_cluster(),
        nano=dataclasses.replace(torch_config.tiny_cluster().nano,
                                 checkpoint_path="/elsewhere"))
    assert (torch_config.with_default_checkpoints(pinned).nano
            .checkpoint_path == "/elsewhere")


def _tokens(engine, prompts):
    return [list(engine.generate(p).token_ids) for p in prompts]


@pytest.mark.parametrize("batched", [True, False],
                         ids=["batched", "sequential"])
def test_engine_tokens_equal_jax_on_trained_weights(float32_presets,
                                                    batched):
    if batched:
        from distributed_llm_tpu.engine.batching import (
            ContinuousBatchingEngine as JaxEngine)
        from distributed_llm_tpu_torch.engine.batching import (
            ContinuousBatchingEngine as TorchEngine)
        cluster = "tiny_batched_cluster"
    else:
        from distributed_llm_tpu.engine.inference import (
            InferenceEngine as JaxEngine)
        from distributed_llm_tpu_torch.engine.inference import (
            InferenceEngine as TorchEngine)
        cluster = "tiny_cluster"
    jc = jax_config.with_default_checkpoints(getattr(jax_config, cluster)())
    tc = torch_config.with_default_checkpoints(
        getattr(torch_config, cluster)())
    prompts = PROMPTS + [FOLLOW_UP]
    for name in ("nano", "orin"):
        jt = dataclasses.replace(getattr(jc, name), tp=1)
        je, te = JaxEngine(jt), TorchEngine(getattr(tc, name), device="cpu")
        try:
            assert te.model.embed.dtype == torch.float32
            want, got = _tokens(je, prompts), _tokens(te, prompts)
        finally:
            for eng in (je, te):
                getattr(eng, "stop", lambda: None)()
        assert got == want, name
        assert all(len(t) > 0 for t in got)


def test_chat_replies_equal_jax(float32_presets):
    """JAX's ``create_app()`` and the port's ``create_app(device="cpu")``,
    each over its default cluster: the trained tiny tiers."""
    from distributed_llm_tpu.serving.app import create_app as jax_app
    from distributed_llm_tpu_torch.serving.app import create_app

    apps = {"jax": jax_app(), "torch": create_app(device="cpu")}
    try:
        replies = {}
        for who, app in apps.items():
            router = app.extensions["dllm_state"]["router"]
            assert all(t.tier.checkpoint_path for t in router.tiers.values())
            client = app.test_client()
            replies[who] = []
            for i, msg in enumerate((NANO_MSG, ORIN_MSG)):
                r = client.post("/chat", json={"message": msg,
                                               "session_id": f"s{i}"})
                body = r.get_json() if hasattr(r, "get_json") else r.json
                replies[who].append((body["device"], body["reply"],
                                     body["tokens"]))
    finally:
        for app in apps.values():
            app.extensions["dllm_state"]["router"].drain(timeout_s=10.0)
    assert [d for d, _, _ in replies["torch"]] == ["nano", "orin"]
    assert replies["torch"] == replies["jax"]
    assert all(text for _, text, _ in replies["torch"])


def test_bf16_flips_are_ties():
    """At the presets' own bf16 the two packages' batched engines give the
    same greedy tokens but where the top two logits tie: at the first
    differing step the port's float32 logits of the trained weights put
    the two picks first and second, under 0.05 apart."""
    from distributed_llm_tpu.engine.batching import (
        ContinuousBatchingEngine as JaxEngine)
    from distributed_llm_tpu_torch.engine.batching import (
        ContinuousBatchingEngine as TorchEngine)
    from distributed_llm_tpu_torch.engine.inference import prepare_prompt

    jc = jax_config.with_default_checkpoints(jax_config.tiny_batched_cluster())
    tc = torch_config.with_default_checkpoints(
        torch_config.tiny_batched_cluster())
    for name in ("nano", "orin"):
        jt = dataclasses.replace(getattr(jc, name), tp=1)
        tier = getattr(tc, name)
        je, te = JaxEngine(jt), TorchEngine(tier, device="cpu")
        try:
            want, got = _tokens(je, PROMPTS), _tokens(te, PROMPTS)
        finally:
            je.stop()
            te.stop()
        cfg = dataclasses.replace(tier.model(), dtype="float32")
        model = torch_ckpt.load_params_for_tier(tier.checkpoint_path, cfg)
        for prompt, w, g in zip(PROMPTS, want, got):
            if w == g:
                continue
            p = next(i for i, (a, b) in enumerate(zip(w, g)) if a != b)
            ids, _ = prepare_prompt(te.tokenizer, prompt,
                                    tier.prefill_buckets, cfg.max_seq_len,
                                    tier.max_new_tokens)
            seq = torch.tensor([ids + w[:p]])
            with torch.no_grad():
                hidden, _ = T.prefill(cfg, model, seq,
                                      torch.arange(seq.shape[1])[None])
                logits = T.logits_from_hidden(model, hidden[0, -1])
            top2 = logits.topk(2)
            assert set(top2.indices.tolist()) == {w[p], g[p]}, (name, p)
            assert float(top2.values[0] - top2.values[1]) < 0.05, (name, p)


def _checkpoint_dir(tmp_path, preset: str, version: str) -> str:
    root = tmp_path / preset
    (root / version).mkdir(parents=True)
    os.symlink(version, root / "latest")
    return str(root)


def test_stale_or_missing_export_raises(tmp_path):
    cfg = torch_config.MODEL_PRESETS["nano_test"]
    stale = _checkpoint_dir(tmp_path, "nano_test", "v501")
    with pytest.raises(FileNotFoundError, match="export_checkpoints.py"):
        torch_ckpt.load_params_for_tier(stale, cfg)
    missing = _checkpoint_dir(tmp_path / "other", "nano_other", "v1")
    with pytest.raises(FileNotFoundError, match="no export"):
        torch_ckpt.load_params_for_tier(missing, cfg)
    with pytest.raises(FileNotFoundError, match="latest"):
        torch_ckpt.load_params_for_tier(str(tmp_path / "nowhere"), cfg)
    with pytest.raises(FileNotFoundError):
        torch_ckpt.load_params_for_tier(str(tmp_path / "gone.npz"), cfg)
    # An export's .npz loads directly; another preset's is refused.
    npz = os.path.join(torch_ckpt.WEIGHTS_DIR, "nano_test.npz")
    copy = tmp_path / "copy.npz"
    shutil.copy(npz, copy)
    direct = torch_ckpt.load_params_for_tier(str(copy), cfg)
    assert torch.equal(direct.embed, torch_ckpt.load_params_for_tier(
        torch_config.default_checkpoint("nano_test"), cfg).embed)
    with pytest.raises(ValueError, match="nano_test"):
        torch_ckpt.load_params_for_tier(
            str(copy), torch_config.MODEL_PRESETS["orin_test"])


def test_engines_refuse_a_missing_export(tmp_path):
    """A tier pointing at a checkpoint with no export fails to build: no
    engine serves random weights in its place."""
    from distributed_llm_tpu_torch.engine.batching import (
        ContinuousBatchingEngine)
    from distributed_llm_tpu_torch.engine.manager import EngineManager
    stale = _checkpoint_dir(tmp_path, "nano_test", "v501")
    tier = dataclasses.replace(torch_config.tiny_batched_cluster().nano,
                               checkpoint_path=stale)
    tier.check_ported()
    with pytest.raises(FileNotFoundError, match="v501"):
        ContinuousBatchingEngine(tier, device="cpu")
    manager = EngineManager(tier, device="cpu", warmup_on_start=False)
    with pytest.raises(FileNotFoundError, match="v501"):
        manager.start_server()
