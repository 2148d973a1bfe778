"""The port's versioned checkpoints (``utils/checkpoint.py``) and
pretraining (``training/pretrain.py``), mirroring the JAX package's
``tests/test_checkpoint.py`` and ``tests/test_pretrain.py``.

- A save/load round trip restores weights, AdamW state and the step
  count, and the resumed trainer steps as the original does.
- Saves publish ``v<step>`` with an atomic ``latest`` link and keep the
  newest two; a stale same-step version is replaced whole; a save of the
  step that already is ``latest`` leaves it untouched and returns None.
- ``peek_vocab_size`` reads ``meta.json`` only; a root the trainer wrote
  serves through ``TierConfig.checkpoint_path`` in the sequential and the
  batched engine (dense and MoE), the committed JAX exports still serve
  as before, and ``eval_checkpoint`` scores the root.
- ``pretrain``: plateau, ``save_every``, ``resume`` (``max_steps``
  counting additional steps, the data seed offset), the horizon
  stretched on resume, and the ``main`` flags.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from distributed_llm_tpu_torch import config as torch_config
from distributed_llm_tpu_torch.engine.batching import ContinuousBatchingEngine
from distributed_llm_tpu_torch.engine.manager import EngineManager
from distributed_llm_tpu_torch.models.checkpoint import load_params_for_tier
from distributed_llm_tpu_torch.training import evaluate, pretrain
from distributed_llm_tpu_torch.training.data import batches
from distributed_llm_tpu_torch.training.trainer import TrainConfig, Trainer
from distributed_llm_tpu_torch.utils import checkpoint as ckpt
from test_torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


PRESETS = torch_config.MODEL_PRESETS


def _trainer(seed, preset="nano_test"):
    return Trainer(PRESETS[preset], TrainConfig(batch_size=4, seq_len=32,
                                                warmup_steps=2, seed=seed),
                   device="cpu")


def _batch(seed=0):
    from distributed_llm_tpu_torch.engine.bpe import load_default
    return next(batches(4, 32, seed=seed, tokenizer=load_default()))


def _state_equal(a, b) -> bool:
    return all(torch.equal(x, b[k]) for k, x in a.items())


def _opt_equal(t1, t2) -> bool:
    s1, s2 = t1.optimizer.state_dict(), t2.optimizer.state_dict()
    for i, st in s1["state"].items():
        for k, v in st.items():
            if not torch.equal(torch.as_tensor(v), torch.as_tensor(
                    s2["state"][i][k])):
                return False
    return True


@pytest.mark.parametrize("preset", ["nano_test", "moe_test"])
def test_trainer_save_load_roundtrip(tmp_path, preset):
    t1 = _trainer(1, preset)
    tokens, mask = _batch()
    for _ in range(2):
        t1.train_step(tokens, mask)
    path = t1.save(str(tmp_path / "ckpt"))
    t2 = _trainer(99, preset)
    assert not _state_equal(t1.model.state_dict(), t2.model.state_dict())
    t2.load(path)
    assert t2.step_count == 2
    assert _state_equal(t1.model.state_dict(), t2.model.state_dict())
    assert _opt_equal(t1, t2)
    m1, m2 = t1.train_step(tokens, mask), t2.train_step(tokens, mask)
    assert m1["loss"] == pytest.approx(m2["loss"], rel=1e-5)
    assert _state_equal(t1.model.state_dict(), t2.model.state_dict())


def test_versioned_saves_keep_latest_and_prune(tmp_path):
    t = _trainer(6)
    tokens, mask = _batch(3)
    root = str(tmp_path / "ckpt")
    for _ in range(3):
        t.train_step(tokens, mask)
        assert t.save(root) == os.path.abspath(root)
    versions = sorted(d for d in os.listdir(root) if d.startswith("v"))
    assert versions == ["v2", "v3"]
    assert os.path.islink(os.path.join(root, "latest"))
    assert os.path.realpath(os.path.join(root, "latest")).endswith("v3")
    assert not [d for d in os.listdir(root) if d.endswith(".tmp")]
    t2 = _trainer(7)
    t2.load(root)
    assert t2.step_count == 3
    with open(os.path.join(root, "v3", "meta.json")) as f:
        meta = json.load(f)
    assert meta["format"] == ckpt.FORMAT and meta["step"] == 3
    assert meta["preset"] == "nano_test"


def test_save_replaces_stale_same_step_version(tmp_path):
    t = _trainer(11)
    tokens, mask = _batch(4)
    root = str(tmp_path / "ckpt")
    t.train_step(tokens, mask)
    t.save(root)                                     # publishes v1
    t.train_step(tokens, mask)
    stale = os.path.join(root, "v2")
    os.makedirs(stale)
    with open(os.path.join(stale, "junk"), "w") as f:
        f.write("stale")
    t.save(root)                                     # replaces v2 whole
    assert os.path.realpath(os.path.join(root, "latest")).endswith("v2")
    assert not os.path.exists(os.path.join(stale, "junk"))
    t2 = _trainer(12)
    t2.load(root)
    assert t2.step_count == 2
    # Same-step republish of the live version: skipped, untouched.
    before = os.stat(os.path.join(stale, "params.pt")).st_mtime_ns
    assert t.save(root) is None
    assert os.stat(os.path.join(stale, "params.pt")).st_mtime_ns == before
    t3 = _trainer(13)
    t3.load(root)
    assert t3.step_count == 2


def test_load_without_latest_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        _trainer(0).load(str(tmp_path))
    assert not ckpt.is_port_checkpoint(str(tmp_path))


def test_peek_vocab_size_reads_metadata_only(tmp_path):
    t = _trainer(2)
    root = str(tmp_path / "ckpt")
    t.save(root)
    os.remove(os.path.join(root, "latest", "params.pt"))
    assert ckpt.peek_vocab_size(root) == PRESETS["nano_test"].vocab_size
    assert ckpt.peek_vocab_size(str(tmp_path / "missing")) is None


@pytest.mark.parametrize("preset", ["nano_test", "moe_test"])
def test_train_then_serve_from_checkpoint(tmp_path, preset):
    t = _trainer(5, preset)
    tokens, mask = _batch(2)
    t.train_step(tokens, mask)
    path = t.save(str(tmp_path / "weights"))
    model = load_params_for_tier(path, PRESETS[preset])
    assert not any(p.requires_grad for p in model.parameters())
    assert _state_equal(t.model.state_dict(), model.state_dict())
    seq = torch_config.TierConfig(name="nano", model_preset=preset,
                                  max_new_tokens=6, prefill_buckets=(16, 32),
                                  checkpoint_path=path)
    mgr = EngineManager(seq, warmup_on_start=False, device="cpu")
    try:
        engine = mgr.engine()
        assert _state_equal(engine.model.state_dict(), model.state_dict())
        r = engine.generate("user: hello", max_new_tokens=4)
        assert r.gen_tokens >= 0 and isinstance(r.text, str)
    finally:
        mgr.stop_server()
    batched = torch_config.TierConfig(
        name="nano", model_preset=preset, decode_batch=2, max_new_tokens=6,
        prefill_buckets=(16, 32), kv_block_size=16, checkpoint_path=path)
    engine = ContinuousBatchingEngine(batched, device="cpu")
    try:
        assert _state_equal(engine.model.state_dict(), model.state_dict())
        assert engine.generate("user: hello").gen_tokens >= 0
    finally:
        engine.stop()
    out = evaluate.eval_checkpoint(preset, path, device="cpu", n_batches=1,
                                   batch_size=2, seq_len=32)
    assert np.isfinite(out["eval_loss"]) and out["n_tokens"] == 2 * 31


def test_committed_jax_exports_still_serve():
    root = torch_config.default_checkpoint("nano_test")
    assert root is not None and not ckpt.is_port_checkpoint(root)
    model = load_params_for_tier(root, PRESETS["nano_test"])
    assert model.embed.shape == (PRESETS["nano_test"].vocab_size, 64)


# -- pretrain --------------------------------------------------------------------

def test_pretrain_plateaus_and_publishes(tmp_path):
    out = tmp_path / "ck"
    res = pretrain.pretrain("nano_test", str(out), batch_size=2, seq_len=16,
                            max_steps=30, eval_every=4, patience=2,
                            min_delta=10.0, device="cpu",
                            log=lambda *_: None)
    assert res["steps"] == 12          # windows at 4 (best), 8, 12 (stale)
    assert len(res["losses"]) == res["steps"]
    assert (out / "latest").is_symlink()
    model = load_params_for_tier(str(out), PRESETS["nano_test"])
    assert model.embed.shape[0] == PRESETS["nano_test"].vocab_size


def test_pretrain_save_every_leaves_resumable_latest(tmp_path):
    out = tmp_path / "ck"
    pretrain.pretrain("nano_test", str(out), batch_size=2, seq_len=16,
                      max_steps=10, eval_every=50, save_every=5,
                      device="cpu", log=lambda *_: None)
    versions = sorted(d.name for d in out.iterdir() if d.name.startswith("v"))
    assert versions == ["v10", "v5"], versions
    tr = _trainer(0)
    tr.load(str(out))
    assert tr.step_count == 10


def test_pretrain_resume_continues_from_checkpoint(tmp_path, monkeypatch):
    out = tmp_path / "ck"
    pretrain.pretrain("nano_test", str(out), batch_size=2, seq_len=16,
                      max_steps=8, eval_every=50, device="cpu",
                      log=lambda *_: None)
    seeds = []
    real = pretrain.batches
    monkeypatch.setattr(pretrain, "batches", lambda *a, seed, **k: (
        seeds.append(seed), real(*a, seed=seed, **k))[1])
    res = pretrain.pretrain("nano_test", str(out), batch_size=2, seq_len=16,
                            max_steps=5, eval_every=50, resume=True,
                            seed=3, device="cpu", log=lambda *_: None)
    assert res["steps"] == 13
    assert seeds == [3 + 8]


def test_resume_extends_lr_schedule_past_horizon(tmp_path):
    out = tmp_path / "ck"
    pretrain.pretrain("nano_test", str(out), batch_size=2, seq_len=16,
                      max_steps=6, eval_every=50, device="cpu",
                      log=lambda *_: None)
    logs = []
    # max_steps=1200 drives the horizon (6 + 1200 > 1000); the unmeetable
    # min_delta ends the run at its second window.
    pretrain.pretrain("nano_test", str(out), batch_size=2, seq_len=16,
                      max_steps=1200, eval_every=2, patience=1,
                      min_delta=1000.0, resume=True, device="cpu",
                      log=logs.append)
    assert any("extended LR schedule to 1206" in line for line in logs)


def test_resume_without_checkpoint_trains_from_scratch(tmp_path):
    logs = []
    res = pretrain.pretrain("nano_test", str(tmp_path / "none"),
                            batch_size=2, seq_len=16, max_steps=2,
                            resume=True, device="cpu", log=logs.append)
    assert res["steps"] == 2 and "WARNING" in logs[0]


def test_main_flags(tmp_path, capsys):
    out = str(tmp_path / "ck")
    pretrain.main(["--preset", "nano_test", "--out", out, "--batch-size",
                   "2", "--seq-len", "16", "--max-steps", "3",
                   "--eval-every", "50", "--device", "cpu"])
    assert ckpt.is_port_checkpoint(out)
    evaluate.main(["--preset", "nano_test", "--checkpoint", out,
                   "--batches", "1", "--batch-size", "2", "--seq-len", "16",
                   "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    got = json.loads(line)
    assert got["preset"] == "nano_test" and got["n_tokens"] == 2 * 15
