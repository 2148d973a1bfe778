"""Pipeline parallelism of the port (``parallel/pipeline.py``,
``training/pipeline_trainer.py``) against the JAX package's, on repeated
CPU slots and JAX's virtual CPU devices, mirroring
``tests/test_pipeline.py``.

- ``split_stages``/``merge_stages`` round-trip (a stacked tensor, the
  port's per-layer list), and a stage count that does not
  divide the layers raises JAX's ``ValueError``.
- ``pipeline_apply``'s forward equals the sequential stack and JAX's
  ``pipeline_apply`` at 2 and 4 stages, and its gradients equal the
  stack's, within 1e-5.
- ``pipeline_lm_loss`` on a float32 ``nano_test`` equals JAX's within
  1e-5 relative and the port's plain ``lm_loss``.
- Three ``PipelineTrainer`` steps at pp=2 from JAX's ``PipelineTrainer``
  init equal its losses (1e-5 relative), pre-clip grad norms (1e-4) and
  parameters (``test_three_adamw_steps_match_jax``'s bounds); the export
  is a standard ``Transformer``; the trainer's config errors are JAX's.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from distributed_llm_tpu import config as jax_config
from distributed_llm_tpu.parallel import pipeline as jax_pipeline
from distributed_llm_tpu.training import pipeline_trainer as jax_pt
from distributed_llm_tpu.training import trainer as jax_trainer
from distributed_llm_tpu_torch import config as torch_config
from distributed_llm_tpu_torch.models.convert import params_from_jax
from distributed_llm_tpu_torch.models.transformer import Transformer
from distributed_llm_tpu_torch.parallel.mesh import DeviceGroup
from distributed_llm_tpu_torch.parallel.pipeline import (merge_stages,
                                                         pipeline_apply,
                                                         split_stages)
from distributed_llm_tpu_torch.training import trainer
from distributed_llm_tpu_torch.training.data import batches
from distributed_llm_tpu_torch.training.pipeline_trainer import (
    PipelineTrainer, pipeline_lm_loss)
from test_torch_training import (F32, LR, STEPS, _tree,  # noqa: F401
                                 assert_params_match, presets)


def _pp(n):
    return DeviceGroup(("cpu",) * n, ("pp",))


def _jax_pp(n):
    return Mesh(np.array(jax.devices()[:n]), ("pp",))


def _tanh_stage(ws, x, extras):
    for w in ws:
        x = torch.tanh(x @ w)
    return x


def _jax_tanh_stage(lp_stack, x, extras):
    def layer(x, w):
        return jnp.tanh(x @ w), None
    return jax.lax.scan(layer, x, lp_stack)[0]


def test_split_merge_roundtrip():
    w = torch.arange(24.0).reshape(8, 3)
    staged = split_stages(w, 4)
    assert staged.shape == (4, 2, 3)
    assert torch.equal(merge_stages(staged), w)
    layers = [object() for _ in range(6)]
    stages = split_stages(layers, 3)
    assert [len(s) for s in stages] == [2, 2, 2]
    assert merge_stages(stages) == layers
    for bad in (w, layers):
        with pytest.raises(ValueError, match="divisible"):
            split_stages(bad, 5)
    with pytest.raises(ValueError, match="divisible"):
        jax_pipeline.split_stages({"w": jnp.asarray(w.numpy())}, 5)


@pytest.mark.parametrize("stages", [2, 4])
def test_pipeline_forward_matches_sequential_and_jax(stages):
    rng = np.random.default_rng(0)
    ws = (rng.standard_normal((8, 16, 16)) * 0.3).astype(np.float32)
    mbs = rng.standard_normal((3, 4, 16)).astype(np.float32)   # M=3, mb=4
    ref = torch.from_numpy(mbs)
    for w in torch.from_numpy(ws):
        ref = torch.tanh(ref @ w)
    got = pipeline_apply(_pp(stages), _tanh_stage,
                         split_stages(torch.from_numpy(ws), stages),
                         torch.from_numpy(mbs))
    theirs = jax_pipeline.pipeline_apply(
        _jax_pp(stages), _jax_tanh_stage,
        jax_pipeline.split_stages({"": jnp.asarray(ws)}, stages)[""],
        jnp.asarray(mbs))
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(theirs), atol=1e-5,
                               rtol=1e-5)


def test_pipeline_gradients_match_sequential():
    rng = np.random.default_rng(2)
    ws = torch.from_numpy((rng.standard_normal((4, 8, 8)) * 0.3).astype(
        np.float32))
    mbs = torch.from_numpy(rng.standard_normal((2, 4, 8)).astype(np.float32))
    w_pipe = ws.clone().requires_grad_(True)
    out = pipeline_apply(_pp(4), _tanh_stage, split_stages(w_pipe, 4), mbs)
    torch.sum(out ** 2).backward()
    w_seq = ws.clone().requires_grad_(True)
    x = mbs
    for i in range(4):
        x = torch.tanh(x @ w_seq[i])
    torch.sum(x ** 2).backward()
    torch.testing.assert_close(w_pipe.grad, w_seq.grad, atol=1e-5, rtol=1e-5)


def _staged(model, stages):
    return {"embed": model.embed,
            "layers": split_stages(list(model.layers), stages),
            "final_ln": model.final_ln}


def test_pipeline_lm_loss_matches_jax(presets):
    name = F32["nano_test"]
    cfg = torch_config.MODEL_PRESETS[name]
    tree = _tree(name, seed=5)
    tokens, mask = next(batches(4, 32, seed=0))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    want = jax_pt.pipeline_lm_loss(
        jax_config.MODEL_PRESETS[name],
        {**jparams, "layers": jax_pipeline.split_stages(jparams["layers"], 2)},
        jnp.asarray(tokens), jnp.asarray(mask), _jax_pp(2),
        num_microbatches=2)
    model = params_from_jax(cfg, tree)
    args = (torch.from_numpy(tokens).long(), torch.from_numpy(mask))
    with torch.no_grad():
        got = pipeline_lm_loss(cfg, _staged(model, 2), *args, _pp(2), 2)
        dense = trainer.lm_loss(cfg, model, *args, remat=False)
    assert float(got) == pytest.approx(float(want), rel=1e-5)
    assert float(got) == pytest.approx(float(dense), rel=1e-5)


def test_pipeline_trainer_three_steps_match_jax(presets):
    name = F32["nano_test"]
    kw = dict(batch_size=4, seq_len=32, learning_rate=LR, warmup_steps=1,
              decay_steps=10, max_grad_norm=0.5)
    jt = jax_pt.PipelineTrainer(jax_config.MODEL_PRESETS[name],
                                jax_trainer.TrainConfig(**kw), _jax_pp(2),
                                num_microbatches=2)
    tree = jax.tree_util.tree_map(np.asarray, jt.export_params())
    cfg = torch_config.MODEL_PRESETS[name]
    tr = PipelineTrainer(cfg, trainer.TrainConfig(**kw), _pp(2),
                         num_microbatches=2, params=params_from_jax(cfg, tree))
    assert tr.stages == 2 and [len(s) for s in tr.params["layers"]] == [1, 1]
    stream = batches(4, 32, seed=1)
    for _ in range(STEPS):
        tokens, mask = next(stream)
        want = jt.train_step(tokens, mask)
        got = tr.train_step(tokens, mask)
        assert np.isfinite(got["loss"])
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
        assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-4)
    exported = tr.export_params()
    assert isinstance(exported, Transformer)
    assert len(exported.layers) == cfg.num_layers
    assert not any(p.requires_grad for p in exported.parameters())
    jparams = jax.tree_util.tree_map(np.asarray, jt.export_params())
    nu = jt.opt_state[1][0].nu
    jnu = jax.tree_util.tree_map(np.asarray, {
        **nu, "layers": jax_pipeline.merge_stages(nu["layers"])})
    assert_params_match(exported, jparams, jnu,
                        sum(trainer.lr_at(tr.tc, i) for i in range(STEPS)))


def test_pipeline_trainer_validates_config_like_jax():
    cfg = torch_config.MODEL_PRESETS["nano_test"]
    jcfg = jax_config.MODEL_PRESETS["nano_test"]
    tc = trainer.TrainConfig(batch_size=4, seq_len=32)
    for ours, theirs in (
            (lambda: PipelineTrainer(cfg, tc, DeviceGroup(("cpu",) * 2,
                                                         ("dp",))),
             lambda: jax_pt.PipelineTrainer(
                 jcfg, jax_trainer.TrainConfig(batch_size=4, seq_len=32),
                 Mesh(np.array(jax.devices()[:2]), ("dp",)))),
            (lambda: PipelineTrainer(cfg, trainer.TrainConfig(
                batch_size=5, seq_len=32), _pp(2), num_microbatches=2),
             lambda: jax_pt.PipelineTrainer(
                 jcfg, jax_trainer.TrainConfig(batch_size=5, seq_len=32),
                 _jax_pp(2), num_microbatches=2)),
            (lambda: PipelineTrainer(cfg, tc, _pp(4), num_microbatches=4),
             lambda: jax_pt.PipelineTrainer(
                 jcfg, jax_trainer.TrainConfig(batch_size=4, seq_len=32),
                 _jax_pp(4), num_microbatches=4))):
        with pytest.raises(ValueError) as want:
            theirs()
        with pytest.raises(ValueError) as got:
            ours()
        assert str(got.value) == str(want.value)
    # The default microbatch count: max(2, stages).
    assert PipelineTrainer(cfg, tc, _pp(2)).num_microbatches == 2
