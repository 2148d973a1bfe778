"""The encoder's data, training and evaluation (``routing/encoder_data.py``,
``encoder_train.py``, ``encoder_eval.py``) against the JAX package's.

- ``contrastive_pairs``, ``unrelated_pairs`` and ``init_encoder_params``
  give the JAX package's lists and arrays for a seed, and ``lr_at`` is
  ``optax.warmup_cosine_decay_schedule`` (the first update's rate 0.0).
- Five training steps at batch 8 from the JAX package's initial
  parameters: each step's loss within 1e-4 relative of JAX's, and the
  trained parameters within 1e-4.  Adam divides each gradient element by
  its own root mean square plus eps (1e-8), so an element whose
  gradients stay within a decade of eps (float32 rounding noise of a sum
  that cancels) moves by the noise's sign, in either package: such
  elements (bias-corrected second moment below (10 eps)^2 in JAX's
  optimizer state) are held only to the bound of their updates (lr per
  step) and must be rare (below 1e-4 of the parameters).
- ``train`` writes the JAX package's fp16 artifact (same keys, shapes and
  dtype) and evaluates it; ``evaluate`` and ``run_eval`` equal the JAX
  package's within 1e-5 on the committed weights, which no test writes.
"""

from __future__ import annotations

import hashlib

import jax
import numpy as np
import optax
import pytest

from distributed_llm_tpu.routing import encoder as jax_encoder
from distributed_llm_tpu.routing import encoder_data as jax_data
from distributed_llm_tpu.routing import encoder_eval as jax_eval
from distributed_llm_tpu.routing import encoder_train as jax_train
from distributed_llm_tpu_torch.routing import encoder, encoder_data
from distributed_llm_tpu_torch.routing import encoder_eval, encoder_train
from test_torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


STEPS, BATCH, LR, EPS = 5, 8, 3e-3, 1e-8


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.mark.parametrize("split,seed", [("train", 0), ("train", 7),
                                        ("heldout", 123)])
def test_contrastive_pairs_equal_jax(split, seed):
    assert encoder_data.contrastive_pairs(split, seed=seed) == \
        jax_data.contrastive_pairs(split, seed=seed)


def test_unrelated_pairs_and_init_equal_jax():
    assert encoder_data.unrelated_pairs(n=120, seed=123) == \
        jax_data.unrelated_pairs(n=120, seed=123)
    ours, theirs = (encoder.init_encoder_params(seed=5),
                    jax_encoder.init_encoder_params(seed=5))
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k])


@pytest.mark.parametrize("steps", [5, 600])
def test_lr_schedule_is_optax(steps):
    sched = optax.warmup_cosine_decay_schedule(
        0.0, LR, warmup_steps=max(steps // 10, 1), decay_steps=steps)
    for count in range(steps + 1):
        # optax evaluates the cosine in float32: a few float32 ulps.
        assert encoder_train.lr_at(count, LR, max(steps // 10, 1), steps) \
            == pytest.approx(float(sched(count)), rel=1e-5, abs=1e-9)
    assert encoder_train.lr_at(0, LR, max(steps // 10, 1), steps) == 0.0


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's ``train`` for STEPS steps, each jitted step's (params, state,
    loss) recorded."""
    out = str(tmp_path_factory.mktemp("jax") / "encoder.npz")
    real_jit, steps = jax.jit, []

    def recording_jit(fn, *a, **kw):
        jitted = real_jit(fn, *a, **kw)

        def run(*args):
            res = jitted(*args)
            if isinstance(res, tuple) and len(res) == 3:
                steps.append(res)
            return res
        return run

    jax.jit = recording_jit
    try:
        metrics = jax_train.train(out, steps=STEPS, batch_size=BATCH, lr=LR,
                                  log=lambda line: None)
    finally:
        jax.jit = real_jit
    assert len(steps) == STEPS
    return {"out": out, "metrics": metrics,
            "losses": [float(s[2]) for s in steps],
            "params": {k: np.asarray(v) for k, v in steps[-1][0].items()},
            "nu": {k: np.asarray(v) for k, v in steps[-1][1][0].nu.items()}}


def test_five_steps_equal_jax(jax_run):
    params, losses = encoder_train.fit(
        jax_encoder.init_encoder_params(seed=0),
        encoder_data.contrastive_pairs("train", seed=0), steps=STEPS,
        batch_size=BATCH, lr=LR, temperature=0.08, class_weight=0.3, seed=0,
        device="cpu", log=lambda line: None)
    np.testing.assert_allclose(losses, jax_run["losses"], rtol=1e-4)
    noisy = total = 0
    for k, want in jax_run["params"].items():
        got = params[k]
        assert got.shape == want.shape and got.dtype == np.float32
        nu_hat = jax_run["nu"][k] / (1.0 - 0.999 ** STEPS)
        clean = np.sqrt(nu_hat) >= 10 * EPS
        untouched = nu_hat == 0.0
        diff = np.abs(got - want)
        assert diff[clean].max(initial=0.0) <= 1e-4, k
        assert diff[untouched].max(initial=0.0) <= 1e-6, k
        assert diff.max() <= LR * STEPS, k
        noisy += int((~clean & ~untouched).sum())
        total += got.size
    assert noisy <= 1e-4 * total, (noisy, total)


def test_train_writes_jaxs_artifact_and_evaluates(jax_run, tmp_path):
    committed = _digest(encoder._DEFAULT_WEIGHTS)
    out = str(tmp_path / "encoder.npz")
    metrics = encoder_train.train(out, steps=2, batch_size=BATCH,
                                  device="cpu", log=lambda line: None)
    ours, theirs = np.load(out), np.load(jax_run["out"])
    assert sorted(ours.files) == sorted(theirs.files)
    for k in ours.files:
        assert ours[k].dtype == theirs[k].dtype == np.float16
        assert ours[k].shape == theirs[k].shape
    assert set(metrics) == set(jax_run["metrics"])
    assert _digest(encoder._DEFAULT_WEIGHTS) == committed


def test_evaluate_committed_weights_equals_jax():
    ours = encoder_train.evaluate(encoder._DEFAULT_WEIGHTS, device="cpu",
                                  log=lambda line: None)
    theirs = jax_train.evaluate(encoder._DEFAULT_WEIGHTS,
                                log=lambda line: None)
    assert set(ours) == set(theirs)
    for k in ours:
        assert ours[k] == pytest.approx(theirs[k], abs=1e-5), k


def test_run_eval_equals_jax():
    ours, theirs = encoder_eval.run_eval("cpu"), jax_eval.run_eval()
    assert ours["suite"] == theirs["suite"]
    assert set(ours) == set(theirs) == {"suite", "hashed", "encoder",
                                        "hybrid"}
    for name in ("hashed", "encoder", "hybrid"):
        assert set(ours[name]) == set(theirs[name])
        for k, v in theirs[name].items():
            assert ours[name][k] == pytest.approx(v, abs=1e-5), (name, k)
    assert encoder_eval._auc(np.array([1.0, 0.5]), np.array([0.5, 0.0])) \
        == jax_eval._auc(np.array([1.0, 0.5]), np.array([0.5, 0.0])) == 0.875
