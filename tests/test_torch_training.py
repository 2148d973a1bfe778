"""Training of the port (``training/``, ``ops/flash_attention.FlashCausal``)
against the JAX package's.

- ``ByteTokenizer`` and the data pipeline: ``synthetic_text``,
  ``chat_text``, ``batches`` (byte and BPE tokenizers, several steps),
  ``pack_documents`` and ``corpus_batches`` are byte-identical to JAX's
  for the same seed, and ``bpe_corpus`` equals JAX's list.
- ``lr_at`` equals ``optax.warmup_cosine_decay_schedule(0, lr, warmup,
  horizon, 0.1 lr)`` at every step past the horizon, within 1e-7 (optax
  evaluates in float32).
- ``lm_loss`` on float32 copies of ``nano_test`` and ``moe_test`` (aux
  term included), with and without remat: within 1e-5 relative of JAX's,
  and every parameter's gradient within 1e-4 of JAX's (relative to the
  leaf's largest); ``FlashCausal``'s backward (the kernel's launch
  replaced by the plain forward, as on the CPU there is no kernel) gives
  autograd's gradients of the plain causal attention.
- Three ``Trainer`` steps from the same weights and batches as the JAX
  ``Trainer`` on a one-device CPU mesh: losses within 1e-5 relative,
  pre-clip grad norms within 1e-4 relative, and the parameters within
  ``tests/test_torch_encoder_train.py``'s bounds: elements whose Adam
  second moment clears float32 gradient noise within 1e-4, untouched
  ones (decay only) within 1e-6, every element within the updates' bound
  (lr per step), the noisy ones rare.  The clip fires in these steps.
- ``eval_quality`` on the committed ``weights/nano_test.npz`` and
  ``orin_test.npz`` (float32 copies, fed to JAX as a params tree):
  ``eval_loss`` within 1e-4 of JAX's.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_llm_tpu import config as jax_config
from distributed_llm_tpu.engine import tokenizer as jax_tok
from distributed_llm_tpu.training import data as jax_data
from distributed_llm_tpu.training import evaluate as jax_eval
from distributed_llm_tpu.training import trainer as jax_trainer
from distributed_llm_tpu_torch import config as torch_config
from distributed_llm_tpu_torch.engine import tokenizer as torch_tok
from distributed_llm_tpu_torch.engine.bpe import load_default
from distributed_llm_tpu_torch.models.checkpoint import load_export
from distributed_llm_tpu_torch.models.convert import params_from_jax
from distributed_llm_tpu_torch.ops import attention as TA
from distributed_llm_tpu_torch.ops import flash_attention as TF
from distributed_llm_tpu_torch.training import data, evaluate, trainer
from test_torch_moe import _moe_tree

F32 = {"nano_test": "nano_test_train_f32", "moe_test": "moe_test_train_f32",
       "orin_test": "orin_test_train_f32"}
STEPS, LR, EPS = 3, 1e-3, 1e-8


@pytest.fixture(scope="module")
def presets():
    with pytest.MonkeyPatch.context() as mp:
        for base, name in F32.items():
            for cfgmod in (jax_config, torch_config):
                mp.setitem(cfgmod.MODEL_PRESETS, name, dataclasses.replace(
                    cfgmod.MODEL_PRESETS[base], name=name, dtype="float32"))
        yield


def _tree(name, seed=0):
    """A numpy tree at JAX's init scale for the float32 preset ``name``."""
    from distributed_llm_tpu.models import init_params
    return jax.tree_util.tree_map(
        np.asarray, init_params(jax_config.MODEL_PRESETS[name], seed))


def _leaves(model):
    """port parameter name -> (JAX tree path, layer index or None)."""
    out = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        out[name] = ((parts[0], None) if len(parts) == 1
                     else (parts[2], int(parts[1])))
    return out


def _jax_leaf(tree, key, layer):
    return tree[key] if layer is None else tree["layers"][key][layer]


# -- tokenizer and data ------------------------------------------------------------

def test_byte_tokenizer_equals_jax():
    text = "user: héllo — 世界\nassistant: ok"
    ours, theirs = torch_tok.ByteTokenizer(), jax_tok.ByteTokenizer()
    assert ours.encode(text) == theirs.encode(text)
    assert ours.encode(text, add_bos=False) == theirs.encode(text,
                                                             add_bos=False)
    ids = ours.encode(text) + [ours.eos_id, ours.pad_id]
    assert ours.decode(ids) == theirs.decode(ids)
    history = [{"role": "user", "content": "hi"}]
    assert ours.encode_history(history) == theirs.encode_history(history)
    byte_cfg = dataclasses.replace(torch_config.MODEL_PRESETS["nano_test"],
                                   tokenizer="byte", vocab_size=512)
    assert isinstance(torch_tok.get_tokenizer(byte_cfg),
                      torch_tok.ByteTokenizer)


@pytest.mark.parametrize("seed", [0, 5])
def test_text_generators_equal_jax(seed):
    for fn in ("synthetic_text", "chat_text"):
        ours = [getattr(data, fn)(np.random.default_rng(seed))
                for _ in range(3)]
        theirs = [getattr(jax_data, fn)(np.random.default_rng(seed))
                  for _ in range(3)]
        assert ours == theirs


@pytest.mark.parametrize("tokenizer", ["byte", "bpe"])
@pytest.mark.parametrize("seed,batch,seq", [(0, 4, 64), (3, 3, 128)])
def test_batches_byte_identical_to_jax(tokenizer, seed, batch, seq):
    tok_ours = torch_tok.ByteTokenizer() if tokenizer == "byte" else (
        load_default())
    tok_theirs = jax_tok.ByteTokenizer() if tokenizer == "byte" else None
    if tok_theirs is None:
        from distributed_llm_tpu.engine.bpe import load_default as jax_bpe
        tok_theirs = jax_bpe()
    ours = data.batches(batch, seq, seed=seed, tokenizer=tok_ours)
    theirs = jax_data.batches(batch, seq, seed=seed, tokenizer=tok_theirs)
    for _ in range(3):
        (ot, om), (tt, tm) = next(ours), next(theirs)
        assert ot.dtype == tt.dtype and om.dtype == tm.dtype
        assert ot.tobytes() == tt.tobytes() and om.tobytes() == tm.tobytes()


def test_packing_and_corpus_batches_equal_jax(tmp_path):
    rng = np.random.default_rng(1)
    docs = [data.chat_text(rng) for _ in range(12)]
    assert (data.pack_documents(docs, 32).tobytes()
            == jax_data.pack_documents(docs, 32).tobytes())
    path = tmp_path / "corpus.txt"
    path.write_text("\n\n".join(docs))
    ours = data.corpus_batches([str(path)], 4, 32, seed=2)
    theirs = jax_data.corpus_batches([str(path)], 4, 32, seed=2)
    for _ in range(6):
        (ot, om), (tt, tm) = next(ours), next(theirs)
        assert ot.tobytes() == tt.tobytes() and om.tobytes() == tm.tobytes()
    with pytest.raises(ValueError):
        data.pack_documents(["a"], 4096)


def test_bpe_corpus_equals_jax():
    assert (data.bpe_corpus(n_synthetic=20, n_chat=30, seed=4)
            == jax_data.bpe_corpus(n_synthetic=20, n_chat=30, seed=4))


# -- the schedule ------------------------------------------------------------------

@pytest.mark.parametrize("warmup,decay", [(100, None), (5, 40), (50, 2000)])
def test_schedule_equals_optax(warmup, decay):
    tc = trainer.TrainConfig(learning_rate=3e-4, warmup_steps=warmup,
                             decay_steps=decay)
    jtc = jax_trainer.TrainConfig(learning_rate=3e-4, warmup_steps=warmup,
                                  decay_steps=decay)
    horizon = trainer.schedule_horizon(tc)
    assert horizon == jax_trainer.schedule_horizon(jtc)
    sched = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=3e-4, warmup_steps=warmup,
        decay_steps=horizon, end_value=3e-5)
    steps = np.arange(horizon + 50)
    want = np.asarray(jax.vmap(sched)(jnp.asarray(steps)), np.float64)
    got = np.asarray([trainer.lr_at(tc, int(i)) for i in steps])
    # optax evaluates in float32, a few parts in 1e6 of the rate here.
    assert np.abs(got - want).max() <= 1e-7
    assert got[0] == 0.0 and got[-1] == pytest.approx(3e-5)


# -- loss and gradients ------------------------------------------------------------

def _batch(cfg, batch=2, seq=32, seed=9):
    tok = load_default()
    return next(data.batches(batch, seq, seed=seed, tokenizer=tok))


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("base", ["nano_test", "moe_test"])
def test_lm_loss_and_gradients_match_jax(presets, base, remat):
    name = F32[base]
    jcfg = jax_config.MODEL_PRESETS[name]
    cfg = torch_config.MODEL_PRESETS[name]
    tree = (_moe_tree(cfg, seed=2, scale=0.05) if base == "moe_test"
            else _tree(name, seed=2))
    toks, mask = _batch(cfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jax_trainer.lm_loss(jcfg, p, jnp.asarray(toks),
                                      jnp.asarray(mask), remat=remat)
    )(jparams)
    model = params_from_jax(cfg, tree).requires_grad_(True)
    loss = trainer.lm_loss(cfg, model, torch.from_numpy(toks).long(),
                           torch.from_numpy(mask), remat=remat)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    for pname, (key, layer) in _leaves(model).items():
        got = dict(model.named_parameters())[pname].grad.numpy()
        want = np.asarray(_jax_leaf(jgrads, key, layer))
        scale = max(float(np.abs(want).max()), 1e-12)
        assert np.abs(got - want).max() <= 1e-4 * scale, pname


def test_moe_loss_carries_the_aux_term(presets):
    cfg = torch_config.MODEL_PRESETS[F32["moe_test"]]
    model = params_from_jax(cfg, _moe_tree(cfg, scale=0.05))
    toks, mask = _batch(cfg)
    args = (model, torch.from_numpy(toks).long(), torch.from_numpy(mask))
    with torch.no_grad():
        base = trainer.lm_loss(dataclasses.replace(cfg, moe_aux_weight=0.0),
                               *args)
        full = trainer.lm_loss(cfg, *args)
    positions = torch.arange(toks.shape[1])[None].expand(*toks.shape)
    from distributed_llm_tpu_torch.models import moe
    aux = moe.prefill(cfg, model, args[1], positions)[2]
    assert float(aux) > 0
    assert float(full - base) == pytest.approx(0.01 * float(aux), rel=1e-4)


def test_flash_causal_function_backward_is_plain_autograd(monkeypatch):
    """The Function's structure on the CPU: its forward's launch stood in
    for by the plain version, its backward recomputed in float32 from the
    saved inputs: at float32 the gradients of autograd through the plain
    attention, at bf16 those of float32 autograd rounded once."""
    monkeypatch.setattr(TF, "_flash_causal_launch", TA.causal_attention)
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 24, 4, 16), (2, 24, 2, 16), (2, 24, 2, 16)))
    g = torch.from_numpy(rng.standard_normal((2, 24, 4, 16)).astype(
        np.float32))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = TF.FlashCausal.apply(*leaves)
    out.backward(g)
    ref = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref_out = TA.causal_attention(*ref)
    ref_out.backward(g)
    assert torch.equal(out, ref_out)
    for a, b in zip(leaves, ref):
        torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=0)
    bf = [t.to(torch.bfloat16).requires_grad_(True) for t in (q, k, v)]
    TF.FlashCausal.apply(*bf).backward(g.to(torch.bfloat16))
    wide = [t.to(torch.bfloat16).float().requires_grad_(True)
            for t in (q, k, v)]
    TA.causal_attention(*wide).backward(g.to(torch.bfloat16).float())
    for a, b in zip(bf, wide):
        assert a.grad.dtype == torch.bfloat16
        assert torch.equal(a.grad, b.grad.to(torch.bfloat16))
    # On the CPU the wrapper is the plain version, differentiable itself.
    assert TF.flash_causal_attention(q, k, v).equal(TA.causal_attention(q, k, v))


# -- three steps of the trainer ----------------------------------------------------

def _jax_steps(name, tree, batches, tc):
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("dp",))
    jt = jax_trainer.Trainer(jax_config.MODEL_PRESETS[name], tc, mesh,
                             params=jax.tree_util.tree_map(jnp.asarray, tree))
    metrics = [jt.train_step(t, m) for t, m in batches]
    nu = jt.opt_state[1][0].nu
    return metrics, jax.tree_util.tree_map(np.asarray, jt.params), \
        jax.tree_util.tree_map(np.asarray, nu)


@pytest.mark.parametrize("base", ["nano_test", "moe_test"])
def test_three_adamw_steps_match_jax(presets, base):
    name = F32[base]
    cfg = torch_config.MODEL_PRESETS[name]
    tree = (_moe_tree(cfg, seed=3, scale=0.05) if base == "moe_test"
            else _tree(name, seed=3))
    kw = dict(batch_size=2, seq_len=32, learning_rate=LR, warmup_steps=1,
              decay_steps=10, max_grad_norm=0.5)
    stream = data.batches(2, 32, seed=11, tokenizer=load_default())
    batches = [next(stream) for _ in range(STEPS)]
    want, jparams, jnu = _jax_steps(name, tree, batches,
                                    jax_trainer.TrainConfig(**kw))
    tr = trainer.Trainer(cfg, trainer.TrainConfig(**kw), device="cpu",
                         params=params_from_jax(cfg, tree))
    got = [tr.train_step(t, m) for t, m in batches]
    assert tr.step_count == STEPS
    for g, w in zip(got, want):
        assert g["loss"] == pytest.approx(w["loss"], rel=1e-5)
        assert g["grad_norm"] == pytest.approx(w["grad_norm"], rel=1e-4)
    assert max(w["grad_norm"] for w in want) > 0.5      # the clip fired
    assert_params_match(tr.model, jparams, jnu,
                        sum(trainer.lr_at(tr.tc, i) for i in range(STEPS)))


def assert_params_match(model, jparams, jnu, rates, steps=STEPS):
    """The port's parameters after ``steps`` AdamW steps against JAX's
    (``jparams``, second moments ``jnu``): elements whose Adam second
    moment clears float32 gradient noise within 1e-4, untouched ones
    within 1e-6, every one within the updates' bound ``rates`` (the
    summed rates), the noisy ones rare."""
    noisy = total = 0
    params = dict(model.named_parameters())
    for pname, (key, layer) in _leaves(model).items():
        got_p = params[pname].detach().cpu().numpy()
        want_p = _jax_leaf(jparams, key, layer)
        nu_hat = _jax_leaf(jnu, key, layer) / (1.0 - 0.999 ** steps)
        clean = np.sqrt(nu_hat) >= 10 * EPS
        untouched = nu_hat == 0.0
        diff = np.abs(got_p - want_p)
        assert diff[clean].max(initial=0.0) <= 1e-4, pname
        assert diff[untouched].max(initial=0.0) <= 1e-6, pname
        assert diff.max() <= rates * 1.01, pname
        noisy += int((~clean & ~untouched).sum())
        total += got_p.size
    assert noisy <= 1e-4 * total, (noisy, total)


def test_extend_schedule_keeps_the_count(presets):
    cfg = torch_config.MODEL_PRESETS[F32["nano_test"]]
    tr = trainer.Trainer(cfg, trainer.TrainConfig(warmup_steps=2,
                                                  decay_steps=20),
                         device="cpu")
    assert not tr.extend_schedule(20)
    assert tr.extend_schedule(500)
    assert trainer.schedule_horizon(tr.tc) == 500 and tr.step_count == 0


# -- evaluation ---------------------------------------------------------------------

@pytest.mark.parametrize("base", ["nano_test", "orin_test"])
def test_eval_quality_on_committed_weights_matches_jax(presets, base):
    name = F32[base]
    tree = load_export(f"distributed_llm_tpu_torch/weights/{base}.npz")
    params = {k: tree[k] for k in ("embed", "final_ln", "layers")}
    cfg = torch_config.MODEL_PRESETS[name]
    kw = dict(n_batches=2, batch_size=4, seq_len=64)
    ours = evaluate.eval_quality(cfg, params_from_jax(cfg, params), **kw)
    theirs = jax_eval.eval_quality(
        jax_config.MODEL_PRESETS[name],
        jax.tree_util.tree_map(jnp.asarray, params), **kw)
    assert set(ours) == set(theirs)
    assert ours["eval_loss"] == pytest.approx(theirs["eval_loss"], abs=1e-4)
    assert ours["next_token_acc"] == pytest.approx(theirs["next_token_acc"],
                                                   abs=1e-4)
    assert ours["n_tokens"] == theirs["n_tokens"]
    assert ours["eval_loss"] < 5.0          # trained, not random (ln 4096)
