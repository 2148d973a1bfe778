"""int8 weight-only serving of the port (``ops/quant.py``) against the
JAX package's ``ops/quant.py``.

- ``quantize_tensor`` is bit-identical to JAX's for ``q`` and ``s``: a
  projection (per-output-channel scales) and the embedding (per-row
  scales), in bfloat16 and float32, with an all-zero column (the 1e-8
  floor) and exact .5 ties (round half to even).  Under ``jax.jit`` (the
  JAX engines' ``maybe_quantize``) XLA turns the division by 127 into a
  product with its float32 reciprocal, which moves a float32 scale by one
  ulp in some channels: there ``q`` is equal and ``s`` within one ulp;
  bfloat16 scales are equal.
- ``matmul``, ``embed_rows`` and ``tied_head`` against JAX's on the same
  quantized weights: float32 within 1e-6 (rtol and atol: the same
  products summed in another order), bfloat16 within 2e-2 at outputs of
  order 1 (two bf16 steps: both round the product and then the scaled
  value, and the sums run in another order).
- ``maybe_quantize``: "none" leaves the model alone, "int8" quantizes in
  place and again changes nothing, any other mode raises.
- ``params_from_jax`` takes a JAX ``quantize_params`` tree and gives the
  port's own quantization of the same bf16 tree, value for value.
- ``prefill``, ``chunk_prefill`` and ``decode_step`` logits with int8
  weights against JAX at float32 (atol 1e-4), on nano_test and
  orin_test; the budget's weight bytes are the quantized model's.
- Greedy tokens with ``quantize="int8"`` identical to the JAX engines' on
  the tiny presets (float32 copies): the batched engine, the batched
  engine with a draft (itself and ``draft_test``), ``InferenceEngine``
  and ``SpeculativeEngine``.
- W1's arithmetic (``w8_split_mirror``: the plan's tiles, chunks of
  64-row k-tiles, each chunk's float32 partial from zero, a split tile's
  partials summed in chunk order, then the bf16 rounding and the scale)
  against the plain version and JAX at decode and wide shapes; the plan
  at every served shape (chunks covering K, the grid, the blocks' equal
  contiguous shares), a grouped plan cutting each weight as its lone one
  does; ``matmul_many`` bit for bit the lone products; the route rule
  (W1's decode regime for at most 64 rows on the card, its wide regime
  above, the plain version on the CPU) and the wrapper's refusals.
"""

from __future__ import annotations

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_tpu import config as jax_config
from distributed_llm_tpu.engine.batching import (
    ContinuousBatchingEngine as JaxBatched)
from distributed_llm_tpu.engine.inference import InferenceEngine as JaxSeq
from distributed_llm_tpu.engine.speculative import SpeculativeEngine as JaxSpec
from distributed_llm_tpu.models import transformer as JT
from distributed_llm_tpu.ops import quant as JQ
from distributed_llm_tpu_torch import config as torch_config
from distributed_llm_tpu_torch.engine.batching import (
    ContinuousBatchingEngine as TorchBatched)
from distributed_llm_tpu_torch.engine.inference import InferenceEngine
from distributed_llm_tpu_torch.engine.speculative import SpeculativeEngine
from distributed_llm_tpu_torch.models import transformer as TT
from distributed_llm_tpu_torch.models.convert import params_from_jax
from distributed_llm_tpu_torch.ops import quant as TQ
from distributed_llm_tpu_torch.utils.hbm_budget import (model_bytes,
                                                        tier_hbm_budget)
from test_torch_engine import _tree
from test_torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# (rtol, atol) of the products against JAX, by dtype (module docstring).
PRODUCT_TOL = {"float32": (1e-6, 1e-6), "bfloat16": (0.0, 2e-2)}
LOGITS_ATOL = 1e-4
F32 = {name: f"{name}_q8_f32" for name in ("nano_test", "orin_test",
                                           "draft_test")}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _weight(rng, shape, contract_axis):
    """A weight with an all-zero channel and, in another channel, exact .5
    ties at scale 1 (amax 127)."""
    w = (rng.standard_normal(shape) * 0.3).astype(np.float32)
    zero = [slice(None)] * 2
    zero[1 if contract_axis in (-2, 0) else 0] = 0
    w[tuple(zero)] = 0.0
    ties = np.asarray([127.0, 2.5, -3.5, 0.5, -0.5, 1.5, -126.5], np.float32)
    if contract_axis in (-2, 0):
        w[:, 1] = 0.0
        w[:len(ties), 1] = ties
    else:
        w[1] = 0.0
        w[1, :len(ties)] = ties
    return w


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("contract_axis,shape", [(-2, (48, 32)),
                                                 (-1, (40, 24))])
def test_quantize_tensor_bit_identical_to_jax(dtype, contract_axis, shape):
    jdt, tdt = DTYPES[dtype]
    w = _weight(np.random.default_rng(0), shape, contract_axis)
    jw = JQ.quantize_tensor(jnp.asarray(w, jdt), contract_axis)
    jit = jax.jit(JQ.quantize_tensor, static_argnums=1)(jnp.asarray(w, jdt),
                                                         contract_axis)
    tw = TQ.quantize_tensor(torch.from_numpy(w).to(tdt), contract_axis)
    assert TQ.is_quantized(tw) and tw.q.dtype == torch.int8
    assert tw.s.dtype == tdt
    for want in (jw, jit):
        np.testing.assert_array_equal(tw.q.numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(_np(tw.s), _np(jw["s"]))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(_np(tw.s), _np(jit["s"]))
    else:
        np.testing.assert_array_max_ulp(_np(tw.s), _np(jit["s"]), maxulp=1)
    ties = tw.q[:7, 1] if contract_axis == -2 else tw.q[1, :7]
    assert ties.tolist() == [127, 2, -4, 0, 0, 2, -126]
    zero = tw.q[:, 0] if contract_axis == -2 else tw.q[0]
    assert not zero.any() and _np(tw.s).min() > 0
    np.testing.assert_array_equal(_np(TQ.dequantize(tw)),
                                  _np(JQ.dequantize(jw)))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("lead", [(1,), (5,), (2, 3)])
def test_products_match_jax(dtype, lead):
    jdt, tdt = DTYPES[dtype]
    rtol, atol = PRODUCT_TOL[dtype]
    rng = np.random.default_rng(len(lead) + lead[0])
    k, n, v = 32, 48, 40
    x = (rng.standard_normal(lead + (k,)) * 0.5).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.2).astype(np.float32)
    table = (rng.standard_normal((v, k)) * 0.5).astype(np.float32)
    tokens = rng.integers(0, v, lead)
    jw, je = (JQ.quantize_tensor(jnp.asarray(a, jdt), ax)
              for a, ax in ((w, -2), (table, -1)))
    tw, te = (TQ.quantize_tensor(torch.from_numpy(a).to(tdt), ax)
              for a, ax in ((w, -2), (table, -1)))
    tx, jx = torch.from_numpy(x).to(tdt), jnp.asarray(x, jdt)
    got = TQ.matmul(tx, tw)
    assert got.dtype == tdt and tuple(got.shape) == lead + (n,)
    np.testing.assert_allclose(_np(got), _np(JQ.matmul(jx, jw)), rtol=rtol,
                               atol=atol)
    rows = TQ.embed_rows(te, torch.from_numpy(tokens))
    np.testing.assert_array_equal(_np(rows), _np(JQ.embed_rows(
        je, jnp.asarray(tokens))))
    head = TQ.tied_head(te, tx)
    assert head.dtype == torch.float32
    np.testing.assert_allclose(_np(head), _np(JQ.tied_head(je, jx)),
                               rtol=rtol, atol=atol)
    # Plain weights keep the plain products.
    np.testing.assert_array_equal(
        _np(TQ.matmul(tx, torch.from_numpy(w).to(tdt))),
        _np(tx @ torch.from_numpy(w).to(tdt)))


def _nano(dtype="float32"):
    jcfg = dataclasses.replace(jax_config.MODEL_PRESETS["nano_test"],
                               dtype=dtype)
    tcfg = dataclasses.replace(torch_config.MODEL_PRESETS["nano_test"],
                               dtype=dtype)
    return jcfg, tcfg


def _models_equal(a, b):
    for (name, x), (_, y) in zip(sorted(a.state_dict().items()),
                                 sorted(b.state_dict().items())):
        assert x.dtype == y.dtype, name
        assert torch.equal(x, y), name


def test_maybe_quantize_modes_and_idempotence():
    _, tcfg = _nano()
    model = params_from_jax(tcfg, _tree(tcfg))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tier = torch_config.TierConfig(name="t", model_preset="nano_test")
    assert TQ.maybe_quantize(model, tier, tcfg) is model
    assert all(torch.equal(before[k], v)
               for k, v in model.state_dict().items())
    for mode in ("int4", "fp8", "INT8"):
        with pytest.raises(ValueError, match="unknown quantize mode"):
            TQ.maybe_quantize(model, dataclasses.replace(tier, quantize=mode))
    q8 = dataclasses.replace(tier, quantize="int8")
    assert TQ.maybe_quantize(model, q8, tcfg) is model
    layer = model.layers[0]
    for key in TQ._QUANT_LAYER_KEYS:
        assert TQ.is_quantized(getattr(layer, key))
        assert tuple(getattr(layer, key).s.shape) == (
            1, getattr(layer, key).q.shape[1])
    assert TQ.is_quantized(model.embed)
    assert tuple(model.embed.s.shape) == (tcfg.vocab_size, 1)
    assert not TQ.is_quantized(layer.ln1) and not list(
        p for n, p in model.named_parameters()
        if not n.endswith(("ln1", "ln2", "final_ln")))
    once = {k: v.clone() for k, v in model.state_dict().items()}
    TQ.maybe_quantize(model, q8, tcfg)
    TQ.quantize_params(model)
    assert all(torch.equal(once[k], v) for k, v in model.state_dict().items())
    # ``.to`` carries q and s (buffers).
    moved = model.to("meta")
    assert moved.layers[0].wq.q.device.type == "meta"


def test_params_from_jax_takes_a_quantized_tree():
    jcfg, tcfg = _nano("bfloat16")
    jparams = JT.init_params(jcfg, 3)
    jq = jax.tree_util.tree_map(np.asarray, JQ.quantize_params(jparams))
    got = params_from_jax(tcfg, jq)
    want = TQ.quantize_params(params_from_jax(
        tcfg, jax.tree_util.tree_map(np.asarray, jparams)))
    _models_equal(got, want)
    assert TQ.is_quantized(got.embed) and got.embed.s.dtype == torch.bfloat16
    assert model_bytes(got) == tier_hbm_budget(torch_config.TierConfig(
        name="t", model_preset="nano_test", quantize="int8"))["params_bytes"]
    bad = dict(jq, layers=dict(jq["layers"], wq={
        "q": jq["layers"]["wq"]["q"][:, :, :8], "s": jq["layers"]["wq"]["s"]}))
    with pytest.raises(ValueError, match="wq"):
        params_from_jax(tcfg, bad)


@pytest.mark.parametrize("preset", ["nano_test", "orin_test"])
def test_forward_with_int8_weights_matches_jax(preset):
    """A prefill, a suffix chunk with padded rows against a 32-position
    window and three decode steps on a contiguous cache, with int8 weights,
    against JAX at float32."""
    jcfg = dataclasses.replace(jax_config.MODEL_PRESETS[preset],
                               dtype="float32")
    tcfg = dataclasses.replace(torch_config.MODEL_PRESETS[preset],
                               dtype="float32")
    jplain = JT.init_params(jcfg, 1)
    jparams = JQ.quantize_params(jplain)
    model = TQ.quantize_params(params_from_jax(
        tcfg, jax.tree_util.tree_map(np.asarray, jplain)))
    rng = np.random.default_rng(11)
    s, n = 16, 13
    toks = rng.integers(0, jcfg.vocab_size, (2, s)).astype(np.int32)
    positions = np.tile(np.arange(s, dtype=np.int32), (2, 1))
    jh, (jk, jv) = JT.prefill(jcfg, jparams, jnp.asarray(toks),
                              jnp.asarray(positions))
    th, (tk, tv) = TT.prefill(tcfg, model, torch.from_numpy(toks).long(),
                              torch.from_numpy(positions))
    np.testing.assert_allclose(
        _np(TT.logits_from_hidden(model, th)),
        _np(JT.logits_from_hidden(jparams, jh)), atol=LOGITS_ATOL, rtol=0)
    jcache = JT.seed_kv_cache(jcfg, jk[:, :1], jv[:, :1], 64)
    tcache = TT.seed_kv_cache(tcfg, tk[:, :1], tv[:, :1], 64)
    chunk = rng.integers(0, jcfg.vocab_size, (1, 16)).astype(np.int32)
    true_len = n + 13
    jh, jcache = JT.chunk_prefill(jcfg, jparams, jnp.asarray(chunk),
                                  jnp.asarray([n], jnp.int32),
                                  jnp.asarray([true_len], jnp.int32), jcache,
                                  window=32)
    th = TT.chunk_prefill(tcfg, model, torch.from_numpy(chunk).long(),
                          torch.tensor([n], dtype=torch.int32),
                          torch.tensor([true_len], dtype=torch.int32), tcache,
                          window=32)
    np.testing.assert_allclose(
        _np(TT.logits_from_hidden(model, th[:, :13])),
        _np(JT.logits_from_hidden(jparams, jh[:, :13])), atol=LOGITS_ATOL,
        rtol=0)
    cur, pos = np.asarray([7], np.int32), true_len
    for _ in range(3):
        jl, jcache = JT.decode_step(jcfg, jparams, jnp.asarray(cur),
                                    jnp.asarray([pos], jnp.int32), jcache)
        tl = TT.decode_step(tcfg, model, torch.from_numpy(cur).long(),
                            torch.tensor([pos], dtype=torch.int32), tcache)
        np.testing.assert_allclose(_np(tl), _np(jl), atol=LOGITS_ATOL, rtol=0)
        cur = np.asarray(jl).argmax(-1).astype(np.int32)
        pos += 1


# -- the engines ------------------------------------------------------------------

PROMPTS = ["rivers carry water down from the mountains to the sea",
           "bright stars shine over quiet hills tonight",
           "a long question about rivers lakes mountains oceans deltas "
           "and the weather systems that move between them " * 3]


@pytest.fixture(scope="module")
def weights():
    """preset -> numpy tree (0.2 scale, so greedy decoding does not
    collapse) of float32 copies registered in both packages."""
    with pytest.MonkeyPatch.context() as mp:
        out = {}
        for i, (base, name) in enumerate(F32.items()):
            for cfgmod in (jax_config, torch_config):
                mp.setitem(cfgmod.MODEL_PRESETS, name, dataclasses.replace(
                    cfgmod.MODEL_PRESETS[base], name=name, dtype="float32"))
            out[name] = _tree(torch_config.MODEL_PRESETS[name], seed=i)
        yield out


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _batched_run(engine):
    reqs = [engine.submit(p) for p in PROMPTS]
    for r in reqs:
        assert r.done.wait(timeout=120)
        if r.error is not None:
            raise r.error
    turn1 = [{"role": "user", "content": "tell me about the tallest hills"}]
    first = engine.generate(turn1)
    turn2 = turn1 + [{"role": "assistant", "content": first.text},
                     {"role": "user", "content": "and the lakes?"}]
    return ([r.result.token_ids for r in reqs]
            + [first.token_ids, engine.generate(turn2).token_ids])


@pytest.mark.parametrize("draft", [None, "self", "draft_test"])
def test_batched_engine_int8_weights_emit_jax_tokens(weights, draft):
    preset = F32["nano_test"]
    kw = dict(model_preset=preset, quantize="int8", prefill_chunk_tokens=32,
              prefill_buckets=(16, 32, 64, 128))
    if draft is not None:
        kw.update(draft_preset=preset if draft == "self" else F32[draft],
                  spec_decode=True)
    jtier = dataclasses.replace(jax_config.tiny_batched_cluster().nano, **kw)
    ttier = dataclasses.replace(torch_config.tiny_batched_cluster().nano, **kw)
    jax_engine = JaxBatched(jtier, params=_jax_tree(weights[preset]))
    draft_params = None
    if draft == "draft_test":
        # The round reads params_d at call time: hand JAX the test's draft,
        # quantized as its engine quantizes its own.
        jax_engine.params_d = JQ.quantize_params(
            _jax_tree(weights[F32[draft]]))
        draft_params = params_from_jax(torch_config.MODEL_PRESETS[F32[draft]],
                                       weights[F32[draft]])
    port = TorchBatched(ttier, device="cpu", params=params_from_jax(
        torch_config.MODEL_PRESETS[preset], weights[preset]),
        draft_params=draft_params)
    try:
        assert TQ.is_quantized(port.model.layers[0].w_up)
        if draft is not None:
            assert port.spec and TQ.is_quantized(port.model_d.layers[0].wq)
            assert (port.model_d is port.model) == (draft == "self")
        want, got = _batched_run(jax_engine), _batched_run(port)
        assert got == want
        assert len(set(got[0])) > 3
        if draft is not None:
            assert (port.spec_stats()["accepted_total"]
                    == jax_engine.spec_stats()["accepted_total"])
    finally:
        jax_engine.stop()
        port.stop()
    assert port.allocator.ref_stats()["allocated_blocks"] == 0


def _seq_tier(pkg, tier="nano", **kw):
    t = getattr(pkg.tiny_cluster(), tier)
    return dataclasses.replace(t, model_preset=F32[t.model_preset], tp=1,
                               quantize="int8", **kw)


def test_inference_engine_int8_weights_emit_jax_tokens(weights):
    jt, tt = _seq_tier(jax_config), _seq_tier(torch_config)
    tree = weights[tt.model_preset]
    pair = (JaxSeq(jt, params=_jax_tree(tree)),
            InferenceEngine(tt, device="cpu",
                            params=params_from_jax(tt.model(), tree)))
    assert TQ.is_quantized(pair[1].model.layers[1].w_down)
    long = "user: " + " ".join(f"word{i}" for i in range(25))
    for history in (PROMPTS[0], long):
        want, got = (e.generate(history) for e in pair)
        assert got.token_ids == want.token_ids
    turn = [{"role": "user", "content": PROMPTS[1]},
            {"role": "assistant", "content": want.text},
            {"role": "user", "content": "and then?"}]
    want, got = (e.generate(turn) for e in pair)
    assert got.token_ids == want.token_ids


def test_speculative_engine_int8_weights_emit_jax_tokens(weights):
    jt, tt = (_seq_tier(pkg, "orin", max_new_tokens=12)
              for pkg in (jax_config, torch_config))
    jd, td = (dataclasses.replace(t, model_preset=F32["draft_test"])
              for t in (jt, tt))
    tree_t, tree_d = weights[tt.model_preset], weights[td.model_preset]
    pair = (JaxSpec(jt, jd, gamma=3, target_params=_jax_tree(tree_t),
                    draft_params=_jax_tree(tree_d)),
            SpeculativeEngine(tt, td, gamma=3, device="cpu",
                              target_params=params_from_jax(tt.model(),
                                                            tree_t),
                              draft_params=params_from_jax(td.model(),
                                                           tree_d)))
    assert TQ.is_quantized(pair[1].model_d.embed)
    prompt = "user: tell me about oceans"
    want, got = (e.generate(prompt) for e in pair)
    assert got.token_ids == want.token_ids
    assert pair[1].accept_history == pair[0].accept_history


# -- W1: the kernel's algorithm, plan, route and refusals ------------------------

# Decode shapes (1-64 rows), then wide ones (past 64 rows: 64 x 256
# tiles, 128 x 256 in a launch of a wave of those, the last one here);
# the plans cut these into 1 to 16 chunks a tile.
MIRROR_SHAPES = [(1, 64, 128), (4, 320, 48), (8, 1024, 256), (20, 2048, 512),
                 (64, 96, 16), (100, 256, 272), (130, 1024, 512),
                 (65, 4096, 64), (300, 64, 6912)]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("m,k,n", MIRROR_SHAPES)
def test_w8_split_mirror_matches_plain_and_jax(dtype, m, k, n):
    """W1's arithmetic at these shapes (the plan's tiles, chunks of one or
    more 64-row k-tiles with K past a tile boundary, each chunk's float32
    partial from zero, a split tile's partials summed in chunk order)
    agrees with the plain version (float32 within 1e-5 relative: another
    summation order; bf16 within one bf16 step of the output, both
    rounding the same float32 sum) and with JAX."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(m + k + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = TQ.quantize_tensor(torch.from_numpy(
        rng.standard_normal((k, n)).astype(np.float32)).to(tdt))
    tx = torch.from_numpy(x).to(tdt)
    got = TQ.w8_split_mirror(tx, w.q, w.s)
    plain = TQ._matmul_plain(tx, w.q, w.s)
    assert got.dtype == tdt and got.shape == plain.shape
    jax_out = JQ.matmul(jnp.asarray(x, jdt), {"q": jnp.asarray(w.q.numpy()),
                                              "s": jnp.asarray(_np(w.s), jdt)})
    scale = float(np.abs(_np(plain)).max())
    tol = (1e-5 if dtype == "float32" else 2 ** -7) * scale
    for ref in (plain, jax_out):
        np.testing.assert_allclose(_np(got), _np(ref), rtol=0, atol=tol)
    assert TQ.w8_matmul(tx, w.q, w.s).dtype == tdt      # CPU: the plain one


def test_w8_mirror_shapes_cover_both_regimes_and_the_fix_up():
    plans = [TQ.w8_plan(m, [(k, n)]) for m, k, n in MIRROR_SHAPES]
    assert {p.bm for p in plans} == {8, 32, 64, 128}
    for wide in (False, True):
        assert {p.chunks[0][1] > 1 for p in plans
                if (p.bn == 256) == wide} == {False, True}


FULL_WIDTH = [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048),
              (4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]
# Every row count the card's check runs: decode rows, then the prefill
# buckets and 256-row chunks.
PLAN_ROWS = (1, 4, 8, 20, 40, 64, 128, 256, 512, 1024, 2048)


def w8_shares(plan):
    """Each block's items, [first, end), as ``csrc/w8_matmul.cu``'s
    ``item_from`` deals them: the launch's k-tiles (weight by weight, tile
    by tile) cut into ``grid`` equal contiguous shares, each item to the
    block whose share holds its first k-tile.  The kernel's own dealing is
    held on the card by chip_smoke's single and grouped checks."""
    kt_base, item_base = [0], [0]
    for tiles, items in zip(plan.tiles, plan.items):
        kt_base.append(kt_base[-1] + tiles * plan.kt)
        item_base.append(item_base[-1] + items)

    def item_from(o):
        if o >= kt_base[-1]:
            return item_base[-1]
        w = max(i for i in range(len(plan.tiles)) if kt_base[i] <= o)
        t, r = divmod(o - kt_base[w], plan.kt)
        chunk, nch = plan.chunks[w]
        return item_base[w] + t * nch + -(-r // chunk)

    total = kt_base[-1]
    return [(item_from(b * total // plan.grid),
             item_from((b + 1) * total // plan.grid))
            for b in range(plan.grid)]


@pytest.mark.parametrize("k,n", FULL_WIDTH)
def test_w8_split_plan_fills_the_card(k, n):
    """At every served row count: the chunks cover the weight's k-tiles
    exactly (only the last may be short), at most W8_MAX_CHUNKS; the grid
    is at most one block an SM and at most the items; the shares deal the
    items to the blocks in contiguous runs of equal k-tiles to within one
    chunk; a weight is split only where that shortens the longest share."""
    for m in PLAN_ROWS:
        plan = TQ.w8_plan(m, [(k, n)])
        chunk, nch = plan.chunks[0]
        kt = -(-k // TQ.W8_BK)
        assert (nch - 1) * chunk < kt <= nch * chunk
        assert nch <= TQ.W8_MAX_CHUNKS
        ref = TQ.w8_tile(m)
        assert plan.bm == ref[0] or (m > TQ.W8_DECODE_ROWS and plan.bm == 128)
        assert (plan.bm == 128) == (m > TQ.W8_DECODE_ROWS and -(-m // ref[0])
                                    * -(-n // ref[1]) >= TQ.W8_SMS)
        assert plan.items == (plan.tiles[0] * nch,)
        assert 1 <= plan.grid <= min(TQ.W8_SMS, plan.total_items)
        shares = w8_shares(plan)
        assert shares[0][0] == 0 and shares[-1][1] == plan.total_items
        assert all(a[1] == b[0] for a, b in zip(shares, shares[1:]))
        # Each block's k-tiles: its share of them, to within one chunk.
        load = [sum(min(chunk, kt - (i % nch) * chunk)
                    for i in range(first, end)) for first, end in shares]
        total = plan.tiles[0] * kt
        assert sum(load) == total
        assert max(load) <= -(-total // plan.grid) + chunk
        if nch > 1:
            # A split pays only where the longest share gets shorter.
            tiles = plan.tiles[0]
            assert (max(load)
                    < -(-tiles // min(tiles, TQ.W8_SMS)) * kt), (m, plan)
        # The fix-up reads a partial a chunk: [BM, BN] float32 a slot.
        assert plan.part_floats == (
            plan.total_items * plan.bm * plan.bn if nch > 1 else 0)


@pytest.mark.parametrize("m", PLAN_ROWS)
def test_w8_grouped_plan_keeps_each_weights_chunks(m):
    """A grouped launch (q/k/v, gate/up) cuts each weight as its lone
    launch does, so each output sums in the same order: the bits of a
    grouped product are the lone product's (its tile's rows may differ: a
    group of a wave of reference tiles runs 128-row tiles).  Its items are
    its weights' tiles x chunks laid end to end."""
    for cfg_shapes in (((2048, 2048), (2048, 512), (2048, 512)),
                       ((2048, 8192), (2048, 8192)),
                       ((4096, 4096), (4096, 1024), (4096, 1024)),
                       ((4096, 14336), (4096, 14336))):
        group = TQ.w8_plan(m, list(cfg_shapes))
        lone = [TQ.w8_plan(m, [shape]) for shape in cfg_shapes]
        assert group.chunks == tuple(p.chunks[0] for p in lone)
        assert group.tiles == tuple(-(-m // group.bm) * -(-n // group.bn)
                                    for _, n in cfg_shapes)
        assert group.items == tuple(t * nch for t, (_, nch)
                                    in zip(group.tiles, group.chunks))
        assert group.grid == min(TQ.W8_SMS, group.total_items)
        # The shares cover every item once, each block's k-tiles equal to
        # within the longest chunk, whatever the weights' chunk lengths.
        shares = w8_shares(group)
        assert shares[0][0] == 0 and shares[-1][1] == group.total_items
        assert all(a[1] == b[0] for a, b in zip(shares, shares[1:]))
        lengths = [min(c, group.kt - j * c) for (c, nch), t
                   in zip(group.chunks, group.tiles)
                   for _ in range(t) for j in range(nch)]
        load = [sum(lengths[first:end]) for first, end in shares]
        assert sum(load) == sum(t * group.kt for t in group.tiles)
        assert max(load) <= (-(-sum(load) // group.grid)
                             + max(c for c, _ in group.chunks))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_matmul_many_equals_lone_products(dtype):
    """``matmul_many`` gives each weight's ``matmul`` bit for bit (int8
    q/k/v-shaped weights, plain weights, 2-D and 3-D x), and its mirror
    holds: each grouped weight's plan and arithmetic are its lone one's."""
    _, tdt = DTYPES[dtype]
    rng = np.random.default_rng(7)
    ws = [torch.from_numpy(rng.standard_normal((64, n)).astype(np.float32)
                           ).to(tdt) for n in (64, 32, 32)]
    qs = [TQ.quantize_tensor(w) for w in ws]
    for shape in ((5, 64), (2, 3, 64)):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                             ).to(tdt)
        for weights in (qs, ws, qs[:2]):
            got = TQ.matmul_many(x, weights)
            assert len(got) == len(weights)
            for y, w in zip(got, weights):
                assert torch.equal(y, TQ.matmul(x, w))
    x2 = torch.from_numpy(rng.standard_normal((5, 64)).astype(np.float32)
                          ).to(tdt)
    for y, w in zip(TQ.w8_matmul_many(x2, [(w.q, w.s) for w in qs]), qs):
        assert torch.equal(y, TQ._matmul_plain(x2, w.q, w.s))


def _cuda_like(shape):
    return types.SimpleNamespace(is_cuda=True, shape=shape,
                                 numel=lambda: int(np.prod(shape)))


@pytest.mark.parametrize("shape,route", [((1, 64), "decode"),
                                         ((64, 64), "decode"),
                                         ((8, 8, 64), "decode"),
                                         ((65, 64), "wide"),
                                         ((2, 40, 64), "wide"),
                                         ((1, 2048, 64), "wide")])
def test_w8_route_rule(shape, route):
    """On the card every product launches W1, by a shape rule between its
    two regimes (no cast route); on the CPU the plain version."""
    assert TQ.w8_route(_cuda_like(shape)) == route
    assert TQ.w8_route(torch.zeros(shape)) == "plain"
    assert (TQ.w8_tile(int(np.prod(shape[:-1])))[1] == 256) == (
        route == "wide")


def test_w8_cpu_products_launch_nothing():
    w = TQ.quantize_tensor(torch.randn(32, 16, dtype=torch.bfloat16))
    before = TQ.w8_matmul.launches
    routes = dict(TQ.w8_matmul.route_launches)
    casts = TQ._matmul_plain.calls
    TQ.matmul(torch.randn(4, 32, dtype=torch.bfloat16), w)
    TQ.w8_matmul(torch.randn(70, 32, dtype=torch.bfloat16), w.q, w.s)
    TQ.matmul_many(torch.randn(3, 32, dtype=torch.bfloat16), (w, w))
    assert TQ.w8_matmul.launches == before
    assert TQ.w8_matmul.route_launches == routes
    assert TQ._matmul_plain.calls == casts      # the CPU is no cast route


@pytest.mark.parametrize("case", ["rows", "k", "n", "dtype", "qdtype",
                                  "stride", "scales", "shape", "count",
                                  "second"])
def test_w8_wrapper_refuses_what_the_kernel_does_not_take(case):
    x = torch.zeros(4, 64, dtype=torch.bfloat16)
    q = torch.zeros(64, 32, dtype=torch.int8)
    s = torch.ones(1, 32, dtype=torch.bfloat16)
    extra = []
    if case == "rows":
        x = torch.zeros(0, 64, dtype=torch.bfloat16)
    elif case == "k":
        x, q = x[:, :40], q[:40]
    elif case == "n":
        q, s = q[:, :24].contiguous(), s[:, :24]
    elif case == "dtype":
        x = x.float()
    elif case == "qdtype":
        q = q.to(torch.uint8)
    elif case == "stride":
        x = torch.zeros(4, 68, dtype=torch.bfloat16)[:, :64]
    elif case == "scales":
        s = torch.ones(1, 16, dtype=torch.bfloat16)
    elif case == "shape":
        q = torch.zeros(48, 32, dtype=torch.int8)
    elif case == "count":
        extra = [(q, s)] * 3                  # four weights in one launch
    else:
        # A group's second weight contracts another K.
        extra = [(torch.zeros(48, 32, dtype=torch.int8), s)]
    with pytest.raises(ValueError, match="w8_matmul"):
        TQ._check_w8(x, [(q, s)] + extra)
    TQ._check_w8(torch.zeros(4, 64, dtype=torch.bfloat16),
                 [(torch.zeros(64, 32, dtype=torch.int8),
                   torch.ones(1, 32, dtype=torch.bfloat16))] * 3)
