"""The dense windowed decode tick of the port against the JAX package.

- The plain versions of the paged decode kernels (``paged_decode_attention``
  and its int8 twin, the dense tick's attention through a window-truncated
  block table) against the JAX Pallas kernels in interpret mode and the
  JAX XLA path (``_gather_decode_paged``): block sizes 16 and 64, GQA
  groups 1, 2 and 4, windows of 1-4 blocks, slots at position 0, mid-block
  and the window's last position, an idle slot on the trash block, and
  the port's table a column slice of a wider table (read in place).
  float32 atol 2e-5 (the interpret-mode kernels keep float32 state like
  the plain version); bf16 atol 2e-2 against the XLA path and 3e-2
  against the kernels (they round at other points).
- The dense plain version over a truncated table equals the ragged plain
  version over the full table, and each counts only its own calls.
- ``ContinuousBatchingEngine`` with ``attention_ragged=False`` on the
  nano tier of ``tiny_batched_cluster()`` at float32, with the plain and
  the int8 pool: greedy tokens and the tick's window sequence identical
  to the JAX engine's, over prompts whose decode crosses the 16 -> 32 ->
  64 rungs.  A ``draft_preset`` on a dense tier serves plain decode in
  both packages.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_tpu import config as jax_config
from distributed_llm_tpu.engine.batching import (
    ContinuousBatchingEngine as JaxEngine)
from distributed_llm_tpu.ops import attention as JA
from distributed_llm_tpu.ops import pallas_attention as JP
from distributed_llm_tpu.ops import quant as JQ
from distributed_llm_tpu_torch import config as torch_config
from distributed_llm_tpu_torch.engine.batching import (
    ContinuousBatchingEngine as TorchEngine)
from distributed_llm_tpu_torch.models.convert import params_from_jax
from distributed_llm_tpu_torch.ops import attention as TA
from distributed_llm_tpu_torch.ops import flash_attention as TF
from test_torch_engine import PRESET, _tree
from test_torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2, 3e-2)}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _case(rng, *, bs, group, wb, q8, b=4, nkv=2, d=16, mb=6):
    """Pools of ``b * mb + 1`` blocks, a shuffled full table [B, MB] and
    its first ``wb`` columns as the window; slot 0 idle on the trash
    block, the others at position 0, mid-block and the window's last
    position."""
    nb = b * mb + 1
    q = rng.standard_normal((b, nkv * group, d)).astype(np.float32)
    k = rng.standard_normal((nkv, nb, bs, d)).astype(np.float32)
    v = rng.standard_normal((nkv, nb, bs, d)).astype(np.float32)
    scales = None
    if q8:
        kq, ks = (np.array(a) for a in JQ.quantize_kv_rows(jnp.asarray(k)))
        vq, vs = (np.array(a) for a in JQ.quantize_kv_rows(jnp.asarray(v)))
        k, v, scales = kq, vq, (ks, vs)
    full = rng.permutation(np.arange(1, nb)).astype(np.int32).reshape(b, mb)
    full[0] = 0
    pos = np.asarray([0, 0, (wb - 1) * bs + bs // 2, wb * bs - 1], np.int32)
    return q, k, v, scales, full, pos


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("q8", [False, True], ids=["bf16_pool", "int8_pool"])
@pytest.mark.parametrize("bs", [16, 64])
@pytest.mark.parametrize("group", [1, 2, 4])
def test_paged_decode_plain_matches_jax(dtype, q8, bs, group):
    """Every window of 1-4 blocks against the XLA path; the interpret-mode
    kernel (slow on the CPU) at one window per (bs, group), the six
    covering 1-4 blocks."""
    jdt, tdt, atol_xla, atol_kernel = DTYPES[dtype]
    rng = np.random.default_rng(bs * 10 + group)
    kernel_wb = {1: 1, 2: 2, 4: 3}[group] + (bs == 64)
    for wb in (1, 2, 3, 4):
        q, k, v, scales, full, pos = _case(rng, bs=bs, group=group, wb=wb,
                                           q8=q8)
        tq = torch.from_numpy(q).to(tdt)
        tk, tv = torch.from_numpy(k), torch.from_numpy(v)
        if not q8:
            tk, tv = tk.to(tdt), tv.to(tdt)
        tfull = torch.from_numpy(full)
        window = tfull[:, :wb]                   # a column slice, strided
        assert not window.is_contiguous()
        tpos = torch.from_numpy(pos)
        jq = jnp.asarray(q, jdt)
        jk, jv = jnp.asarray(k), jnp.asarray(v)
        if not q8:
            jk, jv = jk.astype(jdt), jv.astype(jdt)
        jtab, jpos = jnp.asarray(full[:, :wb]), jnp.asarray(pos)
        before = TA._gather_decode_windowed.calls
        if q8:
            tks, tvs = (torch.from_numpy(s) for s in scales)
            jks, jvs = (jnp.asarray(s) for s in scales)
            port = TF.paged_decode_attention_q8(tq, tk, tv, tks, tvs, window,
                                                tpos)
            xla = JA._gather_decode_paged(jq, jk, jv, jtab, jpos, jks, jvs)
            kern = (lambda: JP.paged_decode_attention_q8(
                jq, jk, jv, jks, jvs, jtab, jpos))
        else:
            port = TF.paged_decode_attention(tq, tk, tv, window, tpos)
            xla = JA._gather_decode_paged(jq, jk, jv, jtab, jpos, None, None)
            kern = lambda: JP.paged_decode_attention(jq, jk, jv, jtab, jpos)
        assert TA._gather_decode_windowed.calls == before + 1
        assert port.dtype == tdt and port.shape == tq.shape
        np.testing.assert_allclose(_np(port), _np(xla), atol=atol_xla, rtol=0)
        if wb == kernel_wb:
            np.testing.assert_allclose(_np(port), _np(kern()),
                                       atol=atol_kernel, rtol=0)


def test_dense_over_window_equals_ragged_over_full_table():
    rng = np.random.default_rng(7)
    q, k, v, _, full, pos = _case(rng, bs=16, group=2, wb=3, q8=False)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tfull, tpos = torch.from_numpy(full), torch.from_numpy(pos)
    ragged0 = TA._gather_decode_paged.calls
    dense0 = TA._gather_decode_windowed.calls
    dense = TA.paged_decode(tq, tk, tv, tfull[:, :3], tpos)
    assert TA._gather_decode_paged.calls == ragged0
    ragged = TA.ragged_decode(tq, tk, tv, tfull, tpos)
    assert TA._gather_decode_windowed.calls == dense0 + 1
    assert TA._gather_decode_paged.calls == ragged0 + 1
    torch.testing.assert_close(dense, ragged, atol=1e-6, rtol=0)


# -- the engine ---------------------------------------------------------------

# Prompts of about 10 tokens decoding 24: the tick's window climbs the
# 16 -> 32 -> 64 bucket rungs as positions pass 12 and 28.
PROMPTS = ["rivers carry water down to the sea",
           "explain how a compiler works",
           "bright stars shine over quiet hills tonight"]


@pytest.fixture(scope="module")
def make_pair():
    """(jax_engine, port_engine) pairs over the same float32 weights,
    with ``attention_ragged=False``; every pair is stopped and the port's
    pool must hold no block after stop."""
    built = []
    with pytest.MonkeyPatch.context() as mp:
        base = jax_config.MODEL_PRESETS["nano_test"]
        mp.setitem(jax_config.MODEL_PRESETS, PRESET,
                   dataclasses.replace(base, name=PRESET, dtype="float32"))
        mp.setitem(torch_config.MODEL_PRESETS, PRESET,
                   dataclasses.replace(torch_config.MODEL_PRESETS["nano_test"],
                                       name=PRESET, dtype="float32"))
        tree = _tree(torch_config.MODEL_PRESETS[PRESET])
        jax_params = {"embed": jnp.asarray(tree["embed"]),
                      "final_ln": jnp.asarray(tree["final_ln"]),
                      "layers": {k: jnp.asarray(v)
                                 for k, v in tree["layers"].items()}}

        def build(**overrides):
            over = dict(model_preset=PRESET, attention_ragged=False,
                        **overrides)
            jtier = dataclasses.replace(
                jax_config.tiny_batched_cluster().nano, **over)
            ttier = dataclasses.replace(
                torch_config.tiny_batched_cluster().nano, **over)
            pair = (JaxEngine(jtier, params=jax_params),
                    TorchEngine(ttier, device="cpu", params=params_from_jax(
                        torch_config.MODEL_PRESETS[PRESET], tree)))
            built.append(pair)
            return pair

        yield build
        for jax_engine, port_engine in built:
            jax_engine.stop()
            port_engine.stop()
            assert port_engine.allocator.ref_stats()["allocated_blocks"] == 0


def _record_windows(engine):
    """Wrap the engine's ``_suffix_window``: the list of windows its dense
    tick picks, one per tick."""
    seen = []
    real = engine._suffix_window

    def spy(needed):
        w = real(needed)
        seen.append(w)
        return w

    engine._suffix_window = spy
    return seen


def _serve(engine, prompts):
    reqs = [engine.submit(p) for p in prompts]
    for r in reqs:
        assert r.done.wait(timeout=120)
        if r.error is not None:
            raise r.error
    return [r.result.token_ids for r in reqs]


@pytest.mark.parametrize("kv_quantize", ["none", "int8"])
def test_dense_tick_tokens_and_windows_match_jax(make_pair, kv_quantize):
    jax_engine, port_engine = make_pair(kv_quantize=kv_quantize)
    assert port_engine.ragged is False and jax_engine.ragged is False
    jax_windows, port_windows = (_record_windows(e)
                                 for e in (jax_engine, port_engine))
    dense0 = TA._gather_decode_windowed.calls
    ragged0 = TA._gather_decode_paged.calls
    for prompt in PROMPTS[:2]:                     # one slot at a time
        want = jax_engine.generate(prompt).token_ids
        got = port_engine.generate(prompt).token_ids
        assert got == want
        assert len(set(got)) > 3
    # Concurrent slots: the window is the batch's high-water mark.
    assert _serve(port_engine, PROMPTS) == _serve(jax_engine, PROMPTS)
    assert port_windows == jax_windows
    assert {16, 32, 64} <= set(port_windows)
    # The dense tick ran the windowed plain version, never the ragged one.
    assert TA._gather_decode_windowed.calls > dense0
    assert TA._gather_decode_paged.calls == ragged0


def test_draft_on_a_dense_tier_serves_plain_decode(make_pair):
    jax_engine, port_engine = make_pair(draft_preset=PRESET,
                                        spec_decode=True)
    assert jax_engine.spec is False and port_engine.spec is False
    assert port_engine.pool_d is None
    prompt = PROMPTS[0]
    assert (port_engine.generate(prompt).token_ids
            == jax_engine.generate(prompt).token_ids)
    assert port_engine.spec_stats()["drafted_total"] == 0
