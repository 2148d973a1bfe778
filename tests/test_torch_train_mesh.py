"""Multi-device training of the port (``parallel/mesh.training_mesh``,
``moe_training_mesh``, ``parallel/sharding.place_for_training``,
``collectives.all_gather``, ``training/trainer.Trainer`` over a group,
``utils/checkpoint`` across groups, ``training/pretrain``'s dp rule)
against the JAX package's, on repeated CPU slots (``["cpu"] * 8``) and
JAX's 8 virtual CPU devices (``tests/conftest.py``).

- The meshes' axis sizes equal JAX's for n = 1..8 and several kv-head,
  sequence and expert counts, odd ones included.
- Every leaf's placement equals JAX's ``train_param_shardings`` spec
  after its fallback, for ``nano_test``, ``orin_test`` and ``moe_test``
  on full, wide, subset and ('dp', 'ep') groups; the pieces hold every
  element once, each on its home slot, and gather back to the model.
- ``all_gather``'s backward sums the users' gradients in float32 and
  rounds once; ``allreduce_sum`` carries the row-parallel partials'
  gradients.
- Three ``Trainer`` steps over ('dp', 'sp', 'tp') = (2, 2, 2), dp-only,
  sp-only, tp-only and an ``orin_test`` ('dp', 'tp') group, and
  ``moe_test`` over ('dp', 'ep') = (2, 4), from the same weights and
  batches as JAX's one-device ``Trainer`` (GSPMD keeps the math, so its
  numbers are the mesh's), and the (2, 2, 2) case against JAX's (2, 2,
  2) mesh ``Trainer`` itself, on float32 presets: losses within 1e-5
  relative, pre-clip grad norms within 1e-4, parameters within
  ``test_three_adamw_steps_match_jax``'s bounds.  The MoE batch
  overflows its experts' capacity, so capacity counted per 'dp' slot
  would keep other tokens than JAX's.
- A checkpoint saved on 8 slots restores bit for bit onto 2 slots and
  onto one device (weights and AdamW moments) and each resumed trainer
  steps as the original; a one-device save loads onto a group and back;
  a mesh-trained root serves through ``load_params_for_tier``.
- ``pretrain`` over CPU slots takes JAX's dp rule.
- The port's counterpart of the three training legs of JAX's
  ``__graft_entry__.dryrun_multichip`` (the ``training_mesh`` step, the
  ``moe_training_mesh`` step and a pp=2 step), against JAX.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from distributed_llm_tpu import config as jax_config
from distributed_llm_tpu.parallel import mesh as jax_mesh
from distributed_llm_tpu.parallel.sharding import train_param_shardings
from distributed_llm_tpu.training import trainer as jax_trainer
from distributed_llm_tpu_torch import config as torch_config
from distributed_llm_tpu_torch import models
from distributed_llm_tpu_torch.engine.bpe import load_default
from distributed_llm_tpu_torch.engine.manager import EngineManager
from distributed_llm_tpu_torch.models import moe
from distributed_llm_tpu_torch.models.checkpoint import load_params_for_tier
from distributed_llm_tpu_torch.models.convert import params_from_jax
from distributed_llm_tpu_torch.parallel.collectives import (all_gather,
                                                            allreduce_sum)
from distributed_llm_tpu_torch.parallel.mesh import (DeviceGroup,
                                                     moe_training_mesh,
                                                     training_mesh)
from distributed_llm_tpu_torch.parallel.sharding import (gather_model,
                                                         place_for_training)
from distributed_llm_tpu_torch.training import PipelineTrainer, pretrain
from distributed_llm_tpu_torch.training import data, trainer
from distributed_llm_tpu_torch.utils import checkpoint as ckpt
from test_torch_moe import _moe_tree
from test_torch_training import (F32, LR, STEPS, _tree,  # noqa: F401
                                 assert_params_match, presets)
from test_torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


B, S = 8, 32
KW = dict(batch_size=B, seq_len=S, learning_rate=LR, warmup_steps=1,
          decay_steps=10, max_grad_norm=0.5)
CPU8 = ["cpu"] * 8


def _group(axes, dims):
    return DeviceGroup(tuple(["cpu"] * int(np.prod(dims))), axes, dims)


def _jax_mesh(axes, dims):
    n = int(np.prod(dims))
    return Mesh(np.array(jax.devices()[:n]).reshape(dims), axes)


def _weights(base):
    """Numpy weights for the float32 copy of ``base`` (seed 3)."""
    name = F32[base]
    if base == "moe_test":
        return _moe_tree(torch_config.MODEL_PRESETS[name], seed=3, scale=0.05)
    return _tree(name, seed=3)


@pytest.fixture(scope="module")
def stream():
    batches = data.batches(B, S, seed=11, tokenizer=load_default())
    return [next(batches) for _ in range(STEPS)]


@pytest.fixture(scope="module")
def jax_runs(presets, stream):
    """JAX's three steps by (preset, mesh dims or None for one device),
    each computed once: (metrics, params, Adam second moments)."""
    runs = {}

    def get(base, dims=None):
        if (base, dims) not in runs:
            cfg = jax_config.MODEL_PRESETS[F32[base]]
            mesh = (_jax_mesh(("dp", "sp", "tp"), dims) if dims
                    else _jax_mesh(("dp",), (1,)))
            params = jax.device_put(
                jax.tree_util.tree_map(jnp.asarray, _weights(base)),
                train_param_shardings(cfg, mesh))
            jt = jax_trainer.Trainer(cfg, jax_trainer.TrainConfig(**KW), mesh,
                                     params=params)
            metrics = [jt.train_step(t, m) for t, m in stream]
            runs[base, dims] = (
                metrics, jax.tree_util.tree_map(np.asarray, jt.params),
                jax.tree_util.tree_map(np.asarray, jt.opt_state[1][0].nu))
        return runs[base, dims]
    return get


def _port(base, group, steps):
    """The port's trainer over ``group`` from ``base``'s weights, after
    ``steps`` steps of the stream: (metrics, trainer)."""
    name = F32[base]
    cfg = torch_config.MODEL_PRESETS[name]
    tr = trainer.Trainer(cfg, trainer.TrainConfig(**KW), group,
                         params=params_from_jax(cfg, _weights(base)),
                         device="cpu")
    return [tr.train_step(t, m) for t, m in steps], tr


def _assert_matches(got, tr, want):
    metrics, jparams, jnu = want
    assert tr.step_count == len(got)
    for g, w in zip(got, metrics):
        assert g["loss"] == pytest.approx(w["loss"], rel=1e-5)
        assert g["grad_norm"] == pytest.approx(w["grad_norm"], rel=1e-4)
    assert max(w["grad_norm"] for w in metrics) > 0.5      # the clip fired
    assert_params_match(tr.model, jparams, jnu,
                        sum(trainer.lr_at(tr.tc, i) for i in range(STEPS)))


# -- the meshes --------------------------------------------------------------------

@pytest.mark.parametrize("kv,seq", [(2, 64), (8, 256), (4, 32), (1, 16),
                                    (3, 48), (2, 7)])
def test_training_mesh_matches_jax(kv, seq):
    for n in range(1, 9):
        ours = training_mesh(CPU8[:n], num_kv_heads=kv, seq_len=seq)
        theirs = jax_mesh.training_mesh(jax.devices()[:n], num_kv_heads=kv,
                                        seq_len=seq)
        assert ours.axis_names == ("dp", "sp", "tp")
        assert ours.shape == dict(theirs.shape) and ours.size == n, n


@pytest.mark.parametrize("experts", [1, 2, 3, 4, 6, 8])
def test_moe_training_mesh_matches_jax(experts):
    for n in range(1, 9):
        ours = moe_training_mesh(CPU8[:n], num_experts=experts)
        theirs = jax_mesh.moe_training_mesh(jax.devices()[:n],
                                            num_experts=experts)
        assert ours.shape == dict(theirs.shape) and ours.size == n, n
        assert ours.ep == theirs.shape["ep"] and ours.dp == theirs.shape["dp"]


def test_group_slots_are_row_major():
    g = _group(("dp", "sp", "tp"), (2, 3, 4))
    for coords in np.ndindex(2, 3, 4):
        assert g.index(**dict(zip(g.axis_names, coords))) == (
            np.ravel_multi_index(coords, (2, 3, 4)))
    assert g.index(dp=1, sp=2, tp=3) == 23 and g.index(ep=5, tp=1) == 1
    assert (g.dp, g.sp, g.tp, g.ep, g.pp) == (2, 3, 4, 1, 1)
    assert _group(("pp",), (2,)).pp == 2


# -- placement ---------------------------------------------------------------------

PLACE_GROUPS = [(("dp", "sp", "tp"), (2, 2, 2)), (("dp", "sp", "tp"), (8, 1, 1)),
                (("dp", "sp", "tp"), (1, 1, 8)), (("dp", "ep"), (2, 4)),
                (("dp",), (2,)), (("tp",), (4,)), (("sp", "tp"), (2, 2))]


@pytest.mark.parametrize("axes,dims", PLACE_GROUPS)
@pytest.mark.parametrize("base", ["nano_test", "orin_test", "moe_test"])
def test_placement_matches_jax_specs(base, axes, dims):
    jcfg = jax_config.MODEL_PRESETS[base]
    want = train_param_shardings(jcfg, _jax_mesh(axes, dims))
    model = models.init_params(torch_config.MODEL_PRESETS[base], seed=1,
                               device="cpu")
    state = {k: v.clone() for k, v in model.state_dict().items()}
    group = _group(axes, dims)
    pl = place_for_training(model, group)
    assert list(pl.leaves) == list(state)
    for name, leaf in pl.leaves.items():
        parts = name.split(".")
        if len(parts) == 1:
            jspec = tuple(want[name].spec)
        else:
            jspec = tuple(want["layers"][parts[2]].spec)[1:]
        jspec += (None,) * (state[name].dim() - len(jspec))
        assert leaf.spec == jspec, name
        # Every element in exactly one piece, each on its home slot.
        assert sum(p.numel() for p in leaf.pieces.values()) == (
            state[name].numel())
        assert torch.equal(pl.whole(name, leaf.pieces), state[name]), name
        for key, p in leaf.pieces.items():
            # Its home: the slot at its block's coordinates, 0 elsewhere.
            assert pl.home(name, key) == group.index(**dict(
                zip((ax for _, ax in leaf.axes), key)))
            assert p.requires_grad and p.is_leaf
    assert len(pl.parameters()) == sum(len(leaf.pieces)
                                       for leaf in pl.leaves.values())
    whole = gather_model(pl)
    with torch.no_grad():
        for p in pl.parameters():
            p.zero_()
    # The gathered model holds copies: the pieces' updates leave it be.
    assert all(torch.equal(v, state[k]) for k, v in whole.state_dict().items())


def test_one_slot_placement_is_the_model_itself():
    model = models.init_params(torch_config.MODEL_PRESETS["nano_test"],
                               device="cpu")
    pl = place_for_training(model, _group(("dp",), (1,)))
    assert pl.model is model
    assert [id(p) for p in pl.parameters()] == [id(p) for p in
                                                model.parameters()]


# -- the collectives under autograd ------------------------------------------------

def test_all_gather_backward_sums_in_float32_once():
    rng = np.random.default_rng(0)

    def bf16(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(torch.bfloat16)

    pieces = [bf16(3, 5).requires_grad_(True) for _ in range(2)]
    outs = all_gather(pieces, 0, [torch.device("cpu")] * 3)
    assert len({id(o) for o in outs}) == 3
    for o in outs:
        assert torch.equal(o, torch.cat(pieces, 0))
    grads = [bf16(6, 5) for _ in outs]
    torch.autograd.backward(outs, grads)
    total = (grads[0].float() + grads[1].float() + grads[2].float()).to(
        torch.bfloat16)
    assert torch.equal(pieces[0].grad, total[:3])
    assert torch.equal(pieces[1].grad, total[3:])


def test_allreduce_sum_carries_row_parallel_gradients():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((8, 6)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((4, 6)).astype(np.float32))
    ws = [w[:4].clone().requires_grad_(True), w[4:].clone().requires_grad_(True)]
    xs = [x[:, :4].clone().requires_grad_(True),
          x[:, 4:].clone().requires_grad_(True)]
    out = allreduce_sum([a @ b for a, b in zip(xs, ws)],
                        [torch.device("cpu")])[0]
    out.backward(g)
    whole_w, whole_x = w.clone().requires_grad_(True), x.clone().requires_grad_(
        True)
    (whole_x @ whole_w).backward(g)
    torch.testing.assert_close(torch.cat([p.grad for p in ws]), whole_w.grad)
    torch.testing.assert_close(torch.cat([p.grad for p in xs], 1),
                               whole_x.grad)


# -- the trainer over groups -------------------------------------------------------

GROUPS = {
    "dp_sp_tp": ("nano_test", ("dp", "sp", "tp"), (2, 2, 2)),
    "dp": ("nano_test", ("dp",), (8,)),
    "sp": ("nano_test", ("sp",), (4,)),
    "tp": ("nano_test", ("tp",), (2,)),
    "orin_dp_tp": ("orin_test", ("dp", "tp"), (2, 4)),
}


@pytest.mark.parametrize("case", list(GROUPS))
def test_trainer_over_a_group_matches_jax(presets, jax_runs, stream, case):
    base, axes, dims = GROUPS[case]
    got, tr = _port(base, _group(axes, dims), stream)
    assert tr.placement.model is None
    _assert_matches(got, tr, jax_runs(base))


def test_trainer_matches_jax_mesh_trainer(presets, jax_runs, stream):
    """The one case held against JAX's (2, 2, 2) mesh trainer itself."""
    got, tr = _port("nano_test", _group(("dp", "sp", "tp"), (2, 2, 2)),
                    stream)
    _assert_matches(got, tr, jax_runs("nano_test", (2, 2, 2)))


def test_moe_over_dp_ep_matches_jax(presets, jax_runs, stream, monkeypatch):
    kept = []
    real = moe.moe_ffn_train

    def watched(cfg, lp, x):
        # The tokens each expert keeps at the whole batch's capacity, and
        # at the capacity of each 'dp' slot's half of it.
        with torch.no_grad():
            xt = x.reshape(-1, x.shape[-1])
            gates, _ = moe._top2_gates(xt @ lp.w_router)

            def keep(g):
                sel = (g > 0).to(torch.int32)
                pos = torch.cumsum(sel, dim=0) * sel - 1
                return (pos >= 0) & (pos < moe.capacity(cfg, g.shape[0]))
            halves = torch.cat([keep(h) for h in gates.chunk(2)])
            kept.append(bool(torch.equal(keep(gates), halves)))
        return real(cfg, lp, x)

    monkeypatch.setattr(moe, "moe_ffn_train", watched)
    group = _group(("dp", "ep"), (2, 4))
    got, tr = _port("moe_test", group, stream)
    assert kept and not all(kept)
    _assert_matches(got, tr, jax_runs("moe_test"))
    # Every expert stack's E splits over the four ep slots.
    assert tr.placement.leaves["layers.0.w_gate"].spec == ("ep", "dp", None)


# -- checkpoints across groups -----------------------------------------------------

def _moments_equal(a, b) -> bool:
    ma, mb = ckpt._moments(a), ckpt._moments(b)
    return ma.keys() == mb.keys() and all(
        torch.equal(ma[n][k], mb[n][k]) for n in ma for k in ma[n])


def _fresh(group, seed=9):
    cfg = torch_config.MODEL_PRESETS[F32["nano_test"]]
    return trainer.Trainer(cfg, trainer.TrainConfig(**KW), group,
                           params=models.init_params(cfg, seed=seed,
                                                     device="cpu"),
                           device="cpu")


def _equal(a, b) -> bool:
    sa, sb = a.model.state_dict(), b.model.state_dict()
    return all(torch.equal(v, sb[k]) for k, v in sa.items())


def test_checkpoint_moves_from_eight_slots_to_two_and_one(presets, stream,
                                                          tmp_path):
    t8 = _fresh(_group(("dp", "sp", "tp"), (2, 2, 2)), seed=3)
    for t, m in stream[:2]:
        t8.train_step(t, m)
    root = t8.save(str(tmp_path / "ck"))
    with open(os.path.join(root, "latest", "meta.json")) as f:
        assert '"step": 2' in f.read()
    t2, t1 = _fresh(_group(("dp",), (2,))), _fresh(None)
    assert not _equal(t8, t2)
    for t in (t2, t1):
        t.load(root)
        assert t.step_count == 2 and _equal(t8, t) and _moments_equal(t8, t)
    want = t8.train_step(*stream[2])
    for t in (t2, t1):
        got = t.train_step(*stream[2])
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
        assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-4)


def test_one_device_checkpoint_loads_onto_a_group_and_back(presets, stream,
                                                           tmp_path):
    t1 = _fresh(None, seed=4)
    for t, m in stream[:2]:
        t1.train_step(t, m)
    tg = _fresh(_group(("dp", "sp", "tp"), (2, 2, 2)))
    tg.load(t1.save(str(tmp_path / "one")))
    assert tg.step_count == 2 and _equal(t1, tg) and _moments_equal(t1, tg)
    tg.train_step(*stream[2])
    back = _fresh(None)
    back.load(tg.save(str(tmp_path / "group")))
    assert back.step_count == 3 and _equal(tg, back)
    assert _moments_equal(tg, back)


def test_mesh_trained_root_serves(presets, stream, tmp_path):
    tg = _fresh(_group(("dp", "ep"), (2, 4)), seed=5)
    tg.train_step(*stream[0])
    root = tg.save(str(tmp_path / "weights"))
    cfg = torch_config.MODEL_PRESETS[F32["nano_test"]]
    served = load_params_for_tier(root, cfg)
    want = tg.model.state_dict()
    assert all(torch.equal(v, want[k]) for k, v in served.state_dict().items())
    tier = torch_config.TierConfig(name="nano", model_preset=cfg.name,
                                   max_new_tokens=4, prefill_buckets=(16, 32),
                                   checkpoint_path=root)
    mgr = EngineManager(tier, warmup_on_start=False, device="cpu")
    try:
        assert mgr.engine().generate("user: hello",
                                     max_new_tokens=4).gen_tokens >= 0
    finally:
        mgr.stop_server()


# -- pretrain ----------------------------------------------------------------------

def test_pretrain_takes_jaxs_dp_rule(presets, tmp_path):
    name = F32["nano_test"]
    kw = dict(batch_size=4, seq_len=16, max_steps=3, eval_every=50)
    logs = []
    res = pretrain.pretrain(name, str(tmp_path / "dp"), devices=["cpu"] * 3,
                            log=logs.append, **kw)
    # 3 slots: the largest count dividing the batch of 4 is 2.
    assert any("dp=2" in line for line in logs), logs
    ref = pretrain.pretrain(name, str(tmp_path / "one"), device="cpu",
                            log=lambda *_: None, **kw)
    assert res["steps"] == ref["steps"] == 3
    for a, b in zip(res["losses"], ref["losses"]):
        assert a == pytest.approx(b, rel=1e-5)
    assert ckpt.is_port_checkpoint(str(tmp_path / "dp"))


# -- the slice as a whole ----------------------------------------------------------

def test_dryrun_multichip_training_legs(presets, jax_runs, stream):
    """The three training legs of JAX's ``dryrun_multichip`` on 8 slots:
    a ``training_mesh`` step, a ``moe_training_mesh`` step and a pp=2
    step, each against JAX's first step on the same weights and batch."""
    legs = {}
    cfg = torch_config.MODEL_PRESETS[F32["nano_test"]]
    mesh = training_mesh(CPU8, num_kv_heads=cfg.num_kv_heads, seq_len=S)
    assert mesh.shape == dict(jax_mesh.training_mesh(
        num_kv_heads=cfg.num_kv_heads, seq_len=S).shape)
    legs["dense"] = (_port("nano_test", mesh, stream[:1])[0][0],
                     jax_runs("nano_test", tuple(mesh.dims)))
    moe_cfg = torch_config.MODEL_PRESETS[F32["moe_test"]]
    moe_mesh = moe_training_mesh(CPU8, num_experts=moe_cfg.num_experts)
    assert moe_mesh.shape == dict(jax_mesh.moe_training_mesh(
        num_experts=moe_cfg.num_experts).shape) == {"dp": 2, "ep": 4}
    legs["moe"] = (_port("moe_test", moe_mesh, stream[:1])[0][0],
                   jax_runs("moe_test"))
    pp = PipelineTrainer(cfg, trainer.TrainConfig(**KW),
                         DeviceGroup(tuple(CPU8[:2]), ("pp",)),
                         num_microbatches=2,
                         params=params_from_jax(cfg, _weights("nano_test")))
    # The pipeline's loss is the stack's: JAX's one-device first step.
    legs["pp"] = (pp.train_step(*stream[0]), jax_runs("nano_test"))
    for name, (got, (metrics, _, _)) in legs.items():
        assert np.isfinite(got["loss"]), name
        assert got["loss"] == pytest.approx(metrics[0]["loss"], rel=1e-5)
        assert got["grad_norm"] == pytest.approx(metrics[0]["grad_norm"],
                                                 rel=1e-4), name
