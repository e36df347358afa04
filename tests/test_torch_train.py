"""The port's training path against the JAX package's on the same weights
and inputs: the training forward (batch norm with running-stat updates,
dropout replayed from JAX's key sequence), loss and gradients through the
gather plans, one optimizer step, Trainer.fit over 2 epochs, and a
checkpoint the port writes read back by the JAX package.

JAX parameters reach the port only through convert.params_from_jax.
Tolerances: forward rtol=atol=1e-5 and gradients atol 1e-4 in float32 (the
same operations, summed in another order by another library); Adam 1e-6
(the same update formula, rounded in another order); Trainer.fit rtol 1e-4
(two epochs of such steps).
"""
import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as ge
from subgnn_tpu.ops.embedding import make_gather_plan as j_plan
from subgnn_tpu.train import checkpoint as jckpt
from subgnn_tpu.train.loop import Trainer as JTrainer
from subgnn_tpu.train.loop import make_optimizer as j_make_optimizer
from subgnn_tpu.train.plans import neigh_ids_for_batch

from subgnn_tpu_torch.bench import build_flagship, build_training_fixture
from subgnn_tpu_torch.config import HParams
from subgnn_tpu_torch.convert import params_from_jax
from subgnn_tpu_torch.models.subgnn import SubGNNModel as TModel
from subgnn_tpu_torch.ops import embedding as T
from subgnn_tpu_torch.train.checkpoint import to_numpy
from subgnn_tpu_torch.train.loop import (Trainer, device_batch,
                                         loss_and_grads, make_optimizer,
                                         tree_leaves)

FWD_TOL = dict(rtol=1e-5, atol=1e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


CASES = {
    "plain": dict(),
    "batch_norm": dict(batch_norm=True),
    "lstm2_dropout": dict(lstm_n_layers=2, lstm_dropout=0.3),
    "head_dropout_bn": dict(lin_dropout=0.3, batch_norm=True),
    "all": dict(batch_norm=True, lstm_n_layers=2, lstm_dropout=0.3,
                lin_dropout=0.3),
}


def _setup(overrides, plans=True):
    """JAX flagship at small widths with non-trivial BN state, a masked
    last row, and (optionally) gather plans for both packages."""
    model, hp, params, state, batch, anchors = ge._build_flagship(
        n_nodes=300, n_sub=8, C=3, L=6, n_pool=12,
        hp_overrides=dict(node_embed_size=16, **overrides))
    params, state, batch, anchors = (_np(params), _np(state), _np(batch),
                                     _np(anchors))
    rng = np.random.default_rng(4)
    if hp.batch_norm:
        for s in state["bn"].values():
            s["mean"] = rng.normal(size=s["mean"].shape).astype(np.float32)
            s["var"] = rng.uniform(0.5, 2.0, s["var"].shape).astype(
                np.float32)
    batch["valid"] = np.arange(8) < 7
    tbatch = {k: v for k, v in batch.items()}
    if plans:
        n_rows = params["node_embed"].shape[0]
        neigh = neigh_ids_for_batch(anchors, np.arange(8))
        batch["cc_plan"] = j_plan(batch["cc_ids"], n_rows)
        batch["neigh_plan"] = j_plan(neigh, n_rows)
        tbatch["cc_plan"] = T.make_gather_plan(batch["cc_ids"], n_rows)
        tbatch["neigh_plan"] = T.make_gather_plan(neigh, n_rows)
    tmodel = TModel(hp, model.n_nodes, model.num_classes, model.multilabel)
    p_t, s_t = params_from_jax(params, state, device="cpu")
    return (model, hp, params, state, batch, anchors, tmodel, p_t, s_t,
            device_batch(tbatch, "cpu"), device_batch(anchors, "cpu"))


def _jax_masks(hp, key, n_walks, B):
    """JAX's dropout masks in draw order (models/subgnn.py: the structure
    LSTM's key is split off first, its inner layers draw in layer order,
    then the two head layers)."""
    masks = []
    rng = key
    if hp.use_structure:
        rng, r_lstm = jax.random.split(rng)
        if hp.lstm_dropout > 0:
            for _ in range(hp.lstm_n_layers - 1):
                r_lstm, sub = jax.random.split(r_lstm)
                masks.append(jax.random.bernoulli(
                    sub, 1.0 - hp.lstm_dropout,
                    (n_walks, hp.random_walk_len, 2 * hp.node_embed_size)))
    if hp.lin_dropout > 0:
        for width in (hp.linear_hidden_dim_1, hp.linear_hidden_dim_2):
            rng, sub = jax.random.split(rng)
            masks.append(jax.random.bernoulli(sub, 1.0 - hp.lin_dropout,
                                              (B, width)))
    return [np.array(m) for m in masks]


def _replay(masks):
    it = iter(masks)

    def keep_mask(shape, rate):
        m = next(it)
        assert m.shape == tuple(shape)
        return torch.from_numpy(m)
    return keep_mask


def _n_walks(hp):
    return (2 * hp.n_layers * hp.n_anchor_patches_structure
            * hp.n_triangular_walks)


@pytest.mark.parametrize("case", list(CASES))
def test_training_forward_matches_jax(case):
    (model, hp, params, state, batch, anchors, tmodel, p_t, s_t, tb,
     ta) = _setup(CASES[case])
    key = jax.random.PRNGKey(7)
    logits_j, state_j = jax.jit(lambda p, s, b, a: model.forward(
        p, s, b, a, train=True, rng=key))(params, state, batch, anchors)
    masks = _jax_masks(hp, key, _n_walks(hp), 8)
    logits_t, state_t = tmodel(p_t, s_t, tb, ta, train=True,
                               keep_mask=_replay(masks))
    np.testing.assert_allclose(logits_t.detach().numpy(),
                               np.asarray(logits_j), **FWD_TOL)
    assert set(state_t) == set(state_j)
    for k, v in _np(state_j).get("bn", {}).items():
        for stat in ("mean", "var"):
            np.testing.assert_allclose(state_t["bn"][k][stat].numpy(),
                                       v[stat], **FWD_TOL, err_msg=k)
    if hp.batch_norm:   # the running stats moved
        k0 = next(iter(state["bn"]))
        assert not np.allclose(state["bn"][k0]["mean"],
                               state_t["bn"][k0]["mean"].numpy())


def test_training_forward_needs_a_keep_mask_for_dropout():
    *_, tmodel, p_t, s_t, tb, ta = _setup(CASES["head_dropout_bn"])
    with pytest.raises(ValueError, match="keep_mask"):
        tmodel(p_t, s_t, tb, ta, train=True)


@pytest.mark.parametrize("case,plans", [("plain", False), ("batch_norm", True),
                                        ("all", True)])
def test_loss_and_grads_match_jax(case, plans):
    (model, hp, params, state, batch, anchors, tmodel, p_t, s_t, tb,
     ta) = _setup(CASES[case], plans)
    key = jax.random.PRNGKey(3)

    def loss_fn(p):
        logits, _ = model.forward(p, state, batch, anchors, train=True,
                                  rng=key)
        return model.loss_fn(logits, batch["label"], batch["valid"])

    loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(params)
    tx = make_optimizer(hp)
    tx.init(p_t)
    loss_t, _, _, grads_t = loss_and_grads(
        tmodel, tx, p_t, s_t, tb, ta,
        _replay(_jax_masks(hp, key, _n_walks(hp), 8)))
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    leaves_j = jax.tree_util.tree_leaves_with_path(grads_j)
    assert len(leaves_j) == len(grads_t)
    for (path, gj), gt in zip(leaves_j, grads_t):
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))
    # the table gradient went through the plans and is not trivial
    i = next(i for i, x in enumerate(tree_leaves(p_t))
             if x is p_t["node_embed"])
    assert float(grads_t[i].abs().sum()) > 0


@pytest.mark.parametrize("grad_clip,freeze", [(0.0, False), (0.5, True),
                                              (1e6, False)])
def test_optimizer_steps_match_optax(grad_clip, freeze):
    rng = np.random.default_rng(5)
    shapes = {"channels": [{"w": (6, 4), "b": (4,)}, {"w": (4, 2)}],
              "head": {"b": (3,), "w": (5, 3)}, "node_embed": (20, 4)}
    make = lambda: jax.tree_util.tree_map(  # noqa: E731
        lambda s: rng.normal(size=s).astype(np.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple))
    params = _np(jax.tree_util.tree_map(jnp.asarray, make()))
    grads = [_np(jax.tree_util.tree_map(jnp.asarray, make()))
             for _ in range(3)]
    hp = HParams(learning_rate=1e-2, grad_clip=grad_clip,
                 freeze_node_embeds=freeze)

    jtx = j_make_optimizer(hp)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jst = jtx.init(jp)
    tx = make_optimizer(hp)
    tp, _ = params_from_jax(params, device="cpu")
    tst = tx.init(tp)
    for g in grads:
        upd, jst = jtx.update(jax.tree_util.tree_map(jnp.asarray, g), jst,
                              jp)
        jp = optax.apply_updates(jp, upd)
        tg, _ = params_from_jax(g, device="cpu")
        tx.step(tp, tx.trainable(tg), tst)
    assert tst["count"] == 3
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jp),
                            tree_leaves(tp)):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   rtol=1e-6, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))
    if freeze:
        np.testing.assert_array_equal(tp["node_embed"].detach().numpy(),
                                      params["node_embed"])
        assert not tp["node_embed"].requires_grad
        assert len(tst["mu"]) == len(tree_leaves(tp)) - 1


def _fixtures(trainable_cc):
    over = dict(trainable_cc=trainable_cc)
    j = ge._build_training_fixture(hp_overrides=over)
    t = build_training_fixture(hp_overrides=over, device="cpu")
    return j, t


@pytest.mark.parametrize("trainable_cc", [False, True])
def test_fit_matches_jax(trainable_cc, tmp_path):
    ((jmodel, jhp, jparams, jstate, jdata, janchors, jeval),
     (tmodel, thp, _, _, tdata, tanchors, teval)) = _fixtures(trainable_cc)
    # the port's fixture draws the same data as the JAX one
    assert thp.to_dict() == jhp.to_dict()
    for split in ("train", "val"):
        for name in ("cc_ids", "labels", "NP_sim", "I_S_sim", "B_S_sim"):
            np.testing.assert_array_equal(getattr(tdata[split], name),
                                          getattr(jdata[split], name))
        for k, v in janchors[split].items():
            np.testing.assert_array_equal(tanchors[split][k], np.asarray(v))

    jtr = JTrainer(jmodel, jhp, eval_cc_tables=jeval)
    jtr.fit(jparams, jstate, jdata["train"], jdata["val"], janchors, seed=0,
            log_fn=None)
    p_t, s_t = params_from_jax(_np(jparams), _np(jstate), device="cpu")
    ttr = Trainer(tmodel, thp, eval_cc_tables=teval, device="cpu",
                  ckpt_dir=str(tmp_path))
    last = ttr.fit(p_t, s_t, tdata["train"], tdata["val"], tanchors, seed=0,
                   log_fn=None)
    assert len(ttr.metric_scores) == len(jtr.metric_scores) == 2
    for mt, mj in zip(ttr.metric_scores, jtr.metric_scores):
        for k in ("train_loss", "val_loss", "val_micro_f1", "val_acc"):
            np.testing.assert_allclose(mt[k], mj[k], rtol=1e-4, err_msg=k)
    assert last is ttr.metric_scores[-1]
    assert ttr.ckpt.best_path is not None and ttr.ckpt.best_path.exists()
    # the caller's parameters were not trained in place
    np.testing.assert_array_equal(p_t["node_embed"].numpy(),
                                  np.asarray(jparams["node_embed"]))


def test_port_checkpoint_loads_into_the_jax_tree(tmp_path):
    (jmodel, jhp, jparams, jstate, *_), (tmodel, thp, _, _, tdata,
                                         tanchors, teval) = _fixtures(False)
    p_t, s_t = params_from_jax(_np(jparams), _np(jstate), device="cpu")
    ttr = Trainer(tmodel, thp.replace(max_epochs=1), device="cpu",
                  ckpt_dir=str(tmp_path))
    ttr.fit(p_t, s_t, tdata["train"], tdata["val"], tanchors, seed=0,
            log_fn=None)
    path = ttr.ckpt.best_path
    payload = jckpt.load_checkpoint(path)
    assert payload["meta"]["epoch"] == 0
    assert payload["meta"]["global_step"] == ttr.global_step == 2
    restored = jckpt.load_params_filtered(path, jparams, payload=payload)
    trained = to_numpy(ttr.params)
    got = jax.tree_util.tree_leaves_with_path(restored)
    assert len(got) == len(tree_leaves(ttr.params))
    for (kp, a), b in zip(got, jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(np.asarray, trained))):
        np.testing.assert_array_equal(np.asarray(a), b,
                                      err_msg=jax.tree_util.keystr(kp))
    # a training step changed the table; the JAX forward runs on the result
    assert not np.array_equal(np.asarray(restored["node_embed"]),
                              np.asarray(jparams["node_embed"]))
    assert payload["opt_state"]["count"] == 2


def test_build_flagship_matches_jax():
    j = ge._build_flagship(n_nodes=100, n_sub=6, C=3, L=5, n_pool=9)
    t = build_flagship(n_nodes=100, n_sub=6, C=3, L=5, n_pool=9,
                       device="cpu")
    assert t[1].to_dict() == j[1].to_dict()
    for k, v in j[4].items():
        np.testing.assert_array_equal(t[4][k], np.asarray(v), k)
    for k, v in j[5].items():
        np.testing.assert_array_equal(t[5][k], np.asarray(v), k)
    np.testing.assert_array_equal(t[2]["node_embed"].numpy(),
                                  np.asarray(j[2]["node_embed"]))
