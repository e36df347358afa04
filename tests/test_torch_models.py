"""The port's model modules against the JAX package on the same weights and
inputs: attention, MPN, bi-LSTM, and SubGNNModel.forward at small widths
(__graft_entry__._build_flagship with D=16, n_nodes=64).

JAX parameters reach the port only through convert.params_from_jax.
Tolerance rtol=atol=1e-5 in float32: the same operations, summed in another
order by another matmul library.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as ge
from subgnn_tpu.models import attention as jattn
from subgnn_tpu.models import lstm as jlstm
from subgnn_tpu.models import mpn as jmpn
from subgnn_tpu.models.subgnn import CHANNEL_CC_KEYS
from subgnn_tpu.train.sims import compact_sims_for_batch as j_compact

from subgnn_tpu_torch.convert import params_from_jax
from subgnn_tpu_torch.models import attention as tattn
from subgnn_tpu_torch.models import lstm as tlstm
from subgnn_tpu_torch.models import mpn as tmpn
from subgnn_tpu_torch.models.subgnn import SubGNNModel as TModel
from subgnn_tpu_torch.train.sims import compact_sims_for_batch as t_compact

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, expect):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(expect),
                               **TOL)


# ------------------------------------------------------------- attention

def test_attention_modules_match_jax():
    rng = np.random.default_rng(0)
    B, R, D = 4, 5, 6
    vec = rng.normal(size=(B, D)).astype(np.float32)
    mat = rng.normal(size=(B, R, D)).astype(np.float32)
    mask = rng.random((B, R)) > 0.3
    p_np = _np(jattn.init_additive_attention(jax.random.PRNGKey(1), D, D))
    p_t, _ = params_from_jax(p_np, device="cpu")
    _close(tattn.masked_softmax(_t(vec[:, :R]), _t(mask)),
           jattn.masked_softmax(vec[:, :R], mask))
    _close(tattn.masked_softmax(_t(vec), None), jattn.masked_softmax(vec, None))
    w_t = tattn.additive_attention(p_t, _t(vec), _t(mat), _t(mask))
    w_j = jattn.additive_attention(p_np, vec, mat, mask)
    _close(w_t, w_j)
    _close(tattn.dot_product_attention(_t(vec), _t(mat), _t(mask)),
           jattn.dot_product_attention(vec, mat, mask))
    _close(tattn.dot_product_attention(_t(vec), _t(mat), normalize=False),
           jattn.dot_product_attention(vec, mat, normalize=False))
    _close(tattn.weighted_sum(_t(mat), w_t), jattn.weighted_sum(mat, w_j))
    _close(tattn.masked_sum(_t(mat), _t(mask[:, :, None]), axis=1),
           jattn.masked_sum(mat, mask[:, :, None], axis=1))


# ------------------------------------------------------------------- mpn

@pytest.mark.parametrize("layout", ["full", "per_subgraph", "shared"])
@pytest.mark.parametrize("norm", [False, True])
def test_mpn_messages_and_updates_match_jax(layout, norm):
    rng = np.random.default_rng(1)
    B, C, A, D = 3, 4, 5, 8
    emb_shape = {"full": (B, C, A, D), "per_subgraph": (B, A, D),
                 "shared": (A, D)}[layout]
    emb = rng.normal(size=emb_shape).astype(np.float32)
    sims = rng.integers(0, 5, (B, C, A)).astype(np.float32)
    valid = rng.random((B, C, A)) > 0.25
    cc = rng.normal(size=(B, C, D)).astype(np.float32)
    p_np = [_np(jmpn.init_mpn_params(jax.random.PRNGKey(k), D))
            for k in range(3)]
    p_t = [params_from_jax(p, device="cpu")[0] for p in p_np]

    agg_j, prop_j = jmpn.mpn_messages(p_np[0], emb, sims, valid,
                                      norm_pos_struc_embed=norm,
                                      layout=layout)
    agg_t, prop_t = tmpn.mpn_messages(p_t[0], _t(emb), _t(sims), _t(valid),
                                      norm_pos_struc_embed=norm,
                                      layout=layout)
    _close(agg_t, agg_j)
    _close(prop_t, prop_j)
    for proj in (True, False):
        _close(tmpn.mpn_update(p_t[0], _t(cc), agg_t,
                               use_mpn_projection=proj),
               jmpn.mpn_update(p_np[0], cc, agg_j, use_mpn_projection=proj))
    upd_j = jmpn.mpn_update_stacked(p_np, [cc] * 3, [agg_j] * 3)
    upd_t = tmpn.mpn_update_stacked(p_t, [_t(cc)] * 3, [agg_t] * 3)
    for a, b in zip(upd_t, upd_j):
        _close(a, b)
    lay_j = jmpn.mpn_layer(p_np[1], cc, emb, sims, valid, layout=layout,
                           norm_pos_struc_embed=norm)
    lay_t = tmpn.mpn_layer(p_t[1], _t(cc), _t(emb), _t(sims), _t(valid),
                           layout=layout, norm_pos_struc_embed=norm)
    for a, b in zip(lay_t, lay_j):
        _close(a, b)


# ------------------------------------------------------------------ lstm

@pytest.mark.parametrize("aggregator", ["last", "sum"])
@pytest.mark.parametrize("num_layers", [1, 2])
def test_lstm_forward_matches_jax(aggregator, num_layers):
    rng = np.random.default_rng(2)
    B, T, F = 12, 10, 8
    x = rng.normal(size=(B, T, F)).astype(np.float32)
    x[:3, 7:] = 0.0  # zero-padded walks stay unmasked (quirk)
    p_np = _np(jlstm.init_lstm_params(jax.random.PRNGKey(3), F, F,
                                      num_layers))
    p_t, _ = params_from_jax(p_np, device="cpu")
    _close(tlstm.lstm_forward(p_t, _t(x), aggregator=aggregator),
           jlstm.lstm_forward(p_np, jnp.asarray(x), aggregator=aggregator))


# ------------------------------------------------------------- the model

def _flagship(overrides):
    model, hp, params, state, batch, anchors = ge._build_flagship(
        n_nodes=64, n_sub=8, C=3, L=6, n_pool=12,
        hp_overrides=dict(node_embed_size=16, **overrides))
    rng = np.random.default_rng(4)
    params, state = _np(params), _np(state)
    if hp.batch_norm:
        # non-trivial running statistics and affine terms
        for k, s in state["bn"].items():
            s["mean"] = rng.normal(size=s["mean"].shape).astype(np.float32)
            s["var"] = rng.uniform(0.5, 2.0, s["var"].shape).astype(
                np.float32)
        for layer in params["channels"]["neighborhood"]:
            for side in ("bn_in", "bn_out"):
                layer[side]["scale"] = rng.uniform(
                    0.5, 1.5, layer[side]["scale"].shape).astype(np.float32)
                layer[side]["bias"] = rng.normal(
                    size=layer[side]["bias"].shape).astype(np.float32)
    return model, hp, params, state, _np(batch), _np(anchors)


CASES = {
    "full_np_sim": {},
    "compact_sims": {},
    "cc_max": {"cc_aggregator": "max"},
    "batch_norm": {"batch_norm": True},
    "trainable_cc": {"trainable_cc": True},
    "fused_ff_attn_lstm_sum": {"fused_channel_update": True, "ff_attn": True,
                               "lstm_aggregator": "sum",
                               "norm_pos_struc_embed": True},
}


@pytest.mark.parametrize("case", list(CASES))
def test_subgnn_forward_matches_jax(case):
    model, hp, params, state, batch, anchors = _flagship(CASES[case])
    B, C = batch["cc_ids"].shape[:2]
    cc_tables = None
    if hp.trainable_cc:
        rng = np.random.default_rng(5)
        cc_tables = {k: rng.normal(size=(B, C, hp.node_embed_size))
                     .astype(np.float32) for k in CHANNEL_CC_KEYS}
    if case == "compact_sims":
        comp = j_compact(batch["NP_sim"], anchors, hp, np.arange(B))
        comp_t = t_compact(batch["NP_sim"], anchors, hp, np.arange(B))
        for k in comp:
            np.testing.assert_array_equal(comp_t[k], comp[k])
        batch = {k: v for k, v in batch.items() if k != "NP_sim"}
        batch.update(comp)

    logits_j, _ = jax.jit(lambda p, s, b, a, cct: model.forward(
        p, s, b, a, train=False, rng=None, cc_tables=cct))(
        params, state, batch, anchors, cc_tables)

    tmodel = TModel(hp, model.n_nodes, model.num_classes, model.multilabel)
    p_t, s_t = params_from_jax(params, state, device="cpu")
    tb = {k: _t(v).long() if v.dtype.kind in "iu" else _t(v)
          for k, v in batch.items() if k in (
              "cc_ids", "subgraph_idx", "NP_sim", "I_S_sim", "B_S_sim",
              "neigh_sims", "pos_in_sims", "pos_out_sims")}
    ta = {k: _t(v).long() for k, v in anchors.items()}
    tcc = None if cc_tables is None else {k: _t(v) for k, v in
                                          cc_tables.items()}
    with torch.inference_mode():
        logits_t, _ = tmodel(p_t, s_t, tb, ta, cc_tables=tcc)
    assert logits_t.dtype == torch.float32
    _close(logits_t, logits_j)

    # the loss agrees too (eval batch with a padded row)
    labels = np.asarray(batch["label"])
    valid = np.ones(B, bool)
    valid[-1] = False
    np.testing.assert_allclose(
        tmodel.loss_fn(logits_t, _t(labels), _t(valid)).item(),
        float(model.loss_fn(logits_j, labels, valid)), **TOL)


def test_init_params_tree_matches_jax_layout():
    """A torch.Generator init builds the same tree (keys, shapes) as the
    JAX init, so JAX checkpoints load into it leaf for leaf."""
    model, hp, params, state, _, _ = _flagship({"batch_norm": True})
    tmodel = TModel(hp, model.n_nodes, model.num_classes, model.multilabel)
    embeds = np.random.default_rng(0).normal(
        size=(model.n_nodes, hp.node_embed_size)).astype(np.float32)
    p_t, s_t = tmodel.init_params(torch.Generator().manual_seed(0), embeds,
                                  device="cpu")
    shapes = lambda tree: jax.tree_util.tree_map(  # noqa: E731
        lambda x: tuple(np.shape(x)), tree)
    assert shapes(_np(p_t)) == shapes(params)
    assert shapes(_np(s_t)) == shapes(state)
    np.testing.assert_array_equal(p_t["node_embed"].numpy(),
                                  params["node_embed"])
    with pytest.raises(RuntimeError):
        TModel(hp, 64, 4, False).init_params(torch.Generator(), embeds)
