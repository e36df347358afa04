"""The port's node-embedding pretrainer (subgnn_tpu_torch/prepare/node_emb.py)
against the JAX package's, on the CPU.

The JAX functions run as their own tests run them (jit on the CPU); the
port gets the JAX parameters through convert.gnn_params_from_jax and the
JAX key sequence's draws (negatives, dropout keep-masks, walks,
permutations, thinning and exact-k uniforms) through ReplayDraws, drawn
here key by key as the JAX trainer splits them. Tolerances: forward 1e-5
(the same float32 sums in another order), loss and gradient leaves 1e-4 x
max|leaf|, AdamW 1e-6, whole trainer runs 1e-4 (losses rel, embeddings x
max|emb|, metrics abs).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from subgnn_tpu.data.graph import CSRGraph as JGraph
from subgnn_tpu.prepare import node_emb as J
from subgnn_tpu.prepare.synthetic import build_synthetic_dataset

from subgnn_tpu_torch.convert import gnn_params_from_jax
from subgnn_tpu_torch.data.graph import CSRGraph as TGraph
from subgnn_tpu_torch.ops import embedding as E
from subgnn_tpu_torch.prepare import node_emb as T

HIDDEN, OUT, DROPOUT = 32, 16, 0.4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _directed(g):
    n = g.n_nodes
    counts = np.diff(g.indptr[1:]).astype(np.int64)
    return (np.repeat(np.arange(n, dtype=np.int64), counts),
            (g.indices[g.indptr[1]:] - 1).astype(np.int64))


@pytest.fixture(scope="module")
def density(tmp_path_factory):
    """tests/test_e2e.py's density graph (n=120), in both packages."""
    task = tmp_path_factory.mktemp("density")
    build_synthetic_dataset(task, desired_property="density", seed=42,
                            n=120, m=3, n_subgraphs=40, n_subgraph_nodes=8,
                            max_tries=40)
    return (JGraph.from_edgelist(task / "edge_list.txt"),
            TGraph.from_edgelist(task / "edge_list.txt"))


@pytest.fixture(scope="module")
def small():
    """A 40-node random graph: (n, src, dst, degrees)."""
    rng = np.random.default_rng(3)
    edges = rng.integers(1, 41, (120, 2))
    edges = edges[edges[:, 0] != edges[:, 1]]
    g = TGraph.from_edges(edges, n_nodes=40)
    src, dst = _directed(g)
    return 40, src, dst, g.degrees[1:].astype(np.float32)


def _features(n, projected, rng):
    return (np.eye(n, dtype=np.float32) if projected
            else rng.normal(size=(n, 6)).astype(np.float32))


def _masks(variant, n, E, rng):
    member = edge_mask = None
    if variant == "member":
        member = (rng.random(n) < 0.6).astype(np.float32)
    elif variant == "edge_mask":
        edge_mask = (rng.random(E) < 0.5).astype(np.float32)
    return member, edge_mask


def _opt(a):
    return None if a is None else torch.as_tensor(a)


@pytest.mark.parametrize("conv", ["gin", "gcn"])
@pytest.mark.parametrize("variant", ["plain", "member", "edge_mask"])
@pytest.mark.parametrize("projected", [True, False])
def test_gnn_forward_matches_jax(small, conv, variant, projected):
    n, src, dst, deg = small
    rng = np.random.default_rng(0)
    x = _features(n, projected, rng)
    member, edge_mask = _masks(variant, n, len(src), rng)
    params = _np(J.init_gnn_params(jax.random.PRNGKey(1), x.shape[1], 16, 8))
    ref = J.gnn_forward(params, jnp.asarray(x), jnp.asarray(src),
                        jnp.asarray(dst), n, conv, jnp.asarray(deg),
                        member=None if member is None else jnp.asarray(member),
                        edge_mask=(None if edge_mask is None
                                   else jnp.asarray(edge_mask)))
    edges = T.EdgePlans(src, dst, n, "cpu")
    got = T.gnn_forward(gnn_params_from_jax(params, "cpu"),
                        torch.as_tensor(x), edges, conv, torch.as_tensor(deg),
                        member=_opt(member), edge_mask=_opt(edge_mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("conv", ["gin", "gcn"])
def test_chunked_spmm_and_nll_match_unchunked(small, conv):
    n, src, dst, deg = small
    rng = np.random.default_rng(1)
    x = torch.as_tensor(_features(n, True, rng))
    _, edge_mask = _masks("edge_mask", n, len(src), rng)
    params = gnn_params_from_jax(
        _np(J.init_gnn_params(jax.random.PRNGKey(2), n, 16, 8)), "cpu")
    pos = np.stack([src[src < dst], dst[src < dst]])
    w = torch.as_tensor(rng.random(pos.shape[1]).astype(np.float32))
    out = {}
    for chunk in (None, 7):
        edges = T.EdgePlans(src, dst, n, "cpu", chunk)
        ends = T.EdgeEndpoints(pos, n, "cpu", chunk)
        assert len(edges.chunks) == (1 if chunk is None
                                     else -(-len(src) // chunk))
        p = {k: {kk: vv.clone().requires_grad_() for kk, vv in v.items()}
             for k, v in params.items()}
        emb = T.gnn_forward(p, x, edges, conv, torch.as_tensor(deg),
                            edge_mask=torch.as_tensor(edge_mask))
        loss = T._positive_nll(emb, ends, w)
        grads = torch.autograd.grad(loss, [p["conv1"]["w"], p["conv2"]["w"]])
        out[chunk] = (emb.detach(), loss.detach(), grads)
    (e0, l0, g0), (e1, l1, g1) = out[None], out[7]
    torch.testing.assert_close(e1, e0, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(l1, l0, rtol=1e-5, atol=1e-5)
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, rtol=1e-5,
                                   atol=1e-5 * float(b.abs().max()))


def _jax_loss_fn(mode, x, src, dst, n, conv, deg, train_pos, neg, kd, *,
                 member=None, emask=None, w_neg=None):
    """The JAX trainer's loss_fn of `mode` (node_emb.py:484-490, :333-340,
    :573-587), unchunked."""
    def loss_fn(p):
        emb = J.gnn_forward(p, x, src, dst, n, conv, deg, dropout=DROPOUT,
                            train=True, rng=kd,
                            member=member if mode == "graphsaint" else None,
                            edge_mask=emask, edge_chunk=None)
        if mode == "full":
            return ((J._edge_nll(emb, train_pos, None, True, None)
                     + J._edge_nll(emb, neg, None, False, None))
                    / (train_pos.shape[1] + neg.shape[1]))
        if mode == "graphsaint":
            w_pos = member[train_pos[0]] * member[train_pos[1]]
            return ((J._edge_nll(emb, train_pos, w_pos, True, None)
                     + J._edge_nll(emb, neg, None, False, None))
                    / (w_pos.sum() + neg.shape[1]))
        seed_mask = member
        w_pos = seed_mask[train_pos[0]] + seed_mask[train_pos[1]]
        return ((J._edge_nll(emb, train_pos, w_pos, True, None)
                 + J._edge_nll(emb, neg, w_neg, False, None))
                / (w_pos.sum() + w_neg.sum() + 1e-7))
    return loss_fn


@pytest.mark.parametrize("conv", ["gin", "gcn"])
@pytest.mark.parametrize("mode", ["full", "graphsaint", "neighbor"])
def test_loss_and_gradients_match_jax(small, conv, mode):
    n, src, dst, deg = small
    rng = np.random.default_rng(4)
    x = _features(n, True, rng)
    params = _np(J.init_gnn_params(jax.random.PRNGKey(5), n, HIDDEN, OUT))
    train_pos = np.stack([src[src < dst], dst[src < dst]])
    neg = rng.integers(0, n, (2, 30))
    kd = jax.random.PRNGKey(6)
    keep = np.array(jax.random.bernoulli(kd, 1 - DROPOUT, (n, HIDDEN)))
    member = emask = w_neg = None
    if mode == "graphsaint":
        member = (rng.random(n) < 0.7).astype(np.float32)
    elif mode == "neighbor":
        member = (rng.random(n) < 0.3).astype(np.float32)    # the seeds
        emask = member[dst] * (rng.random(len(dst)) < 0.6)
        emask = emask.astype(np.float32)
        w_neg = (rng.random(30) < 0.8).astype(np.float32)
    j = {k: None if v is None else jnp.asarray(v)
         for k, v in dict(member=member, emask=emask, w_neg=w_neg).items()}
    loss_fn = _jax_loss_fn(mode, jnp.asarray(x), jnp.asarray(src),
                           jnp.asarray(dst), n, conv, jnp.asarray(deg),
                           jnp.asarray(train_pos), jnp.asarray(neg), kd,
                           member=j["member"], emask=j["emask"],
                           w_neg=j["w_neg"])
    ref_loss, ref_grads = jax.value_and_grad(loss_fn)(params)

    p = gnn_params_from_jax(params, "cpu")
    leaves = [p[k][kk].requires_grad_() for k in p for kk in p[k]]
    data = T.LinkData(torch.as_tensor(x), T.EdgePlans(src, dst, n, "cpu"),
                      torch.as_tensor(deg),
                      T.EdgeEndpoints(train_pos, n, "cpu"), conv, DROPOUT)
    tpos = torch.as_tensor(train_pos)
    kw = {}
    if mode == "graphsaint":
        m = torch.as_tensor(member)
        kw = dict(member=m, w_pos=m[tpos[0]] * m[tpos[1]])
    elif mode == "neighbor":
        m = torch.as_tensor(member)
        kw = dict(edge_mask=torch.as_tensor(emask),
                  w_pos=m[tpos[0]] + m[tpos[1]], w_neg=torch.as_tensor(w_neg))
    loss = T.link_loss(p, data, torch.as_tensor(neg),
                       lambda shape, rate: torch.as_tensor(keep), **kw)
    grads = torch.autograd.grad(loss, leaves)
    loss = float(loss.detach())
    assert abs(loss - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    ref_leaves = [ref_grads[k][kk] for k in p for kk in p[k]]
    for got, ref in zip(grads, ref_leaves):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max())


def test_adamw_matches_optax():
    rng = np.random.default_rng(7)
    shapes = {"conv1": {"w": (12, 8), "b": (8,)},
              "conv2": {"w": (8, 4), "b": (4,)}}
    params = {k: {kk: rng.normal(size=s).astype(np.float32)
                  for kk, s in v.items()} for k, v in shapes.items()}
    tx = optax.adamw(5e-3, weight_decay=5e-4)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jp)
    tp = gnn_params_from_jax(params, "cpu")
    opt = T.AdamW(5e-3, 5e-4)
    ostate = opt.init(tp)
    for _ in range(5):
        grads = {k: {kk: rng.normal(size=s).astype(np.float32)
                     for kk, s in v.items()} for k, v in shapes.items()}
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads),
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step(tp, [torch.as_tensor(grads[k][kk]) for k in tp
                      for kk in tp[k]], ostate)
        for k in tp:
            for kk in tp[k]:
                np.testing.assert_allclose(tp[k][kk].detach().numpy(),
                                           np.asarray(jp[k][kk]), rtol=0,
                                           atol=1e-6)


# ------------------------------------------------ whole runs against JAX

CASES = {
    "full_gin": dict(minibatch="full", conv_type="gin"),
    "full_gcn_ones": dict(minibatch="full", conv_type="gcn",
                          features="ones"),
    "graphsaint": dict(minibatch="graphsaint", conv_type="gin",
                       batch_size=16, walk_length=4, num_steps=3),
    "neighbor_thinned": dict(minibatch="neighbor", conv_type="gcn",
                             batch_size=16, nb_size=3),
    "neighbor_exact": dict(minibatch="neighbor", conv_type="gin",
                           batch_size=16, nb_size=3, nb_exact=True),
}
EPOCHS, SEED = 4, 0


def _jax_draws(g, kw, n_feat):
    """The JAX trainer's initial params and per-step draws for a run of
    EPOCHS epochs (one dispatch: every case here has EPOCHS <= its chunk),
    replaying its key splits (node_emb.py:442-443, :480, :318, :541, :594)."""
    n = g.n_nodes
    src, dst = _directed(g)
    n_tr = 8 * int((src < dst).sum()) // 10
    key = jax.random.PRNGKey(SEED)
    key, k = jax.random.split(key)
    params = _np(J.init_gnn_params(k, n_feat, HIDDEN, OUT))
    q = {"negatives": [], "keep": [], "uniform": [], "permutation": [],
         "walks": []}

    def neg_pair(k1, k2, count, high):
        q["negatives"].append(np.stack([
            np.asarray(jax.random.randint(k1, (count,), 0, high)),
            np.asarray(jax.random.randint(k2, (count,), 0, high))]))

    def keep(kd):
        q["keep"].append(np.asarray(
            jax.random.bernoulli(kd, 1 - DROPOUT, (n, HIDDEN))))

    rng = key
    mode = kw["minibatch"]
    if mode == "full":
        for _ in range(EPOCHS):
            rng, kd, kn1, kn2 = jax.random.split(rng, 4)
            neg_pair(kn1, kn2, max(n_tr // 4, 1), n)
            keep(kd)
    elif mode == "graphsaint":
        bs, wl = kw["batch_size"], kw["walk_length"]
        assert J.saint_dispatch_epochs(kw["num_steps"], len(src)) >= EPOCHS
        for _ in range(EPOCHS * kw["num_steps"]):
            rng, kw_, kd, kn1, kn2 = jax.random.split(rng, 5)
            q["walks"].append(np.asarray(J._plain_walks_device(
                jnp.asarray(g.indptr), jnp.asarray(g.indices),
                jnp.asarray(g.degrees.astype(np.int32)), kw_, walk_len=wl,
                n_walks=bs)))
            neg_pair(kn1, kn2, max(bs * wl // 8, 1), bs * wl)
            keep(kd)
    else:
        bs = kw["batch_size"]
        n_batches = -(-n // bs)
        assert max(1, 320 // n_batches) >= EPOCHS
        in_shape = J.build_in_edge_table(dst, n)[0].shape
        for _ in range(EPOCHS):
            rng, kp = jax.random.split(rng)
            q["permutation"].append(np.asarray(jax.random.permutation(kp, n)))
            for _ in range(n_batches):
                rng, kd, kt, kn1, kn2 = jax.random.split(rng, 5)
                keep(kd)
                if kw.get("nb_exact"):
                    q["uniform"].append(np.asarray(
                        jax.random.uniform(kt, in_shape)))
                else:
                    q["uniform"].append(np.asarray(
                        jax.random.uniform(kt, (len(dst),))))
                neg_pair(kn1, kn2, max(2 * n_tr * bs // (4 * n), 1), bs)
    return params, q


def _loss_history(monkeypatch, module):
    seen = []
    monkeypatch.setattr(module, "_save_plots",
                        lambda d, c, hist, curves: seen.append(list(hist)))
    return seen


@pytest.mark.parametrize("case", list(CASES))
def test_trainer_matches_jax(density, monkeypatch, tmp_path, case):
    jg, tg = density
    kw = dict(CASES[case], hidden=HIDDEN, out_dim=OUT, dropout=DROPOUT,
              epochs=EPOCHS, seed=SEED, plots_dir=tmp_path)
    j_hist = _loss_history(monkeypatch, J)
    t_hist = _loss_history(monkeypatch, T)
    emb_j, m_j = J.train_node_embeddings(jg, **kw)
    n_feat = 20 if kw.get("features") == "ones" else jg.n_nodes
    params, q = _jax_draws(jg, kw, n_feat)
    draws = T.ReplayDraws("cpu", **{
        "negatives": q["negatives"], "keep": q["keep"],
        "uniform": q["uniform"], "permutation": q["permutation"],
        "walks": q["walks"]})
    emb_t, m_t = T.train_node_embeddings(
        tg, device="cpu", params=gnn_params_from_jax(params, "cpu"),
        draws=draws, **kw)
    assert not any(draws._queues.values())      # every draw was used
    np.testing.assert_allclose(t_hist[0], j_hist[0], rtol=1e-4)
    assert m_t.pop("loss_history") == t_hist[0]
    assert emb_t.shape == emb_j.shape == (jg.n_nodes, OUT)
    np.testing.assert_allclose(emb_t, emb_j, rtol=0,
                               atol=1e-4 * np.abs(emb_j).max())
    assert m_t.keys() == m_j.keys()
    for k in m_j:
        assert abs(m_t[k] - m_j[k]) <= 1e-4 * max(1.0, abs(m_j[k])), k


def test_in_edge_table_and_exact_k_mask_match_jax(small):
    n, src, dst, _ = small
    dst_pad = np.concatenate([dst, [n, n]])          # excluded pad edges
    j_pos, j_valid = J.build_in_edge_table(dst_pad, n)
    t_pos, t_valid = T.build_in_edge_table(dst_pad, n)
    np.testing.assert_array_equal(t_pos, j_pos)
    np.testing.assert_array_equal(t_valid, j_valid)
    E = len(dst_pad)
    for k, seed in ((1, 0), (3, 1), (100, 2)):
        key = jax.random.PRNGKey(seed)
        ref = J.exact_k_edge_mask(key, jnp.asarray(j_pos),
                                  jnp.asarray(j_valid), k, E)
        u = torch.as_tensor(np.array(jax.random.uniform(key, j_pos.shape)))
        got = T.exact_k_edge_mask(u, t_pos, t_valid, k, E)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        kept = np.bincount(dst_pad[got.numpy() > 0], minlength=n + 1)[:n]
        np.testing.assert_array_equal(
            kept, np.minimum(k, np.bincount(dst, minlength=n)))


@pytest.mark.parametrize("minibatch,nb_size", [("full", None),
                                               ("graphsaint", None),
                                               ("neighbor", 5)])
def test_greedy_search_order_matches_jax(density, monkeypatch, minibatch,
                                         nb_size):
    jg, tg = density
    assert T.SEARCH_SPACES == J.SEARCH_SPACES
    calls = {}

    def fake(tag):
        def train(graph, **kw):
            calls.setdefault(tag, []).append(
                {k: v for k, v in kw.items() if k != "device"})
            key = repr(sorted((k, v) for k, v in kw.items()
                              if k != "device"))
            acc = np.random.default_rng(sum(map(ord, key))).random()
            return np.full((graph.n_nodes, 2), acc, np.float32), {
                "val_acc": float(acc), "val_auc": float(acc)}
        return train

    monkeypatch.setattr(J, "train_node_embeddings", fake("jax"))
    monkeypatch.setattr(T, "train_node_embeddings", fake("torch"))
    out_j = J.greedy_hyperparam_search(jg, minibatch=minibatch, epochs=3,
                                       seed=5, nb_size=nb_size)
    out_t = T.greedy_hyperparam_search(tg, minibatch=minibatch, epochs=3,
                                       seed=5, nb_size=nb_size, device="cpu")
    assert calls["torch"] == calls["jax"] and len(calls["jax"]) > 2
    np.testing.assert_array_equal(out_t[0], out_j[0])
    assert out_t[1:] == out_j[1:]


def test_save_embeddings_and_plots(density, tmp_path):
    _, tg = density
    emb, metrics = T.train_node_embeddings(
        tg, hidden=16, out_dim=8, epochs=3, seed=0, device="cpu",
        plots_dir=tmp_path / "plots")
    assert np.isfinite(emb).all() and emb.dtype == np.float32
    assert (tmp_path / "plots" / "gin_loss_curve.png").exists()
    assert (tmp_path / "plots" / "gin_roc_curve.png").exists()
    for conv, name in (("gin", "gin"), ("graphsaint_gcn", "graphsaint_gcn")):
        T.save_embeddings(tmp_path, emb, conv)
        np.testing.assert_array_equal(
            np.load(tmp_path / f"{name}_embeddings.npy"), emb)
        pth = torch.load(tmp_path / f"{name}_embeddings.pth")
        assert pth.dtype == torch.float32
        np.testing.assert_array_equal(pth.numpy(), emb)


@pytest.mark.parametrize("minibatch,conv,features", [
    ("full", "gin", "one_hot"), ("full", "gcn", "ones"),
    ("graphsaint", "gcn", "one_hot"), ("neighbor", "gcn", "ones"),
    ("neighbor", "gin", "one_hot")])
def test_spmm_launches_per_step(density, monkeypatch, minibatch, conv,
                                features):
    """segment_matmul calls per step and per eval forward equal
    spmm_launches', chunked (a small EDGE_CHUNK), counted through the
    wrapper the CUDA path increments."""
    _, tg = density
    count = [0]
    plain = E.segment_matmul

    def counted(*a, **k):
        count[0] += 1
        return plain(*a, **k)

    monkeypatch.setattr(E, "segment_matmul", counted)
    monkeypatch.setattr(T, "segment_matmul", counted)
    monkeypatch.setattr(T, "EDGE_CHUNK", 150)
    epochs, steps = 2, 3
    T.train_node_embeddings(tg, conv_type=conv, features=features,
                            minibatch=minibatch, hidden=HIDDEN, out_dim=OUT,
                            epochs=epochs, num_steps=steps, batch_size=40,
                            walk_length=4, device="cpu")
    src, dst = _directed(tg)
    n_tr = 8 * int((src < dst).sum()) // 10
    n_feat = tg.n_nodes if features == "one_hot" else 20
    want = T.spmm_launches(len(src), n_tr, conv_type=conv,
                           minibatch=minibatch, projected=n_feat > HIDDEN,
                           chunk=150)
    n_steps = {"full": 1, "graphsaint": steps,
               "neighbor": -(-tg.n_nodes // 40)}[minibatch] * epochs
    assert -(-len(src) // 150) > 1 and -(-n_tr // 150) > 1
    assert count[0] == n_steps * want["step"] + want["eval"]


def test_projection_features_and_default_draws(density, monkeypatch):
    """Above ONE_HOT_MAX_NODES the features are the fixed random
    projection; a run on the port's own draws is reproducible bit for bit."""
    _, tg = density
    monkeypatch.setattr(T, "ONE_HOT_MAX_NODES", 50)
    x = T._features("one_hot", tg.n_nodes, "cpu")
    assert x.shape == (tg.n_nodes, T.PROJECTION_DIM)
    torch.testing.assert_close(x, T._features("one_hot", tg.n_nodes, "cpu"),
                               rtol=0, atol=0)
    runs = [T.train_node_embeddings(tg, hidden=HIDDEN, out_dim=OUT, epochs=3,
                                    seed=1, minibatch="graphsaint",
                                    batch_size=8, walk_length=4, num_steps=2,
                                    device="cpu") for _ in range(2)]
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    assert runs[0][1] == runs[1][1]
    assert np.isfinite(runs[0][0]).all()
    if not torch.cuda.is_available():      # the default device is cuda
        with pytest.raises(RuntimeError, match="cuda"):
            T.train_node_embeddings(tg, epochs=1)


def test_binary_auc_matches_jax():
    """The port's vectorized tie-averaged AUC equals the JAX package's
    loop, ties and NaN scores included."""
    from subgnn_tpu.train.metrics import binary_auc as j_auc
    from subgnn_tpu_torch.train.metrics import binary_auc as t_auc
    rng = np.random.default_rng(9)
    for i in range(60):
        n = int(rng.integers(2, 200))
        y = rng.random(n) < 0.4
        s = (rng.integers(0, 5, n).astype(np.float32) if i % 2
             else rng.random(n).astype(np.float32))
        if i % 7 == 0:
            s[rng.integers(0, n)] = np.nan
        a, b = t_auc(y, s), j_auc(y, s)
        assert a == b or (np.isnan(a) and np.isnan(b))
