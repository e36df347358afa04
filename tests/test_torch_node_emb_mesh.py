"""The node-embedding pretrainer on a mesh (train_node_embeddings(mesh=),
subgnn_tpu_torch/prepare/node_emb.py) on the CPU: the directed edges split
over the ranks, each rank summing its block's messages, the partial node
sums and the SpMM's input gradient all-reduced over the whole group
(parallel/mesh.py:sum_over_world, copy_to_world).

Ranks are gloo processes spawned by tests/test_torch_mesh.py's `_spawn`:
one spawn of a (1, 2) mesh and one of a (2, 2) mesh, each running every
case. The counterpart of the JAX package's
tests/test_parallel.py:357-380 (its 120-node BA graph, hidden 16, out 8,
5 epochs): full, GraphSAINT and exact-k neighbor mode, GIN and GCN (and
GCN on all-ones features, where layer 1 aggregates before it projects, and
neighbor mode thinned i.i.d., held against one process only).
Every case replays the JAX key sequence's draws (ReplayDraws) from the
JAX package's initial parameters, so the port's mesh runs are held against
the port's one-process run and against JAX's
train_node_embeddings(mesh=make_device_mesh(4, 2)) on tests/conftest.py's
8 host devices. Plus the world collectives' calls and bytes, exactly, and
a rank whose block of the edges is empty.

Tolerances: the JAX mesh test's own, atol 2e-4 / rtol 1e-4 on the
embeddings and 1e-4 on final_loss (the same sums split over ranks and
added in another order); per-epoch losses rtol 1e-4.

No JAX at module level: the spawned ranks import this module.
"""
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

from subgnn_tpu_torch.convert import gnn_params_from_jax
from subgnn_tpu_torch.data.graph import CSRGraph
from subgnn_tpu_torch.ops import embedding as E
from subgnn_tpu_torch.parallel import mesh as MX
from subgnn_tpu_torch.prepare import node_emb as T
from tests.test_torch_mesh import _spawn

EPOCHS, SEED, OUT, DROPOUT = 5, 0, 8, 0.4
CASES = {
    "full_gin": dict(minibatch="full", conv_type="gin"),
    "full_gcn": dict(minibatch="full", conv_type="gcn"),
    "full_gcn_ones": dict(minibatch="full", conv_type="gcn",
                          features="ones", hidden=32),
    "saint_gin": dict(minibatch="graphsaint", conv_type="gin",
                      batch_size=8, walk_length=4, num_steps=3),
    "saint_gcn": dict(minibatch="graphsaint", conv_type="gcn",
                      batch_size=8, walk_length=4, num_steps=3),
    "neighbor_gin": dict(minibatch="neighbor", conv_type="gin",
                         batch_size=32, nb_size=3, nb_exact=True),
    "neighbor_gcn": dict(minibatch="neighbor", conv_type="gcn",
                         batch_size=32, nb_size=3, nb_exact=True),
    "neighbor_gin_iid": dict(minibatch="neighbor", conv_type="gin",
                             batch_size=32, nb_size=3),
}
# JAX's mesh draws the i.i.d. thinning uniforms over its padded edge array,
# which another shape changes (threefry), so that case has no JAX twin
JAX_CASES = [c for c in CASES if c != "neighbor_gin_iid"]
# (world, n_node): a (1, 2) and a (2, 2) mesh
WORLDS = {2: 2, 4: 2}


def _kw(case):
    return dict({"hidden": 16}, **CASES[case], out_dim=OUT, dropout=DROPOUT,
                epochs=EPOCHS, seed=SEED)


def _ba_edges():
    """tests/test_parallel.py:368-370's graph, 1-based edges."""
    import networkx as nx
    g = nx.barabasi_albert_graph(120, 3, seed=0)
    return np.asarray(list(g.edges()), dtype=np.int64) + 1


def _graph():
    return CSRGraph.from_edges(_ba_edges(), n_nodes=120)


# ------------------------------------------------------- the JAX draws

def _jax_draws(jg, kw):
    """The JAX trainer's initial params and per-step draws for EPOCHS
    epochs in one dispatch, replaying its key splits
    (subgnn_tpu/prepare/node_emb.py:442-443, :480, :318, :541, :594)."""
    import jax
    import jax.numpy as jnp
    from subgnn_tpu.prepare import node_emb as J
    n = jg.n_nodes
    counts = np.diff(jg.indptr[1:]).astype(np.int64)
    src = np.repeat(np.arange(n, dtype=np.int64), counts)
    dst = (jg.indices[jg.indptr[1]:] - 1).astype(np.int64)
    n_tr = 8 * int((src < dst).sum()) // 10
    hidden = kw["hidden"]
    n_feat = 20 if kw.get("features") == "ones" else n
    key = jax.random.PRNGKey(SEED)
    key, k = jax.random.split(key)
    params = jax.tree_util.tree_map(
        np.asarray, J.init_gnn_params(k, n_feat, hidden, OUT))
    q = {"negatives": [], "keep": [], "uniform": [], "permutation": [],
         "walks": []}

    def neg_pair(k1, k2, count, high):
        q["negatives"].append(np.stack([
            np.asarray(jax.random.randint(k1, (count,), 0, high)),
            np.asarray(jax.random.randint(k2, (count,), 0, high))]))

    def keep(kd):
        q["keep"].append(np.asarray(
            jax.random.bernoulli(kd, 1 - DROPOUT, (n, hidden))))

    rng = key
    mode = kw["minibatch"]
    if mode == "full":
        for _ in range(EPOCHS):
            rng, kd, kn1, kn2 = jax.random.split(rng, 4)
            neg_pair(kn1, kn2, max(n_tr // 4, 1), n)
            keep(kd)
    elif mode == "graphsaint":
        bs, wl = kw["batch_size"], kw["walk_length"]
        # one dispatch also on JAX's mesh, whose edges are padded to 8
        assert J.saint_dispatch_epochs(kw["num_steps"],
                                       len(src) + 8) >= EPOCHS
        for _ in range(EPOCHS * kw["num_steps"]):
            rng, kw_, kd, kn1, kn2 = jax.random.split(rng, 5)
            q["walks"].append(np.asarray(J._plain_walks_device(
                jnp.asarray(jg.indptr), jnp.asarray(jg.indices),
                jnp.asarray(jg.degrees.astype(np.int32)), kw_, walk_len=wl,
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
                q["uniform"].append(np.asarray(jax.random.uniform(
                    kt, in_shape if kw.get("nb_exact") else (len(dst),))))
                neg_pair(kn1, kn2, max(2 * n_tr * bs // (4 * n), 1), bs)
    return params, q


def _port_run(case, inputs, mesh=None):
    """train_node_embeddings on the CPU from the JAX draws, with the world
    collectives it made: (emb, metrics, {name: (calls, bytes)})."""
    params, q = inputs[case]
    draws = T.ReplayDraws("cpu", **q)
    MX.reset_counts()
    emb, metrics = T.train_node_embeddings(
        _graph(), device="cpu", params=gnn_params_from_jax(params, "cpu"),
        draws=draws, mesh=mesh, **_kw(case))
    assert not any(draws._queues.values())      # every draw was used
    return emb, metrics, {h.__name__: (h.calls, h.bytes)
                          for h in MX.COLLECTIVES if h.calls}


# --------------------------------------------------------------- the jobs

def _job_cases(rank, tmp, mesh):
    with open(Path(tmp) / "inputs.pkl", "rb") as f:
        inputs = pickle.load(f)
    return {case: _port_run(case, inputs, mesh) for case in CASES}


LAUNCH_CHUNK = 150           # EDGE_CHUNK in the launch job: several chunks
LAUNCH_CASES = ("full_gin", "neighbor_gcn", "full_gcn_ones")


def _job_launches(rank, tmp, mesh):
    """segment_matmul calls a run makes on this rank, counted through the
    wrapper the CUDA path increments, with EDGE_CHUNK cut to LAUNCH_CHUNK:
    {case: (calls, this rank's block of the edges)}."""
    with open(Path(tmp) / "inputs.pkl", "rb") as f:
        inputs = pickle.load(f)
    count = [0]
    plain, chunk = E.segment_matmul, T.EDGE_CHUNK

    def counted(*a, **k):
        count[0] += 1
        return plain(*a, **k)

    E.segment_matmul = T.segment_matmul = counted
    T.EDGE_CHUNK = LAUNCH_CHUNK
    try:
        out = {}
        for case in LAUNCH_CASES:
            count[0] = 0
            _port_run(case, inputs, mesh)
            out[case] = (count[0], mesh.world_block(
                len(T._directed_edges(_graph())[0])))
    finally:
        E.segment_matmul = T.segment_matmul = plain
        T.EDGE_CHUNK = chunk
    return out


def _empty_block_inputs():
    """3 undirected edges on 5 nodes: 6 directed edges, blocks of 2 over 4
    ranks, the last one empty."""
    g = CSRGraph.from_edges(np.array([[1, 2], [2, 3], [4, 5]]), n_nodes=5)
    src, dst = T._directed_edges(g)
    rng = np.random.default_rng(4)
    params = T.init_gnn_params(torch.Generator().manual_seed(0), 5, 4, 3)
    member = torch.as_tensor((rng.random(5) < 0.8).astype(np.float32))
    return g, src, dst, params, member


def _job_empty_block(rank, tmp, mesh):
    """gnn_forward and the gradients of a loss through it, GIN and GCN on
    a member mask (its sample degrees summed over the ranks), with this
    rank's block of the edges (empty on rank 3 of 4)."""
    return _empty_block_grads(mesh)


def _empty_block_grads(mesh):
    g, src, dst, params, member = _empty_block_inputs()
    edges = T.EdgePlans(src, dst, 5, "cpu", T.EDGE_CHUNK, mesh)
    x = torch.eye(5)
    out = {"block": (edges.lo, edges.hi)}
    for conv, m in (("gin", None), ("gcn", member)):
        p = {k: {n: v.clone().requires_grad_() for n, v in layer.items()}
             for k, layer in params.items()}
        MX.reset_counts()
        emb = T.gnn_forward(p, x, edges, conv,
                            torch.as_tensor(g.degrees[1:], dtype=torch.float32),
                            member=m)
        leaves = [v for layer in p.values() for v in layer.values()]
        grads = torch.autograd.grad((emb * emb).sum(), leaves)
        out[conv] = (emb.detach().numpy(), [gr.numpy() for gr in grads],
                     {h.__name__: (h.calls, h.bytes)
                      for h in MX.COLLECTIVES if h.calls})
    return out


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The JAX draws (made here) handed to a (1, 2) and a (2, 2) spawn, and
    the one-process references."""
    from subgnn_tpu.data.graph import CSRGraph as JGraph
    jg = JGraph.from_edges(_ba_edges(), n_nodes=120)
    inputs = {case: _jax_draws(jg, _kw(case)) for case in CASES}
    out = {"inputs": inputs, "jg": jg}
    for world, n_node in WORLDS.items():
        tmp = tmp_path_factory.mktemp(f"world{world}")
        with open(tmp / "inputs.pkl", "wb") as f:
            pickle.dump(inputs, f)
        jobs = {"cases": _job_cases, "launches": _job_launches}
        if world == 4:
            jobs["empty_block"] = _job_empty_block
        out[world] = _spawn(world, tmp, jobs, n_node)
    return out


def _close(got, want):
    emb, m = got[:2]
    emb_w, m_w = want[:2]
    np.testing.assert_allclose(emb, emb_w, atol=2e-4, rtol=1e-4)
    assert abs(m["final_loss"] - m_w["final_loss"]) < 1e-4
    if "loss_history" in m_w:
        np.testing.assert_allclose(m["loss_history"], m_w["loss_history"],
                                   rtol=1e-4)


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("case", list(CASES))
def test_mesh_pretrainer_matches_one_process(spawned, case, world):
    """Every rank of a (1, 2) and a (2, 2) mesh returns the one-process
    run's embeddings and metrics, and the ranks return the same."""
    one = _port_run(case, spawned["inputs"])
    assert one[2] == {}             # no collective without a mesh
    ranks = [r[case] for r in spawned[world]["cases"]]
    for r in ranks:
        _close(r, one)
        assert r[1].keys() == one[1].keys()
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[0], ranks[0][0])
        assert r[1] == ranks[0][1]


@pytest.mark.parametrize("case", JAX_CASES)
def test_mesh_pretrainer_matches_jax_mesh(spawned, case):
    """The (2, 2) mesh's run against JAX's train_node_embeddings on a (4, 2)
    mesh of the 8 host devices, its edges sharded over all of them: the
    same keys, whose draws the port replays."""
    from subgnn_tpu.parallel.mesh import make_device_mesh
    from subgnn_tpu.prepare import node_emb as J
    emb_j, m_j = J.train_node_embeddings(
        spawned["jg"], mesh=make_device_mesh(n_data=4, n_node=2),
        **_kw(case))
    got = spawned[4]["cases"][0][case]
    _close(got, (emb_j, m_j))
    for k in m_j:
        assert abs(got[1][k] - m_j[k]) <= 1e-4 * max(1.0, abs(m_j[k])), k


def _expected_counts(case, n_nodes=120):
    """The world collectives of a run, from the design: each forward sums
    two layers over the world (sum_over_world: n x the layer's input width,
    layer 1's the hidden width when it projects first, else the features'),
    each step's backward all-reduces the SpMM input gradient of layer 2 and
    of a projected layer 1 (copy_to_world: n x hidden), and GCN's sample
    degrees outside full mode are summed once a step (all_reduce_world_:
    n). The final eval forward adds two sums."""
    kw = _kw(case)
    hidden = kw["hidden"]
    n_feat = 20 if kw.get("features") == "ones" else n_nodes
    projected = n_feat > hidden
    d1 = hidden if projected else n_feat
    steps = EPOCHS * {"full": 1, "graphsaint": kw.get("num_steps"),
                      "neighbor": -(-n_nodes // kw.get("batch_size", 1))
                      }[kw["minibatch"]]
    out = {"sum_over_world": (2 * steps + 2,
                              (steps + 1) * 4 * n_nodes * (d1 + hidden)),
           "copy_to_world": (steps * (1 + projected),
                             steps * (1 + projected) * 4 * n_nodes * hidden)}
    if kw["conv_type"] == "gcn" and kw["minibatch"] != "full":
        out["all_reduce_world_"] = (steps, steps * 4 * n_nodes)
    return out


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("case", list(CASES))
def test_mesh_pretrainer_collectives_exact(spawned, case, world):
    want = _expected_counts(case)
    for r in spawned[world]["cases"]:
        assert r[case][2] == want


@pytest.mark.parametrize("world", list(WORLDS))
def test_rank_launches_follow_its_block(spawned, world):
    """The ranks' blocks tile the directed edges in rank order, and each
    rank's segment_matmul calls are spmm_launches' count at its block's
    edges (chunks of LAUNCH_CHUNK): what the card's launch counter reads."""
    g = _graph()
    src, dst = T._directed_edges(g)
    n_tr = 8 * int((src < dst).sum()) // 10
    for case in LAUNCH_CASES:
        kw = _kw(case)
        ranks = [r[case] for r in spawned[world]["launches"]]
        blocks = [b for _, b in ranks]
        assert blocks[0][0] == 0 and blocks[-1][1] == len(src)
        assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))
        n_feat = 20 if kw.get("features") == "ones" else g.n_nodes
        steps = EPOCHS * (1 if kw["minibatch"] == "full"
                          else -(-g.n_nodes // kw["batch_size"]))
        for calls, (lo, hi) in ranks:
            want = T.spmm_launches(hi - lo, n_tr, conv_type=kw["conv_type"],
                                   minibatch=kw["minibatch"],
                                   projected=n_feat > kw["hidden"],
                                   chunk=LAUNCH_CHUNK)
            assert calls == steps * want["step"] + want["eval"], case
        assert -(-(blocks[0][1] - blocks[0][0]) // LAUNCH_CHUNK) > 1


def test_empty_edge_block_joins_every_collective(spawned):
    """Rank 3 of 4 holds no edge: its forward and gradients equal the
    one-process ones, and it made the same collectives as the others (the
    gradient all-reduce included)."""
    ranks = spawned[4]["empty_block"]
    assert [r["block"] for r in ranks] == [(0, 2), (2, 4), (4, 6), (6, 6)]
    one = _empty_block_grads(None)
    for conv in ("gin", "gcn"):
        for r in ranks:
            emb, grads, counts = r[conv]
            np.testing.assert_allclose(emb, one[conv][0], atol=1e-6)
            for a, b in zip(grads, one[conv][1]):
                np.testing.assert_allclose(a, b, atol=1e-6)
            assert counts == ranks[0][conv][2]
        want = {"sum_over_world": (2, 4 * 5 * (4 + 4)),
                "copy_to_world": (2, 2 * 4 * 5 * 4)}
        if conv == "gcn":
            want["all_reduce_world_"] = (1, 4 * 5)
        assert ranks[3][conv][2] == want
