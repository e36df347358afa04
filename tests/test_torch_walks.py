"""The port's device walker (subgnn_tpu_torch/sampling/device_walks.py) on
the CPU: its neighbor table equal to the JAX package's, its walks equal to a
numpy oracle of the same semantics on the same uniforms, the walk
invariants, and its triangle-step share against the JAX walker's (the two
draw from different streams, so the shares agree within 3 standard errors).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from subgnn_tpu.data.graph import CSRGraph as JGraph
from subgnn_tpu.sampling import device_walks as J

from subgnn_tpu_torch.config import HParams
from subgnn_tpu_torch.data.graph import CSRGraph as TGraph
from subgnn_tpu_torch.sampling import device_walks as T


def _edges(seed=0, n=40, m=110):
    """Random edges on nodes 1..n, a hub (node 1, 25 neighbors) and an
    isolated node n + 1."""
    rng = np.random.default_rng(seed)
    e = rng.integers(1, n + 1, (m, 2))
    hub = np.stack([np.ones(25, np.int64),
                    rng.choice(np.arange(2, n + 1), 25, replace=False)], 1)
    e = np.concatenate([e, hub])
    return e[e[:, 0] != e[:, 1]], n + 1


@pytest.fixture(scope="module")
def graphs():
    e, n = _edges()
    return JGraph.from_edges(e, n_nodes=n), TGraph.from_edges(e, n_nodes=n)


@pytest.mark.parametrize("max_deg", [None, 5])
def test_neighbor_table_matches_jax(graphs, max_deg):
    jg, tg = graphs
    j_tab, j_deg = J.padded_neighbor_table(jg, max_deg)
    t_tab, t_deg = T.padded_neighbor_table(tg, max_deg, device="cpu")
    np.testing.assert_array_equal(t_tab.numpy(), np.asarray(j_tab))
    np.testing.assert_array_equal(t_deg.numpy(), np.asarray(j_deg))
    assert t_tab.dtype == t_deg.dtype == torch.int32
    # the hub's degree, clamped to a narrower table
    hub = int(tg.degrees.max())
    assert hub > 5 and t_tab.shape[1] == int(t_deg.max()) == (max_deg or hub)


def _index(u, count):
    return min(int(np.float32(u) * np.float32(count)), max(count - 1, 0))


def _oracle(table, deg, starts, u, walk_len, rw_beta):
    """The walker's semantics, one walk at a time, on the same uniforms."""
    max_deg = table.shape[1]
    out = np.zeros((u.shape[0], walk_len), np.int32)
    for i in range(u.shape[0]):
        prev = int(starts[_index(u[i, 0], len(starts))])
        curr = int(table[prev, max_deg - 1 - _index(u[i, 1], deg[prev])])
        out[i, 0] = prev
        if deg[prev] == 0:
            continue
        out[i, 1] = curr
        for t in range(walk_len - 2):
            nbrs = [int(v) for v in table[curr] if v != 0]
            prev_set = {int(v) for v in table[prev] if v != 0}
            tri = [v for v in nbrs if v in prev_set]
            non = [v for v in nbrs if v not in prev_set]
            if not nbrs:
                break
            take_tri = bool(tri) and (not non or u[i, 2 + 2 * t] <= rw_beta)
            cls = tri if take_tri else non
            nxt = cls[_index(u[i, 3 + 2 * t], len(cls))]
            out[i, 2 + t] = nxt
            prev, curr = curr, nxt
    return out


@pytest.mark.parametrize("max_deg", [None, 5])
@pytest.mark.parametrize("rw_beta", [0.65, 0.0, 1.0])
def test_walker_matches_numpy_oracle(graphs, max_deg, rw_beta):
    _, tg = graphs
    table, deg = T.padded_neighbor_table(tg, max_deg, device="cpu")
    starts = np.arange(1, tg.n_nodes + 1)              # the isolated one too
    gen = torch.Generator().manual_seed(3)
    u = T.walk_uniforms(300, 9, gen)
    got = T.triangular_walks_device(table, deg, torch.as_tensor(starts),
                                    walk_len=9, n_walks=300, rw_beta=rw_beta,
                                    uniforms=u, device="cpu")
    ref = _oracle(table.numpy(), deg.numpy(), starts, u.numpy(), 9, rw_beta)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_walk_invariants(graphs):
    _, tg = graphs
    table, deg = T.padded_neighbor_table(tg, device="cpu")
    starts = torch.arange(1, tg.n_nodes + 1)
    walks = T.triangular_walks_device(
        table, deg, starts, walk_len=12, n_walks=2000, rw_beta=0.65,
        generator=torch.Generator().manual_seed(0), device="cpu").numpy()
    adj = {v: set(tg.neighbors(v).tolist()) for v in range(tg.n_nodes + 1)}
    isolated = tg.n_nodes
    assert (walks[:, 0] > 0).all()
    dead = walks[:, 0] == isolated
    assert dead.any() and (walks[dead, 1:] == 0).all()
    for w in walks:
        real = w[w != 0]
        first_pad = np.argmin(w != 0) if (w == 0).any() else len(w)
        assert (w[first_pad:] == 0).all()                 # PAD after PAD
        for a, b in zip(real, real[1:]):
            assert int(b) in adj[int(a)]                   # every step an edge
    # the same generator seed gives the same walks
    again = T.triangular_walks_device(
        table, deg, starts, walk_len=12, n_walks=2000, rw_beta=0.65,
        generator=torch.Generator().manual_seed(0), device="cpu").numpy()
    np.testing.assert_array_equal(walks, again)


def _triangle_share(walks, adj):
    """(triangle steps, steps with both classes non-empty)."""
    took = total = 0
    for w in walks:
        for t in range(2, len(w)):
            if w[t] == 0:
                break
            prev, curr = int(w[t - 2]), int(w[t - 1])
            nbrs = adj[curr]
            tri = nbrs & adj[prev]
            if tri and nbrs - tri:
                total += 1
                took += int(w[t]) in adj[prev]
    return took, total


@pytest.mark.parametrize("rw_beta", [0.65, 0.0])
def test_triangle_share_matches_jax(rw_beta):
    rng = np.random.default_rng(11)
    # a ring lattice (each node joined to the 3 next on each side: many
    # triangles) with 40 random shortcuts
    ring = [(i + 1, (i + k) % 120 + 1) for i in range(120) for k in (1, 2, 3)]
    e = np.concatenate([np.asarray(ring), rng.integers(1, 121, (40, 2))])
    e = e[e[:, 0] != e[:, 1]]
    jg, tg = JGraph.from_edges(e, n_nodes=120), TGraph.from_edges(e, 120)
    adj = {v: set(tg.neighbors(v).tolist()) for v in range(121)}
    j_tab, j_deg = J.padded_neighbor_table(jg)
    j_walks = np.asarray(J.triangular_walks_device(
        j_tab, j_deg, jnp.asarray(jg.node_ids()), jax.random.PRNGKey(0),
        walk_len=8, n_walks=3000, rw_beta=rw_beta))
    t_tab, t_deg = T.padded_neighbor_table(tg, device="cpu")
    t_walks = T.triangular_walks_device(
        t_tab, t_deg, torch.as_tensor(tg.node_ids()), walk_len=8,
        n_walks=3000, rw_beta=rw_beta,
        generator=torch.Generator().manual_seed(0), device="cpu").numpy()
    (kj, nj), (kt, nt) = _triangle_share(j_walks, adj), _triangle_share(
        t_walks, adj)
    assert nj > 5000 and nt > 5000
    pj, pt = kj / nj, kt / nt
    p = (kj + kt) / (nj + nt)
    se = np.sqrt(p * (1 - p) * (1 / nj + 1 / nt))
    assert abs(pj - pt) <= 3 * se + 1e-12, (pj, pt, se)
    if rw_beta == 0.65:
        assert 0.55 < pt < 0.75


def test_structure_pool(graphs):
    _, tg = graphs
    hp = HParams(n_layers=2, n_anchor_patches_structure=4, max_sim_epochs=2,
                 sample_walk_len=12, rw_beta=0.5)
    pool = T.sample_structure_pool_device(tg, hp, seed=0, max_sim_epochs=2,
                                          device="cpu")
    assert pool.shape[0] == 2 * 4 * 2 and pool.dtype == np.int32
    assert pool.shape[1] <= 12 and (pool[:, -1] != 0).any()
    for p in pool:
        real = p[p != 0]
        for a, b in zip(real, real[1:]):
            assert int(b) in set(tg.neighbors(int(a)).tolist())
    np.testing.assert_array_equal(
        pool, T.sample_structure_pool_device(tg, hp, seed=0,
                                             max_sim_epochs=2, device="cpu"))
    # a start set of isolated nodes only: every column past the first is
    # PAD and trimmed
    table, deg = T.padded_neighbor_table(tg, device="cpu")
    walks = T.triangular_walks_device(
        table, deg, torch.tensor([tg.n_nodes]), walk_len=5, n_walks=4,
        rw_beta=0.5, generator=torch.Generator().manual_seed(0), device="cpu")
    assert (walks[:, 1:] == 0).all()


def test_walker_resolves_cuda(graphs):
    _, tg = graphs
    table, deg = T.padded_neighbor_table(tg, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            T.triangular_walks_device(table, deg, torch.tensor([1]),
                                      walk_len=4, n_walks=2, rw_beta=0.5)
        with pytest.raises(RuntimeError, match="cuda"):
            T.padded_neighbor_table(tg)
