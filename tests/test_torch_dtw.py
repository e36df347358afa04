"""The port's DTW (plain PyTorch version on the CPU) against the JAX package:
the lax.scan wavefront, the Pallas kernel in interpret mode, and the host
DP oracle; then the grouped serving similarities end to end.

Tolerances: the plain version repeats the same fp32 operations in the same
order as the JAX wavefront, so distances agree to atol 1e-5 (the float64
host oracle differs only by fp32 rounding); similarities 1/(d+1) to 1e-6.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from subgnn_tpu.ops.dtw_pallas import dtw_distance_pallas
from subgnn_tpu.precompute import dtw as jdtw
from subgnn_tpu.precompute import similarities as jsim
from subgnn_tpu.data.graph import CSRGraph as JGraph

from subgnn_tpu_torch.ops import dtw as tdtw
from subgnn_tpu_torch.precompute import dtw as tpdtw
from subgnn_tpu_torch.precompute import similarities as tsim
from subgnn_tpu_torch.data.graph import CSRGraph as TGraph


def _ragged_pairs(rng, N, La, Lb, allow_empty=True):
    lo = 0 if allow_empty else 1
    la = rng.integers(lo, La + 1, N).astype(np.int32)
    lb = rng.integers(lo, Lb + 1, N).astype(np.int32)
    a = np.zeros((N, La), np.float32)
    b = np.zeros((N, Lb), np.float32)
    for i in range(N):
        a[i, :la[i]] = np.sort(rng.integers(0, 12, la[i]))
        b[i, :lb[i]] = np.sort(rng.integers(0, 12, lb[i]))
    return a, la, b, lb


def _plain(a, la, b, lb):
    return tdtw.dtw_distance_torch(torch.from_numpy(a), torch.from_numpy(la),
                                   torch.from_numpy(b),
                                   torch.from_numpy(lb)).numpy()


@pytest.mark.parametrize("La,Lb", [(10, 7), (7, 10), (25, 25), (15, 25),
                                   (300, 25)])
def test_plain_dtw_matches_jax_scan_and_host(La, Lb):
    """(300, 25): a comp longer than the 256 the first Hopper kernel took,
    16 pairs to keep the host oracle short."""
    rng = np.random.default_rng(La * 100 + Lb)
    a, la, b, lb = _ragged_pairs(rng, 16 if La > 256 else 48, La, Lb)
    la[0], lb[1] = 0, 0          # explicit empty rows on each side
    la[2] = La                   # and a full-length one
    a[2] = np.sort(rng.integers(0, 12, La))
    got = _plain(a, la, b, lb)
    expect = np.asarray(jdtw.dtw_distance_batch(
        jnp.asarray(a), jnp.asarray(la), jnp.asarray(b), jnp.asarray(lb)))
    np.testing.assert_allclose(got, expect, atol=1e-5, rtol=0)
    assert got[0] == 0.0 and got[1] == 0.0
    for i in range(len(a)):
        oracle = jdtw.dtw_host(a[i, :la[i]], b[i, :lb[i]])
        assert abs(got[i] - oracle) < 1e-5 * max(1.0, oracle)
        assert tpdtw.dtw_host(a[i, :la[i]], b[i, :lb[i]]) == oracle


def test_plain_dtw_matches_pallas_interpret():
    rng = np.random.default_rng(3)
    a, la, b, lb = _ragged_pairs(rng, 16, 10, 7)
    got = _plain(a, la, b, lb)
    expect = np.asarray(dtw_distance_pallas(
        jnp.asarray(a), jnp.asarray(la), jnp.asarray(b), jnp.asarray(lb),
        interpret=True))
    np.testing.assert_allclose(got, expect, atol=1e-5, rtol=0)


def test_grouped_wrapper_cpu_matches_per_pair():
    """The grouped wrapper's block-diagonal pair mapping (CPU tensors take
    the plain version) equals DTW of each (comp, anchor) pair."""
    rng = np.random.default_rng(5)
    G, nc, na, Lc, La = 2, 6, 5, 7, 9
    cs, cl, _, _ = _ragged_pairs(rng, G * nc, Lc, 1)
    as_, al, _, _ = _ragged_pairs(rng, G * na, La, 1)
    d = tdtw.dtw_distance_grouped(
        torch.from_numpy(cs), torch.from_numpy(cl), torch.from_numpy(as_),
        torch.from_numpy(al), G, nc, na).numpy().reshape(G, nc, na)
    for g in range(G):
        for c in range(nc):
            for a in range(na):
                ic, ia = g * nc + c, g * na + a
                ref = jdtw.dtw_host(cs[ic, :cl[ic]], as_[ia, :al[ia]])
                assert abs(d[g, c, a] - ref) < 1e-5 * max(1.0, ref)
    assert tdtw.dtw_distance_grouped.launches == 0  # no kernel on the CPU
    assert tdtw.dtw_distance_grouped.pairs == 0


def test_grouped_wrapper_rejects_bad_inputs():
    cs = torch.zeros(4, 3)
    cl = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        tdtw.dtw_distance_grouped(cs, cl.long(), cs, cl, 1, 4, 4)
    with pytest.raises(ValueError):
        tdtw.dtw_distance_grouped(cs, cl, cs, cl, 1, 3, 4)
    with pytest.raises(ValueError):
        tdtw.dtw_distance_grouped(cs.t(), cl[:3], cs, cl, 1, 3, 4)


def test_similarity_matrix_and_grouped_match_jax():
    rng = np.random.default_rng(11)
    nc, na = 20, 12
    cs, cl, _, _ = _ragged_pairs(rng, 2 * nc, 8, 1)
    as_, al, _, _ = _ragged_pairs(rng, 2 * na, 11, 1, allow_empty=False)
    got = tpdtw.dtw_similarity_grouped(
        cs.reshape(2, nc, 8), cl.reshape(2, nc), as_.reshape(2, na, 11),
        al.reshape(2, na), device="cpu")
    expect = jdtw.dtw_similarity_grouped(
        cs.reshape(2, nc, 8), cl.reshape(2, nc), as_.reshape(2, na, 11),
        al.reshape(2, na))
    np.testing.assert_allclose(got, expect, atol=1e-6, rtol=0)
    got1 = tpdtw.dtw_similarity_matrix(cs[:nc], cl[:nc], as_[:na], al[:na],
                                       device="cpu")
    expect1 = jdtw.dtw_similarity_matrix(cs[:nc], cl[:nc], as_[:na], al[:na])
    np.testing.assert_allclose(got1, expect1, atol=1e-6, rtol=0)


def _small_graph_and_sets(seed=0, n=60):
    import networkx as nx
    g = nx.barabasi_albert_graph(n, 3, seed=seed)
    edges = np.asarray(list(g.edges())) + 1
    rng = np.random.default_rng(seed)
    cc_ids = np.zeros((5, 3, 6), np.int32)
    for s in range(5):
        for c in range(int(rng.integers(1, 4))):
            ln = int(rng.integers(1, 7))
            cc_ids[s, c, :ln] = rng.choice(n, ln, replace=False) + 1
    pool = np.zeros((9, 8), np.int32)
    for p in range(9):
        ln = int(rng.integers(1, 9))
        pool[p, :ln] = rng.integers(1, n + 1, ln)
    return edges, n, cc_ids, pool


def test_structure_similarities_both_matches_jax():
    edges, n, cc_ids, pool = _small_graph_and_sets()
    jg = JGraph.from_edges(edges, n_nodes=n)
    tg = TGraph.from_edges(edges, n_nodes=n)
    ji, jb = jsim.structure_similarities_both(jg, cc_ids, pool)
    cache = {}
    ti, tb = tsim.structure_similarities_both(tg, cc_ids, pool,
                                              anchor_cache=cache,
                                              device="cpu")
    np.testing.assert_allclose(ti, ji, atol=1e-6, rtol=0)
    np.testing.assert_allclose(tb, jb, atol=1e-6, rtol=0)
    assert set(cache) == {"int", "bor"}
    # the single-product path equals each half of the fused one
    for internal, ref in ((True, ji), (False, jb)):
        one = tsim.compute_structure_similarities(tg, cc_ids, pool,
                                                  internal=internal,
                                                  device="cpu")
        np.testing.assert_allclose(one, ref, atol=1e-6, rtol=0)


def test_shortest_path_sims_and_borders_match_jax():
    from subgnn_tpu.precompute.shortest_paths import \
        shortest_path_rows as j_rows
    from subgnn_tpu.precompute.border import border_sets_from_rows as j_bor
    from subgnn_tpu_torch.precompute.shortest_paths import \
        shortest_path_rows as t_rows
    from subgnn_tpu_torch.precompute.border import \
        border_sets_from_rows as t_bor
    edges, n, cc_ids, _ = _small_graph_and_sets(seed=2)
    srcs = np.unique(cc_ids[cc_ids != 0]).astype(np.int64)
    jr = j_rows(JGraph.from_edges(edges, n_nodes=n), srcs, backend="fallback")
    tr = t_rows(TGraph.from_edges(edges, n_nodes=n), srcs)
    np.testing.assert_array_equal(tr, jr)
    lut = np.zeros(n + 1, np.int32)
    lut[srcs] = np.arange(1, len(srcs) + 1)
    np.testing.assert_array_equal(
        tsim.compute_shortest_path_similarities(tr, lut[cc_ids]),
        jsim.compute_shortest_path_similarities(jr, lut[cc_ids]))
    np.testing.assert_array_equal(t_bor(srcs, tr, cc_ids, 1, n),
                                  j_bor(srcs, jr, cc_ids, 1, n))

