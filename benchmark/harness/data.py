"""Synthetic inputs of a configuration, made on the host.

The dataset (base graph, subgraphs, labels, split) is one fixed dataset
drawn from the configuration's own `dataset.seed`, as a user's task is one
dataset; the run's seed draws the requests (`request_sizes` and the
serving driver) and, elsewhere, the weights, anchors and orders.

The base graph has the published node and edge counts and a heavy-tailed
degree distribution: a random recursive tree (so the graph is connected and
every hop distance is real) plus Chung-Lu edges drawn with power-law node
weights, on shuffled node ids. Node ids are 1-based, as the program's.

Subgraphs are grown by walks. Their shapes (size and number of connected
components) are a fixed multiset taken from the configuration's size and
component-count distributions by stratified quantiles, so every seed trains and serves the
same amount of work, in another order and on other nodes. Each component is
grown as one walk-connected part from a uniformly drawn start node and kept
apart from the subgraph's other parts (no node of a part is adjacent to
another part), so the component counts are the planned ones.

The split is fixed by shape rank (every tenth subgraph to val, the next to
test), so each split holds the same shapes for every seed.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np


def _lognormal_quantiles(mean: float, sd: float, n: int) -> np.ndarray:
    """n stratified quantiles of the lognormal with this mean and sd."""
    from statistics import NormalDist
    s2 = math.log(1.0 + (sd / mean) ** 2)
    mu = math.log(mean) - s2 / 2
    nd = NormalDist(mu, math.sqrt(s2))
    return np.exp([nd.inv_cdf((i + 0.5) / n) for i in range(n)])


def subgraph_shapes(ds: Dict, n: int) -> np.ndarray:
    """(n, 2) int64 (size, components) of n subgraphs, seed-free: sizes and
    component counts each the rounded stratified quantiles of a lognormal
    with the published mean and sd (Table 1), paired rank for rank (the
    larger subgraphs have the more components); sizes clipped to
    [size_min, size_max], counts to [1, size]."""
    sizes = np.rint(_lognormal_quantiles(ds["subgraph_size_mean"],
                                         ds["subgraph_size_sd"], n))
    sizes = np.clip(sizes, ds["subgraph_size_min"],
                    ds["subgraph_size_max"]).astype(np.int64)
    comps = np.rint(_lognormal_quantiles(ds["components_mean"],
                                         ds["components_sd"], n))
    comps = np.clip(comps, 1, sizes).astype(np.int64)
    return np.stack([sizes, comps], axis=1)


def make_graph(ds: Dict) -> np.ndarray:
    """(n_edges, 2) int64 unique undirected 1-based edges, no self loops,
    drawn from the dataset's own seed."""
    n, m = int(ds["n_nodes"]), int(ds["n_edges"])
    rng = np.random.default_rng([int(ds["seed"]), 1])
    perm = rng.permutation(n) + 1
    # random recursive tree over the shuffled ids: connected, depth O(log n)
    parent = perm[(rng.random(n - 1) * np.arange(1, n)).astype(np.int64)]
    tree = np.stack([perm[1:], parent], axis=1)
    # Chung-Lu weights: w_i ~ (i + i0)^(-1/(gamma-1)), capped, on shuffled ids
    g = float(ds["degree_exponent"])
    w = (np.arange(n) + 10.0) ** (-1.0 / (g - 1.0))
    w = w / w.sum() * 2.0 * m
    w = np.minimum(w, ds["degree_cap_share"] * n)
    p = np.empty(n)
    p[rng.permutation(n)] = w / w.sum()
    keys = np.minimum(tree[:, 0], tree[:, 1]) * (n + 1) + np.maximum(
        tree[:, 0], tree[:, 1])
    have = np.unique(keys)
    extra = np.zeros(0, np.int64)
    cdf = np.cumsum(p)
    cdf /= cdf[-1]
    while len(have) + len(extra) < m:
        need = m - len(have) - len(extra)
        k = int(need * 1.3) + 1024
        u = np.searchsorted(cdf, rng.random(k), side="right") + 1
        v = np.searchsorted(cdf, rng.random(k), side="right") + 1
        u, v = np.minimum(u, v), np.maximum(u, v)
        new = (u * (n + 1) + v)[u != v]
        new = np.unique(new)
        new = new[~np.isin(new, have, assume_unique=True)]
        extra = np.union1d(extra, new)
    extra = rng.permutation(extra)[: m - len(have)]
    keys = np.concatenate([have, extra])
    return np.stack([keys // (n + 1), keys % (n + 1)], axis=1)


def csr(edges: np.ndarray, n_nodes: int):
    """(indptr (n+2,), indices) of the symmetric graph, 1-based rows."""
    both = np.concatenate([edges, edges[:, ::-1]])
    both = both[np.argsort(both[:, 0] * (n_nodes + 1) + both[:, 1])]
    counts = np.bincount(both[:, 0], minlength=n_nodes + 1)
    indptr = np.zeros(n_nodes + 2, np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr, both[:, 1].astype(np.int64)


class Grower:
    """Grows subgraphs of given shapes on one graph, from one rng."""

    def __init__(self, indptr: np.ndarray, indices: np.ndarray, n_nodes: int,
                 rng: np.random.Generator):
        self.indptr, self.indices, self.n = indptr, indices, n_nodes
        self.rng = rng
        self.blocked = np.zeros(n_nodes + 1, bool)

    def _nbrs(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v]:self.indptr[v + 1]]

    def subgraph(self, size: int, comps: int) -> List[int]:
        """A node list of `size` nodes in `comps` walk-grown parts that do
        not touch each other (a part stuck early stays smaller)."""
        rng, blocked = self.rng, self.blocked
        parts = [size // comps + (1 if i < size % comps else 0)
                 for i in range(comps)]
        marked = []
        nodes: List[int] = []
        for want in parts:
            start = None
            for _ in range(1000):
                c = int(rng.integers(1, self.n + 1))
                if not blocked[c]:
                    start = c
                    break
            if start is None:
                break
            part = [start]
            inside = {start}
            tries = 0
            while len(part) < want and tries < 50 * want:
                tries += 1
                v = part[int(rng.integers(len(part)))]
                nb = self._nbrs(v)
                u = int(nb[int(rng.integers(len(nb)))])
                if u in inside or blocked[u]:
                    continue
                part.append(u)
                inside.add(u)
            nodes.extend(part)
            # the part and its neighbours are closed to the later parts
            for v in part:
                nb = self._nbrs(v)
                blocked[nb] = True
                marked.append(nb)
            blocked[part] = True
            marked.append(np.asarray(part))
        for m in marked:
            blocked[m] = False
        return nodes


def make_dataset(cfg: Dict) -> Dict:
    """The configuration's base graph, subgraphs, labels and the train and
    val splits (the test split is never read, and not grown):
    {"edges", "n_nodes", "num_classes", "lists": {split: [[ids]]},
    "labels": {split: int64 array}}."""
    ds = cfg["dataset"]
    n = int(ds["n_nodes"])
    edges = make_graph(ds)
    indptr, indices = csr(edges, n)
    shapes = subgraph_shapes(ds, int(ds["n_subgraphs"]))
    # fixed split by shape rank: every 10th to val, the one after to test
    rank = np.arange(len(shapes))
    split_of = np.where(rank % 10 == 4, 1, np.where(rank % 10 == 9, 2, 0))
    rng = np.random.default_rng([int(ds["seed"]), 2])
    grower = Grower(indptr, indices, n, rng)
    out = {"edges": edges, "n_nodes": n, "num_classes": int(ds["n_classes"]),
           "lists": {}, "labels": {}}
    for tag, split in enumerate(("train", "val")):
        idx = rng.permutation(np.flatnonzero(split_of == tag))
        out["lists"][split] = [grower.subgraph(int(shapes[i, 0]),
                                               int(shapes[i, 1]))
                               for i in idx]
        out["labels"][split] = rng.integers(0, out["num_classes"],
                                            len(idx)).astype(np.int64)
    return out


def request_sizes(traffic: Dict) -> np.ndarray:
    """Subgraphs per request of one cycle, seed-free: stratified quantiles of
    the log-uniform distribution over [min, max]."""
    k, lo, hi = (int(traffic["cycle"]), traffic["subgraphs_min"],
                 traffic["subgraphs_max"])
    q = (np.arange(k) + 0.5) / k
    return np.rint(np.exp(math.log(lo) + q * (math.log(hi) - math.log(lo)))
                   ).astype(np.int64)
