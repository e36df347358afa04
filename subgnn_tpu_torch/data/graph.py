"""CSR base-graph representation with 1-based node ids (0 = padding).

Replaces the reference's NetworkX graph object (reference:
SubGNN/SubGNN.py:525,555-556 reads an edge list and relabels nodes to be
1-indexed so id 0 can pad). Here the graph is three flat arrays:

    indptr  : int64[(n_nodes + 2)]   row pointers; row v (1-based) spans
                                     indices[indptr[v]:indptr[v+1]].
                                     Row 0 (the pad id) is always empty.
    indices : int32[(2 * n_edges)]   neighbor ids, 1-based, sorted per row.
    degrees : int32[(n_nodes + 1)]   degree per id (degrees[0] == 0).

Sorted rows give O(log d) membership tests (used by the triangle check in
triangular random walks, reference: SubGNN/anchor_patch_samplers.py:20-24).

A numpy copy of subgnn_tpu/data/graph.py.
"""
from __future__ import annotations

from pathlib import Path
from typing import Iterable, List, Sequence, Set

import numpy as np


class CSRGraph:
    __slots__ = ("indptr", "indices", "n_nodes")

    def __init__(self, indptr: np.ndarray, indices: np.ndarray, n_nodes: int):
        self.indptr = np.asarray(indptr, dtype=np.int64)
        self.indices = np.asarray(indices, dtype=np.int32)
        self.n_nodes = int(n_nodes)

    # ------------------------------------------------------------------ build

    @classmethod
    def from_edges(cls, edges: np.ndarray, n_nodes: int | None = None) -> "CSRGraph":
        """Build an undirected CSR graph from a (E, 2) array of 1-BASED edges.

        Self-loops are kept as a single directed entry per direction (matching
        NetworkX semantics where a self-loop contributes one neighbor entry);
        duplicate edges are collapsed.
        """
        edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        if n_nodes is None:
            n_nodes = int(edges.max()) if edges.size else 0
        # symmetrize & dedupe
        u, v = edges[:, 0], edges[:, 1]
        both = np.concatenate([edges, np.stack([v, u], axis=1)], axis=0)
        # unique (u, v) pairs via a single int64 key
        key = both[:, 0] * (n_nodes + 1) + both[:, 1]
        key = np.unique(key)
        src = (key // (n_nodes + 1)).astype(np.int64)
        dst = (key % (n_nodes + 1)).astype(np.int32)
        counts = np.bincount(src, minlength=n_nodes + 1)
        indptr = np.zeros(n_nodes + 2, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        # np.unique sorts keys, so dst is already sorted within each src row
        return cls(indptr, dst, n_nodes)

    @classmethod
    def from_edgelist(cls, path: str | Path) -> "CSRGraph":
        """Read a whitespace-separated edge list of 0-based integer node ids
        and return the graph with all ids shifted to 1-based.

        Mirrors nx.read_edgelist + the +1 relabel at reference
        SubGNN/SubGNN.py:554-556. Node count is max(id)+1 (ids are contiguous
        in all shipped datasets; isolated trailing ids would be absent from
        the edge list in both implementations).
        """
        raw = np.loadtxt(str(path), dtype=np.int64, usecols=(0, 1), ndmin=2)
        return cls.from_edges(raw + 1, n_nodes=int(raw.max()) + 1)

    # ------------------------------------------------------------- accessors

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v]:self.indptr[v + 1]]

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int32)

    def node_ids(self) -> np.ndarray:
        """All 1-based node ids that have at least one edge."""
        deg = self.degrees
        return np.nonzero(deg[: self.n_nodes + 1])[0].astype(np.int32)

    # --------------------------------------------------- subgraph operations

    def induced_degrees(self, nodes: np.ndarray) -> np.ndarray:
        """Degree of each node within the induced subgraph on `nodes`.

        Vectorized membership test over the concatenated neighbor rows.
        (reference: SubGNN/gamma.py:29-30 uses nx subgraph.degree)
        """
        nodes = np.asarray(nodes, dtype=np.int64)
        if nodes.size == 0:
            return np.zeros(0, dtype=np.int32)
        member = np.zeros(self.n_nodes + 1, dtype=bool)
        member[nodes] = True
        out = np.empty(len(nodes), dtype=np.int32)
        for i, v in enumerate(nodes):
            out[i] = int(member[self.neighbors(v)].sum())
        return out

    def connected_components(self, nodes: Sequence[int]) -> List[List[int]]:
        """Connected components of the induced subgraph on `nodes`.

        Returns components in order of first appearance of their smallest-
        index representative (deterministic). Matches the set semantics of
        nx.connected_components (reference: SubGNN/SubGNN.py:590-592); the
        ordering of components and of nodes within a component is arbitrary
        in both implementations (downstream use is order-invariant).
        """
        nodes = list(dict.fromkeys(int(n) for n in nodes))
        pos = {v: i for i, v in enumerate(nodes)}
        parent = list(range(len(nodes)))

        def find(x: int) -> int:
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        member = np.zeros(self.n_nodes + 1, dtype=bool)
        member[np.asarray(nodes, dtype=np.int64)] = True
        for v in nodes:
            nbrs = self.neighbors(v)
            for u in nbrs[member[nbrs]]:
                ru, rv = find(pos[int(u)]), find(pos[v])
                if ru != rv:
                    parent[ru] = rv
        comps: dict[int, List[int]] = {}
        for v in nodes:
            comps.setdefault(find(pos[v]), []).append(v)
        return list(comps.values())

    def khop_neighborhood(self, seeds: Iterable[int], k: int) -> Set[int]:
        """Union of k-hop balls around `seeds` (including the seeds).

        Equivalent to the union of nx.ego_graph(..., radius=k) node sets
        (reference: SubGNN/subgraph_utils.py:146-171).
        """
        # vectorized frontier expansion on the CSR arrays (khop_mask):
        # python-set unions cost ~170 s per 32-subgraph serving batch on
        # hub-heavy EM-USER-scale graphs (diameter 2, radius-2 balls ~=
        # the whole graph — PERF.md round-5 serving section); boolean
        # membership + concatenated index slices is ~100x faster, exact
        return set(np.flatnonzero(self.khop_mask(seeds, k)).tolist())

    def khop_mask(self, seeds, k: int) -> np.ndarray:
        """(n_nodes+1,) bool membership mask of khop_neighborhood — the
        allocation-free variant for border-set computation at serving
        scale (the set round-trip costs more than the BFS itself on
        57k-node graphs)."""
        frontier = np.unique(np.asarray(list(seeds), dtype=np.int64))
        seen = np.zeros(self.n_nodes + 1, dtype=bool)
        seen[frontier] = True
        for _ in range(k):
            if frontier.size == 0:
                break
            counts = (self.indptr[frontier + 1]
                      - self.indptr[frontier]).astype(np.int64)
            if counts.sum() == 0:
                break
            offs = np.repeat(self.indptr[frontier].astype(np.int64), counts)
            within = np.arange(counts.sum(), dtype=np.int64) \
                - np.repeat(np.cumsum(counts) - counts, counts)
            nbrs = self.indices[offs + within]
            new_mask = np.zeros_like(seen)
            new_mask[nbrs] = True
            new_mask &= ~seen
            seen |= new_mask
            frontier = np.flatnonzero(new_mask).astype(np.int64)
        return seen

    def border_nodes(self, nodes: Sequence[int]):
        """(in_border, external): nodes of `nodes` with >=1 edge leaving the
        set, and all graph nodes not in the set.

        (reference: SubGNN/subgraph_utils.py:126-144 builds a dense adjacency
        submatrix; here it's a vectorized CSR membership scan.)
        """
        nodes = np.asarray(sorted({int(n) for n in nodes}), dtype=np.int64)
        member = np.zeros(self.n_nodes + 1, dtype=bool)
        member[nodes] = True
        in_border = [int(v) for v in nodes
                     if (~member[self.neighbors(v)]).any()]
        all_ids = self.node_ids()
        external = all_ids[~member[all_ids]]
        return np.asarray(in_border, dtype=np.int32), external.astype(np.int32)

    # ------------------------------------------------------------------ misc

    def __repr__(self) -> str:  # pragma: no cover
        return f"CSRGraph(n_nodes={self.n_nodes}, n_edges={len(self.indices)//2})"
