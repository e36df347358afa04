"""Plain graph operations of SubGNN's precompute, in numpy and scipy.

Everything here works from the benchmark's own edge array: the connected
components of a node list (in order of first appearance), their padded
(N, C, L) table, hop distances by a BFS of dense frontier products on a
device, the CC-min hop distances
that the N and P channels read, k-hop border sets, and the degree
sequences that the structure channel's DTW compares.
"""
from __future__ import annotations

from typing import List

import numpy as np
import scipy.sparse as sp
from scipy.sparse import csgraph

PAD = 0


class Graph:
    """An undirected graph on 1-based ids 1..n (row 0 is the empty pad)."""

    def __init__(self, edges: np.ndarray, n_nodes: int):
        self.n = int(n_nodes)
        e = np.asarray(edges, np.int64)
        both = np.concatenate([e, e[:, ::-1]])
        both = both[np.argsort(both[:, 0] * (self.n + 1) + both[:, 1])]
        counts = np.bincount(both[:, 0], minlength=self.n + 1)
        self.indptr = np.zeros(self.n + 2, np.int64)
        np.cumsum(counts, out=self.indptr[1:])
        self.indices = both[:, 1].astype(np.int64)
        self.adj = sp.csr_matrix(
            (np.ones(len(both), np.float32), self.indices,
             self.indptr[:self.n + 2]), shape=(self.n + 1, self.n + 1))
        self.degree = np.diff(self.indptr)[: self.n + 1]
        self._dense = {}

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v]:self.indptr[v + 1]]

    def node_ids(self) -> np.ndarray:
        return np.nonzero(self.degree)[0].astype(np.int64)

    # ------------------------------------------------------------ components

    def components(self, nodes) -> List[List[int]]:
        """Connected components of the induced subgraph, in order of each
        component's first node in `nodes`, nodes in their list order."""
        nodes = list(dict.fromkeys(int(v) for v in nodes))
        idx = np.asarray(nodes, np.int64)
        sub = self.adj[idx][:, idx]
        _, label = csgraph.connected_components(sub, directed=False)
        comps: dict = {}
        for v, lab in zip(nodes, label):
            comps.setdefault(int(lab), []).append(v)
        return list(comps.values())

    def cc_table(self, lists) -> np.ndarray:
        """(N, C, L) int64 of the components' ids, PAD 0, C and L the
        largest over `lists`."""
        ccs = [self.components(sg) for sg in lists]
        C = max(len(c) for c in ccs)
        L = max(len(x) for c in ccs for x in c)
        out = np.zeros((len(lists), C, L), np.int64)
        for s, c in enumerate(ccs):
            for j, x in enumerate(c):
                out[s, j, :len(x)] = x
        return out

    # ------------------------------------------------------- hop distances

    def hop_rows(self, sources: np.ndarray, device=None,
                 chunk: int = 2048) -> np.ndarray:
        """(S, n) int32 hop distances from each 1-based source to nodes
        1..n (column j is node j + 1); unreached nodes read 0. A BFS by
        levels: the frontier times the dense adjacency, on `device`."""
        import torch
        dev = torch.device("cpu" if device is None else device)
        dt = torch.float16 if dev.type == "cuda" else torch.float32
        adj = self._dense.get(str(dev))
        if adj is None:
            rows = np.repeat(np.arange(self.n + 1), self.degree)
            adj = torch.zeros(self.n + 1, self.n + 1, dtype=dt, device=dev)
            adj[torch.as_tensor(rows, device=dev),
                torch.as_tensor(self.indices, device=dev)] = 1
            self._dense[str(dev)] = adj
        sources = np.asarray(sources, np.int64)
        out = np.zeros((len(sources), self.n), np.int32)
        for a in range(0, len(sources), chunk):
            src = torch.as_tensor(sources[a:a + chunk], device=dev)
            k = torch.arange(len(src), device=dev)
            dist = torch.zeros(len(src), self.n + 1, dtype=torch.int32,
                               device=dev)
            seen = torch.zeros(len(src), self.n + 1, dtype=torch.bool,
                               device=dev)
            seen[k, src] = True
            front = seen.to(dt)
            level = 0
            while True:
                level += 1
                new = ((front @ adj) > 0) & ~seen
                if not bool(new.any()):
                    break
                dist[new] = level
                seen |= new
                front = new.to(dt)
            out[a:a + chunk] = dist[:, 1:].cpu().numpy()
        return out

    def cc_min_distances(self, cc: np.ndarray, device=None) -> np.ndarray:
        """(N, C, n) float32: for each component, the least hop distance
        from its nodes to every node (0 for a padded component)."""
        N, C, _ = cc.shape
        srcs = np.unique(cc[cc != PAD])
        rows = self.hop_rows(srcs, device)
        where = np.zeros(self.n + 1, np.int64)
        where[srcs] = np.arange(len(srcs))
        out = np.zeros((N, C, self.n), np.float32)
        for s in range(N):
            for c in range(C):
                comp = cc[s, c][cc[s, c] != PAD]
                if comp.size:
                    out[s, c] = rows[where[comp]].min(axis=0)
        return out

    def border_sets(self, cc: np.ndarray, radius: int) -> np.ndarray:
        """(N, C, B) int64: the nodes within `radius` hops of each
        component and not in it, ascending, PAD 0; B the largest set
        (at least 1)."""
        N, C, _ = cc.shape
        sets = []
        for s in range(N):
            row = []
            for c in range(C):
                comp = cc[s, c][cc[s, c] != PAD]
                if comp.size == 0:
                    row.append(np.zeros(0, np.int64))
                    continue
                seen = np.zeros(self.n + 1, bool)
                seen[comp] = True
                frontier = comp
                for _ in range(radius):
                    nb = np.concatenate([self.neighbors(int(v))
                                         for v in frontier])
                    new = np.unique(nb[~seen[nb]])
                    seen[new] = True
                    frontier = new
                seen[comp] = False
                row.append(np.flatnonzero(seen))
            sets.append(row)
        B = max(1, max(len(b) for row in sets for b in row))
        out = np.zeros((N, C, B), np.int64)
        for s, row in enumerate(sets):
            for c, b in enumerate(row):
                out[s, c, :len(b)] = b
        return out

    # ------------------------------------------------------ degree sequences

    def degree_sequences(self, node_sets: np.ndarray, internal: bool):
        """(seqs (R, W) float32 sorted ascending and zero-padded, lengths
        (R,)) of each row of 1-based ids (PAD 0): each occurrence of a node
        gives its degree inside the set (internal) or its degree to nodes
        outside the set (border)."""
        node_sets = np.asarray(node_sets, np.int64)
        R, W = node_sets.shape
        seqs = np.zeros((R, W), np.float32)
        lens = np.zeros(R, np.int64)
        for r in range(R):
            nodes = node_sets[r][node_sets[r] != PAD]
            if nodes.size == 0:
                continue
            member = np.zeros(self.n + 1, np.float32)
            member[nodes] = 1.0
            inside = np.asarray(self.adj[nodes] @ member).ravel()
            deg = inside if internal else self.degree[nodes] - inside
            seqs[r, :len(nodes)] = np.sort(deg)
            lens[r] = len(nodes)
        return seqs, lens
