"""BFS hop distances from a subset of source nodes (serving NP sims).

Port of subgnn_tpu/precompute/shortest_paths.py's `shortest_path_rows` with
its numpy host BFS. Output contract: (len(sources), n_nodes) int32 indexed by
RAW 0-based node id, hop distance, unreached nodes left at 0 (the np.zeros
fill artifact of the reference precompute,
prepare_dataset/precompute_graph_metrics.py:23-26). Hop distances are exact,
so any BFS gives the same rows.
"""
from __future__ import annotations

import numpy as np

from ..data.graph import CSRGraph


def _bfs_from_sources_host(graph: CSRGraph, sources: np.ndarray) -> np.ndarray:
    """(len(sources), n_nodes) int32 hop distances, unreached = 0."""
    n = graph.n_nodes
    indptr, indices = graph.indptr, graph.indices
    out = np.zeros((len(sources), n), dtype=np.int32)
    for i, s in enumerate(sources):
        dist = out[i]
        visited = np.zeros(n + 1, dtype=bool)
        visited[s] = True
        frontier = np.array([s], dtype=np.int64)
        d = 0
        while frontier.size:
            d += 1
            # gather all neighbors of the frontier in one shot
            starts = indptr[frontier]
            ends = indptr[frontier + 1]
            total = int((ends - starts).sum())
            if total == 0:
                break
            # flat CSR-row gather with no per-node Python loop: element k of
            # row j sits at indices[starts[j] + k]
            counts = ends - starts
            row_start = np.cumsum(counts) - counts
            offs = np.repeat(starts - row_start, counts) + np.arange(total)
            nbr = indices[offs]
            new = np.unique(nbr[~visited[nbr]])
            if new.size == 0:
                break
            visited[new] = True
            dist[new - 1] = d  # raw 0-based output indexing
            frontier = new
    return out


def shortest_path_rows(graph: CSRGraph, sources: np.ndarray) -> np.ndarray:
    """(len(sources), n) int32 hop distances from each 1-based source node
    (unreached = 0). The N/P similarities only read distances FROM the
    subgraph/CC nodes (reference SubGNN.py:752-781), so serving never builds
    the n^2 all-pairs matrix."""
    sources = np.ascontiguousarray(sources, dtype=np.int64)
    return _bfs_from_sources_host(graph, sources)
