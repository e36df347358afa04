"""BFS hop distances: the all-pairs matrix and rows from a subset of sources.

Port of subgnn_tpu/precompute/shortest_paths.py. Output contract of both
functions: int32 rows indexed by RAW 0-based node id, hop distance,
unreached nodes left at 0 (the np.zeros fill artifact of the reference
precompute, prepare_dataset/precompute_graph_metrics.py:23-26). Hop
distances are exact, so every backend gives the same rows.

  * shortest_path_matrix — the dense (n, n) matrix the full-dataset
    precompute caches as shortest_path_matrix.npy. Backends: 'host' and
    'auto', the multithreaded C++ BFS of ops/native.py (the JAX package's
    'auto' rule whenever its library is there); 'device', frontier products
    against a dense adjacency on a torch device (the JAX package's
    _bfs_device), only on request. A mesh (parallel/mesh.py) forces the
    device BFS over every rank: partition 'sources' splits the sources
    over the ranks against a replicated adjacency, 'graph' the adjacency
    itself (parallel/partition.py).
  * shortest_path_rows — rows from the given sources only (serving, and
    precompute above the all-pairs size): 'auto' and 'host' through the
    C++ BFS, 'fallback' the numpy BFS.

The C++ library builds with g++ at first use; where it cannot build, 'auto'
and 'host' raise rather than drop to the numpy BFS, which is kept as the
plain version that the tests and the chip smoke test hold it against.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..data.graph import CSRGraph
from ..device import resolve_device
from ..ops import native
from ..parallel import mesh as MX
from ..parallel.partition import bfs_graph_partitioned

DEVICE_BFS_CHUNK = 256      # BFS sources per frontier product
PARTITIONS = ("sources", "graph")


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


def _bfs_device(graph: CSRGraph, device: str | torch.device,
                mesh: Optional[MX.Mesh] = None) -> np.ndarray:
    """Dense-adjacency BFS on a torch device, DEVICE_BFS_CHUNK sources at a
    time.

    The frontier of a chunk is a (chunk, n) 0/1 matrix; one level is its
    product with the (n, n) 0/1 adjacency, and a node's distance is written
    when it first enters the frontier. The loop runs until every frontier of
    the chunk is empty. Sums of 0/1 products are positive integers, so the
    `> 0` test is exact in bf16 (on the card) as in fp32 (on the CPU).

    With a mesh (on mesh.device) each chunk is rounded up to a multiple of
    the world and rank r runs its `world_block` of the chunk's sources
    against the whole adjacency, as the JAX package shards the padded
    chunk; the chunk's rows are gathered to every rank (`all_gather_world`,
    4 x chunk x n bytes a chunk)."""
    dev = resolve_device(device if mesh is None else mesh.device)
    n = graph.n_nodes
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    src = np.repeat(np.arange(n + 1), np.diff(graph.indptr)[:n + 1])
    adj = torch.zeros(n, n, dtype=dtype, device=dev)
    adj[torch.as_tensor(src - 1, device=dev),
        torch.as_tensor(graph.indices.astype(np.int64) - 1, device=dev)] = 1

    def bfs(start: int, dist: torch.Tensor) -> None:
        """Distances from sources start .. start + len(dist) - 1 into the
        zeroed (len(dist), n) int32 `dist`."""
        rows = torch.arange(dist.shape[0], device=dev)
        frontier = torch.zeros(dist.shape, dtype=torch.bool, device=dev)
        frontier[rows, start + rows] = True
        visited = frontier.clone()
        d = 0
        while bool(frontier.any()):
            d += 1
            new = ((frontier.to(dtype) @ adj) > 0) & ~visited
            dist.masked_fill_(new, d)
            visited |= new
            frontier = new

    out = torch.zeros(n, n, dtype=torch.int32, device=dev)
    if mesh is None:
        for start in range(0, n, DEVICE_BFS_CHUNK):
            bfs(start, out[start:start + DEVICE_BFS_CHUNK])
        return out.cpu().numpy()
    chunk = -(-DEVICE_BFS_CHUNK // mesh.world) * mesh.world
    lo, hi = mesh.world_block(chunk)
    for start in range(0, n, chunk):
        m = min(chunk, n - start)
        # sources past n are empty rows (distance 0), as in the JAX chunk
        mine = torch.zeros(hi - lo, n, dtype=torch.int32, device=dev)
        bfs(start + lo, mine[:max(0, min(hi, m) - lo)])
        out[start:start + m] = MX.all_gather_world(mine, chunk, mesh)[:m]
    return out.cpu().numpy()


def shortest_path_matrix(graph: CSRGraph, backend: str = "auto",
                         n_threads: int = 0,
                         device: str | torch.device = "cuda",
                         mesh: Optional[MX.Mesh] = None,
                         partition: str = "sources") -> np.ndarray:
    """Dense (n, n) all-pairs hop-distance matrix over RAW 0-based ids.

    backend: 'auto' and 'host', the C++ BFS with `n_threads` threads (0 =
    every hardware thread; the hp.n_processes knob); 'device', dense
    frontier products on `device`. A mesh forces the device BFS on every
    rank (on mesh.device; `backend` and `device` are not read), the matrix
    on every rank: `partition` 'sources' splits each chunk of BFS sources
    over the ranks (`_bfs_device`), 'graph' the adjacency's columns with a
    frontier exchange a level (parallel/partition.py)."""
    if partition not in PARTITIONS:
        raise ValueError(f"shortest_path_matrix partition={partition!r}: "
                         f"only {PARTITIONS} exist")
    if mesh is not None:
        if partition == "graph":
            return bfs_graph_partitioned(graph, mesh, DEVICE_BFS_CHUNK)
        return _bfs_device(graph, mesh.device, mesh)
    if backend == "device":
        return _bfs_device(graph, device)
    if backend not in ("auto", "host"):
        raise ValueError(f"shortest_path_matrix backend={backend!r}: only "
                         "'auto', 'host' and 'device' exist")
    return native.bfs_all_pairs(graph, n_threads=n_threads)


def shortest_path_rows(graph: CSRGraph, sources: np.ndarray,
                       backend: str = "auto",
                       n_threads: int = 0) -> np.ndarray:
    """(len(sources), n) int32 hop distances from each 1-based source node
    (unreached = 0). The N/P similarities only read distances FROM the
    subgraph/CC nodes (reference SubGNN.py:752-781), so serving, and the
    precompute of a graph above the all-pairs size, never build the n^2
    matrix. backend: 'auto' and 'host', the C++ BFS with `n_threads`
    threads; 'fallback', the numpy BFS (single-threaded)."""
    if backend not in ("auto", "host", "fallback"):
        raise ValueError(
            f"shortest_path_rows backend={backend!r}: only 'auto', 'host' "
            "(C++ threads) and 'fallback' (numpy) exist — there is no device "
            "variant for source subsets")
    if backend == "fallback":
        return _bfs_from_sources_host(
            graph, np.ascontiguousarray(sources, dtype=np.int64))
    return native.bfs_from_sources(graph, sources, n_threads=n_threads)


def ego_graphs_1hop(graph: CSRGraph) -> dict:
    """{raw 0-based id: [raw 0-based 1-hop neighbor ids]}, the content of
    the reference's ego_graphs.txt (precompute_graph_metrics.py:34-45)."""
    return {v - 1: (graph.neighbors(v) - 1).tolist()
            for v in range(1, graph.n_nodes + 1)}


def degree_dict(graph: CSRGraph) -> dict:
    """{raw 0-based id: degree}, the content of degree_sequence.txt
    (precompute_graph_metrics.py:47-59)."""
    deg = graph.degrees
    return {v - 1: int(deg[v]) for v in range(1, graph.n_nodes + 1)}
