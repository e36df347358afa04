"""Graph partitioning and the distributed BFS with an explicit frontier
exchange.

Port of subgnn_tpu/parallel/partition.py. Two decompositions of the
all-pairs BFS over the ranks of a mesh exist:

  * source partitioning (precompute/shortest_paths.py `_bfs_device` with a
    mesh): each rank runs its share of the BFS sources against a
    replicated adjacency; its rows are gathered at the end of each chunk;
  * graph partitioning (this module): the 0/1 adjacency is split by
    destination-node column blocks, each rank holds only its block, and
    every BFS level exchanges the frontier: the ranks' (S, w) frontier
    columns are gathered to (S, n_pad) (`all_gather_world`) before the
    local product with the block. This is the decomposition that scales
    past one device's graph memory.

Each level ends with an all-reduce of the new-node count over every rank
(`all_reduce_world_`, JAX's psum), the loop's condition on every rank.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import mesh as MX


def _edges(graph) -> Tuple[np.ndarray, np.ndarray]:
    """(source, destination) of every directed CSR edge, 0-based raw ids."""
    counts = np.diff(graph.indptr[1:]).astype(np.int64)
    rows = np.repeat(np.arange(graph.n_nodes, dtype=np.int64), counts)
    return rows, graph.indices[graph.indptr[1]:].astype(np.int64) - 1


def adjacency_block(graph, n_parts: int, part: int, dtype: torch.dtype,
                    device) -> torch.Tensor:
    """Part `part`'s column block [part*w, (part+1)*w) of the 0/1 adjacency
    over 0-based raw node ids, zero-padded to n_pad = n_parts * w nodes (w
    = ceil(n / n_parts)), as (n_pad, w) `dtype` on `device`, built from the
    CSR without the whole matrix: the columns of the JAX package's
    padded_adjacency(graph, n_parts)."""
    w = -(-graph.n_nodes // n_parts)
    lo = part * w
    src, dst = _edges(graph)
    keep = (dst >= lo) & (dst < lo + w)
    block = torch.zeros(w * n_parts, w, dtype=dtype, device=device)
    block[torch.as_tensor(src[keep], device=device),
          torch.as_tensor(dst[keep] - lo, device=device)] = 1
    return block


def bfs_graph_partitioned(graph, mesh: MX.Mesh, chunk: int = 256
                          ) -> np.ndarray:
    """(n, n) int32 all-pairs BFS distances (unreached = 0, the host BFS's
    contract, reference precompute_graph_metrics.py:23-26) on every rank,
    with the graph partitioned over every rank of `mesh`: rank r holds
    columns [r*w, (r+1)*w) of the adjacency padded to n_pad = world * w
    nodes, and the frontier, visited set and distances of those columns.

    `chunk` sources at a time; each level gathers the chunk's frontier
    (S, n_pad) as int32 (gloo reduces no bool), multiplies it by the local
    block (bf16 on the card, exact for a test of > 0; float32 on the CPU)
    and sums the new-node count over the ranks. A chunk runs 1 + the
    largest hop count of its sources levels, each moving 4 x S x n_pad
    frontier bytes (`all_gather_world`) and an 8-byte count
    (`all_reduce_world_`); the distances are gathered once at the end, 4 x
    n x n_pad bytes."""
    dev = mesh.device
    n = graph.n_nodes
    w = -(-n // mesh.world)
    n_pad = w * mesh.world
    lo = mesh.rank * w
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    adj = adjacency_block(graph, mesh.world, mesh.rank, dtype, dev)
    dist = torch.zeros(n, w, dtype=torch.int32, device=dev)
    for start in range(0, n, chunk):
        m = min(chunk, n - start)
        src = torch.arange(start, start + m, device=dev)
        mine = (src >= lo) & (src < lo + w)
        frontier = torch.zeros(m, w, dtype=torch.int32, device=dev)
        frontier[torch.arange(m, device=dev)[mine], src[mine] - lo] = 1
        visited = frontier.bool()
        out = dist[start:start + m]
        d = 0
        while True:
            # the frontier exchange: every rank's columns of the frontier
            full = MX.all_gather_world(frontier, n_pad, mesh, dim=1)
            new = ((full.to(dtype) @ adj) > 0) & ~visited
            d += 1
            out.masked_fill_(new, d)
            visited |= new
            frontier = new.to(torch.int32)
            count = new.sum(dtype=torch.int64).reshape(1)
            MX.all_reduce_world_([count], mesh)
            if int(count) == 0:
                break
    full = MX.all_gather_world(dist, n_pad, mesh, dim=1)
    return full[:, :n].cpu().numpy()
