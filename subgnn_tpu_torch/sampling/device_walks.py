"""Triangular random walks on a torch device, all walks in lockstep.

Port of subgnn_tpu/sampling/device_walks.py. The walk semantics follow the
host sampler (sampling/walks.py, reference: SubGNN/anchor_patch_samplers.py:
49-113): with probability rw_beta step to a neighbor that closes a triangle
with the previous node, else to a non-triangle neighbor; a walk whose node
has no neighbor ends, and PAD (0) fills the rest of its row.

The graph's CSR rows are padded to a fixed (n_nodes+1, max_deg) table, pads
first, so every step is a dense gather; the triangle test is the dense
(n_walks, max_deg, max_deg) membership compare of curr's row against prev's
row. Every draw of a walk is a uniform in [0, 1): one picks the start node,
one the first step, and two each later step (the class, then the neighbor
within it, as floor(u * count)). They come from a torch.Generator on the
tables' device, or are given (`uniforms`), so a test can hold the walker
against an oracle on the same numbers. The distribution is the JAX
walker's; the stream is not (JAX draws with stateless keys and Gumbel-max).
"""
from __future__ import annotations

import numpy as np
import torch

from ..data.graph import CSRGraph
from ..device import resolve_device

PAD_VALUE = 0


def padded_neighbor_table(graph: CSRGraph, max_deg: int | None = None,
                          device: str | torch.device = "cuda"):
    """((n_nodes+1, max_deg) int32 neighbor ids, 0-padded, rows sorted
    ascending with the pads at the FRONT; (n_nodes+1,) int32 degrees clamped
    to max_deg), on `device`."""
    dev = resolve_device(device)
    deg = graph.degrees
    if max_deg is None:
        max_deg = int(deg.max())
    # clamp degrees to the truncated row width: the walker picks among the
    # last `deg` entries of a row, which must all be kept neighbors
    deg = np.minimum(deg, max_deg)
    table = np.zeros((graph.n_nodes + 1, max_deg), dtype=np.int32)
    for v in range(1, graph.n_nodes + 1):
        nbrs = graph.neighbors(v)[:max_deg]
        table[v, max_deg - len(nbrs):] = nbrs
    return (torch.as_tensor(table, device=dev),
            torch.as_tensor(deg.astype(np.int32), device=dev))


def walk_uniforms(n_walks: int, walk_len: int,
                  generator: torch.Generator) -> torch.Tensor:
    """(n_walks, 2 * walk_len - 2) float32 uniforms in [0, 1) on the
    generator's device: column 0 picks the start, column 1 the first step,
    then columns 2 + 2t and 3 + 2t the class and the neighbor of step t."""
    return torch.rand(n_walks, 2 * walk_len - 2, generator=generator,
                      device=generator.device)


def uniform_index(u: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """floor(u * count) clamped to [0, max(count, 1) - 1]: a uniform index
    below count."""
    idx = (u * count.to(torch.float32)).to(torch.int64)
    return torch.minimum(idx, (count - 1).clamp(min=0).to(torch.int64))


def triangular_walks_device(nbr_table, degrees, start_nodes, *, walk_len: int,
                            n_walks: int, rw_beta: float,
                            generator: torch.Generator | None = None,
                            uniforms: torch.Tensor | None = None,
                            device: str | torch.device = "cuda"
                            ) -> torch.Tensor:
    """(n_walks, walk_len) int32 walks over the full graph, PAD=0.

    nbr_table, degrees: padded_neighbor_table's; start_nodes: 1-based ids
    the start is drawn from uniformly. The draws are `uniforms` (see
    walk_uniforms), else drawn from `generator` (default: a fresh one on
    `device`, seeded 0). Every tensor is moved to `device`."""
    dev = resolve_device(device)
    table = nbr_table.to(dev)
    degrees = degrees.to(dev).to(torch.int64)
    start_nodes = torch.as_tensor(start_nodes, device=dev).to(torch.int64)
    max_deg = table.shape[1]
    if uniforms is None:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        uniforms = walk_uniforms(n_walks, walk_len, generator)
    uniforms = uniforms.to(dev)
    if tuple(uniforms.shape) != (n_walks, 2 * walk_len - 2):
        raise ValueError(f"uniforms must be ({n_walks}, {2 * walk_len - 2}),"
                         f" got {tuple(uniforms.shape)}")
    rows = torch.arange(n_walks, device=dev)

    n_start = torch.tensor(start_nodes.numel(), device=dev)
    prev = start_nodes[uniform_index(uniforms[:, 0], n_start)]
    d_prev = degrees[prev]
    # uniform among the last d_prev entries of prev's row (PAD when 0)
    curr = table[prev,
                 max_deg - 1 - uniform_index(uniforms[:, 1], d_prev)].long()
    alive = d_prev > 0
    out = [prev, torch.where(alive, curr, PAD_VALUE)]
    for t in range(walk_len - 2):
        row = table[curr].long()                           # (W, max_deg)
        d = degrees[curr]
        valid = row != PAD_VALUE
        prev_row = table[prev].long()
        tri = valid & (row[:, :, None] == prev_row[:, None, :]).any(dim=-1)
        non_tri = valid & ~tri
        n_tri = tri.sum(dim=1)
        n_non = non_tri.sum(dim=1)
        take_tri = torch.where(
            n_tri == 0, False,
            torch.where(n_non == 0, True,
                        uniforms[:, 2 + 2 * t] <= rw_beta))
        cls = torch.where(take_tri[:, None], tri, non_tri)
        k = uniform_index(uniforms[:, 3 + 2 * t], cls.sum(dim=1))
        # the k-th (0-based) entry of the class, in row order
        hit = cls & (cls.cumsum(dim=1) == (k + 1)[:, None])
        nxt = row[rows, hit.to(torch.int8).argmax(dim=1)]
        alive = alive & (d > 0) & ((n_tri + n_non) > 0)
        out.append(torch.where(alive, nxt, PAD_VALUE))
        prev = torch.where(alive, curr, prev)
        curr = torch.where(alive, nxt, curr)
    return torch.stack(out[:walk_len], dim=1).to(torch.int32)


def sample_structure_pool_device(graph: CSRGraph, hp, seed: int,
                                 max_sim_epochs: int,
                                 device: str | torch.device = "cuda"
                                 ) -> np.ndarray:
    """Device-sampled structure anchor-patch pool (drop-in for
    sampling.walks.sample_structure_anchor_patches, another RNG stream),
    trailing all-PAD columns trimmed like the host sampler's."""
    dev = resolve_device(device)
    n_samples = max_sim_epochs * hp.n_anchor_patches_structure * hp.n_layers
    nbr_table, degrees = padded_neighbor_table(graph, device=dev)
    starts = torch.as_tensor(graph.node_ids(), device=dev)
    walks = triangular_walks_device(
        nbr_table, degrees, starts, walk_len=hp.sample_walk_len,
        n_walks=n_samples, rw_beta=hp.rw_beta,
        generator=torch.Generator(device=dev).manual_seed(seed), device=dev)
    out = walks.cpu().numpy()
    used = np.nonzero((out != PAD_VALUE).any(axis=0))[0]
    return out[:, : used.max() + 1] if used.size else out[:, :1]
