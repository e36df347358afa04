"""Triangular random walks over CSR graphs.

Reference semantics (SubGNN/anchor_patch_samplers.py:20-158): a walk prefers
(with probability rw_beta) stepping to a neighbor that closes a triangle with
the previous node. Walks are used (1) to sample structure anchor patches over
the base graph and (2) to produce internal/border walk sequences over each
anchor patch that the bi-LSTM encodes.

This implementation walks the CSR arrays directly (no graph object) and uses
per-walk seeded np.random.Generator streams: every walk is reproducible from
(seed, patch_index, walk_index) regardless of host count or execution order —
a deliberate upgrade over the reference's global-RNG streams (identical
distribution, different stream).

These walks are offline precompute (cached to .npy); the hot training path
never executes them, so host-side NumPy is the right tool.

A numpy copy of subgnn_tpu/sampling/walks.py: the same seeded streams give
bit-identical pools and walks in both packages.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..data.graph import CSRGraph

PAD_VALUE = 0


def _neighbors_restricted(graph: CSRGraph, v: int,
                          member: Optional[np.ndarray]) -> np.ndarray:
    nbrs = graph.neighbors(v)
    if member is None:
        return nbrs
    return nbrs[member[nbrs]]


def _split_triangular(graph: CSRGraph, prev: int, curr: int,
                      neighbors: np.ndarray,
                      member: Optional[np.ndarray]):
    """Split `neighbors` of curr into triangle-closing vs not, w.r.t. prev.

    Triangle check is within the same restricted graph used for neighbor
    expansion (reference: anchor_patch_samplers.py:26-47 passes the induced
    subgraph when inside, full graph when border).
    """
    prev_nbrs = _neighbors_restricted(graph, prev, member)
    tri_mask = np.isin(neighbors, prev_nbrs, assume_unique=False)
    return neighbors[tri_mask], neighbors[~tri_mask]


def triangular_random_walk(graph: CSRGraph, rng: np.random.Generator,
                           walk_len: int, rw_beta: float,
                           start_nodes: np.ndarray,
                           member: Optional[np.ndarray] = None,
                           border_member: Optional[np.ndarray] = None) -> list:
    """One triangular random walk; returns the list of visited node ids.

    start_nodes: candidate start nodes (1-based).
    member: bool[(n_nodes+1,)] restricting the walk to an induced subgraph
        (internal walks), or None for the full graph.
    border_member: when set, this is a border walk — the start node is drawn
        from `start_nodes` (the patch's in-border nodes) and every step is
        restricted to border_member (in-border + external nodes)
        (reference: anchor_patch_samplers.py:76-80).

    Mirrors anchor_patch_samplers.py:49-113: walk ends early at dead ends;
    a start node with no neighbors yields a length-1 walk.
    """
    restrict = border_member if border_member is not None else member
    prev = int(rng.choice(start_nodes))
    nbrs = _neighbors_restricted(graph, prev, restrict)
    if nbrs.size == 0:
        return [prev]
    curr = int(rng.choice(nbrs))
    visited = [prev, curr]
    for _ in range(walk_len - 2):
        nbrs = _neighbors_restricted(graph, curr, restrict)
        if nbrs.size == 0:
            break
        tri, non_tri = _split_triangular(graph, prev, curr, nbrs, restrict)
        if tri.size == 0:
            nxt = int(rng.choice(non_tri))
        elif non_tri.size == 0:
            nxt = int(rng.choice(tri))
        elif rng.uniform() <= rw_beta:
            nxt = int(rng.choice(tri))
        else:
            nxt = int(rng.choice(non_tri))
        prev, curr = curr, nxt
        visited.append(nxt)
    return visited


def sample_structure_anchor_patches(graph: CSRGraph, hp, seed: int,
                                    max_sim_epochs: int) -> np.ndarray:
    """Pre-sample the large pool of structure anchor patches.

    n_samples = max_sim_epochs * n_anchor_patches_structure * n_layers
    (reference: anchor_patch_samplers.py:210-243). Returns
    (n_samples, max_patch_len) int32, PAD=0.
    """
    n_samples = max_sim_epochs * hp.n_anchor_patches_structure * hp.n_layers
    all_nodes = graph.node_ids()
    patches = []
    for i in range(n_samples):
        rng = np.random.default_rng([seed, 101, i])
        if hp.structure_patch_type == "triangular_random_walk":
            patch = triangular_random_walk(
                graph, rng, hp.sample_walk_len, hp.rw_beta,
                start_nodes=all_nodes)
        elif hp.structure_patch_type == "ego_graph":
            start = int(rng.choice(all_nodes))
            patch = sorted(graph.khop_neighborhood(
                [start], hp.structure_anchor_patch_radius))
        else:
            raise NotImplementedError(hp.structure_patch_type)
        patches.append(patch)
    max_len = max(len(p) for p in patches)
    out = np.full((n_samples, max_len), PAD_VALUE, dtype=np.int32)
    for i, p in enumerate(patches):
        out[i, :len(p)] = p
    return out


def perform_random_walks(graph: CSRGraph, hp, anchor_patches: np.ndarray,
                         inside: bool, seed: int) -> np.ndarray:
    """(n_patches, n_triangular_walks, random_walk_len) int32 walk node ids.

    Internal walks stay within each anchor patch's induced subgraph; border
    walks start at the patch's in-border nodes and roam over in-border +
    external nodes (reference: anchor_patch_samplers.py:118-158).
    """
    n_patches = anchor_patches.shape[0]
    W, L = hp.n_triangular_walks, hp.random_walk_len
    if L < 2:
        # walks are [start, neighbor, ...] — the reference's walker also
        # always emits >=2 nodes when the start has a neighbor
        raise ValueError(f"random_walk_len must be >= 2, got {L}")
    out = np.full((n_patches, W, L), PAD_VALUE, dtype=np.int32)
    for p in range(n_patches):
        patch = anchor_patches[p]
        patch = patch[patch != PAD_VALUE]
        if patch.size == 0:
            continue
        if inside:
            member = np.zeros(graph.n_nodes + 1, dtype=bool)
            member[patch] = True
            start_nodes, border_member = patch, None
        else:
            in_border, external = graph.border_nodes(patch.tolist())
            border_member = np.zeros(graph.n_nodes + 1, dtype=bool)
            border_member[in_border] = True
            border_member[external] = True
            member = None
            if in_border.size == 0:
                # every patch node is interior (the patch covers a whole
                # connected component): no border walk exists. Keep the PAD
                # walks — empty border degree sequence, like an all-padding
                # patch. Documented deviation: the reference CRASHES here
                # (np.random.choice of the empty in_border_nodes,
                # anchor_patch_samplers.py:78).
                continue
            start_nodes = in_border
        for w in range(W):
            rng = np.random.default_rng([seed, 211 if inside else 223, p, w])
            walk = triangular_random_walk(
                graph, rng, L, hp.rw_beta, start_nodes=start_nodes,
                member=member, border_member=border_member)
            out[p, w, :len(walk)] = walk[:L]
    return out
