"""Degree sequences of node sets (structure-channel gamma inputs).

Reference: SubGNN/gamma.py:21-49. For a node set:
  * internal: sorted degrees within the induced subgraph,
  * border  : sorted (full degree - internal degree) per node.

A numpy copy of subgnn_tpu/precompute/degree.py.
"""
from __future__ import annotations

import numpy as np

from ..data.graph import CSRGraph

PAD_VALUE = 0


def degree_sequences(graph: CSRGraph, node_sets: np.ndarray, internal: bool):
    """Compute sorted degree sequences for each padded row of `node_sets`.

    node_sets: (N, L) int32 of 1-based node ids, PAD=0.
    Returns (seqs, lengths): seqs (N, L) float32 zero-padded at the tail,
    lengths (N,) int32 = number of real nodes per row.
    """
    node_sets = np.asarray(node_sets)
    n, L = node_sets.shape
    full_deg = graph.degrees
    seqs = np.zeros((n, L), dtype=np.float32)
    lengths = np.zeros(n, dtype=np.int32)
    for i in range(n):
        nodes = node_sets[i]
        nodes = nodes[nodes != PAD_VALUE]
        # duplicate entries (walk-derived structure patches revisit nodes)
        # are kept and contribute one degree value PER OCCURRENCE — exactly
        # the reference's nx `subgraph.degree(nodes)` with a duplicate
        # nbunch (gamma.py:30; networkx repeats duplicated nbunch nodes)
        if nodes.size == 0:
            continue
        internal_deg = graph.induced_degrees(nodes)
        if internal:
            seq = np.sort(internal_deg)
        else:
            seq = np.sort(full_deg[nodes] - internal_deg)
        seqs[i, :len(seq)] = seq
        lengths[i] = len(seq)
    return seqs, lengths
