"""K-hop border sets for each connected component of each subgraph.

Reference: SubGNN/SubGNN.py:673-747 + subgraph_utils.py:146-176. The border
set of a CC is the union of radius-k ego graphs around its nodes minus the
CC itself, padded to (n_subgraphs, max_n_cc, max_border_len) with PAD=0.

Full-dataset precompute walks the CSR k-hop balls (compute_border_sets);
serving derives the sets from the BFS rows it already fetched for the NP
similarities (border_sets_from_rows). Both give the same sets.

NOTE a deliberate deviation, kept from the JAX package: when the reference
loads a precomputed ego_graphs.txt it uses the 1-hop ego lists regardless of
the configured radius AND mixes their 0-based ids with its 1-based node ids
(subgraph_utils.py:165-170) — an off-by-one. compute_border_sets computes
the correct radius-k, 1-based sets; shift_compat=True reproduces the
reference's file-loading behaviour for parity studies.

A numpy copy of subgnn_tpu/precompute/border.py.
"""
from __future__ import annotations

import numpy as np

from ..data.graph import CSRGraph

PAD_VALUE = 0


def _pad_border_sets(all_sets, n_sub, max_n_cc):
    """Pad per-CC border id lists to (n_sub, max_n_cc, max_len) int32,
    PAD=0, max_len >= 1 — the one place the layout convention lives."""
    max_len = max((len(b) for row in all_sets for b in row), default=1)
    max_len = max(max_len, 1)
    out = np.full((n_sub, max_n_cc, max_len), PAD_VALUE, dtype=np.int32)
    for s, row in enumerate(all_sets):
        for c, b in enumerate(row):
            out[s, c, :len(b)] = b
    return out


def border_sets_from_rows(srcs: np.ndarray, rows: np.ndarray,
                          cc_ids: np.ndarray, radius: int,
                          n_nodes: int) -> np.ndarray:
    """compute_border_sets from precomputed BFS distance rows:
    border(cc) = {v : 1 <= min_{u in cc} d(u, v) <= radius}. Exactly the
    radius-k ball minus the CC (d(u,u)=0 and unreached=0 share the 0
    sentinel; both are correctly excluded by the >=1 bound). Serving uses
    this because the NP-sim path already fetched distance rows for every
    CC node (runner.predict LRU row cache) — deriving the k-hop balls
    from them is a vectorized reduce over in-memory arrays, vs the 18 s
    the CSR k-hop walk cost per 32-request batch on hub-heavy
    EM-USER-scale graphs (PERF.md round-5 serving section).

    srcs: (S,) 1-based source ids; rows: (S, n_nodes) int32 hop
    distances with 0-based columns (shortest_path_rows convention)."""
    idx = np.zeros(n_nodes + 1, np.int64)
    idx[srcs] = np.arange(len(srcs))
    n_sub, max_n_cc, _ = cc_ids.shape
    all_sets = []
    for s in range(n_sub):
        row_sets = []
        for c in range(max_n_cc):
            comp = cc_ids[s, c]
            comp = comp[comp != PAD_VALUE]
            if comp.size == 0:
                row_sets.append(np.zeros(0, dtype=np.int32))
                continue
            d = rows[idx[comp]]                        # (n_comp, n_nodes)
            within = ((d >= 1) & (d <= radius)).any(axis=0)
            mask = np.zeros(n_nodes + 1, bool)
            mask[1:1 + within.shape[0]] = within       # col j -> id j+1
            mask[comp] = False
            row_sets.append(np.flatnonzero(mask).astype(np.int32))
        all_sets.append(row_sets)
    return _pad_border_sets(all_sets, n_sub, max_n_cc)


def compute_border_sets(graph: CSRGraph, cc_ids: np.ndarray, radius: int,
                        shift_compat: bool = False) -> np.ndarray:
    """(n_subgraphs, max_n_cc, max_border_len) int32, PAD=0: the radius-k
    ball around each CC minus the CC."""
    n_sub, max_n_cc, _ = cc_ids.shape
    all_sets = []
    for s in range(n_sub):
        row = []
        for c in range(max_n_cc):
            comp = cc_ids[s, c]
            comp = comp[comp != PAD_VALUE]
            if comp.size == 0:
                row.append(np.zeros(0, dtype=np.int32))
                continue
            if shift_compat:
                # reference quirk: 1-hop ego lists in RAW 0-based ids,
                # minus the 1-based component set
                nbhd = set()
                for v in comp:
                    nbhd.update((graph.neighbors(int(v)) - 1).tolist())
                border = nbhd - set(int(v) for v in comp)
                row.append(np.asarray(sorted(border), dtype=np.int32))
            else:
                mask = graph.khop_mask(comp.tolist(), radius)
                mask[comp] = False
                row.append(np.flatnonzero(mask).astype(np.int32))
        all_sets.append(row)
    return _pad_border_sets(all_sets, n_sub, max_n_cc)
