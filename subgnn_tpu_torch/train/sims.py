"""Host-side compact NP-similarity gathers (anchor columns only).

Port of subgnn_tpu/train/sims.py. The model only reads the
(n_sub, max_cc, n_nodes) shortest-path similarity tensor at sampled
anchor-node columns (reference: subgraph_mpn.py:91-94), and anchors and the
batch schedule are host-known, so those columns are gathered here in numpy
and shipped as (L, B, C, A) tensors. Index math mirrors models/subgnn.py
(same clip semantics), so results equal the full-tensor path.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from .plans import neigh_ids_for_batch


def compact_sims_for_batch(np_sim: np.ndarray, anchors, hp,
                           idx: np.ndarray) -> Dict[str, np.ndarray]:
    """Anchor-column similarity tensors for one batch.

    np_sim:  host (n_split, C, n_nodes) float32
    anchors: the split's anchor dict (layer-major arrays)
    idx:     (B,) subgraph indices into the split

    Returns float32 arrays keyed as the model forward consumes them:
      neigh_sims   (L, B, C, A_N_in+A_N_out)   [if use_neighborhood]
      pos_in_sims  (L, B, C, A_P_in)           [if use_position]
      pos_out_sims (L, B, C, A_P_out)          [if use_position]
    """
    out: Dict[str, np.ndarray] = {}
    n_nodes = np_sim.shape[2]
    C = np_sim.shape[1]
    rows = np.asarray(idx)[None, :, None, None]          # (1, B, 1, 1)
    cols = np.arange(C)[None, None, :, None]             # (1, 1, C, 1)

    if hp.use_neighborhood:
        ids = neigh_ids_for_batch(anchors, np.asarray(idx))  # (L,B,C,A)
        j = np.clip(ids - 1, 0, n_nodes - 1)
        out["neigh_sims"] = np.ascontiguousarray(
            np_sim[rows, cols, j], np.float32)

    if hp.use_position:
        ids_in = np.asarray(anchors["pos_int"])[:, np.asarray(idx)]  # (L,B,A)
        j = np.clip(ids_in - 1, 0, n_nodes - 1)[:, :, None, :]
        out["pos_in_sims"] = np.ascontiguousarray(
            np_sim[rows, cols, j], np.float32)
        ids_out = np.asarray(anchors["pos_ext"])          # (L, A)
        j = (ids_out - 1)[:, None, None, :]
        out["pos_out_sims"] = np.ascontiguousarray(
            np_sim[rows, cols, j], np.float32)

    return out


def epoch_compact_sims(np_sim: np.ndarray, anchors, hp,
                       order: np.ndarray) -> Dict[str, np.ndarray]:
    """compact_sims_for_batch for every batch of an epoch schedule `order`
    ((n_batches, B)), stacked: float32 (n_batches, L, B, C, A) arrays."""
    per_batch = [compact_sims_for_batch(np_sim, anchors, hp, idx)
                 for idx in order]
    if not per_batch:
        return {}
    return {k: np.stack([b[k] for b in per_batch]) for k in per_batch[0]}
