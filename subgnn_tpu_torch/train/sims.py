"""Compact NP-similarity gathers (anchor columns only).

Port of subgnn_tpu/train/sims.py. The model only reads the
(n_sub, max_cc, n_nodes) shortest-path similarity tensor at sampled
anchor-node columns (reference: subgraph_mpn.py:91-94), so a batch carries
those columns as (L, B, C, A) tensors instead of (B, C, n_nodes) rows.
Index math mirrors models/subgnn.py (same clip semantics), so results equal
the full-tensor path.

Two places gather them. On the card a fused fit keeps both splits' NP sims
resident and each captured step gathers its own batch's columns
(`device_compact_sims`, called by train/loop.py:_FusedRun's steps): the
same float32 values the host would copy, at no host cost. The host gathers
them in numpy (`compact_sims_for_batch`, `epoch_compact_sims`) where the NP
sims stay off the device: a fit on a node axis (a rank holds a slice of the
columns), NP sims over half the card's free memory at the fit's start, a
streaming fit, serving and the benchmark scripts.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

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


def device_compact_sims(np_sim: torch.Tensor, anchors, hp,
                        idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """compact_sims_for_batch on the device, for a fused step to call.

    np_sim:  a split's resident (n_split, C, n_nodes) float32 NP sims,
             contiguous
    anchors: the split's device anchor dict (layer-major int64 tensors)
    idx:     (B,) int64 subgraph indices into the split

    Returns the same keys, shapes and float32 values as the numpy version:
    neighbourhood and internal position anchors clip to [0, n_nodes - 1],
    a border position anchor's PAD id reads the last column (numpy's -1).
    The flat offsets are int64: (idx * C + c) * n_nodes + j passes 2**31
    on a large split."""
    out: Dict[str, torch.Tensor] = {}
    _, C, n_nodes = np_sim.shape
    flat = np_sim.reshape(-1)
    # (1, B, C, 1) offset of each row's component slot
    base = (idx.long()[:, None] * (C * n_nodes)
            + torch.arange(0, C * n_nodes, n_nodes,
                           device=idx.device))[None, :, :, None]

    if hp.use_neighborhood:
        ids = torch.cat([anchors["neigh_int"][:, idx],
                         anchors["neigh_bor"][:, idx]], dim=-1)  # (L,B,C,A)
        out["neigh_sims"] = flat[base + (ids - 1).clamp_(0, n_nodes - 1)]

    if hp.use_position:
        j = (anchors["pos_int"][:, idx] - 1).clamp_(0, n_nodes - 1)  # (L,B,A)
        out["pos_in_sims"] = flat[base + j[:, :, None, :]]
        j = torch.remainder(anchors["pos_ext"] - 1, n_nodes)  # (L, A)
        out["pos_out_sims"] = flat[base + j[:, None, None, :]]

    return out
