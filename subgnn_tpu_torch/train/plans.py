"""Host-side gather plans for training batches.

Port of subgnn_tpu/train/plans.py. The model's embedding-table lookups
(cc-id init and the per-layer neighborhood anchor gathers, reference:
SubGNN/SubGNN.py:609-622, anchor_patch_samplers.py:352-364) go through
ops/embedding.embedding_gather when the batch carries matching plans, so
the table gradient is the plan-routed kernel instead of a scatter-add.
Anchor ids and the batch schedule are host-known before the step, so plans
are built here in numpy and shipped with the batch (stacked per epoch for
the fused trainer, train/loop.py).

A PlanBuilder remembers the tile count per plan name and only grows it
(with headroom) when a batch needs more, so same-shaped batches get
same-shaped plans. Tiling is row-split (ops/embedding.py): skewed id
distributions (hub nodes, the PAD row) cost extra tiles, never wider tiles.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

import torch

from ..ops.embedding import GatherPlan, make_gather_plan, tiles_needed


def neigh_ids_for_batch(anchors, idx: np.ndarray) -> np.ndarray:
    """(L, B, C, A_in+A_out) ids exactly as the forward consumes them
    (models/subgnn.py n_ids_all: internal then border along the last
    axis)."""
    n_int = np.asarray(anchors["neigh_int"])
    n_bor = np.asarray(anchors["neigh_bor"])
    return np.concatenate([n_int[:, idx], n_bor[:, idx]], axis=-1)


class PlanBuilder:
    """Builds per-batch plans with sticky, growth-only tile counts.
    `row_range`: (lo, hi) of a node-axis rank's table rows, whose plans
    route only the ids in them (make_gather_plan)."""

    def __init__(self, n_rows: int, row_range: Optional[tuple] = None):
        self.n_rows = int(n_rows)
        self.row_range = row_range
        self.tiles: Dict[str, int] = {}

    @property
    def plan_rows(self) -> int:
        """The rows a plan covers: the range's, else the whole table's."""
        if self.row_range is None:
            return self.n_rows
        return self.row_range[1] - self.row_range[0]

    def _tiles(self, name: str, ids: np.ndarray) -> int:
        need = tiles_needed(ids, self.n_rows, self.row_range)
        prev = self.tiles.get(name, 0)
        if need > prev:
            # growing: ~6% headroom so shuffle-to-shuffle variation does not
            # change the plan shape every epoch
            need = max(need + 2, int(need * 1.0625))
        t = max(prev, need)
        self.tiles[name] = t
        return t

    def build(self, name: str, ids: np.ndarray) -> GatherPlan:
        return make_gather_plan(ids, self.n_rows,
                                n_tiles=self._tiles(name, ids),
                                row_range=self.row_range)

    def build_stacked(self, name: str, ids_per_batch) -> GatherPlan:
        """One plan per batch, all with one tile count (the most any batch
        asks for), stacked along a leading axis: CPU int32 tensors
        (n_batches, T, W), (n_batches, T, W) and (n_batches, T)."""
        t = max(self._tiles(name, ids) for ids in ids_per_batch)
        self.tiles[name] = t
        plans = [make_gather_plan(ids, self.n_rows, n_tiles=t,
                                  row_range=self.row_range)
                 for ids in ids_per_batch]
        return GatherPlan(torch.stack([p.pos for p in plans]),
                          torch.stack([p.local for p in plans]),
                          torch.stack([p.block for p in plans]),
                          self.plan_rows)


def epoch_plans(builder: Optional[PlanBuilder], hp, cc_ids: np.ndarray,
                anchors, order: np.ndarray) -> Dict[str, GatherPlan]:
    """Stacked plans for every batch of an epoch schedule `order`
    ((n_batches, B) subgraph indices), keyed as the forward reads them."""
    if builder is None:
        return {}
    cc_np = np.asarray(cc_ids)
    plans = {"cc_plan": builder.build_stacked(
        "cc", [cc_np[idx] for idx in order])}
    if hp.use_neighborhood:
        plans["neigh_plan"] = builder.build_stacked(
            "neigh", [neigh_ids_for_batch(anchors, idx) for idx in order])
    return plans


def batch_plans(builder: Optional[PlanBuilder], hp, batch_cc_ids: np.ndarray,
                anchors, idx: np.ndarray) -> Dict[str, GatherPlan]:
    """Plans for one batch (CPU tensors). batch_cc_ids is the batch's OWN
    (B, C, L) id array, so padded short-batch rows match the gather
    exactly; `anchors` are the split's host anchor arrays."""
    if builder is None:
        return {}
    plans = {"cc_plan": builder.build("cc", np.asarray(batch_cc_ids))}
    if hp.use_neighborhood:
        plans["neigh_plan"] = builder.build(
            "neigh", neigh_ids_for_batch(anchors, idx))
    return plans
