"""Gather plans for training batches.

Port of subgnn_tpu/train/plans.py. The model's embedding-table lookups
(cc-id init and the per-layer neighborhood anchor gathers, reference:
SubGNN/SubGNN.py:609-622, anchor_patch_samplers.py:352-364) go through
ops/embedding.embedding_gather when the batch carries matching plans, so
the table gradient is the plan-routed kernel instead of a scatter-add.

Two places build them. A fused fit off a node axis builds each train
step's plans on the device, inside the captured step, from the ids the
step gathers (`device_batch_plans`, called by train/loop.py:_FusedRun's
train step): the same plans as the host's, at a fixed tile count that no
batch can exceed (`plan_tiles_bound`), so the step's shapes never change
and nothing waits for the host. The host builds them in numpy
(`batch_plans`, `epoch_plans`) where a plan covers a node-axis rank's rows
alone (`row_range`) and in the streaming mode: the anchor ids and the batch
schedule are host-known before the step, so the plans ship with the batch
(stacked per epoch for the fused trainer).

A PlanBuilder remembers the tile count per plan name and only grows it
(with headroom) when a batch needs more, so same-shaped batches get
same-shaped plans. Tiling is row-split (ops/embedding.py): skewed id
distributions (hub nodes, the PAD row) cost extra tiles, never wider tiles.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

import torch

from ..ops.embedding import (TABLE_BLOCK, TILE_WIDTH, GatherPlan,
                             make_gather_plan, tiles_needed)


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


def plan_tiles_bound(n_ids: int, n_rows: int) -> int:
    """The most tiles a plan of `n_ids` ids over a table of `n_rows` rows can
    need, whatever the ids: n_blocks + n_ids // TILE_WIDTH.

    A block of c ids needs max(ceil(c / W), 1) tiles (W = TILE_WIDTH), which
    is at most floor(c / W) + 1: for c = 0 both are 1, and for c >= 1
    ceil(c / W) = floor((c - 1) / W) + 1. Summed over the n_blocks blocks,
    the plan needs at most n_blocks + sum floor(c_b / W), and a sum of
    floors is at most the floor of the sum, n_ids // W. The bound is
    reached where no block holds a positive multiple of W ids and the
    blocks' remainders mod W sum to under W (every block holding 1 mod W)."""
    return -(-n_rows // TABLE_BLOCK) + n_ids // TILE_WIDTH


def device_gather_plan(ids: torch.Tensor, n_rows: int) -> GatherPlan:
    """make_gather_plan(ids, n_rows, n_tiles=plan_tiles_bound(...)) on the
    ids' device, element for element, in operations of fixed shape that a
    CUDA graph captures and that never wait for the host. No id multiset
    needs more tiles than the bound, so the plan needs no check (which
    would read a count back).

    The stable sort gives make_gather_plan's order; each block's first
    sorted slot is a binary search for its first row, so the counts come
    from the sorted ids (no atomic adds on the PAD row's block, which
    holds most ids). A sorted slot of block b and rank r in it goes to
    slot tile_start[b] * W + r of the flat (n_tiles * W) plan, prefilled
    with the padding slots' values; a tile's block is a binary search of
    the tiles' ends, padding tiles clamped to the last block."""
    W = TILE_WIDTH
    n_blocks = -(-n_rows // TABLE_BLOCK)
    n_tiles = plan_tiles_bound(ids.numel(), n_rows)
    dev = ids.device
    flat = ids.reshape(-1).to(torch.int32)
    n = flat.numel()
    sorted_ids, order = torch.sort(flat, stable=True)
    edges = torch.arange(0, (n_blocks + 1) * TABLE_BLOCK, TABLE_BLOCK,
                         dtype=torch.int32, device=dev)
    starts = torch.searchsorted(sorted_ids, edges)        # (n_blocks + 1,)
    tiles = (starts.diff() + (W - 1)).div_(W, rounding_mode="floor")
    tile_end = tiles.clamp_(min=1).cumsum(0)              # inclusive
    blk = sorted_ids.div(TABLE_BLOCK, rounding_mode="floor").long()
    dest = ((tile_end - tiles)[blk] * W - starts[blk]
            + torch.arange(n, device=dev))
    pos = torch.full((n_tiles * W,), n, dtype=torch.int32, device=dev)
    pos.scatter_(0, dest, order.to(torch.int32))
    local = torch.full((n_tiles * W,), TABLE_BLOCK, dtype=torch.int32,
                       device=dev)
    local.scatter_(0, dest, sorted_ids.remainder(TABLE_BLOCK))
    block = torch.searchsorted(
        tile_end, torch.arange(n_tiles, device=dev), right=True
    ).clamp_(max=n_blocks - 1).to(torch.int32)
    return GatherPlan(pos.view(n_tiles, W), local.view(n_tiles, W), block,
                      int(n_rows))


def device_batch_plans(hp, cc_ids: torch.Tensor, anchors, idx: torch.Tensor,
                       n_rows: int) -> Dict[str, GatherPlan]:
    """batch_plans on the device, for a fused train step to call: the plans
    of the batch's `cc_ids` (B, C, L) and, with the neighborhood channel,
    of its anchor ids as the forward gathers them (`neigh_ids_for_batch`,
    from the split's device anchor dict at subgraph indices `idx`), each
    at plan_tiles_bound tiles."""
    plans = {"cc_plan": device_gather_plan(cc_ids, n_rows)}
    if hp.use_neighborhood:
        plans["neigh_plan"] = device_gather_plan(
            torch.cat([anchors["neigh_int"][:, idx],
                       anchors["neigh_bor"][:, idx]], dim=-1), n_rows)
    return plans
