"""Embedding gather whose backward routes gradients by a gather plan.

Port of subgnn_tpu/ops/embedding.py. The gradient of `table[ids]` is
routed by a **gather plan** of the ids: the flat ids sorted once, bucketed
by 128-row table block, and cut into tiles of 512 id slots (hot blocks
such as the PAD row get many tiles, never wider ones). `make_gather_plan`
builds one in numpy, from ids known on the host before the step;
train/plans.py:device_gather_plan builds the same plan on the device,
inside a fused train step.

`segment_matmul` computes the table gradient from that plan:

    dtable[row] = sum of g[pos] over the plan slots whose id is `row`,

accumulated in fp32 and written in g's dtype, which is the table's. It replaces the Pallas
TPU kernel subgnn_tpu/ops/embedding.py:_segment_matmul_pallas. A CUDA tensor
launches csrc/segment_matmul.cu (a deterministic segmented row reduction;
see the source for its design and bound); a CPU tensor takes the plain
version `segment_matmul_torch`, the torch form of `_segment_matmul_xla`
(a per-tile one-hot product). `embedding_gather` wraps the gather and that
backward in a `torch.autograd.Function`; `shard_gather` is its form for
one rank's rows of a table sharded over the node axis of a mesh.

The same sum is a sparse-dense product over a fixed edge array:
`segment_sum(msgs, dst, plan)` is out[v] = sum of msgs[e] over the edges
with dst[e] = v, with `plan` built by make_gather_plan from `dst`. Its
backward is the gather grad[dst]; the node-embedding pretrainer
(prepare/node_emb.py) pairs it with `embedding_gather` by `src`, so both
directions of its SpMM run on the kernel.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

TABLE_BLOCK = 128   # table rows per plan block
TILE_WIDTH = 512    # id slots per plan tile


class GatherPlan(NamedTuple):
    """Static routing for the backward of `table[ids]`.

    pos:   (n_tiles, W) int32 — index into the flat ids (ids.reshape(-1));
           padding slots hold n_ids and are never read.
    local: (n_tiles, W) int32 — id - block*TABLE_BLOCK for real slots,
           TABLE_BLOCK for padding slots. Sorted within each block's tiles.
    block: (n_tiles,) int32 — table block of each tile; non-decreasing,
           covers every block at least once; padding tiles map to the last.
    n_rows: number of table rows the plan covers.
    """

    pos: torch.Tensor
    local: torch.Tensor
    block: torch.Tensor
    n_rows: int

    def to(self, device) -> "GatherPlan":
        return GatherPlan(self.pos.to(device), self.local.to(device),
                          self.block.to(device), self.n_rows)


def _in_range(flat: np.ndarray, row_range):
    """(ids as rows of the range, their flat positions, the range's rows)."""
    lo, hi = row_range
    pos = np.flatnonzero((flat >= lo) & (flat < hi))
    return flat[pos] - lo, pos, hi - lo


def tiles_needed(ids: np.ndarray, n_rows: int, row_range=None) -> int:
    """Tile count make_gather_plan would use for this id multiset."""
    flat = np.asarray(ids, np.int64).reshape(-1)
    if row_range is not None:
        flat, _, n_rows = _in_range(flat, row_range)
    n_blocks = -(-n_rows // TABLE_BLOCK)
    counts = np.bincount(flat // TABLE_BLOCK, minlength=n_blocks)
    return int(np.maximum(-(-counts // TILE_WIDTH), 1).sum())


def make_gather_plan(ids: np.ndarray, n_rows: int,
                     n_tiles: int | None = None,
                     row_range: tuple | None = None) -> GatherPlan:
    """Build the backward routing for a static id array (host, numpy).

    ids may have any shape; values in [0, n_rows). `n_tiles` fixes the tile
    count (>= tiles_needed) so plans of same-shaped batches share one shape;
    it defaults to exactly tiles_needed. Padding tiles are appended, mapped
    to the last block. Returns CPU int32 tensors (GatherPlan.to moves them).

    `row_range` (lo, hi): the plan of a node-axis shard, table rows [lo, hi)
    alone (parallel/mesh.py): ids outside the range get no slot, the slots
    keep their positions in the flat ids, a slot's row is id - lo, and the
    plan's n_rows is hi - lo.
    """
    flat = np.asarray(ids, np.int64).reshape(-1)
    if flat.size and (flat.min() < 0 or flat.max() >= n_rows):
        raise ValueError("ids out of range for table")
    n_ids = flat.size
    where = None
    if row_range is not None:
        flat, where, n_rows = _in_range(flat, row_range)
    n_blocks = -(-n_rows // TABLE_BLOCK)
    order = np.argsort(flat, kind="stable").astype(np.int64)
    sorted_ids = flat[order]
    if where is not None:
        order = where[order]       # positions in the whole flat ids
    counts = np.bincount(sorted_ids // TABLE_BLOCK, minlength=n_blocks)
    tiles_per_block = np.maximum(-(-counts // TILE_WIDTH), 1)
    need = int(tiles_per_block.sum())
    if n_tiles is None:
        n_tiles = need
    if need > n_tiles:
        raise ValueError(f"plan needs {need} tiles > requested {n_tiles}")

    W = TILE_WIDTH
    pos = np.full((n_tiles, W), n_ids, np.int64)
    local = np.full((n_tiles, W), TABLE_BLOCK, np.int64)
    block = np.full(n_tiles, n_blocks - 1, np.int64)
    t = 0
    start = 0
    for b in range(n_blocks):
        c = int(counts[b])
        for k in range(int(tiles_per_block[b])):
            lo = start + k * W
            hi = min(start + c, lo + W)
            m = max(hi - lo, 0)
            if m:
                pos[t, :m] = order[lo:hi]
                local[t, :m] = sorted_ids[lo:hi] - b * TABLE_BLOCK
            block[t] = b
            t += 1
        start += c
    return GatherPlan(torch.from_numpy(pos.astype(np.int32)),
                      torch.from_numpy(local.astype(np.int32)),
                      torch.from_numpy(block.astype(np.int32)), int(n_rows))


# ---------------------------------------------------------------- backward


def segment_matmul_torch(g: torch.Tensor, plan: GatherPlan,
                         out_rows: int | None = None) -> torch.Tensor:
    """Plain version of `segment_matmul`: per-tile one-hot product plus a
    block-level scatter-add, in fp32 (the torch form of
    subgnn_tpu/ops/embedding.py:_segment_matmul_xla).

    g: (n_ids, D) flat cotangent rows. Returns (out_rows, D) in g's dtype
    (out_rows defaults to plan.n_rows; rows past plan.n_rows are zero)."""
    out_rows = plan.n_rows if out_rows is None else out_rows
    D = g.shape[-1]
    n_blocks = -(-plan.n_rows // TABLE_BLOCK)
    g_pad = torch.cat([g.float(), g.new_zeros(1, D, dtype=torch.float32)])
    pos = plan.pos.long().clamp(max=g.shape[0])       # padding -> zero row
    gb = g_pad[pos]                                             # (T, W, D)
    onehot = (plan.local.long()[:, :, None]
              == torch.arange(TABLE_BLOCK, device=g.device))    # (T, W, BT)
    contrib = torch.einsum("twb,twd->tbd", onehot.float(), gb)  # (T, BT, D)
    out = torch.zeros(n_blocks, TABLE_BLOCK, D, dtype=torch.float32,
                      device=g.device)
    out.index_add_(0, plan.block.long(), contrib)
    out = out.reshape(-1, D)[:plan.n_rows]
    if out_rows > plan.n_rows:
        out = torch.cat([out, out.new_zeros(out_rows - plan.n_rows, D)])
    return out[:out_rows].to(g.dtype)


_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from .build import load
        fn = load("segment_matmul").subgnn_segment_matmul
        fn.argtypes = ([ctypes.c_void_p] * 5
                       + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p, ctypes.c_longlong] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


KERNEL_WARPS = 16        # warps per thread block of the kernel
KERNEL_MIN_BLOCKS = 264  # two blocks for each of an H100's 132 SMs
KERNEL_SLAB = 256        # columns of one launch of the kernel's general path


def kernel_slots_per_warp(n_slots: int) -> int:
    """Plan slots per warp of the kernel for a plan of `n_slots` slots: the
    most of 64, 32 and 16 that still gives KERNEL_MIN_BLOCKS blocks, else 8.
    The partition depends on the plan's size alone."""
    for sw in (64, 32, 16):
        if -(-n_slots // (KERNEL_WARPS * sw)) >= KERNEL_MIN_BLOCKS:
            return sw
    return 8


def kernel_partial_width(D: int) -> int:
    """Width of the kernel's fp32 partial rows for table width D: the least
    of 32, 64, 128 and 256 that holds min(D, KERNEL_SLAB) columns (D itself
    for D of 32, 64, 128 or 256)."""
    k = -(-min(D, KERNEL_SLAB) // 32)
    return 32 * (1 << (k - 1).bit_length())


# the kernel's ticket words per (device, stream): one int64 a table row,
# allocated zeroed once and left zero by every launch, so calls on one
# stream, which run one after another, share them
_tickets: dict = {}


def _ticket_words(dev: torch.device, stream, rows: int) -> torch.Tensor:
    key = (dev.index, stream.cuda_stream)
    tickets = _tickets.get(key)
    if tickets is None or tickets.numel() < rows:
        tickets = _tickets[key] = torch.zeros(rows, dtype=torch.int64,
                                              device=dev)
    return tickets


def _check(g, plan):
    dev = g.device
    if g.dim() != 2:
        raise ValueError(f"g must be (n_ids, D), got {tuple(g.shape)}")
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"g must be float32 or bfloat16, got {g.dtype}")
    T, W = plan.pos.shape
    for name, t, shape in (("pos", plan.pos, (T, W)),
                           ("local", plan.local, (T, W)),
                           ("block", plan.block, (T,))):
        if t.device != dev:
            raise ValueError(f"plan.{name} is on {t.device}, g on {dev}")
        if t.dtype != torch.int32:
            raise TypeError(f"plan.{name} must be int32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"plan.{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"plan.{name} must be contiguous")


def segment_matmul(g: torch.Tensor, plan: GatherPlan,
                   out_rows: int | None = None) -> torch.Tensor:
    """dtable (out_rows, D) in g's dtype: for each table row, the fp32 sum
    of the rows of g routed to it by `plan`; zero for rows no slot names,
    including rows past plan.n_rows.

    g: (n_ids, D) float32 or bfloat16 flat cotangent (the ids' order), any
    D >= 1; plan: a GatherPlan of int32 tensors on g's device. CUDA tensors
    launch csrc/segment_matmul.cu (g contiguous; D of 32, 64, 128 or 256
    with g 16-byte aligned takes its vector path, any other D or alignment
    its general path, one launch per slab of up to 256 columns) and add one
    to `segment_matmul.launches`; CPU tensors run the plain version.
    """
    out_rows = plan.n_rows if out_rows is None else int(out_rows)
    _check(g, plan)
    dev = g.device
    if dev.type == "cpu":
        return segment_matmul_torch(g, plan, out_rows)
    if dev.type != "cuda":
        raise ValueError(f"segment_matmul: unsupported device {dev}")
    n_ids, D = g.shape
    T, W = plan.pos.shape
    if D < 1:
        raise ValueError(f"g must have at least one column, got {D}")
    if not g.is_contiguous():
        raise ValueError("g must be contiguous")
    if out_rows < plan.n_rows:
        raise ValueError(f"out_rows {out_rows} < plan.n_rows {plan.n_rows}")
    out = torch.empty(out_rows, D, dtype=g.dtype, device=dev)
    sw = kernel_slots_per_warp(T * W)
    n_blocks = max(-(-T * W // (KERNEL_WARPS * sw)), 1)
    # fp32 partial rows: two a kernel block, for runs that cross its edges
    partials = torch.empty(2 * n_blocks, kernel_partial_width(D),
                           dtype=torch.float32, device=dev)
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        tickets = _ticket_words(dev, stream, out_rows)
        err = fn(g.data_ptr(), plan.pos.data_ptr(), plan.local.data_ptr(),
                 plan.block.data_ptr(), out.data_ptr(), n_ids, out_rows, T, W,
                 D, int(g.dtype == torch.bfloat16), sw, partials.data_ptr(),
                 partials.numel() * 4, tickets.data_ptr(), tickets.numel(),
                 stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"segment_matmul kernel launch failed: "
                           f"cudaError_t {err}")
    segment_matmul.launches += 1
    return out


segment_matmul.launches = 0


# ---------------------------------------------------------------- the op


class EmbeddingGather(torch.autograd.Function):
    """table[ids] whose backward is `segment_matmul` over `plan` (built from
    exactly `ids` by make_gather_plan); table rows no id names, including
    rows past plan.n_rows, get zero gradient."""

    @staticmethod
    def forward(ctx, table, ids, plan):
        ctx.plan = plan
        ctx.rows = table.shape[0]
        return table[ids]

    @staticmethod
    def backward(ctx, grad):
        return segment_matmul(_flat_rows(grad), ctx.plan, ctx.rows), None, \
            None


def _flat_rows(grad: torch.Tensor) -> torch.Tensor:
    """A gather's cotangent as the kernel's (n_ids, D) g. It has the forward
    output's dtype, the table's, so dtable has it; an aligned copy keeps a
    fast-set D on the kernel's vector path."""
    g = grad.reshape(-1, grad.shape[-1]).contiguous()
    return g.clone() if g.data_ptr() % 16 else g


def embedding_gather(table: torch.Tensor, ids: torch.Tensor,
                     plan: GatherPlan) -> torch.Tensor:
    """table[ids] with the plan-routed backward (see EmbeddingGather)."""
    return EmbeddingGather.apply(table, ids, plan)


def _masked_rows(shard, ids, lo):
    """shard[ids - lo] where that row is in the shard, zeros elsewhere (an
    id outside reads row 0 of the shard, then masked)."""
    local = ids - lo
    inside = (local >= 0) & (local < shard.shape[0])
    rows = shard[torch.where(inside, local, torch.zeros_like(local))]
    return rows.masked_fill(~inside[..., None], 0)


class ShardGather(torch.autograd.Function):
    """`_masked_rows` whose backward is `segment_matmul` over `plan`, built
    from exactly `ids` with row_range (lo, lo + shard rows): the gradient
    of the shard's rows alone (the masked slots have no slot in it)."""

    @staticmethod
    def forward(ctx, shard, ids, lo, plan):
        ctx.plan = plan
        ctx.rows = shard.shape[0]
        return _masked_rows(shard, ids, lo)

    @staticmethod
    def backward(ctx, grad):
        return (segment_matmul(_flat_rows(grad), ctx.plan, ctx.rows), None,
                None, None)


def shard_gather(shard: torch.Tensor, ids: torch.Tensor, lo: int,
                 plan: GatherPlan | None = None) -> torch.Tensor:
    """This rank's terms of table[ids] from its rows [lo, lo + len(shard))
    of a node-sharded table (parallel/mesh.py): shard[id - lo] for the ids
    in its rows, zeros for the rest (masked, never clamped into the shard),
    so that the terms summed over the node group (mesh.node_sum) are the
    whole table's gather, exactly. With `plan` (make_gather_plan over the
    same row range) the shard's gradient is `segment_matmul`; without one
    it is autograd's index backward."""
    if plan is None:
        return _masked_rows(shard, ids, lo)
    return ShardGather.apply(shard, ids, lo, plan)


class SegmentSum(torch.autograd.Function):
    """out[v] = sum of msgs[e] over the e with dst[e] = v, through
    `segment_matmul` over `plan` (built from exactly `dst` by
    make_gather_plan, n_rows = out rows); the backward is the gather
    grad[dst]."""

    @staticmethod
    def forward(ctx, msgs, dst, plan):
        ctx.save_for_backward(dst)
        return segment_matmul(_flat_rows(msgs), plan)

    @staticmethod
    def backward(ctx, grad):
        dst, = ctx.saved_tensors
        return grad[dst], None, None


def segment_sum(msgs: torch.Tensor, dst: torch.Tensor,
                plan: GatherPlan) -> torch.Tensor:
    """(plan.n_rows, D) sums of the rows of msgs (E, D) by `dst` (see
    SegmentSum)."""
    return SegmentSum.apply(msgs, dst, plan)
