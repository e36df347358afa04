"""The training mesh on torch.distributed: its data and node axes.

Port of subgnn_tpu/parallel/mesh.py. The JAX package lays a (data, node)
jax.sharding.Mesh over the visible devices of one process and lets GSPMD
place the batch and insert the collectives. Here each mesh position is a
process (a rank): NCCL on the card, gloo on the CPU. Ranks are laid out as
JAX lays out devices (`reshape(n_data, n_node)`): rank r sits at data index
r // n_node and node index r % n_node.

The data axis: data index d computes rows [d*b, (d+1)*b) of each batch
(b = B / n_data, `shard_batch`, the counterpart of `batch_pspecs` and
`epoch_extras_pspecs`) and builds its own gather plans for them, so its
embedding-table gradient is a dense tensor like every other leaf.

The node axis (`param_pspecs`, `batch_pspecs`, `split_pspecs`): node index
k holds rows `shard_rows` of the embedding table, and with them Adam's two
moments of it, and columns `shard_cols` of the non-compact NP similarities.
Every other parameter and array is replicated. A gather from the sharded
table is the lowering GSPMD picks: a masked gather of this rank's rows
(ops/embedding.py:shard_gather) summed over the node group (`node_sum`),
exact since every term but one is zero. The ranks of a node group share
their batch rows and compute the same loss from the same sums, so the
sum's backward is the identity, and each rank's table gradient is
segment_matmul over a plan of its own rows (train/plans.py).

The collectives GSPMD inserts become explicit calls here, each over the
group its sum is over:

  * `all_reduce_sum_`: the gradients (replicated leaves and this rank's
    table shard alike), one flat all-reduce for the list, before Adam, and
    the step losses: over the data group (the JAX step's psum over 'data');
  * `all_reduce_bn_stats`: batch norm's train-mode sums, inside autograd,
    so that the moments and their backward are the global batch's (data
    group);
  * `all_gather_rows`: each data index's eval logits to every rank (data
    group);
  * `node_sum`: the masked table and NP-similarity gathers (node group);
  * `all_reduce_node_`: the table shard's squared gradient norm, and the
    whole table and moments a checkpoint holds (`all_gather_node`, node
    group);
  * the precompute's, over the whole group (`Mesh.world_block`: JAX's
    precompute shards over every device at once): `all_gather_world`
    (the NP sims' column blocks, the structure sims' comp blocks, the BFS
    rows and frontiers), `all_reduce_world_` (the partitioned BFS's
    new-node count, the pretrainer's sample degrees) and
    `scatter_world_cols` (rank 0's path matrix, a column block a rank);
  * the pretrainer's edge partition (prepare/node_emb.py), over the whole
    group: `sum_over_world` (each rank's partial node sums, identity
    backward) and `copy_to_world` (identity forward, each rank's partial
    input gradient all-reduced in the backward): the pair GSPMD's lowering
    of "edges sharded, output replicated" amounts to.

Each helper counts its calls and the bytes it reduces (`calls`, `bytes`),
as a kernel wrapper counts its launches; a captured step adds them per
replay (train/graphs.py). On the wire every helper but one is an
all-reduce (the gathers are all-reduces of zero buffers, `_gather_by_sum`);
`scatter_world_cols` is a scatter from rank 0 (parallel/audit.py maps each
helper to its kind).

Launch with torchrun (`init_from_env`); tests and chip_smoke.py initialise
the default group themselves with a file:// store.
"""
from __future__ import annotations

import contextlib
import os
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device

AXIS_NAMES = ("data", "node")
# batch keys that are not batch-major: the layer-major compact anchor-column
# similarities (train/sims.py), (L, B, C, A): a data index takes its part
# of axis 1
COMPACT_SIM_KEYS = ("neigh_sims", "pos_in_sims", "pos_out_sims")


class Mesh:
    """A (data, node) mesh of the ranks of a process group: this rank's
    position and device, and the groups the collectives run over:
    `data_group`, the n_data ranks of this node index (the whole group at
    n_node = 1), and `node_group`, the n_node ranks of this data index
    (None at n_node = 1)."""

    axis_names = AXIS_NAMES

    def __init__(self, group, n_data: int, n_node: int, rank: int,
                 world: int, device: torch.device, data_group=None,
                 node_group=None):
        self.group, self.n_data, self.n_node = group, n_data, n_node
        self.rank, self.world, self.device = rank, world, device
        self.data_index, self.node_index = divmod(rank, n_node)
        self.data_group = group if data_group is None else data_group
        self.node_group = node_group

    @property
    def shape(self) -> Dict[str, int]:
        """{"data": n_data, "node": n_node}, as jax.sharding.Mesh.shape."""
        return dict(zip(AXIS_NAMES, (self.n_data, self.n_node)))

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)

    @property
    def lead(self) -> bool:
        """Rank 0: the one rank that writes files."""
        return self.rank == 0

    @property
    def sharded(self) -> bool:
        """The node axis is in use: the table and NP sims are sharded."""
        return self.n_node > 1

    def rows(self, batch_size: int) -> slice:
        """This rank's rows of a batch of `batch_size`."""
        b = batch_size // self.n_data
        return slice(self.data_index * b, (self.data_index + 1) * b)

    def shard_rows(self, rows: int) -> Tuple[int, int]:
        """[lo, hi) of this rank's rows of a table of `rows` rows (table
        row `id` holds node `id`, row 0 the PAD row)."""
        if rows % self.n_node:
            raise ValueError(f"{rows} table rows must divide over the "
                             f"'node' mesh axis ({self.n_node})")
        n = rows // self.n_node
        return self.node_index * n, (self.node_index + 1) * n

    def shard_cols(self, n_cols: int) -> Tuple[int, int]:
        """[lo, hi) of this rank's columns of the NP similarities' node
        axis of `n_cols` (column `id - 1` holds node `id`). An axis that
        does not divide raises, as jax.device_put of the JAX package's
        NP_sim sharding does."""
        if n_cols % self.n_node:
            raise ValueError(f"the NP similarities' node axis ({n_cols}) "
                             f"must divide over the 'node' mesh axis "
                             f"({self.n_node})")
        n = n_cols // self.n_node
        return self.node_index * n, (self.node_index + 1) * n

    def world_block(self, n: int) -> Tuple[int, int]:
        """[lo, hi) of this rank's block of an axis of length `n` split
        over every rank of the mesh in rank order (JAX's flattened device
        order, how the precompute shards over both axes at once): blocks of
        ceil(n / world), the last ones cut and possibly empty, as JAX pads
        the axis to a multiple of the device count."""
        w = -(-n // self.world)
        lo = min(self.rank * w, n)
        return lo, min(lo + w, n)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank {self.rank} of {self.world}, "
                f"{self.backend}, {self.device})")


def make_device_mesh(n_data: Optional[int] = None, n_node: int = 1,
                     group=None, device=None) -> Mesh:
    """The mesh over `group` (default: the default process group), every
    rank a position: n_data defaults to world // n_node, and n_data *
    n_node must equal the world size. `device`: this rank's device
    (default cuda:current for NCCL, the CPU for gloo)."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_device_mesh needs a process group: launch with torchrun "
            "(parallel/mesh.py:init_from_env) or call "
            "torch.distributed.init_process_group first")
    group = dist.group.WORLD if group is None else group
    world = dist.get_world_size(group)
    if n_node < 1:
        raise ValueError(f"n_node must be at least 1, got {n_node}")
    if n_data is None:
        n_data = world // n_node
    need = n_data * n_node
    if need > world:
        raise ValueError(f"a ({n_data}, {n_node}) mesh needs {need} ranks, "
                         f"the process group has {world}")
    if need != world:
        raise ValueError(f"a ({n_data}, {n_node}) mesh would leave "
                         f"{world - need} of the group's {world} ranks idle")
    if device is None:
        device = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    rank = dist.get_rank(group)
    data_group = node_group = None
    if n_node > 1:
        # every rank creates every subgroup, in one order (new_group is
        # collective over the whole group)
        grid = np.asarray(dist.get_process_group_ranks(group)).reshape(
            n_data, n_node)
        d, k = divmod(rank, n_node)
        for i in range(n_data):
            g = dist.new_group(grid[i].tolist())
            if i == d:
                node_group = g
        for j in range(n_node):
            g = dist.new_group(grid[:, j].tolist())
            if j == k:
                data_group = g
    return Mesh(group, n_data, n_node, rank, world, dev, data_group,
                node_group)


def mesh_from_hparams(hp, group=None, device=None) -> Optional[Mesh]:
    """The mesh the HParams ask for (mesh_data_axis x mesh_node_axis), or
    None for the one-process path (a product of 1). No process group
    counts as a world of 1, so asking for more raises."""
    n_data = int(getattr(hp, "mesh_data_axis", 1) or 1)
    n_node = int(getattr(hp, "mesh_node_axis", 1) or 1)
    if n_data * n_node <= 1:
        return None
    avail = (dist.get_world_size(group) if dist.is_initialized() else 1)
    if n_data * n_node > avail:
        raise ValueError(
            f"mesh_data_axis*mesh_node_axis = {n_data}*{n_node} exceeds the "
            f"{avail} ranks of the process group (launch one process a rank, "
            f"e.g. torchrun --nproc_per_node {n_data * n_node})")
    return make_device_mesh(n_data=n_data, n_node=n_node, group=group,
                            device=device)


_LAUNCH_VARS = ("WORLD_SIZE", "RANK", "LOCAL_RANK")


def init_from_env(device=None) -> torch.device:
    """Under a torchrun launch (WORLD_SIZE, RANK and LOCAL_RANK set):
    initialise the default process group from the environment, unless one
    is already, NCCL with cuda:LOCAL_RANK, or gloo when `device` is the
    CPU; returns this rank's device. Without a launch it initialises
    nothing and returns `device` (default cuda) as resolve_device gives
    it: no GPU raises unless the CPU is asked for."""
    dev = resolve_device("cuda" if device is None else device)
    if not all(k in os.environ for k in _LAUNCH_VARS):
        return dev
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method="env://")
    return dev


@contextlib.contextmanager
def process_group_from_env(device=None) -> Iterator[torch.device]:
    """`init_from_env` for a CLI: yields the device, and destroys the
    default group at exit if this call created it."""
    created = not dist.is_initialized()
    dev = init_from_env(device)
    try:
        yield dev
    finally:
        if created and dist.is_initialized():
            dist.destroy_process_group()


def is_lead() -> bool:
    """No process group, or rank 0 of the default one: the process that
    writes a run's files."""
    return not dist.is_initialized() or dist.get_rank() == 0


def broadcast_object(obj: Any, group=None) -> Any:
    """Rank 0's `obj` on every rank of `group` (default: the default
    group; identity without a process group)."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, group_src=0, group=group)
    return box[0]


def all_gather_objects(obj: Any, mesh: Mesh) -> List[Any]:
    """Every rank's `obj`, in rank order."""
    out: List[Any] = [None] * mesh.world
    dist.all_gather_object(out, obj, group=mesh.group)
    return out


# ------------------------------------------------------------ collectives

def _count(helper, t: torch.Tensor) -> None:
    helper.calls += 1
    helper.bytes += t.numel() * t.element_size()


def _gather_by_sum(block: torch.Tensor, lo: int, n: int, dim: int, group,
                   helper) -> torch.Tensor:
    """The whole tensor, of length `n` along `dim`, on every rank of
    `group` from each rank's `block` of it at [lo, lo + its length): an
    all-reduce of a zero buffer holding this rank's block in its place
    (exact: every other term is 0), which gloo takes for CUDA tensors as
    NCCL does, and a CUDA graph captures. Counted under `helper`: the
    whole tensor's bytes."""
    shape = list(block.shape)
    shape[dim] = n
    full = block.new_zeros(shape)
    full.narrow(dim, lo, block.shape[dim]).copy_(block)
    dist.all_reduce(full, group=group)
    _count(helper, full)
    return full


def _sum_flat_(helper, tensors: List[torch.Tensor], group) -> None:
    if not tensors:
        return
    if len({t.dtype for t in tensors}) != 1:
        raise TypeError(f"{helper.__name__} takes tensors of one dtype, got "
                        f"{sorted({str(t.dtype) for t in tensors})}")
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    _count(helper, flat)
    parts = flat.split([t.numel() for t in tensors])
    torch._foreach_copy_(tensors, [p.view_as(t)
                                   for p, t in zip(parts, tensors)])


def all_reduce_sum_(tensors: List[torch.Tensor], mesh: Mesh) -> None:
    """Sum each tensor over the data group, in place: one all-reduce of
    the list flattened into one buffer (one dtype)."""
    _sum_flat_(all_reduce_sum_, tensors, mesh.data_group)


def all_reduce_node_(tensors: List[torch.Tensor], mesh: Mesh) -> None:
    """Sum each tensor over the node group, in place (one buffer)."""
    _sum_flat_(all_reduce_node_, tensors, mesh.node_group)


class _SumOverRanks(torch.autograd.Function):
    """y = the sum of x over the data group; the loss being the sum of the
    data ranks' losses, the gradient of x is the sum of their gradients of
    y."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        y = x.clone()
        dist.all_reduce(y, group=mesh.data_group)
        _count(all_reduce_bn_stats, y)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.mesh.data_group)
        _count(all_reduce_bn_stats, grad)
        return grad, None


def all_reduce_bn_stats(stats: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """`stats` summed over the data group, differentiably (see
    _SumOverRanks)."""
    return _SumOverRanks.apply(stats, mesh)


class _SumOverNode(torch.autograd.Function):
    """y = the sum of x over the node group. Every rank of the group
    computes the same loss from the same y (counted once), so the gradient
    of x is the gradient of y: the backward is the identity. (A further
    all-reduce there, as _SumOverRanks does, would count the loss n_node
    times.)"""

    @staticmethod
    def forward(ctx, x, mesh):
        y = x.clone()
        dist.all_reduce(y, group=mesh.node_group)
        _count(node_sum, y)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def node_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """`x` summed over the node group, with the identity backward (see
    _SumOverNode): the second half of a gather from a node-sharded
    table or NP similarities."""
    return _SumOverNode.apply(x, mesh)


def all_gather_node(shard: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole (n_node * rows, ...) tensor from each node rank's (rows,
    ...) shard, in node order, on every rank of the node group: an
    all-reduce of a zero buffer holding this rank's shard in its place
    (`_gather_by_sum`, counted under all_reduce_node_)."""
    n = shard.shape[0]
    return _gather_by_sum(shard, mesh.node_index * n, n * mesh.n_node, 0,
                          mesh.node_group, all_reduce_node_)


def bn_moments(flat: torch.Tensor, mesh: Mesh):
    """Batch norm's train-mode moments of the global batch from this rank's
    (rows, D) slice: (mean, biased variance, global row count), from one
    all-reduce of the fp32 sum and sum of squares."""
    x = flat.float()
    sums = all_reduce_bn_stats(torch.stack([x.sum(0), (x * x).sum(0)]), mesh)
    n = flat.shape[0] * mesh.n_data
    mean = sums[0] / n
    var = (sums[1] / n - mean * mean).clamp_min(0.0)
    return mean.to(flat.dtype), var.to(flat.dtype), n


def all_gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """(n_data * b, ...) from each data index's (b, ...) rows, in data
    order, on every rank: an all-reduce over the data group of a zero
    buffer holding this rank's rows in its place (`_gather_by_sum`)."""
    b = x.shape[0]
    return _gather_by_sum(x, mesh.data_index * b, b * mesh.n_data, 0,
                          mesh.data_group, all_gather_rows)


# --------------------------------------------- precompute, the whole world
# The precompute shards over every rank (`Mesh.world_block`), never over
# one axis alone; each helper runs over the whole group.

def all_gather_world(block: torch.Tensor, n: int, mesh: Mesh,
                     dim: int = 0) -> torch.Tensor:
    """The whole tensor, of length `n` along `dim`, from each rank's
    `world_block(n)` of it, on every rank: an all-reduce over the whole
    group of a zero buffer holding this rank's block in its place
    (`_gather_by_sum`). Counted bytes: the whole tensor's, 4 x n x the
    other dims for float32 or int32 (the NP sims of a split: 4 x n_sub x C
    x n_nodes; its structure sims of a side: 4 x n_sub x C x n_anchors)."""
    lo, hi = mesh.world_block(n)
    if block.shape[dim] != hi - lo:
        raise ValueError(f"rank {mesh.rank}'s block of {n} along dim {dim} "
                         f"is [{lo}, {hi}), got {block.shape[dim]} rows")
    return _gather_by_sum(block, lo, n, dim, mesh.group, all_gather_world)


def all_reduce_world_(tensors: List[torch.Tensor], mesh: Mesh) -> None:
    """Sum each tensor over the whole group, in place (one buffer): the
    partitioned BFS's new-node count, JAX's psum over every device; the
    pretrainer's sample degrees from each rank's edges."""
    _sum_flat_(all_reduce_world_, tensors, mesh.group)


class _SumOverWorld(torch.autograd.Function):
    """y = the sum of x over the whole group. Every rank computes the same
    loss from the same y, so the backward is the identity (as
    _SumOverNode's)."""

    @staticmethod
    def forward(ctx, x, mesh):
        y = x.clone()
        dist.all_reduce(y, group=mesh.group)
        _count(sum_over_world, y)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def sum_over_world(partial: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Each rank's partial node sums (over its block of the edges) summed
    over the whole group: an all-reduce forward, the identity backward."""
    return _SumOverWorld.apply(partial, mesh)


class _CopyToWorld(torch.autograd.Function):
    """y = x, replicated on every rank; each rank's y reaches the loss only
    through its own edges, so x's gradient is the sum over the whole group
    of the ranks' gradients of y."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.mesh.group)
        _count(copy_to_world, grad)
        return grad, None


def copy_to_world(h: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """`h` as it is, whose gradient is all-reduced over the whole group in
    the backward: the input of a rank's edge-block SpMM."""
    return _CopyToWorld.apply(h, mesh)


def scatter_world_cols(mat, n_rows: int, n_cols: int,
                       mesh: Mesh) -> torch.Tensor:
    """This rank's `world_block(n_cols)` of the columns of rank 0's
    (n_rows, n_cols) array `mat` (None on the other ranks), float32 on
    mesh.device: one scatter of blocks padded to ceil(n_cols / world)
    columns, staged on the host for gloo (which scatters only CPU
    tensors). Counted bytes: 4 x n_rows x that width x world."""
    lo, hi = mesh.world_block(n_cols)
    w = -(-n_cols // mesh.world)
    stage = torch.device("cpu") if mesh.backend == "gloo" else mesh.device
    block = torch.empty(n_rows, w, dtype=torch.float32, device=stage)
    parts = None
    if mesh.lead:
        parts = []
        for r in range(mesh.world):
            part = torch.zeros(n_rows, w, dtype=torch.float32, device=stage)
            cols = np.asarray(mat[:, r * w:(r + 1) * w], dtype=np.float32)
            part[:, :cols.shape[1]] = torch.from_numpy(cols)
            parts.append(part)
    dist.scatter(block, parts, group_src=0, group=mesh.group)
    scatter_world_cols.calls += 1
    scatter_world_cols.bytes += block.numel() * block.element_size() \
        * mesh.world
    return block[:, :hi - lo].to(mesh.device).contiguous()


COLLECTIVES = (all_reduce_sum_, all_reduce_bn_stats, all_gather_rows,
               node_sum, all_reduce_node_, all_gather_world,
               all_reduce_world_, scatter_world_cols, sum_over_world,
               copy_to_world)
PRECOMPUTE_COLLECTIVES = (all_gather_world, all_reduce_world_,
                          scatter_world_cols)
for _helper in COLLECTIVES:
    _helper.calls = 0
    _helper.bytes = 0


def reset_counts() -> None:
    for helper in COLLECTIVES:
        helper.calls = helper.bytes = 0


# ---------------------------------------------------------- batch slicing

def shard_batch(batch: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This rank's part of a global batch (numpy arrays or tensors): rows
    of each batch-major key, axis 1 of the layer-major compact sims, and
    of the NP similarities this rank's columns too (`batch_pspecs`). Gather
    plans are built per rank from its own ids (train/plans.py), never
    sliced."""
    out = {}
    for k, v in batch.items():
        if v is None:
            out[k] = None
        elif k.endswith("_plan"):
            raise ValueError(f"{k}: build a rank's gather plans from its own "
                             "rows, after shard_batch")
        elif k in COMPACT_SIM_KEYS:
            out[k] = v[:, mesh.rows(v.shape[1])]
        elif k == "NP_sim" and mesh.sharded:
            lo, hi = mesh.shard_cols(v.shape[2])
            out[k] = v[mesh.rows(v.shape[0]), :, lo:hi]
        else:
            out[k] = v[mesh.rows(v.shape[0])]
    return out

