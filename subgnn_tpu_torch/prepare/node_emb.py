"""Self-supervised node-embedding pretrainer (GIN / GCN link prediction).

Port of subgnn_tpu/prepare/node_emb.py:

  * 2-layer GIN (h' = Linear(h + sum_nbr h), GINConv eps=0) or GCN
    (symmetric-normalized adjacency with self loops);
  * neighbor aggregation as a sparse-dense product (SpMM) over the directed
    edge array, on the table-gradient kernel in both directions: the
    gather x[src] is `embedding_gather` with a plan by src (its backward is
    segment_matmul), the sum by dst is `segment_sum` with a plan by dst
    (segment_matmul; its backward is the gather grad[dst]). The edge
    arrays are fixed for a run, so the plans are built once (EdgePlans);
    above EDGE_CHUNK edges they are cut into chunks, a plan pair each, so
    one chunk's (EDGE_CHUNK, d) message buffer is alive at a time. A CUDA
    tensor launches csrc/segment_matmul.cu, a CPU tensor runs its plain
    version; the sums are deterministic either way;
  * link prediction: sigmoid(dot(h_u, h_v)) edge scores, NLL over the
    train split's positive edges (their endpoint gathers plan-routed too,
    chunked and recomputed in the backward above EDGE_CHUNK edges) and
    1/4-ratio uniform negatives (plain indexing: their ids change every
    step);
  * edges split 80/10/10 into train/val/test scoring sets from one numpy
    stream, which also draws the eval negatives (equal to the JAX
    package's for the same seed);
  * three minibatch modes: full-batch (one step an epoch), GraphSAINT
    (device random walks pick the node sample; the induced subgraph is a
    membership mask over the full edge arrays) and NeighborSampler
    (per-epoch shuffled seed batches; the sampled adjacency is an edge
    mask, thinned i.i.d. or to exactly k in-edges a seed);
  * AdamW (optax.adamw), the greedy hyperparameter search over the
    reference's spaces, and loss / ROC plots;
  * on a mesh (parallel/mesh.py, every rank calling with the same
    arguments) the directed edges are split over the ranks
    (`Mesh.world_block`): a rank keeps its block, in EDGE_CHUNK chunks as
    without a mesh, and sums its own edges' messages; the partial node
    sums are all-reduced over the whole group (`sum_over_world`, identity
    backward), and the SpMM's input gradient likewise (`copy_to_world`).
    Features, parameters, AdamW's state, the positive and negative edges
    and every draw are replicated: every rank seeds the same generator (or
    replays the same draws), computes the same loss and applies the same
    update, and returns the same embeddings and metrics. Rank 0 alone
    writes the plots. JAX shards the edges the same way and lets GSPMD
    insert the all-reduce (it pads the edges to a multiple of the devices
    and leaves them unchunked there).

Every random draw of a run (initial parameters, negatives, dropout
keep-masks, walks, permutations, thinning uniforms) comes from one
torch.Generator stream on the run's device, through a `Draws` object; the
tests hand in `ReplayDraws` holding the JAX package's draws. The JAX
package cuts its epochs into device dispatches and folds its key at each
cut (EPOCH_DISPATCH_CHUNK, saint_dispatch_epochs); the port has no
dispatches to cut and runs one epoch loop. Losses stay on the device and
are read once, at the end.
"""
from __future__ import annotations

import random as pyrandom
import warnings
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..data.graph import CSRGraph
from ..device import resolve_device
from ..models.dropout import dropout as apply_dropout
from ..parallel import mesh as MX
from ..ops.embedding import (GatherPlan, embedding_gather, make_gather_plan,
                             segment_matmul, segment_sum)
from ..sampling.device_walks import uniform_index
from ..train.loop import Adam, copy_tree
from ..train.metrics import binary_auc

# Bound on the (edges, hidden) message buffer and on the positive edges'
# (edges, d) endpoint gathers: above this many edges both run chunk by
# chunk, one gather plan (pair) a chunk
EDGE_CHUNK = 1 << 20
ONE_HOT_MAX_NODES = 8192    # one-hot features up to here, else a projection
PROJECTION_DIM = 256
PROJECTION_SEED = 7         # the fixed random projection's own generator
FEATURE_DIM_ONES = 20       # width of the all-ones features
NLL_EPS = 1e-7


def _uniform(generator, shape, bound):
    return ((torch.rand(shape, generator=generator, device=generator.device)
             * 2 - 1) * bound)


def _linear(generator, d_in, d_out):
    b = 1.0 / d_in ** 0.5
    return {"w": _uniform(generator, (d_in, d_out), b),
            "b": _uniform(generator, (d_out,), b)}


def init_gnn_params(generator: torch.Generator, n_feat: int, n_hid: int,
                    n_out: int):
    """{"conv1": {"w" (n_feat, n_hid), "b"}, "conv2": {"w" (n_hid, n_out),
    "b"}}, uniform in +-1/sqrt(d_in), on the generator's device."""
    return {"conv1": _linear(generator, n_feat, n_hid),
            "conv2": _linear(generator, n_hid, n_out)}


# ------------------------------------------------------------------- SpMM


class _EdgeChunk(NamedTuple):
    lo: int
    hi: int
    src: torch.Tensor
    dst: torch.Tensor
    plan_src: GatherPlan
    plan_dst: GatherPlan


class EdgePlans:
    """A run's directed edge array (src -> dst, 0-based ids) on the device,
    in chunks of at most `chunk` edges (None: one chunk), each with its
    gather plans: by src for the backward of the x[src] gather and by dst
    for the sum. Built once a run on the host. With a `mesh`, this rank's
    block [lo, hi) of the edges (`Mesh.world_block`, possibly empty), whose
    sums the SpMM adds over the ranks."""

    def __init__(self, src: np.ndarray, dst: np.ndarray, n_nodes: int,
                 device, chunk: int | None = EDGE_CHUNK,
                 mesh: Optional[MX.Mesh] = None):
        self.mesh = mesh
        self.lo, self.hi = (0, len(src)) if mesh is None \
            else mesh.world_block(len(src))
        src = np.asarray(src[self.lo:self.hi], np.int64)
        dst = np.asarray(dst[self.lo:self.hi], np.int64)
        self.n_nodes = int(n_nodes)
        self.n_edges = len(src)
        self.src = torch.as_tensor(src, device=device)
        self.dst = torch.as_tensor(dst, device=device)
        step = self.n_edges if chunk is None else min(chunk, self.n_edges)
        self.chunks: List[_EdgeChunk] = []
        for lo in range(0, self.n_edges, max(step, 1)):
            hi = min(lo + step, self.n_edges)
            self.chunks.append(_EdgeChunk(
                lo, hi, self.src[lo:hi], self.dst[lo:hi],
                make_gather_plan(src[lo:hi], n_nodes).to(device),
                make_gather_plan(dst[lo:hi], n_nodes).to(device)))


def _gather_segment_sum(x, edges: EdgePlans, edge_mask=None):
    """segment_sum(x[src] * edge_mask, dst) over the edge chunks, both
    directions on segment_matmul (`edge_mask`: the block's). Chunked and
    unchunked differ only in fp reduction order. On a mesh, x enters
    through copy_to_world and the rank's sums leave through
    sum_over_world; a rank without edges still takes part in both."""
    mesh = edges.mesh
    if mesh is not None:
        x = MX.copy_to_world(x, mesh)
    out = None
    for c in edges.chunks:
        msgs = embedding_gather(x, c.src, c.plan_src)
        if edge_mask is not None:
            msgs = msgs * edge_mask[c.lo:c.hi, None]
        part = segment_sum(msgs, c.dst, c.plan_dst)
        out = part if out is None else out + part
    if out is None:
        # no edges: zeros that still depend on x, so that its gradient
        # (and copy_to_world's all-reduce) reaches this rank too
        out = x.new_zeros(edges.n_nodes, x.shape[1]) + x[:0].sum()
    return out if mesh is None else MX.sum_over_world(out, mesh)


def _in_degrees(vals, edges: EdgePlans):
    """(n,) sums of the per-edge values `vals` (the block's) by dst (no
    gradient), over every rank's edges on a mesh."""
    out = vals.new_zeros(edges.n_nodes)
    for c in edges.chunks:
        out = out + segment_matmul(vals[c.lo:c.hi, None].contiguous(),
                                   c.plan_dst)[:, 0]
    if edges.mesh is not None:
        MX.all_reduce_world_([out], edges.mesh)
    return out


def _aggregate(x, edges: EdgePlans, conv_type: str, norm, member=None,
               edge_mask=None):
    """One round of neighbor aggregation over the directed edges.

    With `member` (float (n,) 0/1) it runs on the induced subgraph of the
    member nodes (GraphSAINT); with `edge_mask` (float (E,) 0/1) only the
    masked edges carry messages while every node keeps its self term
    (NeighborSampler). `norm` is GCN's rsqrt(deg + 1) (None for GIN)."""
    if member is not None:
        x = x * member[:, None]
    if conv_type == "gin":
        out = x + _gather_segment_sum(x, edges, edge_mask)
    else:
        xn = x * norm[:, None]
        out = (_gather_segment_sum(xn, edges, edge_mask) + xn) * norm[:, None]
    return out if member is None else out * member[:, None]


def gnn_forward(params, x, edges: EdgePlans, conv_type: str, deg, *,
                dropout: float = 0.0, train: bool = False, keep_mask=None,
                member=None, edge_mask=None):
    """(n, out_dim) node embeddings. deg: (n,) float degrees (GCN, full
    graph); with `member` / `edge_mask` GCN's degrees are those within the
    sample, summed on segment_matmul once a forward. Dropout after layer 1
    draws its mask through keep_mask(shape, rate) (models/dropout.py)."""
    w1, b1 = params["conv1"]["w"], params["conv1"]["b"]
    norm = None
    if conv_type != "gin":
        if member is not None:
            deg = _in_degrees(member[edges.src], edges)
        elif edge_mask is not None:
            deg = _in_degrees(edge_mask, edges)
        norm = torch.rsqrt(deg + 1.0)
    if x.shape[1] > w1.shape[1]:
        # project first: aggregation and the linear map commute, so the
        # (E, d) gather runs at d = hidden instead of n_feat
        h = _aggregate(x @ w1, edges, conv_type, norm, member, edge_mask)
        h = torch.relu(h + b1)
    else:
        h = _aggregate(x, edges, conv_type, norm, member, edge_mask)
        h = torch.relu(h @ w1 + b1)
    if train and dropout > 0:
        h = apply_dropout(h, dropout, keep_mask)
    h = _aggregate(h, edges, conv_type, norm, member, edge_mask)
    return h @ params["conv2"]["w"] + params["conv2"]["b"]


def spmm_launches(n_edges: int, n_train: int, *, conv_type: str,
                  minibatch: str, projected: bool,
                  chunk: int | None = None) -> Dict[str, int]:
    """segment_matmul launches of one training step and of the final eval
    forward. With c edge chunks and p chunks of the train edges: a forward
    sums twice (2c), plus once for GCN's sample degrees outside full mode
    (c); the backward routes the positive endpoints (p), layer 2's gather
    (c) and, when layer 1 projects first, layer 1's gather (c); without the
    projection x has no gradient and layer 1 needs none. On a mesh a rank's
    count takes its block's `n_edges` (0 for an empty block)."""
    chunk = EDGE_CHUNK if chunk is None else chunk
    c = max(-(-n_edges // chunk), 1) if n_edges else 0
    p = max(-(-n_train // chunk), 1)
    sample_deg = conv_type != "gin" and minibatch != "full"
    return {"step": 2 * c + c * sample_deg + p + c + c * projected,
            "eval": 2 * c}


# ------------------------------------------------------------------- loss


class EdgeEndpoints:
    """A fixed (2, E) edge array (the train split's positive edges) on the
    device, in chunks of at most `chunk` edges, each with the gather plan of
    its (2, c) endpoint ids: the backward of emb[edges] runs on
    segment_matmul."""

    def __init__(self, edges: np.ndarray, n_rows: int, device,
                 chunk: int | None = EDGE_CHUNK):
        edges = np.asarray(edges, np.int64).reshape(2, -1)
        self.edges = torch.as_tensor(edges, device=device)
        E = edges.shape[1]
        step = E if chunk is None else min(chunk, E)
        self.chunks = [
            (lo, min(lo + step, E), self.edges[:, lo:lo + step],
             make_gather_plan(edges[:, lo:lo + step], n_rows).to(device))
            for lo in range(0, E, max(step, 1))]

    @property
    def n_edges(self) -> int:
        return self.edges.shape[1]


def _pair_nll(a, b, w, positive: bool):
    s = torch.sigmoid((a * b).sum(dim=-1))
    t = -torch.log(s + NLL_EPS) if positive else -torch.log1p(-s + NLL_EPS)
    return (t * w).sum() if w is not None else t.sum()


def _planned_chunk_nll(emb, ids, plan, w, positive):
    pair = embedding_gather(emb, ids, plan)
    return _pair_nll(pair[0], pair[1], w, positive)


def _positive_nll(emb, pos: EdgeEndpoints, w=None):
    """sum_e w_e * -log(p_e) over the positive edges, plan-routed; above one
    chunk each chunk's endpoint gathers are recomputed in the backward
    (torch.utils.checkpoint), so one chunk's (2, chunk, d) buffer is alive
    at a time."""
    if len(pos.chunks) == 1:
        _, _, ids, plan = pos.chunks[0]
        return _planned_chunk_nll(emb, ids, plan, w, True)
    total = emb.new_zeros(())
    for lo, hi, ids, plan in pos.chunks:
        total = total + checkpoint(
            _planned_chunk_nll, emb, ids, plan,
            None if w is None else w[lo:hi], True, use_reentrant=False,
            preserve_rng_state=False)
    return total


def _edge_nll(emb, edges, w, positive: bool):
    """The link-pred NLL over an edge array of per-step ids (plain
    indexing)."""
    return _pair_nll(emb[edges[0]], emb[edges[1]], w, positive)


def _edge_scores(emb, edges):
    return torch.sigmoid((emb[edges[0]] * emb[edges[1]]).sum(dim=-1))


class LinkData(NamedTuple):
    """What every step of a run reads: features, the SpMM's edges and
    plans, GCN's degrees, the positive train edges and the model's type."""
    x: torch.Tensor
    edges: EdgePlans
    deg: torch.Tensor
    pos: EdgeEndpoints
    conv_type: str
    dropout: float


def link_loss(params, data: LinkData, neg, keep_mask, *, member=None,
              edge_mask=None, w_pos=None, w_neg=None):
    """A training step's loss (the JAX steps' loss_fn): the positive and
    negative NLL over (full) E_train + n_neg, (GraphSAINT, w_pos given)
    sum(w_pos) + n_neg, or (neighbor, w_neg given too) sum(w_pos) +
    sum(w_neg) + 1e-7."""
    emb = gnn_forward(params, data.x, data.edges, data.conv_type, data.deg,
                      dropout=data.dropout, train=True, keep_mask=keep_mask,
                      member=member, edge_mask=edge_mask)
    total = _positive_nll(emb, data.pos, w_pos) + _edge_nll(emb, neg, w_neg,
                                                            False)
    if w_pos is None:
        return total / (data.pos.n_edges + neg.shape[1])
    if w_neg is None:
        return total / (w_pos.sum() + neg.shape[1])
    return total / (w_pos.sum() + w_neg.sum() + 1e-7)


# ------------------------------------------------------------------ draws


def _plain_walks_device(indptr, indices, degrees, generator, *,
                        walk_len: int, n_walks: int) -> torch.Tensor:
    """(n_walks, walk_len) uniform random walks from uniform roots, 1-based
    ids, dead ends repeat the last node (GraphSAINTRandomWalkSampler
    semantics), over the flat CSR arrays (int64 tensors on the device)."""
    dev = generator.device
    n = degrees.numel() - 1
    curr = torch.randint(1, n + 1, (n_walks,), generator=generator,
                         device=dev)
    out = [curr]
    last = max(indices.numel() - 1, 0)
    for _ in range(walk_len - 1):
        d = degrees[curr]
        u = torch.rand(n_walks, generator=generator, device=dev)
        idx = uniform_index(u, d)
        nxt = indices[(indptr[curr] + idx).clamp(max=last)]
        curr = torch.where(d > 0, nxt, curr)
        out.append(curr)
    return torch.stack(out, dim=1)


class Draws:
    """The pretrainer's random draws, from one torch.Generator stream."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def negatives(self, high: int, count: int) -> torch.Tensor:
        """(2, count) int64 uniform in [0, high)."""
        g = self.generator
        return torch.randint(0, high, (2, count), generator=g,
                             device=g.device)

    def keep_mask(self, shape, rate: float) -> torch.Tensor:
        g = self.generator
        return torch.rand(tuple(shape), generator=g, device=g.device) >= rate

    def uniform(self, shape) -> torch.Tensor:
        g = self.generator
        return torch.rand(tuple(shape), generator=g, device=g.device)

    def permutation(self, n: int) -> torch.Tensor:
        g = self.generator
        return torch.randperm(n, generator=g, device=g.device)

    def walks(self, indptr, indices, degrees, walk_len: int,
              n_walks: int) -> torch.Tensor:
        return _plain_walks_device(indptr, indices, degrees, self.generator,
                                   walk_len=walk_len, n_walks=n_walks)


class ReplayDraws:
    """Draws given in advance, one list per kind (arrays, in draw order),
    handed out on `device`; raises when a kind runs out or a shape
    differs from what the step asks for."""

    def __init__(self, device, *, negatives=(), keep=(), uniform=(),
                 permutation=(), walks=()):
        self.device = torch.device(device)
        self._queues = {"negatives": list(negatives), "keep": list(keep),
                        "uniform": list(uniform),
                        "permutation": list(permutation),
                        "walks": list(walks)}

    def _next(self, kind, shape=None):
        q = self._queues[kind]
        if not q:
            raise RuntimeError(f"ReplayDraws: no {kind} draw left")
        out = torch.as_tensor(np.array(q.pop(0)), device=self.device)
        if shape is not None and tuple(out.shape) != tuple(shape):
            raise ValueError(f"ReplayDraws: {kind} draw has shape "
                             f"{tuple(out.shape)}, the step asks for "
                             f"{tuple(shape)}")
        return out

    def negatives(self, high, count):
        return self._next("negatives", (2, count)).long()

    def keep_mask(self, shape, rate):
        return self._next("keep", shape).bool()

    def uniform(self, shape):
        return self._next("uniform", shape).float()

    def permutation(self, n):
        return self._next("permutation", (n,)).long()

    def walks(self, indptr, indices, degrees, walk_len, n_walks):
        return self._next("walks", (n_walks, walk_len)).long()


# --------------------------------------------------------------- sampling


def build_in_edge_table(dst: np.ndarray, n: int):
    """Host-side routing for exact-k neighbor sampling: edge-array positions
    of each node's incoming edges. Returns (in_pos (n, max_in) int32,
    pad slots = len(dst); in_valid (n, max_in) bool). Edges with dst >= n
    are excluded."""
    dst = np.asarray(dst, np.int64)
    E = len(dst)
    idx = np.nonzero(dst < n)[0]
    order = np.argsort(dst[idx], kind="stable")
    positions = idx[order]
    d_sorted = dst[idx][order]
    indeg = np.bincount(d_sorted, minlength=n)
    max_in = max(int(indeg.max()) if len(indeg) else 0, 1)
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(indeg, out=offs[1:])
    slot = np.arange(len(d_sorted), dtype=np.int64) - offs[d_sorted]
    in_pos = np.full((n, max_in), E, np.int64)
    in_pos[d_sorted, slot] = positions
    return in_pos.astype(np.int32), (in_pos < E)


def exact_k_edge_mask(u, in_pos, in_valid, k: int, E: int) -> torch.Tensor:
    """(E,) 0/1 float mask keeping exactly min(k, in_degree) incoming edges
    per node, uniformly without replacement, from per-slot uniforms `u`
    (in_pos's shape): each row's k smallest valid uniforms, scattered back
    to their edge positions. Each edge is in one slot; the pad slots all
    write 0 to position E, so the plain scatter (no accumulation, no sort
    of the pads' duplicate index) is exact."""
    in_pos = torch.as_tensor(in_pos, device=u.device).long()
    in_valid = torch.as_tensor(in_valid, device=u.device)
    g = torch.where(in_valid, u, torch.inf)
    kk = min(k, in_pos.shape[1])
    kth = torch.topk(g, kk, dim=1, largest=False).values[:, -1]
    sel = (g <= kth[:, None]) & in_valid
    out = torch.zeros(E + 1, device=u.device)
    out.scatter_(0, in_pos.reshape(-1), sel.reshape(-1).float())
    return out[:E]


# ---------------------------------------------------------------- trainer


class AdamW(Adam):
    """optax.adamw(lr, weight_decay): Adam (b1 0.9, b2 0.999, eps 1e-8, bias
    corrections in float32) plus weight_decay * param on every leaf, biases
    included, before the learning rate."""

    def __init__(self, lr: float, weight_decay: float):
        super().__init__(lr)
        self.weight_decay = weight_decay


def _features(features: str, n: int, device):
    if features == "one_hot" and n <= ONE_HOT_MAX_NODES:
        return torch.eye(n, device=device)
    if features == "one_hot":
        # a fixed random projection of the identity: O(n*d) memory instead
        # of O(n^2), drawn from its own CPU generator so that every device
        # gets the same features
        gen = torch.Generator().manual_seed(PROJECTION_SEED)
        x = torch.randn(n, PROJECTION_DIM, generator=gen)
        return (x / PROJECTION_DIM ** 0.5).to(device)
    return torch.ones(n, FEATURE_DIM_ONES, device=device)


def _directed_edges(graph: CSRGraph):
    """0-based (src, dst) of every directed edge, straight off the CSR."""
    n = graph.n_nodes
    counts = np.diff(graph.indptr[1:]).astype(np.int64)
    src = np.repeat(np.arange(n, dtype=np.int64), counts)
    dst = (graph.indices[graph.indptr[1]:] - 1).astype(np.int64)
    return src, dst


def train_node_embeddings(graph: CSRGraph, *, conv_type: str = "gin",
                          hidden: int = 128, out_dim: int = 64,
                          lr: float = 1e-3, weight_decay: float = 5e-4,
                          dropout: float = 0.4, epochs: int = 100,
                          seed: int = 0, features: str = "one_hot",
                          minibatch: str = "full", batch_size: int = 512,
                          walk_length: int = 32, num_steps: int = 32,
                          nb_size: int = -1, nb_exact: bool = False,
                          plots_dir: Optional[str | Path] = None,
                          log_every: int = 0,
                          device: str | torch.device = "cuda",
                          params=None, draws=None,
                          mesh: Optional[MX.Mesh] = None
                          ) -> Tuple[np.ndarray, Dict]:
    """Returns (embeddings (n_nodes, out_dim) float32, metrics dict): the
    JAX package's metrics plus `loss_history`, the mean train loss of each
    epoch.

    minibatch='full' is one full-graph step an epoch; 'graphsaint' trains
    each of num_steps steps on the induced subgraph of the nodes visited by
    batch_size random walks of walk_length; 'neighbor' shuffles the nodes
    into ceil(n / batch_size) seed batches an epoch and trains each step on
    the seeds' incoming edges (all of them for nb_size=-1; thinned i.i.d.
    at rate nb_size/deg, or with nb_exact to exactly min(nb_size, deg)).

    `params` (a tree as init_gnn_params returns, any device; copied) and
    `draws` (a Draws or ReplayDraws) replace the initial parameters and the
    per-step draws, which otherwise come from one generator seeded `seed`
    on `device`.

    `mesh`: every rank of it calls with the same arguments and trains on
    its block of the edges (module docstring), on the mesh's device, whose
    type `device` must name; rank 0 alone writes `plots_dir`."""
    dev = resolve_device(device)
    if mesh is not None:
        if mesh.device.type != dev.type:
            raise ValueError(f"device {str(dev)!r} is not the mesh's "
                             f"({mesh.device})")
        dev = mesh.device
    if minibatch not in ("full", "graphsaint", "neighbor"):
        raise ValueError(minibatch)
    n = graph.n_nodes
    # the convolution runs over ALL edges (train+val+test); only the train
    # edges feed the loss, as in the reference
    src, dst = _directed_edges(graph)
    deg = torch.as_tensor(graph.degrees[1:].astype(np.float32), device=dev)

    # undirected positive edges (u < v), split 80/10/10
    und = src < dst
    pos = np.stack([src[und], dst[und]])
    rng_np = np.random.default_rng(seed)
    perm = rng_np.permutation(pos.shape[1])
    n_tr = 8 * len(perm) // 10
    n_va = len(perm) // 10
    splits = {"train": pos[:, perm[:n_tr]],
              "val": pos[:, perm[n_tr:n_tr + n_va]],
              "test": pos[:, perm[n_tr + n_va:]]}

    x = _features(features, n, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if params is None:
        params = init_gnn_params(gen, x.shape[1], hidden, out_dim)
    else:
        params = copy_tree(params, dev)
    if draws is None:
        draws = Draws(gen)
    opt = AdamW(lr, weight_decay)
    opt_state = opt.init(params)
    data = LinkData(x, EdgePlans(src, dst, n, dev, EDGE_CHUNK, mesh), deg,
                    EdgeEndpoints(splits["train"], n, dev, EDGE_CHUNK),
                    conv_type, dropout)
    train_pos = data.pos.edges

    def update(loss):
        grads = torch.autograd.grad(loss, opt.trainable(params))
        opt.step(params, list(grads), opt_state)
        return loss.detach()

    epoch_losses = []
    if minibatch == "full":
        n_neg = max(n_tr // 4, 1)
        for _ in range(epochs):
            neg = draws.negatives(n, n_neg)
            epoch_losses.append(update(
                link_loss(params, data, neg, draws.keep_mask)))
    elif minibatch == "graphsaint":
        indptr = torch.as_tensor(graph.indptr, device=dev)
        indices = torch.as_tensor(graph.indices.astype(np.int64), device=dev)
        degrees = torch.as_tensor(graph.degrees.astype(np.int64), device=dev)
        sample_n = batch_size * walk_length
        n_neg = max(sample_n // 8, 1)
        for _ in range(epochs):
            losses = []
            for _ in range(num_steps):
                walks = draws.walks(indptr, indices, degrees, walk_length,
                                    batch_size)
                sample_ids = walks.reshape(-1)               # 1-based
                member = torch.zeros(n + 1, device=dev)
                member[sample_ids] = 1.0
                member = member[1:]
                # negatives among the sampled nodes
                neg = (sample_ids[draws.negatives(sample_n, n_neg)]
                       - 1).clamp(0, n - 1)
                w_pos = member[train_pos[0]] * member[train_pos[1]]
                losses.append(update(link_loss(
                    params, data, neg, draws.keep_mask, member=member,
                    w_pos=w_pos)))
            epoch_losses.append(torch.stack(losses).mean())
    else:
        n_batches = -(-n // batch_size)
        pad = torch.full((n_batches * batch_size - n,), n, dtype=torch.int64,
                         device=dev)
        # static negative count: in expectation a seed batch samples
        # 2 * |train| * batch_size / n directed train edges; num_neg ~ // 4
        n_neg = max(2 * n_tr * batch_size // (4 * n), 1)
        E = len(dst)
        lo, hi = data.edges.lo, data.edges.hi
        dst_t = data.edges.dst          # this rank's block of the edges
        if nb_size > 0 and nb_exact:
            in_pos, in_valid = build_in_edge_table(dst, n)
            in_pos = torch.as_tensor(in_pos, device=dev).long()
            in_valid = torch.as_tensor(in_valid, device=dev)
        elif nb_size > 0:
            keep_p = torch.clamp(nb_size / deg[dst_t].clamp(min=1.0),
                                 max=1.0)
        for _ in range(epochs):
            batches = torch.cat([draws.permutation(n).long(), pad]).reshape(
                n_batches, batch_size)
            losses = []
            for seeds in batches:
                # (n+1,) 0/1 over node ids; slot n (the last batch's seed
                # padding) forced to 0
                mask = torch.zeros(n + 1, device=dev)
                mask[seeds] = 1.0
                mask[n] = 0.0
                emask = mask[dst_t]          # incoming edges of the seeds
                # the draws and the exact-k mask are whole (replicated),
                # then cut to the block
                if nb_size > 0 and nb_exact:
                    emask = emask * exact_k_edge_mask(
                        draws.uniform(in_pos.shape), in_pos, in_valid,
                        nb_size, E)[lo:hi]
                elif nb_size > 0:
                    emask = emask * (draws.uniform((E,))[lo:hi]
                                     < keep_p).float()
                # negatives among the seeds; a pad endpoint (id n) makes a
                # zero-weight negative
                neg_raw = seeds[draws.negatives(batch_size, n_neg)]
                w_neg = ((neg_raw[0] < n) & (neg_raw[1] < n)).float()
                neg = neg_raw.clamp(max=n - 1)
                seed_mask = mask[:n]
                # an undirected train edge is sampled once per seed endpoint
                w_pos = seed_mask[train_pos[0]] + seed_mask[train_pos[1]]
                losses.append(update(link_loss(
                    params, data, neg, draws.keep_mask, edge_mask=emask,
                    w_pos=w_pos, w_neg=w_neg)))
            epoch_losses.append(torch.stack(losses).mean())

    loss_history = ([float(v) for v in torch.stack(epoch_losses).cpu()]
                    if epoch_losses else [])
    loss = loss_history[-1] if loss_history else float("nan")
    if log_every:
        for epoch in range(0, epochs, log_every):
            print(f"node-emb epoch {epoch}: loss={loss_history[epoch]:.4f}")

    with torch.no_grad():
        emb = gnn_forward(params, x, data.edges, conv_type, deg)
    emb_np = emb.cpu().numpy().astype(np.float32)

    def eval_split(name):
        pos_e = splits[name]
        neg_e = rng_np.integers(0, n, size=pos_e.shape)
        with torch.no_grad():
            scores = np.concatenate([
                _edge_scores(emb, torch.as_tensor(e, device=dev)).cpu()
                .numpy() for e in (pos_e, neg_e)])
        truth = np.concatenate([np.ones(pos_e.shape[1]),
                                np.zeros(neg_e.shape[1])])
        # acc at the reference's 0.5 threshold + AUC
        return (binary_auc(truth, scores),
                float(((scores >= 0.5) == truth).mean()), truth, scores)

    metrics = {}
    curves = {}
    for s in ("train", "val", "test"):
        auc, acc, truth, scores = eval_split(s)
        metrics[f"{s}_auc"] = auc
        metrics[f"{s}_acc"] = acc
        curves[s] = (truth, scores)
    metrics["final_loss"] = float(loss)
    metrics["loss_history"] = loss_history      # per epoch (the port's own)
    metrics["emb_norm_mean"] = float(np.linalg.norm(emb_np, axis=1).mean())
    # GIN's sum aggregation amplifies the init scale by ~avg-degree per
    # layer; on dense graphs the sigmoid-dot link loss then saturates and
    # nothing trains (val_auc 0.5 with huge row norms). Surface it.
    if (conv_type == "gin" and metrics["val_auc"] < 0.55
            and metrics["emb_norm_mean"] > 100.0):
        warnings.warn(
            f"GIN pretrain looks saturated (val_auc="
            f"{metrics['val_auc']:.3f}, mean row norm "
            f"{metrics['emb_norm_mean']:.0f}); on dense graphs try "
            "conv_type='gcn' or more epochs", RuntimeWarning)
    if plots_dir is not None and (mesh is None or mesh.lead):
        _save_plots(Path(plots_dir), conv_type, loss_history, curves)
    return emb_np, metrics


def _save_plots(plots_dir: Path, conv_type: str, loss_history, curves):
    """Loss-curve + ROC-curve artifacts (reference: utils.py:117-192)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plots_dir.mkdir(parents=True, exist_ok=True)
    fig, ax = plt.subplots()
    ax.plot(loss_history)
    ax.set_xlabel("epoch")
    ax.set_ylabel("train loss")
    fig.savefig(plots_dir / f"{conv_type}_loss_curve.png", dpi=80)
    plt.close(fig)

    fig, ax = plt.subplots()
    for split, (truth, scores) in curves.items():
        order = np.argsort(-scores)
        t = truth[order]
        tpr = np.cumsum(t) / max(t.sum(), 1)
        fpr = np.cumsum(1 - t) / max((1 - t).sum(), 1)
        ax.plot(fpr, tpr, label=split)
    ax.plot([0, 1], [0, 1], "k--", lw=0.5)
    ax.set_xlabel("FPR")
    ax.set_ylabel("TPR")
    ax.legend()
    fig.savefig(plots_dir / f"{conv_type}_roc_curve.png", dpi=80)
    plt.close(fig)


# Reference search spaces (config_prepare_dataset.py:46-55)
SEARCH_SPACES = {
    "batch_size": [512, 1024],
    "hidden": [128, 256],
    "out_dim": [64],
    "lr": [0.001, 0.005],
    "weight_decay": [5e-4, 5e-5],
    "dropout": [0.4, 0.5],
    "walk_length": [32],
    "num_steps": [32],
    "nb_size": [-1],  # POSSIBLE_NB_SIZE (NeighborSampler mode only)
}


def greedy_hyperparam_search(graph: CSRGraph, *, conv_type: str = "gin",
                             minibatch: str = "full", epochs: int = 50,
                             seed: int = 0, nb_size: Optional[int] = None,
                             nb_exact: bool = False, log_fn=None,
                             device: str | torch.device = "cuda"):
    """Greedy coordinate descent over the reference's spaces
    (train_node_emb.py:146-172): hyperparameter types are visited in a
    shuffled order; within a type every value is tried (shuffled) with the
    other coordinates at their current-best values; the best model by val
    accuracy is kept across all runs. Configurations already trained are
    skipped.

    Returns (best_embeddings, best_metrics, best_hyperparameters)."""
    spaces = dict(SEARCH_SPACES)
    if minibatch != "graphsaint":
        spaces.pop("walk_length")
        spaces.pop("num_steps")
    if minibatch != "neighbor":
        spaces.pop("nb_size", None)
    elif nb_size is not None:
        # an explicitly requested fan-in replaces the default space
        spaces["nb_size"] = [nb_size]
    if minibatch == "full":
        spaces.pop("batch_size")
    shuffler = pyrandom.Random(seed)
    current = {k: v[0] for k, v in spaces.items()}
    best = {"val_acc": -1.0, "emb": None, "metrics": None, "hp": dict(current)}
    types = list(spaces)
    shuffler.shuffle(types)
    seen = set()
    for param_type in types:
        vals = list(spaces[param_type])
        shuffler.shuffle(vals)
        for val in vals:
            current[param_type] = val
            key = tuple(sorted(current.items()))
            if key in seen:
                continue
            seen.add(key)
            emb, metrics = train_node_embeddings(
                graph, conv_type=conv_type, minibatch=minibatch,
                epochs=epochs, seed=seed, nb_exact=nb_exact, device=device,
                **current)
            if log_fn:
                log_fn(f"greedy {current} -> val_acc={metrics['val_acc']:.4f}"
                       f" val_auc={metrics['val_auc']:.4f}")
            if metrics["val_acc"] >= best["val_acc"]:
                best = {"val_acc": metrics["val_acc"], "emb": emb,
                        "metrics": metrics, "hp": dict(current)}
        # settle this coordinate at the best value seen so far
        current[param_type] = best["hp"][param_type]
    return best["emb"], best["metrics"], best["hp"]


def save_embeddings(out_dir: str | Path, emb: np.ndarray, conv_type: str):
    """Write <conv>_embeddings.pth (a torch tensor, reference-compatible)
    and its .npy twin."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    name = "gin" if conv_type == "gin" else "graphsaint_gcn"
    np.save(out_dir / f"{name}_embeddings.npy", emb)
    torch.save(torch.tensor(emb), out_dir / f"{name}_embeddings.pth")
