"""Explicit ring collectives on torch.distributed point-to-point.

Port of subgnn_tpu/parallel/collectives.py. The JAX package builds a
uni-directional ring from `lax.ppermute` inside `shard_map` over a mesh
axis; here the ring runs over the ranks of a process group, in group-rank
order: each rotation is one `dist.batch_isend_irecv` of a send to rank
(i + 1) % n and a receive from rank (i - 1) % n. The algorithm is JAX's:
pad the flattened tensor to a multiple of n, n - 1 reduce-scatter
rotations leave rank i with the fully reduced chunk (i + 1) % n, then n - 1
all-gather rotations carry the reduced chunks around. A group of one rank
returns `x` (or `chunk_fn(x)`, or `x[None]`) as JAX does.

These are A/B baselines for the collectives torch.distributed already has
(`dist.all_reduce`, `dist.all_gather`): nothing in the port's training or
precompute path calls them.

Staging. NCCL cannot put two ranks on one card, so ranks that share a
card run gloo, and gloo's point-to-point takes CPU tensors only: on an
NVIDIA H100 with torch 2.11, an isend / irecv of CUDA tensors over gloo
fails in its TCP transport ("writev ...: Bad address", the device pointer
written as host memory) and closes the pair's connection, so that every
later call on the group fails too; at times gloo throws it in its I/O
thread instead, and the process aborts (chip_smoke.py phase 5c (d) tries
it on a pair of processes of their own). gloo's all_reduce and all_gather
take CUDA tensors (they stage them themselves). So a CUDA tensor on a gloo
group goes through one host copy before the ring and one after it, and
every rotation moves host buffers; NCCL rotates device buffers.

Each rotation is counted under its helper (`calls` += 1, `bytes` += the
chunk sent), as parallel/mesh.py counts its collectives: on the wire it is
one collective-permute (parallel/audit.py).

Numerics: the ring adds in rotation order, so float sums can differ from
`dist.all_reduce`'s by reassociation rounding; the gather is exact.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist

from .mesh import Mesh


def _ring(mesh_or_group) -> Tuple[object, int, int, Tuple[int, int]]:
    """(group, n, this rank's index i, (global rank of i + 1, of i - 1))."""
    group = mesh_or_group.group if isinstance(mesh_or_group, Mesh) \
        else mesh_or_group
    if group is None:
        group = dist.group.WORLD
    n = dist.get_world_size(group)
    i = dist.get_rank(group)
    peers = (dist.get_global_rank(group, (i + 1) % n),
             dist.get_global_rank(group, (i - 1) % n))
    return group, n, i, peers


def _stage(x: torch.Tensor, group) -> torch.Tensor:
    """x where the group's point-to-point takes it: the host for gloo."""
    if dist.get_backend(group) == "gloo" and x.device.type != "cpu":
        return x.cpu()
    return x


def _rotate(helper, buf: torch.Tensor, group, peers) -> torch.Tensor:
    """Send `buf` to the next rank and return the previous rank's."""
    out = torch.empty_like(buf)
    send = buf.contiguous()
    ops = [dist.P2POp(dist.isend, send, peers[0], group),
           dist.P2POp(dist.irecv, out, peers[1], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    helper.calls += 1
    helper.bytes += send.numel() * send.element_size()
    return out


def _ring_reduce(helper, x: torch.Tensor, mesh_or_group,
                 chunk_fn: Optional[Callable]) -> torch.Tensor:
    group, n, i, peers = _ring(mesh_or_group)
    if n == 1:
        return x if chunk_fn is None else chunk_fn(x)
    flat = _stage(x, group).reshape(-1)
    pad = (-flat.numel()) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    chunks = flat.reshape(n, -1)
    # reduce-scatter: after n - 1 rotations rank i holds the fully reduced
    # chunk (i + 1) % n
    buf = chunks[i].clone()
    for t in range(n - 1):
        buf = _rotate(helper, buf, group, peers) + chunks[(i - t - 1) % n]
    if chunk_fn is not None:
        buf = chunk_fn(buf)
    # all-gather the reduced chunks back around the ring
    out = torch.zeros_like(chunks)
    out[(i + 1) % n] = buf
    for t in range(n - 1):
        buf = _rotate(helper, buf, group, peers)
        out[(i - t) % n] = buf
    out = out.reshape(-1)
    if pad:
        out = out[:-pad]
    return out.reshape(x.shape).to(x.device)


def ring_all_reduce(x: torch.Tensor, mesh_or_group=None) -> torch.Tensor:
    """The sum of `x` over the ranks of a Mesh's group or a process group
    (None: the default group), by an explicit uni-directional ring: each
    rank sends 2 (n - 1) / n of x's bytes. Equal to dist.all_reduce up to
    float reassociation; `x` is left as it is (and returned itself by a
    group of one)."""
    return _ring_reduce(ring_all_reduce, x, mesh_or_group, None)


def ring_all_gather(x: torch.Tensor, mesh_or_group=None) -> torch.Tensor:
    """(n, *x.shape): every rank's `x` in group-rank order, by a
    uni-directional ring of n - 1 rotations (the explicit form of
    dist.all_gather)."""
    group, n, i, peers = _ring(mesh_or_group)
    if n == 1:
        return x[None]
    buf = _stage(x, group).contiguous()
    out = buf.new_zeros((n,) + tuple(x.shape))
    out[i] = buf
    for t in range(n - 1):
        buf = _rotate(ring_all_gather, buf, group, peers)
        out[(i - t - 1) % n] = buf
    return out.to(x.device)


def ring_all_reduce_fused(x: torch.Tensor, mesh_or_group,
                          chunk_fn: Callable) -> torch.Tensor:
    """ring_all_reduce that applies `chunk_fn` (elementwise,
    shape-preserving) to each fully reduced chunk before the all-gather
    rotations carry it on: chunk_fn of the sum, each element transformed
    once (the fused-optimizer-update pattern)."""
    return _ring_reduce(ring_all_reduce_fused, x, mesh_or_group, chunk_fn)


RING_COLLECTIVES = (ring_all_reduce, ring_all_gather, ring_all_reduce_fused)
for _helper in RING_COLLECTIVES:
    _helper.calls = 0
    _helper.bytes = 0


def reset_counts() -> None:
    for helper in RING_COLLECTIVES:
        helper.calls = helper.bytes = 0
