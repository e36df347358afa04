"""Inverted dropout through one mask function.

The training forward draws every dropout mask (the two head dropouts and
the dropout between LSTM layers) through a `keep_mask(shape, rate)`
callable that returns a bool tensor, True where the unit is kept. The
trainer builds it from a torch.Generator (`generator_keep_mask`); parity
tests pass a function that replays the JAX package's masks in draw order
(LSTM layers first, then the two head layers), since torch and jax.random
give different bits from the same seed.

A rank at data index d of a mesh (parallel/mesh.py) holds rows
[d*b, (d+1)*b) of the batch. Its keep_mask carries `shard = (n_data, d)`,
and `dropout` over a tensor with a batch axis then draws the mask of the
whole batch and keeps the rank's rows: every rank draws what one process
would, in the same order, so the generator stays in step on every rank and
the masks are the one-process run's. The LSTM's inputs are the anchor
walks, the same on every rank, and have no batch axis.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

KeepMask = Callable[[Sequence[int], float], torch.Tensor]


def generator_keep_mask(generator: torch.Generator,
                        shard: Optional[Tuple[int, int]] = None) -> KeepMask:
    """Keep-masks with P(keep) = 1 - rate, drawn from `generator` on the
    generator's device. `shard`: (n_data, data index) on a mesh rank."""
    def keep_mask(shape, rate):
        return torch.rand(tuple(shape), generator=generator,
                          device=generator.device) >= rate
    keep_mask.shard = shard
    return keep_mask


def dropout(x: torch.Tensor, rate: float, keep_mask: KeepMask,
            batch_axis: Optional[int] = None) -> torch.Tensor:
    """where(keep, x / (1 - rate), 0), as subgnn_tpu/models/subgnn.py:436-444.
    `batch_axis`: x's batch axis, where a sharded keep_mask takes its
    rank's rows of the whole batch's mask."""
    shape = tuple(x.shape)
    shard = getattr(keep_mask, "shard", None)
    if batch_axis is None or shard is None:
        keep = keep_mask(shape, rate)
    else:
        n_data, index = shard
        b = shape[batch_axis]
        whole = shape[:batch_axis] + (b * n_data,) + shape[batch_axis + 1:]
        keep = keep_mask(whole, rate).narrow(batch_axis, index * b, b)
    return torch.where(keep.to(x.device), x / (1.0 - rate), 0.0)
