"""Inverted dropout through one mask function.

The training forward draws every dropout mask (the two head dropouts and
the dropout between LSTM layers) through a `keep_mask(shape, rate)`
callable that returns a bool tensor, True where the unit is kept. The
trainer builds it from a torch.Generator (`generator_keep_mask`); parity
tests pass a function that replays the JAX package's masks in draw order
(LSTM layers first, then the two head layers), since torch and jax.random
give different bits from the same seed.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

KeepMask = Callable[[Sequence[int], float], torch.Tensor]


def generator_keep_mask(generator: torch.Generator) -> KeepMask:
    """Keep-masks with P(keep) = 1 - rate, drawn from `generator` on the
    generator's device."""
    def keep_mask(shape, rate):
        return torch.rand(tuple(shape), generator=generator,
                          device=generator.device) >= rate
    return keep_mask


def dropout(x: torch.Tensor, rate: float, keep_mask: KeepMask) -> torch.Tensor:
    """where(keep, x / (1 - rate), 0), as subgnn_tpu/models/subgnn.py:436-444."""
    keep = keep_mask(tuple(x.shape), rate).to(x.device)
    return torch.where(keep, x / (1.0 - rate), 0.0)
