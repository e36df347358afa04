"""The program's own spans and counters of a fit, for the per-layer metrics
that read them.

The port records, per epoch of `Trainer.fit`, named spans of host time and
counters (subgnn_tpu_torch/train/spans.py); `last()` there is the recorder
of the process's last fit. A reader takes each epoch of the window that ran
without the profiler, leaving out the traced epochs and the epoch on each
side of them (as fit._clean_walls leaves their walls out), and returns the
median per epoch. Where the program has no recorder (a version before it),
or no such epoch was recorded, it returns None.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np


def recorder():
    """The program's recorder of its last fit, or None."""
    try:
        from subgnn_tpu_torch.train.spans import last
    except ImportError:
        return None
    return last()


def clean_epochs(ctx) -> List[int]:
    """Indices of the window's epochs that ran without the profiler and
    without its start or stop (empty without traced epochs)."""
    traced = ctx.get("traced_epochs") or []
    if not traced:
        return []
    first = traced[0] - 1                # the window's first epoch
    skip = set(traced) | {first, traced[-1] + 1}
    return [e for e in range(first, first + ctx["epochs"]) if e not in skip]


def span_ns(rec, epoch: int, *names: str) -> Optional[int]:
    """Nanoseconds of the spans of these names in `epoch`, summed; None
    where the epoch has none of them."""
    found = [t for t in (rec.total_ns(epoch, n) for n in names)
             if t is not None]
    return sum(found) if found else None


def median(ctx, per_epoch: Callable) -> Optional[float]:
    """The median over the clean epochs of per_epoch(recorder, epoch),
    leaving out the epochs where it gives None."""
    rec = recorder()
    if rec is None:
        return None
    values = [per_epoch(rec, e) for e in clean_epochs(ctx)
              if e in rec.epochs]
    values = [v for v in values if v is not None]
    return float(np.median(values)) if values else None
