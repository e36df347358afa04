"""Host-side id layouts shared by the batch builders.

Only `neigh_ids_for_batch` is needed by serving; the gather plans of
subgnn_tpu/train/plans.py arrive with the training step.
"""
from __future__ import annotations

import numpy as np


def neigh_ids_for_batch(anchors, idx: np.ndarray) -> np.ndarray:
    """(L, B, C, A_in+A_out) ids exactly as the forward consumes them
    (models/subgnn.py n_ids_all: internal then border along the last
    axis)."""
    n_int = np.asarray(anchors["neigh_int"])
    n_bor = np.asarray(anchors["neigh_bor"])
    return np.concatenate([n_int[:, idx], n_bor[:, idx]], axis=-1)
