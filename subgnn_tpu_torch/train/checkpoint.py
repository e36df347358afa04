"""Read checkpoints written by the JAX package.

Checkpoints are pickled payloads of numpy trees (subgnn_tpu/train/
checkpoint.py:18-38): {"params", "state", "opt_state", "meta"}. The port
serves them by copying matching leaves into its own parameter tree.
Unpickling runs code from the file: load only checkpoints this system wrote.
"""
from __future__ import annotations

import json
import pickle
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch


def load_checkpoint(path: str | Path):
    with open(path, "rb") as f:
        return pickle.load(f)


def load_params_filtered(path: str | Path, current_params, payload=None):
    """Restore, keeping only leaves whose path exists in current_params and
    whose shape matches — the reference's filtered state_dict intersection
    load (reference: SubGNN/train.py:264-273,398-408). Restored leaves take
    the current leaf's dtype and device. Pass `payload` (an already loaded
    checkpoint) to avoid re-reading the file."""
    if payload is None:
        payload = load_checkpoint(path)
    saved = payload["params"]

    def merge(cur, sav):
        if isinstance(cur, dict):
            return {k: merge(cur[k], sav[k]) if isinstance(sav, dict) and k in sav
                    else cur[k] for k in cur}
        if isinstance(cur, list):
            if not isinstance(sav, list):
                return cur
            # overlap merges positionally; extra current layers keep init
            return [merge(c, sav[i]) if i < len(sav) else c
                    for i, c in enumerate(cur)]
        if sav is not None and np.shape(sav) == tuple(cur.shape):
            return torch.as_tensor(np.asarray(sav), dtype=cur.dtype,
                                   device=cur.device)
        return cur

    return merge(current_params, saved)


def dump_json(path: str | Path, obj: Dict[str, Any]):
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=4, default=float)
