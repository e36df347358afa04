"""Checkpoints shared with the JAX package, with top-k retention.

Checkpoints are pickled payloads of numpy trees (subgnn_tpu/train/
checkpoint.py:18-112): {"params", "state", "opt_state", "meta"}. The port
writes params and state as numpy trees in the JAX package's layout, so the
JAX package's loaders and both predict CLIs read a checkpoint the port
trained; the optimizer state is the port's own (train/loop.py:Adam), and
the port adds the dropout generator's state ("rng_state", a uint8 array)
so that a resumed run draws the masks the uninterrupted one drew.
The port reads checkpoints by copying matching leaves into its own tree;
the optax classes of a JAX-written optimizer state load as plain tuples,
so its weights restore where optax is not installed.
Unpickling runs code from the file: load only checkpoints this system wrote.
"""
from __future__ import annotations

import json
import pickle
from pathlib import Path
from typing import Any, Dict, List, Tuple

import numpy as np
import torch


def to_numpy(tree):
    """Nested dict/list tree of tensors -> the same tree of numpy arrays."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy(v) for v in tree]
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    return np.asarray(tree) if tree is not None else None


def save_checkpoint(path: str | Path, params, state=None, opt_state=None,
                    meta: Dict[str, Any] | None = None, rng_state=None):
    payload = {
        "params": to_numpy(params),
        "state": to_numpy(state) if state is not None else None,
        "opt_state": to_numpy(opt_state) if opt_state is not None else None,
        "meta": meta or {},
    }
    if rng_state is not None:
        payload["rng_state"] = np.asarray(rng_state, np.uint8)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(payload, f)


class ForeignState(tuple):
    """Stands in for an optax state class (a NamedTuple) in a checkpoint
    the JAX package wrote: its fields, as a tuple."""

    def __new__(cls, *fields):
        return super().__new__(cls, fields)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] == "optax":
            return ForeignState
        return super().find_class(module, name)


def load_checkpoint(path: str | Path):
    with open(path, "rb") as f:
        return _Unpickler(f).load()


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


class TopKCheckpoints:
    """Keep the best-k checkpoints by a monitored metric (higher is better),
    with the JAX package's file names (reference PL ModelCheckpoint top-3,
    SubGNN/train_config.py:144-150)."""

    def __init__(self, ckpt_dir: str | Path, k: int = 3,
                 monitor: str = "val_micro_f1"):
        self.dir = Path(ckpt_dir)
        self.k = k
        self.monitor = monitor
        self.kept: List[Tuple[float, Path]] = []

    def maybe_save(self, epoch: int, metrics: Dict[str, float],
                   params, state=None, opt_state=None,
                   global_step: int | None = None, rng_state=None) -> bool:
        key = float(metrics.get(self.monitor, float("-inf")))
        if np.isnan(key):
            # a NaN monitor must not win best_path (NaN compares False)
            return False
        if len(self.kept) >= self.k and key <= min(v for v, _ in self.kept):
            return False
        fname = (f"epoch={epoch}-val_micro_f1={metrics.get('val_micro_f1', 0):.2f}"
                 f"-val_acc={metrics.get('val_acc', 0):.2f}"
                 f"-val_auroc={metrics.get('val_auroc', 0):.2f}.ckpt")
        path = self.dir / fname
        meta = {"epoch": epoch, **{k: float(v) for k, v in metrics.items()
                                   if isinstance(v, (int, float))}}
        if global_step is not None:
            meta["global_step"] = int(global_step)
        save_checkpoint(path, params, state, opt_state, meta=meta,
                        rng_state=rng_state)
        self.kept.append((key, path))
        self.kept.sort(key=lambda t: -t[0])
        while len(self.kept) > self.k:
            _, worst = self.kept.pop()
            worst.unlink(missing_ok=True)
        return True

    @property
    def best_path(self) -> Path | None:
        return self.kept[0][1] if self.kept else None


def dump_json(path: str | Path, obj: Dict[str, Any]):
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=4, default=float)
