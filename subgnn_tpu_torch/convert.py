"""Carry a JAX-trained parameter tree over to the port.

The port keeps the JAX package's parameter layout (nested dicts and lists,
linear weights (in, out) applied as x @ w, LSTM w_ih (in, 4h) / w_hh
(h, 4h) with gate order i, f, g, o), so the conversion is a leaf-by-leaf
copy into float32 tensors; no transpose is needed. Checkpoints written by
the JAX package (pickled numpy trees) go through here.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device


def tree_from_numpy(tree, device: torch.device):
    """Nested dict/list of array-likes -> the same tree of tensors."""
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_from_numpy(v, device) for v in tree]
    arr = np.asarray(tree)
    if arr.dtype.kind == "f":
        arr = arr.astype(np.float32)
    return torch.as_tensor(arr, device=device)


def params_from_jax(params_np, state_np=None,
                    device: str | torch.device = "cuda"):
    """(params, state) as the port's trees on `device`, from the JAX
    package's parameter and model-state trees given as numpy arrays
    (e.g. jax.tree_util.tree_map(np.asarray, params), or a checkpoint's
    payload["params"] / payload["state"])."""
    dev = resolve_device(device)
    return (tree_from_numpy(params_np, dev),
            tree_from_numpy(state_np or {}, dev))


def gnn_params_from_jax(params_np, device: str | torch.device = "cuda"):
    """The node-embedding pretrainer's parameters on `device`, from the JAX
    package's ({"conv1": {"w", "b"}, "conv2": {"w", "b"}}, numpy arrays;
    the same layout, w as (d_in, d_out))."""
    return tree_from_numpy(params_np, resolve_device(device))
