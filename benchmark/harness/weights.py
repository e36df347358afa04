"""Node embeddings and model weights, drawn on the device from the seed.

Both sides of the comparison get these same tensors: the program through its
parameter tree, the reference through a copy. The program's own initialiser
is only asked for the tree's layout; every leaf is then overwritten here
from one uniform draw of a torch.Generator on the device, so no value of
the program's making reaches the reference.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def leaves(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) of a nested dict/list tree, in insertion order (the
    order in which the program's Adam lists its moments)."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in leaves(v, f"{prefix}/{k}" if prefix else str(k))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in leaves(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def embeddings(n_nodes: int, dim: int, seed: int,
               device: torch.device) -> torch.Tensor:
    """(n_nodes, dim) float32 rows of N(0, 1/dim), one draw on `device`."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    return torch.randn(n_nodes, dim, generator=gen, device=device) \
        / math.sqrt(dim)


@torch.no_grad()
def fill(params: Dict, table: torch.Tensor, dim: int, seed: int) -> None:
    """Overwrite every leaf of `params` in place: node_embed's rows
    1..n from `table` (row 0 and the alignment rows zero), every other
    leaf U(-b, b) from one draw, b = 1/sqrt(rows) of a matrix and
    1/sqrt(dim) of a vector."""
    others = [(p, t) for p, t in leaves(params) if p != "node_embed"]
    dev = table.device
    total = sum(t.numel() for _, t in others)
    gen = torch.Generator(device=dev).manual_seed((int(seed) + 7) % (1 << 63))
    flat = torch.rand(total, generator=gen, device=dev) * 2 - 1
    off = 0
    for _, t in others:
        b = 1.0 / math.sqrt(t.shape[0] if t.dim() >= 2 else dim)
        t.copy_((flat[off:off + t.numel()] * b).view_as(t))
        off += t.numel()
    emb = params["node_embed"]
    emb.zero_()
    emb[1:1 + table.shape[0]] = table


def program_params(hp, n_nodes: int, n_classes: int, seed: int, device):
    """(model, params, state, params0) of the program: the model object,
    its parameter tree (laid out by the program's initialiser, filled
    here), its state, and a CPU copy of the leaves by path."""
    import numpy as np
    from subgnn_tpu_torch.models.subgnn import SubGNNModel
    D = hp.node_embed_size
    model = SubGNNModel(hp, n_nodes, n_classes, multilabel=False)
    params, state = model.init_params(torch.Generator().manual_seed(0),
                                      np.zeros((n_nodes, D), np.float32),
                                      device=device)
    fill(params, embeddings(n_nodes, D, seed, device), D, seed)
    params0 = {p: t.detach().cpu().clone() for p, t in leaves(params)}
    return model, params, state, params0
