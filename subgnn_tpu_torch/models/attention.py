"""Masked softmax, dot-product and additive attention (ff_attn readout).

Port of subgnn_tpu/models/attention.py (reference: SubGNN/attention.py,
AllenNLP-derived). Weights keep the JAX layout: x @ w.
"""
from __future__ import annotations

import torch

TINY = 1e-13


def masked_softmax(vector, mask, axis: int = -1):
    """Softmax over the unmasked entries (reference: attention.py:22-56,
    memory_efficient=False branch)."""
    if mask is None:
        return torch.softmax(vector, dim=axis)
    mask = mask.to(vector.dtype)
    result = torch.softmax(vector * mask, dim=axis)
    result = result * mask
    return result / (result.sum(dim=axis, keepdim=True) + TINY)


def init_additive_attention(generator: torch.Generator, vector_dim: int,
                            matrix_dim: int):
    """W, U, V parameters with xavier-uniform init
    (reference: attention.py:124-134)."""
    def xavier(shape):
        bound = (6.0 / (shape[0] + shape[1])) ** 0.5
        return (torch.rand(shape, generator=generator) * 2 - 1) * bound

    return {"w": xavier((vector_dim, vector_dim)),
            "u": xavier((matrix_dim, vector_dim)),
            "v": xavier((vector_dim, 1))}


def additive_attention(params, vector, matrix, matrix_mask=None):
    """V.tanh(Wx + Uy) similarities -> masked softmax over rows.
    vector: (B, Dv); matrix: (B, R, Dm); returns (B, R)
    (reference: attention.py:102-139)."""
    inter = (vector @ params["w"])[:, None, :] + matrix @ params["u"]
    sims = (torch.tanh(inter) @ params["v"])[..., 0]
    return masked_softmax(sims, matrix_mask)


def dot_product_attention(vector, matrix, matrix_mask=None,
                          normalize: bool = True):
    """Dot-product similarities between a vector and matrix rows,
    optionally masked-softmax-normalized. vector: (B, D); matrix:
    (B, R, D); returns (B, R) (reference: attention.py:60-100)."""
    sims = torch.einsum("bd,brd->br", vector, matrix)
    if normalize:
        return masked_softmax(sims, matrix_mask)
    return sims


def weighted_sum(matrix, attention_weights):
    """(B, R, D), (B, R) -> (B, D) (reference: subgraph_utils.py:179-211)."""
    return torch.einsum("br,brd->bd", attention_weights, matrix)


def masked_sum(vector, mask, axis: int):
    """Sum with masked entries zeroed (reference: subgraph_utils.py:213-237)."""
    return torch.where(mask, vector, 0.0).sum(dim=axis)
