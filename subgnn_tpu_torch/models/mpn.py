"""Subgraph-level message passing as dense masked einsums.

Port of subgnn_tpu/models/mpn.py (reference: SubGNN/subgraph_mpn.py). Every
CC receives a message from a fixed number of anchor patches per channel, so
one layer is

    msgs[b,c,a,:] = valid[b,c,a] * sim[b,c,a] * anchor_embed[b,c,a,:]
    agg[b,c,:]    = sum_a msgs[b,c,a,:]
    cc'[b,c,:]    = relu(Linear([cc ; agg]))
    prop[b,c,a]   = relu(Linear_1(msgs[b,c,a,:]))

Quirks kept: masked message slots are exact zeros, so prop there is
relu(bias); the update also runs on padded CC rows (masked later). Weights
keep the JAX layout: x @ w with w (in, out).
"""
from __future__ import annotations

import torch


def _uniform(generator, shape, bound):
    return (torch.rand(shape, generator=generator) * 2 - 1) * bound


def init_mpn_params(generator: torch.Generator, embed_dim: int):
    """Linear(2D -> D) update + Linear(D -> 1) property head
    (reference: subgraph_mpn.py:33-34), torch-default init bounds."""
    b1 = 1.0 / (2 * embed_dim) ** 0.5
    b2 = 1.0 / embed_dim ** 0.5
    return {
        "linear": {"w": _uniform(generator, (2 * embed_dim, embed_dim), b1),
                   "b": _uniform(generator, (embed_dim,), b1)},
        "linear_position": {"w": _uniform(generator, (embed_dim, 1), b2),
                            "b": _uniform(generator, (1,), b2)},
    }


def mpn_messages(params, anchor_embeds, sims, anchor_valid, *,
                 norm_pos_struc_embed: bool = False, layout: str = "full"):
    """Message aggregation + property head of one MPN layer, without the
    channel-update linear. Layouts of anchor_embeds: 'full' (B, C, A, D),
    'per_subgraph' (B, A, D), 'shared' (A, D). Returns (agg (B,C,D),
    prop (B,C,A))."""
    dt = anchor_embeds.dtype
    w = torch.where(anchor_valid, sims, 0.0).to(dt)               # (B,C,A)
    w_pos = params["linear_position"]["w"].to(dt)                 # (D, 1)
    b_pos = params["linear_position"]["b"].to(dt)

    if layout == "shared":
        agg = torch.einsum("bca,ad->bcd", w, anchor_embeds)
        proj = (anchor_embeds @ w_pos)[:, 0]                      # (A,)
        prop_pre = w * proj[None, None, :] + b_pos
    elif layout == "per_subgraph":
        agg = torch.einsum("bca,bad->bcd", w, anchor_embeds)
        proj = (anchor_embeds @ w_pos)[..., 0]                    # (B, A)
        prop_pre = w * proj[:, None, :] + b_pos
    elif layout == "full":
        agg = torch.einsum("bca,bcad->bcd", w, anchor_embeds)
        proj = (anchor_embeds @ w_pos)[..., 0]                    # (B,C,A)
        prop_pre = w * proj + b_pos
    else:
        raise ValueError(layout)

    if norm_pos_struc_embed:
        norm = torch.linalg.vector_norm(prop_pre, dim=-1, keepdim=True)
        prop = prop_pre / norm.clamp_min(1e-12)
    else:
        prop = torch.relu(prop_pre)
    return agg, prop


def mpn_update(params, cc_embeds, agg, *, use_mpn_projection: bool = True):
    """Channel-update half of one MPN layer: relu(Linear([cc ; agg]))
    (reference: subgraph_mpn.py:233-241)."""
    if not use_mpn_projection:
        return agg
    dt = agg.dtype
    x = torch.cat([cc_embeds.to(dt), agg], dim=-1)                # (B,C,2D)
    return torch.relu(x @ params["linear"]["w"].to(dt)
                      + params["linear"]["b"].to(dt))


def mpn_update_stacked(param_list, cc_list, agg_list):
    """K channel updates as ONE batched contraction: (K, B, C, 2D) x
    (K, 2D, D), the same per-slice math as K mpn_update calls."""
    dt = agg_list[0].dtype
    x = torch.stack([torch.cat([cc.to(dt), agg], dim=-1)
                     for cc, agg in zip(cc_list, agg_list)])      # (K,B,C,2D)
    w = torch.stack([p["linear"]["w"].to(dt) for p in param_list])
    b = torch.stack([p["linear"]["b"].to(dt) for p in param_list])
    out = torch.relu(torch.einsum("kbci,kio->kbco", x, w)
                     + b[:, None, None, :])
    return [out[k] for k in range(len(param_list))]


def mpn_layer(params, cc_embeds, anchor_embeds, sims, anchor_valid, *,
              use_mpn_projection: bool = True,
              norm_pos_struc_embed: bool = False, layout: str = "full"):
    """One anchor-patch -> CC message-passing layer. Returns
    (updated_cc (B,C,D), prop (B,C,A))."""
    agg, prop = mpn_messages(params, anchor_embeds, sims, anchor_valid,
                             norm_pos_struc_embed=norm_pos_struc_embed,
                             layout=layout)
    updated = mpn_update(params, cc_embeds, agg,
                         use_mpn_projection=use_mpn_projection)
    return updated, prop
