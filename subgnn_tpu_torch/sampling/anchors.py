"""Anchor-patch initialization per (split, layer).

Reference: SubGNN/anchor_patch_samplers.py:163-328. All anchors are sampled
offline per split and layer and stacked into dense arrays keyed
[split][channel]; the training step only gathers rows — no sampling inside
jit.

Layouts (layer-major so one array serves the whole model):
  neigh_int[split] : (n_layers, N_split, C, A_N_in)   sampled per CC
  neigh_bor[split] : (n_layers, N_split, C, A_N_out)  sampled per border set
  pos_int[split]   : (n_layers, N_split, A_P_in)      sampled per subgraph
  pos_ext          : (n_layers, A_P_out)              shared across splits
                     (quirk preserved: border position/structure anchors are
                     global while internal ones are per-split,
                     reference SubGNN.py:1012-1020)
  structure        : patches (n_layers, A_S, Lp), pool indices
                     (n_layers, A_S), internal walks (n_layers, A_S, W, L),
                     border walks (n_layers, A_S, W, L)

Sampling DEVIATION (documented): the reference samples one element from each
padded row via argmax over randn with pads zeroed
(anchor_patch_samplers.py:174-194); when every real entry draws a negative
normal, the argmax lands on a pad and the anchor silently disappears (p =
2^-row_len). We sample uniformly over the real entries — same distribution
conditional on a draw landing, never dropping anchors.

A numpy copy of subgnn_tpu/sampling/anchors.py: the same seeded streams give
bit-identical anchors in both packages.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..data.graph import CSRGraph

PAD_VALUE = 0


def _sample_from_rows(rows: np.ndarray, n_samples: int,
                      rng: np.random.Generator) -> np.ndarray:
    """Uniformly sample n_samples entries (with replacement) from the non-pad
    prefix of each row. Pad-only rows sample PAD. rows: (R, L) -> (R, n)."""
    R, L = rows.shape
    lengths = (rows != PAD_VALUE).sum(axis=1)
    safe_len = np.maximum(lengths, 1)
    # For rows whose pads are interleaved (border sets are sorted so pads are
    # a suffix; cc rows likewise), real entries occupy the prefix.
    idx = (rng.random((R, n_samples)) * safe_len[:, None]).astype(np.int64)
    out = np.take_along_axis(rows, idx, axis=1)
    out[lengths == 0] = PAD_VALUE
    return out.astype(np.int32)


def init_anchors_neighborhood(hp, cc_ids: np.ndarray,
                              border_set: Optional[np.ndarray],
                              seed: int, split_tag: int):
    """(internal, border): (n_layers, N, C, A) int32 each."""
    N, C, L = cc_ids.shape
    flat_cc = cc_ids.reshape(N * C, L)
    ints, bors = [], []
    for layer in range(hp.n_layers):
        rng = np.random.default_rng([seed, 311, split_tag, layer])
        ints.append(_sample_from_rows(flat_cc, hp.n_anchor_patches_N_in, rng)
                    .reshape(N, C, -1))
        if border_set is not None:
            flat_b = border_set.reshape(N * C, -1)
            rng_b = np.random.default_rng([seed, 313, split_tag, layer])
            bors.append(_sample_from_rows(flat_b, hp.n_anchor_patches_N_out, rng_b)
                        .reshape(N, C, -1))
    internal = np.stack(ints)
    border = np.stack(bors) if bors else None
    return internal, border


def init_anchors_pos_int(hp, subgraph_lists, seed: int, split_tag: int) -> np.ndarray:
    """(n_layers, N, A_P_in) int32 — uniform nodes from each whole subgraph
    (reference: anchor_patch_samplers.py:200-208, 281-304)."""
    out = np.zeros((hp.n_layers, len(subgraph_lists), hp.n_anchor_patches_pos_in),
                   dtype=np.int32)
    for layer in range(hp.n_layers):
        rng = np.random.default_rng([seed, 331, split_tag, layer])
        for i, sg in enumerate(subgraph_lists):
            out[layer, i] = rng.choice(np.asarray(sg, dtype=np.int32),
                                       hp.n_anchor_patches_pos_in, replace=True)
    return out


def init_anchors_pos_ext(hp, graph: CSRGraph, seed: int) -> np.ndarray:
    """(n_layers, A_P_out) int32 — uniform nodes from the base graph, shared
    across splits (reference: anchor_patch_samplers.py:306-314)."""
    all_nodes = graph.node_ids()
    out = np.zeros((hp.n_layers, hp.n_anchor_patches_pos_out), dtype=np.int32)
    for layer in range(hp.n_layers):
        rng = np.random.default_rng([seed, 337, layer])
        out[layer] = rng.choice(all_nodes, hp.n_anchor_patches_pos_out,
                                replace=True)
    return out


def init_anchors_structure(hp, structure_anchors: np.ndarray,
                           int_walks: np.ndarray, bor_walks: np.ndarray,
                           seed: int):
    """Subsample A_S patches (and their precomputed walks) from the pool for
    each layer (reference: anchor_patch_samplers.py:316-328).

    Returns (patches, pool_indices, int_walks, bor_walks) stacked layer-major.
    """
    n_pool = structure_anchors.shape[0]
    patches, idxs, iw, bw = [], [], [], []
    for layer in range(hp.n_layers):
        rng = np.random.default_rng([seed, 341, layer])
        idx = rng.integers(0, n_pool, hp.n_anchor_patches_structure)
        patches.append(structure_anchors[idx])
        idxs.append(idx.astype(np.int32))
        iw.append(int_walks[idx])
        bw.append(bor_walks[idx])
    return (np.stack(patches), np.stack(idxs), np.stack(iw), np.stack(bw))

