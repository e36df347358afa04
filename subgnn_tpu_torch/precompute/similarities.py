"""Channel similarities: N/P shortest-path sims, S DTW sims, and the
reference-compatible cache paths.

Port of subgnn_tpu/precompute/similarities.py (host and single-device
paths). Artifact filenames follow the reference's cache-key scheme, so the
caches are interchangeable between the two packages and the reference
(SubGNN/SubGNN.py:852-854, 893, 904, 913, 926-931).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..data.graph import CSRGraph
from .degree import degree_sequences
from .dtw import dtw_similarity_grouped, dtw_similarity_matrix

PAD_VALUE = 0


def compute_shortest_path_similarities(shortest_paths: np.ndarray,
                                       cc_ids: np.ndarray) -> np.ndarray:
    """(n_subgraphs, max_n_cc, n_nodes) float32: hop distance from each CC to
    every node = min over the CC's rows of the path matrix.

    Faithful to reference SubGNN/SubGNN.py:752-781: RAW hop distances (no
    reciprocal), 1-based node ids map to 0-based matrix rows, padded CCs
    are filled with PAD_VALUE (0, also a legal distance — quirk preserved).
    `shortest_paths` may be the (n, n) all-pairs matrix or a (k, n)
    row subset from shortest_path_rows with cc_ids remapped into 1-based
    row space.
    """
    n_sub, max_n_cc, _ = cc_ids.shape
    n_nodes = shortest_paths.shape[1]
    sims = np.full((n_sub, max_n_cc, n_nodes), float(PAD_VALUE),
                   dtype=np.float32)
    for s in range(n_sub):
        for c in range(max_n_cc):
            comp = cc_ids[s, c]
            comp = comp[comp != PAD_VALUE]
            if comp.size:
                sims[s, c, :] = shortest_paths[comp - 1, :].min(axis=0)
    return sims


def compute_structure_similarities(graph: CSRGraph, cc_ids: np.ndarray,
                                   structure_anchors: np.ndarray,
                                   internal: bool,
                                   device: str | torch.device = "cuda"
                                   ) -> np.ndarray:
    """(n_subgraphs, max_n_cc, n_anchors) float32 DTW similarities between
    every CC and every pooled structure anchor patch (reference:
    SubGNN/SubGNN.py:783-833). Padded CCs are PAD_VALUE (SubGNN.py:831)."""
    n_sub, max_n_cc, L = cc_ids.shape
    comp_flat = cc_ids.reshape(n_sub * max_n_cc, L)
    comp_seqs, comp_lens = degree_sequences(graph, comp_flat, internal=internal)
    anchor_seqs, anchor_lens = degree_sequences(graph, structure_anchors,
                                                internal=internal)
    sims = dtw_similarity_matrix(comp_seqs, comp_lens, anchor_seqs,
                                 anchor_lens, device=device)
    sims = sims.reshape(n_sub, max_n_cc, -1).astype(np.float32)
    sims[cc_ids[:, :, 0] == PAD_VALUE] = PAD_VALUE
    return sims


def structure_similarities_both(graph: CSRGraph, cc_ids: np.ndarray,
                                structure_anchors: np.ndarray,
                                anchor_cache: dict | None = None,
                                device: str | torch.device = "cuda"):
    """Internal AND border structure similarities in ONE kernel launch
    (serving hot path; equals two compute_structure_similarities calls).

    anchor_cache: a dict the caller keeps per anchor pool — the pool's
    degree sequences are request-invariant, so a warm serving path skips
    recomputing them. Returns (int_sims, bor_sims).
    """
    n_sub, max_n_cc, L = cc_ids.shape
    comp_flat = cc_ids.reshape(n_sub * max_n_cc, L)
    ci, li = degree_sequences(graph, comp_flat, internal=True)
    cb, lb = degree_sequences(graph, comp_flat, internal=False)
    if anchor_cache is None:
        anchor_cache = {}
    if "int" not in anchor_cache:
        anchor_cache["int"] = degree_sequences(graph, structure_anchors,
                                               internal=True)
        anchor_cache["bor"] = degree_sequences(graph, structure_anchors,
                                               internal=False)
    (ai, ali), (ab, alb) = anchor_cache["int"], anchor_cache["bor"]
    sims = dtw_similarity_grouped(
        np.stack([ci, cb]), np.stack([li, lb]),
        np.stack([ai, ab]), np.stack([ali, alb]), device=device)
    cc_mask = cc_ids[:, :, 0] != PAD_VALUE
    out = []
    for g in range(2):
        s = sims[g].reshape(n_sub, max_n_cc, -1).astype(np.float32)
        s[~cc_mask] = PAD_VALUE
        out.append(s)
    return out[0], out[1]


# --------------------------------------------------------------------- cache

def cached(path: Path, compute_fn, recompute: bool = False) -> np.ndarray:
    """Load a .npy artifact or compute+save it (reference caching pattern,
    SubGNN/SubGNN.py:856-873)."""
    path = Path(path)
    if path.exists() and not recompute:
        return np.load(path, allow_pickle=True)
    arr = compute_fn()
    path.parent.mkdir(parents=True, exist_ok=True)
    np.save(path, arr)
    return arr


def np_sim_path(sim_dir: Path, split: str) -> Path:
    return Path(sim_dir) / f"{PAD_VALUE}_{split}_similarities.npy"


def border_set_path(sim_dir: Path, radius: int, split: str) -> Path:
    return Path(sim_dir) / f"{radius}_{PAD_VALUE}_{split}_border_set.npy"


def struc_patches_path(sim_dir: Path, hp) -> Path:
    return Path(sim_dir) / (
        f"struc_patches_{hp.sample_walk_len}_{hp.structure_patch_type}_"
        f"{hp.max_sim_epochs}.npy")


def struc_walks_path(sim_dir: Path, hp, internal: bool) -> Path:
    pre = "int" if internal else "bor"
    return Path(sim_dir) / (
        f"{pre}_struc_patch_random_walks_{hp.n_triangular_walks}_"
        f"{hp.random_walk_len}_{hp.sample_walk_len}_"
        f"{hp.structure_patch_type}_{hp.max_sim_epochs}.npy")


def struc_sim_path(sim_dir: Path, hp, internal: bool, split: str) -> Path:
    pre = "int" if internal else "bor"
    suffix = ("_" + hp.structure_similarity_fn
              if hp.structure_similarity_fn != "dtw" else "")
    return Path(sim_dir) / (
        f"{pre}_struc_{hp.sample_walk_len}_{hp.structure_patch_type}_"
        f"{hp.max_sim_epochs}_{PAD_VALUE}{suffix}_{split}_similarities.npy")
