"""Channel similarities: N/P shortest-path sims, S DTW sims, and the
reference-compatible cache paths.

Port of subgnn_tpu/precompute/similarities.py: the host loop and the
single-device DTW, and on a mesh (parallel/mesh.py) the CC-min over each
rank's column block of the path matrix and the DTW of each rank's block of
comps, gathered to every rank. Artifact filenames follow the reference's
cache-key scheme, so the caches are interchangeable between the two
packages and the reference (SubGNN/SubGNN.py:852-854, 893, 904, 913,
926-931).
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..data.graph import CSRGraph
from ..parallel import mesh as MX
from .degree import degree_sequences
from .dtw import (dtw_similarity_grouped, dtw_similarity_matrix,
                  dtw_similarity_mesh)

PAD_VALUE = 0
CC_MIN_CHUNK = 512      # subgraphs a CC-min step on a mesh


def compute_shortest_path_similarities(shortest_paths: np.ndarray,
                                       cc_ids: np.ndarray,
                                       mesh: Optional[MX.Mesh] = None
                                       ) -> np.ndarray:
    """(n_subgraphs, max_n_cc, n_nodes) float32: hop distance from each CC to
    every node = min over the CC's rows of the path matrix.

    Faithful to reference SubGNN/SubGNN.py:752-781: RAW hop distances (no
    reciprocal), 1-based node ids map to 0-based matrix rows, padded CCs
    are filled with PAD_VALUE (0, also a legal distance — quirk preserved).
    `shortest_paths` may be the (n, n) all-pairs matrix or a (k, n)
    row subset from shortest_path_rows with cc_ids remapped into 1-based
    row space. With a mesh each rank reads only its column block of it
    (`path_column_block`) and the CC-min runs on the device
    (`shortest_path_similarities_mesh`); the values are mins of integers,
    so the result is the host loop's, bit for bit.
    """
    n_sub, max_n_cc, _ = cc_ids.shape
    n_nodes = shortest_paths.shape[1]
    if mesh is not None:
        return shortest_path_similarities_mesh(
            path_column_block(shortest_paths, mesh), n_nodes, cc_ids, mesh)
    sims = np.full((n_sub, max_n_cc, n_nodes), float(PAD_VALUE),
                   dtype=np.float32)
    for s in range(n_sub):
        for c in range(max_n_cc):
            comp = cc_ids[s, c]
            comp = comp[comp != PAD_VALUE]
            if comp.size:
                sims[s, c, :] = shortest_paths[comp - 1, :].min(axis=0)
    return sims


def path_column_block(shortest_paths: np.ndarray,
                      mesh: MX.Mesh) -> torch.Tensor:
    """This rank's `world_block` of the columns of the (rows, n_nodes) path
    matrix (an array or a memory map: only the block is read), float32 on
    mesh.device."""
    lo, hi = mesh.world_block(shortest_paths.shape[1])
    return torch.as_tensor(np.ascontiguousarray(shortest_paths[:, lo:hi],
                                                dtype=np.float32),
                           device=mesh.device)


def shortest_path_similarities_mesh(block: torch.Tensor, n_nodes: int,
                                    cc_ids: np.ndarray,
                                    mesh: MX.Mesh) -> np.ndarray:
    """compute_shortest_path_similarities on a mesh, from this rank's
    column block (rows, hi - lo) of the path matrix on its device
    (subgnn_tpu/precompute/similarities.py:_shortest_path_similarities_device):
    CC_MIN_CHUNK subgraphs at a time, a loop over the CC length gathers one
    row per (subgraph, CC), PAD masked to inf, and min-accumulates; inf
    (an empty CC) becomes PAD. The (n_sub, C, hi - lo) blocks are then
    gathered to every rank (`all_gather_world`, 4 x n_sub x C x n_nodes
    bytes)."""
    n_sub, max_n_cc, L = cc_ids.shape
    n_rows = block.shape[0]
    dev = block.device
    ids_all = torch.as_tensor(np.asarray(cc_ids, dtype=np.int64), device=dev)
    local = torch.empty(n_sub, max_n_cc, block.shape[1], dtype=torch.float32,
                        device=dev)
    for s in range(0, n_sub, CC_MIN_CHUNK):
        ids = ids_all[s:s + CC_MIN_CHUNK]
        acc = torch.full((ids.shape[0], max_n_cc, block.shape[1]),
                         float("inf"), device=dev)
        for col in (ids.unbind(2) if n_rows else ()):   # no rows: all PAD
            # torch raises on an id out of range where jnp.clip clamps
            rows = block[(col - 1).clamp(0, n_rows - 1)]
            torch.minimum(acc, rows.masked_fill(
                (col == PAD_VALUE)[:, :, None], float("inf")), out=acc)
        local[s:s + CC_MIN_CHUNK] = acc.masked_fill(acc.isinf(),
                                                    float(PAD_VALUE))
    full = MX.all_gather_world(local, n_nodes, mesh, dim=2)
    return full.cpu().numpy()


def compute_structure_similarities(graph: CSRGraph, cc_ids: np.ndarray,
                                   structure_anchors: np.ndarray,
                                   internal: bool,
                                   device: str | torch.device = "cuda",
                                   mesh: Optional[MX.Mesh] = None
                                   ) -> np.ndarray:
    """(n_subgraphs, max_n_cc, n_anchors) float32 DTW similarities between
    every CC and every pooled structure anchor patch (reference:
    SubGNN/SubGNN.py:783-833). Padded CCs are PAD_VALUE (SubGNN.py:831).
    With a mesh each rank takes the degree sequences and the DTW of its
    `world_block` of the n_sub * C comps (precompute/dtw.py:
    dtw_similarity_mesh), and every rank gets them all."""
    n_sub, max_n_cc, L = cc_ids.shape
    comp_flat = cc_ids.reshape(n_sub * max_n_cc, L)
    anchor_seqs, anchor_lens = degree_sequences(graph, structure_anchors,
                                                internal=internal)
    if mesh is None:
        comp_seqs, comp_lens = degree_sequences(graph, comp_flat,
                                                internal=internal)
        sims = dtw_similarity_matrix(comp_seqs, comp_lens, anchor_seqs,
                                     anchor_lens, device=device)
    else:
        lo, hi = mesh.world_block(len(comp_flat))
        comp_seqs, comp_lens = degree_sequences(graph, comp_flat[lo:hi],
                                                internal=internal)
        sims = dtw_similarity_mesh(comp_seqs, comp_lens, anchor_seqs,
                                   anchor_lens, len(comp_flat), mesh,
                                   device=device)
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

def cached(path: Path, compute_fn, recompute: bool = False,
           hit: Optional[bool] = None, save: bool = True) -> np.ndarray:
    """Load a .npy artifact or compute+save it (reference caching pattern,
    SubGNN/SubGNN.py:856-873). `hit`: whether to load, decided by the
    caller (default: the file exists and not `recompute`); `save`: whether
    to write what was computed."""
    path = Path(path)
    if hit is None:
        hit = path.exists() and not recompute
    if hit:
        return np.load(path, allow_pickle=True)
    arr = compute_fn()
    if save:
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
