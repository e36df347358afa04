"""Structure-channel DTW similarities on the device.

Port of subgnn_tpu/precompute/dtw.py. The local cost is the reference's
ratio distance d(a, b) = (max(a,b)+1)/(min(a,b)+1) - 1 (gamma.py:51-52) and
the similarity is 1/(DTW+1) (gamma.py:54-59). DTW is EXACT, as in the JAX
package (fastdtw(radius=1) in the reference is an approximation).

Every (comp, anchor) pair runs in ONE launch of the grouped kernel
(ops/dtw.py); the JAX version reached the same pairs through a chunked
lax.scan with gathered (pairs, L) copies. On a mesh
(`dtw_similarity_mesh`) each rank launches it once on its block of comps.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.dtw import dtw_distance_grouped
from ..parallel import mesh as MX


def _put(x: np.ndarray, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                           device=device)


def dtw_similarity_grouped(comp_seqs: np.ndarray, comp_lens: np.ndarray,
                           anchor_seqs: np.ndarray, anchor_lens: np.ndarray,
                           device: str | torch.device = "cuda") -> np.ndarray:
    """(G, n_comp, n_anchor) float32 of 1/(DTW+1) for G independent
    same-shaped products in one kernel launch. comp_seqs (G, nc, Lc);
    anchor_seqs (G, na, La)."""
    G, nc, Lc = comp_seqs.shape
    _, na, La = anchor_seqs.shape
    d = dtw_distance_grouped(
        _put(comp_seqs.reshape(G * nc, Lc), torch.float32, device),
        _put(comp_lens.reshape(G * nc), torch.int32, device),
        _put(anchor_seqs.reshape(G * na, La), torch.float32, device),
        _put(anchor_lens.reshape(G * na), torch.int32, device), G, nc, na)
    out = d.cpu().numpy()
    return (1.0 / (out + 1.0)).reshape(G, nc, na)


def dtw_similarity_matrix(comp_seqs: np.ndarray, comp_lens: np.ndarray,
                          anchor_seqs: np.ndarray, anchor_lens: np.ndarray,
                          device: str | torch.device = "cuda") -> np.ndarray:
    """(n_comp, n_anchor) float32 of 1/(DTW+1) similarities, single device
    (the G = 1 case of dtw_similarity_grouped)."""
    return dtw_similarity_grouped(comp_seqs[None], comp_lens[None],
                                  anchor_seqs[None], anchor_lens[None],
                                  device=device)[0]


def dtw_similarity_mesh(comp_seqs: np.ndarray, comp_lens: np.ndarray,
                        anchor_seqs: np.ndarray, anchor_lens: np.ndarray,
                        n_comps: int, mesh: MX.Mesh,
                        device: str | torch.device = "cuda") -> np.ndarray:
    """(n_comps, n_anchor) float32 of 1/(DTW+1) on every rank of `mesh`,
    each rank computing the pairs of its `world_block(n_comps)` of the comps
    (subgnn_tpu/precompute/dtw.py:dtw_similarity_matrix's mesh branch: the
    pairs are comp-major, so a block of comps is a block of pairs).

    comp_seqs / comp_lens: this rank's block, padded to the global comp
    width; anchor_seqs: every anchor at the global width, so that each rank's
    launch takes the path one launch over all comps takes. One launch of
    the grouped kernel (G = 1) a rank with comps, none for an empty block;
    every rank joins the gather of the distances (`all_gather_world`, 4 x
    n_comps x n_anchor bytes)."""
    lo, hi = mesh.world_block(n_comps)
    nc, na = hi - lo, anchor_seqs.shape[0]
    if comp_seqs.shape[0] != nc:
        raise ValueError(f"rank {mesh.rank} takes comps [{lo}, {hi}) of "
                         f"{n_comps}, got {comp_seqs.shape[0]}")
    if nc:
        d = dtw_distance_grouped(
            _put(comp_seqs, torch.float32, device),
            _put(comp_lens, torch.int32, device),
            _put(anchor_seqs, torch.float32, device),
            _put(anchor_lens, torch.int32, device), 1, nc, na).view(nc, na)
    else:
        d = torch.zeros(0, na, dtype=torch.float32, device=device)
    out = MX.all_gather_world(d, n_comps, mesh).cpu().numpy()
    return 1.0 / (out + 1.0)


def dtw_host(a, b) -> float:
    """Exact-DTW host oracle (classic O(nm) DP) for tests."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if len(a) == 0 or len(b) == 0:
        return 0.0
    n, m = len(a), len(b)
    D = np.full((n + 1, m + 1), np.inf)
    D[0, 0] = 0.0
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            c = (max(a[i - 1], b[j - 1]) + 1.0) / (min(a[i - 1], b[j - 1]) + 1.0) - 1.0
            D[i, j] = c + min(D[i - 1, j], D[i, j - 1], D[i - 1, j - 1])
    return float(D[n, m])
