"""Structure similarities: exact DTW between degree sequences, in PyTorch.

The local cost of two degrees a, b is (max(a, b) + 1) / (min(a, b) + 1) - 1
and a similarity is 1 / (DTW + 1) (SubGNN gamma.py); DTW is the exact
dynamic programme (the published code's fastdtw(radius=1) approximates it;
the configuration states the exact one). A pair with an empty side reads
distance 0. A padded component's similarity reads 0.
"""
from __future__ import annotations

import numpy as np
import torch

PAD = 0


def dtw(a: torch.Tensor, la: torch.Tensor, b: torch.Tensor,
        lb: torch.Tensor) -> torch.Tensor:
    """(P,) float32 exact DTW of P pairs: a (P, Wa), b (P, Wb) zero-padded
    float32, la, lb (P,) lengths. Row by row over a, cell by cell over b,
    vector work over the pairs."""
    P = a.shape[0]
    dev = a.device
    Wa, Wb = int(la.max().item()) if P else 0, int(lb.max().item()) if P else 0
    inf = torch.full((P,), float("inf"), device=dev)
    prev = [torch.zeros(P, device=dev)] + [inf] * Wb
    out = torch.zeros(P, device=dev)
    for i in range(1, Wa + 1):
        ai = a[:, i - 1]
        cur = [inf]
        for j in range(1, Wb + 1):
            bj = b[:, j - 1]
            cost = (torch.maximum(ai, bj) + 1.0) / (torch.minimum(ai, bj)
                                                     + 1.0) - 1.0
            best = torch.minimum(torch.minimum(prev[j], cur[j - 1]),
                                 prev[j - 1])
            cur.append(cost + best)
        done = la == i
        if bool(done.any()):
            last = torch.stack(cur, 1).gather(1, lb.clamp(min=0)[:, None])[:, 0]
            out = torch.where(done, last, out)
        prev = cur
    return torch.where((la == 0) | (lb == 0), torch.zeros_like(out), out)


def structure_sims(comp_seqs, comp_lens, anchor_seqs, anchor_lens,
                   comp_valid: np.ndarray, device,
                   chunk: int = 1 << 20) -> np.ndarray:
    """(n_comp, n_anchor) float32 1/(DTW + 1) of every comp against every
    anchor, rows of invalid (padded) comps set to 0."""
    nc, na = comp_seqs.shape[0], anchor_seqs.shape[0]
    ci = np.repeat(np.arange(nc), na)
    ai = np.tile(np.arange(na), nc)
    keep = np.repeat(comp_valid, na)
    out = np.zeros(nc * na, np.float32)
    sel = np.flatnonzero(keep)
    cs = torch.as_tensor(comp_seqs, dtype=torch.float32, device=device)
    cl = torch.as_tensor(comp_lens, dtype=torch.int64, device=device)
    as_ = torch.as_tensor(anchor_seqs, dtype=torch.float32, device=device)
    al = torch.as_tensor(anchor_lens, dtype=torch.int64, device=device)
    for s in range(0, len(sel), chunk):
        part = sel[s:s + chunk]
        c = torch.as_tensor(ci[part], device=device)
        a = torch.as_tensor(ai[part], device=device)
        d = dtw(cs[c], cl[c], as_[a], al[a])
        out[part] = (1.0 / (d + 1.0)).cpu().numpy()
    return out.reshape(nc, na)


def split_structure_sims(graph, cc: np.ndarray, structure, internal: bool,
                         device) -> np.ndarray:
    """(N, C, n_pool) internal or border structure similarities of a
    component table against the anchor pool's patches that the layers name
    (samplers.Structure); the other columns, never read, are 0."""
    N, C, L = cc.shape
    cseq, clen = graph.degree_sequences(cc.reshape(N * C, L), internal)
    aseq, alen = graph.degree_sequences(structure.patches, internal)
    valid = (cc[:, :, 0] != PAD).reshape(-1)
    out = np.zeros((N, C, structure.n_pool), np.float32)
    out[:, :, structure.sel] = structure_sims(
        cseq, clen, aseq, alen, valid, device).reshape(N, C, -1)
    return out
