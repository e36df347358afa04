"""Frozen copies of SubGNN's seeded anchor samplers, on reference.graph.

The program draws its anchors and structure walks from numpy Generators
seeded with lists of integers (the seed, a stream tag, a split tag, a layer
or patch index). These copies make the same draws in the same order over the
benchmark's own graph, so the anchors that the reference feeds its forward
are the ones the configuration's sampling defines, and the program's can be
held to them exactly. Semantics (from the published sampler,
anchor_patch_samplers.py): neighborhood anchors uniform over a component's
nodes or its border set; internal position anchors uniform over the
subgraph's node list; border position anchors uniform over the graph's
nodes; structure patches triangular random walks over the graph (step to a
triangle-closing neighbour with probability rw_beta), a pool of them
subsampled per layer (only the patches a layer names are drawn here: each
has its own stream); internal walks inside a patch, border walks from the
patch's border nodes over the border and the rest of the graph.
"""
from __future__ import annotations

import numpy as np

PAD = 0
PREDICT_TAG = 3
SPLIT_TAG = {"train": 0, "val": 1, "test": 2}


def _from_rows(rows: np.ndarray, n: int, rng) -> np.ndarray:
    R = rows.shape[0]
    lengths = (rows != PAD).sum(axis=1)
    idx = (rng.random((R, n)) * np.maximum(lengths, 1)[:, None]).astype(
        np.int64)
    out = np.take_along_axis(rows, idx, axis=1)
    out[lengths == 0] = PAD
    return out.astype(np.int64)


def neighborhood(hp, cc, border, seed: int, tag: int):
    """(internal (nl, N, C, A_in), border (nl, N, C, A_out) or None)."""
    N, C, L = cc.shape
    ints, bors = [], []
    for layer in range(hp["n_layers"]):
        rng = np.random.default_rng([seed, 311, tag, layer])
        ints.append(_from_rows(cc.reshape(N * C, L),
                               hp["n_anchor_patches_N_in"], rng)
                    .reshape(N, C, -1))
        if border is not None:
            rng = np.random.default_rng([seed, 313, tag, layer])
            bors.append(_from_rows(border.reshape(N * C, -1),
                                   hp["n_anchor_patches_N_out"], rng)
                        .reshape(N, C, -1))
    return np.stack(ints), (np.stack(bors) if bors else None)


def position_internal(hp, lists, seed: int, tag: int) -> np.ndarray:
    out = np.zeros((hp["n_layers"], len(lists), hp["n_anchor_patches_pos_in"]),
                   np.int64)
    for layer in range(hp["n_layers"]):
        rng = np.random.default_rng([seed, 331, tag, layer])
        for i, sg in enumerate(lists):
            out[layer, i] = rng.choice(np.asarray(sg, np.int32),
                                       hp["n_anchor_patches_pos_in"],
                                       replace=True)
    return out


def position_border(hp, graph, seed: int) -> np.ndarray:
    nodes = graph.node_ids().astype(np.int32)
    out = np.zeros((hp["n_layers"], hp["n_anchor_patches_pos_out"]), np.int64)
    for layer in range(hp["n_layers"]):
        rng = np.random.default_rng([seed, 337, layer])
        out[layer] = rng.choice(nodes, hp["n_anchor_patches_pos_out"],
                                replace=True)
    return out


def structure_indices(hp, seed: int) -> np.ndarray:
    """(nl, A_S) pool indices of each layer's structure anchors."""
    n_pool = hp["max_sim_epochs"] * hp["n_anchor_patches_structure"] * \
        hp["n_layers"]
    return np.stack([np.random.default_rng([seed, 341, layer]).integers(
        0, n_pool, hp["n_anchor_patches_structure"])
        for layer in range(hp["n_layers"])])


# ------------------------------------------------------------------- walks

def _restricted(graph, v: int, member):
    nb = graph.neighbors(v)
    return nb if member is None else nb[member[nb]]


def _walk(graph, rng, walk_len: int, beta: float, starts, member=None,
          border_member=None) -> list:
    restrict = border_member if border_member is not None else member
    prev = int(rng.choice(starts))
    nb = _restricted(graph, prev, restrict)
    if nb.size == 0:
        return [prev]
    curr = int(rng.choice(nb))
    out = [prev, curr]
    for _ in range(walk_len - 2):
        nb = _restricted(graph, curr, restrict)
        if nb.size == 0:
            break
        tri_mask = np.isin(nb, _restricted(graph, prev, restrict))
        tri, non = nb[tri_mask], nb[~tri_mask]
        if tri.size == 0:
            nxt = int(rng.choice(non))
        elif non.size == 0:
            nxt = int(rng.choice(tri))
        elif rng.uniform() <= beta:
            nxt = int(rng.choice(tri))
        else:
            nxt = int(rng.choice(non))
        prev, curr = curr, nxt
        out.append(nxt)
    return out


def structure_patches(graph, hp, seed: int, ids: np.ndarray) -> np.ndarray:
    """(len(ids), longest) of the pool's patches `ids`, PAD 0: each a
    triangular walk of sample_walk_len over the graph from its own stream
    (the pool's other patches are never read)."""
    nodes = graph.node_ids().astype(np.int32)
    patches = [_walk(graph, np.random.default_rng([seed, 101, int(i)]),
                     hp["sample_walk_len"], hp["rw_beta"], nodes)
               for i in ids]
    out = np.zeros((len(ids), max(len(p) for p in patches)), np.int64)
    for i, p in enumerate(patches):
        out[i, :len(p)] = p
    return out


def _border_nodes(graph, patch):
    nodes = np.asarray(sorted({int(v) for v in patch}), np.int64)
    member = np.zeros(graph.n + 1, bool)
    member[nodes] = True
    in_border = [int(v) for v in nodes
                 if (~member[graph.neighbors(int(v))]).any()]
    all_ids = graph.node_ids()
    return (np.asarray(in_border, np.int32),
            all_ids[~member[all_ids]].astype(np.int32))


def patch_walks(graph, hp, patches, ids, inside: bool,
                seed: int) -> np.ndarray:
    """(len(ids), W, L) walks over the pool's patches `ids` (rows of
    `patches`), PAD 0."""
    W, L = hp["n_triangular_walks"], hp["random_walk_len"]
    out = np.zeros((len(ids), W, L), np.int64)
    for r, p in enumerate(ids):
        patch = patches[r][patches[r] != PAD]
        if patch.size == 0:
            continue
        if inside:
            member = np.zeros(graph.n + 1, bool)
            member[patch] = True
            starts, border_member = patch.astype(np.int32), None
        else:
            in_border, external = _border_nodes(graph, patch.tolist())
            if in_border.size == 0:
                continue
            border_member = np.zeros(graph.n + 1, bool)
            border_member[in_border] = True
            border_member[external] = True
            member, starts = None, in_border
        for w in range(W):
            rng = np.random.default_rng([seed, 211 if inside else 223,
                                         int(p), w])
            walk = _walk(graph, rng, L, hp["rw_beta"], starts, member,
                         border_member)
            out[r, w, :len(walk)] = walk[:L]
    return out


class Structure:
    """The structure channel's anchors: each layer's pool indices, the
    patches they name (`sel`, ascending, and their rows `patches`), and
    the layers' internal and border walks (nl, A_S, W, L)."""

    def __init__(self, graph, hp, seed: int):
        self.n_pool = hp["max_sim_epochs"] * \
            hp["n_anchor_patches_structure"] * hp["n_layers"]
        self.idx = structure_indices(hp, seed)
        self.sel = np.unique(self.idx)
        self.patches = structure_patches(graph, hp, seed, self.sel)
        rows = np.searchsorted(self.sel, self.idx)
        self.int_walks = patch_walks(graph, hp, self.patches, self.sel, True,
                                     seed)[rows]
        self.bor_walks = patch_walks(graph, hp, self.patches, self.sel,
                                     False, seed)[rows]

    def anchors(self) -> dict:
        return {"struc_pool_idx": self.idx, "struc_int_walks": self.int_walks,
                "struc_bor_walks": self.bor_walks}
