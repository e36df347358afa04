"""Padded array dataset for subgraph batches.

The reference pads connected-component id tensors to global maxima and trims
per batch (reference: SubGNN/SubGNN.py:575-607, 1068-1114). Here we keep
the GLOBAL static shapes everywhere — per-batch trimming would trigger one
XLA recompilation per distinct trimmed shape, and padding is mathematically
inert (pad id 0 embeds to a zero row, and every reduction is masked).

A numpy copy of subgnn_tpu/data/dataset.py.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from .graph import CSRGraph
from .subgraphs import MultiLabelBinarizer

PAD_VALUE = 0


def initialize_cc_ids(graph: CSRGraph, subgraphs: List[List[int]],
                      max_n_cc: int | None = None,
                      max_len_cc: int | None = None) -> np.ndarray:
    """(n_subgraphs, max_n_cc, max_len_cc) int32 of 1-based node ids, PAD=0.

    Connected components of each subgraph's induced graph
    (reference: SubGNN/SubGNN.py:575-607).
    """
    if not subgraphs:
        raise ValueError("no subgraphs given (empty node-list file or "
                         "empty split)")
    cc_lists = [graph.connected_components(sg) for sg in subgraphs]
    got_cc = max(len(ccs) for ccs in cc_lists)
    got_len = max((len(cc) for ccs in cc_lists for cc in ccs), default=1)
    if max_n_cc is None:
        max_n_cc = got_cc
    elif got_cc > max_n_cc:
        # pinned serving shapes (runner.predict) must reject oversized
        # inputs with a clear message, not a numpy IndexError mid-pad
        raise ValueError(
            f"a subgraph has {got_cc} connected components > the pinned "
            f"max_n_cc={max_n_cc}; raise the pin (costs a retrace) or "
            "split the input")
    if max_len_cc is None:
        max_len_cc = got_len
    elif got_len > max_len_cc:
        raise ValueError(
            f"a connected component has {got_len} nodes > the pinned "
            f"max_len_cc={max_len_cc}; raise the pin (costs a retrace)")
    out = np.full((len(subgraphs), max_n_cc, max_len_cc), PAD_VALUE, dtype=np.int32)
    for s, ccs in enumerate(cc_lists):
        for c, cc in enumerate(ccs):
            out[s, c, :len(cc)] = cc
    return out


def pad_node_lists(lists: List[List[int]], max_len: int | None = None) -> np.ndarray:
    """(n, max_len) int32, PAD=0."""
    if max_len is None:
        max_len = max((len(l) for l in lists), default=1)
    out = np.full((len(lists), max_len), PAD_VALUE, dtype=np.int32)
    for i, l in enumerate(lists):
        out[i, :len(l)] = l
    return out


@dataclasses.dataclass
class SubgraphData:
    """One split's arrays: ids, labels, CCs, border sets, similarities.

    Mirrors the per-example contents of the reference SubgraphDataset
    (reference: SubGNN/datasets.py:9-57) as whole-split arrays.
    """

    subgraph_ids: np.ndarray                  # (N, max_sg_len) int32
    cc_ids: np.ndarray                        # (N, C, L) int32
    labels: np.ndarray                        # (N,) int64 or (N, n_classes) int32
    N_border: Optional[np.ndarray] = None     # (N, C, B) int32
    NP_sim: Optional[np.ndarray] = None       # (N, C, n_nodes) float32
    I_S_sim: Optional[np.ndarray] = None      # (N, C, n_struct_anchors) float32
    B_S_sim: Optional[np.ndarray] = None      # (N, C, n_struct_anchors) float32
    multilabel: bool = False

    @classmethod
    def build(cls, graph: CSRGraph, subgraphs: List[List[int]], labels,
              multilabel: bool,
              binarizer: Optional[MultiLabelBinarizer] = None,
              max_n_cc: int | None = None,
              max_len_cc: int | None = None) -> "SubgraphData":
        cc_ids = initialize_cc_ids(graph, subgraphs, max_n_cc, max_len_cc)
        if multilabel:
            lab = binarizer.transform(labels)
        else:
            lab = np.asarray(labels, dtype=np.int64)
        return cls(subgraph_ids=pad_node_lists(subgraphs), cc_ids=cc_ids,
                   labels=lab, multilabel=multilabel)

    def __len__(self) -> int:
        return self.cc_ids.shape[0]

    def subset(self, idx: np.ndarray) -> "SubgraphData":
        """New SubgraphData restricted to rows `idx` (train-holdout carving
        for nested model selection; see runner.SubGNNPipeline
        train_holdout)."""
        take = (lambda a: None if a is None else a[idx])
        return SubgraphData(
            subgraph_ids=self.subgraph_ids[idx], cc_ids=self.cc_ids[idx],
            labels=self.labels[idx], N_border=take(self.N_border),
            NP_sim=take(self.NP_sim), I_S_sim=take(self.I_S_sim),
            B_S_sim=take(self.B_S_sim), multilabel=self.multilabel)

    def batches(self, batch_size: int, *, shuffle: bool, drop_last: bool,
                rng: Optional[np.random.Generator] = None,
                include_np_sim: bool = True):
        """Yield dict batches of numpy arrays with STATIC shapes.

        Like the reference loaders (reference: SubGNN/SubGNN.py:1116-1151):
        train shuffles and drops the last short batch when batch_size <= N;
        eval keeps order. Short eval batches are padded to batch_size and a
        'valid' mask marks real rows (the reference instead emits a ragged
        final batch — padding + masking is the static-shape equivalent).
        """
        n = len(self)
        order = np.arange(n)
        if shuffle:
            (rng or np.random.default_rng()).shuffle(order)
        step = batch_size
        for start in range(0, n, step):
            idx = order[start:start + step]
            if len(idx) < batch_size:
                if drop_last:
                    break
                pad = np.zeros(batch_size - len(idx), dtype=idx.dtype)
                valid = np.concatenate([np.ones(len(idx), bool),
                                        np.zeros(batch_size - len(idx), bool)])
                idx = np.concatenate([idx, pad])
            else:
                valid = np.ones(batch_size, bool)
            batch = {
                "subgraph_ids": self.subgraph_ids[idx],
                "cc_ids": self.cc_ids[idx],
                "subgraph_idx": idx.astype(np.int32),
                "label": self.labels[idx],
                "valid": valid,
            }
            for name in ("NP_sim", "I_S_sim", "B_S_sim"):
                arr = getattr(self, name)
                if name == "NP_sim" and not include_np_sim:
                    # compact-sims mode (train/sims.py): anchor columns are
                    # host-gathered instead of slicing the full tensor
                    batch[name] = None
                    continue
                batch[name] = arr[idx] if arr is not None else None
            yield batch
