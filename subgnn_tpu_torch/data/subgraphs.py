"""Subgraph TSV parsing and label binarization.

File format (reference: SubGNN/subgraph_utils.py:24-92): one subgraph per
line, tab-separated:  "n1-n2-...-nk\tLABEL[-LABEL2...]\ttrain|val|test".
Multi-label datasets join several labels with '-'. Node ids in the file are
0-based; callers re-index to 1-based (+1) for padding with 0.

A numpy copy of subgnn_tpu/data/subgraphs.py.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np


class MultiLabelBinarizer:
    """Minimal sklearn-compatible multi-label binarizer (reference uses
    sklearn.preprocessing.MultiLabelBinarizer at SubGNN/SubGNN.py:536)."""

    def __init__(self):
        self.classes_: np.ndarray | None = None

    def fit(self, label_lists) -> "MultiLabelBinarizer":
        classes = sorted({l for labels in label_lists for l in labels})
        self.classes_ = np.asarray(classes)
        return self

    def transform(self, label_lists) -> np.ndarray:
        index = {c: i for i, c in enumerate(self.classes_.tolist())}
        out = np.zeros((len(label_lists), len(self.classes_)), dtype=np.int32)
        for i, labels in enumerate(label_lists):
            for l in labels:
                out[i, index[l]] = 1
        return out


def read_subgraphs(path: str | Path):
    """Parse the subgraph TSV.

    Returns (train_sub_G, train_labels, val_sub_G, val_labels,
             test_sub_G, test_labels, multilabel).

    Faithful to reference SubGNN/subgraph_utils.py:24-92 including:
      * label ids assigned by first appearance in file order (:67-69),
      * the val/test swap when the val split is smaller than test (:89-90),
      * single-label datasets return int arrays; multilabel return lists of
        label-id lists.
    """
    label_idx = 0
    labels: Dict[str, int] = {}
    splits: Dict[str, Tuple[List[List[int]], List[List[int]]]] = {
        "train": ([], []), "val": ([], []), "test": ([], []),
    }
    multilabel = False

    with open(path) as fin:
        for lineno, line in enumerate(fin, 1):
            if not line.strip():
                continue  # tolerate blank/whitespace lines (hand edits)
            cols = line.split("\t")
            if len(cols) < 3:
                # same hand-edit class as blank lines, but a short row is
                # ambiguous (missing label or split?) — fail loudly with
                # context instead of a raw IndexError
                raise ValueError(
                    f"{path}:{lineno}: expected 'nodes\\tlabel\\tsplit' "
                    f"(3 tab-separated columns), got {len(cols)}")
            nodes = [int(n) for n in cols[0].split("-") if n.strip() != ""]
            if not nodes:
                continue
            labs = cols[1].split("-")
            if len(labs) > 1:
                multilabel = True
            for lab in labs:
                if lab not in labels:
                    labels[lab] = label_idx
                    label_idx += 1
            split = cols[2].strip()
            if split in splits:
                splits[split][0].append(nodes)
                splits[split][1].append([labels[lab] for lab in labs])

    train_G, train_L = splits["train"]
    val_G, val_L = splits["val"]
    test_G, test_L = splits["test"]

    if not multilabel:
        train_L = np.asarray([l[0] for l in train_L], dtype=np.int64)
        val_L = np.asarray([l[0] for l in val_L], dtype=np.int64)
        test_L = np.asarray([l[0] for l in test_L], dtype=np.int64)

    # quirk preserved: swap val/test if val is the smaller split
    # (reference: SubGNN/subgraph_utils.py:89-90)
    if len(val_G) < len(test_G):
        val_G, val_L, test_G, test_L = test_G, test_L, val_G, val_L

    return train_G, train_L, val_G, val_L, test_G, test_L, multilabel


def reindex_subgraphs(subgraphs: List[List[int]]) -> List[List[int]]:
    """Shift node ids +1 so 0 becomes the padding id
    (reference: SubGNN/SubGNN.py:509-517)."""
    return [[n + 1 for n in sg] for sg in subgraphs]
