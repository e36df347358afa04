"""Classification metrics in pure NumPy (no sklearn dependency).

A numpy copy of subgnn_tpu/train/metrics.py (the port imports nothing from
the JAX package). Mirrors the reference's metric surface (reference:
SubGNN/subgraph_utils.py:94-124 for F1/accuracy, SubGNN/SubGNN.py:408-504
for AUROC incl. per-class):
  * multiclass: argmax predictions; micro/macro F1; accuracy; OVR AUROC on
    softmax probabilities (binary case uses the positive-class column).
  * multilabel: sigmoid > 0.5 predictions; micro/macro F1; subset accuracy;
    macro AUROC over label columns on sigmoid probabilities.
"""
from __future__ import annotations

import numpy as np


def _sigmoid(x):
    # numerically stable split form: exp only ever sees non-positive
    # arguments, so large |logits| cannot overflow (same values as the
    # naive form where that doesn't overflow)
    x = np.atleast_1d(np.asarray(x, dtype=np.float64))
    out = np.empty_like(x)
    pos = x >= 0
    out[pos] = 1.0 / (1.0 + np.exp(-x[pos]))
    ex = np.exp(x[~pos])
    out[~pos] = ex / (1.0 + ex)
    return out


def _softmax(x):
    z = x - x.max(axis=-1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=-1, keepdims=True)


def _f1_counts(tp, fp, fn):
    denom = 2 * tp + fp + fn
    return np.where(denom > 0, 2 * tp / np.maximum(denom, 1), 0.0)


def calc_f1(logits, labels, avg_type: str = "macro",
            multilabel: bool = False, n_classes: int | None = None) -> float:
    logits = np.asarray(logits)
    labels = np.asarray(labels)
    if multilabel:
        pred = (_sigmoid(logits) > 0.5).astype(np.int64)
        true = labels.astype(np.int64)
        tp = (pred & true).sum(axis=0).astype(np.float64)
        fp = (pred & ~true.astype(bool)).sum(axis=0).astype(np.float64)
        fn = (~pred.astype(bool) & true.astype(bool)).sum(axis=0).astype(np.float64)
    else:
        C = n_classes or logits.shape[-1]
        pred = logits.argmax(axis=-1)
        tp = np.zeros(C)
        fp = np.zeros(C)
        fn = np.zeros(C)
        for c in range(C):
            tp[c] = ((pred == c) & (labels == c)).sum()
            fp[c] = ((pred == c) & (labels != c)).sum()
            fn[c] = ((pred != c) & (labels == c)).sum()
    if avg_type == "micro":
        return float(_f1_counts(tp.sum(), fp.sum(), fn.sum()))
    elif avg_type == "macro":
        return float(_f1_counts(tp, fp, fn).mean())
    raise NotImplementedError(avg_type)


def calc_accuracy(logits, labels, multilabel: bool = False) -> float:
    logits = np.asarray(logits)
    labels = np.asarray(labels)
    if multilabel:
        pred = (_sigmoid(logits) > 0.5).astype(np.int64)
        return float((pred == labels).all(axis=1).mean())  # subset accuracy
    return float((logits.argmax(axis=-1) == labels).mean())


def _mean_defined(vals) -> float:
    """Mean over the non-nan entries (nan = class absent from the split);
    nan when every class is degenerate — nanmean's semantics without its
    mean-of-empty-slice RuntimeWarning."""
    finite = [v for v in vals if not np.isnan(v)]
    return float(np.mean(finite)) if finite else float("nan")


def binary_auc(y_true, y_score) -> float:
    """Rank-based (Mann-Whitney) ROC AUC with tie handling."""
    y_true = np.asarray(y_true).astype(bool)
    y_score = np.asarray(y_score, dtype=np.float64)
    n_pos = int(y_true.sum())
    n_neg = len(y_true) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(y_score, kind="mergesort")
    sorted_scores = y_score[order]
    # average ranks for ties: a run of equal scores starting at 0-based
    # position i with s members gets (i + 1) + (s - 1) / 2
    starts = np.ones(len(sorted_scores), dtype=bool)
    starts[1:] = sorted_scores[1:] != sorted_scores[:-1]
    first = np.flatnonzero(starts)
    sizes = np.diff(np.append(first, len(sorted_scores)))
    ranks = np.empty(len(y_score), dtype=np.float64)
    ranks[order] = np.repeat((first + 1) + (sizes - 1) / 2.0, sizes)
    rank_sum = ranks[y_true].sum()
    return float((rank_sum - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def roc_auc_ovr(logits, labels, multilabel: bool = False):
    """(overall_auc, per_class_auc list).

    Multiclass: softmax probs, macro-average of per-class one-vs-rest AUCs;
    binary special-case uses the positive column
    (reference: SubGNN/SubGNN.py:425-446). Multilabel: sigmoid probs, macro
    over label columns. Per-class values mirror the reference's
    val_auroc_class_<c> logging; note its per-class multiclass AUCs use raw
    logits as scores (SubGNN.py:446) — AUC is rank-based so logits and
    softmax give identical values for the binary sub-problem only when
    classes are scored monotonically; we use the same raw-logit convention.
    Classes without both positives and negatives yield nan and are excluded
    from the macro average.
    """
    logits = np.asarray(logits)
    labels = np.asarray(labels)
    C = logits.shape[-1]
    if multilabel:
        probs = _sigmoid(logits)
        per_class = [binary_auc(labels[:, c], probs[:, c]) for c in range(C)]
        overall = _mean_defined(per_class)
        return overall, per_class
    probs = _softmax(logits)
    n_unique = len(np.unique(labels))
    if n_unique == 2 and C == 2:
        overall = binary_auc(labels == 1, probs[:, 1])
    else:
        aucs = [binary_auc(labels == c, probs[:, c]) for c in range(C)]
        overall = _mean_defined(aucs)
    per_class = [binary_auc(labels == c, logits[:, c]) for c in range(C)]
    return overall, per_class
