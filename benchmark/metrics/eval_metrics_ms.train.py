"""Eval host metrics, ms per epoch: the program's `fit.eval.metrics` span,
the per-batch accuracy and macro-F1 and the trainer's metrics (AUROC,
train/metrics.py) over the val logits; the median over the window's epochs
run without the profiler (harness/fit_spans.py)."""
from benchmark.harness.fit_spans import median, span_ns


def _ms(rec, epoch):
    ns = span_ns(rec, epoch, "fit.eval.metrics")
    return None if ns is None else ns / 1e6


def read(ctx):
    return median(ctx, _ms)
