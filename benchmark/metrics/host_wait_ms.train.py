"""The device as the host sees it, ms per epoch: the program's
`fit.train.wait` and `fit.eval.wait` spans, where the host is blocked
reading the train losses and the val losses and logits off the card; the
median over the window's epochs run without the profiler
(harness/fit_spans.py)."""
from benchmark.harness.fit_spans import median, span_ns


def _ms(rec, epoch):
    ns = span_ns(rec, epoch, "fit.train.wait", "fit.eval.wait")
    return None if ns is None else ns / 1e6


def read(ctx):
    return median(ctx, _ms)
