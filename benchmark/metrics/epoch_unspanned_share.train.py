"""A check on the program's spans, in %: the share of each `fit.epoch` span
that no innermost span covers (its self time and that of every span with
children); the median over the window's epochs run without the profiler
(harness/fit_spans.py)."""
from benchmark.harness.fit_spans import median, span_ns


def _share(rec, epoch):
    ns = span_ns(rec, epoch, "fit.epoch")
    return None if not ns else 100.0 * rec.unspanned_ns(epoch) / ns


def read(ctx):
    return median(ctx, _share)
