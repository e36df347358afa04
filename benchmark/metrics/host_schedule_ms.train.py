"""Host schedule of training, ms per epoch: the program's `fit.schedule`
spans, the next epoch's order, stacked gather plans (epoch_plans), compact
NP sims (epoch_compact_sims) and their pinned copies to the device
(_FusedRun.schedule); the median over the window's epochs run without the
profiler (harness/fit_spans.py)."""
from benchmark.harness.fit_spans import median, span_ns


def _ms(rec, epoch):
    ns = span_ns(rec, epoch, "fit.schedule")
    return None if ns is None else ns / 1e6


def read(ctx):
    return median(ctx, _ms)
