"""Host time to launch one replayed step, us: the program's
`fit.train.launch` and `fit.eval.launch` spans (the copies into the step
graphs' static buffers and the replays) over its `replays` counter, per
epoch; the median over the window's epochs run without the profiler
(harness/fit_spans.py)."""
from benchmark.harness.fit_spans import median, span_ns


def _us(rec, epoch):
    ns = span_ns(rec, epoch, "fit.train.launch", "fit.eval.launch")
    replays = rec.counters[epoch].get("replays", 0)
    return None if ns is None or not replays else ns / replays / 1e3


def read(ctx):
    return median(ctx, _us)
