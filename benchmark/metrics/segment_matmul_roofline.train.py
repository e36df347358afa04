"""Share of its roofline the table-gradient kernel (csrc/segment_matmul.cu,
kernels named segment_rows) reaches in training, in %: the least time of
the traced train steps' table gradients by bytes (each non-pad gathered id
and its cotangent row read once, the table's gradient written once,
harness/bounds.py:segment_bytes, from the steps' ids), over the kernel's
device time in the trace."""
from benchmark.harness.bounds import PEAK_HBM_BYTES
from benchmark.harness.trace import device_time


def read(ctx):
    red = ctx.get("trace")
    if red is None or not ctx.get("segment_bytes"):
        return None
    seconds, n = device_time(red, "segment_rows")
    if n == 0 or seconds <= 0:
        return None
    return 100.0 * ctx["segment_bytes"] / PEAK_HBM_BYTES / seconds
