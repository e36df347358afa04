"""Share of its roofline the DTW kernel (csrc/dtw.cu, kernels named dtw_)
reaches in serving, in %: the least time of the traced requests' launches
(harness/bounds.py:dtw_bound_s, DP cells from the requests' component
sizes and the anchor pool's patch lengths), over the kernel's device time
in the trace."""
import numpy as np

from benchmark.harness.bounds import dtw_bound_s
from benchmark.harness.trace import device_time


def read(ctx):
    red = ctx.get("trace")
    if red is None or ctx.get("pool") is None:
        return None
    seconds, n = device_time(red, "dtw_")
    if n == 0 or seconds <= 0:
        return None
    R = ctx["reference"]
    anchor_lens = (np.asarray(ctx["pool"]) != 0).sum(axis=1)
    bound = 0.0
    for req in ctx["traced"]:
        cc = R.g.cc_table(req)
        bound += dtw_bound_s((cc != 0).sum(axis=2).ravel(), anchor_lens)
    return 100.0 * bound / seconds
