"""Model FLOP utilisation of serving: the forward FLOPs of every request of
the window (harness/flops.py, over the request's subgraphs and its largest
component count, in batches of batch_size), over the window, over the
card's published float32 peak (67 TFLOP/s), in %."""
from benchmark.harness.bounds import PEAK_FP32_FLOPS
from benchmark.harness.flops import model_flops


def read(ctx):
    hp, k = ctx["hp"], ctx["n_classes"]
    R = ctx["reference"]
    B = hp["batch_size"]
    total = 0
    for req in ctx["served"]:
        C = max(len(R.g.components(sg)) for sg in req)
        for s in range(0, len(req), B):
            total += model_flops(hp, min(B, len(req) - s), C, k,
                                 backward=False)
    return 100.0 * total / ctx["window_s"] / PEAK_FP32_FLOPS
