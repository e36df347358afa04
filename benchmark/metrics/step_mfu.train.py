"""Model FLOP utilisation of training: the forward and backward FLOPs of
every train step and the forward FLOPs of every validation step of the
window's epochs run without the profiler (harness/flops.py, from shapes),
over their wall time, over the card's published float32 peak
(67 TFLOP/s), in %."""
from benchmark.harness.bounds import PEAK_FP32_FLOPS
from benchmark.harness.flops import model_flops


def read(ctx):
    walls = ctx["clean_walls"]
    if not walls:
        return None
    hp, k = ctx["hp"], ctx["n_classes"]
    per_epoch = ctx["steps_per_epoch"] * model_flops(
        hp, ctx["batch"], ctx["max_cc"], k, backward=True)
    B, n_val = ctx["batch"], ctx["n_val"]
    per_epoch += sum(model_flops(hp, min(B, n_val - s), ctx["val_max_cc"], k,
                                 backward=False) for s in range(0, n_val, B))
    return 100.0 * per_epoch * len(walls) / sum(walls) / PEAK_FP32_FLOPS
