"""Device idle share of training: 1 - the device's busy time per epoch
(union of its activities over the traced epochs) over the median wall time
of the window's epochs run without the profiler, in %."""
import numpy as np


def read(ctx):
    red = ctx.get("trace")
    traced = ctx.get("traced_epochs") or []
    walls = ctx["clean_walls"]
    if red is None or not traced or red["busy_s"] <= 0 or not walls:
        return None
    return 100.0 * (1.0 - red["busy_s"] / len(traced) / float(np.median(walls)))
