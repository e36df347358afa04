"""Device activities (kernels, copies, memsets) per replayed train step,
from the trace: the activities the trace links to each train graph's
replay (the first steps_per_epoch replays of each traced epoch); where the
trace links none, all device activities of the traced epochs over their
train steps."""
import numpy as np

from benchmark.harness.trace import graph_activities


def read(ctx):
    red = ctx.get("trace")
    steps = ctx.get("traced_train_steps")
    if red is None or not steps or not red["activities"]:
        return None
    per = graph_activities(red)
    nb = ctx["steps_per_epoch"]
    n_ep = len(ctx["traced_epochs"])
    if per is not None and len(per) % n_ep == 0:
        k = len(per) // n_ep
        train = [per[e * k + i] for e in range(n_ep) for i in range(nb)]
        return float(np.mean(train))
    return red["activities"] / steps
