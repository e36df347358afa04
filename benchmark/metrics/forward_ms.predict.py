"""Mean wall time of a request's forward pass (timings["forward"]), in ms,
over the window's requests."""


def read(ctx):
    v = [t["forward"] for t in ctx["timings"] if "forward" in t]
    return 1e3 * sum(v) / len(v) if v else None
