"""Mean wall time of a request's structure sims (host degree sequences and
one DTW launch; timings["structure_sims"]), in ms, over the window's
requests."""


def read(ctx):
    v = [t["structure_sims"] for t in ctx["timings"] if "structure_sims" in t]
    return 1e3 * sum(v) / len(v) if v else None
