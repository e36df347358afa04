"""Mean host wall time of a request's BFS rows, NP sims and border sets
(timings["bfs_rows_wall"] of SubGNNPipeline.predict), in ms, over the
window's requests. Requests without a BFS (no N or P channel) give
nothing."""


def read(ctx):
    v = [t["bfs_rows_wall"] for t in ctx["timings"] if "bfs_rows_wall" in t]
    return 1e3 * sum(v) / len(v) if v else None
