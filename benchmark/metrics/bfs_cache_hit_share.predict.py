"""Share of a request's BFS sources served from the pipeline's row cache,
1 - sum(bfs_cache_miss) / sum(bfs_srcs) over the window's requests, in %."""


def read(ctx):
    srcs = sum(t.get("bfs_srcs", 0) for t in ctx["timings"])
    if not srcs:
        return None
    miss = sum(t.get("bfs_cache_miss", 0) for t in ctx["timings"])
    return 100.0 * (1.0 - miss / srcs)
