"""The serving cells: SubGNNPipeline.predict of subgnn_tpu_torch, one client
in a closed loop.

Set-up makes the base graph from the seed, runs the program's structure
precompute in memory (the anchor pool and its walks, which serving reads),
fills the weights and hands the pipeline the graph and pool. Warm-up sends
requests until the BFS row cache is full (and at least `warmup_requests`),
as a server at steady state has it. The window then sends requests one
after another, each waiting for its reply; the client draws its next
request between replies, outside the window's clock, so the window is the
time the pipeline served. A request holds novel node lists: its number of
subgraphs cycles through stratified log-uniform sizes, each cycle in an
order drawn from the seed, and its subgraphs grow from uniformly drawn start
nodes. With `--trace 1`, `trace_requests` more requests after the window
run under torch.profiler.

After the window the reference recomputes, from the graph, the seed and the
weights alone, a sample of the window's requests drawn from the seed, the
one with the most subgraphs among them, and compares the logits.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Iterator, List

import numpy as np
import torch

from .data import Grower, csr, make_graph, request_sizes, subgraph_shapes
from .common import read_per_layer
from .trace import Trace
from .weights import program_params


def requests(cfg: Dict, traffic: Dict, seed: int, stream: int, indptr,
             indices) -> Iterator[List[List[int]]]:
    """Endless requests (see the module docstring); `stream` tells
    warm-up's apart from the window's."""
    ds = cfg["dataset"]
    sizes = request_sizes(traffic)
    shapes = subgraph_shapes(ds, int(ds["n_subgraphs"]))
    rng = np.random.default_rng([seed, 3, stream])
    shape_order = rng.permutation(len(shapes))
    grower = Grower(indptr, indices, int(ds["n_nodes"]), rng)
    j = 0
    while True:
        for k in rng.permutation(sizes):
            req = []
            for _ in range(int(k)):
                s, c = shapes[shape_order[j % len(shapes)]]
                j += 1
                req.append(grower.subgraph(int(s), int(c)))
            yield req


def run(cell, args, dev: torch.device, t_process: float) -> Dict[str, Any]:
    from subgnn_tpu_torch.config import HParams, RunConfig
    from subgnn_tpu_torch.data.graph import CSRGraph
    from subgnn_tpu_torch.sampling.walks import (
        perform_random_walks, sample_structure_anchor_patches)
    from subgnn_tpu_torch.train.runner import SubGNNPipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seed = int(args.seed) % (1 << 62)
    cfg, traffic = cell.config, cell.traffic
    ds = cfg["dataset"]
    n = int(ds["n_nodes"])
    hp = HParams.from_dict(dict(cfg["hparams"], seed=seed))
    n_cls = int(ds["n_classes"])
    t0 = time.perf_counter()
    edges = make_graph(ds)
    indptr, indices = csr(edges, n)
    stages = {"data_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    graph = CSRGraph.from_edges(edges, n_nodes=n)
    pipe = SubGNNPipeline(RunConfig(), hp, device=dev)
    pipe.graph, pipe.num_classes, pipe.multilabel = graph, n_cls, False
    if hp.use_structure:
        pool = sample_structure_anchor_patches(graph, hp, seed,
                                               hp.max_sim_epochs)
        pipe.structure_anchors = pool.astype(np.int32)
        pipe.int_walks = perform_random_walks(graph, hp, pool, True,
                                              seed).astype(np.int32)
        pipe.bor_walks = perform_random_walks(graph, hp, pool, False,
                                              seed).astype(np.int32)
    pipe._loaded = True
    stages["pool_walks_s"] = time.perf_counter() - t0
    model, params, _, params0 = program_params(hp, n, n_cls, seed, dev)

    def serve(req):
        t0 = time.perf_counter()
        out = pipe.predict(req, params, seed=seed)
        return time.perf_counter() - t0, out

    t0 = time.perf_counter()
    warm = requests(cfg, traffic, seed, 0, indptr, indices)
    n_warm = 0
    bfs = hp.use_neighborhood or hp.use_position
    while n_warm < int(traffic["warmup_requests"]) or (
            bfs and len(pipe._bfs_row_cache) < pipe.BFS_ROW_CACHE_SIZE
            and n_warm < int(traffic["warmup_requests_max"])):
        serve(next(warm))
        n_warm += 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_process
    stages["warmup_s"] = time.perf_counter() - t0

    stream = requests(cfg, traffic, seed, 1, indptr, indices)
    served, lat, timings, logits = [], [], [], []
    window_s = 0.0
    while window_s < float(args.seconds):
        req = next(stream)
        dt, out = serve(req)
        window_s += dt
        served.append(req)
        lat.append(dt)
        timings.append(out["timings"])
        logits.append(out["logits"])
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    ctx = {"cell": cell, "hp": cfg["hparams"], "n_classes": n_cls,
           "window_s": window_s, "timings": timings, "served": served}
    if args.trace:
        tracer = Trace(dev)
        traced = [next(stream) for _ in range(int(traffic["trace_requests"]))]
        tracer.start()
        for req in traced:
            serve(req)
        tracer.stop()
        ctx["trace"] = tracer.reduce()
        ctx["traced"] = traced
    cache = {"bfs_row_cache_rows": len(pipe._bfs_row_cache),
             "warmup_requests": n_warm, "stages": stages}
    pool = pipe.structure_anchors
    del pipe, model, params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    from .check_predict import check
    t0 = time.perf_counter()
    checks, R = check(cell, edges, seed, dev, params0, served, logits,
                      cell.limits)
    stages["check_s"] = time.perf_counter() - t0
    ctx["reference"] = R
    ctx["pool"] = pool
    result = {"attempted": len(served), "failed": 0,
              "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                         "count": 1, "memory_peak_bytes": int(peak)},
              "info": cache}
    if args.trace:
        result.update(read_per_layer(cell, ctx))
    else:
        from statistics import quantiles
        p95 = quantiles(lat, n=100, method="inclusive")[94] if len(lat) > 1 \
            else lat[0]
        result["metrics"] = {
            "predict_p95_ms": {"value": p95 * 1e3, "unit": "ms"},
            "predict_subgraphs_per_s": {
                "value": sum(len(r) for r in served) / window_s,
                "unit": "subgraphs/s"},
            "setup_s": {"value": setup_s, "unit": "s"}}
    return {"result": result, "checks": checks}
