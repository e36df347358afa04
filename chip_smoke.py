#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (subgnn_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases, each fatal on failure (non-zero exit, no result line):
  1. build   — compile every CUDA source of the port (one nvcc per source,
               all started together) and print the compiler's register report;
  2. kernel  — hold the DTW kernel against its plain PyTorch version on the
               card at serving shapes (G=2 groups x 64*15 comps x 150 pool
               patches, ragged and empty rows), max abs error <= 1e-5;
  3. serving — the port's SubGNNPipeline.predict at the flagship widths
               (D=128, 2 layers, all channels, float32) on a synthetic
               8192-node, average-degree-16 graph: 4 requests of 64 novel
               15-node subgraphs. Logits must be finite, the kernel's launch
               count must rise on every request, and one request recomputed
               by the port on the CPU must agree;
  4. timings — cold/warm per-request stage timings; the kernel's time
               against the plain version's at the serving request's own
               inputs, beside its lower bound on the card.
Prints the card's name and power limit, one JSON line of kernel records,
and last {"ok": true, "device": {...}}. Exits non-zero without a CUDA
device, and when run outside a checkout of the repository.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
DTW_FLOPS_PER_CELL = 8      # max, min, 2 adds, 1 div, 1 sub, 3-way min
DTW_TOL = 1e-5              # same fp32 operations in the same order
CPU_GPU_REL_TOL = 1e-3      # float32 sums in another order on each device

N_NODES, AVG_DEGREE = 8192, 16
N_REQUESTS, REQUEST_SIZE, SUBGRAPH_NODES = 4, 64, 15


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def flagship_hparams(HParams, seed):
    return HParams(
        node_embed_size=128, n_layers=2,
        n_anchor_patches_N_in=15, n_anchor_patches_N_out=30,
        n_anchor_patches_pos_in=30, n_anchor_patches_pos_out=60,
        n_anchor_patches_structure=15, n_triangular_walks=5,
        random_walk_len=10, linear_hidden_dim_1=64, linear_hidden_dim_2=32,
        sample_walk_len=25, max_sim_epochs=5, batch_size=64,
        use_neighborhood=True, use_position=True, use_structure=True,
        dtype="float32", seed=seed)


def grow_subgraph(graph, rng, size):
    """1-3 BFS-grown pieces from random starts, `size` nodes in all."""
    nodes: list[int] = []
    n_pieces = int(rng.integers(1, 4))
    for p in range(n_pieces):
        want = (size - len(nodes)) // (n_pieces - p)
        start = int(rng.integers(1, graph.n_nodes + 1))
        piece, frontier = [start], [start]
        while frontier and len(piece) < want:
            nxt = []
            for v in frontier:
                for u in rng.permutation(graph.neighbors(v)):
                    if len(piece) < want and int(u) not in piece:
                        piece.append(int(u))
                        nxt.append(int(u))
            frontier = nxt
        nodes.extend(v for v in piece if v not in nodes)
    return nodes[:size]


def write_dataset(root: Path, rng):
    """Synthetic task dir in the reference's on-disk format: edge list
    (0-based ids), subgraph TSV with train/val/test rows, embeddings."""
    from subgnn_tpu_torch.data.graph import CSRGraph
    task = root / "synthetic"
    task.mkdir(parents=True)
    edges = rng.integers(1, N_NODES + 1, (N_NODES * AVG_DEGREE // 2, 2))
    edges = edges[edges[:, 0] != edges[:, 1]]
    np.savetxt(task / "edge_list.txt", edges - 1, fmt="%d")
    graph = CSRGraph.from_edgelist(task / "edge_list.txt")
    rows = []
    for i, split in enumerate(["train"] * 8 + ["val"] * 4 + ["test"] * 4):
        sg = grow_subgraph(graph, rng, SUBGRAPH_NODES)
        rows.append("-".join(str(v - 1) for v in sg)
                    + f"\t{'ABC'[i % 3]}\t{split}")
    (task / "subgraphs.pth").write_text("\n".join(rows) + "\n")
    emb = rng.normal(size=(graph.n_nodes, 128)).astype(np.float32)
    np.save(task / "gin_embeddings.npy", emb)
    return graph


def dtw_inputs(graph, cc_ids, pool_cache):
    """The grouped kernel's inputs for one request, stacked exactly as
    precompute/similarities.structure_similarities_both stacks them."""
    from subgnn_tpu_torch.precompute.degree import degree_sequences
    n, C, L = cc_ids.shape
    flat = cc_ids.reshape(n * C, L)
    ci, li = degree_sequences(graph, flat, internal=True)
    cb, lb = degree_sequences(graph, flat, internal=False)
    (ai, ali), (ab, alb) = pool_cache["int"], pool_cache["bor"]
    return (np.concatenate([ci, cb]), np.concatenate([li, lb]),
            np.concatenate([ai, ab]), np.concatenate([ali, alb]),
            2, n * C, ai.shape[0])


def event_ms(fn, iters):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import subgnn_tpu_torch
    check(Path(subgnn_tpu_torch.__file__).resolve().parents[1] == HERE,
          f"subgnn_tpu_torch imported from {subgnn_tpu_torch.__file__}, "
          f"not from this checkout ({HERE})")
    from subgnn_tpu_torch.config import HParams, RunConfig
    from subgnn_tpu_torch.data.dataset import initialize_cc_ids
    from subgnn_tpu_torch.models.subgnn import tree_to
    from subgnn_tpu_torch.ops import build
    from subgnn_tpu_torch.ops import dtw as kdtw
    from subgnn_tpu_torch.train.runner import SubGNNPipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    rng = np.random.default_rng(args.seed)

    # ------------------------------------------------------------ 1. build
    t0 = time.perf_counter()
    secs = build.build()
    print(f"[build] {json.dumps(secs)} wall {time.perf_counter() - t0:.2f}s")
    for name in build.SOURCES:
        log = build.library_path(name).with_suffix(".log")
        if log.exists():
            print(f"[build] {name} nvcc:\n{log.read_text().strip()}")

    # ---------------------------------------------------- 2. kernel vs plain
    G, nc, na, Lc, La = 2, REQUEST_SIZE * SUBGRAPH_NODES, 150, 15, 25

    def ragged(rows, width, empty_frac):
        lens = rng.integers(1, width + 1, rows).astype(np.int32)
        lens[rng.random(rows) < empty_frac] = 0
        seqs = np.zeros((rows, width), np.float32)
        for i in range(rows):
            seqs[i, :lens[i]] = np.sort(rng.integers(0, 40, lens[i]))
        return seqs, lens

    cs, cl = ragged(G * nc, Lc, 0.3)
    as_, al = ragged(G * na, La, 0.05)
    kin = [torch.as_tensor(x, device=dev) for x in (cs, cl, as_, al)]
    got = kdtw.dtw_distance_grouped(*kin, G, nc, na)
    ref = kdtw.dtw_distance_grouped_torch(*kin, G, nc, na)
    torch.cuda.synchronize()
    max_abs_err = float((got - ref).abs().max())
    print(f"[kernel] dtw_grouped vs plain at G={G} nc={nc} na={na} Lc={Lc} "
          f"La={La}: max_abs_err={max_abs_err!r} (tol {DTW_TOL})")
    check(max_abs_err <= DTW_TOL, "DTW kernel disagrees with its plain version")

    # ---------------------------------------------------------- 3. serving
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        graph = write_dataset(root, rng)
        requests = [[grow_subgraph(graph, rng, SUBGRAPH_NODES)
                     for _ in range(REQUEST_SIZE)] for _ in range(N_REQUESTS)]
        print(f"[serving] synthetic graph n={graph.n_nodes} "
              f"edges={len(graph.indices) // 2} "
              f"({time.perf_counter() - t0:.2f}s)")
        hp = flagship_hparams(HParams, args.seed)
        rc = RunConfig(task="synthetic", project_root=root)
        pads = dict(max_n_cc=SUBGRAPH_NODES, max_len_cc=SUBGRAPH_NODES)

        t0 = time.perf_counter()
        pipe = SubGNNPipeline(rc, hp, device="cuda")
        pipe.load()
        pipe.precompute()
        _, params, state = pipe.build_model(args.seed)
        print(f"[serving] load+precompute+build_model "
              f"{time.perf_counter() - t0:.2f}s; pool "
              f"{pipe.structure_anchors.shape}")

        results = []
        kdtw.dtw_distance_grouped.launches = 0
        for req in requests:
            before = kdtw.dtw_distance_grouped.launches
            res = pipe.predict(req, params=params, state=state, **pads)
            res["dtw_launches"] = kdtw.dtw_distance_grouped.launches - before
            results.append(res)
        launches = kdtw.dtw_distance_grouped.launches
        for i, res in enumerate(results):
            check(res["logits"].shape == (REQUEST_SIZE, pipe.num_classes),
                  f"request {i}: logits shape {res['logits'].shape}")
            check(np.isfinite(res["logits"]).all(),
                  f"request {i}: non-finite logits")
            check(res["dtw_launches"] >= 1,
                  f"request {i}: the DTW kernel was not launched")
        print(f"[serving] {N_REQUESTS} requests x {REQUEST_SIZE} subgraphs: "
              f"finite logits, dtw kernel launches per request "
              f"{[r['dtw_launches'] for r in results]}")

        cpu_pipe = SubGNNPipeline(rc, hp, device="cpu")
        cpu_pipe.load()
        cpu_pipe.precompute()
        cpu_res = cpu_pipe.predict(requests[0], params=tree_to(params, "cpu"),
                                   state=tree_to(state, "cpu"), **pads)
        diff = float(np.abs(cpu_res["logits"] - results[0]["logits"]).max())
        scale = max(1.0, float(np.abs(cpu_res["logits"]).max()))
        print(f"[serving] request 0 on the CPU vs the GPU: max |logit diff| "
              f"{diff!r} (max |logit| {scale!r}, tol {CPU_GPU_REL_TOL} x "
              f"that); pred agree {float((cpu_res['pred'] == results[0]['pred']).mean())!r}")
        check(diff <= CPU_GPU_REL_TOL * scale,
              "GPU serving disagrees with the CPU recompute")

        # ------------------------------------------------------ 4. timings
        for i, res in enumerate(results):
            tag = "cold" if i == 0 else "warm"
            print(f"[timings] request {i} ({tag}): "
                  + json.dumps({k: v for k, v in res["timings"].items()}))

        cc_ids = initialize_cc_ids(graph, requests[-1], **pads)
        seqs = dtw_inputs(pipe.graph, cc_ids, pipe._serving_anchor_seqs)
        *arrays, Gr, ncr, nar = seqs
        rin = [torch.as_tensor(np.ascontiguousarray(x), device=dev)
               for x in arrays]
        got = kdtw.dtw_distance_grouped(*rin, Gr, ncr, nar)
        ref = kdtw.dtw_distance_grouped_torch(*rin, Gr, ncr, nar)
        torch.cuda.synchronize()
        req_err = float((got - ref).abs().max())
        check(req_err <= DTW_TOL, "DTW kernel disagrees at request inputs")
        max_abs_err = max(max_abs_err, req_err)

        def kernel():
            kdtw.dtw_distance_grouped(*rin, Gr, ncr, nar)

        def plain():
            kdtw.dtw_distance_grouped_torch(*rin, Gr, ncr, nar)

        p1 = event_ms(plain, 3)
        k1 = event_ms(kernel, 50)
        k2 = event_ms(kernel, 50)
        p2 = event_ms(plain, 3)
        ms, plain_ms = min(k1, k2), min(p1, p2)

        cl_r = arrays[1].astype(np.int64).reshape(Gr, ncr)
        al_r = arrays[3].astype(np.int64).reshape(Gr, nar)
        cells = int(sum((cl_r[g][:, None] * al_r[g][None, :]).sum()
                        for g in range(Gr)))
        n_bytes = sum(x.nbytes for x in arrays) + Gr * ncr * nar * 4
        ops_ms = cells * DTW_FLOPS_PER_CELL / PEAK_FP32_FLOPS * 1e3
        bytes_ms = n_bytes / PEAK_HBM_BYTES * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        print(f"[timings] dtw_grouped at request inputs (pairs "
              f"{Gr * ncr * nar}, DP cells {cells}): kernel {ms!r} ms "
              f"(runs {k1!r}, {k2!r}), plain {plain_ms!r} ms (runs {p1!r}, "
              f"{p2!r}), bound {bound_ms!r} ms, max_abs_err {req_err!r}")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    record = {"name": "dtw_grouped", "route": "cuda",
              "source": "subgnn_tpu_torch/csrc/dtw.cu",
              "replaces": "subgnn_tpu/ops/dtw_pallas.py:25",
              "launches": launches, "max_abs_err": max_abs_err,
              "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
              "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
              "library_ms": None}
    check(all(isinstance(v, (int, float)) and math.isfinite(v)
              for k, v in record.items() if k in ("ms", "plain_ms",
                                                  "bound_ms", "max_abs_err")),
          f"non-finite kernel record {record}")
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
