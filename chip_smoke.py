#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (subgnn_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases, each fatal on failure (non-zero exit, no result line):
  1. build    — compile every CUDA source of the port (one nvcc per source,
                all started together) and print the compiler's register
                report;
  2. kernels  — hold each kernel against its plain PyTorch version on the
                card: DTW at serving shapes (G=2 groups x 64*15 comps x 150
                pool patches, ragged and empty rows) and at a long case
                (Lc=300, a few comps of 257-300 nodes), max abs error <=
                1e-5, and whether the bits are equal is printed;
                segment_matmul (the embedding-table gradient) at the bench's
                plans (B=1280 bf16 and B=512 fp32, neigh and cc) and three
                edge cases (every id on one row, only PAD ids, padding
                tiles), per row |kernel - plain| <= 1e-5 * sum |g| over the
                row's slots (+ one bf16 ulp of the plain value for bf16; the
                output takes g's dtype, fp32 or bf16);
                segment_matmul's general path at D = 8, 96, 100 and 384
                (fp32 and bf16) at the bf16 neigh plan, same tolerance;
  3. serving  — the port's SubGNNPipeline.predict at the flagship widths
                (D=128, 2 layers, all channels, float32) on a synthetic
                8192-node, average-degree-16 graph: the full precompute
                (its one-time 8192^2 host BFS and stage times printed), then
                4 requests of 64 novel 15-node subgraphs. Logits must be
                finite, the DTW kernel must launch on every request, and one
                request recomputed by the port on the CPU must agree;
  4. dataset  — the full-dataset path on the card: a task of its own on the
                same graph (384 train / 128 val / 128 test subgraphs of 15
                nodes, D=128 embeddings, the serving task's
                shortest_path_matrix.npy shared through
                RunConfig.shortest_paths_path_override): precompute() with
                its stage times and exactly 2 x 3 DTW launches (one per split
                and side), the structure sims against the same stage on the
                CPU (atol 1e-6, bits equal printed), then Trainer.fit for 2
                epochs on split_data / sample_anchors / eval_cc_tables
                (finite val metrics, a checkpoint, segment_matmul launched
                twice a step). Then the repository's mini fixture (a D=8
                embedding table, off segment_matmul's vector set) through
                the same path for its config's 3 epochs, against the same run
                on the CPU (losses rel 1e-3); and shortest_path_matrix's
                device BFS on a 4096-node seeded graph against
                shortest_path_rows at 512 sampled sources (equal);
  5. training — the bench's training step (subgnn_tpu_torch/bench.py) at
                the flagship widths: 20 bf16 steps at B=1280 (finite losses,
                every leaf that gets a gradient changes, segment_matmul
                launched exactly twice per step), with their mpn_edges_per_s;
                one fp32 step at B=512 against the same step on the CPU
                (loss rel 1e-4, every gradient leaf atol 1e-4 x max|leaf|);
                Trainer.fit for 2 epochs on build_training_fixture at the
                flagship widths (finite val metrics, a top-k checkpoint);
  6. timings  — cold/warm per-request stage timings; each kernel's time
                against its plain version's, its lower bound on the card and
                (segment_matmul) index_add_, at the main path's own inputs.
                Each kernel record holds `ms` (= `call_ms`: CUDA events
                around 50 back-to-back eager calls, the larger of the host's
                enqueue time and the device time), `device_ms` (the sum of
                one call's own device activities, traced with torch.profiler
                with the L2 flushed before each call) and `span_ms` (first
                start to last end of those activities);
                subgnn_tpu_torch/kernel_times.py has the helpers.
Each path's launch counts are zeroed just before it and read just after:
the DTW record's launches are the 4 serving requests', segment_matmul's are
Trainer.fit's on the flagship fixture (the 20 bf16 steps and the dataset
phase's runs are counted on their own, for their checks).
Prints the card's name and power limit, one JSON line of kernel records,
and last {"ok": true, "device": {...}}. Exits non-zero without a CUDA
device, and when run outside a checkout of the repository.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent

DTW_TOL = 1e-5              # the same fp32 operations on each cell
CPU_GPU_REL_TOL = 1e-3      # float32 sums in another order on each device
SEG_REL_TOL = 1e-5          # fp32 sums of the same terms in another order
BF16_ULP = 2.0 ** -7        # one bf16 ulp, relative (8-bit significand)
STEP_LOSS_RTOL = 1e-4       # one fp32 training step, GPU vs CPU
STEP_GRAD_TOL = 1e-4        # x max|leaf|, per gradient leaf
N_BF16_STEPS, BF16_RUNS = 20, 4

N_NODES, AVG_DEGREE = 8192, 16
N_REQUESTS, REQUEST_SIZE, SUBGRAPH_NODES = 4, 64, 15
DATASET_SPLITS = {"train": 384, "val": 128, "test": 128}
ANY_WIDTHS = (8, 96, 100, 384)   # segment_matmul's general path
STRUC_SIM_TOL = 1e-6             # structure sims, card vs CPU
BFS_NODES, BFS_SOURCES = 4096, 512
MINI = HERE / "tests" / "fixtures" / "mini_multilabel"


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


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


def write_split_task(task: Path, graph, rng, counts):
    """Subgraph TSV with counts[split] rows of SUBGRAPH_NODES nodes each
    (0-based ids, labels A/B/C) and D=128 embeddings in task/."""
    task.mkdir(parents=True, exist_ok=True)
    rows = []
    splits = [s for s, n in counts.items() for _ in range(n)]
    for i, split in enumerate(splits):
        sg = grow_subgraph(graph, rng, SUBGRAPH_NODES)
        rows.append("-".join(str(v - 1) for v in sg)
                    + f"\t{'ABC'[i % 3]}\t{split}")
    (task / "subgraphs.pth").write_text("\n".join(rows) + "\n")
    emb = rng.normal(size=(graph.n_nodes, 128)).astype(np.float32)
    np.save(task / "gin_embeddings.npy", emb)


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
    write_split_task(task, graph, rng, {"train": 8, "val": 4, "test": 4})
    return graph


def fit_dataset(pipe, ckpt_dir, seed, tag):
    """Trainer.fit on the pipeline's precomputed splits: (last metrics,
    trainer, segment_matmul launches)."""
    from subgnn_tpu_torch.ops import embedding as E
    from subgnn_tpu_torch.train.loop import Trainer
    model, params, state = pipe.build_model(seed)
    trainer = Trainer(model, pipe.hp, ckpt_dir=str(ckpt_dir),
                      eval_cc_tables=pipe.eval_cc_tables(), device=pipe.device)
    anchors = pipe.sample_anchors(seed)
    E.segment_matmul.launches = 0
    last = trainer.fit(params, state, pipe.split_data("train"),
                       pipe.split_data("val"), anchors, seed=seed,
                       log_fn=lambda m: print(f"[dataset] {tag} fit {m}"))
    return last, trainer, E.segment_matmul.launches


def check_fit(last, trainer, launches, tag):
    for k in ("train_loss", "val_loss", "val_micro_f1", "val_acc",
              "val_auroc"):
        check(math.isfinite(last[k]), f"{tag} Trainer.fit: {k} = {last[k]!r}")
    best = trainer.ckpt.best_path
    check(best is not None and best.exists(),
          f"{tag} Trainer.fit wrote no checkpoint")
    check(launches == 2 * trainer.global_step,
          f"{tag} Trainer.fit: {launches} segment_matmul launches in "
          f"{trainer.global_step} steps")


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


def segment_check(E, g, ids, plan, out_rows):
    """Kernel vs plain on the card: (max abs err, within tolerance and the
    same bits on a second run). The tolerance per row is SEG_REL_TOL x the
    sum of |g| over the row's slots (index_add_ of |g|), plus one bf16 ulp
    of the plain value for bf16."""
    import torch
    got = E.segment_matmul(g, plan, out_rows)
    again = E.segment_matmul(g, plan, out_rows)
    ref = E.segment_matmul_torch(g, plan, out_rows)
    absum = torch.zeros(out_rows, g.shape[1], device=g.device).index_add_(
        0, ids.reshape(-1), g.float().abs())
    tol = SEG_REL_TOL * absum
    if g.dtype == torch.bfloat16:
        tol = tol + ref.float().abs() * BF16_ULP
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs()
    return (float(err.max()),
            bool((err <= tol).all()) and torch.equal(got, again))


def plan_stats(ids, plan):
    return (f"ids {ids.numel()}, tiles {plan.pos.shape[0]}, PAD ids "
            f"{int((ids == 0).sum())}, table rows {plan.n_rows}")


def dataset_phase(root: Path, graph, hp, rng, seed: int, dev):
    """Phase 4: precompute + Trainer.fit on a task of their own (the
    serving task's graph and path matrix), the D=8 mini fixture, and the
    device BFS."""
    import shutil

    import torch
    from subgnn_tpu_torch.config import HParams, RunConfig, \
        load_commented_json
    from subgnn_tpu_torch.data.graph import CSRGraph
    from subgnn_tpu_torch.ops import dtw as kdtw
    from subgnn_tpu_torch.precompute.shortest_paths import (
        shortest_path_matrix, shortest_path_rows)
    from subgnn_tpu_torch.precompute.similarities import \
        compute_structure_similarities
    from subgnn_tpu_torch.train.runner import SPLITS, SubGNNPipeline

    t0 = time.perf_counter()
    write_split_task(root / "dataset", graph, rng, DATASET_SPLITS)
    serving = root / "synthetic"
    rc = RunConfig(task="dataset", project_root=root,
                   graph_path_override=serving / "edge_list.txt",
                   shortest_paths_path_override=(serving /
                                                 "shortest_path_matrix.npy"))
    pipe = SubGNNPipeline(rc, hp.replace(max_epochs=2), device="cuda").load()
    print(f"[dataset] task written and loaded: "
          f"{ {s: len(pipe.subgraphs[s]) for s in SPLITS} } subgraphs of "
          f"{SUBGRAPH_NODES} nodes, cc_ids "
          f"{ {s: pipe.cc_ids[s].shape for s in SPLITS} } "
          f"({time.perf_counter() - t0:.2f}s)")
    kdtw.dtw_distance_grouped.launches = 0
    t0 = time.perf_counter()
    pipe.precompute()
    dtw_launches = kdtw.dtw_distance_grouped.launches
    print(f"[dataset] precompute on the card {time.perf_counter() - t0:.2f}s, "
          f"stages (s) {json.dumps(pipe.precompute_timings)}; dtw kernel "
          f"launches {dtw_launches}")
    check(dtw_launches == 2 * len(SPLITS),
          f"dataset precompute: {dtw_launches} DTW launches, expected "
          f"{2 * len(SPLITS)} (one per split and side)")
    worst, same = 0.0, True
    t0 = time.perf_counter()
    for s in SPLITS:
        for internal, got in ((True, pipe.int_s_sim[s]),
                              (False, pipe.bor_s_sim[s])):
            ref = compute_structure_similarities(
                pipe.graph, pipe.cc_ids[s], pipe.structure_anchors,
                internal=internal, device="cpu").astype(np.float32)
            check(got.shape == ref.shape, f"{s} structure sims shape "
                                          f"{got.shape} vs {ref.shape}")
            worst = max(worst, float(np.abs(got - ref).max()))
            same = same and np.array_equal(got, ref)
    print(f"[dataset] structure sims, card vs CPU (3 splits x 2 sides): max "
          f"abs diff {worst!r} (tol {STRUC_SIM_TOL}), bits equal {same} "
          f"(CPU {time.perf_counter() - t0:.2f}s)")
    check(worst <= STRUC_SIM_TOL, "dataset structure sims: card and CPU "
                                  "disagree")
    t0 = time.perf_counter()
    last, trainer, launches = fit_dataset(pipe, root / "dataset_ckpt", seed,
                                          "dataset")
    check_fit(last, trainer, launches, "dataset")
    print(f"[dataset] Trainer.fit 2 epochs x {trainer.global_step // 2} "
          f"batches of {pipe.hp.batch_size}: val_micro_f1 "
          f"{last['val_micro_f1']!r}, val_loss {last['val_loss']!r}, "
          f"segment_matmul launches {launches} (2 per step); checkpoint "
          f"{trainer.ckpt.best_path.name}; {time.perf_counter() - t0:.2f}s")

    # the mini fixture: a D=8 table, on the card and on the CPU
    mini = root / "mini_root"
    shutil.copytree(MINI / "mini", mini / "mini")
    mhp = HParams.from_dict(load_commented_json(MINI / "mini_config.json")
                            ["hyperparams_fix"])
    runs = {}
    for where in ("cuda", "cpu"):
        t0 = time.perf_counter()
        mpipe = SubGNNPipeline(RunConfig(task="mini", project_root=mini),
                               mhp, device=where).load().precompute()
        runs[where] = fit_dataset(mpipe, mini / f"ckpt_{where}", seed,
                                  f"mini {where}")
        print(f"[dataset] mini fixture on {where}: table "
              f"{mpipe.pretrained_embeds.shape}, "
              f"{time.perf_counter() - t0:.2f}s")
    last, trainer, launches = runs["cuda"]
    check(mpipe.hp.node_embed_size == 8, "the mini fixture's table is not D=8")
    check_fit(last, trainer, launches, "mini")
    cpu_scores = runs["cpu"][1].metric_scores
    diffs = [abs(a[k] - b[k]) / max(abs(b[k]), 1e-12)
             for a, b in zip(trainer.metric_scores, cpu_scores)
             for k in ("train_loss", "val_loss")]
    print(f"[dataset] mini fixture D=8, {len(trainer.metric_scores)} epochs "
          f"on the card: val_micro_f1 {last['val_micro_f1']!r}, "
          f"segment_matmul launches {launches} in {trainer.global_step} "
          f"steps; losses vs the CPU run: max rel diff {max(diffs)!r} (tol "
          f"{CPU_GPU_REL_TOL})")
    check(len(trainer.metric_scores) == mhp.max_epochs,
          "mini fixture: wrong number of epochs")
    check(max(diffs) <= CPU_GPU_REL_TOL, "mini fixture: card and CPU "
                                         "training disagree")

    # the device BFS at the size `auto` still sends to the card
    brng = np.random.default_rng(seed + 3)
    edges = brng.integers(1, BFS_NODES + 1, (BFS_NODES * 4, 2))
    edges = edges[edges[:, 0] != edges[:, 1]]
    bgraph = CSRGraph.from_edges(edges, n_nodes=BFS_NODES)
    t0 = time.perf_counter()
    mat = shortest_path_matrix(bgraph, backend="device", device=dev)
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    srcs = np.sort(brng.choice(np.arange(1, BFS_NODES + 1), BFS_SOURCES,
                               replace=False))
    t0 = time.perf_counter()
    rows = shortest_path_rows(bgraph, srcs)
    t_host = time.perf_counter() - t0
    equal = np.array_equal(mat[srcs - 1], rows)
    print(f"[dataset] device BFS, {BFS_NODES} nodes (max hop "
          f"{int(mat.max())}, unreached pairs {int((mat == 0).sum())}): "
          f"{t_dev:.3f}s for all {BFS_NODES} sources; host BFS {t_host:.3f}s "
          f"for {BFS_SOURCES}; rows equal {equal}")
    check(equal, "device BFS disagrees with shortest_path_rows")


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
    from subgnn_tpu_torch.bench import (bench_batch, build_training_fixture,
                                        card, flagship_hparams)
    from subgnn_tpu_torch.config import HParams, RunConfig
    from subgnn_tpu_torch.data.dataset import initialize_cc_ids
    from subgnn_tpu_torch.kernel_times import (PEAK_FP32_FLOPS, bench_plans,
                                               device_times, dtw_bound_ms,
                                               event_ms, segment_bound_ms)
    from subgnn_tpu_torch.models.subgnn import tree_to
    from subgnn_tpu_torch.ops import build
    from subgnn_tpu_torch.ops import dtw as kdtw
    from subgnn_tpu_torch.ops import embedding as E
    from subgnn_tpu_torch.train.loop import (Trainer, copy_tree,
                                             loss_and_grads, make_optimizer,
                                             mpn_edges_per_step, train_step)
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

    def ragged(rows, width, empty_frac, gen=rng):
        lens = gen.integers(1, width + 1, rows).astype(np.int32)
        lens[gen.random(rows) < empty_frac] = 0
        seqs = np.zeros((rows, width), np.float32)
        for i in range(rows):
            seqs[i, :lens[i]] = np.sort(gen.integers(0, 40, lens[i]))
        return seqs, lens

    def dtw_check(arrays, G, nc, na):
        """Kernel vs plain on the card: (max abs err, bits equal)."""
        kin = [torch.as_tensor(np.ascontiguousarray(x), device=dev)
               for x in arrays]
        got = kdtw.dtw_distance_grouped(*kin, G, nc, na)
        ref = kdtw.dtw_distance_grouped_torch(*kin, G, nc, na)
        torch.cuda.synchronize()
        return float((got - ref).abs().max()), torch.equal(got, ref)

    # the serving shape, then a long case: 2 x 64 comps of up to 300 nodes
    # (6 of them 257-300, past what the first kernel took) x 150 anchors,
    # drawn from a generator of their own (the serving phase's data below
    # comes from `rng`)
    cs, cl = ragged(G * nc, Lc, 0.3)
    as_, al = ragged(G * na, La, 0.05)
    lrng = np.random.default_rng(args.seed + 2)
    long_cs = np.zeros((2 * 64, 300), np.float32)
    long_cl = lrng.integers(1, 65, 2 * 64).astype(np.int32)
    long_cl[lrng.random(2 * 64) < 0.2] = 0
    long_cl[lrng.choice(2 * 64, 6, replace=False)] = lrng.integers(257, 301, 6)
    for i, n in enumerate(long_cl):
        long_cs[i, :n] = np.sort(lrng.integers(0, 40, n))
    max_abs_err = 0.0
    for what, arrays, shape in (
            ("serving", (cs, cl, as_, al), (G, nc, na)),
            ("long", (long_cs, long_cl, as_, al), (2, 64, na))):
        err, same = dtw_check(arrays, *shape)
        max_abs_err = max(max_abs_err, err)
        print(f"[kernel] dtw_grouped vs plain, {what} case (G, nc, na) = "
              f"{shape}, Lc={arrays[0].shape[1]} La={La}, comp lengths "
              f"{int(arrays[1].min())}-{int(arrays[1].max())}: max_abs_err="
              f"{err!r} (tol {DTW_TOL}), bits equal {same}")
        check(err <= DTW_TOL, f"DTW kernel disagrees with its plain version "
                              f"({what} case)")

    # segment_matmul at the bench's plans (the training path's own inputs:
    # the batches of phase 4) and at edge cases
    t0 = time.perf_counter()
    benches = {dt: bench_batch(dt, dev, args.seed)
               for dt in ("float32", "bfloat16")}
    print(f"[kernel] bench batches built ({time.perf_counter() - t0:.2f}s)")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    seg_err = 0.0
    D = 128
    for dt, (_, _, params_b, _, batch_b, anchors_b) in benches.items():
        rows = params_b["node_embed"].shape[0]
        tdt = torch.bfloat16 if dt == "bfloat16" else torch.float32
        for name, ids, plan in bench_plans(batch_b, anchors_b):
            g = torch.randn(ids.numel(), D, generator=gen, device=dev).to(tdt)
            err, ok = segment_check(E, g, ids, plan, rows)
            seg_err = max(seg_err, err)
            print(f"[kernel] segment_matmul {dt} B={batch_b['cc_ids'].shape[0]}"
                  f" {name} plan ({plan_stats(ids, plan)}): max_abs_err "
                  f"{err!r}, within tolerance and deterministic {ok}")
            check(ok, f"segment_matmul disagrees with its plain version (or "
                      f"with itself on a second run) at the {dt} {name} plan")
    rows = 8200
    edge = {"one_row": np.full(3 * E.TILE_WIDTH + 5, 4242),
            "only_pad": np.zeros(40 * 16, np.int64),
            "padding_tiles": np.random.default_rng(args.seed + 1).integers(
                0, rows, 5000)}
    for name, ids_np in edge.items():
        extra = 7 if name == "padding_tiles" else 0
        plan = E.make_gather_plan(ids_np, rows, E.tiles_needed(ids_np, rows)
                                  + extra).to(dev)
        ids = torch.as_tensor(ids_np, device=dev)
        for tdt in (torch.float32, torch.bfloat16):
            g = torch.randn(ids.numel(), D, generator=gen, device=dev).to(tdt)
            err, ok = segment_check(E, g, ids, plan, rows + 8)
            seg_err = max(seg_err, err)
            print(f"[kernel] segment_matmul edge case {name} {tdt} "
                  f"({plan_stats(ids, plan)}): max_abs_err {err!r}, within "
                  f"tolerance and deterministic {ok}")
            check(ok, f"segment_matmul disagrees at edge case {name}")
    # the general path (any D, scalar loads, slabs of up to 256 columns) at
    # the bf16 neigh plan's ids
    _, ids, plan = next(x for x in bench_plans(benches["bfloat16"][4],
                                               benches["bfloat16"][5])
                        if x[0] == "neigh")
    rows = benches["bfloat16"][2]["node_embed"].shape[0]
    for width in ANY_WIDTHS:
        for tdt in (torch.float32, torch.bfloat16):
            g = torch.randn(ids.numel(), width, generator=gen,
                            device=dev).to(tdt)
            err, ok = segment_check(E, g, ids, plan, rows)
            seg_err = max(seg_err, err)
            print(f"[kernel] segment_matmul D={width} {tdt} at the bf16 neigh "
                  f"plan ({plan_stats(ids, plan)}): max_abs_err {err!r}, "
                  f"within tolerance and deterministic {ok}")
            check(ok, f"segment_matmul disagrees at D={width} {tdt}")

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
        hp = HParams(**flagship_hparams("float32"), sample_walk_len=25,
                     max_sim_epochs=5, batch_size=64, use_neighborhood=True,
                     use_position=True, use_structure=True, seed=args.seed)
        rc = RunConfig(task="synthetic", project_root=root)
        pads = dict(max_n_cc=SUBGRAPH_NODES, max_len_cc=SUBGRAPH_NODES)

        t0 = time.perf_counter()
        pipe = SubGNNPipeline(rc, hp, device="cuda")
        pipe.load()
        pipe.precompute()
        _, params, state = pipe.build_model(args.seed)
        print(f"[serving] load+precompute+build_model "
              f"{time.perf_counter() - t0:.2f}s; pool "
              f"{pipe.structure_anchors.shape}; precompute stages (s) "
              f"{json.dumps(pipe.precompute_timings)}")

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
        req_err, req_same = dtw_check(arrays, Gr, ncr, nar)
        check(req_err <= DTW_TOL, "DTW kernel disagrees at request inputs")
        max_abs_err = max(max_abs_err, req_err)

        def kernel():
            kdtw.dtw_distance_grouped(*rin, Gr, ncr, nar)

        def plain():
            kdtw.dtw_distance_grouped_torch(*rin, Gr, ncr, nar)

        p1 = event_ms(plain, 3)
        k1 = event_ms(kernel, 50)
        dev_t = device_times(kernel)
        k2 = event_ms(kernel, 50)
        p2 = event_ms(plain, 3)
        ms, plain_ms = min(k1, k2), min(p1, p2)

        n_bytes = sum(x.nbytes for x in arrays) + Gr * ncr * nar * 4
        bound_ms, bound_by, cells = dtw_bound_ms(arrays[1], arrays[3], Gr,
                                                 ncr, nar, n_bytes)
        nonempty = int((arrays[1].reshape(Gr, ncr) > 0).sum())
        print(f"[timings] dtw_grouped at request inputs (pairs "
              f"{Gr * ncr * nar}, non-empty comps {nonempty} of {Gr * ncr}, "
              f"DP cells {cells}): kernel {ms!r} ms (runs {k1!r}, {k2!r}), "
              f"plain {plain_ms!r} ms (runs {p1!r}, {p2!r}), bound "
              f"{bound_ms!r} ms ({bound_by}), max_abs_err {req_err!r}, bits "
              f"equal {req_same}; device_ms {dev_t['device_ms']!r}, span_ms "
              f"{dev_t['span_ms']!r}, device activities "
              f"{json.dumps(dev_t['activities'])}")

        # ------------------------------------------------------ 4. dataset
        dataset_phase(root, graph, hp, rng, args.seed, dev)

    dtw_record = {"name": "dtw_grouped", "route": "cuda",
                  "source": "subgnn_tpu_torch/csrc/dtw.cu",
                  "replaces": "subgnn_tpu/ops/dtw_pallas.py:25",
                  "launches": launches, "max_abs_err": max_abs_err,
                  "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                  "bound_by": bound_by, "library_ms": None,
                  "bits_equal": req_same, "device_ms": dev_t["device_ms"],
                  "span_ms": dev_t["span_ms"], "call_ms": ms}

    # --------------------------------------------------------- 4. training
    # 20 bf16 steps at B=1280, timed in runs of 5 (before the CPU recompute
    # below, whose CPU work would share the host with the launching thread)
    model, hp, params, state, batch, anchors = benches["bfloat16"]
    tx = make_optimizer(hp.replace(learning_rate=1e-3))
    opt_state = tx.init(params)
    _, _, _, g0 = loss_and_grads(model, tx, params, state, batch, anchors)
    reached = [bool(g.abs().sum() > 0) for g in g0]
    before = [x.detach().clone() for x in tx.trainable(params)]
    del g0
    per_run = N_BF16_STEPS // BF16_RUNS
    B, C = batch["cc_ids"].shape[:2]
    edges_per_run = mpn_edges_per_step(hp, B, C) * per_run
    losses, run_s = [], []
    E.segment_matmul.launches = 0
    for _ in range(BF16_RUNS):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_run):
            loss, _, _ = train_step(model, tx, params, opt_state, state,
                                    batch, anchors)
            losses.append(loss)
        end.record()
        torch.cuda.synchronize()
        run_s.append(start.elapsed_time(end) / 1e3)
    bf16_launches = E.segment_matmul.launches
    losses = torch.stack(losses).float().cpu().numpy()
    check(np.isfinite(losses).all(), f"bf16 steps: non-finite loss {losses}")
    check(bf16_launches == 2 * N_BF16_STEPS,
          f"bf16 steps: segment_matmul launched {bf16_launches} times in "
          f"{N_BF16_STEPS} steps, expected {2 * N_BF16_STEPS}")
    after = tx.trainable(params)
    unchanged = [i for i, (a, b, r) in enumerate(zip(before, after, reached))
                 if r and torch.equal(a, b)]
    check(not unchanged, f"bf16 steps: leaves {unchanged} did not change")
    i = next(i for i, x in enumerate(after) if x is params["node_embed"])
    check(reached[i] and not torch.equal(before[i], after[i]),
          "bf16 steps: the embedding table got no update")
    rates = [edges_per_run / t for t in run_s]
    step_ms = float(np.median(run_s)) / per_run * 1e3
    print(f"[training] bf16 {N_BF16_STEPS} steps B={B}: loss "
          f"{losses[0]!r} -> {losses[-1]!r}, segment_matmul launches "
          f"{bf16_launches} (2 per step), {sum(reached)} of {len(reached)} "
          f"leaves get a gradient and all of them changed; mpn_edges_per_s "
          f"{float(np.median(rates))!r} (runs of {per_run} steps: {rates!r};"
          f" first run includes warm-up), {step_ms!r} ms/step")
    del before

    # one fp32 step at B=512 on the card and on the CPU, same inputs
    model, hp, params, state, batch, anchors = benches["float32"]
    tx = make_optimizer(hp)
    tx.init(params)
    t0 = time.perf_counter()
    loss_g, _, _, grads_g = loss_and_grads(model, tx, params, state, batch,
                                           anchors)
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    p_cpu = copy_tree(params, "cpu")
    tx.init(p_cpu)
    t0 = time.perf_counter()
    loss_c, _, _, grads_c = loss_and_grads(
        model, tx, p_cpu, tree_to(state, "cpu"),
        {k: v.to("cpu") for k, v in batch.items()},
        {k: v.cpu() for k, v in anchors.items()})
    t_cpu = time.perf_counter() - t0
    rel = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
    worst = 0.0
    for gg, gc in zip(grads_g, grads_c):
        diff = float((gg.cpu() - gc).abs().max())
        scale = float(gc.abs().max())
        check(diff <= STEP_GRAD_TOL * scale,
              f"fp32 step: a gradient leaf differs by {diff!r} (max|leaf| "
              f"{scale!r})")
        worst = max(worst, diff / scale if scale else 0.0)
    print(f"[training] fp32 step B={batch['cc_ids'].shape[0]}: loss GPU "
          f"{float(loss_g)!r} CPU {float(loss_c)!r} (rel diff {rel!r}, tol "
          f"{STEP_LOSS_RTOL}); worst gradient leaf diff / max|leaf| "
          f"{worst!r} over {len(grads_g)} leaves (tol {STEP_GRAD_TOL}); "
          f"step {t_gpu:.3f}s GPU (first), {t_cpu:.3f}s CPU")
    check(rel <= STEP_LOSS_RTOL, "fp32 step: GPU loss disagrees with CPU")
    del p_cpu, grads_c, grads_g

    # Trainer.fit at the flagship widths
    t0 = time.perf_counter()
    (fmodel, fhp, fparams, fstate, fdata, fanchors,
     _) = build_training_fixture(
        rng_seed=args.seed, n_nodes=N_NODES, n_train=256, n_val=128, C=3,
        L=16, n_pool=150, device=dev,
        hp_overrides=dict(flagship_hparams("float32"), batch_size=64,
                          max_epochs=2))
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(fmodel, fhp, ckpt_dir=str(Path(tmp) / "ckpt"),
                          device=dev)
        E.segment_matmul.launches = 0
        last = trainer.fit(fparams, fstate, fdata["train"], fdata["val"],
                           fanchors, seed=args.seed,
                           log_fn=lambda m: print(f"[training] fit {m}"))
        fit_launches = E.segment_matmul.launches
        best = trainer.ckpt.best_path
        check(best is not None and best.exists(),
              "Trainer.fit wrote no checkpoint")
        ckpt_bytes = best.stat().st_size
    for k in ("train_loss", "val_loss", "val_micro_f1", "val_acc",
              "val_auroc"):
        check(math.isfinite(last[k]), f"Trainer.fit: {k} = {last[k]!r}")
    check(fit_launches == 2 * trainer.global_step,
          f"Trainer.fit: {fit_launches} segment_matmul launches in "
          f"{trainer.global_step} steps")
    print(f"[training] Trainer.fit 2 epochs x {trainer.global_step // 2} "
          f"batches of 64: val_micro_f1 {last['val_micro_f1']!r}, val_loss "
          f"{last['val_loss']!r}, segment_matmul launches {fit_launches}; "
          f"checkpoint {best.name} ({ckpt_bytes} bytes); "
          f"{time.perf_counter() - t0:.2f}s")

    # ------------------------------------------------- 5. segment timings
    _, _, params, _, batch, anchors = benches["bfloat16"]
    rows = params["node_embed"].shape[0]
    timed = {}
    for name, ids, plan in bench_plans(batch, anchors):
        g = torch.randn(ids.numel(), D, generator=gen,
                        device=dev).to(torch.bfloat16)
        err, ok = segment_check(E, g, ids, plan, rows)
        check(ok, f"segment_matmul disagrees at the timed {name} inputs")
        seg_err = max(seg_err, err)
        flat = ids.reshape(-1)

        def kernel():
            E.segment_matmul(g, plan, rows)

        def plain():
            E.segment_matmul_torch(g, plan, rows)

        def library():
            torch.zeros(rows, D, dtype=torch.float32, device=dev).index_add_(
                0, flat, g.float())

        p1 = event_ms(plain, 3)
        k1 = event_ms(kernel, 50)
        l1 = event_ms(library, 20)
        k_dev = device_times(kernel)
        l_dev = device_times(library)
        l2 = event_ms(library, 20)
        k2 = event_ms(kernel, 50)
        p2 = event_ms(plain, 3)
        bound = segment_bound_ms(g, plan, rows)
        n_real = int((plan.local < E.TABLE_BLOCK).sum())
        ops_ms = n_real * D / PEAK_FP32_FLOPS * 1e3
        timed[name] = dict(ms=min(k1, k2), plain_ms=min(p1, p2),
                           library_ms=min(l1, l2), bound_ms=max(bound, ops_ms),
                           bound_by="operations" if ops_ms > bound else "bytes",
                           device_ms=k_dev["device_ms"],
                           span_ms=k_dev["span_ms"], call_ms=min(k1, k2),
                           library_device_ms=l_dev["device_ms"])
        print(f"[timings] segment_matmul bf16 B={batch['cc_ids'].shape[0]} "
              f"{name} plan ({plan_stats(ids, plan)}): kernel call_ms "
              f"{min(k1, k2)!r} (runs {k1!r}, {k2!r}), device_ms "
              f"{k_dev['device_ms']!r}, span_ms {k_dev['span_ms']!r}, device "
              f"activities {json.dumps(k_dev['activities'])}; plain "
              f"{min(p1, p2)!r} ms (runs {p1!r}, {p2!r}); index_add_ call_ms "
              f"{min(l1, l2)!r} (runs {l1!r}, {l2!r}), device_ms "
              f"{l_dev['device_ms']!r}; bound {timed[name]['bound_ms']!r} ms; "
              f"max_abs_err {err!r}")
    share = (timed["neigh"]["device_ms"] + timed["cc"]["device_ms"]) / step_ms
    print(f"[timings] segment_matmul share of a bf16 step: device_ms "
          f"{timed['neigh']['device_ms'] + timed['cc']['device_ms']!r} of "
          f"{step_ms!r} ms ({share!r}); device_ms / bound at the neigh plan "
          f"{timed['neigh']['device_ms'] / timed['neigh']['bound_ms']!r}")
    seg_record = {"name": "segment_matmul", "route": "cuda",
                  "source": "subgnn_tpu_torch/csrc/segment_matmul.cu",
                  "replaces": "subgnn_tpu/ops/embedding.py:162",
                  "launches": fit_launches, "max_abs_err": seg_err,
                  **timed["neigh"]}

    print(card())
    for record in (dtw_record, seg_record):
        check(all(isinstance(record[k], (int, float))
                  and math.isfinite(record[k])
                  for k in ("ms", "plain_ms", "bound_ms", "max_abs_err",
                            "device_ms", "span_ms", "call_ms")),
              f"non-finite kernel record {record}")
        check(record["launches"] > 0, f"{record['name']} was not launched "
                                      f"on its path")
    print(json.dumps({"kernels": [dtw_record, seg_record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
