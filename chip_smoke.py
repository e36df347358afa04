#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (subgnn_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases, each fatal on failure (non-zero exit, no result line):
  1. build    — compile every CUDA source of the port (one nvcc per source,
                all started together) and print the compiler's register
                report; beside them, the host C++ library (g++, BFS and
                walks, subgnn_tpu_torch/ops/native.py) and its seconds;
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
                (its one-time 8192^2 all-pairs BFS in the C++ library, once,
                and stage times printed), then 4 requests of 64 novel 15-node
                subgraphs, each printing its BFS sources, cache misses,
                bfs_rows_wall and ms per missed source. Logits must be
                finite, the DTW kernel must launch on every request, the C++
                BFS on every request with misses, request 0's served rows
                (up to 256 of its sources) must equal the numpy BFS's, and
                one request recomputed by the port on the CPU must agree;
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
                on the CPU (losses rel 1e-3). Every fit here and below takes
                Trainer.fit's fused mode where the JAX rules do, its steps
                CUDA-graph replays, their launches counted per replay;
  4b. fused   — on phase 4's task and splits, flagship widths, fp32, B=64,
                2 epochs: the fused fit against the streaming fit, at
                lin_dropout 0 (per-epoch train/val losses within rel 1e-5,
                bits equal printed) and 0.1 (equality printed), each with
                segment_matmul launched twice a step, its captures (at most
                one a step graph: one train graph a plan shape and one eval
                graph) and its epoch_time_s and train_edges_per_s printed;
                then segment_matmul captured alone (train/graphs.py) and
                called eagerly, captured and replayed, each call with a new
                g and a new plan in its static buffers, against its plain
                version at segment_check's tolerance in fp32 and bf16, one
                launch counted a call;
  5. run      — whole training runs through the port's CLIs, in-process
                (main() with sys.argv set) on -device cuda, at the flagship
                widths (lin_dropout 0.1, anchor resampling) on a fresh task
                of the same shape as phase 4's (no similarities cache; the
                serving graph and matrix through -graph_path and
                -shortest_paths_path): (a) cli.train for 3 epochs with
                top-3 checkpoints: the four JSON artifacts and a TB event
                file, exactly 6 DTW launches, segment_matmul twice per fit
                step, finite test metrics; (b) -resume from (a)'s epoch-0
                checkpoint: epochs 1-2 train/val losses within rel 1e-4 of
                (a)'s (bits equal printed); (c) -restoreModelPath
                -restoreModelName -noTrain on (a)'s best checkpoint:
                test_results.json within rel 1e-5 of (a)'s; (d) auto_lr_find
                and 1 epoch: the found lr finite, in [1e-6/3, 3e-2/3], and
                printed (its sweep launches no kernel: segment_matmul stays
                at 2 per fit step); (e) cli.test, 2 seeds x 1 epoch: finite
                means in experiment_results.json; (f) cli.train_config on
                the mini fixture's config, 2 trials x 1 epoch: 2 trials in
                study.json; (g) the mini fixture's SubGNNPipeline.run on the
                card and on the CPU: per-epoch losses within rel 1e-3. Each
                step's seconds and launch counts, and the phase's seconds,
                are printed;
  5b. prepare — dataset preparation on the card (prepare/node_emb.py, its
                SpMM both ways on segment_matmul): (a) cli.prepare_dataset
                in-process, --skip_graph -conv gin -emb_dim 64 -emb_epochs
                30 -device cuda, on the serving graph (hidden 128, full
                mode, one-hot 8192 features projected first): its
                ego_graphs.txt, degree_sequence.txt and
                shortest_path_matrix.npy equal to the port's CPU write,
                gin_embeddings.pth an (8192, 64) fp32 tensor equal to the
                .npy and finite, segment_matmul launched exactly
                spmm_launches' count (30 x 5 + 2), val_auc > 0.6; (b) GCN
                at dropout 0.4, 3 full-mode epochs on the card and on the
                CPU from the same initial parameters and numpy draws:
                per-epoch losses within rel 1e-4, embeddings within 1e-4 x
                max|emb|, bits equal printed; (c) a uniform graph at PPI-BP
                scale (17,080 nodes, 316,951 edges; random projection
                features): GraphSAINT (GIN, 512 walks of 32, 32 steps) for
                2 epochs and neighbor mode (GCN, nb_size 10 exact, batch
                512, 34 steps) for 1, finite, launches exact; (d) a uniform
                graph at HPO-METAB scale (14,587 nodes, 3,238,174 edges:
                6.48M directed, 7 SpMM chunks): GCN full mode for 3
                epochs, finite, launches exact, peak memory printed;
                segment_matmul timed at its first chunk's plan (D 128 fp32)
                against its plain version, index_add_ and its bound; (e)
                the device triangular walks at bench.py's shape (8192
                nodes, 4096 walks of 24, rw_beta 0.65, 8 rounds): every
                step an edge, PAD only after PAD,
                anchor_patch_samples_per_s printed. Seconds per epoch come
                from host stamps (after a synchronize) at each step's first
                draw;
  6. BFS      — on seeded graphs of 4096 and 8192 nodes (average degree
                16): the C++ all-pairs BFS at hp.n_processes threads and at
                every hardware thread, shortest_path_matrix's device BFS,
                and at 512 sampled sources the C++ rows on one thread and
                the numpy rows, each timed; every matrix and row set must be
                equal;
  7. training — the bench's training step (subgnn_tpu_torch/bench.py) at
                the flagship widths: 20 bf16 steps at B=1280 (finite losses,
                every leaf that gets a gradient changes, segment_matmul
                launched exactly twice per step), with their mpn_edges_per_s;
                one fp32 step at B=512 against the same step on the CPU
                (loss rel 1e-4, every gradient leaf atol 1e-4 x max|leaf|);
                Trainer.fit for 2 epochs on build_training_fixture at the
                flagship widths (finite val metrics, a top-k checkpoint);
  8. timings  — cold/warm per-request stage timings; each kernel's time
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
Trainer.fit's on the flagship fixture (the 20 bf16 steps and the dataset,
run and prepare phases' runs are counted on their own, for their checks;
the prepare runs' counts are in the record's `prepare_launches`, its time
at the prepare plan in `prepare_spmm`); the C++
BFS's calls are counted over serving's precompute and over its requests.
Prints the card's name and power limit, one JSON line of kernel records,
and last {"ok": true, "device": {...}}. Exits non-zero without a CUDA
device, and when run outside a checkout of the repository.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import sys
import os
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
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
BFS_SIZES, BFS_SOURCES = (4096, N_NODES), 512
BFS_CHECK_SOURCES = 256     # request 0's served rows held against numpy
MINI = HERE / "tests" / "fixtures" / "mini_multilabel"
RUN_EPOCHS = 3              # run phase (a); (b) resumes from epoch 0
RUN_DROPOUT = 0.1           # lin_dropout of (a)/(b): the resume must
                            # restore the card's dropout generator
RESUME_REL_TOL = 1e-4       # (b) vs (a), the same run on one card
RESTORE_REL_TOL = 1e-5      # (c) vs (a), one checkpoint tested twice
FUSED_REL_TOL = 1e-5        # fused vs streaming fit, the same steps
FUSED_DROPOUT = 0.1         # the fused phase's second pair
PREP_EPOCHS = 30            # prepare (a): the CLI's full-mode GIN epochs
PREP_CPU_EPOCHS = 3         # prepare (b): card vs CPU
PREP_REL_TOL = 1e-4         # (b): float32 sums in another order
PPI_BP = (17080, 316951)    # prepare (c): nodes, undirected edges
HPO_METAB = (14587, 3238174)  # prepare (d): 6.48M directed edges


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


def dataset_phase(root: Path, graph, hp, rng, seed: int):
    """Phase 4: precompute + Trainer.fit on a task of their own (the
    serving task's graph and path matrix), and the D=8 mini fixture."""
    import shutil

    from subgnn_tpu_torch.config import HParams, RunConfig, \
        load_commented_json
    from subgnn_tpu_torch.ops import dtw as kdtw
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
    return pipe


def captured_segment_check(E, ids_np, rows, seed):
    """segment_matmul captured alone (train/graphs.StepGraph: call 1 eager,
    call 2 captured and replayed, call 3 a replay), each call with a new g
    and a new plan (new ids of the same shape, one tile count) copied into
    its static buffers; every result held against segment_matmul_torch
    with segment_check's tolerance, in fp32 and bf16. Returns (max abs
    err, launches counted per call)."""
    import torch
    from subgnn_tpu_torch.train.graphs import StepGraph
    dev = torch.device("cuda:0")
    crng = np.random.default_rng(seed + 5)
    draws = [ids_np, crng.integers(0, rows, ids_np.shape),
             crng.permutation(ids_np.reshape(-1)).reshape(ids_np.shape)]
    tiles = max(E.tiles_needed(d, rows) for d in draws)
    plans = [E.make_gather_plan(d, rows, tiles).to(dev) for d in draws]
    worst, counts = 0.0, []
    for tdt in (torch.float32, torch.bfloat16):
        gs = [torch.as_tensor(crng.normal(size=(d.size, 128)), device=dev,
                              dtype=tdt) for d in draws]
        g = torch.empty_like(gs[0])
        plan = E.GatherPlan(*(torch.empty_like(t) for t in plans[0][:3]),
                            rows)
        out = torch.empty(rows, 128, device=dev, dtype=tdt)

        def step():
            out.copy_(E.segment_matmul(g, plan, rows))

        graph = StepGraph(step, dev)
        for d, p, gi in zip(draws, plans, gs):
            g.copy_(gi)
            for dst, src in zip(plan[:3], p[:3]):
                dst.copy_(src)
            before = E.segment_matmul.launches
            graph()
            counts.append(E.segment_matmul.launches - before)
            ref = E.segment_matmul_torch(gi, p, rows)
            absum = torch.zeros(rows, 128, device=dev).index_add_(
                0, torch.as_tensor(d.reshape(-1), device=dev),
                gi.float().abs())
            tol = SEG_REL_TOL * absum
            if tdt == torch.bfloat16:
                tol = tol + ref.float().abs() * BF16_ULP
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs()
            worst = max(worst, float(err.max()))
            check(bool((err <= tol).all()), f"captured segment_matmul "
                  f"disagrees with its plain version ({tdt}, call "
                  f"{graph.calls})")
        check(graph.captures == 1 and graph.graph is not None,
              "captured segment_matmul: no graph was captured")
    return worst, counts


def fused_phase(pipe, seed: int, benches):
    """Fused-epoch Trainer.fit (each step a CUDA-graph replay) against the
    streaming one on phase 4's task at the flagship widths, at lin_dropout
    0 and FUSED_DROPOUT, and segment_matmul captured alone."""
    from subgnn_tpu_torch.kernel_times import bench_plans
    from subgnn_tpu_torch.ops import embedding as E
    from subgnn_tpu_torch.train.loop import Trainer

    class Streaming(Trainer):
        """Trainer.fit's mode selection sees splits over its 1 GiB bound
        (as the JAX package's tests force streaming)."""
        _split_bytes = staticmethod(lambda data: 1 << 40)

    t_phase = time.perf_counter()
    anchors = pipe.sample_anchors(seed)
    train, val = pipe.split_data("train"), pipe.split_data("val")
    runs = {}
    for rate in (0.0, FUSED_DROPOUT):
        hp = pipe.hp.replace(max_epochs=2, lin_dropout=rate)
        for mode, cls in (("fused", Trainer), ("streaming", Streaming)):
            model, params, state = pipe.build_model(seed)
            model.hp = hp              # the forward reads the dropout rate
            trainer = cls(model, hp, eval_cc_tables=pipe.eval_cc_tables(),
                          device=pipe.device)
            E.segment_matmul.launches = 0
            t0 = time.perf_counter()
            trainer.fit(params, state, train, val, anchors, seed=seed,
                        log_fn=None)
            secs = time.perf_counter() - t0
            launches = E.segment_matmul.launches
            check(trainer.fused is (mode == "fused"),
                  f"fused phase: the {mode} run took the other mode")
            check(launches == 2 * trainer.global_step,
                  f"fused phase ({mode}, dropout {rate}): {launches} "
                  f"segment_matmul launches in {trainer.global_step} steps")
            m = trainer.metric_scores
            print(f"[fused] {mode} fit, lin_dropout {rate}: {secs:.2f}s, "
                  f"{trainer.global_step} steps, segment_matmul launches "
                  f"{launches}, captures {trainer.fused_captures} over "
                  f"{len(trainer._graphs)} step graphs; epoch_time_s "
                  f"{[x['epoch_time_s'] for x in m]!r}, train_edges_per_s "
                  f"{[x['train_edges_per_s'] for x in m]!r}; train_loss "
                  f"{[x['train_loss'] for x in m]!r}, val_loss "
                  f"{[x['val_loss'] for x in m]!r}")
            if mode == "fused":
                # one train graph a plan shape, one eval graph
                check(trainer.fused_captures <= len(trainer._graphs)
                      <= 1 + len(m), f"fused phase: "
                      f"{trainer.fused_captures} captures of "
                      f"{len(trainer._graphs)} step graphs")
            runs[mode, rate] = m
        pair = [(a[k], b[k]) for a, b in zip(runs["fused", rate],
                                             runs["streaming", rate])
                for k in ("train_loss", "val_loss")]
        worst = max(rel_diff(a, b) for a, b in pair)
        same = all(a == b for a, b in pair)
        print(f"[fused] fused vs streaming at lin_dropout {rate}: train and "
              f"val losses max rel diff {worst!r}, bits equal {same}")
        if rate == 0.0:
            check(worst <= FUSED_REL_TOL, f"fused and streaming fits "
                  f"disagree at lin_dropout 0 ({worst!r} > {FUSED_REL_TOL})")
    model, _, params, _, batch, anchors_b = benches["bfloat16"]
    _, ids, _ = next(x for x in bench_plans(batch, anchors_b)
                     if x[0] == "neigh")
    err, counts = captured_segment_check(E, ids.cpu().numpy(),
                                         params["node_embed"].shape[0], seed)
    print(f"[fused] segment_matmul captured alone at the bf16 neigh ids "
          f"(eager, captured + replayed, replayed; new g and plan each "
          f"call; fp32 then bf16): max_abs_err {err!r}, launches counted "
          f"per call {counts}")
    check(counts == [1] * 6, f"captured segment_matmul counted {counts}")
    print(f"[fused] phase seconds {time.perf_counter() - t_phase:.2f}")
    return err


def drive(main, prog, args, tag="run"):
    """Run a CLI's main() in this process with sys.argv set (so that the
    launch counters can be read after it); echo its standard output with a
    prefix and return it."""
    buf = io.StringIO()
    saved = sys.argv
    sys.argv = [prog] + [str(a) for a in args]
    try:
        with contextlib.redirect_stdout(buf):
            main()
    finally:
        sys.argv = saved
        for line in buf.getvalue().splitlines():
            print(f"[{tag}] {prog}: {line}")
    return buf.getvalue()


def epoch_metas(run_dir: Path):
    """{epoch: checkpoint meta} of a run's top-k checkpoints (every epoch's
    metrics at full precision, the step count after it)."""
    from subgnn_tpu_torch.train.checkpoint import load_checkpoint
    metas = {}
    for path in sorted((run_dir / "checkpoints").glob("*.ckpt")):
        meta = load_checkpoint(path)["meta"]
        metas[int(meta["epoch"])] = dict(meta, file=path.name)
    return metas


def finite_metrics(metrics, prefix):
    return all(math.isfinite(metrics[f"{prefix}_{k}"])
               for k in ("loss", "micro_f1", "acc", "auroc"))


def rel_diff(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def run_phase(root: Path, graph, hp, rng, seed: int):
    """Phase 5: whole training runs through the port's CLIs on the card,
    on a fresh task (no similarities cache) on the serving graph, and the
    mini fixture's run() on the card against the CPU."""
    import shutil

    from subgnn_tpu_torch.cli import test as test_cli
    from subgnn_tpu_torch.cli import train as train_cli
    from subgnn_tpu_torch.cli import train_config as config_cli
    from subgnn_tpu_torch.config import HParams, RunConfig, \
        load_commented_json
    from subgnn_tpu_torch.ops import dtw as kdtw
    from subgnn_tpu_torch.ops import embedding as E
    from subgnn_tpu_torch.train.runner import SubGNNPipeline

    t_phase = time.perf_counter()
    serving = root / "synthetic"
    task = root / "run"
    write_split_task(task, graph, rng, DATASET_SPLITS)
    # cli.test reads the task directory's own files
    shutil.copy(serving / "edge_list.txt", task / "edge_list.txt")
    (task / "shortest_path_matrix.npy").symlink_to(
        serving / "shortest_path_matrix.npy")
    hyp = dict(hp.to_dict(), max_epochs=RUN_EPOCHS, seed=seed,
               resample_anchor_patches=True, lin_dropout=RUN_DROPOUT)
    hyp_path = root / "run_hyperparams.json"
    hyp_path.write_text(json.dumps(hyp))
    base = ["-task", "run", "-project_root", root, "-device", "cuda",
            "-graph_path", serving / "edge_list.txt",
            "-shortest_paths_path", serving / "shortest_path_matrix.npy"]
    results = root / "tensorboard"
    steps_per_epoch = DATASET_SPLITS["train"] // hp.batch_size

    def counted(what, main, prog, args):
        kdtw.dtw_distance_grouped.launches = 0
        E.segment_matmul.launches = 0
        t0 = time.perf_counter()
        text = drive(main, prog, args)
        secs = time.perf_counter() - t0
        counts = (kdtw.dtw_distance_grouped.launches,
                  E.segment_matmul.launches)
        print(f"[run] {what}: {secs:.2f}s, dtw launches {counts[0]}, "
              f"segment_matmul launches {counts[1]}")
        return text, counts

    # (a) a 3-epoch run with anchor resampling and top-3 checkpoints
    text, (dtw_n, seg_n) = counted(
        "(a) train", train_cli.main, "train",
        base + ["-hyperparams", hyp_path, "-tb_name", "a",
                "-checkpoint_k", 3])
    run_a = results / "a"
    for name in ("hyperparams.json", "trainer_kwargs.json",
                 "final_metric_scores.json", "test_results.json"):
        check((run_a / name).exists(), f"(a) wrote no {name}")
    events = list((run_a / "tb").glob("events.out.tfevents.*"))
    check(len(events) == 1 and events[0].stat().st_size > 0,
          "(a) wrote no TensorBoard event file")
    check(dtw_n == 2 * 3, f"(a): {dtw_n} DTW launches on a fresh task, "
                          f"expected 6 (one per split and side)")
    metas_a = epoch_metas(run_a)
    check(sorted(metas_a) == list(range(RUN_EPOCHS)),
          f"(a) checkpoints of epochs {sorted(metas_a)}")
    steps = metas_a[RUN_EPOCHS - 1]["global_step"]
    check(steps == RUN_EPOCHS * steps_per_epoch, f"(a): {steps} steps")
    check(seg_n == 2 * steps, f"(a): {seg_n} segment_matmul launches in "
                              f"{steps} fit steps, expected {2 * steps}")
    test_a = json.loads((run_a / "test_results.json").read_text())
    check(finite_metrics(test_a, "test"), f"(a) test metrics {test_a}")
    check(json.loads(text.strip().splitlines()[-1])["test"] == test_a,
          "(a) printed test metrics differ from test_results.json")
    for e, m in sorted(metas_a.items()):
        print(f"[run] (a) epoch {e}: train_loss {m['train_loss']!r} "
              f"val_loss {m['val_loss']!r} val_micro_f1 "
              f"{m['val_micro_f1']!r} epoch_time_s {m['epoch_time_s']!r} "
              f"train_edges_per_s {m['train_edges_per_s']!r}")
    print(f"[run] (a) test: {json.dumps(test_a)}")

    # (b) resume (a) from its epoch-0 checkpoint: epochs 1-2 again
    _, (dtw_n, seg_n) = counted(
        "(b) resume", train_cli.main, "train",
        base + ["-hyperparams", hyp_path, "-tb_name", "b", "-resume",
                run_a / "checkpoints" / metas_a[0]["file"]])
    metas_b = epoch_metas(results / "b")
    check(sorted(metas_b) == list(range(1, RUN_EPOCHS)),
          f"(b) checkpoints of epochs {sorted(metas_b)}")
    diffs = [rel_diff(metas_b[e][k], metas_a[e][k]) for e in metas_b
             for k in ("train_loss", "val_loss")]
    same = all(metas_b[e][k] == metas_a[e][k] for e in metas_b
               for k in ("train_loss", "val_loss"))
    print(f"[run] (b) resumed epochs 1-{RUN_EPOCHS - 1} vs (a): train_loss "
          f"and val_loss max rel diff {max(diffs)!r} (tol "
          f"{RESUME_REL_TOL}), bits equal {same}")
    check(max(diffs) <= RESUME_REL_TOL, "(b) the resumed run left (a)'s "
                                        "trajectory")
    check(dtw_n == 0, f"(b): {dtw_n} DTW launches with the cache written")
    check(seg_n == 2 * (RUN_EPOCHS - 1) * steps_per_epoch,
          f"(b): {seg_n} segment_matmul launches")

    # (c) -noTrain restore of (a)'s best checkpoint
    best = max(metas_a.values(), key=lambda m: m["val_micro_f1"])["file"]
    counted("(c) restore -noTrain", train_cli.main, "train",
            base + ["-restoreModelPath", run_a, "-restoreModelName",
                    f"checkpoints/{best}", "-noTrain", "-tb_name", "c"])
    test_c = json.loads((results / "c" / "test_results.json").read_text())
    diffs = [rel_diff(test_c[k], test_a[k]) for k in test_a
             if math.isfinite(test_a[k])]
    print(f"[run] (c) restored {best}: test metrics vs (a) max rel diff "
          f"{max(diffs)!r} (tol {RESTORE_REL_TOL}), bits equal "
          f"{test_c == test_a}")
    check(set(test_c) == set(test_a) and max(diffs) <= RESTORE_REL_TOL,
          "(c) the restored checkpoint tests differently from (a)")

    # (d) auto_lr_find, then one epoch
    lr_path = root / "run_lr_hyperparams.json"
    lr_path.write_text(json.dumps(dict(hyp, auto_lr_find=True, max_epochs=1,
                                       resample_anchor_patches=False)))
    text, (_, seg_n) = counted("(d) auto_lr_find", train_cli.main, "train",
                               base + ["-hyperparams", lr_path,
                                       "-tb_name", "d"])
    line = next(x for x in text.splitlines() if x.startswith("auto_lr_find"))
    found = float(line.split("->")[1].split()[0])
    print(f"[run] (d) {line}: found lr {found!r} (range "
          f"[{1e-6 / 3!r}, {3e-2 / 3!r}])")
    check(math.isfinite(found) and 1e-6 / 3 <= found <= 3e-2 / 3,
          f"(d) lr_find found {found!r}")
    check(seg_n == 2 * steps_per_epoch, f"(d): {seg_n} segment_matmul "
          f"launches (lr_find's steps carry no plans)")

    # (e) the multi-seed protocol, 2 seeds x 1 epoch
    exp = root / "experiments"
    counted("(e) test 2 seeds", test_cli.main, "test",
            ["-task", "run", "-project_root", root, "-restoreModelPath",
             run_a, "-n_seeds", 2, "-max_epochs", 1, "-out_dir", exp,
             "-device", "cuda"])
    summary = json.loads((exp / "experiment_results.json").read_text())
    means = {k: v for k, v in summary.items() if k.endswith("_mean")}
    print(f"[run] (e) experiment_results.json: {json.dumps(means)}")
    check(summary["seeds"] == [0, 1] and len(means) == 3
          and all(math.isfinite(v) for v in means.values()),
          "(e) non-finite means")

    # (f) a 2-trial study from the mini fixture's config, 1 epoch a trial
    mini = root / "run_mini"
    shutil.copytree(MINI / "mini", mini / "mini")
    cfg = load_commented_json(MINI / "mini_config.json")
    cfg["hyperparams_fix"]["max_epochs"] = 1
    cfg_path = root / "run_mini_config.json"
    cfg_path.write_text(json.dumps(cfg))
    counted("(f) train_config 2 trials", config_cli.main, "train_config",
            ["-config_path", cfg_path, "-project_root", mini, "-n_trials",
             2, "-device", "cuda"])
    trials = json.loads((mini / "tb" / "mini" / "study.json").read_text())[
        "trials"]
    print(f"[run] (f) study.json: {len(trials)} trials, values "
          f"{[t['value'] for t in trials]!r}")
    check(len(trials) == 2, "(f) the study did not record 2 trials")

    # (g) the mini fixture's run() on the card and on the CPU
    mhp = HParams.from_dict(load_commented_json(MINI / "mini_config.json")
                            ["hyperparams_fix"])
    scores = {}
    for where in ("cuda", "cpu"):
        t0 = time.perf_counter()
        pipe = SubGNNPipeline(RunConfig(task="mini", project_root=mini),
                              mhp, device=where,
                              results_dir=root / f"run_mini_{where}")
        pipe.run(log_fn=lambda m, w=where: print(f"[run] (g) {w} {m}"))
        scores[where] = pipe.trainer.metric_scores
        print(f"[run] (g) mini run() on {where}: "
              f"{time.perf_counter() - t0:.2f}s")
    diffs = [rel_diff(a[k], b[k]) for a, b in zip(scores["cuda"],
                                                 scores["cpu"])
             for k in ("train_loss", "val_loss")]
    print(f"[run] (g) mini run() losses, card vs CPU over "
          f"{len(scores['cuda'])} epochs: max rel diff {max(diffs)!r} (tol "
          f"{CPU_GPU_REL_TOL})")
    check(len(scores["cuda"]) == len(scores["cpu"]) == mhp.max_epochs,
          "(g) wrong number of epochs")
    check(max(diffs) <= CPU_GPU_REL_TOL, "(g) card and CPU runs disagree")
    print(f"[run] phase seconds {time.perf_counter() - t_phase:.2f}")


def uniform_graph(rng, n, m):
    """A CSRGraph on nodes 1..n with m distinct undirected edges drawn
    uniformly (no self loops)."""
    from subgnn_tpu_torch.data.graph import CSRGraph
    keys = np.empty(0, np.int64)
    while len(keys) < m:
        u, v = rng.integers(0, n, (2, int((m - len(keys)) * 1.1) + 1000))
        lo, hi = np.minimum(u, v), np.maximum(u, v)
        keys = np.union1d(keys, (lo * n + hi)[lo < hi])
    keys = rng.permutation(keys)[:m]
    return CSRGraph.from_edges(np.stack([keys // n, keys % n], 1) + 1,
                               n_nodes=n)


def timed_draws(gen):
    """The trainer's own Draws, stamping the host clock (after a
    synchronize) at each step's negatives, the first draw of a step: the
    stamps' differences are step times."""
    import torch
    from subgnn_tpu_torch.prepare.node_emb import Draws

    class Timed(Draws):
        def __init__(self, generator):
            super().__init__(generator)
            self.stamps = []

        def negatives(self, high, count):
            torch.cuda.synchronize()
            self.stamps.append(time.perf_counter())
            return super().negatives(high, count)

    return Timed(gen)


def step_seconds(draws):
    """Median seconds between consecutive steps (the first step, which
    pays for set-up, left out) and the first step's."""
    d = np.diff(draws.stamps)
    return (float(np.median(d[1:])) if len(d) > 1 else float("nan"),
            float(d[0]) if len(d) else float("nan"))


def prepare_phase(root: Path, seed: int, dev, gpu: str):
    """Phase 5b: dataset preparation on the card (see the module doc)."""
    import ast
    import shutil

    import torch
    from subgnn_tpu_torch.bench import device_sampler, profile_steps
    from subgnn_tpu_torch.cli import prepare_dataset as prep_cli
    from subgnn_tpu_torch.data.graph import CSRGraph
    from subgnn_tpu_torch.ops import embedding as E
    from subgnn_tpu_torch.prepare import node_emb as NE

    t_phase = time.perf_counter()
    prng = np.random.default_rng(seed + 5)
    records = {}

    # (a) the CLI at the reference's widths on the serving graph: hidden 128
    # (the CLI's), emb_dim 64, 30 full-mode GIN epochs, one-hot 8192 features
    # projected first
    task, cpu_task = root / "prepare", root / "prepare_cpu"
    for d in (task, cpu_task):
        d.mkdir()
        for f in ("edge_list.txt", "subgraphs.pth"):
            shutil.copy(root / "synthetic" / f, d / f)
    graph = CSRGraph.from_edgelist(task / "edge_list.txt")
    src, dst = NE._directed_edges(graph)
    n_tr = 8 * int((src < dst).sum()) // 10
    want = NE.spmm_launches(len(src), n_tr, conv_type="gin",
                            minibatch="full", projected=True)
    timing = {}

    def timed_train(*a, **k):
        draws = timed_draws(torch.Generator(device=dev).manual_seed(seed))
        t0 = time.perf_counter()
        out = NE.train_node_embeddings(*a, draws=draws, **k)
        timing.update(total=time.perf_counter() - t0,
                      steps=step_seconds(draws))
        return out

    prep_cli.train_node_embeddings = timed_train
    E.segment_matmul.launches = 0
    t0 = time.perf_counter()
    try:
        text = drive(prep_cli.main, "prepare_dataset",
                     ["-out", task, "--skip_graph", "-conv", "gin",
                      "-emb_dim", 64, "-emb_epochs", PREP_EPOCHS, "-seed",
                      seed, "-device", dev.type], tag="prepare")
    finally:
        prep_cli.train_node_embeddings = NE.train_node_embeddings
    cli_s = time.perf_counter() - t0
    launches = E.segment_matmul.launches
    metrics = ast.literal_eval(text.split("node embeddings: ", 1)[1]
                               .splitlines()[0])
    prep_cli.prepare(str(cpu_task), generate_graph=False, generate_emb=False,
                     device="cpu", log_fn=None)
    for f in ("ego_graphs.txt", "degree_sequence.txt",
              "shortest_path_matrix.npy"):
        check((task / f).read_bytes() == (cpu_task / f).read_bytes(),
              f"(a) {f} differs from the port's CPU write")
    emb = torch.load(task / "gin_embeddings.pth")
    check(emb.dtype == torch.float32 and tuple(emb.shape) == (N_NODES, 64),
          f"(a) gin_embeddings.pth is {emb.dtype} {tuple(emb.shape)}")
    check(np.array_equal(emb.numpy(), np.load(task / "gin_embeddings.npy")),
          "(a) the .pth and .npy embeddings differ")
    check(bool(torch.isfinite(emb).all()), "(a) non-finite embeddings")
    expect = PREP_EPOCHS * want["step"] + want["eval"]
    check(launches == expect, f"(a) segment_matmul launched {launches} "
          f"times, expected {PREP_EPOCHS} x {want['step']} + {want['eval']}")
    step_s, first_s = timing["steps"]
    print(f"[prepare] (a) cli.prepare_dataset -conv gin -emb_dim 64 "
          f"-emb_epochs {PREP_EPOCHS} on {graph.n_nodes} nodes / {len(src)} "
          f"directed edges: val_auc {metrics['val_auc']!r}, val_acc "
          f"{metrics['val_acc']!r}, final_loss {metrics['final_loss']!r}; "
          f"seconds per epoch {step_s!r} (median, warm; first {first_s!r}), "
          f"train_node_embeddings {timing['total']!r}s, CLI {cli_s!r}s; "
          f"segment_matmul launches {launches} = {PREP_EPOCHS} x "
          f"{want['step']} a step + {want['eval']} eval; metric files equal "
          f"to the CPU's ({gpu})")
    check(metrics["val_auc"] > 0.6, f"(a) val_auc {metrics['val_auc']!r}")
    records["cli_gin_full"] = dict(seconds_per_epoch=step_s,
                                   val_auc=metrics["val_auc"],
                                   launches=launches)

    # (b) card against CPU: GCN, dropout 0.4, 3 full-mode epochs, numpy
    # draws from the seed and the same initial parameters
    n = graph.n_nodes
    drng = np.random.default_rng(seed + 6)
    init = NE.init_gnn_params(torch.Generator().manual_seed(seed), n, 128, 64)
    n_neg = max(n_tr // 4, 1)
    negs = [drng.integers(0, n, (2, n_neg)) for _ in range(PREP_CPU_EPOCHS)]
    keeps = [drng.random((n, 128)) >= 0.4 for _ in range(PREP_CPU_EPOCHS)]
    runs = {}
    for where in (dev.type, "cpu"):
        draws = NE.ReplayDraws(where, negatives=negs, keep=keeps)
        t0 = time.perf_counter()
        runs[where] = NE.train_node_embeddings(
            graph, conv_type="gcn", dropout=0.4, epochs=PREP_CPU_EPOCHS,
            seed=seed, device=where, params=init, draws=draws)
        print(f"[prepare] (b) {PREP_CPU_EPOCHS} GCN epochs on {where}: "
              f"{time.perf_counter() - t0:.2f}s")
    (emb_g, m_g), (emb_c, m_c) = runs[dev.type], runs["cpu"]
    loss_rel = max(rel_diff(a, b) for a, b in zip(m_g["loss_history"],
                                                  m_c["loss_history"]))
    emb_err = float(np.abs(emb_g - emb_c).max())
    scale = float(np.abs(emb_c).max())
    print(f"[prepare] (b) card vs CPU: per-epoch losses {m_g['loss_history']!r}"
          f" vs {m_c['loss_history']!r}, max rel diff {loss_rel!r} (tol "
          f"{PREP_REL_TOL}); embeddings max |diff| {emb_err!r} (max |emb| "
          f"{scale!r}, tol {PREP_REL_TOL} x that); bits equal "
          f"{bool(np.array_equal(emb_g, emb_c))}")
    check(loss_rel <= PREP_REL_TOL, "(b) card and CPU losses disagree")
    check(emb_err <= PREP_REL_TOL * scale,
          "(b) card and CPU embeddings disagree")

    # (c) the minibatch modes at PPI-BP scale, random projection features
    t0 = time.perf_counter()
    ppi = uniform_graph(prng, *PPI_BP)
    src, dst = NE._directed_edges(ppi)
    n_tr = 8 * int((src < dst).sum()) // 10
    print(f"[prepare] (c) PPI-BP-scale graph: {ppi.n_nodes} nodes, "
          f"{len(src) // 2} edges ({time.perf_counter() - t0:.2f}s)")
    for name, kw, epochs, steps in (
            ("graphsaint", dict(conv_type="gin", minibatch="graphsaint",
                                batch_size=512, walk_length=32,
                                num_steps=32), 2, 32),
            ("neighbor", dict(conv_type="gcn", minibatch="neighbor",
                              batch_size=512, nb_size=10, nb_exact=True),
             1, -(-ppi.n_nodes // 512))):
        want = NE.spmm_launches(len(src), n_tr, conv_type=kw["conv_type"],
                                minibatch=name, projected=True)
        draws = timed_draws(torch.Generator(device=dev).manual_seed(seed))
        E.segment_matmul.launches = 0
        t0 = time.perf_counter()
        emb, m = NE.train_node_embeddings(ppi, epochs=epochs, seed=seed,
                                          device=dev, draws=draws, **kw)
        total = time.perf_counter() - t0
        launches = E.segment_matmul.launches
        step_s, first_s = step_seconds(draws)
        expect = epochs * steps * want["step"] + want["eval"]
        print(f"[prepare] (c) {name} ({kw['conv_type']}), {epochs} epoch(s) "
              f"x {steps} steps: losses {m['loss_history']!r}, val_auc "
              f"{m['val_auc']!r}; seconds per epoch {step_s * steps!r} "
              f"(median step {step_s!r}, first {first_s!r}), "
              f"train_node_embeddings {total!r}s; segment_matmul launches "
              f"{launches} = {epochs * steps} x {want['step']} + "
              f"{want['eval']} ({gpu})")
        check(np.isfinite(m["loss_history"]).all() and np.isfinite(emb).all(),
              f"(c) {name}: non-finite losses or embeddings")
        check(launches == expect, f"(c) {name}: {launches} segment_matmul "
                                  f"launches, expected {expect}")
        records[name] = dict(seconds_per_epoch=step_s * steps,
                             launches=launches)
    # where a neighbor-mode epoch's time goes (plans, table and eval
    # included)
    profile_steps(lambda: NE.train_node_embeddings(
        ppi, epochs=1, seed=seed, device=dev, **kw), 1,
        "(c) neighbor, 1 epoch", file=sys.stdout,
        sort_by=("self_device_time_total", "self_cpu_time_total"))
    del ppi

    # (d) the chunked SpMM at HPO-METAB scale: GCN, full mode, 3 epochs
    t0 = time.perf_counter()
    metab = uniform_graph(prng, *HPO_METAB)
    gen_s = time.perf_counter() - t0
    src, dst = NE._directed_edges(metab)
    n_tr = 8 * int((src < dst).sum()) // 10
    want = NE.spmm_launches(len(src), n_tr, conv_type="gcn",
                            minibatch="full", projected=True)
    print(f"[prepare] (d) HPO-METAB-scale graph: {metab.n_nodes} nodes, "
          f"{len(src)} directed edges ({-(-len(src) // NE.EDGE_CHUNK)} "
          f"chunks of <= {NE.EDGE_CHUNK}) (drawn and built in {gen_s:.2f}s;"
          f" {time.perf_counter() - t0:.2f}s in all)")
    check(len(src) > NE.EDGE_CHUNK, "(d) the graph fits one chunk")
    draws = timed_draws(torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.reset_peak_memory_stats()
    E.segment_matmul.launches = 0
    t0 = time.perf_counter()
    emb, m = NE.train_node_embeddings(metab, conv_type="gcn", epochs=3,
                                      seed=seed, device=dev, draws=draws)
    total = time.perf_counter() - t0
    launches = E.segment_matmul.launches
    peak = torch.cuda.max_memory_allocated()
    step_s, first_s = step_seconds(draws)
    expect = 3 * want["step"] + want["eval"]
    print(f"[prepare] (d) 3 GCN full epochs: losses {m['loss_history']!r}, "
          f"val_auc {m['val_auc']!r}; seconds per epoch {step_s!r} (first "
          f"{first_s!r}), train_node_embeddings {total!r}s; peak device "
          f"memory {peak} bytes; segment_matmul launches {launches} = 3 x "
          f"{want['step']} + {want['eval']} ({gpu})")
    check(np.isfinite(m["loss_history"]).all() and np.isfinite(emb).all(),
          "(d) non-finite losses or embeddings")
    check(launches == expect, f"(d) {launches} segment_matmul launches, "
                              f"expected {expect}")
    records["chunked_gcn_full"] = dict(seconds_per_epoch=step_s,
                                       launches=launches, peak_bytes=peak)
    profile_steps(lambda: NE.train_node_embeddings(
        metab, conv_type="gcn", epochs=1, seed=seed, device=dev), 1,
        "(d) GCN full, 1 epoch", file=sys.stdout)

    # segment_matmul at the phase's largest plan: (d)'s first edge chunk by
    # dst (the SpMM's forward sum), D = hidden 128, fp32
    edges = NE.EdgePlans(src[:NE.EDGE_CHUNK], dst[:NE.EDGE_CHUNK],
                         metab.n_nodes, dev, None)
    c = edges.chunks[0]
    g = torch.randn(c.hi - c.lo, 128, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(seed))
    err, ok = segment_check(E, g, c.dst, c.plan_dst, metab.n_nodes)
    check(ok, "segment_matmul disagrees at the prepare plan")
    records["spmm"] = spmm_timing(E, g, c.dst, c.plan_dst, metab.n_nodes)
    records["spmm"]["max_abs_err"] = err
    print(f"[prepare] segment_matmul at (d)'s edge chunk by dst ("
          f"{plan_stats(c.dst, c.plan_dst)}, D=128 fp32): "
          f"{json.dumps(records['spmm'])} ({gpu})")
    del metab, edges, g

    # (e) the device walks at bench.py's shape
    rate, wg, walks = device_sampler(dev)
    w = walks.cpu().numpy().astype(np.int64)
    pairs = (w[:, :-1] != 0) & (w[:, 1:] != 0)
    a, b = w[:, :-1][pairs], w[:, 1:][pairs]
    src_w = np.repeat(np.arange(wg.n_nodes + 1), np.diff(wg.indptr)[
        :wg.n_nodes + 1])
    keys = np.sort(src_w * (wg.n_nodes + 1) + wg.indices)
    edge_ok = bool(np.isin(a * (wg.n_nodes + 1) + b, keys).all())
    pad_ok = bool(((w[:, :-1] != 0) | (w[:, 1:] == 0)).all())
    print(f"[prepare] (e) triangular_walks_device {tuple(w.shape)} on "
          f"{wg.n_nodes} nodes: anchor_patch_samples_per_s {rate!r}; every "
          f"step an edge {edge_ok}, PAD only after PAD {pad_ok} ({gpu})")
    check(edge_ok and pad_ok, "(e) device walks break an invariant")
    records["anchor_patch_samples_per_s"] = rate
    print(f"[prepare] phase seconds {time.perf_counter() - t_phase:.2f}")
    return records


def spmm_timing(E, g, ids, plan, rows):
    """The kernel's call and device time at (g, plan) against its plain
    version and index_add_, with its bound."""
    import torch
    from subgnn_tpu_torch.kernel_times import (PEAK_FP32_FLOPS, device_times,
                                               event_ms, segment_bound_ms)
    D = g.shape[1]

    def kernel():
        E.segment_matmul(g, plan, rows)

    def plain():
        E.segment_matmul_torch(g, plan, rows)

    def library():
        torch.zeros(rows, D, dtype=torch.float32, device=g.device).index_add_(
            0, ids, g)

    p1, k1, l1 = event_ms(plain, 3), event_ms(kernel, 20), event_ms(library,
                                                                      20)
    k_dev, l_dev = device_times(kernel), device_times(library)
    l2, k2, p2 = event_ms(library, 20), event_ms(kernel, 20), event_ms(plain,
                                                                       3)
    bound = segment_bound_ms(g, plan, rows)
    ops_ms = int((plan.local < E.TABLE_BLOCK).sum()) * D / PEAK_FP32_FLOPS * 1e3
    return dict(ms=min(k1, k2), plain_ms=min(p1, p2), library_ms=min(l1, l2),
                device_ms=k_dev["device_ms"], span_ms=k_dev["span_ms"],
                library_device_ms=l_dev["device_ms"],
                bound_ms=max(bound, ops_ms),
                bound_by="operations" if ops_ms > bound else "bytes")


def served_rows_check(pipe, req, res, pads, seed):
    """Request 0 is cold: every BFS source missed the row cache. Hold the
    rows the C++ library served (still cached) against the numpy BFS at up
    to BFS_CHECK_SOURCES of them."""
    from subgnn_tpu_torch.data.dataset import initialize_cc_ids
    from subgnn_tpu_torch.precompute.shortest_paths import \
        _bfs_from_sources_host
    srcs = np.unique(initialize_cc_ids(pipe.graph, req, **pads))
    srcs = srcs[srcs != 0].astype(np.int64)
    check(res["timings"]["bfs_cache_miss"] == len(srcs),
          "request 0: not every BFS source missed the cache")
    pick = np.sort(np.random.default_rng(seed + 4).choice(
        srcs, min(BFS_CHECK_SOURCES, len(srcs)), replace=False))
    served = np.stack([pipe._bfs_row_cache[int(s)] for s in pick])
    t0 = time.perf_counter()
    want = _bfs_from_sources_host(pipe.graph, pick)
    t_np = time.perf_counter() - t0
    return {"sources": len(pick), "missed": len(srcs),
            "equal": bool(np.array_equal(served, want)),
            "numpy_ms_per_source": t_np / len(pick) * 1e3}


def bfs_phase(hp, seed: int, dev):
    """Phase 5: the all-pairs BFS on the host (C++) and on the card, and the
    numpy rows, on seeded graphs of each size in BFS_SIZES."""
    import torch
    from subgnn_tpu_torch.data.graph import CSRGraph
    from subgnn_tpu_torch.precompute.shortest_paths import (
        shortest_path_matrix, shortest_path_rows)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    threads = {"n_processes": hp.n_processes, "all": 0}
    print(f"[bfs] host threads: os.cpu_count() {os.cpu_count()}, usable "
          f"{len(os.sched_getaffinity(0))}; hp.n_processes {hp.n_processes}")
    brng = np.random.default_rng(seed + 3)
    # the first device BFS pays for cuBLAS's set-up: take it here
    warm = CSRGraph.from_edges(brng.integers(1, 257, (1024, 2)), n_nodes=256)
    shortest_path_matrix(warm, backend="device", device=dev)
    for n in BFS_SIZES:
        edges = brng.integers(1, n + 1, (n * AVG_DEGREE // 2, 2))
        g = CSRGraph.from_edges(edges[edges[:, 0] != edges[:, 1]], n_nodes=n)
        srcs = np.sort(brng.choice(np.arange(1, n + 1), BFS_SOURCES,
                                   replace=False))
        secs, mats = {}, {}
        for name, k in threads.items():
            mats[name], secs[f"cpp_all_pairs_{name}"] = timed(
                lambda k=k: shortest_path_matrix(g, backend="host",
                                                 n_threads=k))
        mats["device"], secs["device_all_pairs"] = timed(
            lambda: shortest_path_matrix(g, backend="device", device=dev))
        cpp_rows, secs["cpp_rows_1_thread"] = timed(
            lambda: shortest_path_rows(g, srcs, backend="host", n_threads=1))
        np_rows, secs["numpy_rows"] = timed(
            lambda: shortest_path_rows(g, srcs, backend="fallback"))
        ref = mats["all"]
        equal = (all(np.array_equal(m, ref) for m in mats.values())
                 and np.array_equal(cpp_rows, ref[srcs - 1])
                 and np.array_equal(np_rows, ref[srcs - 1]))
        per_src = {k: v / (BFS_SOURCES if "rows" in k else n) * 1e3
                   for k, v in secs.items()}
        ratio = secs["device_all_pairs"] / secs["cpp_all_pairs_n_processes"]
        print(f"[bfs] {n} nodes, {len(g.indices) // 2} edges (max hop "
              f"{int(ref.max())}, unreached pairs {int((ref == 0).sum())}): "
              f"seconds {json.dumps(secs)}; ms per source "
              f"{json.dumps(per_src)}; C++ (n_threads {hp.n_processes} and "
              f"0), device and numpy agree {equal}; device / C++ at "
              f"n_processes {ratio!r}")
        check(equal, f"BFS at {n} nodes: the C++, device and numpy BFS "
                     f"disagree")
        del mats, ref


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
    from subgnn_tpu_torch.ops import native
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
    with ThreadPoolExecutor(max_workers=1) as pool:
        host_lib = pool.submit(native.build)   # g++ beside the nvcc builds
        secs = build.build()
        lib_path, gxx_s = host_lib.result()
    print(f"[build] {json.dumps(secs)} wall {time.perf_counter() - t0:.2f}s; "
          f"host library (g++) {gxx_s:.2f}s -> {lib_path.name}")
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
        native.bfs_all_pairs.launches = 0
        pipe.precompute()
        all_pairs_launches = native.bfs_all_pairs.launches
        _, params, state = pipe.build_model(args.seed)
        print(f"[serving] load+precompute+build_model "
              f"{time.perf_counter() - t0:.2f}s; pool "
              f"{pipe.structure_anchors.shape}; precompute stages (s) "
              f"{json.dumps(pipe.precompute_timings)}; NP similarities "
              f"(the C++ all-pairs BFS at n_threads={hp.n_processes}, "
              f"{all_pairs_launches} call) "
              f"{pipe.precompute_timings['NP similarities']!r}s")
        check(all_pairs_launches == 1, f"serving precompute: "
              f"{all_pairs_launches} C++ all-pairs BFS calls, expected 1")

        results = []
        kdtw.dtw_distance_grouped.launches = 0
        native.bfs_from_sources.launches = 0
        for i, req in enumerate(requests):
            before = kdtw.dtw_distance_grouped.launches
            res = pipe.predict(req, params=params, state=state, **pads)
            res["dtw_launches"] = kdtw.dtw_distance_grouped.launches - before
            results.append(res)
            if i == 0:
                bfs_check = served_rows_check(pipe, req, res, pads,
                                              args.seed)
        launches = kdtw.dtw_distance_grouped.launches
        bfs_launches = native.bfs_from_sources.launches
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
        missed = sum(r["timings"]["bfs_cache_miss"] > 0 for r in results)
        for i, res in enumerate(results):
            t = res["timings"]
            miss = t["bfs_cache_miss"]
            print(f"[serving] request {i} BFS (C++, n_threads="
                  f"{hp.n_processes}): bfs_srcs {t['bfs_srcs']}, "
                  f"bfs_cache_miss {miss}, bfs_rows_wall "
                  f"{t['bfs_rows_wall']!r}s, "
                  f"{t['bfs_rows_wall'] / miss * 1e3 if miss else 0.0!r} ms "
                  f"per missed source; total {t['total']!r}s")
        print(f"[serving] request 0's served rows vs the numpy BFS at "
              f"{bfs_check['sources']} of its {bfs_check['missed']} missed "
              f"sources: equal {bfs_check['equal']} (numpy "
              f"{bfs_check['numpy_ms_per_source']!r} ms a source); C++ BFS "
              f"calls over the requests {bfs_launches} ({missed} with misses)")
        check(bfs_check["equal"], "request 0: the C++ BFS rows served "
                                  "differ from the numpy BFS's")
        check(bfs_launches == missed >= 1, f"serving: {bfs_launches} C++ BFS "
              f"calls for {missed} requests with cache misses")

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

        # ---------------------------------------------- 3. serving timings
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
        dpipe = dataset_phase(root, graph, hp, rng, args.seed)

        # ------------------------------------------------------ 4b. fused
        seg_err = max(seg_err, fused_phase(dpipe, args.seed, benches))
        del dpipe

        # ---------------------------------------------------------- 5. run
        run_phase(root, graph, hp, rng, args.seed)

        # ----------------------------------------------------- 5b. prepare
        prepare = prepare_phase(root, args.seed, dev, card())

    # ------------------------------------------------------------ 6. BFS
    bfs_phase(hp, args.seed, dev)

    dtw_record = {"name": "dtw_grouped", "route": "cuda",
                  "source": "subgnn_tpu_torch/csrc/dtw.cu",
                  "replaces": "subgnn_tpu/ops/dtw_pallas.py:25",
                  "launches": launches, "max_abs_err": max_abs_err,
                  "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                  "bound_by": bound_by, "library_ms": None,
                  "bits_equal": req_same, "device_ms": dev_t["device_ms"],
                  "span_ms": dev_t["span_ms"], "call_ms": ms}

    # --------------------------------------------------------- 7. training
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

    # ------------------------------------------------- 8. segment timings
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
                  "launches": fit_launches,
                  "max_abs_err": max(seg_err, prepare["spmm"]["max_abs_err"]),
                  **timed["neigh"],
                  "prepare_launches": {k: v["launches"]
                                       for k, v in prepare.items()
                                       if isinstance(v, dict)
                                       and "launches" in v},
                  "prepare_spmm": prepare["spmm"]}

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
