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
                pool patches, ragged and empty rows), at a long case
                (Lc=300, a few comps of 257-300 nodes) and at anchors past
                the warp path's shared-memory strip (La = 60,000, its
                boundary in global scratch; the plain version on the CPU,
                where its 60,000 diagonals are not bound by launches), max
                abs error <= 1e-5, and whether the bits are equal is
                printed;
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
  4c. mesh    — the data axis of the training mesh (parallel/mesh.py) on
                phase 4's task at 4b's widths: (a) an NCCL process group of
                one rank in this process: Trainer(mesh=make_device_mesh(1))
                fused (its gradient all-reduce captured in the train graph
                and counted once a replay) and streaming, 2 epochs each,
                against 4b's fits without a mesh (train/val losses within
                rel 1e-6, bits equal printed; segment_matmul twice a step;
                the all-reduce's bytes a step equal to the trainable
                leaves'); a third fused fit traced with profile_dir gives
                the NCCL kernels' share of the traced kernel time; (b) two
                gloo ranks spawned on this one card (NCCL takes one rank a
                card), a streaming (debug_mode) fit of 2 epochs against the
                same fit in this process (train/val losses within rel 1e-4),
                both ranks' parameters equal bit for bit and segment_matmul
                launched twice a step on each; then a fused fit on those
                ranks refused before its first step (gloo's all-reduce
                cannot be captured), naming the backend;
  4d. node    — the node axis of the training mesh (the table, Adam's
                moments of it and the non-compact NP sims sharded over
                mesh_node_axis ranks): (a) in this process, segment_matmul
                on each shard's plan (make_gather_plan's row_range) at the
                bench's four plans for n_node 2 and 4, each against its
                plain version at segment_check's tolerance, the shards
                concatenated against the whole table's kernel output at
                the same tolerance (bits equal printed), each shard's
                device_ms, slots and byte bound printed; (b) two gloo ranks
                of a (1, 2) mesh spawned on this card, streaming
                (debug_mode) fits of 2 epochs on phase 4's task at 4b's
                widths with compact sims and with the NP sims sharded,
                against the same fits in this process: train/val losses
                within rel 1e-4, each rank's table rows within 1e-5 of the
                one-process table's, the replicated leaves bit-equal across
                the ranks, segment_matmul twice a step on each rank, and the
                node-group sums' bytes exactly 4 x (D x the ids gathered +
                the NP-sim values gathered) (printed beside an all-gather of
                the table); a fused fit on those ranks refused; (c) the
                device bytes of the table and its moments, and of a batch's
                NP sims, at (1, 1) and on a rank of (1, 2): half;
  4e. precompute mesh — SubGNNPipeline.precompute(mesh=) on phase 4's
                task (the NP-sim CC-min on each rank's column block of the
                memory-mapped path matrix, the DTW on each rank's block of
                comps, both gathered; rank 0 alone writing), each into a
                fresh similarities directory: (a) an NCCL group of one rank
                in this process: every array bit-equal to phase 4's, exactly
                6 DTW launches, the same file names; (b) two gloo ranks
                spawned on this card: each rank's border sets, NP sims, pool
                and walks bit-equal to phase 4's, its structure sims within
                STRUC_SIM_TOL (bits equal printed), 6 DTW launches on each
                rank and the pairs its wrapper counted equal to its blocks'
                (their sum (a)'s count), only rank 0 writing (phase 4's file
                names), the gathers' bytes exactly 4 x n_sub x C x (n_nodes
                + 2 x n_anchors) over the splits, and the stage times beside
                phase 4's; (c) on those ranks, at BFS_SIZES[0] nodes,
                shortest_path_matrix(mesh=) with partition 'sources' and
                'graph' equal to the C++ matrix, each's seconds, levels and
                frontier-exchange bytes (checked exactly against the levels
                the matrix implies); that matrix scattered from rank 0 in
                column blocks (scatter_world_cols) on (a)'s and (b)'s
                meshes, each block equal; then, in this process, one DTW
                launch at each rank's block of the train split's internal
                side timed alone against the launch on all its comps
                (device_ms, kernel_block_warps);
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
  5c. prepare mesh — the pretrainer's edge-sharded SpMM
                (train_node_embeddings(mesh=)), the ring collectives and the
                at-scale dry run. Every pretraining run is first made in
                this process without a mesh: (a) an NCCL group of one rank
                in this process, 5b (b)'s GCN setting (3 epochs, replayed
                numpy draws) and 5b (a)'s projected GIN setting (5 epochs,
                seeded draws) on the serving graph: bit-equal to the runs
                without a mesh, segment_matmul launched exactly
                spmm_launches' count, the world collectives' calls and bytes
                exact; (b) two gloo ranks spawned on this card, the same two
                settings and 5b (c)'s exact-k neighbor mode at PPI-BP scale:
                losses within rel 1e-4 and embeddings within 1e-4 x max|emb|
                of one process, each rank's launches spmm_launches' count at
                its block of the edges, the world collectives exact, each
                rank's seconds beside one process's; segment_matmul's
                device_ms at a rank's block of the PPI edges against all of
                them; (d) on those ranks, ring_all_reduce and
                ring_all_gather of a (17080, 128) fp32 tensor against
                dist.all_reduce (rel 1e-5) and dist.all_gather (equal), both
                timed (gloo on one card, staged through the host), one
                world all-reduce at the node sums' shape timed, and, on a
                pair of processes of its own (gloo may abort a process that
                tries it), what gloo's isend / irecv of a CUDA tensor does
                (printed: why the rings stage through the host); (c)
                entry()'s flagship forward, dryrun_multichip(1) (one NCCL
                rank, fused) and dryrun_multichip_full(2) (two gloo ranks
                of a (1, 2) mesh on this card, streaming: gloo cannot be
                captured):
                prepare, mesh precompute with 6 DTW launches a rank, fit,
                test, checkpoint and the collective audit, its result and
                seconds printed;
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
Each path's launch counts are zeroed just before it and read just after
(the node axis's in each spawned rank, in the segment_matmul record's
`node_axis`):
the DTW record's launches are the 4 serving requests' (its
`mesh_precompute` holds 4e's launches and pairs a rank, as each rank's
wrapper counted them, and the device_ms of one launch at each rank's block
shape, made in this process; its `dryrun` the launches of 5c (c)'s
dry run on each rank), segment_matmul's are
Trainer.fit's on the flagship fixture (the 20 bf16 steps and the dataset,
run and prepare phases' runs are counted on their own, for their checks;
the prepare runs' counts are in the record's `prepare_launches`, its time
at the prepare plan in `prepare_spmm`, 5c's launches on each rank of
each mesh in `pretrainer_mesh`); the C++
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


def segment_tol(g, ids, ref, out_rows, lo=0):
    """segment_check's tolerance per output element: SEG_REL_TOL x the sum
    of |g| over the row's slots (index_add_ of |g|), plus one bf16 ulp of
    the plain value `ref` for bf16; rows [lo, lo + out_rows) of the table
    (a node-axis shard's)."""
    import torch
    local = ids.reshape(-1) - lo
    keep = (local >= 0) & (local < out_rows)
    absum = torch.zeros(out_rows, g.shape[1], device=g.device).index_add_(
        0, local[keep], g.float().abs()[keep])
    tol = SEG_REL_TOL * absum
    if g.dtype == torch.bfloat16:
        tol = tol + ref.float().abs() * BF16_ULP
    return tol


def segment_check(E, g, ids, plan, out_rows, lo=0):
    """Kernel vs plain on the card: (max abs err, within tolerance and the
    same bits on a second run), at segment_tol's tolerance. `lo`: the first
    table row of a shard plan (make_gather_plan's row_range)."""
    import torch
    got = E.segment_matmul(g, plan, out_rows)
    again = E.segment_matmul(g, plan, out_rows)
    ref = E.segment_matmul_torch(g, plan, out_rows)
    tol = segment_tol(g, ids, ref, out_rows, lo)
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
    return err, runs


MESH_WORLD1_REL_TOL = 1e-6  # 4c (a): a one-rank all-reduce is exact
MESH_GLOO_REL_TOL = 1e-4    # 4c (b): the batch's sums split over 2 ranks


def mesh_rank(rank, store, rc, hp, seed, out):
    """4c (b): one of two gloo ranks on cuda:0 (spawned: its own process),
    a streaming fit on phase 4's task read from its caches; writes its
    metrics, parameters and counts to <out>.<rank>.pt."""
    sys.path.insert(0, str(HERE))
    import torch
    import torch.distributed as dist
    from subgnn_tpu_torch.ops import embedding as E
    from subgnn_tpu_torch.parallel import mesh as MX
    from subgnn_tpu_torch.train.checkpoint import to_numpy
    from subgnn_tpu_torch.train.loop import Trainer
    from subgnn_tpu_torch.train.runner import SubGNNPipeline
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=2, rank=rank)
    try:
        mesh = MX.make_device_mesh(2, device="cuda:0")
        pipe = SubGNNPipeline(rc, hp, device="cuda:0").load().precompute(
            recompute=False)
        model, params, state = pipe.build_model(seed)
        trainer = Trainer(model, hp, eval_cc_tables=pipe.eval_cc_tables(),
                          device="cuda:0", mesh=mesh)
        E.segment_matmul.launches = 0
        MX.reset_counts()
        t0 = time.perf_counter()
        trainer.fit(params, state, pipe.split_data("train"),
                    pipe.split_data("val"), pipe.sample_anchors(seed),
                    seed=seed, log_fn=None)
        secs = time.perf_counter() - t0
        result = {"metrics": trainer.metric_scores,
                  "params": to_numpy(trainer.params),
                  "launches": E.segment_matmul.launches,
                  "steps": trainer.global_step, "fused": trainer.fused,
                  "secs": secs, "reduce_calls": MX.all_reduce_sum_.calls,
                  "reduce_bytes": MX.all_reduce_sum_.bytes}
        # a fused fit would capture gloo's all-reduce: refused before its
        # first step, naming the backend
        fused = Trainer(model, hp.replace(debug_mode=False),
                        device="cuda:0", mesh=mesh)
        try:
            fused.fit(params, state, pipe.split_data("train"),
                      pipe.split_data("val"), pipe.sample_anchors(seed),
                      seed=seed, log_fn=None)
            result["fused_refused"] = ""
        except ValueError as e:
            result["fused_refused"] = str(e)
        result["fused_steps"] = fused.global_step
        torch.save(result, f"{out}.{rank}.pt")
    finally:
        dist.destroy_process_group()


def trace_kernel_us(trace_dir: Path):
    """(NCCL kernels' microseconds, all kernels' microseconds) in the
    torch.profiler chrome trace written into `trace_dir`."""
    nccl = total = 0.0
    for path in trace_dir.rglob("*.pt.trace.json"):
        for ev in json.loads(path.read_text()).get("traceEvents", []):
            if ev.get("cat") == "kernel":
                total += ev.get("dur", 0.0)
                if "nccl" in ev.get("name", "").lower():
                    nccl += ev.get("dur", 0.0)
    return nccl, total


def mesh_phase(pipe, seed: int, fused_runs, root: Path):
    """Phase 4c: Trainer(mesh=...) on phase 4's task at 4b's widths, (a)
    on an NCCL group of one rank in this process against 4b's mesh-less
    fits, (b) on two gloo ranks on this card against this process."""
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from subgnn_tpu_torch.kernel_times import event_ms
    from subgnn_tpu_torch.ops import embedding as E
    from subgnn_tpu_torch.parallel import mesh as MX
    from subgnn_tpu_torch.train import graphs
    from subgnn_tpu_torch.train.checkpoint import to_numpy
    from subgnn_tpu_torch.train.loop import (Trainer, mpn_edges_per_step,
                                             tree_leaves)

    class Streaming(Trainer):
        _split_bytes = staticmethod(lambda data: 1 << 40)

    t_phase = time.perf_counter()
    anchors = pipe.sample_anchors(seed)
    train, val = pipe.split_data("train"), pipe.split_data("val")
    hp = pipe.hp.replace(max_epochs=2, lin_dropout=0.0)
    calls_at = graphs.COUNTED.index((MX.all_reduce_sum_, "calls"))
    bytes_at = graphs.COUNTED.index((MX.all_reduce_sum_, "bytes"))

    def fit(cls, mesh, hp, profile_dir=None):
        model, params, state = pipe.build_model(seed)
        model.hp = hp
        trainer = cls(model, hp, eval_cc_tables=pipe.eval_cc_tables(),
                      device=pipe.device, mesh=mesh)
        E.segment_matmul.launches = 0
        MX.reset_counts()
        t0 = time.perf_counter()
        trainer.fit(params, state, train, val, anchors, seed=seed,
                    log_fn=None, profile_dir=profile_dir)
        return trainer, time.perf_counter() - t0, E.segment_matmul.launches

    # (a) one NCCL rank: the all-reduce issued (and captured) at world 1
    dist.init_process_group("nccl", init_method=f"file://{root}/nccl_store",
                            world_size=1, rank=0)
    try:
        mesh = MX.make_device_mesh(1, device=pipe.device)
        print(f"[mesh] (a) {mesh}")
        for mode, cls in (("fused", Trainer), ("streaming", Streaming)):
            trainer, secs, launches = fit(cls, mesh, hp)
            m, steps = trainer.metric_scores, trainer.global_step
            check(trainer.fused is (mode == "fused"),
                  f"mesh phase (a): the {mode} run took the other mode")
            check(launches == 2 * steps, f"mesh phase (a) {mode}: "
                  f"{launches} segment_matmul launches in {steps} steps")
            # a step's gradients, plus the losses once an epoch
            check(MX.all_reduce_sum_.calls == steps + len(m),
                  f"mesh phase (a) {mode}: {MX.all_reduce_sum_.calls} "
                  f"gradient all-reduces in {steps} steps")
            leaf_bytes = sum(x.numel() * x.element_size()
                             for x in trainer.tx.trainable(trainer.params))
            per_step = ((MX.all_reduce_sum_.bytes - 4 * steps)
                        / max(steps, 1))
            check(per_step == leaf_bytes, f"mesh phase (a) {mode}: "
                  f"{per_step} all-reduced bytes a step, trainable leaves "
                  f"{leaf_bytes}")
            replay = ""
            if mode == "fused":
                train_graph = trainer._graphs[0]
                check(train_graph.captures == 1
                      and train_graph.per_replay[calls_at] == 1
                      and train_graph.per_replay[bytes_at] == leaf_bytes,
                      f"mesh phase (a): the train graph holds "
                      f"{train_graph.per_replay[calls_at]} all-reduces of "
                      f"{train_graph.per_replay[bytes_at]} bytes a replay")
                replay = (f", per train replay: all-reduce calls "
                          f"{train_graph.per_replay[calls_at]}, bytes "
                          f"{train_graph.per_replay[bytes_at]}")
            pair = [(a[k], b[k]) for a, b in zip(m, fused_runs[mode, 0.0])
                    for k in ("train_loss", "val_loss")]
            worst = max(rel_diff(a, b) for a, b in pair)
            print(f"[mesh] (a) NCCL world 1, {mode} fit: {secs:.2f}s, "
                  f"{steps} steps, segment_matmul launches {launches}, "
                  f"captures {trainer.fused_captures}, gradient all-reduce "
                  f"bytes a step {int(per_step)} (trainable leaves "
                  f"{leaf_bytes}){replay}; epoch_time_s "
                  f"{[x['epoch_time_s'] for x in m]!r}, train_edges_per_s "
                  f"{[x['train_edges_per_s'] for x in m]!r}; vs 4b's {mode} "
                  f"fit without a mesh: train/val losses max rel diff "
                  f"{worst!r} (tol {MESH_WORLD1_REL_TOL}), bits equal "
                  f"{all(a == b for a, b in pair)}")
            check(worst <= MESH_WORLD1_REL_TOL, f"mesh phase (a): the "
                  f"{mode} fit on one NCCL rank disagrees with 4b's")
            if mode == "fused":
                fused_trainer = trainer
        # the gradient all-reduce alone, eager and captured (StepGraph),
        # on copies of the trainable leaves, against a warm fused step
        leaves = [x.detach().clone()
                  for x in fused_trainer.tx.trainable(fused_trainer.params)]
        graph = graphs.StepGraph(lambda: MX.all_reduce_sum_(leaves, mesh),
                                 pipe.device)
        eager_ms = event_ms(lambda: MX.all_reduce_sum_(leaves, mesh), 50)
        graph()
        graph()
        replay_ms = event_ms(graph, 50)
        step_ms = 1e3 * mpn_edges_per_step(hp, hp.batch_size,
                                           train.cc_ids.shape[1]) / \
            fused_trainer.metric_scores[-1]["train_edges_per_s"]
        print(f"[mesh] (a) gradient all-reduce of {len(leaves)} leaves "
              f"({sum(x.numel() for x in leaves) * 4} bytes) on one NCCL "
              f"rank: eager {eager_ms!r} ms, replayed {replay_ms!r} ms; a "
              f"warm fused train step {step_ms!r} ms (from "
              f"train_edges_per_s), the replayed all-reduce's share "
              f"{replay_ms / step_ms!r}")
        # the NCCL kernels' share of the traced kernel time of a fused fit
        trace_dir = root / "mesh_trace"
        trainer, secs, _ = fit(Trainer, mesh, hp, profile_dir=trace_dir)
        nccl_us, kernel_us = trace_kernel_us(trace_dir)
        steps = trainer.global_step
        print(f"[mesh] (a) traced fused fit (profile_dir): {secs:.2f}s, "
              f"{steps} train steps; NCCL kernels {nccl_us!r} us of "
              f"{kernel_us!r} us of kernel time (train and eval), share "
              f"{nccl_us / kernel_us if kernel_us else float('nan')!r}; "
              f"{nccl_us / max(steps, 1)!r} us of NCCL a train step")
    finally:
        dist.destroy_process_group()

    # (b) two gloo ranks on this card, streaming (debug_mode)
    ghp = hp.replace(debug_mode=True)
    one, one_secs, one_launches = fit(Trainer, None, ghp)
    check(not one.fused, "mesh phase (b): the debug_mode fit was fused")
    out = root / "mesh_gloo"
    t0 = time.perf_counter()
    mp.start_processes(mesh_rank, args=(str(root / "gloo_store"), pipe.rc,
                                        ghp, seed, str(out)),
                       nprocs=2, start_method="spawn")
    spawn_secs = time.perf_counter() - t0
    ranks = [torch.load(f"{out}.{r}.pt", weights_only=False)
             for r in range(2)]
    pair = [(a[k], b[k]) for a, b in zip(ranks[0]["metrics"],
                                         one.metric_scores)
            for k in ("train_loss", "val_loss")]
    worst = max(rel_diff(a, b) for a, b in pair)
    same_params = all(np.array_equal(a, b) for a, b in zip(
        tree_leaves(ranks[0]["params"]),
        tree_leaves(ranks[1]["params"])))
    one_params = tree_leaves(to_numpy(one.params))
    param_diff = max(float(np.abs(a - b).max()) for a, b in zip(
        tree_leaves(ranks[0]["params"]), one_params))
    for r, res in enumerate(ranks):
        check(not res["fused"] and res["launches"] == 2 * res["steps"]
              and res["launches"] > 0, f"mesh phase (b) rank {r}: "
              f"{res['launches']} segment_matmul launches in "
              f"{res['steps']} steps")
        check("'gloo'" in res["fused_refused"] and res["fused_steps"] == 0,
              f"mesh phase (b) rank {r}: a fused fit over gloo on the card "
              f"was not refused before its first step "
              f"({res['fused_refused']!r})")
    print(f"[mesh] (b) 2 gloo ranks on cuda:0, streaming (debug_mode) fit: "
          f"spawn to exit {spawn_secs:.2f}s, fits "
          f"{[round(r['secs'], 3) for r in ranks]}s (one process "
          f"{one_secs:.2f}s); epoch_time_s rank 0 "
          f"{[x['epoch_time_s'] for x in ranks[0]['metrics']]!r}, one "
          f"process {[x['epoch_time_s'] for x in one.metric_scores]!r}; "
          f"segment_matmul launches per rank "
          f"{[r['launches'] for r in ranks]} in {ranks[0]['steps']} steps; "
          f"gradient all-reduces {ranks[0]['reduce_calls']} "
          f"({ranks[0]['reduce_bytes']} bytes); train/val losses vs one "
          f"process max rel diff {worst!r} (tol {MESH_GLOO_REL_TOL}); "
          f"params vs one process max abs diff {param_diff!r}; ranks' "
          f"params bit-equal {same_params}; a fused fit refused: "
          f"{ranks[0]['fused_refused']!r}")
    check(worst <= MESH_GLOO_REL_TOL, "mesh phase (b): two gloo ranks "
          "disagree with one process")
    check(same_params, "mesh phase (b): the two ranks' parameters differ")
    print(f"[mesh] phase seconds {time.perf_counter() - t_phase:.2f}")



NODE_REL_TOL = 1e-4         # 4d (b): losses, two node ranks vs one process
NODE_SHARD_ATOL = 1e-5      # 4d (b): a rank's table rows vs one process's
NODE_SHARDS = (2, 4)        # 4d (a): n_node of the shard plans
NODE_TRACED_CALLS = 10      # 4d (a): traced calls a shard's device_ms


def node_plan_phase(E, benches, gen, dev):
    """4d (a): segment_matmul on each node shard's plan (make_gather_plan's
    row_range) at the bench's four plans, against its plain version, and
    the shards together against the whole table's kernel output. Returns
    (max abs err, {plan: [[device_ms of each shard] for each n_node]})."""
    import torch
    from subgnn_tpu_torch.kernel_times import (bench_plans, device_times,
                                               segment_bound_ms)
    t0 = time.perf_counter()
    worst, times = 0.0, {}
    for dt, (_, _, params_b, _, batch_b, anchors_b) in benches.items():
        rows = params_b["node_embed"].shape[0]
        tdt = torch.bfloat16 if dt == "bfloat16" else torch.float32
        for name, ids, plan in bench_plans(batch_b, anchors_b):
            ids_np = ids.cpu().numpy()
            g = torch.randn(ids.numel(), 128, generator=gen,
                            device=dev).to(tdt)
            whole = E.segment_matmul(g, plan, rows)
            tol = segment_tol(g, ids, E.segment_matmul_torch(g, plan, rows),
                              rows)
            key = f"{dt}_{name}"
            times[key] = []
            for n_node in NODE_SHARDS:
                n = rows // n_node
                parts, shard_ms = [], []
                for k in range(n_node):
                    lo = k * n
                    splan = E.make_gather_plan(
                        ids_np, rows, row_range=(lo, lo + n)).to(dev)
                    err, ok = segment_check(E, g, ids, splan, n, lo)
                    worst = max(worst, err)
                    check(ok, f"node phase (a): segment_matmul disagrees "
                              f"with its plain version at the {key} plan's "
                              f"shard {k} of {n_node}")
                    parts.append(E.segment_matmul(g, splan, n))
                    dev_t = device_times(
                        lambda: E.segment_matmul(g, splan, n),
                        NODE_TRACED_CALLS)
                    slots = int((splan.local < E.TABLE_BLOCK).sum())
                    bound = segment_bound_ms(g, splan, n)
                    shard_ms.append(dev_t["device_ms"])
                    print(f"[node] (a) segment_matmul {key} shard {k} of "
                          f"{n_node} (rows {lo}-{lo + n}, slots {slots} of "
                          f"{ids.numel()}, tiles {splan.pos.shape[0]}): "
                          f"max_abs_err {err!r}, device_ms "
                          f"{dev_t['device_ms']!r}, bound {bound!r} ms "
                          f"(bytes)")
                joined = torch.cat(parts)
                diff = (joined.float() - whole.float()).abs()
                same = torch.equal(joined, whole)
                print(f"[node] (a) {key} at n_node {n_node}: shards "
                      f"concatenated vs the whole table's kernel output max "
                      f"abs diff {float(diff.max())!r}, bits equal {same}")
                check(bool((diff <= tol).all()), f"node phase (a): the "
                      f"{key} shards at n_node {n_node} disagree with the "
                      f"whole table's gradient")
                times[key].append(shard_ms)
    print(f"[node] (a) {time.perf_counter() - t0:.2f}s")
    return worst, times


def node_rank(rank, store, rc, hp, seed, out):
    """4d (b): one of two gloo ranks of a (1, 2) mesh on cuda:0 (spawned),
    streaming fits with compact and with sharded NP sims on phase 4's task
    read from its caches; writes each fit's metrics, table shard,
    replicated leaves, counts and what it held to <out>.<rank>.pt."""
    sys.path.insert(0, str(HERE))
    import torch
    import torch.distributed as dist
    from subgnn_tpu_torch.ops import embedding as E
    from subgnn_tpu_torch.parallel import mesh as MX
    from subgnn_tpu_torch.train.checkpoint import to_numpy
    from subgnn_tpu_torch.train.loop import Trainer
    from subgnn_tpu_torch.train.runner import SubGNNPipeline
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=2, rank=rank)
    try:
        mesh = MX.make_device_mesh(1, 2, device="cuda:0")
        pipe = SubGNNPipeline(rc, hp, device="cuda:0").load().precompute(
            recompute=False)
        result = {}
        for compact in (True, False):
            model, params, state = pipe.build_model(seed)
            trainer = Trainer(model, hp, eval_cc_tables=pipe.eval_cc_tables(),
                              device="cuda:0", mesh=mesh)
            trainer.compact_sims = compact
            E.segment_matmul.launches = 0
            MX.reset_counts()
            t0 = time.perf_counter()
            trainer.fit(params, state, pipe.split_data("train"),
                        pipe.split_data("val"), pipe.sample_anchors(seed),
                        seed=seed, log_fn=None)
            secs = time.perf_counter() - t0
            result[compact] = {
                "metrics": trainer.metric_scores,
                "shard": to_numpy(trainer.params["node_embed"]),
                "rows": trainer._rows,
                "replicated": to_numpy({k: v for k, v in
                                        trainer.params.items()
                                        if k != "node_embed"}),
                "launches": E.segment_matmul.launches,
                "steps": trainer.global_step, "fused": trainer.fused,
                "secs": secs, "held": trainer.held,
                "node_calls": MX.node_sum.calls,
                "node_bytes": MX.node_sum.bytes,
                "reduce_bytes": MX.all_reduce_sum_.bytes}
        fused = Trainer(model, hp.replace(debug_mode=False),
                        device="cuda:0", mesh=mesh)
        try:
            fused.fit(params, state, pipe.split_data("train"),
                      pipe.split_data("val"), pipe.sample_anchors(seed),
                      seed=seed, log_fn=None)
            result["fused_refused"] = ""
        except ValueError as e:
            result["fused_refused"] = str(e)
        result["fused_steps"] = fused.global_step
        torch.save(result, f"{out}.{rank}.pt")
    finally:
        dist.destroy_process_group()


def held_bytes(held, compact):
    """(table + Adam's moments of it, NP sims) bytes a fit held."""
    table = sum(held[k][1] for k in ("node_embed", "mu", "nu"))
    return table, (None if compact else held["NP_sim"][1])


def node_phase(pipe, seed: int, root: Path, benches, gen, dev):
    """Phase 4d: the node axis of the training mesh. (a) segment_matmul on
    node shard plans in this process; (b) two gloo ranks of a (1, 2) mesh
    on this card against this process; (c) what a rank holds."""
    import torch
    import torch.multiprocessing as mp
    from subgnn_tpu_torch.ops import embedding as E
    from subgnn_tpu_torch.train.checkpoint import to_numpy
    from subgnn_tpu_torch.train.loop import (Trainer, node_gathers_per_step,
                                             tree_leaves)

    t_phase = time.perf_counter()
    err, shard_ms = node_plan_phase(E, benches, gen, dev)

    # (b) the same streaming (debug_mode) fits in this process and on two
    # gloo ranks of a (1, 2) mesh on this card
    hp = pipe.hp.replace(max_epochs=2, lin_dropout=0.0, debug_mode=True)
    anchors = pipe.sample_anchors(seed)
    train, val = pipe.split_data("train"), pipe.split_data("val")
    one = {}
    for compact in (True, False):
        model, params, state = pipe.build_model(seed)
        model.hp = hp
        trainer = Trainer(model, hp, eval_cc_tables=pipe.eval_cc_tables(),
                          device=pipe.device)
        trainer.compact_sims = compact
        t0 = time.perf_counter()
        trainer.fit(params, state, train, val, anchors, seed=seed,
                    log_fn=None)
        one[compact] = (trainer, time.perf_counter() - t0)
    out = root / "node_gloo"
    t0 = time.perf_counter()
    mp.start_processes(node_rank, args=(str(root / "node_store"), pipe.rc,
                                        hp, seed, str(out)),
                       nprocs=2, start_method="spawn")
    spawn_secs = time.perf_counter() - t0
    ranks = [torch.load(f"{out}.{r}.pt", weights_only=False)
             for r in range(2)]
    D = hp.node_embed_size
    launches = {}
    for compact in (True, False):
        tr, one_secs = one[compact]
        tag = "compact sims" if compact else "NP sims sharded"
        res = [r[compact] for r in ranks]
        pair = [(a[k], b[k]) for a, b in zip(res[0]["metrics"],
                                             tr.metric_scores)
                for k in ("train_loss", "val_loss")]
        worst = max(rel_diff(a, b) for a, b in pair)
        whole = to_numpy(tr.params)
        shard_diff = max(float(np.abs(
            r["shard"] - whole["node_embed"][r["rows"][0]:r["rows"][1]]
        ).max()) for r in res)
        same_leaves = all(np.array_equal(a, b) for a, b in zip(
            tree_leaves(res[0]["replicated"]),
            tree_leaves(res[1]["replicated"])))
        # the node-group sums carry every forward's gathered rows and, with
        # the NP sims sharded, its NP-sim values: train steps, val batches
        ids_t, cols_t = node_gathers_per_step(
            hp, hp.batch_size, *train.cc_ids.shape[1:], compact)
        ids_v, cols_v = node_gathers_per_step(
            hp, hp.batch_size, *val.cc_ids.shape[1:], compact)
        n_val = -(-len(val) // hp.batch_size) * len(res[0]["metrics"])
        for r, x in enumerate(res):
            steps = x["steps"]
            want = 4 * (steps * (ids_t * D + cols_t)
                        + n_val * (ids_v * D + cols_v))
            check(not x["fused"] and x["launches"] == 2 * steps > 0,
                  f"node phase (b) rank {r} ({tag}): {x['launches']} "
                  f"segment_matmul launches in {steps} steps")
            check(x["node_bytes"] == want, f"node phase (b) rank {r} "
                  f"({tag}): node-group sums of {x['node_bytes']} bytes, "
                  f"the gathers hold {want}")
        launches[compact] = [x["launches"] for x in res]
        table_b, np_b = held_bytes(res[0]["held"], compact)
        one_table_b, one_np_b = held_bytes(tr.held, compact)
        steps = res[0]["steps"]
        print(f"[node] (b) 2 gloo ranks of a (1, 2) mesh on cuda:0, "
              f"streaming (debug_mode) fit, {tag}: fits "
              f"{[round(x['secs'], 3) for x in res]}s (one process "
              f"{one_secs:.2f}s); epoch_time_s rank 0 "
              f"{[x['epoch_time_s'] for x in res[0]['metrics']]!r}, one "
              f"process {[x['epoch_time_s'] for x in tr.metric_scores]!r}; "
              f"segment_matmul launches per rank "
              f"{launches[compact]} in {steps} steps; node-group sums "
              f"{res[0]['node_calls']} calls, {res[0]['node_bytes']} bytes "
              f"(= 4 x (D x ids + NP values) gathered, checked exactly), "
              f"{(ids_t * D + cols_t) * 4} bytes a train step against "
              f"{whole['node_embed'].size * 4} for an all-gather of the "
              f"table; gradient all-reduce bytes {res[0]['reduce_bytes']}; "
              f"train/val losses vs one process max rel diff {worst!r} (tol "
              f"{NODE_REL_TOL}); table shards vs the one-process table's "
              f"rows max abs diff {shard_diff!r} (tol {NODE_SHARD_ATOL}); "
              f"replicated leaves bit-equal across ranks {same_leaves}")
        print(f"[node] (c) {tag}: device bytes of the table + Adam's "
              f"moments of it, (1, 1) {one_table_b} vs (1, 2) a rank "
              f"{table_b} ({table_b / one_table_b!r})"
              + ("" if compact else
                 f"; NP sims of a streaming batch (1, 1) {one_np_b} vs "
                 f"(1, 2) {np_b} ({np_b / one_np_b!r})"))
        check(worst <= NODE_REL_TOL, f"node phase (b) ({tag}): two node "
              "ranks disagree with one process")
        check(shard_diff <= NODE_SHARD_ATOL, f"node phase (b) ({tag}): a "
              "rank's table shard differs from the one-process table's rows")
        check(same_leaves, f"node phase (b) ({tag}): the two ranks' "
              "replicated leaves differ")
        check(2 * table_b == one_table_b and (compact or 2 * np_b == one_np_b),
              f"node phase (c) ({tag}): a rank of (1, 2) does not hold half")
    for r, res in enumerate(ranks):
        check("'gloo'" in res["fused_refused"] and res["fused_steps"] == 0,
              f"node phase (b) rank {r}: a fused fit over gloo on the card "
              f"was not refused before its first step "
              f"({res['fused_refused']!r})")
    print(f"[node] (b) spawn to exit {spawn_secs:.2f}s; a fused fit "
          f"refused: {ranks[0]['fused_refused']!r}")
    print(f"[node] phase seconds {time.perf_counter() - t_phase:.2f}")
    return err, {"launches_per_rank": launches[False],
                 "shard_device_ms": shard_ms}


PRE_WORLD = 2               # 4e (b), (c): gloo ranks on the one card
PRE_BFS_SEED = 5            # 4e (c): its graph's generator is seed + this


def precompute_bytes(pipe):
    """The precompute gathers' bytes (all_gather_world) of one precompute
    of `pipe`'s task with its path matrix on disk: a split's NP sims, 4 x
    n_sub x C x n_nodes, and its structure sims, 4 x n_sub x C x n_anchors
    for each side."""
    n_anchors = pipe.structure_anchors.shape[0]
    return sum(4 * cc.shape[0] * cc.shape[1]
               * (pipe.graph.n_nodes + 2 * n_anchors)
               for cc in pipe.cc_ids.values())


def mesh_precompute(pipe, mesh):
    """pipe.precompute(mesh=mesh, recompute=True): its seconds, stage
    seconds, DTW launches and pairs as the kernel's wrapper counted them
    in this process, the pairs this rank's comp blocks should hold
    (`world_block` of each split's comps x 2 sides x the anchors), the
    precompute collectives' {name: (calls, bytes)} and the names of the
    files it saved."""
    import torch
    from subgnn_tpu_torch.ops import dtw as kdtw
    from subgnn_tpu_torch.parallel import mesh as MX
    saved, save = [], np.save

    def counted_save(path, arr, *a, **k):
        saved.append(Path(path).name)
        save(path, arr, *a, **k)

    kdtw.dtw_distance_grouped.launches = 0
    kdtw.dtw_distance_grouped.pairs = 0
    MX.reset_counts()
    np.save = counted_save
    try:
        t0 = time.perf_counter()
        pipe.precompute(recompute=True, mesh=mesh)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        np.save = save
    na = pipe.structure_anchors.shape[0]
    expect = 0
    for cc in pipe.cc_ids.values():
        lo, hi = mesh.world_block(cc.shape[0] * cc.shape[1])
        expect += 2 * (hi - lo) * na
    return {"secs": secs, "timings": dict(pipe.precompute_timings),
            "launches": kdtw.dtw_distance_grouped.launches,
            "pairs": kdtw.dtw_distance_grouped.pairs,
            "pairs_expected": expect,
            "counts": {h.__name__: (h.calls, h.bytes)
                       for h in MX.PRECOMPUTE_COLLECTIVES},
            "saved": sorted(saved)}


def precompute_diff(got, ref):
    """(border sets, NP sims, pool and walks all bit-equal; the structure
    sims' max abs diff; their bits equal) of two precomputed pipelines."""
    from subgnn_tpu_torch.train.runner import SPLITS
    exact = all(np.array_equal(got.np_sim[s], ref.np_sim[s])
                and np.array_equal(got.border[s], ref.border[s])
                for s in SPLITS) and all(
        np.array_equal(getattr(got, k), getattr(ref, k))
        for k in ("structure_anchors", "int_walks", "bor_walks"))
    worst, same = 0.0, True
    for s in SPLITS:
        for k in ("int_s_sim", "bor_s_sim"):
            a, b = getattr(got, k)[s], getattr(ref, k)[s]
            worst = max(worst, float(np.abs(a - b).max()))
            same = same and np.array_equal(a, b)
    return exact, worst, same


def scatter_check(want, mesh):
    """scatter_world_cols of rank 0's `want` (n, n): (this rank's block
    equal to its columns of `want`, the scatter's (calls, bytes))."""
    from subgnn_tpu_torch.parallel import mesh as MX
    n = len(want)
    lo, hi = mesh.world_block(n)
    MX.reset_counts()
    block = MX.scatter_world_cols(want if mesh.lead else None, n, n, mesh)
    equal = np.array_equal(block.cpu().numpy(),
                           want[:, lo:hi].astype(np.float32))
    return equal, (MX.scatter_world_cols.calls, MX.scatter_world_cols.bytes)


def precompute_rank(rank, store, rc, ref_rc, hp, bfs_dir, out):
    """4e (b), (c): one of PRE_WORLD gloo ranks of a (PRE_WORLD, 1) mesh on
    cuda:0 (spawned): (b) phase 4's precompute on the mesh into a fresh
    similarities directory, against phase 4's caches; (c) the BFS of
    bfs_dir's graph with its sources and with its graph partitioned,
    against its C++ matrix, and that matrix scattered from rank 0 in
    column blocks. Writes <out>.<rank>.pt."""
    sys.path.insert(0, str(HERE))
    import torch
    import torch.distributed as dist
    from subgnn_tpu_torch.data.graph import CSRGraph
    from subgnn_tpu_torch.parallel import mesh as MX
    from subgnn_tpu_torch.precompute.shortest_paths import \
        shortest_path_matrix
    from subgnn_tpu_torch.train.runner import SubGNNPipeline
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=PRE_WORLD, rank=rank)
    try:
        mesh = MX.make_device_mesh(PRE_WORLD, device="cuda:0")
        pipe = SubGNNPipeline(rc, hp, device="cuda:0").load()
        result = mesh_precompute(pipe, mesh)
        ref = SubGNNPipeline(ref_rc, hp, device="cuda:0").load().precompute(
            recompute=False)
        result["exact"], result["struc_diff"], result["struc_same"] = \
            precompute_diff(pipe, ref)
        want = np.load(Path(bfs_dir) / "matrix.npy")
        graph = CSRGraph.from_edges(np.load(Path(bfs_dir) / "edges.npy"),
                                    n_nodes=len(want))
        result["bfs"] = {}
        for partition in ("sources", "graph"):
            MX.reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = shortest_path_matrix(graph, mesh=mesh, partition=partition)
            secs = time.perf_counter() - t0
            result["bfs"][partition] = {
                "secs": secs, "equal": bool(np.array_equal(got, want)),
                "counts": {h.__name__: (h.calls, h.bytes)
                           for h in MX.PRECOMPUTE_COLLECTIVES}}
        result["scatter"] = scatter_check(want, mesh)
        torch.save(result, f"{out}.{rank}.pt")
    finally:
        dist.destroy_process_group()


def precompute_mesh_phase(pipe, seed: int, root: Path):
    """Phase 4e: SubGNNPipeline.precompute(mesh=) on phase 4's task, (a) on
    an NCCL group of one rank in this process and (b) on PRE_WORLD gloo
    ranks on this card, against phase 4's precompute; (c) on those ranks,
    the BFS with its sources and with its graph partitioned against the
    C++ matrix; on both, that matrix scattered from rank 0 in column
    blocks (`scatter_world_cols`: a path matrix built without a file).
    Returns the DTW record's `mesh_precompute` entry."""
    import dataclasses

    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from subgnn_tpu_torch.data.graph import CSRGraph
    from subgnn_tpu_torch.kernel_times import device_times
    from subgnn_tpu_torch.ops import dtw as kdtw
    from subgnn_tpu_torch.parallel import mesh as MX
    from subgnn_tpu_torch.precompute.degree import degree_sequences
    from subgnn_tpu_torch.precompute.shortest_paths import (
        DEVICE_BFS_CHUNK, shortest_path_matrix)
    from subgnn_tpu_torch.train.runner import SPLITS, SubGNNPipeline

    t_phase = time.perf_counter()
    names = sorted(p.name for p in pipe.rc.similarities_path().iterdir())
    gathers = {"all_gather_world": (len(SPLITS) * 3, precompute_bytes(pipe)),
               "all_reduce_world_": (0, 0), "scatter_world_cols": (0, 0)}
    one = json.dumps({k: round(v, 4)
                      for k, v in pipe.precompute_timings.items()})

    def rc_into(name):
        return dataclasses.replace(pipe.rc,
                                   similarities_path_override=root / name)

    def check_run(res, tag, writes):
        check(res["launches"] == 2 * len(SPLITS), f"precompute mesh phase "
              f"{tag}: {res['launches']} DTW launches, expected "
              f"{2 * len(SPLITS)} (one per split and side)")
        check(res["pairs"] == res["pairs_expected"], f"precompute mesh "
              f"phase {tag}: the DTW launches took {res['pairs']} pairs, "
              f"its blocks of comps hold {res['pairs_expected']}")
        check(res["counts"] == gathers, f"precompute mesh phase {tag}: "
              f"collectives {res['counts']}, expected {gathers}")
        check(res["saved"] == (names if writes else []), f"precompute mesh "
              f"phase {tag}: saved {res['saved']}, phase 4 wrote {names}")

    # (c)'s graph and its C++ matrix, also scattered in (a) and (b)
    n = BFS_SIZES[0]
    brng = np.random.default_rng(seed + PRE_BFS_SEED)
    edges = brng.integers(1, n + 1, (n * AVG_DEGREE // 2, 2))
    edges = edges[edges[:, 0] != edges[:, 1]]
    t0 = time.perf_counter()
    want = shortest_path_matrix(CSRGraph.from_edges(edges, n_nodes=n),
                                backend="host")
    cpp_secs = time.perf_counter() - t0
    scatter_bytes = 4 * n * n

    # (a) one NCCL rank in this process
    dist.init_process_group("nccl",
                            init_method=f"file://{root}/nccl_pre_store",
                            world_size=1, rank=0)
    try:
        mesh = MX.make_device_mesh(1, device=pipe.device)
        p1 = SubGNNPipeline(rc_into("sims_mesh1"), pipe.hp,
                            device=pipe.device).load()
        a = mesh_precompute(p1, mesh)
        a["scatter"] = scatter_check(want, mesh)
    finally:
        dist.destroy_process_group()
    exact, worst, same = precompute_diff(p1, pipe)
    del p1
    print(f"[precompute mesh] (a) NCCL world 1: {a['secs']:.2f}s, stages "
          f"(s) {json.dumps(a['timings'])} (phase 4, no mesh: {one}); DTW "
          f"launches {a['launches']}, pairs counted {a['pairs']} (its "
          f"block: {a['pairs_expected']}); collectives "
          f"{a['counts']} (expected {gathers}); vs phase 4: border sets, "
          f"NP sims, pool, walks bit-equal {exact}, structure sims max abs "
          f"diff {worst!r}, bits equal {same}")
    check(exact and same, "precompute mesh phase (a): one NCCL rank is not "
                          "bit-equal to phase 4's precompute")
    check_run(a, "(a)", True)
    check(sorted(p.name for p in (root / "sims_mesh1").iterdir()) == names,
          "precompute mesh phase (a): another file set than phase 4's")
    print(f"[precompute mesh] (a) the {n}-node matrix scattered on one NCCL "
          f"rank: equal {a['scatter'][0]}, (calls, bytes) {a['scatter'][1]}")
    check(a["scatter"] == (True, (1, scatter_bytes)), "precompute mesh phase "
          "(a): the scattered matrix differs")

    # (b), (c): PRE_WORLD gloo ranks on this card
    bfs_dir = root / "bfs_mesh"
    bfs_dir.mkdir()
    np.save(bfs_dir / "edges.npy", edges)
    np.save(bfs_dir / "matrix.npy", want)
    out = root / "pre_gloo"
    t0 = time.perf_counter()
    mp.start_processes(precompute_rank,
                       args=(str(root / "pre_gloo_store"),
                             rc_into("sims_mesh2"), pipe.rc, pipe.hp,
                             str(bfs_dir), str(out)),
                       nprocs=PRE_WORLD, start_method="spawn")
    spawn_secs = time.perf_counter() - t0
    ranks = [torch.load(f"{out}.{r}.pt", weights_only=False)
             for r in range(PRE_WORLD)]
    for r, res in enumerate(ranks):
        print(f"[precompute mesh] (b) rank {r} of {PRE_WORLD} gloo ranks on "
              f"cuda:0: {res['secs']:.2f}s, stages (s) "
              f"{json.dumps(res['timings'])} (phase 4, no mesh: {one}); DTW "
              f"launches {res['launches']}, pairs counted {res['pairs']} "
              f"(its block: {res['pairs_expected']}); "
              f"collectives {res['counts']} (expected {gathers}); files "
              f"saved {len(res['saved'])}; vs phase 4: border sets, NP sims, "
              f"pool, walks bit-equal {res['exact']}, structure sims max abs "
              f"diff {res['struc_diff']!r} (tol {STRUC_SIM_TOL}), bits equal "
              f"{res['struc_same']}")
        check(res["exact"], f"precompute mesh phase (b) rank {r}: the NP "
                            f"sims or host arrays differ from phase 4's")
        check(res["struc_diff"] <= STRUC_SIM_TOL, f"precompute mesh phase "
              f"(b) rank {r}: structure sims disagree with phase 4's")
        check_run(res, f"(b) rank {r}", r == 0)
    check(sorted(p.name for p in (root / "sims_mesh2").iterdir()) == names,
          "precompute mesh phase (b): another file set than phase 4's")
    check(sum(r["pairs"] for r in ranks) == a["pairs"], "precompute mesh "
          "phase (b): the pairs the ranks' DTW launches took do not add up "
          "to the one rank's of (a)")
    print(f"[precompute mesh] (b) the {n}-node matrix scattered from rank 0 "
          f"(staged on the host): each rank's block equal "
          f"{[r['scatter'][0] for r in ranks]}, (calls, bytes) "
          f"{ranks[0]['scatter'][1]}")
    for r, res in enumerate(ranks):
        check(res["scatter"] == (True, (1, scatter_bytes)), f"precompute "
              f"mesh phase (b) rank {r}: its scattered block differs")

    # (c): levels and bytes from the C++ matrix (1 + a chunk's largest hop
    # count levels, each a 4 x S x n_pad frontier exchange)
    chunk = DEVICE_BFS_CHUNK
    n_pad = -(-n // PRE_WORLD) * PRE_WORLD
    levels = [1 + int(want[s:s + chunk].max()) for s in range(0, n, chunk)]
    frontier = sum(lv * 4 * min(chunk, n - i * chunk) * n_pad
                   for i, lv in enumerate(levels))
    q = -(-chunk // PRE_WORLD) * PRE_WORLD
    n_chunks = -(-n // q)
    expect = {"sources": {"all_gather_world": (n_chunks,
                                               n_chunks * 4 * q * n),
                          "all_reduce_world_": (0, 0),
                          "scatter_world_cols": (0, 0)},
              "graph": {"all_gather_world": (sum(levels) + 1,
                                             frontier + 4 * n * n_pad),
                        "all_reduce_world_": (sum(levels), 8 * sum(levels)),
                        "scatter_world_cols": (0, 0)}}
    for partition, counts in expect.items():
        res = [r["bfs"][partition] for r in ranks]
        print(f"[precompute mesh] (c) BFS at {n} nodes, {len(edges)} edges, "
              f"partition {partition!r} on {PRE_WORLD} gloo ranks: seconds "
              f"{[round(x['secs'], 4) for x in res]} (C++ all threads, one "
              f"process: {cpp_secs:.4f}); levels {sum(levels)} in "
              f"{len(levels)} chunks; collectives {res[0]['counts']}"
              + (f"; frontier-exchange bytes {frontier}"
                 if partition == "graph" else "")
              + f"; equal to the C++ matrix {[x['equal'] for x in res]}")
        for r, x in enumerate(res):
            check(x["equal"], f"precompute mesh phase (c) rank {r}: the "
                  f"{partition} BFS differs from the C++ matrix")
            check(x["counts"] == counts, f"precompute mesh phase (c) rank "
                  f"{r} {partition}: collectives {x['counts']}, expected "
                  f"{counts}")

    # the DTW launch at each rank's block of comps (the train split's
    # internal side), made here after the ranks have exited and timed
    # alone, against the launch on all the comps: the ranks shared the card
    # while they ran, so their own launches are not what one costs
    cc = pipe.cc_ids["train"]
    flat = cc.reshape(-1, cc.shape[2])
    ai, ali = degree_sequences(pipe.graph, pipe.structure_anchors, True)
    na = len(ai)

    def launch(lo, hi):
        ci, li = degree_sequences(pipe.graph, flat[lo:hi], True)
        args = [torch.as_tensor(x, device="cuda") for x in (ci, li, ai, ali)]
        return lambda: kdtw.dtw_distance_grouped(*args, 1, hi - lo, na)

    w = -(-len(flat) // PRE_WORLD)
    blocks = [(min(r * w, len(flat)), min(r * w + w, len(flat)))
              for r in range(PRE_WORLD)]
    one_ms = device_times(launch(0, len(flat)))["device_ms"]
    rank_ms = [device_times(launch(lo, hi))["device_ms"]
               for lo, hi in blocks]
    warps = [kdtw.kernel_block_warps(hi - lo, na)
             for lo, hi in [(0, len(flat))] + blocks]
    print(f"[precompute mesh] DTW, train split internal side ({len(flat)} "
          f"comps x {na} anchors): one launch device_ms {one_ms!r} "
          f"(kernel_block_warps {warps[0]}); one launch at each rank's "
          f"block {blocks}, in this process, device_ms {rank_ms!r} "
          f"(kernel_block_warps {warps[1:]}); "
          f"spawn to exit {spawn_secs:.2f}s")
    print(f"[precompute mesh] phase seconds "
          f"{time.perf_counter() - t_phase:.2f}")
    return {"launches_per_rank": [r["launches"] for r in ranks],
            "pairs_per_rank": [r["pairs"] for r in ranks],
            "ms": rank_ms, "one_process_ms": one_ms,
            "ms_of": "device_ms of one launch at each rank's block of the "
                     "train split's internal-side comps, made alone in the "
                     "parent process after the ranks exited"}



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


PREP_MESH_WORLD = 2         # 5c (b), (d): gloo ranks on the one card
PREP_MESH_GIN_EPOCHS = 5    # 5c: 5b (a)'s GIN setting, fewer epochs
PREP_MESH_REL_TOL = 1e-4    # 5c (b): the node sums split over 2 ranks
RING_RTOL = 1e-5            # 5c (d): the ring adds in rotation order
RING_CALLS = 5              # 5c (d): timed calls of each collective
GLOO_PROBE_S = 60           # 5c (d): the probe group's timeout


def prep_mesh_runs(graphs, seed: int):
    """5c's pretraining runs on `graphs` ({"serving": the serving graph,
    "ppi": 5b (c)'s PPI-BP-scale graph}, either or both), {name: (graph,
    keyword arguments, steps)}: on each graph 5b (b)'s GCN (replayed numpy
    draws, given initial parameters) and 5b (a)'s projected GIN, and at
    PPI-BP scale 5b (c)'s exact-k neighbor mode too."""
    import torch
    from subgnn_tpu_torch.prepare import node_emb as NE
    out = {}
    for tag, g in graphs.items():
        n = g.n_nodes
        src, dst = NE._directed_edges(g)
        n_tr = 8 * int((src < dst).sum()) // 10
        drng = np.random.default_rng(seed + 6)
        n_feat = n if n <= NE.ONE_HOT_MAX_NODES else NE.PROJECTION_DIM
        init = NE.init_gnn_params(torch.Generator().manual_seed(seed),
                                  n_feat, 128, 64)
        negs = [drng.integers(0, n, (2, max(n_tr // 4, 1)))
                for _ in range(PREP_CPU_EPOCHS)]
        keeps = [drng.random((n, 128)) >= 0.4
                 for _ in range(PREP_CPU_EPOCHS)]
        out[f"{tag}_gcn"] = (g, dict(conv_type="gcn", dropout=0.4,
                                     epochs=PREP_CPU_EPOCHS, params=init,
                                     replay=dict(negatives=negs,
                                                 keep=keeps)),
                             PREP_CPU_EPOCHS)
        out[f"{tag}_gin"] = (g, dict(conv_type="gin", hidden=128,
                                     out_dim=64,
                                     epochs=PREP_MESH_GIN_EPOCHS),
                             PREP_MESH_GIN_EPOCHS)
    if "ppi" in graphs:
        ppi = graphs["ppi"]
        out["ppi_neighbor"] = (ppi, dict(conv_type="gcn",
                                         minibatch="neighbor",
                                         batch_size=512, nb_size=10,
                                         nb_exact=True, epochs=1),
                               -(-ppi.n_nodes // 512))
    return out


def prep_mesh_run(run, seed: int, dev, mesh=None):
    """One of prep_mesh_runs' runs on `dev` (on `mesh`): embeddings,
    metrics, segment_matmul launches, the world collectives' {name: (calls,
    bytes)}, this rank's block of the edges, seconds, median step seconds."""
    import torch
    from subgnn_tpu_torch.ops import embedding as E
    from subgnn_tpu_torch.parallel import mesh as MX
    from subgnn_tpu_torch.prepare import node_emb as NE
    g, kw, _ = run
    kw = dict(kw)
    replay = kw.pop("replay", None)
    draws = (NE.ReplayDraws(dev, **replay) if replay is not None
             else timed_draws(torch.Generator(device=dev).manual_seed(seed)))
    E.segment_matmul.launches = 0
    MX.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    emb, m = NE.train_node_embeddings(g, seed=seed, device=dev, draws=draws,
                                      mesh=mesh, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    E_all = len(NE._directed_edges(g)[0])
    return {"emb": emb, "metrics": m, "launches": E.segment_matmul.launches,
            "counts": {h.__name__: (h.calls, h.bytes)
                       for h in MX.COLLECTIVES if h.calls},
            "block": (0, E_all) if mesh is None else mesh.world_block(E_all),
            "secs": secs,
            "step_s": (step_seconds(draws)[0] if replay is None
                       else float("nan"))}


def prep_mesh_expect(run, block):
    """(segment_matmul launches, world collectives) a run makes on a rank
    holding `block` of the edges (the design: tests/test_torch_node_emb_mesh
    derives the same)."""
    from subgnn_tpu_torch.prepare import node_emb as NE
    g, kw, steps = run
    n = g.n_nodes
    src, dst = NE._directed_edges(g)
    n_tr = 8 * int((src < dst).sum()) // 10
    hidden = kw.get("hidden", 128)
    n_feat = n if n <= NE.ONE_HOT_MAX_NODES else NE.PROJECTION_DIM
    projected = n_feat > hidden
    mode = kw.get("minibatch", "full")
    want = NE.spmm_launches(block[1] - block[0], n_tr,
                            conv_type=kw["conv_type"], minibatch=mode,
                            projected=projected)
    d1 = hidden if projected else n_feat
    counts = {"sum_over_world": (2 * steps + 2,
                                 (steps + 1) * 4 * n * (d1 + hidden)),
              "copy_to_world": (steps * (1 + projected),
                                steps * (1 + projected) * 4 * n * hidden)}
    if kw["conv_type"] == "gcn" and mode != "full":
        counts["all_reduce_world_"] = (steps, steps * 4 * n)
    return steps * want["step"] + want["eval"], counts


def ring_check(mesh, x):
    """5c (d): ring_all_reduce and ring_all_gather of `x` (this rank's) on
    `mesh` against dist.all_reduce / dist.all_gather: max relative error,
    the gathers equal, and the median milliseconds of RING_CALLS calls of
    each (host clock, synchronised)."""
    import torch
    import torch.distributed as dist
    from subgnn_tpu_torch.parallel import collectives as RC

    def timed(fn):
        out, secs = None, []
        for _ in range(RING_CALLS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        return out, float(np.median(secs)) * 1e3

    def dist_reduce():
        y = x.clone()
        dist.all_reduce(y, group=mesh.group)
        return y

    def dist_gather():
        ys = [torch.empty_like(x) for _ in range(mesh.world)]
        dist.all_gather(ys, x, group=mesh.group)
        return torch.stack(ys)

    want, dist_ms = timed(dist_reduce)
    RC.reset_counts()
    got, ring_ms = timed(lambda: RC.ring_all_reduce(x, mesh))
    rotations = RC.ring_all_reduce.calls // RING_CALLS
    rel = float(((got - want).abs() / want.abs().clamp_min(1e-6)).max())
    gwant, gdist_ms = timed(dist_gather)
    ggot, gring_ms = timed(lambda: RC.ring_all_gather(x, mesh))
    return {"rel_err": rel, "gather_equal": bool(torch.equal(ggot, gwant)),
            "ring_ms": ring_ms, "dist_ms": dist_ms,
            "gather_ring_ms": gring_ms, "gather_dist_ms": gdist_ms,
            "rotations": rotations, "bytes": x.numel() * x.element_size()}


def world_reduce_ms(mesh, n: int, width: int) -> float:
    """Median host milliseconds of RING_CALLS synchronised all-reduces of
    an (n, width) fp32 tensor over the whole group: one of the pretrainer's
    world sums at that shape."""
    import torch
    import torch.distributed as dist
    x = torch.ones(n, width, device=mesh.device)
    secs = []
    for _ in range(RING_CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(x, group=mesh.group)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return float(np.median(secs)) * 1e3


def gloo_probe_rank(rank, store, out):
    """5c (d): whether gloo's point-to-point takes a CUDA tensor, tried by
    one of two processes of a group of their own (spawned; its ops time out
    after GLOO_PROBE_S instead of hanging). Writes <out>.<rank>.txt: the
    error it raised, or "" when the exchange went through. gloo may instead
    throw in its I/O thread, which aborts the process: the phase spawns the
    probe apart from every other rank for that reason. Why the ring
    collectives stage through the host on gloo."""
    import datetime

    import torch
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=GLOO_PROBE_S))
    x = torch.full((4,), float(rank), device="cuda:0")
    got = torch.empty_like(x)
    try:
        for req in dist.batch_isend_irecv(
                [dist.P2POp(dist.isend, x, 1 - rank),
                 dist.P2POp(dist.irecv, got, 1 - rank)]):
            req.wait()
        said = ""
    except Exception as e:  # what it raised is the finding
        said = str(e).splitlines()[0]
    Path(f"{out}.{rank}.txt").write_text(said)


def gloo_probe(root: Path):
    """gloo_probe_rank on two spawned processes: {rank: what it said}, or
    "aborted: <why>" for a rank whose process died before it could say."""
    import torch.multiprocessing as mp
    out = root / "gloo_probe"
    aborted = ""
    try:
        mp.start_processes(gloo_probe_rank,
                           args=(str(root / "gloo_probe_store"), str(out)),
                           nprocs=2, start_method="spawn")
    except (mp.ProcessExitedException, mp.ProcessRaisedException) as e:
        aborted = str(e).strip().splitlines()[-1]
    said = {}
    for r in range(2):
        f = Path(f"{out}.{r}.txt")
        said[r] = f.read_text() if f.exists() else f"aborted: {aborted}"
    return said


def prep_mesh_rank(rank, store, graph_path, seed, out):
    """5c (b), (d): one of PREP_MESH_WORLD gloo ranks on cuda:0 (spawned):
    prep_mesh_runs' PPI-scale runs on the mesh, then the ring collectives
    and the wire time of one world all-reduce at the node sums' shape.
    Writes <out>.<rank>.pt."""
    sys.path.insert(0, str(HERE))
    import torch
    import torch.distributed as dist
    from subgnn_tpu_torch.data.graph import CSRGraph
    from subgnn_tpu_torch.parallel import mesh as MX
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=PREP_MESH_WORLD, rank=rank)
    try:
        mesh = MX.make_device_mesh(PREP_MESH_WORLD, device="cuda:0")
        ppi = CSRGraph.from_edges(np.load(graph_path), n_nodes=PPI_BP[0])
        result = {k: prep_mesh_run(v, seed, mesh.device, mesh)
                  for k, v in prep_mesh_runs({"ppi": ppi}, seed).items()}
        gen = torch.Generator(device="cuda:0").manual_seed(seed + rank)
        x = torch.randn(PPI_BP[0], 128, generator=gen, device="cuda:0")
        result["ring"] = ring_check(mesh, x)
        result["world_reduce_ms"] = world_reduce_ms(mesh, PPI_BP[0], 128)
        torch.save(result, f"{out}.{rank}.pt")
    finally:
        dist.destroy_process_group()


def prep_mesh_phase(root: Path, graph, seed: int, dev, gpu: str):
    """Phase 5c: the pretrainer's edge-sharded SpMM on a mesh, the ring
    collectives and the at-scale dry run (see the module doc). Returns the
    kernel records' entries: segment_matmul's launches on each rank
    (`pretrainer_mesh`) and the dry run's (`dryrun`)."""
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from subgnn_tpu_torch import entry as EN
    from subgnn_tpu_torch.kernel_times import device_times
    from subgnn_tpu_torch.ops import embedding as E
    from subgnn_tpu_torch.parallel import mesh as MX
    from subgnn_tpu_torch.prepare import node_emb as NE

    t_phase = time.perf_counter()
    ppi = uniform_graph(np.random.default_rng(seed + 5), *PPI_BP)
    runs = prep_mesh_runs({"serving": graph, "ppi": ppi}, seed)

    # one process on the card: every run's reference
    ref = {k: prep_mesh_run(v, seed, dev) for k, v in runs.items()}
    for k, r in ref.items():
        print(f"[prepare mesh] {k}, no mesh: {r['secs']:.2f}s, median step "
              f"{r['step_s']!r}s, losses {r['metrics']['loss_history']!r}, "
              f"segment_matmul launches {r['launches']}")

    # (a) one NCCL rank: bit-equal to no mesh, launches exact
    dist.init_process_group("nccl",
                            init_method=f"file://{root}/nccl_prep_store",
                            world_size=1, rank=0)
    try:
        mesh = MX.make_device_mesh(1, device=dev)
        one = {k: prep_mesh_run(runs[k], seed, dev, mesh)
               for k in ("serving_gcn", "serving_gin")}
    finally:
        dist.destroy_process_group()
    records = {}
    for k, r in one.items():
        want_launches, want_counts = prep_mesh_expect(runs[k], r["block"])
        same = (np.array_equal(r["emb"], ref[k]["emb"])
                and r["metrics"]["loss_history"]
                == ref[k]["metrics"]["loss_history"])
        print(f"[prepare mesh] (a) {k} on one NCCL rank: {r['secs']:.2f}s "
              f"(no mesh {ref[k]['secs']:.2f}s); bits equal to no mesh "
              f"{same}; segment_matmul launches {r['launches']} (expected "
              f"{want_launches}); world collectives {r['counts']} (expected "
              f"{want_counts}) ({gpu})")
        check(same, f"prepare mesh (a) {k}: one NCCL rank is not bit-equal "
                    f"to the run without a mesh")
        check(r["launches"] == want_launches == ref[k]["launches"],
              f"prepare mesh (a) {k}: {r['launches']} segment_matmul "
              f"launches, expected {want_launches}")
        check(r["counts"] == want_counts, f"prepare mesh (a) {k}: world "
              f"collectives {r['counts']}, expected {want_counts}")
        records[f"nccl1_{k}"] = [r["launches"]]

    # (b), (d): PREP_MESH_WORLD gloo ranks on this card
    graph_path = root / "ppi_edges.npy"
    src, dst = NE._directed_edges(ppi)
    und = src < dst
    np.save(graph_path, np.stack([src[und], dst[und]], 1) + 1)
    out = root / "prep_gloo"
    t0 = time.perf_counter()
    mp.start_processes(prep_mesh_rank,
                       args=(str(root / "prep_gloo_store"), str(graph_path),
                             seed, str(out)),
                       nprocs=PREP_MESH_WORLD, start_method="spawn")
    spawn_secs = time.perf_counter() - t0
    ranks = [torch.load(f"{out}.{r}.pt", weights_only=False)
             for r in range(PREP_MESH_WORLD)]
    for k in [k for k in runs if k.startswith("ppi")]:
        r_ref = ref[k]
        scale = float(np.abs(r_ref["emb"]).max())
        for r, res in enumerate(ranks):
            x = res[k]
            want_launches, want_counts = prep_mesh_expect(runs[k], x["block"])
            loss_rel = max(rel_diff(a, b) for a, b in zip(
                x["metrics"]["loss_history"],
                r_ref["metrics"]["loss_history"]))
            emb_err = float(np.abs(x["emb"] - r_ref["emb"]).max())
            print(f"[prepare mesh] (b) {k} rank {r} of {PREP_MESH_WORLD} "
                  f"gloo ranks on cuda:0, edges {x['block']}: "
                  f"{x['secs']:.2f}s (one process {r_ref['secs']:.2f}s), "
                  f"median step {x['step_s']!r}s (one process "
                  f"{r_ref['step_s']!r}s); losses max rel diff {loss_rel!r} "
                  f"(tol {PREP_MESH_REL_TOL}), embeddings max |diff| "
                  f"{emb_err!r} (max |emb| {scale!r}, tol "
                  f"{PREP_MESH_REL_TOL} x that); segment_matmul launches "
                  f"{x['launches']} (expected {want_launches}; one process "
                  f"{r_ref['launches']}); world collectives {x['counts']} "
                  f"(expected {want_counts}) ({gpu})")
            check(loss_rel <= PREP_MESH_REL_TOL, f"prepare mesh (b) {k} rank "
                  f"{r}: losses disagree with one process")
            check(emb_err <= PREP_MESH_REL_TOL * scale, f"prepare mesh (b) "
                  f"{k} rank {r}: embeddings disagree with one process")
            check(x["launches"] == want_launches, f"prepare mesh (b) {k} "
                  f"rank {r}: {x['launches']} segment_matmul launches, "
                  f"expected {want_launches}")
            check(x["counts"] == want_counts, f"prepare mesh (b) {k} rank "
                  f"{r}: world collectives {x['counts']}, expected "
                  f"{want_counts}")
        records[f"gloo{PREP_MESH_WORLD}_{k}"] = [res[k]["launches"]
                                                 for res in ranks]
    for r, res in enumerate(ranks):
        ring = res["ring"]
        print(f"[prepare mesh] (d) rank {r}: ring collectives over gloo on "
              f"one card (host-staged), {ring['bytes']} bytes a rank: "
              f"ring_all_reduce vs dist.all_reduce max rel err "
              f"{ring['rel_err']!r} (tol {RING_RTOL}), {ring['rotations']} "
              f"rotations, {ring['ring_ms']!r} ms vs {ring['dist_ms']!r} ms; "
              f"ring_all_gather equal to dist.all_gather "
              f"{ring['gather_equal']}, {ring['gather_ring_ms']!r} ms vs "
              f"{ring['gather_dist_ms']!r} ms (median of {RING_CALLS}, host "
              f"clock; gloo on one card, not NCCL); one world all-reduce of "
              f"the ({PPI_BP[0]}, 128) node sums {res['world_reduce_ms']!r} "
              f"ms ({gpu})")
        check(ring["rel_err"] <= RING_RTOL, f"prepare mesh (d) rank {r}: "
              f"ring_all_reduce disagrees with dist.all_reduce")
        check(ring["gather_equal"], f"prepare mesh (d) rank {r}: "
              f"ring_all_gather differs from dist.all_gather")
        check(ring["rotations"] == 2 * (PREP_MESH_WORLD - 1),
              f"prepare mesh (d) rank {r}: {ring['rotations']} rotations")
    for r, said in gloo_probe(root).items():
        print(f"[prepare mesh] (d) rank {r} of a probe pair: gloo's isend / "
              f"irecv of a CUDA tensor: "
              + (said if said.startswith("aborted") else
                 f"raised {said!r}" if said else "went through"))

    # segment_matmul at a rank's block of the PPI edges (its dst plan, the
    # forward sum, D = hidden 128), made here after the ranks have exited,
    # against the plan of all the edges
    lo, hi = ranks[0]["ppi_gcn"]["block"]
    block_ms = {}
    for tag, (a, b) in (("all edges", (0, len(src))),
                        ("rank 0's block", (lo, hi))):
        edges = NE.EdgePlans(src[a:b], dst[a:b], ppi.n_nodes, dev, None)
        c = edges.chunks[0]
        g = torch.randn(b - a, 128, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(seed))
        block_ms[tag] = device_times(
            lambda: E.segment_matmul(g, c.plan_dst, ppi.n_nodes))["device_ms"]
    print(f"[prepare mesh] segment_matmul device_ms at the PPI edges' dst "
          f"plan, D=128 fp32: {json.dumps(block_ms)}; spawn to exit "
          f"{spawn_secs:.2f}s ({gpu})")

    # (c) the dry runs: the flagship forward and one NCCL rank's fused fit
    # (the module's own entry point), then dryrun_multichip_full on two
    # gloo ranks of a (1, 2) mesh on this card
    t0 = time.perf_counter()
    fn, args = EN.entry()
    logits = fn(*args)
    check(tuple(logits.shape) == (32, 4)
          and bool(torch.isfinite(logits).all()), "entry(): bad logits")
    fit = EN.dryrun_multichip(1, full=False)
    check(fit["fused"] and fit["backend"] == "nccl", f"dryrun_multichip(1): "
          f"{fit}")
    print(f"[prepare mesh] (c) entry() logits {tuple(logits.shape)} finite; "
          f"dryrun_multichip(1): {json.dumps(fit)} "
          f"({time.perf_counter() - t0:.2f}s) ({gpu})")
    t0 = time.perf_counter()
    full = EN.dryrun_multichip_full(PREP_MESH_WORLD)
    full_s = time.perf_counter() - t0
    print(f"[prepare mesh] (c) dryrun_multichip_full({PREP_MESH_WORLD}): "
          f"{full_s:.2f}s ({gpu})")
    check(full["mesh"] == {"data": 1, "node": 2} and full["n_nodes"] == 5000
          and np.isfinite(full["best_monitor"])
          and np.isfinite(full["test_micro_f1"]),
          f"dryrun_multichip_full: {full}")
    check(full["backend"] == "gloo" and not full["fused"],
          "dryrun_multichip_full: gloo ranks on the card fit streaming")
    for r, x in enumerate(full["ranks"]):
        check(x["launches"]["dtw_grouped"] == 6 and
              x["launches"]["segment_matmul"] > 0, f"dryrun_multichip_full "
              f"rank {r}: launches {x['launches']}")
    print(f"[prepare mesh] phase seconds {time.perf_counter() - t_phase:.2f}")
    return ({"launches_per_rank": records, "segment_matmul_block_ms":
             block_ms, "world_reduce_ms": [r["world_reduce_ms"]
                                           for r in ranks]},
            {"launches_per_rank": [x["launches"] for x in full["ranks"]],
             "seconds": full_s})


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

    def dtw_check(arrays, G, nc, na, plain_device=dev):
        """Kernel on the card vs plain on `plain_device`: (max abs err,
        bits equal)."""
        kin = [torch.as_tensor(np.ascontiguousarray(x), device=dev)
               for x in arrays]
        got = kdtw.dtw_distance_grouped(*kin, G, nc, na).cpu()
        ref = kdtw.dtw_distance_grouped_torch(
            *(x.to(plain_device) for x in kin), G, nc, na).cpu()
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
    # anchors past the warp path's shared-memory strip (La > 58,112): 6
    # comps of up to 300 nodes (two past the register bound of 64, one
    # empty) x 3 anchors of up to 60,000
    wide_cl = np.array([300, 40, 0, 120, 64, 65], np.int32)
    wide_al = np.array([60_000, 59_000, 5], np.int32)
    wide_cs = np.zeros((6, 300), np.float32)
    wide_as = np.zeros((3, 60_000), np.float32)
    for seqs, lens in ((wide_cs, wide_cl), (wide_as, wide_al)):
        for i, n in enumerate(lens):
            seqs[i, :n] = np.sort(lrng.integers(0, 40, n))
    max_abs_err = 0.0
    for what, arrays, shape in (
            ("serving", (cs, cl, as_, al), (G, nc, na)),
            ("long", (long_cs, long_cl, as_, al), (2, 64, na)),
            ("wide anchors", (wide_cs, wide_cl, wide_as, wide_al),
             (1, 6, 3))):
        t0 = time.perf_counter()
        err, same = dtw_check(arrays, *shape,
                              plain_device="cpu" if what == "wide anchors"
                              else dev)
        max_abs_err = max(max_abs_err, err)
        print(f"[kernel] dtw_grouped vs plain, {what} case (G, nc, na) = "
              f"{shape}, Lc={arrays[0].shape[1]} La={arrays[2].shape[1]}, "
              f"comp lengths {int(arrays[1].min())}-{int(arrays[1].max())}, "
              f"anchor lengths {int(arrays[3].min())}-"
              f"{int(arrays[3].max())}: max_abs_err={err!r} (tol {DTW_TOL}), "
              f"bits equal {same} ({time.perf_counter() - t0:.2f}s)")
        check(err <= DTW_TOL, f"DTW kernel disagrees with its plain version "
                              f"({what} case)")
    # the wide-anchor path's time: its two launches a call (the grouped
    # kernel, then the warp path with its boundary in global scratch)
    wide_in = [torch.as_tensor(x, device=dev)
               for x in (wide_cs, wide_cl, wide_as, wide_al)]
    wide_ms = event_ms(lambda: kdtw.dtw_distance_grouped(*wide_in, 1, 6, 3),
                       3)
    wide_bound, wide_by, wide_cells = dtw_bound_ms(
        wide_cl, wide_al, 1, 6, 3,
        sum(x.nbytes for x in (wide_cs, wide_cl, wide_as, wide_al)) + 18 * 4)
    print(f"[kernel] dtw_grouped wide anchors (La 60,000, "
          f"{kdtw.strip_scratch_warps(60_000, 18)} scratch warps): "
          f"{wide_ms!r} ms a call (CUDA events, 3 calls), {wide_cells} DP "
          f"cells, bound {wide_bound!r} ms ({wide_by})")

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
        err, fused_runs = fused_phase(dpipe, args.seed, benches)
        seg_err = max(seg_err, err)

        # ------------------------------------------------------- 4c. mesh
        mesh_phase(dpipe, args.seed, fused_runs, root)

        # ------------------------------------------------------- 4d. node
        err, node = node_phase(dpipe, args.seed, root, benches, gen, dev)
        seg_err = max(seg_err, err)

        # ----------------------------------------------- 4e. precompute mesh
        mesh_pre = precompute_mesh_phase(dpipe, args.seed, root)
        del dpipe

        # ---------------------------------------------------------- 5. run
        run_phase(root, graph, hp, rng, args.seed)

        # ----------------------------------------------------- 5b. prepare
        prepare = prepare_phase(root, args.seed, dev, card())

        # ------------------------------------------------ 5c. prepare mesh
        prep_mesh, dryrun = prep_mesh_phase(root, graph, args.seed, dev,
                                            card())

    # ------------------------------------------------------------ 6. BFS
    bfs_phase(hp, args.seed, dev)

    dtw_record = {"name": "dtw_grouped", "route": "cuda",
                  "source": "subgnn_tpu_torch/csrc/dtw.cu",
                  "replaces": "subgnn_tpu/ops/dtw_pallas.py:25",
                  "launches": launches, "max_abs_err": max_abs_err,
                  "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                  "bound_by": bound_by, "library_ms": None,
                  "bits_equal": req_same, "device_ms": dev_t["device_ms"],
                  "span_ms": dev_t["span_ms"], "call_ms": ms,
                  "mesh_precompute": mesh_pre, "dryrun": dryrun}

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
                  "prepare_spmm": prepare["spmm"],
                  "node_axis": node, "pretrainer_mesh": prep_mesh}

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
