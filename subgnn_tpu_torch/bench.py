"""Training-step throughput of the port on one CUDA device.

    python -m subgnn_tpu_torch.bench          # BENCH_DTYPE=bfloat16 (default)
    BENCH_DTYPE=float32 python -m subgnn_tpu_torch.bench
    python -m subgnn_tpu_torch.bench --profile 5

Prints ONE JSON line on stdout:
    {"metric": "mpn_edges_per_s", "value": N, "unit": "edges/s",
     "run_spread": [...], "dtype": "...", "step": "cuda_graph",
     "anchor_patch_samples_per_s": M}
and on stderr the card's name and power limit and the eager step's rate
beside the graph's. The measured step is the one the fused trainer runs:
the training step captured once as a CUDA graph (train/graphs.py) and
replayed, the counterpart of bench.py:129-136's 50 steps in one
`fori_loop` dispatch. `--profile N` then, for the replayed and for the
eager step, times N more steps without the profiler, traces N more with
torch.profiler, and prints to stderr the wall time per step of both, the
device busy time per step (from the trace), the device's idle share
against each wall time, the device activities per step, and the ops with
the most device time.

The metric counts anchor-patch -> CC message edges processed per second by
the full training step (forward + backward, with the embedding-table
gradient through the plan kernel, + Adam) at the flagship configuration of
bench.py: D=128, 2 layers, all three channels, B=1280 in bf16 or B=512 in
fp32, C=3 CCs of up to 16 nodes, an 8192-node table, a 150-patch structure
pool, gather plans and compact anchor-column similarities. Each timed run
is 50 steps between CUDA events after a synchronize; the value is the
median of 3 runs, after one warm-up run; graph and eager runs alternate.

`anchor_patch_samples_per_s` is the device triangular-walk sampler's rate
at bench.py:174-211's shape (`device_sampler`: 8192 nodes, 4096 walks of
24, rw_beta 0.65, 8 rounds; warm-up untimed).

Also the port's copies of __graft_entry__._build_flagship and
_build_training_fixture: the same numpy draws in the same order, so the same
seed gives the same batches, splits and anchors as the JAX package's.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from .config import HParams
from .data.dataset import SubgraphData
from .device import resolve_device
from .models.subgnn import CHANNEL_CC_KEYS, SubGNNModel

STEPS, RUNS = 50, 3


def build_flagship(rng_seed=0, n_nodes=256, n_sub=32, C=3, L=8, n_pool=40,
                   hp_overrides=None, device: str | torch.device = "cuda"):
    """A realistic all-three-channel SubGNN instance on synthetic arrays
    (port of __graft_entry__._build_flagship). Returns (model, hp, params,
    state, batch, anchors): params/state on `device` from a torch.Generator
    seeded with 0, batch and anchors as host numpy arrays."""
    hp = HParams(n_layers=2, node_embed_size=64,
                 n_anchor_patches_N_in=10, n_anchor_patches_N_out=20,
                 n_anchor_patches_pos_in=20, n_anchor_patches_pos_out=40,
                 n_anchor_patches_structure=10, n_triangular_walks=5,
                 random_walk_len=10,
                 linear_hidden_dim_1=64, linear_hidden_dim_2=32)
    if hp_overrides:
        hp = hp.replace(**hp_overrides)
    rng = np.random.default_rng(rng_seed)
    model = SubGNNModel(hp, n_nodes=n_nodes, num_classes=4, multilabel=False)
    embeds = rng.normal(size=(n_nodes, hp.node_embed_size)).astype(np.float32)
    params, state = model.init_params(torch.Generator().manual_seed(0),
                                      embeds, device=device)

    cc_ids = np.zeros((n_sub, C, L), np.int32)
    for s in range(n_sub):
        for c in range(int(rng.integers(1, C + 1))):
            ln = int(rng.integers(1, L + 1))
            cc_ids[s, c, :ln] = rng.choice(n_nodes, size=ln, replace=False) + 1
    batch = {
        "cc_ids": cc_ids,
        "subgraph_idx": np.arange(n_sub, dtype=np.int32),
        "label": rng.integers(0, 4, n_sub),
        "valid": np.ones(n_sub, bool),
        "NP_sim": rng.integers(0, 6, (n_sub, C, n_nodes)).astype(np.float32),
        "I_S_sim": rng.random((n_sub, C, n_pool)).astype(np.float32),
        "B_S_sim": rng.random((n_sub, C, n_pool)).astype(np.float32),
    }
    nl = hp.n_layers
    anchors = {
        "neigh_int": np.where(
            cc_ids[None, :, :, :1] != 0,
            rng.integers(1, n_nodes + 1,
                         (nl, n_sub, C, hp.n_anchor_patches_N_in)), 0)
        .astype(np.int32),
        "neigh_bor": np.where(
            cc_ids[None, :, :, :1] != 0,
            rng.integers(1, n_nodes + 1,
                         (nl, n_sub, C, hp.n_anchor_patches_N_out)), 0)
        .astype(np.int32),
        "pos_int": rng.integers(
            1, n_nodes + 1,
            (nl, n_sub, hp.n_anchor_patches_pos_in)).astype(np.int32),
        "pos_ext": rng.integers(
            1, n_nodes + 1, (nl, hp.n_anchor_patches_pos_out)).astype(np.int32),
        "struc_pool_idx": rng.integers(
            0, n_pool, (nl, hp.n_anchor_patches_structure)).astype(np.int32),
        "struc_int_walks": rng.integers(
            0, n_nodes + 1,
            (nl, hp.n_anchor_patches_structure, hp.n_triangular_walks,
             hp.random_walk_len)).astype(np.int32),
        "struc_bor_walks": rng.integers(
            0, n_nodes + 1,
            (nl, hp.n_anchor_patches_structure, hp.n_triangular_walks,
             hp.random_walk_len)).astype(np.int32),
    }
    return model, hp, params, state, batch, anchors


def build_training_fixture(rng_seed=0, n_nodes=128, n_train=16, n_val=8,
                           C=2, L=4, n_pool=16, hp_overrides=None,
                           device: str | torch.device = "cuda"):
    """Small synthetic train/val splits with per-split anchors, shaped like
    the pipeline's outputs, for Trainer.fit (port of
    __graft_entry__._build_training_fixture). Returns (model, hp, params,
    state, data, anchors, eval_cc): data and anchors per split as host
    numpy, eval_cc the val split's CC tables when hp.trainable_cc."""
    hp = HParams(n_layers=1, node_embed_size=32,
                 n_anchor_patches_N_in=4, n_anchor_patches_N_out=4,
                 n_anchor_patches_pos_in=4, n_anchor_patches_pos_out=4,
                 n_anchor_patches_structure=4, n_triangular_walks=2,
                 random_walk_len=4, linear_hidden_dim_1=16,
                 linear_hidden_dim_2=8, batch_size=8, max_epochs=2,
                 learning_rate=1e-3)
    if hp_overrides:
        hp = hp.replace(**hp_overrides)
    rng = np.random.default_rng(rng_seed)
    num_classes = 4
    model = SubGNNModel(hp, n_nodes=n_nodes, num_classes=num_classes,
                        multilabel=False)
    embeds = rng.normal(size=(n_nodes, hp.node_embed_size)).astype(np.float32)

    def make_cc_ids(n_sub):
        cc = np.zeros((n_sub, C, L), np.int32)
        for s in range(n_sub):
            for c in range(int(rng.integers(1, C + 1))):
                ln = int(rng.integers(1, L + 1))
                cc[s, c, :ln] = rng.choice(n_nodes, size=ln, replace=False) + 1
        return cc

    def make_split(n_sub):
        cc = make_cc_ids(n_sub)
        return SubgraphData(
            subgraph_ids=cc[:, 0, :].copy(),
            cc_ids=cc,
            labels=rng.integers(0, num_classes, n_sub),
            NP_sim=rng.integers(0, 6, (n_sub, C, n_nodes)).astype(np.float32),
            I_S_sim=rng.random((n_sub, C, n_pool)).astype(np.float32),
            B_S_sim=rng.random((n_sub, C, n_pool)).astype(np.float32))

    data = {"train": make_split(n_train), "val": make_split(n_val)}

    def make_anchors(n_sub, cc_ids):
        nl = hp.n_layers
        return {
            "neigh_int": np.where(
                cc_ids[None, :, :, :1] != 0,
                rng.integers(1, n_nodes + 1,
                             (nl, n_sub, C, hp.n_anchor_patches_N_in)), 0)
            .astype(np.int32),
            "neigh_bor": np.where(
                cc_ids[None, :, :, :1] != 0,
                rng.integers(1, n_nodes + 1,
                             (nl, n_sub, C, hp.n_anchor_patches_N_out)), 0)
            .astype(np.int32),
            "pos_int": rng.integers(
                1, n_nodes + 1,
                (nl, n_sub, hp.n_anchor_patches_pos_in)).astype(np.int32),
            "pos_ext": rng.integers(
                1, n_nodes + 1,
                (nl, hp.n_anchor_patches_pos_out)).astype(np.int32),
            "struc_pool_idx": rng.integers(
                0, n_pool,
                (nl, hp.n_anchor_patches_structure)).astype(np.int32),
            "struc_int_walks": rng.integers(
                0, n_nodes + 1,
                (nl, hp.n_anchor_patches_structure, hp.n_triangular_walks,
                 hp.random_walk_len)).astype(np.int32),
            "struc_bor_walks": rng.integers(
                0, n_nodes + 1,
                (nl, hp.n_anchor_patches_structure, hp.n_triangular_walks,
                 hp.random_walk_len)).astype(np.int32),
        }

    anchors = {s: make_anchors(len(data[s]), data[s].cc_ids)
               for s in ("train", "val")}

    train_cc = eval_cc = None
    if hp.trainable_cc:
        table = np.concatenate(
            [np.zeros((1, hp.node_embed_size), np.float32), embeds], axis=0)

        def cc_tables(cc_ids):
            emb = table[cc_ids]
            agg = emb.sum(2) if hp.cc_aggregator == "sum" else emb.max(2)
            return {k: agg.copy() for k in CHANNEL_CC_KEYS}

        train_cc = cc_tables(data["train"].cc_ids)
        eval_cc = {"val": cc_tables(data["val"].cc_ids)}
    params, state = model.init_params(torch.Generator().manual_seed(0),
                                      embeds, train_cc, device=device)
    return model, hp, params, state, data, anchors, eval_cc


def flagship_hparams(dtype: str) -> dict:
    """bench.py's flagship widths (bench.py:71-83)."""
    return dict(node_embed_size=128, n_layers=2,
                n_anchor_patches_N_in=15, n_anchor_patches_N_out=30,
                n_anchor_patches_pos_in=30, n_anchor_patches_pos_out=60,
                n_anchor_patches_structure=15, n_triangular_walks=5,
                random_walk_len=10, linear_hidden_dim_1=64,
                linear_hidden_dim_2=32, dtype=dtype)


def bench_batch(dtype: str, device, seed: int = 0):
    """The bench's model and device batch at `dtype`: B=1280 (bf16) or 512
    (fp32), with gather plans and compact anchor-column similarities.
    Returns (model, hp, params, state, batch, anchors) on `device`."""
    from .train.loop import device_batch
    from .train.plans import PlanBuilder, batch_plans
    from .train.sims import compact_sims_for_batch

    B = 1280 if dtype == "bfloat16" else 512
    model, hp, params, state, batch, anchors = build_flagship(
        rng_seed=seed, n_nodes=8192, n_sub=B, C=3, L=16, n_pool=150,
        hp_overrides=flagship_hparams(dtype), device=device)
    idx = np.arange(B)
    batch.update(batch_plans(PlanBuilder(params["node_embed"].shape[0]), hp,
                             batch["cc_ids"], anchors, idx))
    batch.update(compact_sims_for_batch(batch.pop("NP_sim"), anchors, hp,
                                        idx))
    return (model, hp, params, state, device_batch(batch, device),
            device_batch(anchors, device))


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def profile_steps(step, n: int, label: str = "step", file=None,
                  sort_by=("self_device_time_total",)) -> None:
    """Time n calls of `step` unprofiled, then trace n more with
    torch.profiler; print the breakdown to `file` (default stderr), one op
    table per key of `sort_by`. The idle share against the unprofiled wall
    time is the step's own: the profiler's host cost stretches only the
    traced steps, not the device work."""
    file = sys.stderr if file is None else file
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = sorted((e.time_range.start, e.time_range.end)
                     for e in prof.events()
                     if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in kernels:                      # union of kernel intervals, us
        if b > end:
            busy += b - max(a, end)
            end = b
    wall_ms = wall / n * 1e3
    busy_ms = busy / n / 1e3
    print(f"profile ({label}): {n} steps unprofiled, wall {plain_ms!r} "
          f"ms/step; {n} steps traced, wall {wall_ms!r} ms/step, device busy "
          f"{busy_ms!r} ms/step; idle share {1 - busy_ms / plain_ms!r} "
          f"unprofiled, {1 - busy_ms / wall_ms!r} traced; "
          f"{len(kernels) / n!r} device activities (kernels, copies, "
          f"memsets) per step", file=file)
    for key in sort_by:
        print(prof.key_averages().table(sort_by=key, row_limit=15,
                                        max_name_column_width=60), file=file)


def timed_run(step) -> float:
    """Seconds of STEPS calls of `step` between CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(STEPS):
        step()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3


def device_sampler(device, n_nodes: int = 8192, n_walks: int = 4096,
                   walk_len: int = 24, rounds: int = 8,
                   rw_beta: float = 0.65):
    """Anchor patches sampled per second by the device triangular-walk
    sampler (sampling/device_walks.py) on bench.py's synthetic graph (the
    same numpy draws: n_nodes nodes, n_nodes * 8 edges drawn, self loops
    dropped): `rounds` rounds of n_walks walks of walk_len, timed between
    CUDA events after one untimed warm-up round. Returns (rate, graph,
    the last round's walks)."""
    from .data.graph import CSRGraph
    from .sampling.device_walks import (padded_neighbor_table,
                                        triangular_walks_device)

    rng_np = np.random.default_rng(0)
    edges = rng_np.integers(1, n_nodes + 1, (n_nodes * 8, 2))
    edges = edges[edges[:, 0] != edges[:, 1]]
    g = CSRGraph.from_edges(edges, n_nodes=n_nodes)
    nbr, degs = padded_neighbor_table(g, device=device)
    starts = torch.as_tensor(g.node_ids(), device=device)
    gen = torch.Generator(device=device).manual_seed(0)

    def walk():
        return triangular_walks_device(nbr, degs, starts, walk_len=walk_len,
                                       n_walks=n_walks, rw_beta=rw_beta,
                                       generator=gen, device=device)

    walk()                                                  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(rounds):
        walks = walk()
    end.record()
    torch.cuda.synchronize()
    return n_walks * rounds / (start.elapsed_time(end) / 1e3), g, walks


def main(argv=None) -> int:
    from .ops import embedding
    from .train.graphs import StepGraph
    from .train.loop import make_optimizer, mpn_edges_per_step, train_step

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="trace N more steps with torch.profiler")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtype = os.environ.get("BENCH_DTYPE", "bfloat16")
    model, hp, params, state, batch, anchors = bench_batch(dtype, dev)
    tx = make_optimizer(hp.replace(learning_rate=1e-3))
    opt_state = tx.init(params)

    def step():
        train_step(model, tx, params, opt_state, state, batch, anchors)

    graph = StepGraph(step, dev)
    for fn in (step, graph):                                # warm-up
        for _ in range(STEPS):
            fn()
    embedding.segment_matmul.launches = 0
    graph_s, eager_s = [], []
    for _ in range(RUNS):
        graph_s.append(timed_run(graph))
        eager_s.append(timed_run(step))
    launches = embedding.segment_matmul.launches
    if launches != 2 * 2 * STEPS * RUNS:
        raise RuntimeError(f"segment_matmul launched {launches} times in "
                           f"{2 * STEPS * RUNS} steps")
    B, C = batch["cc_ids"].shape[:2]
    edges = mpn_edges_per_step(hp, B, C) * STEPS
    print(card(), file=sys.stderr)
    print(f"eager step: mpn_edges_per_s {edges / float(np.median(eager_s))!r}"
          f" (runs {[edges / t for t in eager_s]!r}); graph step "
          f"{edges / float(np.median(graph_s))!r}; ms/step eager "
          f"{float(np.median(eager_s)) / STEPS * 1e3!r}, graph "
          f"{float(np.median(graph_s)) / STEPS * 1e3!r}; captures "
          f"{graph.captures}", file=sys.stderr)
    sampler_rate, _, _ = device_sampler(dev)
    print(json.dumps({
        "metric": "mpn_edges_per_s",
        "value": edges / float(np.median(graph_s)),
        "unit": "edges/s",
        "run_spread": [edges / t for t in graph_s],
        "dtype": hp.dtype,
        "step": "cuda_graph",
        "anchor_patch_samples_per_s": sampler_rate,
    }))
    if args.profile:
        profile_steps(graph, args.profile, "graph replay")
        profile_steps(step, args.profile, "eager")
    return 0


if __name__ == "__main__":
    sys.exit(main())
