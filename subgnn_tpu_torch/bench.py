"""Fixtures and measuring helpers of the port, shared by the tests,
chip_smoke.py, kernel_times.py and entry.py.

`build_flagship` and `build_training_fixture` are the port's copies of
__graft_entry__._build_flagship and _build_training_fixture: the same numpy
draws in the same order, so the same seed gives the same batches, splits
and anchors as the JAX package's. `bench_batch` is one training batch at
bench.py's flagship widths (`flagship_hparams`: D=128, 2 layers, all three
channels, B=1280 in bf16 or B=512 in fp32, gather plans and compact
anchor-column similarities). `profile_steps` times steps unprofiled and
traced and prints the device's busy time and idle share; `device_sampler`
times the device triangular-walk sampler; `card` names the card.

The port's throughput is measured by its benchmark (`benchmark/`,
BENCHMARK.json), not here.
"""
from __future__ import annotations

import subprocess
import sys
import time

import numpy as np
import torch

from .config import HParams
from .data.dataset import SubgraphData
from .models.subgnn import CHANNEL_CC_KEYS, SubGNNModel


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
