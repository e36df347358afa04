"""A single-device forward check and a multi-rank dry run of the port.

    python -m subgnn_tpu_torch.entry

runs the flagship forward on the card, then `dryrun_multichip` over one
rank a visible card. The port's counterpart of __graft_entry__.py:

  * `entry(device)`: (fn, (params, batch)), fn the flagship forward (eval,
    no dropout) of bench.build_flagship's instance;
  * `dryrun_multichip(n, full, device)`: n ranks spawned with
    torch.multiprocessing, each running the production Trainer.fit on a
    (n / 2, 2) mesh (the table, its Adam moments and the NP sims sharded
    over the node axis) for 2 epochs on build_training_fixture with compact
    sims and trainable CC tables; then, with `full`,
    `dryrun_multichip_full(n)`;
  * `dryrun_multichip_full(n, ...)`: a 5,000-node synthetic task prepared in
    this process (cli.prepare_dataset.prepare, random embeddings), then on
    every rank SubGNNPipeline.run (precompute on the mesh, fit, test, a
    top-1 checkpoint) and a count of the collectives of one training step
    of the 5,000-node flagship batch on the mesh (parallel/audit.py), held
    to __graft_entry__.py's bounds.

Ranks. On the card with at least n cards, one rank a card over NCCL; else
(ranks sharing a card, or the CPU) gloo. A fused fit captures its
gradients' all-reduce in a CUDA graph, which NCCL allows and gloo does not
(train/loop.py:_FusedRun), so gloo ranks on the card fit in the streaming
mode (debug_mode) and every other mesh fits fused, as the JAX dry run
does. The processes join through a file:// store in a temporary directory
and hand their results back through files there.
"""
from __future__ import annotations

import json
import math
import os
import pickle
import tempfile
import time
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .bench import build_flagship, build_training_fixture
from .device import resolve_device
from .models.dropout import generator_keep_mask
from .parallel import mesh as MX
from .parallel.audit import count_collectives
from .train.loop import Trainer, device_batch, loss_and_grads, make_optimizer
from .train.plans import PlanBuilder, batch_plans

SPAWN_TIMEOUT_S = 600       # a dry run's ranks, spawn to exit


def entry(device: str | torch.device = "cuda"):
    """(fn, (params, batch)): fn(params, batch) -> the flagship forward's
    (32, 4) logits, eval mode, no dropout; batch as tensors on `device`."""
    dev = resolve_device(device)
    model, _, params, state, batch, anchors = build_flagship(device=dev)
    anchors = device_batch(anchors, dev)

    def forward(params, batch):
        with torch.no_grad():
            logits, _ = model(params, state, batch, anchors, train=False)
        return logits

    return forward, (params, device_batch(batch, dev))


# ------------------------------------------------------------------ ranks

def mesh_axes(n: int):
    """(n_data, n_node) of an n-rank dry run: a node axis of 2 when n is
    even (__graft_entry__.py:209-211)."""
    n_node = 2 if n >= 2 and n % 2 == 0 else 1
    return n // n_node, n_node


def rank_backend(n: int, device) -> str:
    """NCCL for one rank a card, gloo where ranks share a card or run on
    the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda" and n <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _rank_device(rank: int, n: int, device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    return torch.device("cuda", rank % torch.cuda.device_count())


def _expect(ok: bool, what) -> None:
    """A dry-run check: raises AssertionError (also under python -O)."""
    if not ok:
        raise AssertionError(what)


def _fit_fused(dev: torch.device, backend: str) -> bool:
    """Whether a mesh fit can take the fused mode (module docstring)."""
    return dev.type == "cpu" or backend == "nccl"


def _rank_main(rank: int, n: int, device: str, job: str, args: tuple,
               tmp: str) -> None:
    """One spawned rank: join the group, run JOBS[job](mesh device, n,
    backend, *args), pickle its result to <tmp>/<job>.<rank>.pkl."""
    dev = _rank_device(rank, n, device)
    backend = rank_backend(n, device)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(backend, init_method=f"file://{tmp}/store",
                            world_size=n, rank=rank)
    try:
        out = JOBS[job](dev, n, backend, *args)
        with open(Path(tmp) / f"{job}.{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _spawn(n: int, device, job: str, *args) -> list:
    """JOBS[job] on n spawned ranks; each rank's result, in rank order."""
    resolve_device(device)
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(_rank_main,
                                 args=(n, str(device), job, args, tmp),
                                 nprocs=n, join=False, start_method="spawn")
        deadline = time.monotonic() + SPAWN_TIMEOUT_S
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for proc in ctx.processes:
                    proc.kill()
                raise TimeoutError(f"the {n} ranks of the {job!r} dry run "
                                   f"did not finish in {SPAWN_TIMEOUT_S} s")
        out = []
        for r in range(n):
            with open(Path(tmp) / f"{job}.{r}.pkl", "rb") as f:
                out.append(pickle.load(f))
    return out


# ------------------------------------------------------------ the fit

def _fit_job(dev: torch.device, n: int, backend: str) -> Dict[str, Any]:
    """__graft_entry__.py:187-242 on this rank: the production Trainer.fit
    on a (n_data, n_node) mesh, 2 epochs, compact sims, trainable CCs."""
    n_data, n_node = mesh_axes(n)
    fused = _fit_fused(dev, backend)
    batch_size = 8 * n_data // math.gcd(8, n_data)     # divides over data
    model, hp, params, state, data, anchors, eval_cc = build_training_fixture(
        n_nodes=128, n_train=2 * batch_size, n_val=batch_size, C=2, L=4,
        hp_overrides=dict(mesh_data_axis=n_data, mesh_node_axis=n_node,
                          batch_size=batch_size, max_epochs=2,
                          trainable_cc=True, debug_mode=not fused),
        device=dev)
    mesh = MX.make_device_mesh(n_data, n_node, device=dev)
    trainer = Trainer(model, hp, eval_cc_tables=eval_cc, device=dev,
                      mesh=mesh)
    trainer.compact_sims = True          # the anchor-column sims path
    last = trainer.fit(params, state, data["train"], data["val"], anchors,
                       seed=0, log_fn=None)
    rows = int(params["node_embed"].shape[0])
    held = int(trainer.params["node_embed"].shape[0])
    _expect(trainer.fused == fused, f"the fit took the "
            f"{'fused' if trainer.fused else 'streaming'} mode")
    _expect(np.isfinite(last["train_loss"]), last)
    _expect(np.isfinite(last["val_loss"]), last)
    _expect(held * n_node == rows, (held, rows, n_node))
    return {"mesh": mesh.shape, "backend": backend, "fused": trainer.fused,
            "train_loss": float(last["train_loss"]),
            "val_loss": float(last["val_loss"]), "table_rows": rows,
            "rows_held": held, "device": str(dev)}


def dryrun_multichip(n_devices: int, full: bool = True,
                     device: str | torch.device = "cuda") -> Dict[str, Any]:
    """Trainer.fit over an n_devices-rank mesh (module docstring), then,
    with `full`, dryrun_multichip_full(n_devices). Returns rank 0's fit
    result (with the full run's under "full")."""
    t0 = time.perf_counter()
    ranks = _spawn(n_devices, device, "fit")
    res = dict(ranks[0], seconds=time.perf_counter() - t0)
    for r in ranks[1:]:
        _expect(r["train_loss"] == res["train_loss"], ranks)
    print(f"dryrun_multichip({n_devices}): mesh={res['mesh']} "
          f"({res['backend']}, {res['device']}) Trainer.fit "
          f"{'fused' if res['fused'] else 'streaming'} epochs=2 "
          f"train_loss={res['train_loss']:.4f} table rows held "
          f"{res['rows_held']} of {res['table_rows']} ok")
    if full:
        res["full"] = dryrun_multichip_full(n_devices, device=device)
    return res


# -------------------------------------------------------- the full run

def _mesh_step(model, hp, params, state, batch, anchors, mesh: MX.Mesh):
    """(step, leaves): step() runs one training forward and backward of the
    host `batch` on `mesh` as Trainer's streaming step does (this rank's
    rows of the batch and of the table, its shard plans, the gradients
    all-reduced over the data group), without the update; leaves are the
    trainable leaves it all-reduces the gradients of."""
    dev = mesh.device
    rows = int(params["node_embed"].shape[0])
    row_range = mesh.shard_rows(rows) if mesh.sharded else None
    own = params if row_range is None else dict(
        params,
        node_embed=params["node_embed"][row_range[0]:row_range[1]].clone())
    n_valid = int(np.asarray(batch["valid"]).sum())
    local = MX.shard_batch(batch, mesh)
    local.update(batch_plans(PlanBuilder(rows, row_range), hp,
                             local["cc_ids"], anchors, local["subgraph_idx"]))
    local = device_batch(local, dev)
    anchors_dev = device_batch(anchors, dev)
    tx = make_optimizer(hp)
    tx.init(own)                        # marks the trainable leaves
    keep_mask = generator_keep_mask(
        torch.Generator(device=dev).manual_seed(0),
        (mesh.n_data, mesh.data_index))

    def step():
        return loss_and_grads(model, tx, own, state, local, anchors_dev,
                              keep_mask, mesh, n_valid)

    return step, tx.trainable(own)


def _full_job(dev: torch.device, n: int, backend: str, root: str,
              n_nodes: int) -> Dict[str, Any]:
    """__graft_entry__.py:296-340 on this rank: run() on the mesh, then the
    collective audit of one flagship training step at n_nodes."""
    from .config import HParams, RunConfig
    from .ops import dtw as kdtw
    from .ops import embedding as E
    from .train.runner import SubGNNPipeline

    root = Path(root)
    n_data, n_node = mesh_axes(n)
    hp = HParams(max_epochs=3, batch_size=16, node_embed_size=64,
                 n_layers=2, max_sim_epochs=1, n_triangular_walks=2,
                 random_walk_len=4, sample_walk_len=10,
                 mesh_data_axis=n_data, mesh_node_axis=n_node,
                 debug_mode=not _fit_fused(dev, backend))
    rc = RunConfig(task="dryrun5k", project_root=root)
    pipe = SubGNNPipeline(rc, hp, device=dev, results_dir=root / "results",
                          checkpoint_k=1)
    kdtw.dtw_distance_grouped.launches = kdtw.dtw_distance_grouped.pairs = 0
    E.segment_matmul.launches = 0
    t0 = time.perf_counter()
    out = pipe.run(log_fn=None)
    run_s = time.perf_counter() - t0
    launches = {"dtw_grouped": kdtw.dtw_distance_grouped.launches,
                "dtw_pairs": kdtw.dtw_distance_grouped.pairs,
                "segment_matmul": E.segment_matmul.launches}
    _expect(np.isfinite(out["best_monitor"]), out)
    _expect(np.isfinite(out["test"]["test_micro_f1"]), out)
    dist.barrier()                      # rank 0 wrote the run's files
    results = root / "results"
    _expect(list(results.rglob("*.ckpt")), f"no checkpoint under {results}")
    _expect((results / "test_results.json").exists(),
            "no test_results.json")

    # the collective audit of one step of the flagship batch at this
    # instance's node count (__graft_entry__.py:314-330)
    model, fhp, params, state, batch, anchors = build_flagship(
        n_nodes=n_nodes, n_sub=hp.batch_size, C=3, L=16, n_pool=40,
        hp_overrides=dict(node_embed_size=64), device=dev)
    mesh = MX.make_device_mesh(n_data, n_node, device=dev)
    step, leaves = _mesh_step(model, fhp, params, state, batch, anchors, mesh)
    audit = count_collectives(step)
    # the gradients' all-reduce over the data group carries the trainable
    # leaves this rank holds: every replicated leaf whole and, on a node
    # axis, its rows of the table (JAX's bound counts the whole table)
    grad_bytes = sum(t.numel() * t.element_size() for t in leaves)
    _expect(audit["counts"].get("all-reduce", 0) >= (
        (1 if n_data > 1 else 0) + (1 if n_node > 1 else 0)), audit)
    _expect(audit["by_helper"]["all_reduce_sum_"] == (1, grad_bytes),
            (audit, grad_bytes))
    _expect(audit["bytes"]["all-reduce"] >= grad_bytes * (n_data > 1),
            (audit, grad_bytes))
    return {"mesh": {"data": n_data, "node": n_node},
            "best_monitor": float(out["best_monitor"]),
            "test_micro_f1": float(out["test"]["test_micro_f1"]),
            "collective_counts": audit["counts"],
            "collective_bytes": audit["bytes"],
            "collective_by_helper": audit["by_helper"],
            "grad_bytes": grad_bytes, "fused": pipe.trainer.fused,
            "backend": backend, "device": str(dev), "run_seconds": run_s,
            "launches": launches}


def dryrun_multichip_full(n_devices: int = 8, n_nodes: int = 5000,
                          n_subgraphs: int = 64, workdir=None,
                          device: str | torch.device = "cuda"
                          ) -> Dict[str, Any]:
    """The whole pipeline at scale on n_devices ranks (module docstring):
    prepare here, then on every rank run() (mesh precompute, fit, test,
    checkpoint) and the collective audit. Returns and prints
    __graft_entry__.py's result keys (mesh, n_nodes, n_subgraphs,
    best_monitor, test_micro_f1, collective_counts, collective_bytes: rank
    0's) and the port's own: `collective_by_helper`, `grad_bytes` (what the
    data all-reduce carries), `fused`, `backend`, `seconds` (the whole
    call), `prepare_seconds`, and `ranks` (each rank's run seconds and
    kernel launches)."""
    from .cli.prepare_dataset import prepare
    from .prepare.node_emb import save_embeddings

    dev = resolve_device(device)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(workdir if workdir is not None else tmp)
        task_dir = root / "dryrun5k"
        if not (task_dir / "subgraphs.pth").exists():
            # random embeddings in place of the GIN pretrain (the stages
            # under test do not read them)
            prepare(str(task_dir), "density", seed=11, generate_emb=False,
                    n=n_nodes, n_subgraphs=n_subgraphs, n_subgraph_nodes=15,
                    log_fn=None, device=dev.type)
            emb = np.random.default_rng(0).normal(
                size=(n_nodes, 64)).astype(np.float32)
            save_embeddings(task_dir, emb, "gin")
        prepare_s = time.perf_counter() - t0
        ranks = _spawn(n_devices, device, "full", str(root), n_nodes)
    first = ranks[0]
    for r in ranks[1:]:
        _expect((r["best_monitor"], r["test_micro_f1"]) == (
            first["best_monitor"], first["test_micro_f1"]), ranks)
    result = {"mesh": first["mesh"], "n_nodes": n_nodes,
              "n_subgraphs": n_subgraphs,
              **{k: first[k] for k in (
                  "best_monitor", "test_micro_f1", "collective_counts",
                  "collective_bytes", "collective_by_helper", "grad_bytes",
                  "fused", "backend")},
              "seconds": time.perf_counter() - t0,
              "prepare_seconds": prepare_s,
              "ranks": [{k: r[k] for k in ("device", "run_seconds",
                                           "launches")} for r in ranks]}
    print("dryrun_multichip_full:", json.dumps(result))
    return result


JOBS = {"fit": _fit_job, "full": _full_job}


def main() -> None:
    fn, args = entry()
    out = fn(*args)
    print("entry forward:", tuple(out.shape))
    dryrun_multichip(torch.cuda.device_count())


if __name__ == "__main__":
    main()
