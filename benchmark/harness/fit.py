"""The training cells: Trainer.fit of subgnn_tpu_torch on a seeded dataset.

Set-up makes the dataset from the seed, runs the program's precompute
functions in memory (border sets, the all-pairs BFS and the NP sims, the
structure pool, its walks and the DTW sims of the train and val splits),
samples the anchors, fills the weights, builds one Trainer and starts its
fit. The fit's first epochs are set-up: the first three train steps are
held for the correctness check (the step's call is watched from outside),
and the steps' CUDA graphs are captured. The window then runs whole epochs
of the same fit, each with its validation pass, as fit runs them, and
closes at the first epoch end past `--seconds`. The fit then runs one more
epoch, outside the window's clock, whose every train step and validation
logits are recorded for the check, and is stopped from its
metrics_callback. With `--trace 1`, `trace_epochs` epochs of the window
run under torch.profiler.

After that the reference recomputes, from the dataset alone, the anchors,
the NP and structure sims of the rows it checks and the first three steps;
from the program's recorded state before each step of the checked epoch,
that step; and the validation logits at the program's state after it.
"""
from __future__ import annotations

import time
from typing import Any, Dict

import numpy as np
import torch

from .bounds import segment_bytes
from .common import read_per_layer
from .data import make_dataset
from .trace import Trace
from .weights import leaves, program_params

SPLITS = ("train", "val")


class StopWindow(Exception):
    """Raised from fit's metrics_callback to end the window."""


def epoch_order(n: int, batch: int, seed: int, epochs: int) -> list:
    """The (n_batches, B) train orders of fit's first `epochs` epochs: one
    shuffle of arange(n) an epoch from default_rng(seed), the short tail
    dropped (Trainer._epoch_order with drop_last)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(epochs):
        order = np.arange(n)
        rng.shuffle(order)
        nb = n // batch
        out.append(order[: nb * batch].reshape(nb, batch))
    return out


def program_setup(cell, seed: int, dev: torch.device) -> Dict[str, Any]:
    """The program's inputs of one fit: graph, splits, anchors, weights."""
    from subgnn_tpu_torch.config import HParams
    from subgnn_tpu_torch.data.dataset import (SubgraphData,
                                               initialize_cc_ids,
                                               pad_node_lists)
    from subgnn_tpu_torch.data.graph import CSRGraph
    from subgnn_tpu_torch.precompute.border import compute_border_sets
    from subgnn_tpu_torch.precompute.shortest_paths import \
        shortest_path_matrix
    from subgnn_tpu_torch.precompute.similarities import (
        compute_shortest_path_similarities, compute_structure_similarities)
    from subgnn_tpu_torch.sampling import anchors as A
    from subgnn_tpu_torch.sampling.walks import (
        perform_random_walks, sample_structure_anchor_patches)

    cfg = cell.config
    hpd = dict(cfg["hparams"], seed=seed, max_epochs=1 << 30)
    hp = HParams.from_dict(hpd)
    t0 = time.perf_counter()
    data = make_dataset(cfg)
    data_s = time.perf_counter() - t0
    n = data["n_nodes"]
    graph = CSRGraph.from_edges(data["edges"], n_nodes=n)
    lists = data["lists"]
    cc = {s: initialize_cc_ids(graph, lists[s]) for s in SPLITS}
    border = {s: None for s in SPLITS}
    np_sim = {s: None for s in SPLITS}
    i_sim = {s: None for s in SPLITS}
    b_sim = {s: None for s in SPLITS}
    timings = {"data_s": data_s}
    t0 = time.perf_counter()
    if hp.use_neighborhood:
        border = {s: compute_border_sets(graph, cc[s],
                                         hp.neigh_sample_border_size)
                  for s in SPLITS}
    timings["border_sets_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if hp.use_neighborhood or hp.use_position:
        mat = shortest_path_matrix(graph, n_threads=hp.n_processes,
                                   device=dev)
        timings["all_pairs_bfs_s"] = time.perf_counter() - t0
        np_sim = {s: compute_shortest_path_similarities(mat, cc[s])
                  for s in SPLITS}
        del mat
    timings["np_sims_s"] = time.perf_counter() - t0
    pool = iw = bw = None
    t0 = time.perf_counter()
    if hp.use_structure:
        pool = sample_structure_anchor_patches(graph, hp, seed,
                                               hp.max_sim_epochs)
        iw = perform_random_walks(graph, hp, pool, True, seed)
        bw = perform_random_walks(graph, hp, pool, False, seed)
        timings["pool_walks_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for s in SPLITS:
            i_sim[s] = compute_structure_similarities(
                graph, cc[s], pool, internal=True, device=dev)
            b_sim[s] = compute_structure_similarities(
                graph, cc[s], pool, internal=False, device=dev)
        timings["structure_sims_s"] = time.perf_counter() - t0
    anchors = {s: {} for s in SPLITS}
    tags = {"train": 0, "val": 1}
    if hp.use_neighborhood:
        for s in SPLITS:
            anchors[s]["neigh_int"], anchors[s]["neigh_bor"] = \
                A.init_anchors_neighborhood(hp, cc[s], border[s], seed,
                                            tags[s])
    if hp.use_position:
        pos_ext = A.init_anchors_pos_ext(hp, graph, seed)
        for s in SPLITS:
            anchors[s]["pos_int"] = A.init_anchors_pos_int(hp, lists[s],
                                                           seed, tags[s])
            anchors[s]["pos_ext"] = pos_ext
    if hp.use_structure:
        _, idx, siw, sbw = A.init_anchors_structure(hp, pool, iw, bw, seed)
        for s in SPLITS:
            anchors[s].update(struc_pool_idx=idx, struc_int_walks=siw,
                              struc_bor_walks=sbw)
    split = {s: SubgraphData(subgraph_ids=pad_node_lists(lists[s]),
                             cc_ids=cc[s], labels=data["labels"][s],
                             N_border=border[s], NP_sim=np_sim[s],
                             I_S_sim=i_sim[s], B_S_sim=b_sim[s])
             for s in SPLITS}
    return {"hp": hp, "data": data, "graph": graph, "cc": cc,
            "np_sim": np_sim, "i_sim": i_sim, "b_sim": b_sim,
            "pool": pool, "anchors": anchors, "split": split,
            "timings": timings}


class Watch:
    """Watches the fit's train steps from outside the program.

    The step function's returned loss is the captured graph's static
    output, which every replay rewrites (`train_step` is wrapped for the
    whole fit; a replay never calls it). The step's call is wrapped for the
    fit's first `n` steps, then undone, and again once `arm` is called at
    the window's close, for the epoch after it. Records:
      first steps   each loss, the Adam moments after step 1 and the
                    parameters after step n;
      armed epoch   the state (parameters, Adam moments and count) before
                    its first train step and after each, each step's loss,
                    and the validation logits its eval pass handed to the
                    trainer's metrics (at the state after the last step).
    """

    def __init__(self, trainer, dev: torch.device, n: int = 3):
        from subgnn_tpu_torch.train import graphs, loop
        self.loop, self.graphs = loop, graphs
        self.orig_step = loop.train_step
        self.orig_call = graphs.StepGraph.__call__
        self.trainer, self.dev, self.n = trainer, dev, n
        self.calls, self.loss = 0, None
        self.losses, self.params, self.mu = [], {}, None
        self.late = None
        watch = self

        def train_step(*a, **k):
            out = watch.orig_step(*a, **k)
            watch.loss = out[0]
            return out

        def call(graph):
            watch.orig_call(graph)
            watch.calls += 1
            watch.record()

        loop.train_step = train_step
        graphs.StepGraph.__call__ = call

    def _sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def record(self) -> None:
        self._sync()
        tr = self.trainer
        self.losses.append(float(self.loss))
        if self.calls == 1:
            self.mu = [m.detach().cpu().clone() for m in tr.opt_state["mu"]]
        if self.calls == self.n:
            self.params = {p: t.detach().cpu().clone()
                           for p, t in leaves(tr.params)}
            self.graphs.StepGraph.__call__ = self.orig_call

    def state(self) -> Dict[str, Any]:
        """The trainer's parameters, Adam moments and count, on the host."""
        self._sync()
        tr = self.trainer
        cpu = lambda ts: [t.detach().cpu().clone() for t in ts]
        return {"params": {p: t.detach().cpu().clone()
                           for p, t in leaves(tr.params)},
                "mu": cpu(tr.opt_state["mu"]), "nu": cpu(tr.opt_state["nu"]),
                "count": int(tr.opt_state["count"])}

    def arm(self, steps: int) -> None:
        """Record the next epoch's `steps` train steps and its val logits."""
        late = self.late = {"states": [], "losses": [], "val_logits": None}
        watch, done = self, [0]

        def call(graph):
            if done[0] == 0:
                late["states"].append(watch.state())
            watch.orig_call(graph)
            done[0] += 1
            if done[0] <= steps:
                watch._sync()
                late["losses"].append(float(watch.loss))
                late["states"].append(watch.state())

        orig_metrics = self.trainer._metrics

        def metrics(split, logits, *a, **k):
            if split == "val" and late["val_logits"] is None:
                late["val_logits"] = np.array(logits, np.float32)
            return orig_metrics(split, logits, *a, **k)

        self.graphs.StepGraph.__call__ = call
        self.trainer._metrics = metrics

    def undo(self) -> None:
        self.loop.train_step = self.orig_step
        self.graphs.StepGraph.__call__ = self.orig_call
        self.trainer.__dict__.pop("_metrics", None)


class Window:
    """fit's metrics_callback: warm-up epochs, then the window; at its close
    `on_close(epoch)`, and after one more epoch (the checked one), stop."""

    def __init__(self, warmup: int, seconds: float, trace_epochs: int,
                 tracer, on_start, on_close):
        self.warmup, self.seconds = warmup, seconds
        self.on_start = on_start    # called when the window opens
        self.on_close = on_close    # called when it closes
        self.trace_epochs, self.tracer = trace_epochs, tracer
        self.t_start = self.t_end = None
        self.first = None           # epoch index of the window's first
        self.ends = []              # perf_counter at each epoch's end
        self.traced = []            # window epochs under the profiler

    def __call__(self, epoch: int, metrics: Dict[str, Any]) -> None:
        now = time.perf_counter()
        if self.t_end is not None:
            raise StopWindow        # the checked epoch after the window ran
        self.ends.append(now)
        if epoch + 1 == self.warmup:
            self.t_start, self.first = now, epoch + 1
            self.on_start()
            return
        if self.t_start is None:
            return
        k = epoch - self.first          # window epochs done, minus one
        if self.tracer is not None:
            if k == 0:
                self.tracer.start()
            elif 1 <= k <= self.trace_epochs:
                self.traced.append(epoch)
                if k == self.trace_epochs:
                    self.tracer.stop()
        if now - self.t_start >= self.seconds and (
                self.tracer is None or k >= self.trace_epochs):
            self.t_end = now
            self.on_close(epoch)

    @property
    def epochs(self) -> int:
        return len(self.ends) - self.warmup


def run(cell, args, dev: torch.device, t_process: float) -> Dict[str, Any]:
    """One run of a training cell. Returns {"result", "checks",
    "controls"}; `args.controls` (not a command-line flag; control.py sets
    it) adds the control's and the half-batch fault's readings."""
    from subgnn_tpu_torch.train.loop import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seed = int(args.seed) % (1 << 62)
    tr_cfg = cell.traffic
    cfg = cell.config
    t0 = time.perf_counter()
    ps = program_setup(cell, seed, dev)
    ps["timings"]["program_setup_s"] = time.perf_counter() - t0
    hp = ps["hp"]
    n_cls = ps["data"]["num_classes"]
    model, params, state, params0 = program_params(
        hp, ps["data"]["n_nodes"], n_cls, seed, dev)
    trainer = Trainer(model, hp, ckpt_dir=None, tb_dir=None, device=dev)
    tracer = Trace(dev) if args.trace else None
    n_train = len(ps["split"]["train"])
    B = hp.batch_size
    nb = n_train // B
    marks = {}
    watch = Watch(trainer, dev)

    def on_start():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        marks["setup_s"] = time.perf_counter() - t_process
        marks["captures"] = trainer.fused_captures

    def on_close(epoch):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        marks["peak"] = (torch.cuda.max_memory_allocated(dev)
                         if dev.type == "cuda" else 0)
        marks["captures_at_end"] = trainer.fused_captures
        marks["checked_epoch"] = epoch + 1
        watch.arm(nb)

    win = Window(int(tr_cfg["warmup_epochs"]), float(args.seconds),
                 int(tr_cfg["trace_epochs"]) if args.trace else 0, tracer,
                 on_start, on_close)
    try:
        trainer.fit(params, state, ps["split"]["train"], ps["split"]["val"],
                    ps["anchors"], seed=seed, log_fn=None,
                    metrics_callback=win)
        raise RuntimeError("fit ended before the window closed")
    except StopWindow:
        pass
    finally:
        watch.undo()
    window_s = win.t_end - win.t_start
    epochs = win.epochs
    C_tr = ps["cc"]["train"].shape[1]
    C_val = ps["cc"]["val"].shape[1]
    n_val = len(ps["split"]["val"])
    ctx_walls = _clean_walls(win)
    info = {"fused": trainer.fused, "captures_at_start": marks["captures"],
            "captures_at_end": marks["captures_at_end"],
            "window_epochs": epochs, "train_steps_per_epoch": nb,
            "checked_epoch": marks["checked_epoch"],
            "epoch_walls_s": ctx_walls,
            "max_cc": {"train": C_tr, "val": C_val},
            "cc_len": {s: int(ps["cc"][s].shape[2]) for s in SPLITS},
            "setup_timings": ps["timings"]}
    ctx = {"cell": cell, "hp": cfg["hparams"], "n_classes": n_cls,
           "window_s": window_s, "epochs": epochs, "steps_per_epoch": nb,
           "batch": B, "max_cc": C_tr, "val_max_cc": C_val, "n_val": n_val,
           "clean_walls": ctx_walls, "traced_epochs": win.traced}
    orders = epoch_order(n_train, B, seed, marks["checked_epoch"] + 1)
    if args.trace:
        ctx["trace"] = tracer.reduce()
        ctx["segment_bytes"] = sum(
            _step_segment_bytes(hp, ps, orders[e][i], hp.node_embed_size)
            for e in win.traced for i in range(nb))
        ctx["traced_train_steps"] = nb * len(win.traced)
    del trainer, params, state, model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    from .check_fit import check
    t0 = time.perf_counter()
    checks, extra, controls = check(
        cell, ps, seed, dev, params0, watch, orders[-1], cell.limits,
        controls=bool(getattr(args, "controls", False)))
    info.update(extra, check_s=time.perf_counter() - t0)
    del ps, watch
    subgraphs_per_s = epochs * nb * B / window_s
    result = {"attempted": epochs, "failed": 0,
              "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                         "count": 1, "memory_peak_bytes": int(marks["peak"])},
              "info": info}
    if args.trace:
        result.update(read_per_layer(cell, ctx))
    else:
        result["metrics"] = {
            "train_subgraphs_per_s": {"value": subgraphs_per_s,
                                      "unit": "subgraphs/s"},
            "setup_s": {"value": marks["setup_s"], "unit": "s"}}
    return {"result": result, "checks": checks, "controls": controls}


def _clean_walls(win: Window) -> list:
    """Wall seconds of the window's epochs that ran without the profiler
    and without its start or stop (the epoch after the traced ones)."""
    walls = np.diff(win.ends[win.warmup - 1:])
    skip = set(win.traced)
    if win.traced:
        skip.update((win.traced[0] - 1, win.traced[-1] + 1))
    return [float(w) for i, w in enumerate(walls)
            if win.first + i not in skip]


def _step_segment_bytes(hp, ps, rows: np.ndarray, dim: int) -> int:
    """The table-gradient bytes of one train step over batch `rows`: the
    CC ids, and the neighborhood anchors when the channel is on."""
    table_rows = ps["data"]["n_nodes"] + 1
    total = segment_bytes(ps["cc"]["train"][rows], table_rows, dim)
    if hp.use_neighborhood:
        a = ps["anchors"]["train"]
        ids = np.concatenate([a["neigh_int"][:, rows],
                              a["neigh_bor"][:, rows]], axis=-1)
        total += segment_bytes(ids, table_rows, dim)
    return total
