"""End-to-end pipeline: load -> precompute -> anchors -> train -> test
(`run`), and serving: load -> precompute -> predict.

Port of subgnn_tpu/train/runner.py (SubGNNPipeline): the same files,
caches, RNG streams, JSON artifacts and request flow, with the model and the
structure DTW on a torch device and every BFS (the all-pairs matrix,
serving's rows on a worker thread) in the C++ host library. `run` trains
through train/loop.py:Trainer on `split_data`, `sample_anchors` and
`eval_cc_tables`, with the JAX run's train holdout, checkpoint restore,
lr_find, per-epoch anchor resampling and resume, and tests the best
checkpoint; on a (data, node) mesh when the hparams ask for one
(mesh_data_axis, mesh_node_axis, parallel/mesh.py), one process a rank.
"""
from __future__ import annotations

import json
import threading
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..config import HParams, RunConfig
from ..convert import tree_from_numpy
from ..data.dataset import SubgraphData, initialize_cc_ids, pad_node_lists
from ..data.graph import CSRGraph
from ..data.subgraphs import (MultiLabelBinarizer, read_subgraphs,
                              reindex_subgraphs)
from ..device import resolve_device
from ..models.subgnn import CHANNEL_CC_KEYS, SubGNNModel
from ..parallel import mesh as MX
from ..precompute.border import border_sets_from_rows, compute_border_sets
from ..precompute.shortest_paths import (shortest_path_matrix,
                                         shortest_path_rows)
from ..precompute.similarities import (border_set_path, cached,
                                       compute_shortest_path_similarities,
                                       compute_structure_similarities,
                                       np_sim_path, path_column_block,
                                       shortest_path_similarities_mesh,
                                       struc_patches_path, struc_sim_path,
                                       struc_walks_path,
                                       structure_similarities_both)
from ..sampling.anchors import (init_anchors_neighborhood,
                                init_anchors_pos_ext, init_anchors_pos_int,
                                init_anchors_structure)
from ..sampling.walks import (perform_random_walks,
                              sample_structure_anchor_patches)
from .checkpoint import dump_json, load_checkpoint, load_params_filtered
from .loop import Trainer, make_optimizer
from .sims import compact_sims_for_batch
from .spans import span

SPLITS = ("train", "val", "test")
SPLIT_TAG = {"train": 0, "val": 1, "test": 2}
PAD_VALUE = 0
PREDICT_TAG = 3  # serving RNG stream, disjoint from the split tags 0-2

# above this node count the (n, n) all-pairs matrix (>= 1.6 GB and growing
# quadratically) is never materialized; NP sims BFS from CC sources only
_FULL_SP_MAX_NODES = 20_000
# an existing shortest_path_matrix.npy larger than this is memory-mapped, so
# the NP-sim CC-min reads only the rows it needs
_SP_MMAP_BYTES = 1 << 30


def load_embeddings(path: Path) -> np.ndarray:
    """Load pretrained node embeddings: .pth (torch tensor) or .npy."""
    npy = path.with_suffix(".npy")
    if path.suffix == ".pth" and path.exists():
        t = torch.load(str(path), map_location="cpu", weights_only=False)
        return np.asarray(t.detach().numpy() if hasattr(t, "detach") else t,
                          dtype=np.float32)
    if npy.exists():
        return np.load(npy).astype(np.float32)
    raise FileNotFoundError(path)


class SubGNNPipeline:
    # serving: max shortest-path rows LRU-cached across predict() calls
    BFS_ROW_CACHE_SIZE = 2048

    def __init__(self, run_config: RunConfig, hp: HParams,
                 device: str | torch.device = "cuda", *,
                 results_dir: Optional[str | Path] = None,
                 checkpoint_k: int = 3,
                 train_holdout: Optional[np.ndarray] = None):
        self.rc = run_config
        self.hp = hp
        self.device = resolve_device(device)
        self.results_dir = Path(results_dir) if results_dir else None
        self.checkpoint_k = checkpoint_k  # 0 disables checkpointing
        # train-split rows carved out for nested model selection: fit never
        # sees them; run() scores them with the best-val checkpoint like a
        # non-train split (out["holdout"])
        self.train_holdout = (None if train_holdout is None
                              else np.unique(np.asarray(train_holdout,
                                                        np.int64)))
        self._loaded = False
        self.structure_anchors = self.int_walks = self.bor_walks = None
        self.precompute_timings: Dict[str, float] = {}
        self._bfs_row_cache: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self._bfs_cache_lock = threading.Lock()
        self._serving_anchor_seqs: Dict[str, Any] = {}
        self._serving_anchor_cache: Dict[int, Dict[str, Any]] = {}
        self._predict_model: Optional[SubGNNModel] = None

    # ------------------------------------------------------------------ load

    def load(self):
        """Read graph/subgraphs/embeddings (reference: SubGNN.py:519-570)."""
        rc, hp = self.rc, self.hp
        self.graph = CSRGraph.from_edgelist(rc.graph_path())
        (tr, trl, va, val, te, tel, multilabel) = read_subgraphs(
            rc.subgraphs_path())
        self.multilabel = multilabel
        if multilabel:
            self.binarizer = MultiLabelBinarizer().fit(
                list(trl) + list(val) + list(tel))
            self.num_classes = len(self.binarizer.classes_)
        else:
            self.binarizer = None
            self.num_classes = int(max(trl.max(), val.max(), tel.max())) + 1
        if hp.subset_data:
            b = hp.batch_size
            tr, trl = tr[:b], trl[:b]
            va, val = va[:b], val[:b]
            te, tel = te[:b], tel[:b]
        self.subgraphs = {"train": reindex_subgraphs(tr),
                          "val": reindex_subgraphs(va),
                          "test": reindex_subgraphs(te)}
        self.labels = {"train": trl, "val": val, "test": tel}
        emb = load_embeddings(rc.embedding_path(hp.embedding_type))
        self.pretrained_embeds = emb
        self.hp = hp.replace(node_embed_size=int(emb.shape[1]))
        self.cc_ids = {s: initialize_cc_ids(self.graph, self.subgraphs[s])
                       for s in SPLITS}
        self._loaded = True
        return self

    # ------------------------------------------------------------ precompute

    def precompute(self, recompute: Optional[bool] = None,
                   mesh: Optional[MX.Mesh] = None):
        """Border sets, N/P shortest-path sims, the structure anchor pool and
        its walks, and the structure DTW sims of every split, cached under
        <task>/similarities with the JAX package's (and the reference's)
        filenames (subgnn_tpu/train/runner.py:147-282; reference
        SubGNN.py:673-989). The all-pairs BFS (the C++ host library,
        hp.n_processes threads) runs on the host, and without a mesh the
        NP-sim CC-min too; the DTW kernel runs once per split and side on
        the pipeline's device.
        Each stage's seconds go to `precompute_timings` (and are printed
        when over 5 s). `recompute`: ignore the caches (default
        hp.compute_similarities).

        On a mesh (parallel/mesh.py) every rank calls this: the host
        arrays (border sets, pool, walks) are computed by every rank from
        the seed, the NP-sim CC-min runs on each rank's column block of the
        path matrix and the DTW on each rank's block of comps, both
        gathered to every rank; rank 0 alone writes files."""
        if not self._loaded:
            raise RuntimeError("call load() first")
        rc, hp = self.rc, self.hp
        sim_dir = rc.similarities_path()
        if recompute is None:
            recompute = hp.compute_similarities
        lead = mesh is None or mesh.lead
        if hp.subset_data:
            # truncated splits: never read or write the full-data caches
            def cache(path, fn, recompute=False):
                return fn()
        elif mesh is None:
            sim_dir.mkdir(parents=True, exist_ok=True)
            cache = cached
        else:
            def cache(path, fn, recompute=False):
                # rank 0 decides each hit and every rank follows: a rank
                # looking for itself could find a file rank 0 has just
                # written, and skip the collectives rank 0 waits in
                hit = MX.broadcast_object(
                    not recompute and Path(path).exists(), mesh.group)
                return cached(path, fn, hit=hit, save=lead)
        self.precompute_timings = {}
        t0 = time.time()

        def stage(name):
            nonlocal t0
            dt = time.time() - t0
            self.precompute_timings[name] = dt
            if dt > 5 and lead:
                print(f"[precompute] {name}: {dt:.1f}s", flush=True)
            t0 = time.time()

        self.border = {s: None for s in SPLITS}
        if hp.use_neighborhood:
            for s in SPLITS:
                self.border[s] = cache(
                    border_set_path(sim_dir, hp.neigh_sample_border_size, s),
                    lambda s=s: compute_border_sets(
                        self.graph, self.cc_ids[s],
                        hp.neigh_sample_border_size),
                    recompute)
        stage("border sets")

        self.np_sim = {s: None for s in SPLITS}
        if hp.use_neighborhood or hp.use_position:
            shortest = None   # (matrix or rows, row LUT or None), on a miss

            def np_sims(s):
                nonlocal shortest
                save = not hp.subset_data
                if shortest is None:
                    shortest = (self._shortest(save) if mesh is None
                                else self._shortest_block(mesh, save))
                mat, lut = shortest
                ids = self.cc_ids[s] if lut is None else lut[self.cc_ids[s]]
                if mesh is None:
                    return compute_shortest_path_similarities(mat, ids)
                return shortest_path_similarities_mesh(
                    mat, self.graph.n_nodes, ids, mesh)

            for s in SPLITS:
                self.np_sim[s] = np.asarray(cache(
                    np_sim_path(sim_dir, s), lambda s=s: np_sims(s),
                    recompute), dtype=np.float32)
        stage("NP similarities")

        self.int_s_sim = {s: None for s in SPLITS}
        self.bor_s_sim = {s: None for s in SPLITS}
        self.structure_anchors = self.int_walks = self.bor_walks = None
        if hp.use_structure:
            if hp.structure_similarity_fn != "dtw":
                raise NotImplementedError(hp.structure_similarity_fn)
            self.structure_anchors = cache(
                struc_patches_path(sim_dir, hp),
                lambda: sample_structure_anchor_patches(
                    self.graph, hp, hp.seed, hp.max_sim_epochs),
                recompute).astype(np.int32)
            stage("structure pool")
            self.int_walks = cache(
                struc_walks_path(sim_dir, hp, True),
                lambda: perform_random_walks(self.graph, hp,
                                             self.structure_anchors, True,
                                             hp.seed),
                recompute).astype(np.int32)
            self.bor_walks = cache(
                struc_walks_path(sim_dir, hp, False),
                lambda: perform_random_walks(self.graph, hp,
                                             self.structure_anchors, False,
                                             hp.seed),
                recompute).astype(np.int32)
            stage("structure walks")
            for s in SPLITS:
                for internal, out in ((True, self.int_s_sim),
                                      (False, self.bor_s_sim)):
                    out[s] = cache(
                        struc_sim_path(sim_dir, hp, internal, s),
                        lambda s=s, internal=internal:
                            compute_structure_similarities(
                                self.graph, self.cc_ids[s],
                                self.structure_anchors, internal=internal,
                                device=self.device, mesh=mesh),
                        recompute).astype(np.float32)
            stage("structure DTW similarities")
        return self

    def _shortest(self, save: bool = True):
        """(hop-distance rows, row LUT or None) for the NP-sim CC-min: an
        existing shortest_path_matrix.npy (memory-mapped above
        _SP_MMAP_BYTES); above _FULL_SP_MAX_NODES, BFS rows from the CC
        nodes of every split only, with a LUT from 1-based node id to
        1-based row (PAD 0 stays 0); else the full matrix, built (and
        saved when `save`)."""
        sp_path = self.rc.shortest_paths_path()
        if sp_path.exists():
            mm = "r" if sp_path.stat().st_size > _SP_MMAP_BYTES else None
            return np.load(sp_path, mmap_mode=mm), None
        return self._build_shortest(save)

    def _row_sources(self):
        """(the CC nodes of every split, 1-based and sorted; the LUT from
        1-based node id to 1-based row, PAD 0 staying 0): the rows of a
        graph above _FULL_SP_MAX_NODES."""
        srcs = np.unique(np.concatenate(
            [self.cc_ids[s].ravel() for s in SPLITS]))
        srcs = srcs[srcs != PAD_VALUE].astype(np.int64)
        lut = np.zeros(self.graph.n_nodes + 1, np.int32)
        lut[srcs] = np.arange(1, len(srcs) + 1, dtype=np.int32)
        return srcs, lut

    def _build_shortest(self, save: bool):
        """_shortest without a matrix file: the BFS rows with their LUT, or
        the full matrix (saved when `save`)."""
        hp = self.hp
        if self.graph.n_nodes > _FULL_SP_MAX_NODES:
            srcs, lut = self._row_sources()
            return shortest_path_rows(self.graph, srcs,
                                      n_threads=hp.n_processes), lut
        mat = shortest_path_matrix(self.graph, n_threads=hp.n_processes,
                                   device=self.device)
        if save:
            np.save(self.rc.shortest_paths_path(), mat)
        return mat, None

    def _shortest_block(self, mesh: MX.Mesh, save: bool):
        """_shortest on a mesh: (this rank's column block of the rows,
        float32 on its device; the row LUT or None). An existing
        shortest_path_matrix.npy is memory-mapped by every rank, which
        reads its block only; otherwise rank 0 builds the matrix (or the
        rows) as _shortest does and scatters the column blocks
        (`scatter_world_cols`)."""
        n = self.graph.n_nodes
        sp_path = self.rc.shortest_paths_path()
        # rank 0 decides: it may write the file below while the others look
        if MX.broadcast_object(sp_path.exists(), mesh.group):
            return path_column_block(np.load(sp_path, mmap_mode="r"),
                                     mesh), None
        mat = self._build_shortest(save)[0] if mesh.lead else None
        n_rows, lut = n, None
        if n > _FULL_SP_MAX_NODES:
            srcs, lut = self._row_sources()
            n_rows = len(srcs)
        return MX.scatter_world_cols(mat, n_rows, n, mesh), lut

    # --------------------------------------------------------------- anchors

    @staticmethod
    def _subset_split_anchors(split_anchors: Dict[str, Any],
                              idx: np.ndarray) -> Dict[str, Any]:
        """One split's anchor arrays restricted to subgraph rows `idx`:
        neigh_int/neigh_bor (L, N, C, A) and pos_int (L, N, A) slice their
        subgraph axis; pos_ext and the structure arrays are split-wide."""
        out = dict(split_anchors)
        for k in ("neigh_int", "neigh_bor", "pos_int"):
            if k in out:
                out[k] = out[k][:, idx]
        return out

    def sample_anchors(self, seed: Optional[int] = None
                       ) -> Dict[str, Dict[str, np.ndarray]]:
        """Per-split host anchor arrays, the form Trainer.fit / evaluate
        take (subgnn_tpu/train/runner.py:sample_anchors; reference
        SubGNN.py:1047-1061). pos_ext and the structure arrays are shared
        by every split."""
        hp = self.hp
        seed = hp.seed if seed is None else seed
        anchors: Dict[str, Dict[str, np.ndarray]] = {s: {} for s in SPLITS}
        if hp.use_neighborhood:
            for s in SPLITS:
                anchors[s]["neigh_int"], anchors[s]["neigh_bor"] = \
                    init_anchors_neighborhood(hp, self.cc_ids[s],
                                              self.border[s], seed,
                                              SPLIT_TAG[s])
        if hp.use_position:
            pos_ext = init_anchors_pos_ext(hp, self.graph, seed)
            for s in SPLITS:
                anchors[s]["pos_int"] = init_anchors_pos_int(
                    hp, self.subgraphs[s], seed, SPLIT_TAG[s])
                anchors[s]["pos_ext"] = pos_ext
        if hp.use_structure:
            _, idx, iw, bw = init_anchors_structure(
                hp, self.structure_anchors, self.int_walks, self.bor_walks,
                seed)
            for s in SPLITS:
                anchors[s].update(struc_pool_idx=idx, struc_int_walks=iw,
                                  struc_bor_walks=bw)
        return anchors

    # ------------------------------------------------------------------ data

    def split_data(self, split: str) -> SubgraphData:
        """One split's arrays after precompute()
        (subgnn_tpu/train/runner.py:split_data)."""
        labels = self.labels[split]
        if self.multilabel:
            labels = self.binarizer.transform(labels)
        else:
            labels = np.asarray(labels, dtype=np.int64)
        return SubgraphData(
            subgraph_ids=pad_node_lists(self.subgraphs[split]),
            cc_ids=self.cc_ids[split], labels=labels,
            N_border=self.border[split], NP_sim=self.np_sim[split],
            I_S_sim=self.int_s_sim[split], B_S_sim=self.bor_s_sim[split],
            multilabel=self.multilabel)

    # ----------------------------------------------------------------- model

    def _cc_tables_from_ids(self, ids: np.ndarray) -> Dict[str, np.ndarray]:
        """Initial per-channel CC tables from the PRETRAINED embeddings
        (reference: SubGNN.py:609-668)."""
        table = np.concatenate([np.zeros((1, self.hp.node_embed_size),
                                         np.float32),
                                self.pretrained_embeds], axis=0)
        emb = table[ids]  # (N, C, L, D)
        cc = emb.sum(axis=2) if self.hp.cc_aggregator == "sum" \
            else emb.max(axis=2)
        return {k: cc.copy() for k in CHANNEL_CC_KEYS}

    def build_model(self, seed: Optional[int] = None):
        """(model, params, state) with parameters drawn from a seeded
        torch.Generator on the pipeline's device."""
        hp = self.hp
        seed = hp.seed if seed is None else seed
        model = SubGNNModel(hp, self.graph.n_nodes, self.num_classes,
                            self.multilabel)
        train_cc = (self._cc_tables_from_ids(self.cc_ids["train"])
                    if hp.trainable_cc else None)
        gen = torch.Generator().manual_seed(seed)
        params, state = model.init_params(gen, self.pretrained_embeds,
                                          train_cc, device=self.device)
        return model, params, state

    def eval_cc_tables(self) -> Optional[Dict[str, Dict[str, torch.Tensor]]]:
        """The val and test CC tables, from the PRETRAINED embeddings, on the
        pipeline's device, in the form Trainer(eval_cc_tables=...) takes;
        None without hp.trainable_cc (the fourth value of the JAX
        package's build_model, subgnn_tpu/train/runner.py:372-376; val/test
        stay at this init as node embeddings train, a reference quirk)."""
        if not self.hp.trainable_cc:
            return None
        return {s: {k: torch.as_tensor(v, device=self.device) for k, v in
                    self._cc_tables_from_ids(self.cc_ids[s]).items()}
                for s in ("val", "test")}

    # ------------------------------------------------------------------- run

    def run(self, seed: Optional[int] = None, log_fn=print,
            restore_path: Optional[str | Path] = None,
            resume_path: Optional[str | Path] = None,
            profile_dir: Optional[str | Path] = None,
            metrics_callback=None) -> Dict[str, Any]:
        """Full train + test cycle (subgnn_tpu/train/runner.py:381-546).
        Under results_dir it writes the
        reference's JSON artifacts (hyperparams.json, trainer_kwargs.json,
        final_metric_scores.json, test_results.json), TensorBoard scalars
        (tb/) and the top-k checkpoints (checkpoints/).

        On a mesh (the hparams' mesh_data_axis x mesh_node_axis > 1, one
        process a rank of the default process group: parallel/mesh.py)
        every rank runs this whole method: every rank precomputes on the
        mesh (`precompute(mesh=)`: the NP-sim CC-min and the DTW pairs
        spread over the ranks, as subgnn_tpu/train/runner.py:401), trains
        its rows of each batch (on a node axis, with its shard of the
        table) and tests the best checkpoint; rank 0 alone writes files.

        restore_path: filtered load of a checkpoint's weights and model
        state (the JAX package's or the port's), then train max_epochs from
        scratch: the reference's -restoreModelName (train.py:264-273).
        resume_path: continue a run from one of its own checkpoints (params,
        Adam state, model state, step count and dropout generator) to
        max_epochs, reproducing the uninterrupted run. profile_dir: a
        torch.profiler trace of the fit (Trainer.fit). Testing uses the
        best checkpoint's weights and model state. Returns {"val": the last
        epoch's metrics, "test", "holdout" (None without train_holdout),
        "best_monitor"}."""
        hp = self.hp
        seed = hp.seed if seed is None else seed
        mesh = MX.mesh_from_hparams(hp, device=self.device)
        lead = mesh is None or mesh.lead
        self.load()
        self.precompute(mesh=mesh)
        anchors = self.sample_anchors(seed)
        model, params, state = self.build_model(seed)
        eval_cc = self.eval_cc_tables()
        train_data = self.split_data("train")
        val_data = self.split_data("val")

        holdout_idx = keep_idx = holdout_data = None
        if self.train_holdout is not None:
            n_train = len(self.subgraphs["train"])
            H = self.train_holdout
            if not (len(H) and H.min() >= 0 and H.max() < n_train):
                raise ValueError(f"train_holdout rows must lie in "
                                 f"[0, {n_train}), got {H.min()}..{H.max()}")
            holdout_idx = H
            keep_idx = np.setdiff1d(np.arange(n_train), H)
            anchors = dict(anchors)
            anchors["holdout"] = self._subset_split_anchors(
                anchors["train"], holdout_idx)
            anchors["train"] = self._subset_split_anchors(
                anchors["train"], keep_idx)
            holdout_data = train_data.subset(holdout_idx)
            train_data = train_data.subset(keep_idx)
            if hp.trainable_cc:
                # the held-out rows are scored like a non-train split, from
                # PRETRAINED-initialised CC tables; the trainable train
                # table shrinks to the kept rows
                keep = torch.as_tensor(keep_idx, device=self.device)
                params["train_cc"] = {k: v[keep]
                                      for k, v in params["train_cc"].items()}
                eval_cc = dict(eval_cc)
                eval_cc["holdout"] = {
                    k: torch.as_tensor(v[holdout_idx], device=self.device)
                    for k, v in self._cc_tables_from_ids(
                        self.cc_ids["train"]).items()}

        if restore_path:
            payload = load_checkpoint(restore_path)
            params = load_params_filtered(restore_path, params,
                                          payload=payload)
            # the model state (batch-norm running stats) travels with the
            # weights it was trained with
            if payload.get("state") is not None:
                state = tree_from_numpy(payload["state"], self.device)

        ckpt_dir = (self.results_dir / "checkpoints"
                    if self.results_dir and self.checkpoint_k > 0 else None)
        tb_dir = self.results_dir / "tb" if self.results_dir else None
        trainer = Trainer(model, hp, ckpt_dir=ckpt_dir,
                          monitor=self.rc.monitor_metric,
                          checkpoint_k=max(self.checkpoint_k, 1),
                          eval_cc_tables=eval_cc, tb_dir=tb_dir,
                          device=self.device, mesh=mesh)
        devices = ([str(self.device)] if mesh is None
                   else MX.all_gather_objects(str(mesh.device), mesh))
        if self.results_dir and lead:
            dump_json(self.results_dir / "hyperparams.json", hp.to_dict())
            # the reference's trainer-kwargs sidecar (train_config.py:
            # 179-183), with the JAX run's keys
            tkw = {
                "max_epochs": hp.max_epochs,
                "gpus": 1 if self.device.type == "cuda" else 0,
                "num_sanity_val_steps": 0,
                "progress_bar_refresh_rate":
                    hp.extras.get("progress_bar_refresh_rate", 5),
                "gradient_clip_val": hp.grad_clip,
                "devices": devices,
                "mesh_axes": None if mesh is None else mesh.shape,
                "monitor": self.rc.monitor_metric,
                "checkpoint_k": self.checkpoint_k,
            }
            if hp.auto_lr_find:
                tkw["auto_lr_find"] = True
            dump_json(self.results_dir / "trainer_kwargs.json", tkw)

        if hp.auto_lr_find and hp.max_epochs > 0:
            # the kept train rows (the JAX run sweeps the whole split here,
            # against anchors and CC tables cut to the kept rows)
            t0 = time.time()
            found = trainer.lr_find(params, state, train_data, anchors,
                                    seed=seed)
            if log_fn and lead:
                log_fn(f"auto_lr_find: {hp.learning_rate:.2e} -> "
                       f"{found:.2e} ({time.time() - t0:.2f}s)")
            self.hp = hp = hp.replace(learning_rate=found)
            trainer.hp = hp
            trainer.tx = make_optimizer(hp)  # rebuilt with the found lr

        on_epoch_end = None
        if hp.resample_anchor_patches:
            def on_epoch_end(epoch):  # noqa: F811
                fresh = self.sample_anchors(seed + 1000 + epoch)
                if keep_idx is not None:  # keep holdout rows out of fit
                    fresh["train"] = self._subset_split_anchors(
                        fresh["train"], keep_idx)
                return fresh

        start_epoch = 0
        if resume_path:
            start_epoch = trainer.resume_from(resume_path)
            if log_fn and lead:
                log_fn(f"resuming from {resume_path} at epoch {start_epoch}")

        self.trainer = trainer
        try:
            trainer.fit(params, state, train_data, val_data, anchors,
                        seed=seed, on_epoch_end=on_epoch_end, log_fn=log_fn,
                        start_epoch=start_epoch,
                        profile_dir=(str(profile_dir) if profile_dir
                                     else None),
                        metrics_callback=metrics_callback)
        except Exception:
            # keep what was learned before re-raising (a pruned trial still
            # writes final_metric_scores, as the reference's pruner)
            if self.results_dir and lead and trainer.metric_scores:
                dump_json(self.results_dir / "final_metric_scores.json",
                          dict(trainer.metric_scores[-1]))
            raise
        finally:
            if trainer.tb:
                trainer.tb.close()

        if self.results_dir and lead and trainer.metric_scores:
            dump_json(self.results_dir / "final_metric_scores.json",
                      dict(trainer.metric_scores[-1]))

        # test with the best checkpoint (reference: train.py:389-409), its
        # model state too, so batch-norm running stats match its weights;
        # on a mesh, rank 0's (it wrote it before it sends the path)
        best = trainer.ckpt.best_path if trainer.ckpt else None
        if mesh is not None:
            best = MX.broadcast_object(best, mesh.group)
        if best:
            # the whole table in the file; a node rank takes its rows
            trainer.load_weights(best)
        test_metrics = trainer.evaluate(self.split_data("test"),
                                        anchors["test"], "test")
        holdout_metrics = None
        if holdout_data is not None:
            # the same restored best-val checkpoint as test
            holdout_metrics = trainer.evaluate(holdout_data,
                                               anchors["holdout"], "holdout")
        if self.results_dir and lead:
            dump_json(self.results_dir / "test_results.json", test_metrics)
        return {"val": (trainer.metric_scores[-1] if trainer.metric_scores
                        else {}),
                "test": test_metrics, "holdout": holdout_metrics,
                "best_monitor": trainer.best_monitor_value()}

    # --------------------------------------------------------------- serving

    def _bfs_rows(self, cc_ids: np.ndarray, timings: Dict[str, float]):
        """NP sims and border sets of a request from BFS rows, LRU-cached by
        source node across requests (one lock around lookup+BFS+insert)."""
        hp = self.hp
        srcs = np.unique(cc_ids.ravel())
        srcs = srcs[srcs != PAD_VALUE].astype(np.int64)
        with self._bfs_cache_lock:
            cache = self._bfs_row_cache
            missing = np.array([s for s in srcs if int(s) not in cache],
                               dtype=np.int64)
            if missing.size:
                for s, row in zip(missing, shortest_path_rows(
                        self.graph, missing, n_threads=hp.n_processes)):
                    cache[int(s)] = row.copy()
            timings["bfs_srcs"] = int(srcs.size)
            timings["bfs_cache_miss"] = int(missing.size)
            rows = np.stack([cache[int(s)] for s in srcs])
            for s in srcs:  # mark this request's rows most recently used
                cache.move_to_end(int(s))
            while len(cache) > self.BFS_ROW_CACHE_SIZE:
                cache.popitem(last=False)
        with span("predict.np_sim") as s:
            lut = np.zeros(self.graph.n_nodes + 1, np.int32)
            lut[srcs] = np.arange(1, len(srcs) + 1, dtype=np.int32)
            np_sim = compute_shortest_path_similarities(rows, lut[cc_ids])
        timings["np_sim"] = s.seconds
        border = None
        if hp.use_neighborhood:
            with span("predict.border_sets") as s:
                border = border_sets_from_rows(srcs, rows, cc_ids,
                                               hp.neigh_sample_border_size,
                                               self.graph.n_nodes)
            timings["border_sets"] = s.seconds
        return np_sim, border

    def _request_anchors(self, cc_ids, border, node_lists, seed):
        """Anchors for one request: per-request neighborhood and internal
        position anchors, plus the request-invariant border position and
        structure anchors, cached per seed."""
        hp = self.hp
        anchors: Dict[str, Any] = {}
        if hp.use_neighborhood:
            anchors["neigh_int"], anchors["neigh_bor"] = \
                init_anchors_neighborhood(hp, cc_ids, border, seed,
                                          PREDICT_TAG)
        if hp.use_position:
            anchors["pos_int"] = init_anchors_pos_int(hp, node_lists, seed,
                                                      PREDICT_TAG)
        fixed = self._serving_anchor_cache.get(seed)
        if fixed is None:
            fixed = {}
            if hp.use_position:
                # shared across splits — the training-time set (same
                # seed-derived stream, reference SubGNN.py:1012)
                fixed["pos_ext"] = init_anchors_pos_ext(hp, self.graph, seed)
            if hp.use_structure:
                _, idx, iw, bw = init_anchors_structure(
                    hp, self.structure_anchors, self.int_walks,
                    self.bor_walks, seed)
                fixed.update(struc_pool_idx=idx, struc_int_walks=iw,
                             struc_bor_walks=bw)
            self._serving_anchor_cache[seed] = fixed
        anchors.update(fixed)
        return anchors

    def predict(self, node_lists, params, state=None,
                seed: Optional[int] = None,
                anchors: Optional[Dict[str, Any]] = None,
                max_n_cc: Optional[int] = None,
                max_len_cc: Optional[int] = None):
        """Classify NEW subgraphs of the loaded base graph.

        node_lists: 1-based node-id lists over the SAME base graph as the
        training data. Requires load() + precompute() and parameters
        (build_model, a JAX checkpoint through train/checkpoint.py, or
        convert.params_from_jax). Per-subgraph precompute runs on the fly:
        CC split, BFS rows (LRU-cached) -> NP sims + border sets, and the
        internal+border structure DTW against the persisted anchor pool in
        one kernel launch, overlapped with the BFS on a worker thread.
        max_n_cc/max_len_cc pin the padded CC shape.

        Returns {"logits": (N, num_classes) float32, "probs", "pred",
                 "timings": per-stage seconds, each a span's
                 (train/spans.py: perf_counter, and a profiler range
                 while torch.profiler records)}.
        """
        hp = self.hp
        if not self._loaded:
            raise RuntimeError("call load() + precompute() first")
        if state is None:
            if hp.batch_norm:
                raise ValueError("hp.batch_norm models carry running stats: "
                                 "pass the checkpoint's `state` too")
            state = {}
        seed = hp.seed if seed is None else seed
        timings: Dict[str, float] = {}
        with span("predict") as total:
            logits = self._predict_logits(node_lists, params, state, seed,
                                          anchors, max_n_cc, max_len_cc,
                                          timings)
        timings["total"] = total.seconds
        if self.multilabel:
            probs = 1.0 / (1.0 + np.exp(-logits))
            pred = (probs > 0.5).astype(np.int32)
        else:
            e = np.exp(logits - logits.max(axis=1, keepdims=True))
            probs = e / e.sum(axis=1, keepdims=True)
            pred = probs.argmax(axis=1).astype(np.int32)
        return {"logits": logits, "probs": probs, "pred": pred,
                "timings": timings}

    def _predict_logits(self, node_lists, params, state, seed, anchors,
                        max_n_cc, max_len_cc, timings) -> np.ndarray:
        """predict's stages, each a span whose seconds go to `timings`;
        the (N, num_classes) float32 logits."""
        hp = self.hp
        with span("predict.cc_split") as s:
            cc_ids = initialize_cc_ids(self.graph, node_lists,
                                       max_n_cc=max_n_cc,
                                       max_len_cc=max_len_cc)  # (N, C, L)
        timings["cc_split"] = s.seconds
        n = len(node_lists)

        np_sim = border = int_s = bor_s = None
        with ThreadPoolExecutor(max_workers=1) as pool:
            bfs_future = None
            if hp.use_neighborhood or hp.use_position:
                # open from the submission to the result (the worker's own
                # stages are spans of their own)
                bfs_wall = span("predict.bfs_rows").__enter__()
                bfs_future = pool.submit(self._bfs_rows, cc_ids, timings)
            if hp.use_structure:
                if self.structure_anchors is None:
                    raise RuntimeError("call precompute() first")
                with span("predict.structure_sims") as s:
                    int_s, bor_s = structure_similarities_both(
                        self.graph, cc_ids, self.structure_anchors,
                        anchor_cache=self._serving_anchor_seqs,
                        device=self.device)
                timings["structure_sims"] = s.seconds
            if bfs_future is not None:
                try:
                    np_sim, border = bfs_future.result()
                finally:
                    bfs_wall.__exit__(None, None, None)
                timings["bfs_rows_wall"] = bfs_wall.seconds

        if anchors is None:
            with span("predict.anchors") as s:
                anchors = self._request_anchors(cc_ids, border, node_lists,
                                                seed)
            timings["anchors"] = s.seconds
        # host copies feed the compact-sims gather, device copies the model
        anchors = {k: (v.cpu().numpy() if torch.is_tensor(v)
                       else np.asarray(v)) for k, v in anchors.items()}
        anchors_dev = {k: torch.as_tensor(v, device=self.device).long()
                       for k, v in anchors.items()}

        cc_tables = None
        if hp.trainable_cc:
            with span("predict.cc_tables") as s:
                cc_tables = {k: torch.as_tensor(v, device=self.device)
                             for k, v in self._cc_tables_from_ids(
                                 cc_ids).items()}
            timings["cc_tables"] = s.seconds

        labels = (np.zeros((n, self.num_classes), np.float32)
                  if self.multilabel else np.zeros(n, np.int64))
        data = SubgraphData(
            subgraph_ids=pad_node_lists(node_lists), cc_ids=cc_ids,
            labels=labels, N_border=border, NP_sim=np_sim,
            I_S_sim=int_s, B_S_sim=bor_s, multilabel=self.multilabel)

        if self._predict_model is None:
            self._predict_model = SubGNNModel(hp, self.graph.n_nodes,
                                              self.num_classes,
                                              self.multilabel)
        model = self._predict_model

        def put(x):
            return torch.as_tensor(x, device=self.device)

        out = []
        B = hp.batch_size
        arange_b = torch.arange(B, device=self.device)
        with span("predict.forward") as s, torch.inference_mode():
            for batch in data.batches(B, shuffle=False, drop_last=False,
                                      include_np_sim=False):
                idx = batch["subgraph_idx"]
                # every tensor is (B, ...) whatever the request size: the
                # request-sized anchor/cc-table arrays are sliced to this
                # batch and re-indexed within it
                tb = {"cc_ids": put(batch["cc_ids"]).long(),
                      "subgraph_idx": arange_b}
                for k in ("I_S_sim", "B_S_sim"):
                    if batch[k] is not None:
                        tb[k] = put(batch[k])
                if np_sim is not None:
                    tb.update({k: put(v) for k, v in compact_sims_for_batch(
                        np_sim, anchors, hp, idx).items()})
                tidx = put(idx).long()
                banchors = self._subset_split_anchors(anchors_dev, tidx)
                bcc = (None if cc_tables is None
                       else {k: v[tidx] for k, v in cc_tables.items()})
                logits, _ = model(params, state, tb, banchors, cc_tables=bcc)
                out.append(logits.cpu().numpy()[batch["valid"]])
        timings["forward"] = s.seconds
        return np.concatenate(out).astype(np.float32)

def load_best_hyperparams(path: str | Path) -> HParams:
    """Load a frozen best_model_hyperparameters/*/hyperparams.json dict."""
    with open(path) as f:
        return HParams.from_dict(json.load(f))
