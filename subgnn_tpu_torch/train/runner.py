"""Dataset pipeline: load -> precompute -> sample_anchors / split_data ->
build_model -> Trainer.fit, and serving: load -> precompute -> predict.

Port of subgnn_tpu/train/runner.py (SubGNNPipeline) without its mesh: the
same files, caches, RNG streams and request flow, with the model, the
structure DTW and (on small graphs) the all-pairs BFS on a torch device.
Training runs through train/loop.py:Trainer on `split_data`,
`sample_anchors` and `eval_cc_tables`; `SubGNNPipeline.run` (a whole
training run with its JSON artifacts, anchor resampling, lr_find and
resume) is not ported yet.
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
from ..data.dataset import SubgraphData, initialize_cc_ids, pad_node_lists
from ..data.graph import CSRGraph
from ..data.subgraphs import (MultiLabelBinarizer, read_subgraphs,
                              reindex_subgraphs)
from ..device import resolve_device
from ..models.subgnn import CHANNEL_CC_KEYS, SubGNNModel
from ..precompute.border import border_sets_from_rows, compute_border_sets
from ..precompute.shortest_paths import (shortest_path_matrix,
                                         shortest_path_rows)
from ..precompute.similarities import (border_set_path, cached,
                                       compute_shortest_path_similarities,
                                       compute_structure_similarities,
                                       np_sim_path, struc_patches_path,
                                       struc_sim_path, struc_walks_path,
                                       structure_similarities_both)
from ..sampling.anchors import (init_anchors_neighborhood,
                                init_anchors_pos_ext, init_anchors_pos_int,
                                init_anchors_structure)
from ..sampling.walks import (perform_random_walks,
                              sample_structure_anchor_patches)
from .sims import compact_sims_for_batch

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
                 device: str | torch.device = "cuda"):
        self.rc = run_config
        self.hp = hp
        self.device = resolve_device(device)
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

    def precompute(self):
        """Border sets, N/P shortest-path sims, the structure anchor pool and
        its walks, and the structure DTW sims of every split, cached under
        <task>/similarities with the JAX package's (and the reference's)
        filenames (subgnn_tpu/train/runner.py:precompute without its mesh;
        reference SubGNN.py:673-989). The NP-sim CC-min runs on the host;
        the DTW kernel runs once per split and side on the pipeline's
        device, and so does the all-pairs BFS of a graph of up to 4096
        nodes. Each stage's seconds go to `precompute_timings` (and are
        printed when over 5 s)."""
        if not self._loaded:
            raise RuntimeError("call load() first")
        rc, hp = self.rc, self.hp
        sim_dir = rc.similarities_path()
        recompute = hp.compute_similarities
        if hp.subset_data:
            # truncated splits: never read or write the full-data caches
            def cache(path, fn, recompute=False):
                return fn()
        else:
            sim_dir.mkdir(parents=True, exist_ok=True)
            cache = cached
        self.precompute_timings = {}
        t0 = time.time()

        def stage(name):
            nonlocal t0
            dt = time.time() - t0
            self.precompute_timings[name] = dt
            if dt > 5:
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

            def np_sim_inputs(s):
                nonlocal shortest
                if shortest is None:
                    shortest = self._shortest(save=not hp.subset_data)
                mat, lut = shortest
                ids = self.cc_ids[s]
                return mat, (ids if lut is None else lut[ids])

            for s in SPLITS:
                self.np_sim[s] = np.asarray(cache(
                    np_sim_path(sim_dir, s),
                    lambda s=s: compute_shortest_path_similarities(
                        *np_sim_inputs(s)),
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
                                device=self.device),
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
        rc, hp = self.rc, self.hp
        sp_path = rc.shortest_paths_path()
        if sp_path.exists():
            mm = "r" if sp_path.stat().st_size > _SP_MMAP_BYTES else None
            return np.load(sp_path, mmap_mode=mm), None
        if self.graph.n_nodes > _FULL_SP_MAX_NODES:
            srcs = np.unique(np.concatenate(
                [self.cc_ids[s].ravel() for s in SPLITS]))
            srcs = srcs[srcs != PAD_VALUE].astype(np.int64)
            rows = shortest_path_rows(self.graph, srcs,
                                      n_threads=hp.n_processes)
            lut = np.zeros(self.graph.n_nodes + 1, np.int32)
            lut[srcs] = np.arange(1, len(srcs) + 1, dtype=np.int32)
            return rows, lut
        mat = shortest_path_matrix(self.graph, n_threads=hp.n_processes,
                                   device=self.device)
        if save:
            np.save(sp_path, mat)
        return mat, None

    # --------------------------------------------------------------- anchors

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
                for s, row in zip(missing,
                                  shortest_path_rows(self.graph, missing)):
                    cache[int(s)] = row.copy()
            timings["bfs_srcs"] = int(srcs.size)
            timings["bfs_cache_miss"] = int(missing.size)
            rows = np.stack([cache[int(s)] for s in srcs])
            for s in srcs:  # mark this request's rows most recently used
                cache.move_to_end(int(s))
            while len(cache) > self.BFS_ROW_CACHE_SIZE:
                cache.popitem(last=False)
        t0 = time.time()
        lut = np.zeros(self.graph.n_nodes + 1, np.int32)
        lut[srcs] = np.arange(1, len(srcs) + 1, dtype=np.int32)
        np_sim = compute_shortest_path_similarities(rows, lut[cc_ids])
        timings["np_sim"] = time.time() - t0
        border = None
        if hp.use_neighborhood:
            t0 = time.time()
            border = border_sets_from_rows(srcs, rows, cc_ids,
                                           hp.neigh_sample_border_size,
                                           self.graph.n_nodes)
            timings["border_sets"] = time.time() - t0
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
                 "timings": per-stage wall-clock seconds}.
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
        t_all = time.time()

        t0 = time.time()
        cc_ids = initialize_cc_ids(self.graph, node_lists, max_n_cc=max_n_cc,
                                   max_len_cc=max_len_cc)         # (N, C, L)
        timings["cc_split"] = time.time() - t0
        n = len(node_lists)

        np_sim = border = int_s = bor_s = None
        with ThreadPoolExecutor(max_workers=1) as pool:
            bfs_future = None
            if hp.use_neighborhood or hp.use_position:
                t_bfs = time.time()
                bfs_future = pool.submit(self._bfs_rows, cc_ids, timings)
            if hp.use_structure:
                if self.structure_anchors is None:
                    raise RuntimeError("call precompute() first")
                t0 = time.time()
                int_s, bor_s = structure_similarities_both(
                    self.graph, cc_ids, self.structure_anchors,
                    anchor_cache=self._serving_anchor_seqs,
                    device=self.device)
                timings["structure_sims"] = time.time() - t0
            if bfs_future is not None:
                np_sim, border = bfs_future.result()
                timings["bfs_rows_wall"] = time.time() - t_bfs

        if anchors is None:
            t0 = time.time()
            anchors = self._request_anchors(cc_ids, border, node_lists, seed)
            timings["anchors"] = time.time() - t0
        # host copies feed the compact-sims gather, device copies the model
        anchors = {k: (v.cpu().numpy() if torch.is_tensor(v)
                       else np.asarray(v)) for k, v in anchors.items()}
        anchors_dev = {k: torch.as_tensor(v, device=self.device).long()
                       for k, v in anchors.items()}

        cc_tables = None
        if hp.trainable_cc:
            t0 = time.time()
            cc_tables = {k: torch.as_tensor(v, device=self.device)
                         for k, v in self._cc_tables_from_ids(cc_ids).items()}
            timings["cc_tables"] = time.time() - t0

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
        t_fwd = time.time()
        with torch.inference_mode():
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
                banchors = dict(anchors_dev)
                tidx = put(idx).long()
                for k in ("neigh_int", "neigh_bor", "pos_int"):
                    if k in banchors:
                        banchors[k] = banchors[k][:, tidx]
                bcc = (None if cc_tables is None
                       else {k: v[tidx] for k, v in cc_tables.items()})
                logits, _ = model(params, state, tb, banchors, cc_tables=bcc)
                out.append(logits.cpu().numpy()[batch["valid"]])
        timings["forward"] = time.time() - t_fwd
        timings["total"] = time.time() - t_all
        logits = np.concatenate(out).astype(np.float32)
        if self.multilabel:
            probs = 1.0 / (1.0 + np.exp(-logits))
            pred = (probs > 0.5).astype(np.int32)
        else:
            e = np.exp(logits - logits.max(axis=1, keepdims=True))
            probs = e / e.sum(axis=1, keepdims=True)
            pred = probs.argmax(axis=1).astype(np.int32)
        return {"logits": logits, "probs": probs, "pred": pred,
                "timings": timings}


def load_best_hyperparams(path: str | Path) -> HParams:
    """Load a frozen best_model_hyperparameters/*/hyperparams.json dict."""
    with open(path) as f:
        return HParams.from_dict(json.load(f))
