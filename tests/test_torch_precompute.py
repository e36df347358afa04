"""Full-dataset precompute of the port against the JAX package's, on the CPU.

Each test holds a JAX function against its port on the same inputs: the
border sets, the all-pairs BFS matrix (the port's numpy host BFS and its
torch frontier-product BFS), SubGNNPipeline.precompute on copies of the
mini fixture (the same cache file names with equal arrays), its row-subset
and memory-map branches, sample_anchors / split_data / the eval CC tables,
and one Trainer.fit epoch from the pipeline's outputs.

Tolerances: border sets, hop distances, NP sims, the structure pool, its
walks and every anchor array are exact; structure sims atol 1e-6 (the same
DTW in float32 in another order); Trainer.fit metrics rtol 1e-4, as in
tests/test_torch_train.py.
"""
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from subgnn_tpu.config import HParams as JHParams, RunConfig as JRunConfig
from subgnn_tpu.data.graph import CSRGraph as JGraph
from subgnn_tpu.data.dataset import initialize_cc_ids as j_cc_ids
from subgnn_tpu.data.subgraphs import read_subgraphs
from subgnn_tpu.precompute.border import compute_border_sets as j_border
from subgnn_tpu.precompute.shortest_paths import \
    shortest_path_matrix as j_matrix
from subgnn_tpu.train.loop import Trainer as JTrainer
from subgnn_tpu.train.runner import SubGNNPipeline as JPipe

from subgnn_tpu_torch.config import HParams, RunConfig
from subgnn_tpu_torch.convert import params_from_jax
from subgnn_tpu_torch.data.graph import CSRGraph
from subgnn_tpu_torch.precompute.border import compute_border_sets
from subgnn_tpu_torch.precompute.shortest_paths import (shortest_path_matrix,
                                                        shortest_path_rows)
from subgnn_tpu_torch.train import runner
from subgnn_tpu_torch.train.loop import Trainer
from subgnn_tpu_torch.train.runner import SubGNNPipeline

REPO = Path(__file__).parents[1]
FIXTURE = REPO / "tests" / "fixtures" / "mini_multilabel"
SPLITS = ("train", "val", "test")

# the small all-channel config of tests/test_torch_slice.py
HP = dict(use_neighborhood=True, use_position=True, use_structure=True,
          max_sim_epochs=1, n_triangular_walks=2, random_walk_len=4,
          sample_walk_len=6, batch_size=4, n_layers=2, node_embed_size=8,
          linear_hidden_dim_1=8, linear_hidden_dim_2=8,
          n_anchor_patches_N_in=2, n_anchor_patches_N_out=2,
          n_anchor_patches_pos_in=3, n_anchor_patches_pos_out=3,
          n_anchor_patches_structure=2, seed=0)


def _random_graph(seed=3, n=90):
    """A seeded graph whose last 10 ids have no edges (isolated nodes)."""
    rng = np.random.default_rng(seed)
    edges = rng.integers(1, n - 9, (160, 2))
    edges = edges[edges[:, 0] != edges[:, 1]]
    return JGraph.from_edges(edges, n_nodes=n), CSRGraph.from_edges(
        edges, n_nodes=n)


def _mini_graphs():
    path = FIXTURE / "mini" / "edge_list.txt"
    return JGraph.from_edgelist(path), CSRGraph.from_edgelist(path)


def _copy(tmp_path, name, with_matrix=True):
    shutil.copytree(FIXTURE / "mini", tmp_path / name / "mini")
    if not with_matrix:
        (tmp_path / name / "mini" / "shortest_path_matrix.npy").unlink()
    return tmp_path / name


@pytest.mark.parametrize("radius,shift_compat", [(1, False), (2, False),
                                                 (1, True)])
def test_border_sets_match_jax(radius, shift_compat):
    jg, tg = _mini_graphs()
    tr, _, va, _, te, _, _ = read_subgraphs(FIXTURE / "mini" / "subgraphs.pth")
    lists = list(tr) + list(va) + list(te)
    rg_j, rg_t = _random_graph()
    rng = np.random.default_rng(1)
    rand_lists = [list(rng.choice(np.arange(1, 91), 6, replace=False))
                  for _ in range(12)]
    for (gj, gt), node_lists in (((jg, tg), lists),
                                 ((rg_j, rg_t), rand_lists)):
        cc = j_cc_ids(gj, node_lists)
        got = compute_border_sets(gt, cc, radius, shift_compat=shift_compat)
        np.testing.assert_array_equal(
            got, j_border(gj, cc, radius, shift_compat=shift_compat))
        assert got.dtype == np.int32


@pytest.mark.parametrize("backend", ["host", "device"])
@pytest.mark.parametrize("graph", ["mini", "isolated"])
def test_shortest_path_matrix_matches_jax(backend, graph):
    gj, gt = _mini_graphs() if graph == "mini" else _random_graph()
    want = j_matrix(gj, backend="host")
    got = shortest_path_matrix(gt, backend=backend, device="cpu")
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    src = np.array([1, 5, gt.n_nodes], np.int64)
    np.testing.assert_array_equal(shortest_path_rows(gt, src), want[src - 1])


def test_shortest_path_backends_refuse_what_they_do_not_take(monkeypatch):
    _, gt = _mini_graphs()
    with pytest.raises(ValueError, match="device"):
        shortest_path_rows(gt, np.array([1]), backend="device")
    with pytest.raises(ValueError):
        shortest_path_matrix(gt, backend="native", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):   # no silent CPU BFS
        shortest_path_matrix(gt, backend="device")


def _pipelines(tmp_path, hp, with_matrix=True):
    """The JAX and the port's pipeline, each loaded and precomputed on its
    own copy of the fixture."""
    jroot = _copy(tmp_path, "jax", with_matrix)
    troot = _copy(tmp_path, "torch", with_matrix)
    jpipe = JPipe(JRunConfig(task="mini", project_root=jroot),
                  JHParams(**hp)).load().precompute()
    tpipe = SubGNNPipeline(RunConfig(task="mini", project_root=troot),
                           HParams(**hp), device="cpu").load().precompute()
    return jpipe, tpipe, jroot / "mini", troot / "mini"


def _assert_same_arrays(tpipe, jpipe):
    for s in SPLITS:
        np.testing.assert_array_equal(tpipe.border[s], jpipe.border[s])
        np.testing.assert_array_equal(tpipe.np_sim[s], jpipe.np_sim[s])
        for name in ("int_s_sim", "bor_s_sim"):
            got, want = getattr(tpipe, name)[s], getattr(jpipe, name)[s]
            assert got.dtype == np.float32 and got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    for name in ("structure_anchors", "int_walks", "bor_walks"):
        np.testing.assert_array_equal(getattr(tpipe, name),
                                      getattr(jpipe, name))


@pytest.mark.parametrize("mode", ["matrix", "no_matrix", "subset"])
def test_precompute_matches_jax(tmp_path, mode):
    hp = dict(HP, subset_data=mode == "subset")
    jpipe, tpipe, jdir, tdir = _pipelines(tmp_path, hp,
                                          with_matrix=mode != "no_matrix")
    _assert_same_arrays(tpipe, jpipe)
    assert list(tpipe.precompute_timings) == [
        "border sets", "NP similarities", "structure pool",
        "structure walks", "structure DTW similarities"]
    if mode == "subset":        # touches no file
        assert not (tdir / "similarities").exists()
        assert sorted(p.name for p in tdir.iterdir()) == sorted(
            p.name for p in (FIXTURE / "mini").iterdir())
        return
    names = sorted(p.name for p in (tdir / "similarities").iterdir())
    assert names == sorted(p.name for p in (jdir / "similarities").iterdir())
    assert len(names) == 3 + 3 + 3 + 3 * 2      # border, NP, pool+walks, DTW
    for name in names:
        got = np.load(tdir / "similarities" / name)
        want = np.load(jdir / "similarities" / name)
        if "_struc_" in name and name.endswith("_similarities.npy"):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(np.load(tdir / "shortest_path_matrix.npy"),
                                  np.load(jdir / "shortest_path_matrix.npy"))
    # a second precompute reads every cache back
    again = SubGNNPipeline(RunConfig(task="mini", project_root=tdir.parent),
                           HParams(**hp), device="cpu").load().precompute()
    _assert_same_arrays(again, jpipe)


def test_precompute_row_subset_and_memory_map(tmp_path, monkeypatch):
    hp = HParams(**dict(HP, use_structure=False))
    full = SubGNNPipeline(RunConfig(task="mini",
                                    project_root=_copy(tmp_path, "full")),
                          hp, device="cpu").load().precompute()

    # above _FULL_SP_MAX_NODES: BFS rows from the CC nodes only, no matrix
    monkeypatch.setattr(runner, "_FULL_SP_MAX_NODES", 10)   # graph is 40
    root = _copy(tmp_path, "rows", with_matrix=False)
    rows = SubGNNPipeline(RunConfig(task="mini", project_root=root), hp,
                          device="cpu").load().precompute()
    for s in SPLITS:
        np.testing.assert_array_equal(rows.np_sim[s], full.np_sim[s])
    assert not (root / "mini" / "shortest_path_matrix.npy").exists()
    mat, lut = rows._shortest()
    assert lut is not None and mat.shape[0] < rows.graph.n_nodes

    # an existing matrix above _SP_MMAP_BYTES is memory-mapped
    monkeypatch.setattr(runner, "_SP_MMAP_BYTES", 100)
    root = _copy(tmp_path, "mmap")
    mm = SubGNNPipeline(RunConfig(task="mini", project_root=root), hp,
                        device="cpu").load()
    mat, lut = mm._shortest()
    assert isinstance(mat, np.memmap) and lut is None
    mm.precompute()
    for s in SPLITS:
        np.testing.assert_array_equal(mm.np_sim[s], full.np_sim[s])


def test_anchors_split_data_and_eval_cc_match_jax(tmp_path):
    hp = dict(HP, trainable_cc=True)
    jpipe, tpipe, _, _ = _pipelines(tmp_path, hp)
    janchors = jpipe.sample_anchors(5)
    tanchors = tpipe.sample_anchors(5)
    for s in SPLITS:
        assert set(tanchors[s]) == set(janchors[s]) == {
            "neigh_int", "neigh_bor", "pos_int", "pos_ext", "struc_pool_idx",
            "struc_int_walks", "struc_bor_walks"}
        for k, v in janchors[s].items():
            assert isinstance(tanchors[s][k], np.ndarray)
            np.testing.assert_array_equal(tanchors[s][k], np.asarray(v), k)
        jd, td = jpipe.split_data(s), tpipe.split_data(s)
        for name in ("subgraph_ids", "cc_ids", "labels", "N_border",
                     "NP_sim"):
            np.testing.assert_array_equal(getattr(td, name),
                                          getattr(jd, name), name)
        for name in ("I_S_sim", "B_S_sim"):
            np.testing.assert_allclose(getattr(td, name), getattr(jd, name),
                                       rtol=0, atol=1e-6)
        assert td.multilabel == jd.multilabel is True
    *_, jeval = jpipe.build_model()
    teval = tpipe.eval_cc_tables()
    assert set(teval) == set(jeval) == {"val", "test"}
    for s, tables in jeval.items():
        assert set(teval[s]) == set(tables)
        for k, v in tables.items():
            assert teval[s][k].device.type == "cpu"
            np.testing.assert_array_equal(teval[s][k].numpy(), np.asarray(v))
    tpipe.hp = tpipe.hp.replace(trainable_cc=False)
    assert tpipe.eval_cc_tables() is None


def test_fit_from_the_pipeline_matches_jax(tmp_path):
    """load -> precompute -> sample_anchors -> build_model -> Trainer.fit,
    one epoch on the mini fixture with its config's hyperparameters (D=8
    embeddings, trainable CC tables, gradient clipping), the port's
    parameters carried from the JAX model."""
    from subgnn_tpu.config import load_commented_json
    hp = dict(load_commented_json(FIXTURE / "mini_config.json")
              ["hyperparams_fix"], max_epochs=1, compute_similarities=False)
    jpipe, tpipe, _, _ = _pipelines(tmp_path, hp)
    assert tpipe.pretrained_embeds.shape == (40, 8)
    jmodel, jparams, jstate, jeval = jpipe.build_model()
    tmodel, _, _ = tpipe.build_model()
    jtr = JTrainer(jmodel, jpipe.hp, eval_cc_tables=jeval)
    jtr.fit(jparams, jstate, jpipe.split_data("train"),
            jpipe.split_data("val"), jpipe.sample_anchors(), seed=0,
            log_fn=None)
    np_tree = jax.tree_util.tree_map(np.asarray, (jparams, jstate))
    p_t, s_t = params_from_jax(*np_tree, device="cpu")
    ttr = Trainer(tmodel, tpipe.hp, eval_cc_tables=tpipe.eval_cc_tables(),
                  device="cpu", ckpt_dir=str(tmp_path / "ckpt"))
    ttr.fit(p_t, s_t, tpipe.split_data("train"), tpipe.split_data("val"),
            tpipe.sample_anchors(), seed=0, log_fn=None)
    assert len(ttr.metric_scores) == len(jtr.metric_scores) == 1
    mt, mj = ttr.metric_scores[0], jtr.metric_scores[0]
    for k in ("train_loss", "val_loss", "val_micro_f1", "val_acc",
              "val_auroc"):
        np.testing.assert_allclose(mt[k], mj[k], rtol=1e-4, err_msg=k)
    assert ttr.ckpt.best_path is not None and ttr.ckpt.best_path.exists()
