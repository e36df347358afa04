"""The mesh branches of precompute on the CPU: the NP-sim CC-min on each
rank's column block of the path matrix, the structure DTW on each rank's
block of comps, the all-pairs BFS with its sources or its graph partitioned
over the ranks (subgnn_tpu_torch/parallel/partition.py), and
SubGNNPipeline.precompute(mesh=) with rank 0 alone writing.

Ranks are gloo processes spawned by tests/test_torch_mesh.py's `_spawn`:
one spawn of a (2, 2) mesh (world 4) and one of a (3, 1) mesh (world 3,
where no axis of the inputs divides), each running every job. The inputs
are made in this process from seeds and read by the ranks; the references
(the port in one process, the JAX package in one process and on its (4, 2)
and (8, 1) meshes of tests/conftest.py's 8 host devices) run here.
Counterparts of the JAX package's tests/test_parallel.py:180-356.

Tolerances: NP sims, hop distances, border sets, the pool and its walks are
exact (mins of integers, integer BFS); structure sims are bit-equal to the
port's one-process result (the same DTW on the same pairs) and within atol
1e-6 of JAX's (the same DTW in float32 in another order). The collectives'
bytes are exact (the formulas of parallel/mesh.py's docstrings).

No JAX at module level: the spawned ranks import this module.
"""
import pickle
import shutil
from pathlib import Path

import numpy as np
import pytest

from subgnn_tpu_torch.config import HParams, RunConfig
from subgnn_tpu_torch.data.dataset import initialize_cc_ids
from subgnn_tpu_torch.data.graph import CSRGraph
from subgnn_tpu_torch.parallel import mesh as MX
from subgnn_tpu_torch.parallel.partition import adjacency_block
from subgnn_tpu_torch.precompute import shortest_paths as t_sp
from subgnn_tpu_torch.precompute.similarities import (
    compute_shortest_path_similarities, compute_structure_similarities)
from subgnn_tpu_torch.train import runner as t_runner
from subgnn_tpu_torch.train.runner import SubGNNPipeline
from tests.test_torch_mesh import FIXTURE, _spawn

SPLITS = ("train", "val", "test")
# tests/test_torch_precompute.py's small all-channel config
HP = dict(use_neighborhood=True, use_position=True, use_structure=True,
          max_sim_epochs=1, n_triangular_walks=2, random_walk_len=4,
          sample_walk_len=6, batch_size=4, n_layers=2, node_embed_size=8,
          linear_hidden_dim_1=8, linear_hidden_dim_2=8,
          n_anchor_patches_N_in=2, n_anchor_patches_N_out=2,
          n_anchor_patches_pos_in=3, n_anchor_patches_pos_out=3,
          n_anchor_patches_structure=2, seed=0)
# (world, n_node): a (2, 2) mesh, and a (3, 1) mesh no input axis divides
WORLDS = {4: 2, 3: 1}
PIPE_MODES = ("matrix", "no_matrix", "rows", "subset")


# ------------------------------------------------------------- the inputs

def _random_edges(rng, n, m):
    """tests/test_parallel.py:_random_csr's edges."""
    edges = rng.integers(1, n + 1, (m, 2))
    return edges[edges[:, 0] != edges[:, 1]], n


def _inputs():
    """Every job's inputs, from the seeds of tests/test_parallel.py."""
    import networkx as nx
    rng = np.random.default_rng(1)
    n_nodes, n_sub, C, L = 77, 11, 3, 5
    sp = rng.integers(0, 9, (n_nodes, n_nodes)).astype(np.float32)
    cc_ids = rng.integers(0, n_nodes + 1, (n_sub, C, L)).astype(np.int32)
    cc_ids[:, :, 0] = rng.integers(1, n_nodes + 1, (n_sub, C))
    cc_ids[2, 1:] = 0                                   # an empty CC
    out = {"np77": (sp, cc_ids)}

    rng = np.random.default_rng(7)
    g = nx.barabasi_albert_graph(60, 2, seed=3)
    edges = np.asarray(list(g.edges()), dtype=np.int64) + 1
    csr = CSRGraph.from_edges(edges, n_nodes=60)
    subgraphs = [(rng.choice(60, size=5, replace=False) + 1).tolist()
                 for _ in range(5)]
    cc_ids = initialize_cc_ids(csr, subgraphs)
    srcs = np.unique(cc_ids.ravel())
    srcs = srcs[srcs != 0].astype(np.int64)
    lut = np.zeros(csr.n_nodes + 1, np.int32)
    lut[srcs] = np.arange(1, len(srcs) + 1, dtype=np.int32)
    out["rows"] = (t_sp.shortest_path_rows(csr, srcs), lut[cc_ids],
                   (edges, 60), cc_ids)

    rng = np.random.default_rng(2)
    edges, n = _random_edges(rng, 96, 300)
    cc_ids = rng.integers(0, n + 1, (6, 2, 4)).astype(np.int32)
    cc_ids[:, 0, 0] = rng.integers(1, n + 1, 6)
    anchors = rng.integers(1, n + 1, (9, 5)).astype(np.int32)
    out["struc"] = ((edges, n), cc_ids, anchors)
    out["bfs60"] = _random_edges(np.random.default_rng(3), 60, 150)
    out["bfs61"] = _random_edges(np.random.default_rng(5), 61, 130)
    return out


def _graph(edges_n):
    edges, n = edges_n
    return CSRGraph.from_edges(edges, n_nodes=n)


def _counted(fn):
    """fn()'s result and the precompute collectives' {name: (calls,
    bytes)} it made."""
    MX.reset_counts()
    out = fn()
    return out, {h.__name__: (h.calls, h.bytes)
                 for h in MX.PRECOMPUTE_COLLECTIVES}


# --------------------------------------------------------------- the jobs

def _job_ops(rank, tmp, mesh):
    with open(Path(tmp) / "inputs.pkl", "rb") as f:
        inp = pickle.load(f)
    out = {"block": {n: mesh.world_block(n) for n in (0, 2, 77, 60, 61)}}
    sp, cc = inp["np77"]
    out["np77"] = _counted(lambda: compute_shortest_path_similarities(
        sp, cc, mesh=mesh))
    rows, ids, _, _ = inp["rows"]
    out["rows"] = _counted(lambda: compute_shortest_path_similarities(
        rows, ids, mesh=mesh))
    g, cc, anchors = inp["struc"]
    for internal in (True, False):
        out["struc", internal] = _counted(
            lambda: compute_structure_similarities(
                _graph(g), cc, anchors, internal, device="cpu", mesh=mesh))
    out["sources"] = _counted(lambda: t_sp.shortest_path_matrix(
        _graph(inp["bfs60"]), mesh=mesh, partition="sources"))
    for name in ("bfs60", "bfs61"):
        out["graph", name] = _counted(lambda: t_sp.shortest_path_matrix(
            _graph(inp[name]), mesh=mesh, partition="graph"))
    with pytest.raises(ValueError, match="partition"):
        t_sp.shortest_path_matrix(_graph(inp["bfs60"]), mesh=mesh,
                                  partition="edges")
    return out


def _precompute(pipe, mesh, **kw):
    """pipe.precompute(mesh=, **kw): its arrays, the files it saved, its
    structure-sim calls and its collectives."""
    saved, calls = [], []
    save, sims = np.save, t_runner.compute_structure_similarities

    def counted_save(path, arr, *a, **k):
        saved.append(Path(path).name)
        save(path, arr, *a, **k)

    def counted_sims(*a, **k):
        calls.append(k["mesh"] is mesh)
        return sims(*a, **k)

    np.save, t_runner.compute_structure_similarities = counted_save, \
        counted_sims
    try:
        _, counts = _counted(lambda: pipe.precompute(mesh=mesh, **kw))
    finally:
        np.save, t_runner.compute_structure_similarities = save, sims
    arrays = {name: getattr(pipe, name) for name in
              ("border", "np_sim", "int_s_sim", "bor_s_sim",
               "structure_anchors", "int_walks", "bor_walks")}
    return {"arrays": arrays, "saved": sorted(saved), "sims": calls,
            "counts": counts}


def _job_pipeline(rank, tmp, mesh):
    out = {}
    for mode in PIPE_MODES:
        # "rows": BFS rows from the CC nodes only (the graph has 40 nodes)
        t_runner._FULL_SP_MAX_NODES = 10 if mode == "rows" else 20_000
        hp = HParams(**dict(HP, subset_data=mode == "subset"))
        root = Path(tmp) / mode
        pipe = SubGNNPipeline(RunConfig(task="mini", project_root=root), hp,
                              device="cpu").load()
        runs = [_precompute(pipe, mesh)]
        if mode == "matrix":
            runs.append(_precompute(pipe, mesh))      # every cache present
            runs.append(_precompute(pipe, mesh, recompute=True))
        out[mode] = runs
    return out


JOBS = {"ops": _job_ops, "pipeline": _job_pipeline}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """{world: {job: [each rank's result]}}, and the inputs."""
    inp = _inputs()
    out = {"inputs": inp}
    for world, n_node in WORLDS.items():
        tmp = tmp_path_factory.mktemp(f"world{world}")
        with open(tmp / "inputs.pkl", "wb") as f:
            pickle.dump(inp, f)
        for mode in PIPE_MODES:
            _copy_fixture(tmp / mode, with_matrix=mode == "matrix")
        out[world] = _spawn(world, tmp, JOBS, n_node)
        out[world]["tmp"] = tmp
    return out


def _copy_fixture(root, with_matrix=True):
    shutil.copytree(FIXTURE / "mini", root / "mini")
    if not with_matrix:
        (root / "mini" / "shortest_path_matrix.npy").unlink()
    return root


# ------------------------------------------------------------ the checks

def _gather_bytes(*shapes):
    return sum(4 * int(np.prod(s)) for s in shapes)


def _assert_collectives(counts, **made):
    want = {h.__name__: (0, 0) for h in MX.PRECOMPUTE_COLLECTIVES}
    want.update(made)
    assert counts == want


@pytest.mark.parametrize("world", WORLDS)
def test_world_blocks_cover_the_axis_in_rank_order(spawned, world):
    blocks = [r["block"] for r in spawned[world]["ops"]]
    for n in (0, 2, 77, 60, 61):
        w = -(-n // world)
        got = [b[n] for b in blocks]
        assert got == [(min(r * w, n), min(r * w + w, n))
                       for r in range(world)]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", ["np77", "rows"])
def test_np_sims_mesh_match_host_and_jax(spawned, world, case):
    from subgnn_tpu.parallel.mesh import make_device_mesh as j_mesh
    from subgnn_tpu.precompute.similarities import \
        compute_shortest_path_similarities as j_np_sims
    inp = spawned["inputs"][case]
    mat, ids = inp[:2]
    host = compute_shortest_path_similarities(mat, ids)
    np.testing.assert_array_equal(host, j_np_sims(mat, ids))
    np.testing.assert_array_equal(
        host, j_np_sims(mat, ids, mesh=j_mesh(n_data=4, n_node=2)))
    if case == "rows":      # the row subset against the full matrix
        full = t_sp.shortest_path_matrix(_graph(inp[2]))
        np.testing.assert_array_equal(
            host, compute_shortest_path_similarities(full, inp[3]))
    for r in spawned[world]["ops"]:
        got, counts = r[case]
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, host)
        _assert_collectives(counts, all_gather_world=(1, _gather_bytes(
            host.shape)))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("internal", [True, False])
def test_structure_sims_mesh_match_one_process_and_jax(spawned, world,
                                                       internal):
    from subgnn_tpu.data.graph import CSRGraph as JGraph
    from subgnn_tpu.parallel.mesh import make_device_mesh as j_mesh
    from subgnn_tpu.precompute.similarities import \
        compute_structure_similarities as j_struc
    (edges, n), cc, anchors = spawned["inputs"]["struc"]
    one = compute_structure_similarities(_graph((edges, n)), cc, anchors,
                                         internal, device="cpu")
    jax_mesh = j_struc(JGraph.from_edges(edges, n_nodes=n), cc, anchors,
                       internal, mesh=j_mesh(n_data=8, n_node=1))
    for r in spawned[world]["ops"]:
        got, counts = r["struc", internal]
        assert got.dtype == np.float32 and got.shape == one.shape
        np.testing.assert_array_equal(got, one)
        np.testing.assert_allclose(got, jax_mesh, rtol=0, atol=1e-6)
        # one gather of the distances: 4 x n_sub x C x n_anchors bytes
        _assert_collectives(counts, all_gather_world=(
            1, 4 * cc.shape[0] * cc.shape[1] * anchors.shape[0]))


def _levels(host, chunk):
    """A chunk's BFS levels: 1 + the largest hop count of its sources."""
    return [1 + int(host[s:s + chunk].max())
            for s in range(0, len(host), chunk)]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("partition,name", [("sources", "bfs60"),
                                            ("graph", "bfs60"),
                                            ("graph", "bfs61")])
def test_bfs_mesh_matches_host_and_jax(spawned, world, partition, name):
    from subgnn_tpu.data.graph import CSRGraph as JGraph
    from subgnn_tpu.parallel.mesh import make_device_mesh as j_mesh
    from subgnn_tpu.precompute.shortest_paths import \
        shortest_path_matrix as j_matrix
    edges, n = spawned["inputs"][name]
    host = t_sp.shortest_path_matrix(_graph((edges, n)), backend="host")
    np.testing.assert_array_equal(host, j_matrix(
        JGraph.from_edges(edges, n_nodes=n), mesh=j_mesh(n_data=8, n_node=1),
        partition=partition))
    chunk = t_sp.DEVICE_BFS_CHUNK
    for r in spawned[world]["ops"]:
        got, counts = (r["sources"] if partition == "sources"
                       else r["graph", name])
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, host)
        if partition == "sources":
            # a chunk rounded up to the world, gathered: 4 x chunk x n
            q = -(-chunk // world) * world
            n_chunks = -(-n // q)
            _assert_collectives(counts, all_gather_world=(
                n_chunks, n_chunks * 4 * q * n))
            continue
        # a frontier exchange of 4 x S x n_pad and an 8-byte count a
        # level, the distances gathered once (4 x n x n_pad)
        n_pad = -(-n // world) * world
        levels = _levels(host, chunk)
        frontier = sum(lv * 4 * min(chunk, n - i * chunk) * n_pad
                       for i, lv in enumerate(levels))
        _assert_collectives(
            counts,
            all_gather_world=(sum(levels) + 1, frontier + 4 * n * n_pad),
            all_reduce_world_=(sum(levels), 8 * sum(levels)))


def test_padded_adjacency_matches_jax():
    """Each part's adjacency_block is its columns of JAX's padded
    adjacency."""
    import torch
    from subgnn_tpu.data.graph import CSRGraph as JGraph
    from subgnn_tpu.parallel.partition import padded_adjacency as j_padded
    edges, n = _random_edges(np.random.default_rng(6), 10, 20)
    for parts in (1, 3, 4):
        want, n_pad = j_padded(JGraph.from_edges(edges, n_nodes=n), parts)
        w = n_pad // parts
        for d in range(parts):
            got = adjacency_block(_graph((edges, n)), parts, d, torch.int32,
                                  "cpu").numpy()
            assert got.shape == (n_pad, w)
            np.testing.assert_array_equal(got, want[:, d * w:(d + 1) * w])


def test_unknown_partition_raises():
    g = _graph(_random_edges(np.random.default_rng(3), 60, 150))
    with pytest.raises(ValueError, match="partition"):
        t_sp.shortest_path_matrix(g, backend="host", partition="edges")


# ----------------------------------------------------- the whole pipeline

@pytest.fixture(scope="module")
def references(tmp_path_factory):
    """The port's one-process precompute and the JAX pipeline's on its
    (4, 2) mesh, each on its own copy of the fixture, per mode."""
    from subgnn_tpu.config import HParams as JHParams, \
        RunConfig as JRunConfig
    from subgnn_tpu.parallel.mesh import make_device_mesh as j_mesh
    from subgnn_tpu.train.runner import SubGNNPipeline as JPipe
    tmp = tmp_path_factory.mktemp("references")
    out = {}
    for mode in ("matrix", "subset"):
        hp = dict(HP, subset_data=mode == "subset")
        one = SubGNNPipeline(
            RunConfig(task="mini", project_root=_copy_fixture(
                tmp / f"torch_{mode}")),
            HParams(**hp), device="cpu").load().precompute()
        jpipe = JPipe(JRunConfig(task="mini", project_root=_copy_fixture(
            tmp / f"jax_{mode}")), JHParams(**hp)).load()
        jpipe.precompute(mesh=j_mesh(n_data=4, n_node=2))
        out[mode] = (one, jpipe, tmp / f"torch_{mode}" / "mini")
    return out


def _assert_arrays(arrays, pipe, atol_struc=0.0):
    for name in ("border", "np_sim", "int_s_sim", "bor_s_sim"):
        for s in SPLITS:
            got, want = arrays[name][s], getattr(pipe, name)[s]
            assert got.dtype == want.dtype and got.shape == want.shape
            if atol_struc and "s_sim" in name:
                np.testing.assert_allclose(got, want, rtol=0,
                                           atol=atol_struc)
            else:
                np.testing.assert_array_equal(got, want, err_msg=name)
    for name in ("structure_anchors", "int_walks", "bor_walks"):
        np.testing.assert_array_equal(arrays[name], getattr(pipe, name))


def _np_and_dtw_bytes(pipe):
    """The NP-sim and DTW gathers' bytes of a precompute: a split's NP sims
    4 x n_sub x C x n_nodes, each side's structure sims 4 x n_sub x C x
    n_anchors."""
    n_anchors = pipe.structure_anchors.shape[0]
    return sum(4 * cc.shape[0] * cc.shape[1] * (pipe.graph.n_nodes
                                                + 2 * n_anchors)
               for cc in (pipe.cc_ids[s] for s in SPLITS))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("mode", PIPE_MODES)
def test_pipeline_precompute_mesh_matches_one_process_and_jax(
        spawned, references, world, mode):
    one, jpipe, one_dir = references["subset" if mode == "subset"
                                     else "matrix"]
    ranks = spawned[world]["pipeline"]
    gathers = (3 + 6, _np_and_dtw_bytes(one))
    for rank, r in enumerate(ranks):
        first = r[mode][0]
        _assert_arrays(first["arrays"], one)
        _assert_arrays(first["arrays"], jpipe, atol_struc=1e-6)
        assert first["sims"] == [True] * 6       # 3 splits x 2 sides
        made = {"all_gather_world": gathers}
        if mode != "matrix":
            # no matrix file: rank 0's rows, a column block to each rank,
            # 4 x rows x the padded width
            n = one.graph.n_nodes
            ids = np.unique(np.concatenate([one.cc_ids[s].ravel()
                                            for s in SPLITS]))
            n_rows = n if mode != "rows" else int((ids != 0).sum())
            made["scatter_world_cols"] = (1, 4 * n_rows * -(-n // world)
                                          * world)
        _assert_collectives(first["counts"], **made)
        if rank or mode == "subset":
            assert first["saved"] == []
    tmp = spawned[world]["tmp"]
    if mode == "subset":            # no rank read or wrote a cache
        assert not (tmp / mode / "mini" / "similarities").exists()
        return
    names = sorted(p.name for p in (one_dir / "similarities").iterdir())
    want = names + (["shortest_path_matrix.npy"] if mode == "no_matrix"
                    else [])
    assert ranks[0][mode][0]["saved"] == sorted(want)
    assert sorted(p.name for p in (tmp / mode / "mini" / "similarities")
                  .iterdir()) == names
    for name in names:
        got = np.load(tmp / mode / "mini" / "similarities" / name)
        np.testing.assert_array_equal(
            got, np.load(one_dir / "similarities" / name), err_msg=name)


@pytest.mark.parametrize("world", WORLDS)
def test_pipeline_precompute_mesh_hits_and_recomputes_on_every_rank(
        spawned, references, world):
    one = references["matrix"][0]
    for rank, r in enumerate(spawned[world]["pipeline"]):
        first, hit, again = r["matrix"]
        # every cache present: read on every rank, nothing computed
        _assert_arrays(hit["arrays"], one)
        assert hit["saved"] == [] and hit["sims"] == []
        _assert_collectives(hit["counts"])
        # recompute=True: every rank computes again, no deadlock
        _assert_arrays(again["arrays"], one)
        assert again["sims"] == [True] * 6
        assert again["counts"] == first["counts"]
        assert again["saved"] == (first["saved"] if rank == 0 else [])
