"""The port's host C++ library (subgnn_tpu_torch/ops/native.py) against the
JAX package's library and its numpy BFS, on the CPU.

Hop distances and walks are integers: every comparison is exact. Skips only
where this machine has no g++.
"""
import shutil
import time
from pathlib import Path

import numpy as np
import pytest

from subgnn_tpu.data.graph import CSRGraph as JGraph
from subgnn_tpu.ops import native as jnative
from subgnn_tpu.precompute.shortest_paths import \
    _bfs_from_sources_host as j_numpy_bfs

from subgnn_tpu_torch.data.graph import CSRGraph
from subgnn_tpu_torch.ops import native
from subgnn_tpu_torch.precompute.shortest_paths import (shortest_path_matrix,
                                                        shortest_path_rows)

REPO = Path(__file__).parents[1]

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no g++ on this machine")


def _edges(name):
    """(1-based edges, n_nodes) of a seeded test graph."""
    if name.startswith("random"):
        rng = np.random.default_rng(int(name[-1]))
        e = rng.integers(1, 121, (480, 2))
        return e[e[:, 0] != e[:, 1]], 120
    if name == "disconnected":   # a path, a triangle and a pair
        return np.array([[1, 2], [2, 3], [3, 4], [5, 6], [6, 7], [7, 5],
                         [8, 9]]), 9
    # isolated nodes: ids 31-40 have no edge
    rng = np.random.default_rng(7)
    e = rng.integers(1, 31, (60, 2))
    return e[e[:, 0] != e[:, 1]], 40


def _graphs(name):
    edges, n = _edges(name)
    return JGraph.from_edges(edges, n_nodes=n), CSRGraph.from_edges(
        edges, n_nodes=n)


@pytest.fixture(scope="module")
def jax_native():
    """The JAX package's library. Its loader gives up for the process when
    the library is rewritten by another test process at the moment it
    loads, so ask again after such a miss."""
    for _ in range(10):
        if jnative.get_lib() is not None:
            return jnative
        jnative._tried = False
        time.sleep(1.0)
    pytest.fail("the JAX package's native library did not load")


@pytest.mark.parametrize("n_threads", [1, 3, 0])
@pytest.mark.parametrize("graph", ["random0", "random1", "disconnected",
                                   "isolated"])
@pytest.mark.parametrize("fn", ["bfs_from_sources", "bfs_all_pairs"])
def test_bfs_matches_the_jax_library_and_numpy(jax_native, fn, graph,
                                               n_threads):
    jg, tg = _graphs(graph)
    n = tg.n_nodes
    if fn == "bfs_all_pairs":
        sources = np.arange(1, n + 1)
        got = native.bfs_all_pairs(tg, n_threads=n_threads)
        want = jax_native.bfs_all_pairs(jg, n_threads=n_threads)
    else:
        rng = np.random.default_rng(n_threads)
        sources = np.concatenate([[1, n], rng.integers(1, n + 1, 17)])
        got = native.bfs_from_sources(tg, sources, n_threads=n_threads)
        want = jax_native.bfs_from_sources(jg, sources, n_threads=n_threads)
    assert got.dtype == np.int32 and got.shape == (len(sources), n)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, j_numpy_bfs(jg, sources))
    if graph in ("disconnected", "isolated"):
        assert (got == 0).sum() > len(sources)   # unreached pairs stay 0


@pytest.mark.parametrize("seed,rw_beta,n_threads", [
    (9, 0.7, 1), (9, 0.7, 0), (3, 0.0, 0), (3, 1.0, 1), (2 ** 40 + 5, 0.5, 3)])
@pytest.mark.parametrize("graph", ["random1", "isolated"])
def test_walks_match_the_jax_library(jax_native, graph, seed, rw_beta,
                                     n_threads):
    jg, tg = _graphs(graph)
    args = dict(n_walks=64, walk_len=12, rw_beta=rw_beta, seed=seed)
    got = native.triangular_walks_full(tg, n_threads=n_threads, **args)
    assert got.dtype == np.int32 and got.shape == (64, 12)
    np.testing.assert_array_equal(
        got, jax_native.triangular_walks_full(jg, **args))
    np.testing.assert_array_equal(
        got, native.triangular_walks_full(tg, n_threads=0, **args))
    for w in got:   # steps follow edges, PAD only after a dead end
        real = w[w != 0]
        assert (w[len(real):] == 0).all()
        for a, b in zip(real, real[1:]):
            assert b in tg.neighbors(a)


def test_library_builds_under_build_native():
    lib = Path(native.get_lib()._name).resolve()
    assert lib.parent == REPO / "build" / "native"
    assert lib.name.startswith("libsubgnn_native-")
    assert native.SRC.resolve() == (REPO / "subgnn_tpu_torch" / "native" /
                                    "subgnn_native.cpp")
    assert (REPO / "subgnn_tpu") not in lib.parents
    assert native.is_available()


@pytest.mark.parametrize("fault", ["missing compiler", "broken source"])
@pytest.mark.parametrize("call", [
    "get_lib", "rows auto", "rows host", "matrix auto", "matrix host"])
def test_a_failed_build_raises(monkeypatch, tmp_path, fault, call):
    _, tg = _graphs("random0")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    if fault == "missing compiler":
        monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    else:
        bad = tmp_path / "broken.cpp"
        bad.write_text(native.SRC.read_text() + "\nnot C++ at all\n")
        monkeypatch.setattr(native, "SRC", bad)
    run = {"get_lib": native.get_lib,
           "rows auto": lambda: shortest_path_rows(tg, np.array([1, 2])),
           "rows host": lambda: shortest_path_rows(tg, np.array([1, 2]),
                                                   backend="host"),
           "matrix auto": lambda: shortest_path_matrix(tg),
           "matrix host": lambda: shortest_path_matrix(tg, backend="host")}
    with pytest.raises(RuntimeError, match="native library build failed"):
        run[call]()
    assert not native.is_available()
    assert not list((tmp_path / "native").glob("*"))   # no library, no .tmp
    # the numpy BFS is there only when asked for by name
    jg, _ = _graphs("random0")
    np.testing.assert_array_equal(
        shortest_path_rows(tg, np.array([1, 2]), backend="fallback"),
        j_numpy_bfs(jg, np.array([1, 2])))


def test_sources_outside_the_graph_raise():
    _, tg = _graphs("disconnected")
    for bad in ([0, 1], [1, tg.n_nodes + 1]):
        with pytest.raises(ValueError, match="1-based"):
            native.bfs_from_sources(tg, np.array(bad))
