"""The host C++ library (``subgnn_tpu_torch/native/subgnn_native.cpp``):
multithreaded BFS and triangular walks, bound with ctypes.

The port of subgnn_tpu/ops/native.py, with the same functions and names:
  * bfs_from_sources(graph, sources) -> (len(sources), n) int32 hop
    distances (unreached = 0), the rows serving's N/P sims and border sets
    read;
  * bfs_all_pairs(graph) -> the (n, n) matrix the precompute caches as
    shortest_path_matrix.npy;
  * triangular_walks_full(graph, ...) -> walks over the full graph, the
    same stream as the JAX package's library for the same seed (the
    pipeline does not use them: its cached walks come from the numpy
    sampler's stream).

The library builds at first use with g++ into ``build/native/`` beside the
package (``~/.cache/subgnn_tpu_torch/native`` where that cannot be written:
ops/build.py:build_dir), named by a digest of the source, the flags and ``g++ --version``,
so an edited source or another compiler builds anew; each process writes
its own temporary file and renames it into place, so concurrent builds
never load a half-written library. A failed build raises: the numpy BFS it
would fall back to is many times slower a source (PERF.md §6), so callers
that want it ask for it by name
(``shortest_path_rows(..., backend="fallback")``).

ctypes releases the GIL for the length of each call, so a BFS on a worker
thread runs beside Python work on others. ``n_threads=0`` means every
hardware thread.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from .build import build_dir

SRC = Path(__file__).resolve().parents[1] / "native" / "subgnn_native.cpp"
BUILD_DIR = build_dir("native")
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.RLock()
# keyed by (compiler, source, build dir): each library loads once a process
_loaded: Dict[Tuple[str, Path, Path], ctypes.CDLL] = {}


def _run(cmd) -> str:
    """Run the compiler; its stdout, or RuntimeError with its stderr."""
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"native library build failed: {' '.join(cmd)}: "
                           f"{e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"native library build failed: {' '.join(cmd)} "
                           f"exited {proc.returncode}\n{proc.stderr}")
    return proc.stdout


def library_path() -> Path:
    """Where the library for this source, these flags and this compiler
    lies (built or not)."""
    key = (SRC.read_bytes() + " ".join(CXX_FLAGS).encode()
           + _run([CXX, "--version"]).encode())
    digest = hashlib.sha256(key).hexdigest()[:16]
    return BUILD_DIR / f"libsubgnn_native-{digest}.so"


def build() -> Tuple[Path, float]:
    """(library path, seconds the build took: 0.0 if it was built)."""
    with _lock:
        out = library_path()
        if out.exists():
            return out, 0.0
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        try:
            _run([CXX, *CXX_FLAGS, str(SRC), "-o", str(tmp)])
            os.replace(tmp, out)
        finally:
            tmp.unlink(missing_ok=True)
        return out, time.perf_counter() - t0


def get_lib() -> ctypes.CDLL:
    """The loaded library, building it first if needed (RuntimeError when
    the build fails)."""
    with _lock:
        key = (CXX, SRC, BUILD_DIR)
        lib = _loaded.get(key)
        if lib is None:
            lib = ctypes.CDLL(str(build()[0]))
            _bind(lib)
            _loaded[key] = lib
        return lib


def is_available() -> bool:
    """Whether the library builds and loads here."""
    try:
        get_lib()
    except RuntimeError:
        return False
    return True


def _bind(lib):
    i64p, i32p = ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32)
    lib.bfs_all_pairs.argtypes = [i64p, i32p, ctypes.c_int64, i32p,
                                  ctypes.c_int32]
    lib.bfs_from_sources.argtypes = [i64p, i32p, ctypes.c_int64, i32p,
                                     ctypes.c_int64, i32p, ctypes.c_int32]
    lib.triangular_walks_full.argtypes = [
        i64p, i32p, i32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_double, ctypes.c_uint64, i32p, ctypes.c_int32]
    for fn in (lib.bfs_all_pairs, lib.bfs_from_sources,
               lib.triangular_walks_full):
        fn.restype = None


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _csr(graph):
    return (np.ascontiguousarray(graph.indptr, dtype=np.int64),
            np.ascontiguousarray(graph.indices, dtype=np.int32))


def bfs_all_pairs(graph, n_threads: int = 0) -> np.ndarray:
    """(n, n) int32 all-pairs hop distances (unreached = 0)."""
    lib = get_lib()
    bfs_all_pairs.launches += 1
    n = graph.n_nodes
    indptr, indices = _csr(graph)
    out = np.zeros((n, n), dtype=np.int32)
    lib.bfs_all_pairs(_ptr(indptr, ctypes.c_int64),
                      _ptr(indices, ctypes.c_int32), n,
                      _ptr(out, ctypes.c_int32), n_threads)
    return out


def bfs_from_sources(graph, sources: np.ndarray,
                     n_threads: int = 0) -> np.ndarray:
    """(len(sources), n) int32 hop distances from each 1-based source
    (unreached = 0)."""
    n = graph.n_nodes
    src = np.ascontiguousarray(sources, dtype=np.int32).reshape(-1)
    if src.size and (src.min() < 1 or src.max() > n):
        raise ValueError(f"BFS sources must be 1-based node ids in 1..{n}, "
                         f"got {src.min()}..{src.max()}")
    lib = get_lib()
    bfs_from_sources.launches += 1
    indptr, indices = _csr(graph)
    out = np.zeros((len(src), n), dtype=np.int32)
    lib.bfs_from_sources(_ptr(indptr, ctypes.c_int64),
                         _ptr(indices, ctypes.c_int32), n,
                         _ptr(src, ctypes.c_int32), len(src),
                         _ptr(out, ctypes.c_int32), n_threads)
    return out


def triangular_walks_full(graph, n_walks: int, walk_len: int, rw_beta: float,
                          seed: int, n_threads: int = 0) -> np.ndarray:
    """(n_walks, walk_len) int32 triangular walks over the full graph from
    starts drawn among the nodes with an edge (PAD 0 after a dead end)."""
    starts = np.ascontiguousarray(graph.node_ids(), dtype=np.int32)
    if not starts.size or walk_len < 2 or n_walks < 0:
        raise ValueError(f"triangular walks need a graph with an edge, "
                         f"walk_len >= 2 and n_walks >= 0 (got "
                         f"{starts.size} start nodes, walk_len {walk_len}, "
                         f"n_walks {n_walks})")
    lib = get_lib()
    indptr, indices = _csr(graph)
    out = np.zeros((n_walks, walk_len), dtype=np.int32)
    lib.triangular_walks_full(
        _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int32),
        _ptr(starts, ctypes.c_int32), len(starts), n_walks, walk_len,
        rw_beta, seed, _ptr(out, ctypes.c_int32), n_threads)
    return out


# calls that reached the library, for the chip smoke test's path checks
bfs_all_pairs.launches = 0
bfs_from_sources.launches = 0
