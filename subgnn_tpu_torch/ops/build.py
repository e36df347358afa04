"""Build the port's CUDA sources into shared libraries and load them.

Each source under ``subgnn_tpu_torch/csrc/`` compiles with nvcc for sm_90a
into a shared library with a plain C interface, bound with ctypes. Builds
happen at first use (or all at once, in parallel, through `build`) into
``build/kernels/`` beside the package (``~/.cache/subgnn_tpu_torch/kernels``
where that cannot be written, see `build_dir`), named by a digest of the
source and flags so an edited source rebuilds. No PyTorch headers are
compiled, which keeps a build to seconds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
# the directory that holds the package: a checkout's root, or site-packages
PACKAGE_PARENT = Path(__file__).resolve().parents[2]


def build_dir(sub: str, parent: Path = PACKAGE_PARENT) -> Path:
    """Where the port's libraries of kind `sub` build: ``parent/build/sub``
    when it (or the nearest of its parents that exists) can be written, as
    in a checkout, else ``~/.cache/subgnn_tpu_torch/sub`` (an installed
    package in a place the user cannot write). The JAX package's host
    library takes the same rule (subgnn_tpu/ops/native.py:_lib_dir)."""
    local = parent / "build" / sub
    nearest = next((d for d in (local, local.parent, parent) if d.exists()),
                   None)
    if nearest is not None and os.access(nearest, os.W_OK):
        return local
    return Path.home() / ".cache" / "subgnn_tpu_torch" / sub


BUILD_DIR = build_dir("kernels")
SOURCES = {"dtw": "dtw.cu", "segment_matmul": "segment_matmul.cu"}
# IEEE division and no fast-math: the kernels stay bit-comparable to their
# plain PyTorch versions
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Iterable[str] | None = None) -> Dict[str, float]:
    """Compile every missing library in `names` (default: all), one nvcc
    process per source, all started together. Returns {name: seconds}
    (0.0 for a library already built). The compiler's register/spill report
    is kept beside each library as ``.log``."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    seconds = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failures = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `name`, building it first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return lib
