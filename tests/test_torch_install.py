"""An installed port: its wheel carries every source it builds at first use
(the CUDA kernels and the host C++ library), and both build directories
fall back to a per-user cache where the package's own place cannot be
written (the JAX package's rule, subgnn_tpu/ops/native.py:_lib_dir).

The wheel is built offline from a copy of the package files under
tmp_path, so the checkout's own build/ stays untouched."""
import os
import shutil
import subprocess
import sys
import zipfile
from pathlib import Path

import pytest

from subgnn_tpu_torch.ops import build as kbuild
from subgnn_tpu_torch.ops import native

REPO = Path(__file__).resolve().parents[1]


def test_wheel_ships_the_sources_it_builds(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    for name in ("pyproject.toml", "README.md"):
        shutil.copy(REPO / name, src / name)
    for pkg in ("subgnn_tpu", "subgnn_tpu_torch"):
        shutil.copytree(REPO / pkg, src / pkg, ignore=shutil.ignore_patterns(
            "__pycache__", "*.pyc", "*.so"))
    out = tmp_path / "wheel"
    proc = subprocess.run(
        [sys.executable, "-m", "pip", "wheel", "--no-deps",
         "--no-build-isolation", "--no-index", "-q", "-w", str(out),
         str(src)], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    wheel, = out.glob("*.whl")
    names = set(zipfile.ZipFile(wheel).namelist())
    for path in ("subgnn_tpu_torch/native/subgnn_native.cpp",
                 "subgnn_tpu_torch/csrc/dtw.cu",
                 "subgnn_tpu_torch/csrc/segment_matmul.cu"):
        assert path in names, path
    assert native.SRC.relative_to(REPO).as_posix() in names
    assert {f"subgnn_tpu_torch/csrc/{f}" for f in kbuild.SOURCES.values()} \
        <= names


def test_build_dirs_beside_a_writable_package():
    assert kbuild.BUILD_DIR == kbuild.PACKAGE_PARENT / "build" / "kernels"
    assert native.BUILD_DIR == kbuild.PACKAGE_PARENT / "build" / "native"


@pytest.mark.parametrize("existing", ["none", "build", "build_sub"])
def test_build_dir_falls_back_to_a_user_cache(tmp_path, monkeypatch,
                                              existing):
    site = tmp_path / "site-packages"
    site.mkdir()
    if existing != "none":
        (site / "build").mkdir()
    if existing == "build_sub":
        (site / "build" / "kernels").mkdir()
    home = tmp_path / "home"
    monkeypatch.setenv("HOME", str(home))
    assert kbuild.build_dir("kernels", site) == site / "build" / "kernels"
    # read-only: the mode bits, and os.access refusing it (a root user
    # passes mode bits)
    for d in (site, *site.rglob("*")):
        d.chmod(0o555)
    access = os.access
    monkeypatch.setattr(kbuild.os, "access", lambda p, mode: (
        False if Path(p).is_relative_to(site) and mode & os.W_OK
        else access(p, mode)))
    try:
        for sub in ("kernels", "native"):
            assert kbuild.build_dir(sub, site) == \
                home / ".cache" / "subgnn_tpu_torch" / sub
        assert kbuild.build_dir("kernels", tmp_path / "missing") == \
            home / ".cache" / "subgnn_tpu_torch" / "kernels"
    finally:
        for d in (site, *site.rglob("*")):
            d.chmod(0o755)
