"""The run path and the reference load nothing of JAX or the JAX package,
and the reference imports nothing of the program."""
import ast
import json
import subprocess
import sys
from pathlib import Path

from benchmark.harness.common import BENCH_DIR, ROOT

PROBE = r"""
import json, sys, time, torch
from pathlib import Path
sys.path.insert(0, {root!r})
from benchmark.tests import tiny
from benchmark import run as R, control
from benchmark.harness.common import forbidden_modules
d = tiny.make(Path({tmp!r}))
for name in tiny.workloads():
    args = R.parse(["--workload", name, "--seed", "5", "--seconds", "0.5",
                    "--trace", "1"])
    R.run_cell(tiny.cell(d, name), args, torch.device("cpu"),
               time.perf_counter())
print(json.dumps(forbidden_modules()))
"""


def test_run_path_loads_no_jax(tmp_path):
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=str(ROOT), tmp=str(tmp_path))],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_compared_whole():
    from benchmark.harness import common
    saved = dict(sys.modules)
    try:
        sys.modules["subgnn_tpu_torch_x"] = sys
        sys.modules["jaxlib_like.sub"] = sys
        assert "subgnn_tpu_torch_x" not in common.forbidden_modules()
        sys.modules["jax.numpy"] = sys
        assert "jax" in common.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_reference_imports_nothing_of_the_program():
    for path in sorted((BENCH_DIR / "reference").glob("*.py")):
        tree = ast.parse(Path(path).read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module] if node.level == 0 else []
            for n in names:
                top = n.split(".")[0]
                assert top not in ("subgnn_tpu_torch", "subgnn_tpu", "jax",
                                   "jaxlib", "flax", "benchmark"), (path, n)
