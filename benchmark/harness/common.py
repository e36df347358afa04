"""What every cell shares: finding a cell's files by name, the card's
description, the check that nothing of JAX was loaded, and the result line.

A cell of BENCHMARK.json names a configuration and a traffic mix; their
files are `configs/<config>.json` and `traffic/<traffic>.json` under the
benchmark's folder, the limits of its correctness check
`limits/<cell>.json`, and the reader of each per-layer metric
`metrics/<metric>.py`. The traffic file's `kind` names the driver that
runs it (`harness/<kind>.py`).
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path
from typing import Any, Dict, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "subgnn_tpu")


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of BENCHMARK.json with its files."""

    def __init__(self, name: str, bench: Optional[Dict] = None,
                 bench_dir: Path = BENCH_DIR):
        bench = bench if bench is not None else load_json(
            bench_dir.parent / "BENCHMARK.json")
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.spec = found[0]
        self.name = name
        self.dir = bench_dir
        self.config = load_json(bench_dir / "configs"
                                / f"{self.spec['config']}.json")
        if self.config["dataset"].get("multilabel"):
            # the generator's labels, the weights' model, serving and the
            # reference's loss are single-label (softmax cross-entropy)
            raise SystemExit(f"{name}: configuration {self.spec['config']!r}"
                             " is multi-label, which this harness does not "
                             "generate, run or check")
        self.traffic = load_json(bench_dir / "traffic"
                                 / f"{self.spec['traffic']}.json")
        path = bench_dir / "limits" / f"{name}.json"
        self.limits = load_json(path) if path.exists() else {}
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"] if self._reports(m)]

    def _reports(self, metric: Dict) -> bool:
        if "workloads" in metric:
            return self.name in metric["workloads"]
        return any(m["name"] == metric["moves"] for m in self.end_to_end)

    def driver(self):
        return importlib.import_module(f"benchmark.harness.{self.traffic['kind']}")

    def reader(self, metric: str):
        """The read(ctx) function of metrics/<metric>.py."""
        path = self.dir / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "benchmark_metric_" + metric.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def read_per_layer(cell: Cell, ctx: Dict[str, Any]) -> Dict[str, Any]:
    """A traced run's part of the result line: the cell's per-layer metrics
    that their readers found something for, the device's busy and traced
    seconds, and the breakdown."""
    from .trace import breakdown
    metrics = {}
    for m in cell.per_layer:
        v = cell.reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    return {"metrics": metrics,
            "device_trace": {"busy_s": ctx["trace"]["busy_s"],
                             "window_s": ctx["trace"]["window_s"]},
            "breakdown": breakdown(ctx["trace"])}


def card_info() -> Dict[str, Any]:
    """The first card's name, count and power limit (nvidia-smi)."""
    import torch
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60).stdout.split()
        info["power_limit_w"] = float(out[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        info["power_limit_w"] = None
    return info


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: subgnn_tpu_torch is the port and passes)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def emit(result: Dict[str, Any], checks: Dict[str, Any]) -> None:
    """Print each compared number beside its limit on stderr, then the
    result line (the checks last in it) on stdout."""
    for name, (value, limit) in checks.items():
        print(f"check {name}: {value!r} limit {limit!r}", file=sys.stderr)
    result = dict(result)
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    print(json.dumps(result), flush=True)
