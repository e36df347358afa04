"""A tiny copy of the benchmark for CPU tests: every configuration and cell
of BENCHMARK.json cut to a few hundred nodes and a few dozen subgraphs,
with the real cells' limits and metric readers. The serving driver
(harness/predict.py) has no cell in BENCHMARK.json; the tiny copy gives
each configuration one (`<config>.predict`), with its metrics and a limit,
so that the driver, its readers and its check stay tested."""
from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

from benchmark.harness.common import BENCH_DIR, ROOT, Cell, load_json

SHRINK_DATA = {"n_nodes": 300, "n_subgraphs": 60, "subgraph_size_max": 20}
SHRINK_HP = {"node_embed_size": 16, "batch_size": 8,
             "n_anchor_patches_structure": 4, "max_sim_epochs": 2,
             "sample_walk_len": 10, "n_triangular_walks": 2,
             "random_walk_len": 4, "n_processes": 2}
SERVING_TRAFFIC = {"kind": "predict", "description": "one closed-loop client",
                   "subgraphs_min": 1, "subgraphs_max": 8, "cycle": 8,
                   "warmup_requests": 2, "warmup_requests_max": 6,
                   "trace_requests": 3, "check_requests": 3}
SERVING_LIMITS = {"ppi_bp": 2e-5, "hpo_metab": 1.2e-5}
SERVING_METRICS = ["bfs_rows_ms.predict", "bfs_cache_hit_share.predict",
                   "structure_sims_ms.predict", "dtw_roofline.predict",
                   "forward_ms.predict", "predict_mfu.predict",
                   "device_idle_share.predict"]
SHRINK_TRAFFIC = {"warmup_epochs": 2, "trace_epochs": 2, "subgraphs_max": 8,
                  "cycle": 8, "warmup_requests": 2, "warmup_requests_max": 6,
                  "trace_requests": 3, "check_requests": 3}


def _with_serving(bench: dict) -> dict:
    """BENCHMARK.json with a serving cell for each configuration."""
    bench = json.loads(json.dumps(bench))
    serve = [f"{c['name']}.predict" for c in bench["configs"]]
    bench["workloads"] += [{"name": n, "config": n.split(".")[0],
                            "traffic": "predict", "chips": 1, "why": "tiny"}
                           for n in serve]
    bench["end_to_end"] += [
        {"name": n, "unit": u, "better": b, "bound": 0.25,
         "source": "host_clock", "workloads": serve}
        for n, u, b in (("predict_p95_ms", "ms", "lower"),
                        ("predict_subgraphs_per_s", "subgraphs/s", "higher"))]
    bench["per_layer"] += [
        {"name": m, "unit": "%", "better": "higher", "source": "host_clock",
         "layer": "serving", "moves": "predict_p95_ms", "workloads": serve}
        for m in SERVING_METRICS]
    return bench


def make(tmp: Path) -> Path:
    """Write the tiny benchmark under `tmp`; returns its folder."""
    bench = _with_serving(load_json(ROOT / "BENCHMARK.json"))
    d = tmp / "bench"
    for sub in ("configs", "traffic", "limits"):
        (d / sub).mkdir(parents=True)
    shutil.copytree(BENCH_DIR / "metrics", d / "metrics")
    for c in bench["configs"]:
        cfg = load_json(ROOT / c["file"])
        ds = cfg["dataset"]
        density = ds["n_edges"] / ds["n_nodes"]
        ds.update(SHRINK_DATA, n_edges=int(min(density, 30) * 300))
        cfg["hparams"].update(SHRINK_HP,
                              n_layers=min(cfg["hparams"]["n_layers"], 2))
        (d / "configs" / f"{c['name']}.json").write_text(json.dumps(cfg))
    for w in bench["workloads"]:
        if w["traffic"] == "predict":
            t = SERVING_TRAFFIC
            (d / "limits" / f"{w['name']}.json").write_text(json.dumps(
                {"logit_gap": SERVING_LIMITS[w["config"]]}))
        else:
            t = load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
            t.update({k: v for k, v in SHRINK_TRAFFIC.items() if k in t})
            shutil.copy(BENCH_DIR / "limits" / f"{w['name']}.json",
                        d / "limits" / f"{w['name']}.json")
        (d / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(t))
    (d / "BENCHMARK.json").write_text(json.dumps(bench))
    return d


def cell(d: Path, name: str) -> Cell:
    return Cell(name, load_json(d / "BENCHMARK.json"), d)


def run(d: Path, name: str, capsys, seed: int = 2 ** 33 + 11,
        trace: int = 0) -> dict:
    """One run of a tiny cell on the CPU (the look for a card skipped);
    returns the parsed result line."""
    import torch
    from benchmark import run as R
    args = R.parse(["--workload", name, "--seed", str(seed), "--seconds",
                    "1", "--trace", str(trace)])
    capsys.readouterr()
    rc = R.run_cell(cell(d, name), args, torch.device("cpu"),
                    time.perf_counter())
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


def workloads(kind: str = None, tiny: bool = True) -> list:
    """Names of the tiny benchmark's cells of a driver `kind` (all when
    None); `tiny=False`: BENCHMARK.json's own cells only."""
    bench = load_json(ROOT / "BENCHMARK.json")
    if tiny:
        bench = _with_serving(bench)
    out = []
    for w in bench["workloads"]:
        t = (SERVING_TRAFFIC if w["traffic"] == "predict" else
             load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json"))
        if kind is None or t["kind"] == kind:
            out.append(w["name"])
    return out

