"""Readings of the correctness check's control and faults, for setting its
limits (never run by the benchmark's own runs).

    python3 benchmark/control.py --workload ppi_bp.train --seeds 11,12,13

For each seed, at the cell's own sizes on the first CUDA device (or
`--device cpu`), the reference is put in the program's place and read by
the same numbers the check compares, against the float32 reference (a
training cell runs the program too, with a short window, `--seconds`, and
prints its own numbers beside them):
  control     the reference with every matrix product's operands rounded to
              TF32, the nearest precision below the configuration's float32
  half_batch  (training cells) each step's loss taken over the first half
              of its batch, the mean over the rest
A step that leaves the state unchanged reads 1 on update_gap by its
definition and needs no run. Prints one JSON line per seed.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def train_readings(cell, seed: int, dev, seconds: float = 2.0) -> dict:
    """One short run of a training cell (its set-up, a window of
    `seconds`, the checked epoch after it): the program's numbers, and the
    same numbers of the control and of the half-batch fault, each in the
    program's place (from the same weights, and in the later epoch from the
    program's recorded state before each step)."""
    from benchmark.harness import fit
    args = argparse.Namespace(workload=cell.name, seed=seed, seconds=seconds,
                              trace=0, controls=True)
    out = fit.run(cell, args, dev, time.perf_counter())
    info = out["result"]["info"]
    return {"program": {k: v for k, (v, _) in out["checks"].items()},
            **out["controls"],
            "late_norms": info["reference_late_grad_norms"],
            "first_norms": info["reference_grad_norms"],
            "window_epochs": info["window_epochs"]}


def predict_readings(cell, seed: int, dev) -> dict:
    from subgnn_tpu_torch.config import HParams
    from benchmark.harness import check_predict as CP
    from benchmark.harness.check_fit import _tree
    from benchmark.harness.data import csr, make_graph
    from benchmark.harness.predict import requests
    from benchmark.harness.weights import program_params
    from benchmark.reference.model import tf32_round

    cfg, traffic = cell.config, cell.traffic
    ds = cfg["dataset"]
    n = int(ds["n_nodes"])
    edges = make_graph(ds)
    _, _, _, params0 = program_params(HParams.from_dict(cfg["hparams"]), n,
                                      int(ds["n_classes"]), seed, dev)
    params = _tree({p: v.to(dev) for p, v in params0.items()})
    R = CP.RefServing(cfg["hparams"], edges, n, seed, dev)
    stream = requests(cfg, traffic, seed, 1, *csr(edges, n))
    reqs = [next(stream) for _ in range(int(traffic["cycle"]))]
    idx = CP.sample(len(reqs), [len(r) for r in reqs], seed,
                    int(traffic["check_requests"]))
    worst = max(CP.gap(R.logits(reqs[i], params, tf32_round),
                       R.logits(reqs[i], params)) for i in idx)
    return {"control": {"logit_gap": worst}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    import torch
    from benchmark.harness.common import Cell

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = Cell(args.workload)
    dev = torch.device(args.device)
    for s in args.seeds.split(","):
        out = (train_readings(cell, int(s), dev, args.seconds)
               if cell.traffic["kind"] == "fit"
               else predict_readings(cell, int(s), dev))
        print(json.dumps({"workload": args.workload, "seed": int(s), **out}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
