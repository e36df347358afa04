"""Multi-seed evaluation harness.

Usage:
  python -m subgnn_tpu_torch.cli.test -task hpo_metab -project_root <root> \\
      -restoreModelPath best_model_hyperparameters/hpo_metab [-n_seeds 10] \\
      [-device cuda]

Re-trains with the restored hyperparams.json on seeds 0..n-1 and reports
mean/SD of test accuracy / micro-F1 / AUROC into experiment_results.json
(reference: SubGNN/test.py:27-103, README.md:42-55). Port of
subgnn_tpu/cli/test.py with the same flags and keys, plus -device (default
cuda; pass -device cpu to run on the CPU). Under torchrun every seed trains
data-parallel over the launched ranks (the hyperparameters'
mesh_data_axis; cli/train.py), with rank 0's seeds.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from ..config import HParams, RunConfig
from ..parallel.mesh import broadcast_object, is_lead, process_group_from_env
from ..train.checkpoint import dump_json
from ..train.runner import SubGNNPipeline


def run_seeds(task: str, project_root: str, hyperparams_path: str,
              n_seeds: int = 10, out_dir: str | None = None,
              max_epochs: int | None = None, log_fn=print,
              random_seeds: bool = False,
              overrides: dict | None = None,
              device: str = "cuda") -> dict:
    rc = RunConfig(task=task, project_root=Path(project_root))
    with open(Path(hyperparams_path)) as f:
        hyp = json.load(f)
    out_dir = Path(out_dir) if out_dir else Path(project_root) / "experiments" / task
    # default seeds 0..n-1, or fresh random draws per round like the
    # reference's --random_seeds (SubGNN/test.py:61-66)
    if random_seeds:
        seeds = broadcast_object([int(s) for s in np.random.default_rng()
                                  .integers(0, 1_000_001, n_seeds)])
    else:
        seeds = list(range(n_seeds))
    accs, f1s, aurocs = [], [], []
    for round_i, seed in enumerate(seeds):
        # per-round seed always wins (it IS the protocol); overrides may
        # not collide with it (dict(**) would raise on a 'seed' key)
        hp = HParams.from_dict({**hyp, **(overrides or {}), "seed": seed})
        if max_epochs is not None:
            hp = hp.replace(max_epochs=max_epochs)
        results_dir = out_dir / f"seed_{round_i}"
        pipe = SubGNNPipeline(rc, hp, device=device,
                              results_dir=results_dir)
        out = pipe.run(seed=seed, log_fn=log_fn)
        t = out["test"]
        accs.append(t["test_acc"])
        f1s.append(t["test_micro_f1"])
        aurocs.append(t["test_auroc"])
        if log_fn and is_lead():
            log_fn(f"seed {seed}: acc={t['test_acc']:.4f} "
                   f"micro_f1={t['test_micro_f1']:.4f} "
                   f"auroc={t['test_auroc']:.4f}")
    results = {
        "seeds": seeds,
        "accuracies": accs, "micro_f1s": f1s, "aurocs": aurocs,
        "acc_mean": float(np.mean(accs)), "acc_sd": float(np.std(accs)),
        "micro_f1_mean": float(np.mean(f1s)), "micro_f1_sd": float(np.std(f1s)),
        "auroc_mean": float(np.mean(aurocs)), "auroc_sd": float(np.std(aurocs)),
    }
    if is_lead():
        dump_json(out_dir / "experiment_results.json", results)
    if log_fn and is_lead():
        log_fn(json.dumps({k: v for k, v in results.items()
                           if k.endswith(("mean", "sd"))}, indent=2))
    return results


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-task", type=str, required=True)
    parser.add_argument("-project_root", type=str, required=True)
    parser.add_argument("-restoreModelPath", type=str, required=True,
                        help="directory containing hyperparams.json")
    parser.add_argument("-n_seeds", type=int, default=10)
    parser.add_argument("-max_epochs", type=int, default=None)
    parser.add_argument("-out_dir", type=str, default=None)
    parser.add_argument("--random_seeds", action="store_true",
                        help="draw each round's seed uniformly from "
                             "[0, 1e6] instead of 0..n-1 "
                             "(reference SubGNN/test.py:61-66)")
    parser.add_argument("-device", type=str, default="cuda",
                        help="torch device (default cuda; 'cpu' must be "
                             "asked for explicitly)")
    args = parser.parse_args(argv)
    with process_group_from_env(args.device) as device:
        run_seeds(args.task, args.project_root,
                  str(Path(args.restoreModelPath) / "hyperparams.json"),
                  args.n_seeds, args.out_dir, args.max_epochs,
                  random_seeds=args.random_seeds, device=device)


if __name__ == "__main__":
    main()
