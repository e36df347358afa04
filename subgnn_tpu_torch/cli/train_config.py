"""Config-file experiment driver (the reference's canonical entry point).

Usage: python -m subgnn_tpu_torch.cli.train_config \\
           -config_path <run_config.json> [-device cuda]

Runs an HPO study per the run config's hyperparams_optuna spec
(reference: SubGNN/train_config.py:202-283), training one SubGNNPipeline per
trial, logging each trial's artifacts under <tb.dir>/<tb.name>/version_<n>/
and the study state beside them. Port of subgnn_tpu/cli/train_config.py,
plus -device (default cuda; pass -device cpu to run on the CPU). Under
torchrun every trial trains data-parallel over the launched ranks (the
config's mesh_data_axis; cli/train.py).
"""
from __future__ import annotations

import argparse
import json
import random
from pathlib import Path

from ..config import HParams, RunConfig
from ..device import resolve_device
from ..parallel.mesh import is_lead, process_group_from_env
from ..train.hpo import Study, Trial, TrialPruned, hyperparams_from_config
from ..train.runner import SubGNNPipeline


def run_study(config_path: str, project_root: str | None = None,
              n_trials: int | None = None, log_fn=print,
              device: str = "cuda") -> Study:
    resolve_device(device)  # no GPU for "cuda": fail before any work
    rc = RunConfig.from_json(config_path)
    if project_root:
        rc.project_root = Path(project_root)
    study_dir = Path(rc.project_root) / rc.tb_dir / rc.tb_name
    study_dir.mkdir(parents=True, exist_ok=True)
    study = Study(study_dir / "study.json", direction=rc.opt_direction,
                  sampler=rc.sampler, grid_search_space=rc.grid_search_space)
    n = n_trials if n_trials is not None else rc.opt_n_trials

    def objective(trial: Trial) -> float:
        hyp = hyperparams_from_config(rc, trial)
        hp = HParams.from_dict(hyp)
        version = "version_" + str(random.randint(0, 10_000_000))
        results_dir = study_dir / version
        pipe = SubGNNPipeline(rc, hp, device=device, results_dir=results_dir)

        def metrics_callback(epoch, metrics):
            trial.report(metrics.get(rc.monitor_metric, float("nan")), epoch)
            if rc.pruning and trial.should_prune():
                raise TrialPruned()

        out = pipe.run(log_fn=log_fn, metrics_callback=metrics_callback)
        return out["best_monitor"]

    study.optimize(objective, n)
    if log_fn and is_lead():
        log_fn(f"best trial: {json.dumps(study.best_trial, default=float)}")
    return study


def main(argv=None):
    parser = argparse.ArgumentParser(description="Learn subgraph embeddings")
    parser.add_argument("-config_path", type=str, required=True)
    parser.add_argument("-project_root", type=str, default=None,
                        help="dataset root (PROJECT_ROOT equivalent)")
    parser.add_argument("-n_trials", type=int, default=None)
    parser.add_argument("-device", type=str, default="cuda",
                        help="torch device (default cuda; 'cpu' must be "
                             "asked for explicitly)")
    args = parser.parse_args(argv)
    with process_group_from_env(args.device) as device:
        run_study(args.config_path, args.project_root, args.n_trials,
                  device=device)


if __name__ == "__main__":
    main()
