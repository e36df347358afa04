"""Argparse single-run driver (the reference's SubGNN/train.py equivalent).

Usage:
  python -m subgnn_tpu_torch.cli.train -task density -project_root data \\
      [-hyperparams path/to/hyperparams.json] [-restoreModelPath dir] \\
      [-max_epochs N] [-seed S] [-noTrain] [-subset_data] [-device cuda]

Port of subgnn_tpu/cli/train.py with the same flags and output, plus
-device (default cuda; pass -device cpu to run on the CPU). Covers the
reference flows (reference: SubGNN/train.py:47-497): single training run
with default or restored hyperparameters, checkpoint restore (filtered
intersection load), optional test-only evaluation, JSON artifact dumps,
and the in-driver search (-opt_n_trials). -debug_mode trains streaming
with per-step gradient norms and NaN checks; -profile_dir writes a
torch.profiler trace of the fit.

Data-parallel training (the hyperparameters' mesh_data_axis = N): launch N
processes with torchrun, which joins them into one process group (NCCL on
the card, one card a rank; gloo with -device cpu):
  torchrun --nproc_per_node N -m subgnn_tpu_torch.cli.train ... [-device cpu]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..config import HParams, RunConfig
from ..parallel.mesh import is_lead, process_group_from_env
from ..train.hpo import Study, TrialPruned, suggest_channels
from ..train.runner import SubGNNPipeline


def default_hyperparams() -> dict:
    """Hard-coded defaults mirroring reference train.py:104-150."""
    return dict(
        seed=42, max_epochs=100, use_neighborhood=True, use_structure=True,
        use_position=True, structure_patch_type="triangular_random_walk",
        lstm_aggregator="last", n_processes=4, resample_anchor_patches=False,
        freeze_node_embeds=False, use_mpn_projection=True,
        compute_similarities=False, sample_walk_len=50, n_triangular_walks=10,
        random_walk_len=15, rw_beta=0.7, max_sim_epochs=5, batch_size=64,
        learning_rate=5e-4, grad_clip=0.5, n_layers=2,
        neigh_sample_border_size=1, n_anchor_patches_pos_out=100,
        n_anchor_patches_pos_in=50, n_anchor_patches_N_in=15,
        n_anchor_patches_N_out=50, n_anchor_patches_structure=25,
        linear_hidden_dim_1=64, linear_hidden_dim_2=32, lstm_dropout=0.0,
        lstm_n_layers=1, lin_dropout=0.0, cc_aggregator="sum",
        trainable_cc=False, embedding_type="gin", ff_attn=False,
    )


def get_hyperparams_optuna(args, trial) -> dict:
    """In-driver search ranges mirroring reference train.py:152-192,
    including its two name quirks: n_layers is suggested under the name
    'gamma_shortest_max_distance_N' (train.py:163), and
    linear_hidden_dim_1/2 share the suggest name 'linear_hidden_dim'
    (train.py:176-177) so they always come out equal."""
    if getattr(args, "opt_channels", False):
        # extension over the reference space: the reference pinned the
        # subset per search run and kept per-channel winner files
        # (best_model_hyperparameters/<task>/{N,S,P,all}_*.json); here the
        # subset is searched as one categorical (train/hpo.py
        # suggest_channels)
        channels = suggest_channels(trial)
    else:
        channels = dict(use_neighborhood=True, use_structure=False,
                        use_position=False)
    return dict(
        seed=42,
        **channels,
        batch_size=trial.suggest_int("batch_size", 64, 150),
        learning_rate=trial.suggest_float("learning_rate", 1e-5, 1e-3,
                                          log=True),
        grad_clip=trial.suggest_float("grad_clip", 0, 0.5),
        max_epochs=(args.max_epochs if args.max_epochs is not None else 100),
        node_embed_size=32,
        n_layers=trial.suggest_int("gamma_shortest_max_distance_N", 1, 5),
        n_anchor_patches_pos_in=trial.suggest_int(
            "n_anchor_patches_pos_in", 25, 75),
        n_anchor_patches_pos_out=trial.suggest_int(
            "n_anchor_patches_pos_out", 50, 200),
        n_anchor_patches_N_in=trial.suggest_int(
            "n_anchor_patches_N_in", 10, 25),
        n_anchor_patches_N_out=trial.suggest_int(
            "n_anchor_patches_N_out", 25, 75),
        n_anchor_patches_structure=trial.suggest_int(
            "n_anchor_patches_structure", 15, 40),
        neigh_sample_border_size=trial.suggest_int(
            "neigh_sample_border_size", 1, 2),
        linear_hidden_dim_1=trial.suggest_int("linear_hidden_dim", 16, 96),
        linear_hidden_dim_2=trial.suggest_int("linear_hidden_dim", 16, 96),
        n_triangular_walks=trial.suggest_int("n_triangular_walks", 5, 15),
        random_walk_len=trial.suggest_int("random_walk_len", 18, 26),
        sample_walk_len=trial.suggest_int("sample_walk_len", 18, 26),
        rw_beta=trial.suggest_float("rw_beta", 0.1, 0.9),
        lstm_aggregator="last",
        lstm_dropout=trial.suggest_float("lstm_dropout", 0.0, 0.4),
        lstm_n_layers=trial.suggest_int("lstm_n_layers", 1, 2),
        n_processes=4,
        lin_dropout=trial.suggest_float("lin_dropout", 0.0, 0.6),
        resample_anchor_patches=False, compute_similarities=False,
        use_mpn_projection=True,
        cc_aggregator=trial.suggest_categorical("cc_aggregator",
                                                ["sum", "max"]),
        trainable_cc=trial.suggest_categorical("trainable_cc", [True, False]),
        freeze_node_embeds=False, embedding_type="gin",
    )


# GridSampler space at reference train.py:471-474. Its second key is never
# suggested by get_hyperparams_optuna (the vestigial
# gamma_shortest_max_distance_P) — a dead grid dimension, reproduced as-is.
GRID_SEARCH_SPACE = {
    "neigh_sample_border_size": [1, 2],
    "gamma_shortest_max_distance_P": [3, 4, 5, 6],
}


def run_optuna_search(args, rc: RunConfig, device):
    """The reference's flow (2): -opt_n_trials set, no restoreModelPath
    (train.py:448-493) — resumable study over the in-driver ranges."""
    import random as _random

    direction = ("minimize" if args.monitor_metric == "val_loss"
                 else "maximize")
    study_path = (Path(args.log_path) if args.log_path
                  else Path(args.project_root) / args.tb_dir / args.tb_name)
    study_path.mkdir(parents=True, exist_ok=True)
    study = Study(study_path / "study.json", direction=direction,
                  sampler=("grid" if args.grid_search else "random"),
                  grid_search_space=(GRID_SEARCH_SPACE if args.grid_search
                                     else None))

    holdout = None
    if getattr(args, "opt_holdout_frac", 0):
        # nested model selection: trials are scored on a train-carved
        # holdout by the restored best-val checkpoint (extension; round-4
        # RESULTS.md measured best-val unable to rank channel subsets)
        import numpy as _np
        from ..data.subgraphs import read_subgraphs
        tr, *_ = read_subgraphs(rc.subgraphs_path())
        n_train = len(tr)
        k = max(25, int(n_train * args.opt_holdout_frac))
        holdout = _np.random.default_rng(777).choice(
            n_train, size=min(k, max(n_train - 1, 1)), replace=False)

    def objective(trial):
        hyp = get_hyperparams_optuna(args, trial)
        if args.seed is not None:
            hyp["seed"] = args.seed
        if args.subset_data:
            hyp["subset_data"] = True
        if args.debug_mode:
            hyp["debug_mode"] = True
        results_dir = (None if args.no_save else study_path /
                       ("version_" + str(_random.randint(0, 10_000_000))))
        pipe = SubGNNPipeline(rc, HParams.from_dict(hyp), device=device,
                              results_dir=results_dir,
                              checkpoint_k=(0 if args.no_checkpointing
                                            else args.checkpoint_k),
                              train_holdout=holdout)

        def metrics_callback(epoch, metrics):
            trial.report(metrics.get(args.monitor_metric, float("nan")),
                         epoch)
            if args.opt_prune and trial.should_prune():
                raise TrialPruned()

        out = pipe.run(metrics_callback=metrics_callback)
        if holdout is not None:
            return out["holdout"]["holdout_micro_f1"]
        return out["best_monitor"]

    study.optimize(objective, args.opt_n_trials)
    if is_lead():
        print(json.dumps({"best_params": study.best_params,
                          "best_value": study.best_trial["value"]},
                         default=float))
    return study


def main(argv=None):
    parser = argparse.ArgumentParser(description="Learn subgraph embeddings")
    parser.add_argument("-task", type=str, required=True)
    parser.add_argument("-project_root", type=str, required=True)
    parser.add_argument("-tb_dir", type=str, default="tensorboard")
    parser.add_argument("-tb_name", type=str, default="run")
    parser.add_argument("-hyperparams", type=str, default=None,
                        help="path to a hyperparams.json to load")
    parser.add_argument("-restoreModelPath", type=str, default=None,
                        help="dir containing hyperparams.json (+ checkpoints)")
    parser.add_argument("-restoreModelName", type=str, default=None,
                        help="checkpoint filename inside restoreModelPath")
    parser.add_argument("-noTrain", action="store_true",
                        help="skip training; restore and test only")
    parser.add_argument("-subset_data", action="store_true")
    parser.add_argument("-debug_mode", action="store_true",
                        help="NaN checking + per-step grad norms "
                             "(reference train.py:340-351)")
    parser.add_argument("-max_epochs", type=int, default=None)
    parser.add_argument("-seed", type=int, default=None)
    parser.add_argument("-monitor_metric", type=str, default="val_micro_f1")
    parser.add_argument("-checkpoint_k", type=int, default=3,
                        help="top-k checkpoints to keep (reference "
                             "train.py:76)")
    parser.add_argument("-no_checkpointing", action="store_true")
    parser.add_argument("-no_save", action="store_true",
                        help="write no artifacts (reference train.py:65)")
    parser.add_argument("-resume", type=str, default=None,
                        help="checkpoint file to elastically resume from: "
                             "continues training at the saved epoch with "
                             "the exact uninterrupted trajectory")
    parser.add_argument("-profile_dir", type=str, default=None,
                        help="write a profiler trace of training here "
                             "(the reference's AdvancedProfiler analog, "
                             "train.py:345-351)")
    # in-driver optuna search (reference train.py:80-83,448-493)
    parser.add_argument("-opt_n_trials", type=int, default=None,
                        help="run an HPO study over the in-driver ranges "
                             "instead of a single run")
    parser.add_argument("-opt_n_cores", type=int, default=-1,
                        help="accepted for parity; trials run sequentially "
                             "(the reference's shipped configs use 1 core)")
    parser.add_argument("-opt_prune", action="store_true",
                        help="median-prune unpromising trials")
    parser.add_argument("-grid_search", action="store_true",
                        help="grid sampler over the reference's fixed space")
    parser.add_argument("-opt_channels", action="store_true",
                        help="search the channel subset (N/S/P combinations) "
                             "as a categorical instead of the reference's "
                             "pinned use_neighborhood-only space")
    parser.add_argument("-opt_holdout_frac", type=float, default=0.0,
                        help="score trials on a train-carved holdout of "
                             "this fraction (min 25 subgraphs) with the "
                             "restored best-val checkpoint, instead of "
                             "best-val itself — nested model selection "
                             "(best-val cannot rank channel subsets on "
                             "tiny val splits, RESULTS.md round 4)")
    parser.add_argument("-log_path", type=str, default=None,
                        help="study/results dir (defaults to tb_dir/tb_name)")
    # per-file path overrides (reference train.py:52-56)
    parser.add_argument("-graph_path", type=str, default=None)
    parser.add_argument("-subgraphs_path", type=str, default=None)
    parser.add_argument("-shortest_paths_path", type=str, default=None)
    parser.add_argument("-similarities_path", type=str, default=None)
    parser.add_argument("-embedding_path", type=str, default=None)
    parser.add_argument("-device", type=str, default="cuda",
                        help="torch device (default cuda; 'cpu' must be "
                             "asked for explicitly)")
    args = parser.parse_args(argv)
    # no GPU for "cuda" fails here, before any work; under torchrun this
    # joins the process group, which is destroyed at exit
    with process_group_from_env(args.device) as device:
        _main(args, device)


def _main(args, device):
    hyp = default_hyperparams()
    if args.restoreModelPath:
        with open(Path(args.restoreModelPath) / "hyperparams.json") as f:
            hyp.update(json.load(f))
    if args.hyperparams:
        with open(args.hyperparams) as f:
            hyp.update(json.load(f))
    if args.max_epochs is not None:
        hyp["max_epochs"] = args.max_epochs
    if args.seed is not None:
        hyp["seed"] = args.seed
    if args.subset_data:
        hyp["subset_data"] = True
    if args.debug_mode:
        hyp["debug_mode"] = True
    if args.noTrain:
        hyp["max_epochs"] = 0

    rc = RunConfig(task=args.task, project_root=Path(args.project_root),
                   tb_dir=args.tb_dir, tb_name=args.tb_name,
                   monitor_metric=args.monitor_metric,
                   graph_path_override=args.graph_path,
                   subgraphs_path_override=args.subgraphs_path,
                   shortest_paths_path_override=args.shortest_paths_path,
                   similarities_path_override=args.similarities_path,
                   embedding_path_override=args.embedding_path)
    if args.opt_n_trials is not None and args.restoreModelPath is None:
        # flow (2) of reference train.py:36-41: HPO over in-driver ranges
        run_optuna_search(args, rc, device)
        return

    results_dir = (None if args.no_save
                   else Path(args.log_path) if args.log_path
                   else Path(args.project_root) / args.tb_dir / args.tb_name)
    restore = None
    if args.restoreModelPath and args.restoreModelName:
        restore = Path(args.restoreModelPath) / args.restoreModelName

    pipe = SubGNNPipeline(rc, HParams.from_dict(hyp), device=device,
                          results_dir=results_dir,
                          checkpoint_k=(0 if args.no_checkpointing
                                        else args.checkpoint_k))
    out = pipe.run(restore_path=restore, resume_path=args.resume,
                   profile_dir=args.profile_dir)
    if is_lead():
        print(json.dumps({"test": out["test"],
                          "best_monitor": out["best_monitor"]},
                         default=float))


if __name__ == "__main__":
    main()
