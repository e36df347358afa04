"""The port's copies of the TensorBoard writer and the HPO study against
the JAX package's, and its train / test / train_config CLIs on the CPU.

TBWriter: byte-identical event files for the same scalars and clock.
Study/Trial: the same params, study.json and best trial for the same seed
with the random, grid and TPE samplers, through resume and pruning. The
CLIs run with -device cpu on copies of the mini fixture (D=8, 1 epoch) and
must write the JAX CLIs' artifacts; flags not ported yet, and cuda without
a GPU, exit non-zero.
"""
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import subgnn_tpu.train.hpo as j_hpo
import subgnn_tpu.train.tb_writer as j_tb
from subgnn_tpu.cli import test as j_test_cli
from subgnn_tpu.cli import train as j_train_cli
from subgnn_tpu.config import load_commented_json

import subgnn_tpu_torch.train.hpo as t_hpo
import subgnn_tpu_torch.train.tb_writer as t_tb
from subgnn_tpu_torch.cli import test as t_test_cli
from subgnn_tpu_torch.cli import train as t_train_cli
from subgnn_tpu_torch.cli import train_config as t_train_config
from subgnn_tpu_torch.train.checkpoint import load_checkpoint

REPO = Path(__file__).parents[1]
FIXTURE = REPO / "tests" / "fixtures" / "mini_multilabel"
ARTIFACTS = ("hyperparams.json", "trainer_kwargs.json",
             "final_metric_scores.json", "test_results.json")


def test_tb_writer_bytes_match_jax(tmp_path, monkeypatch):
    files = []
    for mod, name in ((j_tb, "jax"), (t_tb, "torch")):
        clock = iter(np.arange(1_700_000_000.0, 1_700_000_100.0, 0.25))
        monkeypatch.setattr(mod.time, "time", lambda c=clock: next(c))
        w = mod.TBWriter(tmp_path / name)
        for step in range(3):
            w.add_scalars({"train_loss": 0.5 / (step + 1), "epoch": step,
                           "val_micro_f1": np.float64(0.25 * step),
                           "note": "skipped", "flag": True}, step)
        w.add_scalar("lr", 1e-3, 7)
        w.close()
        files.extend((tmp_path / name).glob("events.out.tfevents.*"))
    assert len(files) == 2 and files[0].name == files[1].name
    assert files[0].read_bytes() == files[1].read_bytes()
    assert len(files[0].read_bytes()) > 200


def _objective(hpo):
    """An objective of each package's own TrialPruned: a float, a log
    float, an int and a categorical; prunes by the median rule."""
    def objective(trial):
        x = trial.suggest_float("x", 0.0, 1.0)
        lr = trial.suggest_float("lr", 1e-5, 1e-2, log=True)
        n = trial.suggest_int("n", 1, 6)
        c = trial.suggest_categorical("c", ["sum", "max"])
        trial.suggest_int("neigh_sample_border_size", 1, 2)
        value = x + 0.1 * n + (0.3 if c == "max" else 0.0) - 10 * lr
        for step in range(7):
            trial.report(value * (step + 1) / 7, step)
            if trial.should_prune():
                raise hpo.TrialPruned()
        return value
    return objective


@pytest.mark.parametrize("sampler", ["random", "grid", "tpe"])
def test_study_matches_jax(tmp_path, sampler):
    space = {"neigh_sample_border_size": [1, 2], "c": ["sum", "max"],
             "n": [2, 5, 6]} if sampler == "grid" else None
    studies = {}
    for name, hpo in (("jax", j_hpo), ("torch", t_hpo)):
        path = tmp_path / name / "study.json"
        kw = dict(direction="maximize", sampler=sampler, seed=5,
                  grid_search_space=space)
        hpo.Study(path, **kw).optimize(_objective(hpo), 7)
        # resume: a new Study on the same file continues it
        studies[name] = hpo.Study(path, **kw).optimize(_objective(hpo), 14)
    j, t = studies["jax"], studies["torch"]
    assert (tmp_path / "torch" / "study.json").read_text() == \
        (tmp_path / "jax" / "study.json").read_text()
    assert t.trials == j.trials
    assert len(t.trials) == (12 if sampler == "grid" else 14)
    assert any(tr["pruned"] for tr in t.trials)
    assert t.best_trial == j.best_trial and t.best_params == j.best_params
    minimize = t_hpo.Study(tmp_path / "torch" / "study.json",
                           direction="minimize")
    assert minimize.best_trial == j_hpo.Study(
        tmp_path / "jax" / "study.json", direction="minimize").best_trial


def test_trial_and_spec_helpers_match_jax():
    rc = type("RC", (), {"hyperparams_fix": {"max_epochs": 3},
                         "hyperparams_optuna": {
                             "batch_size": {"type": "suggest_categorical",
                                            "args": [[64, 128]]},
                             "learning_rate": {"type": "suggest_float",
                                               "args": [1e-4, 1e-2],
                                               "kwargs": {"log": True}},
                             "lin_dropout": {"type": "suggest_uniform",
                                             "args": [0.0, 0.5]},
                             "n_layers": {"type": "suggest_int",
                                          "args": [1, 4]}}})()
    for seed in range(4):
        got = t_hpo.hyperparams_from_config(
            rc, t_hpo.Trial(np.random.default_rng(seed)))
        want = j_hpo.hyperparams_from_config(
            rc, j_hpo.Trial(np.random.default_rng(seed)))
        assert got == want
        tt = t_hpo.Trial(np.random.default_rng(seed))
        jt = j_hpo.Trial(np.random.default_rng(seed))
        assert t_hpo.suggest_channels(tt) == j_hpo.suggest_channels(jt)
        assert t_train_cli.get_hyperparams_optuna(
            argparseish(max_epochs=2), tt) == \
            j_train_cli.get_hyperparams_optuna(argparseish(max_epochs=2), jt)
    assert t_train_cli.GRID_SEARCH_SPACE == j_train_cli.GRID_SEARCH_SPACE
    assert t_train_cli.default_hyperparams() == \
        j_train_cli.default_hyperparams()


def argparseish(**kw):
    import argparse
    return argparse.Namespace(**kw)


@pytest.fixture()
def mini_root(tmp_path):
    shutil.copytree(FIXTURE / "mini", tmp_path / "data" / "mini")
    return tmp_path / "data"


def _hyperparams_file(tmp_path, **over):
    hyp = dict(load_commented_json(FIXTURE / "mini_config.json")
               ["hyperparams_fix"], compute_similarities=False)
    hyp.update(over)
    path = tmp_path / "hyp.json"
    path.write_text(json.dumps(hyp))
    return path


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_train_cli_run_restore_and_resume(mini_root, tmp_path, capsys):
    hyp = _hyperparams_file(tmp_path, max_epochs=2)
    base = ["-task", "mini", "-project_root", str(mini_root),
            "-hyperparams", str(hyp), "-device", "cpu"]
    t_train_cli.main(base + ["-tb_name", "run"])
    printed = _last_json(capsys)
    run = mini_root / "tensorboard" / "run"
    for name in ARTIFACTS:
        assert (run / name).exists(), name
    assert len(list((run / "tb").glob("events.out.tfevents.*"))) == 1
    test = json.loads((run / "test_results.json").read_text())
    assert printed["test"] == pytest.approx(test, nan_ok=True)
    assert set(printed) == {"test", "best_monitor"}
    assert json.loads((run / "trainer_kwargs.json").read_text())["gpus"] == 0

    # -noTrain: the best checkpoint's weights and state, tested again
    ckpts = sorted((run / "checkpoints").glob("*.ckpt"))
    best = max(ckpts, key=lambda p: load_checkpoint(p)["meta"]
               ["val_micro_f1"])
    t_train_cli.main(["-task", "mini", "-project_root", str(mini_root),
                      "-restoreModelPath", str(run),
                      "-restoreModelName", f"checkpoints/{best.name}",
                      "-noTrain",
                      "-tb_name", "restored", "-device", "cpu"])
    again = _last_json(capsys)
    restored = mini_root / "tensorboard" / "restored"
    assert json.loads((restored / "hyperparams.json").read_text())[
        "max_epochs"] == 0
    assert not (restored / "final_metric_scores.json").exists()
    assert again["test"] == pytest.approx(printed["test"], rel=1e-6,
                                          nan_ok=True)

    # -resume from epoch 0 continues to the same last epoch
    first, = (run / "checkpoints").glob("epoch=0-*.ckpt")
    t_train_cli.main(base + ["-tb_name", "resumed", "-resume", str(first)])
    capsys.readouterr()
    final = json.loads((run / "final_metric_scores.json").read_text())
    resumed = json.loads((mini_root / "tensorboard" / "resumed" /
                          "final_metric_scores.json").read_text())
    assert resumed["epoch"] == final["epoch"] == 1
    for k in ("train_loss", "val_loss", "val_micro_f1"):
        assert resumed[k] == pytest.approx(final[k], rel=1e-6)


def test_train_cli_in_driver_search(mini_root, monkeypatch, capsys):
    """-opt_n_trials: a resumable study over the in-driver ranges, patched
    to the fixture's widths so that two trials train in seconds."""
    fixed = load_commented_json(FIXTURE / "mini_config.json")[
        "hyperparams_fix"]

    def tiny_ranges(args, trial):
        return dict(fixed, max_epochs=1, compute_similarities=False,
                    learning_rate=trial.suggest_float(
                        "learning_rate", 1e-4, 1e-2, log=True))

    monkeypatch.setattr(t_train_cli, "get_hyperparams_optuna", tiny_ranges)
    t_train_cli.main(["-task", "mini", "-project_root", str(mini_root),
                      "-tb_name", "search", "-opt_n_trials", "2",
                      "-device", "cpu"])
    payload = _last_json(capsys)
    assert set(payload["best_params"]) == {"learning_rate"}
    search = mini_root / "tensorboard" / "search"
    trials = json.loads((search / "study.json").read_text())["trials"]
    assert len(trials) == 2 and all(np.isfinite(t["value"]) for t in trials)
    versions = sorted(search.glob("version_*"))
    assert len(versions) == 2
    for v in versions:
        for name in ARTIFACTS:
            assert (v / name).exists(), (v, name)


def test_test_cli_writes_the_jax_keys(mini_root, tmp_path, monkeypatch):
    """run_seeds trains each seed on the CPU; the JAX harness, given canned
    runs, writes experiment_results.json with the same keys."""
    hyp = _hyperparams_file(tmp_path, max_epochs=1)
    out = t_test_cli.run_seeds("mini", str(mini_root), str(hyp), n_seeds=2,
                               out_dir=str(tmp_path / "exp"), log_fn=None,
                               device="cpu")
    written = json.loads((tmp_path / "exp" /
                          "experiment_results.json").read_text())
    assert written == pytest.approx(out)
    assert written["seeds"] == [0, 1]
    for k in ("acc_mean", "micro_f1_mean", "auroc_mean"):
        assert np.isfinite(written[k]), k
    for i in range(2):
        assert (tmp_path / "exp" / f"seed_{i}" / "test_results.json").exists()

    class Canned:
        def __init__(self, rc, hp, results_dir=None):
            self.hp = hp

        def run(self, seed=None, log_fn=None):
            v = 0.5 + 0.1 * seed
            return {"test": {"test_acc": v, "test_micro_f1": v,
                             "test_auroc": v}}

    monkeypatch.setattr(j_test_cli, "SubGNNPipeline", Canned)
    j_test_cli.run_seeds("mini", str(mini_root), str(hyp), n_seeds=2,
                         out_dir=str(tmp_path / "jexp"), log_fn=None)
    jax_keys = json.loads((tmp_path / "jexp" /
                           "experiment_results.json").read_text())
    assert set(written) == set(jax_keys)


def test_train_config_runs_a_study(mini_root, tmp_path):
    cfg = load_commented_json(FIXTURE / "mini_config.json")
    cfg["hyperparams_fix"].update(max_epochs=1, compute_similarities=False)
    cfg["hyperparams_optuna"] = {"learning_rate": {
        "type": "suggest_float", "args": [1e-4, 1e-2],
        "kwargs": {"log": True}}}
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    t_train_config.main(["-config_path", str(path), "-project_root",
                         str(mini_root), "-n_trials", "2", "-device", "cpu"])
    study = mini_root / "tb" / "mini" / "study.json"
    trials = json.loads(study.read_text())["trials"]
    assert len(trials) == 2
    assert all(np.isfinite(t["value"]) for t in trials)
    assert len({t["params"]["learning_rate"] for t in trials}) == 2


@pytest.mark.parametrize("flag", [["-profile_dir", "prof"], ["-debug_mode"]])
def test_train_cli_refuses_flags_not_ported(mini_root, flag, tmp_path):
    """Both flags were refused before the fused-epoch slice; now each runs:
    -profile_dir writes a torch.profiler trace of the fit, -debug_mode
    trains streaming and reports the epochs' gradient norms."""
    hyp = _hyperparams_file(tmp_path, max_epochs=1)
    if flag[0] == "-profile_dir":
        flag = ["-profile_dir", str(tmp_path / "prof")]
    t_train_cli.main(["-task", "mini", "-project_root", str(mini_root),
                      "-hyperparams", str(hyp), "-device", "cpu",
                      "-tb_name", "flagged"] + flag)
    run = mini_root / "tensorboard" / "flagged"
    final = json.loads((run / "final_metric_scores.json").read_text())
    assert json.loads((run / "test_results.json").read_text())
    if flag[0] == "-profile_dir":
        assert list((tmp_path / "prof").glob("*.pt.trace.json"))
        assert "grad_norm" not in final
    else:
        assert json.loads((run / "hyperparams.json").read_text())[
            "debug_mode"] is True
        assert np.isfinite(final["grad_norm"]) and final["grad_norm"] > 0


def test_clis_refuse_cuda_without_a_gpu(mini_root, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hyp = _hyperparams_file(tmp_path, max_epochs=1)
    with pytest.raises(RuntimeError, match="cuda"):
        t_train_cli.main(["-task", "mini", "-project_root", str(mini_root),
                          "-hyperparams", str(hyp)])
    (tmp_path / "hyperparams.json").write_text(hyp.read_text())
    with pytest.raises(RuntimeError, match="cuda"):
        t_test_cli.main(["-task", "mini", "-project_root", str(mini_root),
                         "-restoreModelPath", str(tmp_path), "-n_seeds", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        t_train_config.main(["-config_path",
                             str(FIXTURE / "mini_config.json"),
                             "-project_root", str(mini_root)])
    # and a Trainer, debug_mode or not
    from subgnn_tpu_torch.config import HParams
    from subgnn_tpu_torch.train.loop import Trainer
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(None, HParams(debug_mode=True))
    for made in ("tensorboard", "tb", "experiments"):
        assert not (mini_root / made).exists(), made
