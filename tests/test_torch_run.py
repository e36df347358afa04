"""Whole training runs: the port's SubGNNPipeline.run against the JAX
package's on the mini fixture, on the CPU.

Each pipeline loads and precomputes its own copy of the fixture
(tests/fixtures/mini_multilabel: D=8 embeddings, trainable CC tables,
dropout 0). The two packages draw their initial weights from different
generators, so the port's build_model is patched to return the JAX run's
draw (convert.params_from_jax). Compared: per-epoch train/val metrics and
every test metric at rtol 1e-4 (as tests/test_torch_train.py), the JSON
artifacts, the holdout metrics, a restored JAX checkpoint, lr_find's
smoothed sweep and suggestion, and resume (port against port, rtol 1e-6).
"""
import json
import pickle
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

import jax

from subgnn_tpu.config import HParams as JHParams, RunConfig as JRunConfig
from subgnn_tpu.config import load_commented_json
from subgnn_tpu.train.checkpoint import save_checkpoint as j_save_checkpoint
from subgnn_tpu.train.loop import Trainer as JTrainer
from subgnn_tpu.train.runner import SubGNNPipeline as JPipe

from subgnn_tpu_torch.config import HParams, RunConfig
from subgnn_tpu_torch.convert import params_from_jax
from subgnn_tpu_torch.train.checkpoint import ForeignState, load_checkpoint
from subgnn_tpu_torch.train.loop import Trainer
from subgnn_tpu_torch.train.runner import SubGNNPipeline

REPO = Path(__file__).parents[1]
FIXTURE = REPO / "tests" / "fixtures" / "mini_multilabel"
ARTIFACTS = ("hyperparams.json", "trainer_kwargs.json",
             "final_metric_scores.json", "test_results.json")
EPOCH_KEYS = ("train_loss", "val_loss", "val_micro_f1", "val_acc")


def _hp(**over):
    hp = dict(load_commented_json(FIXTURE / "mini_config.json")
              ["hyperparams_fix"], max_epochs=2, compute_similarities=False)
    hp.update(over)
    return hp


def _root(tmp_path, name):
    shutil.copytree(FIXTURE / "mini", tmp_path / name / "mini")
    return tmp_path / name


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _run_both(tmp_path, hp, **kw):
    """(JAX pipeline, its run() output, port pipeline, its output), each on
    its own fixture copy and results dir, the port from the JAX weights."""
    jpipe = JPipe(JRunConfig(task="mini",
                             project_root=_root(tmp_path, "jax")),
                  JHParams.from_dict(hp), results_dir=tmp_path / "jres",
                  **kw)
    drawn = {}
    j_build = jpipe.build_model

    def build_jax(seed=None):
        out = j_build(seed)
        drawn["trees"] = _np(out[1]), _np(out[2])
        return out

    jpipe.build_model = build_jax
    jout = jpipe.run(log_fn=None)

    tpipe = SubGNNPipeline(RunConfig(task="mini",
                                     project_root=_root(tmp_path, "torch")),
                           HParams.from_dict(hp), device="cpu",
                           results_dir=tmp_path / "tres", **kw)
    t_build = tpipe.build_model

    def build_from_jax(seed=None):
        model, _, _ = t_build(seed)
        return (model, *params_from_jax(*drawn["trees"], device="cpu"))

    tpipe.build_model = build_from_jax
    tout = tpipe.run(log_fn=None)
    return jpipe, jout, tpipe, tout


def _assert_epochs_close(t_scores, j_scores, rtol):
    assert len(t_scores) == len(j_scores) > 0
    for mt, mj in zip(t_scores, j_scores):
        assert mt["epoch"] == mj["epoch"]
        for k in EPOCH_KEYS:
            np.testing.assert_allclose(mt[k], mj[k], rtol=rtol,
                                       err_msg=f"epoch {mt['epoch']} {k}")


def _assert_metrics_close(got, want, rtol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)


@pytest.mark.parametrize("resample", [False, True],
                         ids=["fixed_anchors", "resample_anchors"])
def test_run_matches_jax(tmp_path, resample):
    hp = _hp(resample_anchor_patches=resample)
    jpipe, jout, tpipe, tout = _run_both(tmp_path, hp)
    _assert_epochs_close(tpipe.trainer.metric_scores,
                         jpipe.trainer.metric_scores, 1e-4)
    _assert_metrics_close(tout["test"], jout["test"], 1e-4)
    assert tout["holdout"] is jout["holdout"] is None
    np.testing.assert_allclose(tout["best_monitor"], jout["best_monitor"],
                               rtol=1e-4)
    _assert_metrics_close(
        {k: v for k, v in tout["val"].items() if k in EPOCH_KEYS},
        {k: v for k, v in jout["val"].items() if k in EPOCH_KEYS}, 1e-4)
    for name in ARTIFACTS:
        got = json.loads((tmp_path / "tres" / name).read_text())
        want = json.loads((tmp_path / "jres" / name).read_text())
        if name == "hyperparams.json":
            assert got == want
        else:
            assert set(got) == set(want), name
    kw = json.loads((tmp_path / "tres" / "trainer_kwargs.json").read_text())
    assert kw["gpus"] == 0 and kw["devices"] == ["cpu"]
    assert kw["mesh_axes"] is None
    test = json.loads((tmp_path / "tres" / "test_results.json").read_text())
    _assert_metrics_close(test, tout["test"], 0)
    assert len(list((tmp_path / "tres" / "tb").glob("events.out.*"))) == 1
    assert len(list((tmp_path / "tres" / "checkpoints").glob("*.ckpt"))) == 2


def test_run_with_train_holdout_matches_jax(tmp_path):
    hp = _hp(batch_size=4)
    jpipe, jout, tpipe, tout = _run_both(tmp_path, hp,
                                         train_holdout=np.array([6, 1, 5]))
    _assert_epochs_close(tpipe.trainer.metric_scores,
                         jpipe.trainer.metric_scores, 1e-4)
    assert set(tout["holdout"]) == set(jout["holdout"])
    assert "holdout_micro_f1" in tout["holdout"]
    _assert_metrics_close(tout["holdout"], jout["holdout"], 1e-4)
    _assert_metrics_close(tout["test"], jout["test"], 1e-4)
    # the trainable train table holds the kept rows only
    assert all(v.shape[0] == 5
               for v in tpipe.trainer.params["train_cc"].values())


def test_restore_of_a_jax_checkpoint_matches_jax(tmp_path, monkeypatch):
    """restore_path with max_epochs=0: the test pass of a checkpoint the
    JAX package wrote (weights drawn from another seed, optax state
    included). Resuming from it raises; its optax classes load as plain
    tuples where optax is missing."""
    import optax
    hp = _hp(max_epochs=0)
    src = JPipe(JRunConfig(task="mini", project_root=_root(tmp_path, "src")),
                JHParams.from_dict(hp))
    src.load()
    _, params, state, _ = src.build_model(seed=11)
    ckpt = tmp_path / "jax.ckpt"
    j_save_checkpoint(ckpt, params, state, optax.adam(1e-3).init(params),
                      meta={"epoch": 4, "global_step": 9})

    jout = JPipe(JRunConfig(task="mini", project_root=_root(tmp_path, "jax")),
                 JHParams.from_dict(hp)).run(log_fn=None, restore_path=ckpt)
    tpipe = SubGNNPipeline(RunConfig(task="mini",
                                     project_root=_root(tmp_path, "torch")),
                           HParams.from_dict(hp), device="cpu")
    tout = tpipe.run(log_fn=None, restore_path=ckpt)
    assert tpipe.trainer.metric_scores == []
    _assert_metrics_close(tout["test"], jout["test"], 1e-4)
    assert np.isnan(tout["best_monitor"]) and np.isnan(jout["best_monitor"])

    with pytest.raises(ValueError, match="optax"):
        SubGNNPipeline(RunConfig(task="mini", project_root=tmp_path / "torch"),
                       HParams.from_dict(_hp(max_epochs=1)),
                       device="cpu").run(log_fn=None, resume_path=ckpt)

    monkeypatch.setitem(sys.modules, "optax", None)   # import optax fails
    payload = load_checkpoint(ckpt)
    adam_state = payload["opt_state"][0]       # (ScaleByAdamState, ...)
    assert isinstance(adam_state, ForeignState) and len(adam_state) == 3
    np.testing.assert_array_equal(payload["params"]["node_embed"],
                                  np.asarray(params["node_embed"]))


def test_lr_find_matches_jax(tmp_path, monkeypatch):
    """The smoothed-loss sweep (captured where both trainers take its
    gradient) and the suggested lr."""
    hp = _hp()
    jpipe = JPipe(JRunConfig(task="mini", project_root=_root(tmp_path, "j")),
                  JHParams.from_dict(hp)).load().precompute()
    tpipe = SubGNNPipeline(RunConfig(task="mini",
                                     project_root=_root(tmp_path, "t")),
                           HParams.from_dict(hp), device="cpu")
    tpipe.load().precompute()
    jmodel, jparams, jstate, jeval = jpipe.build_model()
    tmodel, _, _ = tpipe.build_model()
    p_t, s_t = params_from_jax(_np(jparams), _np(jstate), device="cpu")

    sweeps = []
    gradient = np.gradient

    def capture(losses, *a, **k):
        sweeps.append(np.array(losses))
        return gradient(losses, *a, **k)

    monkeypatch.setattr(np, "gradient", capture)
    j_lr = JTrainer(jmodel, jpipe.hp, eval_cc_tables=jeval).lr_find(
        jparams, jstate, jpipe.split_data("train"), jpipe.sample_anchors(),
        seed=3)
    trainer = Trainer(tmodel, tpipe.hp, device="cpu")
    t_lr = trainer.lr_find(p_t, s_t, tpipe.split_data("train"),
                           tpipe.sample_anchors(), seed=3)
    assert len(sweeps) == 2 and len(sweeps[0]) >= 5
    np.testing.assert_allclose(sweeps[1], sweeps[0], rtol=1e-4)
    assert t_lr == j_lr
    assert 1e-6 / 3 <= t_lr <= 3e-2 / 3
    # the caller's weights were not trained
    np.testing.assert_array_equal(p_t["node_embed"].numpy(),
                                  np.asarray(jparams["node_embed"]))


@pytest.mark.parametrize("extra", [
    {}, {"lin_dropout": 0.3, "lstm_dropout": 0.3, "lstm_n_layers": 2,
         "resample_anchor_patches": True}],
    ids=["no_dropout", "dropout_resample"])
def test_resume_reproduces_the_uninterrupted_run(tmp_path, extra):
    hp = HParams.from_dict(_hp(max_epochs=3, **extra))
    root = _root(tmp_path, "data")
    rc = RunConfig(task="mini", project_root=root)
    full = SubGNNPipeline(rc, hp, device="cpu", results_dir=tmp_path / "a")
    full.run(log_fn=None)
    ckpt, = (tmp_path / "a" / "checkpoints").glob("epoch=0-*.ckpt")
    assert load_checkpoint(ckpt)["rng_state"].dtype == np.uint8
    resumed = SubGNNPipeline(rc, hp, device="cpu",
                             results_dir=tmp_path / "b")
    resumed.run(log_fn=None, resume_path=ckpt)
    assert [m["epoch"] for m in resumed.trainer.metric_scores] == [1, 2]
    _assert_epochs_close(resumed.trainer.metric_scores,
                         full.trainer.metric_scores[1:], 1e-6)
    assert resumed.trainer.global_step == full.trainer.global_step
    # the weights saved after epochs 1 and 2 agree too (the test pass uses
    # the best of the checkpoints each run saw, which may differ)
    saved = sorted((tmp_path / "b" / "checkpoints").glob("*.ckpt"))
    assert len(saved) == 2
    for path in saved:
        twin, = (tmp_path / "a" / "checkpoints").glob(
            path.name.split("-")[0] + "-*.ckpt")
        got = load_checkpoint(path)["params"]
        want = load_checkpoint(twin)["params"]
        for (kp, a), b in zip(
                jax.tree_util.tree_leaves_with_path(got),
                jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7,
                                       err_msg=jax.tree_util.keystr(kp))
    # without the generator's state the masks (and the losses) differ
    if extra:
        payload = load_checkpoint(ckpt)
        del payload["rng_state"]
        bare = tmp_path / "bare.ckpt"
        bare.write_bytes(pickle.dumps(payload))
        again = SubGNNPipeline(rc, hp, device="cpu")
        again.run(log_fn=None, resume_path=bare)
        assert (again.trainer.metric_scores[0]["train_loss"]
                != full.trainer.metric_scores[1]["train_loss"])


def test_best_monitor_value_matches_jax():
    scores = [{"val_loss": 0.9, "val_micro_f1": 0.2},
              {"val_loss": 0.1, "val_micro_f1": 0.8},
              {"val_loss": 0.5, "val_micro_f1": 0.4}]
    for monitor, want in (("val_loss", 0.1), ("val_micro_f1", 0.8),
                          ("val_acc", None)):
        got = []
        for cls in (Trainer, JTrainer):
            t = cls.__new__(cls)
            t.metric_scores, t.monitor = scores, monitor
            got.append(cls.best_monitor_value(t))
        if want is None:
            assert all(np.isnan(got))
        else:
            assert got == [pytest.approx(want)] * 2
