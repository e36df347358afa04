"""The port's spans and counters (train/spans.py) on the CPU: what
`Trainer.fit` records per epoch, that the spans reach torch.profiler's
timeline only while it records, that `epoch_time_s` and predict's `timings`
come from them, and that Adam clips a gradient shared by two leaves once.

Fits run the training fixture (`build_training_fixture`: 16 train and 8 val
subgraphs, batch 8) in the fused mode, whose CPU path calls the steps where
the card replays their graphs and keeps the NP sims on the device, the steps
gathering their compact sims (no `fit.schedule.sims`) and building their
gather plans (no `fit.schedule.plans`); predict runs the mini fixture's
pipeline."""
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from subgnn_tpu_torch.bench import build_training_fixture
from subgnn_tpu_torch.config import HParams, RunConfig
from subgnn_tpu_torch.train import loop as L
from subgnn_tpu_torch.train import spans as S
from subgnn_tpu_torch.train.loop import Trainer
from subgnn_tpu_torch.train.runner import SubGNNPipeline

EPOCHS = 3
FUSED = {"fit.epoch": None, "fit.train": "fit.epoch",
         "fit.train.launch": "fit.train", "fit.schedule": "fit.train",
         "fit.schedule.put": "fit.schedule", "fit.train.wait": "fit.train",
         "fit.eval": "fit.epoch", "fit.eval.launch": "fit.eval",
         "fit.eval.wait": "fit.eval", "fit.eval.metrics": "fit.eval",
         "fit.epoch_end": "fit.epoch"}
# the last epoch schedules no next one
SCHEDULE = {k for k in FUSED if k.startswith("fit.schedule")}
STREAMING = {"fit.epoch": None, "fit.train": "fit.epoch",
             "fit.eval": "fit.epoch", "fit.epoch_end": "fit.epoch"}
REPO = Path(__file__).parents[1]
MINI = REPO / "tests" / "fixtures" / "mini_multilabel" / "mini"


def _fit(monkeypatch=None, streaming=False, host_sims=False,
         host_plans=False, **fit_kw):
    model, hp, params, state, data, anchors, _ = build_training_fixture(
        hp_overrides=dict(max_epochs=EPOCHS), device="cpu")
    tr = Trainer(model, hp, device="cpu")
    if streaming:
        monkeypatch.setattr(Trainer, "_split_bytes",
                            staticmethod(lambda d: 1 << 40))
    if host_sims:       # a device with no room for the NP sims
        monkeypatch.setattr(L, "_free_device_bytes", lambda device: 0)
    if host_plans:      # the node axis's rule
        monkeypatch.setattr(L, "plans_fit_on_device", lambda row_range: False)
    tr.fit(params, state, data["train"], data["val"], anchors, seed=0,
           log_fn=None, **fit_kw)
    assert tr.fused is not streaming
    return tr, hp, data


def _check_tree(rec, epoch, want):
    rows = rec.rows(epoch)
    assert sorted(r[0] for r in rows) == sorted(want)   # each once
    assert rows[0][0] == "fit.epoch" and rows[0][1] == -1
    for name, parent, start, end in rows:
        assert end >= start > 0, name
        if parent >= 0:
            assert rows[parent][0] == want[name], name
            assert rows[parent][2] <= start and end <= rows[parent][3], name


def test_fused_fit_records_each_span_once_per_epoch():
    tr, hp, data = _fit()
    rec = tr.spans
    assert S.last() is rec
    assert sorted(rec.epochs) == list(range(EPOCHS))
    for epoch in range(EPOCHS):
        want = dict(FUSED)
        if epoch == EPOCHS - 1:
            want = {k: v for k, v in want.items() if k not in SCHEDULE}
        _check_tree(rec, epoch, want)
        n_train = len(data["train"]) // hp.batch_size
        n_val = -(-len(data["val"]) // hp.batch_size)
        assert rec.counters[epoch] == {"replays": n_train + n_val,
                                       "device_sims": n_train + n_val,
                                       "device_plans": n_train}
        # 32 bytes a span
        assert len(rec.epochs[epoch]) * 8 == 32 * len(want)
    # the innermost spans cover the epochs
    assert sum(map(rec.unspanned_ns, range(EPOCHS))) <= 0.1 * sum(
        rec.total_ns(e, "fit.epoch") for e in range(EPOCHS))


def test_host_gathered_sims_have_their_span(monkeypatch):
    """Where the host gathers the compact sims, `fit.schedule.sims` times
    it inside `fit.schedule`, and no replay counts as `device_sims`."""
    tr, hp, data = _fit(monkeypatch, host_sims=True)
    assert tr.sims_on_device is False
    rec = tr.spans
    for epoch in range(EPOCHS):
        want = dict(FUSED, **{"fit.schedule.sims": "fit.schedule"})
        if epoch == EPOCHS - 1:
            want = {k: v for k, v in want.items() if k not in SCHEDULE
                    and k != "fit.schedule.sims"}
        _check_tree(rec, epoch, want)
        n_train = len(data["train"]) // hp.batch_size
        n_val = -(-len(data["val"]) // hp.batch_size)
        assert rec.counters[epoch] == {"replays": n_train + n_val,
                                       "device_sims": 0,
                                       "device_plans": n_train}


def test_host_built_plans_have_their_span(monkeypatch):
    """Where the host builds the gather plans (the node axis's rule),
    `fit.schedule.plans` times it inside `fit.schedule`, and no replay
    counts as `device_plans`."""
    tr, hp, data = _fit(monkeypatch, host_plans=True)
    assert tr.plans_on_device is False and tr.sims_on_device is True
    rec = tr.spans
    for epoch in range(EPOCHS):
        want = dict(FUSED, **{"fit.schedule.plans": "fit.schedule"})
        if epoch == EPOCHS - 1:
            want = {k: v for k, v in want.items()
                    if not k.startswith("fit.schedule")}
        _check_tree(rec, epoch, want)
        n_train = len(data["train"]) // hp.batch_size
        n_val = -(-len(data["val"]) // hp.batch_size)
        assert rec.counters[epoch] == {"replays": n_train + n_val,
                                       "device_sims": n_train + n_val,
                                       "device_plans": 0}


def test_streaming_fit_records_train_and_eval(monkeypatch):
    tr, _, _ = _fit(monkeypatch, streaming=True)
    for epoch in range(EPOCHS):
        _check_tree(tr.spans, epoch, STREAMING)
        assert tr.spans.counters[epoch] == {}


def test_epoch_time_is_train_and_eval_on_the_spans_clock():
    tr, _, _ = _fit()
    for epoch, metrics in enumerate(tr.metric_scores):
        rows = {r[0]: r for r in tr.spans.rows(epoch)}
        want = (rows["fit.eval"][3] - rows["fit.epoch"][2]) * 1e-9
        assert metrics["epoch_time_s"] == pytest.approx(want, rel=1e-12)
        assert 0 < metrics["epoch_time_s"] < (
            rows["fit.epoch"][3] - rows["fit.epoch"][2]) * 1e-9


def test_spans_are_profiler_ranges_under_the_profiler():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _fit()
    spans = [e for e in prof.events() if e.name in FUSED]
    assert {e.name for e in spans} == set(FUSED)
    # host operations of a function's scope: a user scope's range would
    # get a device-side copy over the device work launched inside it
    user = torch._C._profiler.RecordScope.USER_SCOPE.value
    assert all(e.device_type.name == "CPU" and e.scope != user
               for e in spans)


def test_fit_with_profile_dir_traces_the_spans(tmp_path):
    _fit(profile_dir=str(tmp_path / "trace"))
    trace, = (tmp_path / "trace").glob("*.pt.trace.json")
    text = trace.read_text()
    for name in FUSED:
        assert f'"{name}"' in text, name


def test_no_profiler_range_without_the_profiler(monkeypatch):
    entered = []

    def profiler_range(name, *a, **k):
        entered.append(name)
        raise AssertionError("a profiler range without the profiler")
    monkeypatch.setattr(S, "_ProfilerRange", profiler_range)
    assert not S.profiling()
    tr, _, _ = _fit()
    assert entered == [] and len(tr.spans.epochs) == EPOCHS


def test_spans_outside_an_epoch_are_not_kept():
    rec = S.Spans()
    with rec.span("before"):
        pass
    rec.count("replays", 2)
    with rec.epoch(4):
        with rec.span("inner") as inner:
            rec.count("replays", 3)
    with rec.span("after"):
        pass
    assert list(rec.epochs) == [4] and rec.counters == {4: {"replays": 3}}
    assert [r[0] for r in rec.rows(4)] == ["fit.epoch", "inner"]
    assert rec.total_ns(4, "inner") == inner.end - inner.start
    assert rec.total_ns(4, "before") is None
    assert rec.unspanned_ns(4) == (rec.total_ns(4, "fit.epoch")
                                   - rec.total_ns(4, "inner"))


@pytest.mark.parametrize("clip", [1e-3, 0.0])
def test_adam_scales_a_gradient_shared_by_two_leaves_once(clip):
    """Autograd can hand one tensor to two leaves (the LSTM's b_ih + b_hh):
    each leaf's gradient is clipped once, as optax clips each leaf."""
    params = {"b_ih": torch.zeros(4), "b_hh": torch.zeros(4),
              "w": torch.zeros(3)}
    tx = L.Adam(lr=0.1, grad_clip=clip)
    opt = tx.init(params)
    g = torch.tensor([1.0, -2.0, 3.0, 0.5])
    w = torch.tensor([0.25, 0.5, -1.0])
    shared = g.clone()
    tx.step(params, [shared, shared, w.clone()], opt)
    norm = float(torch.sqrt(2 * g.square().sum() + w.square().sum()))
    scale = clip / norm if clip else 1.0
    for i, want in enumerate((g, g, w)):
        torch.testing.assert_close(opt["mu"][i], (1 - tx.b1) * scale * want,
                                   rtol=1e-6, atol=0)
        torch.testing.assert_close(opt["nu"][i],
                                   (1 - tx.b2) * (scale * want) ** 2,
                                   rtol=1e-5, atol=0)


def test_adam_clips_the_lstm_biases_once():
    """The aliasing as autograd makes it: one gradient for both biases of a
    sum, clipped once; the update equals that of unaliased gradients."""
    b_ih = torch.tensor([0.5, -1.0, 2.0], requires_grad=True)
    b_hh = torch.tensor([1.5, 0.0, -0.5], requires_grad=True)
    x = torch.tensor([3.0, -4.0, 1.0])
    loss = (x * (b_ih + b_hh)).sum()
    grads = list(torch.autograd.grad(loss, [b_ih, b_hh]))
    apart = [t.clone() for t in grads]
    runs = []
    for gs in (grads, apart):
        params = {"b_ih": b_ih.detach().clone(), "b_hh": b_hh.detach().clone()}
        tx = L.Adam(lr=0.1, grad_clip=0.5)
        opt = tx.init(params)
        tx.step(params, gs, opt)
        runs.append((params, opt))
    (p1, o1), (p2, o2) = runs
    for k in p1:
        torch.testing.assert_close(p1[k], p2[k], rtol=0, atol=0)
    for a, b in zip(o1["mu"], o2["mu"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(o1["mu"][0], 0.1 * 0.5 * x / x.norm() / (
        2 ** 0.5), rtol=1e-6, atol=0)


@pytest.fixture()
def pipeline(tmp_path):
    shutil.copytree(MINI, tmp_path / "mini")
    hp = HParams(use_neighborhood=True, use_position=True, use_structure=True,
                 max_sim_epochs=1, n_triangular_walks=2, random_walk_len=4,
                 sample_walk_len=6, batch_size=4, n_layers=1,
                 node_embed_size=8, linear_hidden_dim_1=8,
                 linear_hidden_dim_2=8, n_anchor_patches_N_in=2,
                 n_anchor_patches_N_out=2, n_anchor_patches_pos_in=3,
                 n_anchor_patches_pos_out=3, n_anchor_patches_structure=2,
                 seed=0)
    pipe = SubGNNPipeline(RunConfig(task="mini", project_root=tmp_path), hp,
                          device="cpu")
    pipe.load()
    pipe.precompute()
    _, params, state = pipe.build_model()
    return pipe, params, state


def test_predict_timings_are_spans(pipeline):
    pipe, params, state = pipeline
    novel = [[1, 5, 9, 13], [2, 6, 10], [30, 31, 32, 33, 34]]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = pipe.predict(novel, params, state, max_n_cc=4, max_len_cc=6)
    timings = out["timings"]
    stages = ("cc_split", "structure_sims", "bfs_rows_wall", "anchors",
              "forward", "np_sim", "border_sets")
    assert set(timings) == set(stages) | {"total", "bfs_srcs",
                                          "bfs_cache_miss"}
    assert all(timings[k] >= 0 for k in stages)
    assert timings["total"] >= timings["forward"] + timings["cc_split"]
    assert isinstance(timings["bfs_srcs"], int)
    # the calling thread's spans (the profiler records no worker thread's)
    names = {e.name for e in prof.events()}
    assert {"predict", "predict.cc_split", "predict.bfs_rows",
            "predict.structure_sims", "predict.anchors",
            "predict.forward"} <= names
    again = pipe.predict(novel, params, state, max_n_cc=4, max_len_cc=6)
    assert again["timings"]["bfs_cache_miss"] == 0
    np.testing.assert_array_equal(again["logits"], out["logits"])
