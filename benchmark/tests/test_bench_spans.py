"""The readers of the program's spans (harness/fit_spans.py and the five
per-layer metrics that use it) on the CPU: numbers from a fit's recorder,
None where the program has no recorder, and all five in a traced run's
result line."""
import sys

import pytest

from benchmark.harness import fit_spans
from benchmark.harness.common import Cell
from benchmark.tests import tiny

READERS = ["host_schedule_ms.train", "launch_us_per_replay.train",
           "host_wait_ms.train", "eval_metrics_ms.train",
           "epoch_unspanned_share.train"]
# a window of 8 epochs from epoch 2, epochs 3 and 4 traced: the clean
# epochs leave out 2 (the profiler's start), 3, 4 and 5 (its stop)
CTX = {"traced_epochs": [3, 4], "epochs": 8}


@pytest.fixture(scope="module")
def fitted():
    from subgnn_tpu_torch.bench import build_training_fixture
    from subgnn_tpu_torch.train.loop import Trainer
    model, hp, params, state, data, anchors, _ = build_training_fixture(
        hp_overrides=dict(max_epochs=11), device="cpu")
    tr = Trainer(model, hp, device="cpu")
    tr.fit(params, state, data["train"], data["val"], anchors, seed=0,
           log_fn=None)
    assert tr.fused
    return tr


def test_clean_epochs_leave_out_the_traced_and_their_neighbours():
    assert fit_spans.clean_epochs(CTX) == [6, 7, 8, 9]
    assert fit_spans.clean_epochs({"traced_epochs": [], "epochs": 8}) == []


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_a_number(fitted, name):
    from subgnn_tpu_torch.train import spans
    assert spans.last() is fitted.spans
    value = Cell("ppi_bp.train").reader(name)(CTX)
    assert isinstance(value, float) and value >= 0
    if name == "epoch_unspanned_share.train":
        assert value < 100
    if name == "launch_us_per_replay.train":
        rec = fitted.spans
        per = sorted(rec.total_ns(e, "fit.train.launch")
                     + rec.total_ns(e, "fit.eval.launch")
                     for e in range(6, 10))
        replays = rec.counters[6]["replays"]
        assert value == pytest.approx((per[1] + per[2]) / 2 / replays / 1e3)


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_none_without_a_recorder(fitted, name, monkeypatch):
    read = Cell("ppi_bp.train").reader(name)
    assert read({"traced_epochs": [], "epochs": 8}) is None
    assert read({"traced_epochs": [30], "epochs": 2}) is None
    from subgnn_tpu_torch.train import spans
    monkeypatch.setattr(spans, "_last", None)
    assert read(CTX) is None
    # a program without the module
    monkeypatch.setitem(sys.modules, "subgnn_tpu_torch.train.spans", None)
    assert read(CTX) is None


def test_traced_run_reports_the_five(tmp_path, capsys, monkeypatch):
    """A tiny traced run whose window closes two epochs after the traced
    ones and their neighbours, however long the profiler takes to start."""
    import json
    import time

    import torch
    from benchmark import run as R
    from benchmark.harness import fit

    class Window(fit.Window):
        def __call__(self, epoch, metrics):
            if self.first is not None and \
                    epoch - self.first >= self.trace_epochs + 3:
                self.seconds = 0.0
            return super().__call__(epoch, metrics)
    monkeypatch.setattr(fit, "Window", Window)
    bench = tiny.make(tmp_path)
    args = R.parse(["--workload", "hpo_metab.train", "--seed",
                    str(2 ** 33 + 5), "--seconds", "1e9", "--trace", "1"])
    capsys.readouterr()
    assert R.run_cell(tiny.cell(bench, "hpo_metab.train"), args,
                      torch.device("cpu"), time.perf_counter()) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert len(out["info"]["epoch_walls_s"]) == 2     # the clean epochs
    for name in READERS:
        assert out["metrics"][name]["value"] >= 0, name
    assert out["metrics"]["epoch_unspanned_share.train"]["value"] < 20
