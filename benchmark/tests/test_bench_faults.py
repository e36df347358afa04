"""A whole run of each tiny cell on the CPU, sound and with the timed path
broken underneath: `correct` comes out true, then false once for each
fault the cell can have (a step that leaves its state unchanged; half the
batch left out, the mean over the rest; an answer altered where it is
produced). One chip: there is no exchange between chips to leave out."""
import numpy as np
import pytest

from benchmark.tests import tiny

TRAIN = tiny.workloads("fit")
PREDICT = tiny.workloads("predict")


@pytest.fixture
def bench(tmp_path):
    return tiny.make(tmp_path)


@pytest.mark.parametrize("name", TRAIN + PREDICT)
def test_sound_run_is_correct(bench, name, capsys):
    out = tiny.run(bench, name, capsys)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {
        m["name"] for m in tiny.cell(bench, name).end_to_end}


@pytest.mark.parametrize("name", TRAIN)
def test_state_left_unchanged_fails(bench, name, capsys, monkeypatch):
    from subgnn_tpu_torch.train import loop
    monkeypatch.setattr(loop.Adam, "step", lambda self, *a, **k: None)
    out = tiny.run(bench, name, capsys)
    assert not out["correct"]
    assert out["checks"]["update_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", TRAIN)
def test_half_batch_fails(bench, name, capsys, monkeypatch):
    from subgnn_tpu_torch.models.subgnn import SubGNNModel
    orig = SubGNNModel.loss_fn

    def half(self, logits, labels, valid=None, n_valid=None):
        h = logits.shape[0] // 2
        return orig(self, logits[:h], labels[:h],
                    None if valid is None else valid[:h])
    monkeypatch.setattr(SubGNNModel, "loss_fn", half)
    out = tiny.run(bench, name, capsys)
    assert not out["correct"]


@pytest.mark.parametrize("name", PREDICT)
def test_altered_answer_fails(bench, name, capsys, monkeypatch):
    from subgnn_tpu_torch.train.runner import SubGNNPipeline
    orig = SubGNNPipeline.predict

    def altered(self, *a, **k):
        out = orig(self, *a, **k)
        out["logits"] = out["logits"].copy()
        out["logits"][-1, 0] += np.float32(0.01) * max(
            1.0, float(np.abs(out["logits"]).max()))
        return out
    monkeypatch.setattr(SubGNNPipeline, "predict", altered)
    out = tiny.run(bench, name, capsys)
    assert not out["correct"]
