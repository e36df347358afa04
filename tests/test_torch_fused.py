"""The port's fused-epoch trainer against the JAX package's, on the CPU.

On the CPU the fused mode runs the card's code path (resident splits and
NP sims, the batch, its gather plans and its compact sims built on the
device from an index row, losses read once an epoch; the host's stacked
plans, copied once an epoch, where a test forces the node axis's rule, and
the host's compact sims where it takes the device's free memory away) and
calls the step where the card replays its CUDA graph. Inputs come from the training
fixture both packages build from the same seeded numpy draws
(`build_training_fixture`), with the JAX weights carried over by
convert.params_from_jax and dropout off wherever the two packages are
compared (their generators differ).

Tolerances: stacked plans and compact sims exact (the same numpy work),
and so the step's device gather of them and a fit with the NP sims on the
device against one whose host gathers them (the same float32 values); the
device's gather plans equal to the host's element for element, and so a
fit whose steps build them against one whose host does;
fused fit vs JAX's fused fit, metrics rtol 1e-4 and parameters atol 1e-5
after 3 epochs (fp32 steps summed in another order by another library);
fused vs streaming in the port, atol 1e-5 (the JAX test's; the same
operations, only the plans' padding tiles differ); a resume bit-equal (the
same operations in the same order); debug_mode gradient norms rtol 1e-4.
"""
import json

import numpy as np
import pytest
import torch

import jax

import __graft_entry__ as ge
from subgnn_tpu.train import checkpoint as jckpt
from subgnn_tpu.train import plans as jplans
from subgnn_tpu.train import sims as jsims
from subgnn_tpu.train.loop import Trainer as JTrainer

from subgnn_tpu_torch.bench import build_training_fixture
from subgnn_tpu_torch.convert import params_from_jax
from subgnn_tpu_torch.ops import embedding as E
from subgnn_tpu_torch.train import loop as L
from subgnn_tpu_torch.train import plans as tplans
from subgnn_tpu_torch.train import sims as tsims
from subgnn_tpu_torch.train.checkpoint import to_numpy
from subgnn_tpu_torch.train.graphs import StepGraph
from subgnn_tpu_torch.train.loop import Trainer

EPOCHS = 3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _fixtures(**over):
    j = ge._build_training_fixture(hp_overrides=over)
    t = build_training_fixture(hp_overrides=over, device="cpu")
    return j, t


def _port_inputs(j):
    """The JAX fixture's weights as the port's CPU trees."""
    return params_from_jax(_np(j[2]), _np(j[3]), device="cpu")


def _resampled(anchors):
    """on_epoch_end: seeded new anchors of the same shapes and ranges."""
    def on_epoch_end(epoch):
        r = np.random.default_rng(100 + epoch)
        return {s: {k: r.integers(np.min(v), np.max(v) + 1, v.shape)
                    .astype(np.int32) for k, v in a.items()}
                for s, a in anchors.items()}
    return on_epoch_end


def _assert_trees(a, b, **tol):
    la = jax.tree_util.tree_leaves_with_path(_np(to_numpy(a)))
    lb = jax.tree_util.tree_leaves(_np(to_numpy(b)))
    assert len(la) == len(lb)
    for (path, x), y in zip(la, lb):
        if tol:
            np.testing.assert_allclose(x, y, **tol,
                                       err_msg=jax.tree_util.keystr(path))
        else:
            np.testing.assert_array_equal(x, y, jax.tree_util.keystr(path))


@pytest.mark.parametrize("neighborhood", [True, False])
def test_epoch_plans_match_jax(neighborhood):
    _, hp, _, _, data, anchors, _ = build_training_fixture(device="cpu")
    hp = hp.replace(use_neighborhood=neighborhood)
    n_rows = 136
    jb, tb = jplans.PlanBuilder(n_rows), tplans.PlanBuilder(n_rows)
    rng = np.random.default_rng(3)
    for epoch in range(3):              # sticky, growth-only tile counts
        order = rng.permutation(16).reshape(2, 8).astype(np.int32)
        cc = data["train"].cc_ids
        jp = jplans.epoch_plans(jb, hp, cc, anchors["train"], order)
        tp = tplans.epoch_plans(tb, hp, cc, anchors["train"], order)
        assert sorted(jp) == sorted(tp) == (
            ["cc_plan", "neigh_plan"] if neighborhood else ["cc_plan"])
        for k in jp:
            for name in ("pos", "local", "block"):
                got = getattr(tp[k], name)
                assert got.dtype == torch.int32 and got.device.type == "cpu"
                np.testing.assert_array_equal(
                    got.numpy(), np.asarray(getattr(jp[k], name)),
                    f"{k}.{name}")
            assert tp[k].n_rows == jp[k].n_rows == n_rows
        assert tb.tiles == jb.tiles
    assert tp["cc_plan"].pos.shape[0] == 2


def _plan_ids(case, rng):
    """(ids, n_rows) of one case of the device plan test."""
    if case == "ppi_bp_neigh":
        # the neighbourhood plan's ids at ppi_bp's shape, ~87% PAD
        n_rows = 17080
        ids = rng.integers(1, n_rows, (2, 64, 59, 45))
        ids[rng.random(ids.shape) < 0.873] = 0
    elif case == "hub_in_a_middle_block":
        n_rows = 1000
        ids = rng.integers(0, n_rows, (8, 300))
        ids[rng.random(ids.shape) < 0.6] = 517
    elif case == "blocks_of_0_511_512_513_1024":
        n_rows = 5 * E.TABLE_BLOCK
        ids = np.concatenate([
            b * E.TABLE_BLOCK + rng.integers(0, E.TABLE_BLOCK, c)
            for b, c in ((1, 511), (2, 512), (3, 513), (4, 1024))])
        ids = rng.permutation(ids)
    elif case == "one_block":
        n_rows = 1000
        ids = 3 * E.TABLE_BLOCK + rng.integers(0, E.TABLE_BLOCK, (4, 777))
    elif case == "at_the_bound":
        # 1 mod 512 ids in every block: the bound is reached exactly
        n_rows = 4 * E.TABLE_BLOCK
        ids = rng.permutation(np.concatenate([
            b * E.TABLE_BLOCK + rng.integers(0, E.TABLE_BLOCK, c)
            for b, c in enumerate((1, 513, 1025, 1))]))
    else:                                     # "rows_not_a_multiple_of_128"
        n_rows = 300
        ids = rng.integers(0, n_rows, (64, 3, 7))
    return ids, n_rows


@pytest.mark.parametrize("case", [
    "ppi_bp_neigh", "hub_in_a_middle_block", "blocks_of_0_511_512_513_1024",
    "one_block", "at_the_bound", "rows_not_a_multiple_of_128"])
def test_device_gather_plan_equals_the_host_plan(case):
    """The plan a fused step builds (tplans.device_gather_plan) equals
    make_gather_plan's at plan_tiles_bound tiles element for element, and
    the table gradient over the two is bit-equal; no case needs more tiles
    than the bound, and the bound is reached where every block holds 1 mod
    512 ids."""
    rng = np.random.default_rng(sum(map(ord, case)))
    ids, n_rows = _plan_ids(case, rng)
    bound = tplans.plan_tiles_bound(ids.size, n_rows)
    need = E.tiles_needed(ids, n_rows)
    assert need <= bound
    if case == "at_the_bound":
        assert need == bound == 7
    host = E.make_gather_plan(ids, n_rows, n_tiles=bound)
    dev = tplans.device_gather_plan(torch.as_tensor(ids), n_rows)
    assert dev.n_rows == host.n_rows == n_rows
    for name in ("pos", "local", "block"):
        got, want = getattr(dev, name), getattr(host, name)
        assert got.dtype == torch.int32 and got.is_contiguous(), name
        assert torch.equal(got, want), name
    g = torch.as_tensor(rng.normal(size=(ids.size, 4)), dtype=torch.float32)
    assert torch.equal(E.segment_matmul_torch(g, dev),
                       E.segment_matmul_torch(g, host))


def test_epoch_compact_sims_match_jax():
    _, hp, _, _, data, anchors, _ = build_training_fixture(
        hp_overrides=dict(n_layers=2), device="cpu")
    order = np.random.default_rng(5).permutation(16).reshape(2, 8)
    got = tsims.epoch_compact_sims(data["train"].NP_sim, anchors["train"],
                                   hp, order)
    want = jsims.epoch_compact_sims(data["train"].NP_sim, anchors["train"],
                                    hp, order)
    assert sorted(got) == sorted(want) == ["neigh_sims", "pos_in_sims",
                                           "pos_out_sims"]
    for k, v in want.items():
        assert got[k].dtype == np.float32
        assert got[k].shape[:3] == (2, 2, 8)     # (n_batches, L, B, ...)
        np.testing.assert_array_equal(got[k], np.asarray(v), k)
    assert tsims.epoch_compact_sims(data["train"].NP_sim, anchors["train"],
                                    hp, order[:0]) == {}


@pytest.mark.parametrize("split", ["train", "val"])
def test_device_compact_sims_equal_the_host_gathers(split):
    """The fused step's gather from the resident NP sims equals the host's
    numpy gather bit for bit, for several index rows, with PAD ids (0)
    planted in every anchor array and one id past the last node: the
    neighbourhood and internal position ids clip to [0, n_nodes - 1], a
    border position PAD reads the last column."""
    _, hp, _, _, data, anchors, _ = build_training_fixture(
        hp_overrides=dict(n_layers=2), device="cpu")
    np_sim = data[split].NP_sim
    n, n_nodes = np_sim.shape[0], np_sim.shape[2]
    padded = {k: np.array(v) for k, v in anchors[split].items()}
    padded["neigh_int"][0, 1, 0, :2] = 0
    padded["neigh_int"][1, 2, 1, 0] = n_nodes + 3
    padded["neigh_bor"][1, 1, 1, -1] = 0
    padded["pos_int"][:, 1, 0] = 0
    padded["pos_ext"][0, 0] = padded["pos_ext"][1, -1] = 0
    rows = np.random.default_rng(7).permutation(n)
    resident = torch.as_tensor(np_sim)
    for a in (anchors[split], padded):
        dev_anchors = L.device_batch(a, "cpu")
        for idx in (rows[:8], rows[-8:], np.array([1, 1, 2, 0, 1, 2, 2, 1])):
            want = tsims.compact_sims_for_batch(np_sim, a, hp, idx)
            got = tsims.device_compact_sims(resident, dev_anchors, hp,
                                            torch.as_tensor(idx).long())
            assert sorted(got) == sorted(want) == [
                "neigh_sims", "pos_in_sims", "pos_out_sims"]
            for k, v in want.items():
                assert got[k].dtype == torch.float32, k
                assert tuple(got[k].shape) == v.shape, k
                np.testing.assert_array_equal(got[k].numpy(), v, k)
    # the PAD slots read the columns the numpy indices name
    idx = np.array([1, 0, 2, 1])
    got = tsims.device_compact_sims(resident, L.device_batch(padded, "cpu"),
                                    hp, torch.as_tensor(idx))
    np.testing.assert_array_equal(got["pos_in_sims"][:, 0, :, 0].numpy(),
                                  np.stack([np_sim[1, :, 0]] * 2))
    np.testing.assert_array_equal(got["pos_out_sims"][0, :, :, 0].numpy(),
                                  np_sim[idx, :, n_nodes - 1])
    np.testing.assert_array_equal(got["neigh_sims"][1, 2, 1, 0].numpy(),
                                  np_sim[2, 1, n_nodes - 1])


@pytest.mark.parametrize("case", ["fixed", "resample"])
def test_resident_sims_fit_equals_host_sims_fit(case, monkeypatch):
    """A fused fit whose steps gather their compact sims from the NP sims
    on the device equals one whose host gathers them (forced by a device
    that reports no free memory) bit for bit: per-epoch metrics,
    parameters, state and Adam's moments; `device_sims` counts every
    replay of the first and none of the second."""
    over = dict(max_epochs=EPOCHS, lin_dropout=0.2, batch_norm=True,
                resample_anchor_patches=case == "resample")
    model, hp, params, state, data, anchors, _ = build_training_fixture(
        hp_overrides=over, device="cpu")
    hook = _resampled(anchors) if case == "resample" else None
    runs = {}
    for path in ("device", "host"):
        with monkeypatch.context() as m:
            if path == "host":
                m.setattr(L, "_free_device_bytes", lambda device: 0)
            tr = runs[path] = Trainer(model, hp, device="cpu")
            tr.fit(params, state, data["train"], data["val"], anchors,
                   seed=0, on_epoch_end=hook, log_fn=None)
    d, h = runs["device"], runs["host"]
    assert d.fused and h.fused and d.compact_sims is h.compact_sims is True
    assert d.sims_on_device is True and h.sims_on_device is False
    assert d.fused_captures == h.fused_captures == 2
    assert d.held["NP_sim"][0] == data["train"].NP_sim.shape
    assert d.held["NP_sim_val"][0] == data["val"].NP_sim.shape
    assert "NP_sim" not in h.held
    for epoch in range(EPOCHS):
        replays = d.spans.counters[epoch]["replays"]
        assert replays == h.spans.counters[epoch]["replays"] == 3
        assert d.spans.counters[epoch]["device_sims"] == replays
        assert h.spans.counters[epoch]["device_sims"] == 0
        if epoch < EPOCHS - 1 or case == "resample":
            names = {r[0] for r in h.spans.rows(epoch)}
            assert "fit.schedule.sims" in names
        assert "fit.schedule.sims" not in {r[0] for r in d.spans.rows(epoch)}
    for md, mh in zip(d.metric_scores, h.metric_scores):
        for k, v in mh.items():
            if k != "epoch_time_s" and k != "train_edges_per_s":
                assert md[k] == v, k
    _assert_trees(d.params, h.params)
    _assert_trees(d.state, h.state)
    for k in ("mu", "nu"):
        _assert_trees(d.opt_state[k], h.opt_state[k])
    assert int(d.opt_state["count"]) == int(h.opt_state["count"])


@pytest.mark.parametrize("case", ["fixed", "resample"])
@pytest.mark.parametrize("channels", ["nsp", "s_only"])
def test_device_plans_fit_equals_host_plans_fit(case, channels, monkeypatch):
    """A fused fit whose train steps build their gather plans on the device
    equals one whose host builds them (forced through plans_fit_on_device)
    bit for bit: per-epoch metrics, parameters, state and Adam's moments.
    `device_plans` counts every train replay of the first and none of the
    second; `fit.schedule.plans` times the host's plans alone; the device
    path captures one train step and one eval step."""
    over = dict(max_epochs=EPOCHS, lin_dropout=0.2, batch_norm=True,
                resample_anchor_patches=case == "resample")
    if channels == "s_only":
        over.update(use_neighborhood=False, use_position=False)
    model, hp, params, state, data, anchors, _ = build_training_fixture(
        hp_overrides=over, device="cpu")
    hook = _resampled(anchors) if case == "resample" else None
    runs = {}
    for path in ("device", "host"):
        with monkeypatch.context() as m:
            if path == "host":
                m.setattr(L, "plans_fit_on_device", lambda row_range: False)
            tr = runs[path] = Trainer(model, hp, device="cpu")
            tr.fit(params, state, data["train"], data["val"], anchors,
                   seed=0, on_epoch_end=hook, log_fn=None)
    d, h = runs["device"], runs["host"]
    assert d.fused and h.fused
    assert d.plans_on_device is True and h.plans_on_device is False
    assert d.fused_captures == 2
    n_train = len(data["train"]) // hp.batch_size
    for epoch in range(EPOCHS):
        assert d.spans.counters[epoch]["device_plans"] == n_train
        assert h.spans.counters[epoch]["device_plans"] == 0
        if epoch < EPOCHS - 1 or case == "resample":
            names = {r[0] for r in h.spans.rows(epoch)}
            assert "fit.schedule.plans" in names
        names = {r[0] for r in d.spans.rows(epoch)}
        assert "fit.schedule.plans" not in names
    for md, mh in zip(d.metric_scores, h.metric_scores):
        for k, v in mh.items():
            if k != "epoch_time_s" and k != "train_edges_per_s":
                assert md[k] == v, k
    _assert_trees(d.params, h.params)
    _assert_trees(d.state, h.state)
    for k in ("mu", "nu"):
        _assert_trees(d.opt_state[k], h.opt_state[k])
    assert int(d.opt_state["count"]) == int(h.opt_state["count"])


class _Mesh:
    def __init__(self, n_node):
        self.sharded = n_node > 1


@pytest.mark.parametrize("case", [
    "cpu", "fits_in_half", "over_half", "node_axis", "data_axis"])
def test_sims_on_device_by_what_the_fit_observes(case, monkeypatch):
    """The NP sims stay on the device off a node axis and within half the
    free memory the device reports; the CPU always keeps them."""
    cuda = torch.device("cuda")
    free = 1000
    monkeypatch.setattr(L, "_free_device_bytes",
                        lambda device: None if device.type == "cpu" else free)
    want, args = {
        "cpu": (True, (1 << 40, torch.device("cpu"), None)),
        "fits_in_half": (True, (500, cuda, None)),
        "over_half": (False, (501, cuda, None)),
        "node_axis": (False, (1, cuda, _Mesh(n_node=2))),
        "data_axis": (True, (500, cuda, _Mesh(n_node=1))),
    }[case]
    assert L.sims_fit_on_device(*args) is want
    if case == "node_axis":
        assert L.sims_fit_on_device(1, torch.device("cpu"),
                                    _Mesh(n_node=2)) is False


@pytest.mark.parametrize("over", [dict(), dict(trainable_cc=True,
                                               batch_norm=True)],
                         ids=["plain", "trainable_cc_batch_norm"])
def test_fused_fit_matches_jax_fused_fit(over, tmp_path):
    over = dict(over, max_epochs=EPOCHS)
    (jmodel, jhp, jparams, jstate, jdata, janchors, jeval), t = _fixtures(
        **over)
    tmodel, thp, _, _, tdata, tanchors, teval = t
    jtr = JTrainer(jmodel, jhp, eval_cc_tables=jeval)
    jtr.fit(jparams, jstate, jdata["train"], jdata["val"], janchors, seed=0,
            log_fn=None)
    assert hasattr(jtr, "_fused_train_epoch")
    p_t, s_t = _port_inputs((jmodel, jhp, jparams, jstate))
    ttr = Trainer(tmodel, thp, eval_cc_tables=teval, device="cpu",
                  ckpt_dir=str(tmp_path))
    ttr.fit(p_t, s_t, tdata["train"], tdata["val"], tanchors, seed=0,
            log_fn=None)
    assert ttr.fused and ttr.compact_sims is jtr.compact_sims is True
    assert ttr.fused_captures == 2                   # train + eval
    assert ttr.global_step == jtr.global_step == EPOCHS * 2
    assert len(ttr.metric_scores) == len(jtr.metric_scores) == EPOCHS
    for mt, mj in zip(ttr.metric_scores, jtr.metric_scores):
        for k in ("train_loss", "val_loss", "val_micro_f1", "val_acc",
                  "avg_val_acc", "avg_macro_f1", "val_auroc"):
            np.testing.assert_allclose(mt[k], mj[k], rtol=1e-4, err_msg=k)
    _assert_trees(jtr.params, ttr.params, atol=1e-5, rtol=0)
    _assert_trees(jtr.state, ttr.state, atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", ["fixed", "resample", "resident_np_sim"])
def test_fused_fit_matches_streaming_fit(case, monkeypatch):
    over = dict(max_epochs=EPOCHS, lin_dropout=0.2, batch_norm=True,
                resample_anchor_patches=case == "resample")
    model, hp, params, state, data, anchors, _ = build_training_fixture(
        hp_overrides=over, device="cpu")
    hook = _resampled(anchors) if case == "resample" else None
    runs = {}
    for mode in ("fused", "streaming"):
        tr = Trainer(model, hp, device="cpu")
        if case == "resident_np_sim":
            tr.compact_sims = False
        with monkeypatch.context() as m:
            if mode == "streaming":
                m.setattr(Trainer, "_split_bytes",
                          staticmethod(lambda d: 1 << 40))
            tr.fit(params, state, data["train"], data["val"], anchors,
                   seed=0, on_epoch_end=hook, log_fn=None)
        assert tr.fused is (mode == "fused")
        assert tr.fused_captures == (2 if mode == "fused" else 0)
        runs[mode] = tr
    f, s = runs["fused"], runs["streaming"]
    for k in ("train_loss", "val_loss", "val_micro_f1", "avg_macro_f1"):
        np.testing.assert_allclose([m[k] for m in f.metric_scores],
                                   [m[k] for m in s.metric_scores],
                                   atol=1e-5, rtol=0, err_msg=k)
    _assert_trees(f.params, s.params, atol=1e-5, rtol=0)
    _assert_trees(f.state, s.state, atol=1e-5, rtol=0)
    assert int(f.opt_state["count"]) == int(s.opt_state["count"]) == 6


def test_fused_fit_recaptures_when_the_plans_grow(monkeypatch):
    """Where the host builds the plans (the node axis's rule, forced), a
    growth of their tile count between epochs makes a new train step (a
    new capture on the card); the eval step stays. The padding tiles add
    nothing, so the run equals one without growth."""
    monkeypatch.setattr(L, "plans_fit_on_device", lambda row_range: False)
    model, hp, params, state, data, anchors, _ = build_training_fixture(
        hp_overrides=dict(max_epochs=EPOCHS), device="cpu")
    plain = Trainer(model, hp, device="cpu")
    plain.fit(params, state, data["train"], data["val"], anchors, seed=0,
              log_fn=None)
    epoch_plans = L.epoch_plans

    def growing(builder, *args):
        for name in builder.tiles:
            builder.tiles[name] += 3
        return epoch_plans(builder, *args)

    monkeypatch.setattr(L, "epoch_plans", growing)
    grown = Trainer(model, hp, device="cpu")
    grown.fit(params, state, data["train"], data["val"], anchors, seed=0,
              log_fn=None)
    assert plain.plans_on_device is grown.plans_on_device is False
    assert plain.fused_captures == 2
    assert grown.fused_captures == EPOCHS + 1
    _assert_trees(plain.params, grown.params, atol=1e-6, rtol=0)


@pytest.mark.parametrize("case", ["default", "short_batches", "debug_mode",
                                  "resident_over_1GiB", "compact_off"])
def test_mode_selection_matches_jax(case, monkeypatch):
    over = dict(max_epochs=0)
    if case == "short_batches":
        over["batch_size"] = 32                      # > 16 train subgraphs
    if case == "debug_mode":
        over["debug_mode"] = True
    (jmodel, jhp, jparams, jstate, jdata, janchors, _), t = _fixtures(**over)
    tmodel, thp, params, state, tdata, tanchors, _ = t
    if case == "resident_over_1GiB":
        for cls in (JTrainer, Trainer):
            monkeypatch.setattr(cls, "_split_bytes",
                                staticmethod(lambda d: 1 << 30))
    jtr = JTrainer(jmodel, jhp)
    ttr = Trainer(tmodel, thp, device="cpu")
    if case == "compact_off":
        jtr.compact_sims = ttr.compact_sims = False
    try:
        jtr.fit(jparams, jstate, jdata["train"], jdata["val"], janchors,
                seed=0, log_fn=None)
    finally:
        jax.config.update("jax_debug_nans", False)
    ttr.fit(params, state, tdata["train"], tdata["val"], tanchors, seed=0,
            log_fn=None)
    assert ttr.fused == hasattr(jtr, "_fused_train_epoch")
    assert ttr.fused == (case in ("default", "compact_off"))
    assert ttr.compact_sims == jtr.compact_sims
    assert ttr.sims_on_device is (case == "default")
    assert ttr.plans_on_device is ttr.fused
    assert L.plans_fit_on_device(None) is True
    assert L.plans_fit_on_device((0, 64)) is False


def test_fused_resume_continues_the_uninterrupted_run(tmp_path):
    over = dict(max_epochs=EPOCHS, lin_dropout=0.2,
                resample_anchor_patches=True)
    model, hp, params, state, data, anchors, _ = build_training_fixture(
        hp_overrides=over, device="cpu")
    hook = _resampled(anchors)
    a = Trainer(model, hp, device="cpu", ckpt_dir=str(tmp_path / "a"),
                checkpoint_k=EPOCHS)
    a.fit(params, state, data["train"], data["val"], anchors, seed=3,
          on_epoch_end=hook, log_fn=None)
    first = next((tmp_path / "a").glob("epoch=0-*.ckpt"))
    b = Trainer(model, hp, device="cpu")
    start = b.resume_from(first)
    assert start == 1
    b.fit(params, state, data["train"], data["val"], anchors, seed=3,
          on_epoch_end=hook, log_fn=None, start_epoch=start)
    assert a.fused and b.fused
    for ma, mb in zip(a.metric_scores[1:], b.metric_scores):
        assert mb["epoch"] == ma["epoch"]
        for k in ("train_loss", "val_loss", "val_micro_f1"):
            assert mb[k] == ma[k], k
    _assert_trees(a.params, b.params)
    assert b.global_step == a.global_step == EPOCHS * 2


def test_fused_checkpoint_reads_into_the_jax_tree(tmp_path):
    (jmodel, jhp, jparams, jstate, *_), t = _fixtures(max_epochs=2)
    tmodel, thp, _, _, tdata, tanchors, _ = t
    p_t, s_t = _port_inputs((jmodel, jhp, jparams, jstate))
    tr = Trainer(tmodel, thp, device="cpu", ckpt_dir=str(tmp_path))
    tr.fit(p_t, s_t, tdata["train"], tdata["val"], tanchors, seed=0,
           log_fn=None)
    assert tr.fused
    path = sorted(tmp_path.glob("epoch=1-*.ckpt"))[0]
    payload = jckpt.load_checkpoint(path)
    assert payload["meta"]["global_step"] == 4
    count = np.asarray(payload["opt_state"]["count"])   # as PR 8 wrote it
    assert count.shape == () and count.dtype.kind == "i" and count == 4
    restored = jckpt.load_params_filtered(path, jparams, payload=payload)
    _assert_trees(restored, tr.params)


def test_adam_keeps_its_count_on_the_device():
    _, hp, params, *_ = build_training_fixture(device="cpu")
    tx = L.make_optimizer(hp)
    opt = tx.init(params)
    assert torch.is_tensor(opt["count"]) and opt["count"].dtype == torch.int64
    grads = [torch.ones_like(x) for x in tx.trainable(params)]
    graph = StepGraph(lambda: tx.step(params, [g.clone() for g in grads],
                                      opt), "cpu")
    for _ in range(3):
        graph()
    assert graph.calls == 3 and graph.captures == 1
    saved = tx.host_state(opt)
    assert type(saved["count"]) is int and saved["count"] == 3
    again = tx.init(params, saved)
    assert int(again["count"]) == 3 and again["count"].dtype == torch.int64


def test_debug_mode_grad_norms_match_jax():
    (jmodel, jhp, jparams, jstate, jdata, janchors, _), t = _fixtures(
        max_epochs=2, debug_mode=True)
    tmodel, thp, _, _, tdata, tanchors, _ = t
    jtr = JTrainer(jmodel, jhp)
    try:
        jtr.fit(jparams, jstate, jdata["train"], jdata["val"], janchors,
                seed=0, log_fn=None)
    finally:
        jax.config.update("jax_debug_nans", False)
    p_t, s_t = _port_inputs((jmodel, jhp, jparams, jstate))
    ttr = Trainer(tmodel, thp, device="cpu")
    ttr.fit(p_t, s_t, tdata["train"], tdata["val"], tanchors, seed=0,
            log_fn=None)
    assert not ttr.fused and ttr.fused_captures == 0
    assert len(ttr._grad_norms) == 4
    for mt, mj in zip(ttr.metric_scores, jtr.metric_scores):
        assert mt["grad_norm"] > 0
        np.testing.assert_allclose(mt["grad_norm"], mj["grad_norm"],
                                   rtol=1e-4)
        np.testing.assert_allclose(mt["train_loss"], mj["train_loss"],
                                   rtol=1e-4)


def test_debug_mode_raises_on_a_planted_nan():
    model, hp, params, state, data, anchors, _ = build_training_fixture(
        hp_overrides=dict(debug_mode=True), device="cpu")
    params["head"]["lin3"]["b"][1] = float("nan")
    tr = Trainer(model, hp, device="cpu")
    with pytest.raises(FloatingPointError, match="non-finite"):
        tr.fit(params, state, data["train"], data["val"], anchors, seed=0,
               log_fn=None)
    assert tr.global_step == 0          # raised before the first update


def test_fit_with_profile_dir_writes_a_trace(tmp_path):
    model, hp, params, state, data, anchors, _ = build_training_fixture(
        hp_overrides=dict(max_epochs=1), device="cpu")
    tr = Trainer(model, hp, device="cpu")
    tr.fit(params, state, data["train"], data["val"], anchors, seed=0,
           log_fn=None, profile_dir=str(tmp_path / "trace"))
    traces = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)


def test_fused_fit_refuses_resampled_anchors_of_another_shape():
    model, hp, params, state, data, anchors, _ = build_training_fixture(
        hp_overrides=dict(max_epochs=2), device="cpu")

    def on_epoch_end(epoch):
        return {s: dict(a, pos_ext=a["pos_ext"][:, :2])
                for s, a in anchors.items()}

    tr = Trainer(model, hp, device="cpu")
    with pytest.raises(ValueError, match="changed shape"):
        tr.fit(params, state, data["train"], data["val"], anchors, seed=0,
               on_epoch_end=on_epoch_end, log_fn=None)
    assert tr.fused and len(tr.metric_scores) == 1
