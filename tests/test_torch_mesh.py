"""The data axis of the training mesh (subgnn_tpu_torch/parallel/mesh.py) on
the CPU (its node axis: tests/test_torch_node_axis.py): ranks are processes
spawned with torch.multiprocessing, joined in a gloo process group through
a file:// store under tmp_path (no TCP port, so test workers never
collide). Each spawned run does all of its jobs in one pair of processes,
and the tests read its results (a module-scoped fixture); the one-process
references run in the test process.

Counterparts of the JAX package's mesh tests (tests/test_parallel.py):
streaming on 2 and 4 ranks, one of them with no valid row (:145), fused on
2 ranks with trainable CC tables, batch norm and dropout (:114), a mesh
resume (:406); plus the port's 2-rank fused fit against the JAX Trainer's
mesh_data_axis=2 fit on the 8 host devices of tests/conftest.py, run() on 2
ranks through cli.train, and the mesh knobs refused where they cannot be
honoured (through mesh_from_hparams, Trainer, run() and cli.train).

Tolerances: a mesh fit against the one-process port fit, rtol 1e-4 on the
metrics and atol 1e-5 on the parameters (the same sums split over ranks and
added in another order); against JAX, rtol 2e-4 (the JAX mesh tests' own);
a mesh resume against the uninterrupted mesh run, atol 1e-6 (the JAX
test's). Ranks end with the same parameters bit for bit (every rank applies
the same all-reduced gradients).

No JAX at module level: the spawned ranks import this module.
"""
import json
import os
import pickle
import shutil
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from subgnn_tpu_torch.bench import build_training_fixture
from subgnn_tpu_torch.cli import train as t_train_cli
from subgnn_tpu_torch.config import HParams, RunConfig, load_commented_json
from subgnn_tpu_torch.parallel import mesh as MX
from subgnn_tpu_torch.train import runner as t_runner
from subgnn_tpu_torch.train.checkpoint import to_numpy
from subgnn_tpu_torch.train.loop import Trainer

FIXTURE = Path(__file__).parent / "fixtures" / "mini_multilabel"
SPAWN_TIMEOUT_S = 300
EPOCHS = 3
# the fits of the streaming and fused checks: every mesh-sensitive piece on
MESH_HP = dict(trainable_cc=True, batch_norm=True, lin_dropout=0.2,
               max_epochs=EPOCHS)
JAX_HP = dict(trainable_cc=True, batch_norm=True, max_epochs=EPOCHS)
METRIC_KEYS = ("train_loss", "val_loss", "val_micro_f1", "val_acc",
               "avg_val_acc", "avg_macro_f1", "val_auroc")
ARTIFACTS = ("hyperparams.json", "trainer_kwargs.json",
             "final_metric_scores.json", "test_results.json")


class _Streaming(Trainer):
    """Mode selection sees splits over its 1 GiB bound (as the JAX tests
    force streaming)."""
    _split_bytes = staticmethod(lambda data: 1 << 40)


# ------------------------------------------------------------- the fits

def _fit(over, n_train=16, n_val=8, streaming=False, mesh=None,
         weights=None, ckpt_dir=None, checkpoint_k=3, resume=None,
         start_epoch=0, compact=None):
    """A Trainer.fit on build_training_fixture (CPU): its metrics, params
    (the whole table on a node axis), state, mode, what it held and its
    collective counts. `compact`: force the compact sims on or off."""
    model, hp, params, state, data, anchors, eval_cc = build_training_fixture(
        n_train=n_train, n_val=n_val, hp_overrides=over, device="cpu")
    if weights is not None:
        params, state = weights
    cls = _Streaming if streaming else Trainer
    tr = cls(model, hp, eval_cc_tables=eval_cc, device="cpu", mesh=mesh,
             ckpt_dir=ckpt_dir, checkpoint_k=checkpoint_k)
    tr.compact_sims = compact
    if resume is not None:
        assert tr.resume_from(resume) == start_epoch
    MX.reset_counts()
    tr.fit(params, state, data["train"], data["val"], anchors, seed=0,
           log_fn=None, start_epoch=start_epoch)
    counts = {"grad_reduces": MX.all_reduce_sum_.calls,
              "bn_reduces": MX.all_reduce_bn_stats.calls,
              "gathers": MX.all_gather_rows.calls,
              "node_sums": MX.node_sum.calls,
              "node_sum_bytes": MX.node_sum.bytes}
    whole, _ = tr.whole_params()
    return {"metrics": [{k: m[k] for k in METRIC_KEYS + ("epoch",)}
                        for m in tr.metric_scores],
            "params": to_numpy(whole), "state": to_numpy(tr.state),
            "fused": tr.fused, "plans_on_device": tr.plans_on_device,
            "steps": tr.global_step, "held": tr.held,
            "grad_norms": tr._grad_norms, **counts}


def _job_api(rank, tmp, mesh):
    """The mesh object and the checks make_device_mesh keeps."""
    out = {"shape": mesh.shape, "axis_names": mesh.axis_names,
           "rank": mesh.rank, "rows": (mesh.rows(8).start, mesh.rows(8).stop),
           "device": str(mesh.device), "backend": mesh.backend}
    for n in (4, 1):
        with pytest.raises(ValueError):
            MX.make_device_mesh(n, device="cpu")
    with pytest.raises(ValueError, match="needs 4 ranks"):
        MX.make_device_mesh(2, 2, device="cpu")
    return out


def _job_stream(rank, tmp, mesh):
    return _fit(MESH_HP, n_train=20, streaming=True, mesh=mesh)


def _job_stream_empty_rank(rank, tmp, mesh):
    # 10 train subgraphs, B=16: one batch, rank 3's rows 12-15 all invalid
    return _fit(dict(MESH_HP, batch_size=16), n_train=10, mesh=mesh)


def _job_fused(rank, tmp, mesh):
    return _fit(MESH_HP, mesh=mesh)


def _job_jax(rank, tmp, mesh):
    with open(Path(tmp) / "jax_weights.pkl", "rb") as f:
        params, state = pickle.load(f)
    from subgnn_tpu_torch.convert import params_from_jax
    return _fit(JAX_HP, mesh=mesh,
                weights=params_from_jax(params, state, device="cpu"))


def _job_resume(rank, tmp, mesh):
    ckpts = Path(tmp) / "resume_ckpt"
    full = _fit(dict(MESH_HP, max_epochs=4), mesh=mesh)
    _fit(dict(MESH_HP, max_epochs=2), mesh=mesh, ckpt_dir=str(ckpts),
         checkpoint_k=10)
    dist.barrier()              # rank 0 wrote the checkpoints
    mid, = ckpts.glob("epoch=1-*.ckpt")
    resumed = _fit(dict(MESH_HP, max_epochs=4), mesh=mesh, resume=mid,
                   start_epoch=2)
    return {"full": full, "resumed": resumed,
            "files": sorted(p.name for p in ckpts.iterdir())}


def _job_run(rank, tmp, mesh):
    """cli.train on the mini fixture with mesh_data_axis=2 (the hparams'),
    as under torchrun: the launch variables set and the group already
    joined, so the CLI takes it (and leaves it) as it is."""
    counts = {"dump_json": [], "dtw_sims": 0}
    dump, sims = t_runner.dump_json, t_runner.compute_structure_similarities

    def counted_dump(path, obj):
        counts["dump_json"].append(Path(path).name)
        dump(path, obj)

    def counted_sims(*a, **k):
        counts["dtw_sims"] += 1
        return sims(*a, **k)

    os.environ.update(WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank))
    t_runner.dump_json, t_runner.compute_structure_similarities = \
        counted_dump, counted_sims
    MX.reset_counts()
    try:
        root = Path(tmp) / "run_root"
        t_train_cli.main(["-task", "mini", "-project_root", str(root),
                          "-hyperparams", str(Path(tmp) / "run_hyp.json"),
                          "-tb_name", "mesh", "-device", "cpu"])
    finally:
        t_runner.dump_json, t_runner.compute_structure_similarities = \
            dump, sims
    counts["group_kept"] = dist.is_initialized()
    counts["precompute_gathers"] = MX.all_gather_world.calls
    return counts


JOBS = {"api": _job_api, "stream": _job_stream,
        "stream_empty_rank": _job_stream_empty_rank, "fused": _job_fused,
        "jax": _job_jax, "resume": _job_resume, "run": _job_run}


def _rank_main(rank, world, tmp, jobs, n_node):
    """One spawned rank: join the gloo group, make the (world / n_node,
    n_node) mesh, run the jobs ({name: function of (rank, tmp, mesh)}),
    pickle each job's result to <tmp>/<name>.<rank>.pkl."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            world_size=world, rank=rank)
    try:
        mesh = MX.make_device_mesh(world // n_node, n_node, device="cpu")
        for name, job in jobs.items():
            out = job(rank, tmp, mesh)
            with open(Path(tmp) / f"{name}.{rank}.pkl", "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _spawn(world, tmp, jobs, n_node=1):
    """Run `jobs` (names of JOBS, or {name: module-level function}) on
    `world` spawned ranks of a (world / n_node, n_node) mesh; {job: [result
    of each rank]}."""
    if not isinstance(jobs, dict):
        jobs = {name: JOBS[name] for name in jobs}
    ctx = mp.start_processes(_rank_main,
                             args=(world, str(tmp), jobs, n_node),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"spawned ranks did not finish {jobs} in "
                        f"{SPAWN_TIMEOUT_S} s")
    out = {}
    for job in jobs:
        out[job] = []
        for r in range(world):
            with open(Path(tmp) / f"{job}.{r}.pkl", "rb") as f:
                out[job].append(pickle.load(f))
    return out


def _mini_hyp(path, **over):
    hyp = dict(load_commented_json(FIXTURE / "mini_config.json")
               ["hyperparams_fix"], max_epochs=2, **over)
    path.write_text(json.dumps(hyp))
    return path


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Both spawned runs: 2 ranks (every job but one) and 4 ranks (the
    rank with no valid row). The JAX fixture's weights go to the 2-rank
    run through a file."""
    import __graft_entry__ as ge
    import jax
    tmp2 = tmp_path_factory.mktemp("world2")
    tmp4 = tmp_path_factory.mktemp("world4")
    j = ge._build_training_fixture(hp_overrides=dict(JAX_HP,
                                                     mesh_data_axis=2))
    weights = jax.tree_util.tree_map(np.asarray, (j[2], j[3]))
    with open(tmp2 / "jax_weights.pkl", "wb") as f:
        pickle.dump(weights, f)
    shutil.copytree(FIXTURE / "mini", tmp2 / "run_root" / "mini")
    _mini_hyp(tmp2 / "run_hyp.json", mesh_data_axis=2)
    out = _spawn(2, tmp2, ["api", "stream", "fused", "jax", "resume", "run"])
    out.update(_spawn(4, tmp4, ["stream_empty_rank"]))
    out["tmp2"] = tmp2
    return out


# ------------------------------------------------------------ assertions

def _assert_trees(a, b, **tol):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_trees(a[k], b[k], **tol)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_trees(x, y, **tol)
    elif tol:
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _assert_metrics(got, want, rtol):
    assert [m["epoch"] for m in got] == [m["epoch"] for m in want]
    for g, w in zip(got, want):
        for k in METRIC_KEYS:
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=1e-6,
                                       err_msg=k)


def _assert_ranks_agree(results):
    for r in results[1:]:
        _assert_trees(results[0]["params"], r["params"])
        _assert_trees(results[0]["state"], r["state"])
        assert r["metrics"] == results[0]["metrics"]


@pytest.mark.parametrize("job,over,n_train,streaming", [
    ("stream", MESH_HP, 20, True),
    ("stream_empty_rank", dict(MESH_HP, batch_size=16), 10, False),
    ("fused", MESH_HP, 16, False),
], ids=["streaming_2_ranks", "streaming_4_ranks_one_empty", "fused_2_ranks"])
def test_mesh_fit_matches_one_process(spawned, job, over, n_train,
                                      streaming):
    ranks = spawned[job]
    one = _fit(over, n_train=n_train, streaming=streaming)
    assert ranks[0]["fused"] is one["fused"] is (job == "fused")
    # a data axis's fused steps build their own plans, as one process's
    assert ranks[0]["plans_on_device"] is one["plans_on_device"] is (
        job == "fused")
    assert ranks[0]["steps"] == one["steps"]
    _assert_ranks_agree(ranks)
    _assert_metrics(ranks[0]["metrics"], one["metrics"], rtol=1e-4)
    _assert_trees(ranks[0]["params"], one["params"], atol=1e-5, rtol=0)
    _assert_trees(ranks[0]["state"], one["state"], atol=1e-5, rtol=0)
    # one gradient all-reduce a step (plus the train losses' once an
    # epoch), batch norm's two a layer and side each step, logits gathered
    # a val batch
    assert ranks[0]["grad_reduces"] == one["steps"] + EPOCHS
    assert ranks[0]["bn_reduces"] == one["steps"] * 2 * 2
    assert ranks[0]["gathers"] > 0
    assert one["grad_reduces"] == one["bn_reduces"] == one["gathers"] == 0


def test_mesh_fused_fit_matches_jax_mesh_fit(spawned):
    import __graft_entry__ as ge
    import jax
    from subgnn_tpu.train.loop import Trainer as JTrainer
    jmodel, jhp, jparams, jstate, jdata, janchors, jeval = \
        ge._build_training_fixture(hp_overrides=dict(JAX_HP,
                                                     mesh_data_axis=2))
    jtr = JTrainer(jmodel, jhp, eval_cc_tables=jeval)
    assert jtr.mesh is not None and jtr.mesh.shape["data"] == 2
    jtr.fit(jparams, jstate, jdata["train"], jdata["val"], janchors,
            seed=0, log_fn=None)
    ranks = spawned["jax"]
    assert ranks[0]["fused"] and hasattr(jtr, "_fused_train_epoch")
    _assert_ranks_agree(ranks)
    for got, want in zip(ranks[0]["metrics"], jtr.metric_scores):
        for k in METRIC_KEYS:
            np.testing.assert_allclose(got[k], want[k], rtol=2e-4,
                                       atol=1e-5, err_msg=k)
    jparams_np = jax.tree_util.tree_map(np.asarray, jtr.params)
    from subgnn_tpu_torch.convert import params_from_jax
    want, _ = params_from_jax(jparams_np, {}, device="cpu")
    _assert_trees(ranks[0]["params"], to_numpy(want), atol=2e-4, rtol=2e-4)


def test_mesh_resume_reproduces_uninterrupted_run(spawned):
    ranks = spawned["resume"]
    assert any(name.startswith("epoch=1-") for name in ranks[0]["files"])
    for r in ranks:
        assert [m["epoch"] for m in r["resumed"]["metrics"]] == [2, 3]
        _assert_trees(r["full"]["params"], r["resumed"]["params"],
                      atol=1e-6, rtol=0)
        _assert_metrics(r["resumed"]["metrics"], r["full"]["metrics"][2:],
                        rtol=1e-6)


def test_mesh_run_writes_jax_artifacts_once(spawned, tmp_path):
    r0, r1 = spawned["run"]
    run_dir = spawned["tmp2"] / "run_root" / "tensorboard" / "mesh"
    # rank 0 alone writes, once each; both ranks precompute on the mesh,
    # the structure sims of 3 splits x 2 sides and the NP sims gathered
    assert sorted(r0["dump_json"]) == sorted(ARTIFACTS)
    assert r1["dump_json"] == []
    assert (r0["dtw_sims"], r1["dtw_sims"]) == (6, 6)
    assert r0["precompute_gathers"] == r1["precompute_gathers"] == 3 + 6
    assert r0["group_kept"] and r1["group_kept"]
    tkw = json.loads((run_dir / "trainer_kwargs.json").read_text())
    assert tkw["devices"] == ["cpu", "cpu"]
    assert tkw["mesh_axes"] == {"data": 2, "node": 1}
    assert len(list((run_dir / "tb").glob("events.out.tfevents.*"))) == 1
    assert list((run_dir / "checkpoints").glob("*.ckpt"))
    # the same run in one process
    shutil.copytree(FIXTURE / "mini", tmp_path / "mini")
    t_train_cli.main(["-task", "mini", "-project_root", str(tmp_path),
                      "-hyperparams", str(_mini_hyp(tmp_path / "h.json")),
                      "-tb_name", "one", "-device", "cpu"])
    one_dir = tmp_path / "tensorboard" / "one"
    assert json.loads((one_dir / "trainer_kwargs.json").read_text())[
        "mesh_axes"] is None
    for name in ("final_metric_scores.json", "test_results.json"):
        got = json.loads((run_dir / name).read_text())
        want = json.loads((one_dir / name).read_text())
        for k in want:
            if k.endswith(("loss", "micro_f1", "acc")):
                np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                           err_msg=f"{name} {k}")


def test_mesh_object_and_rank_rows(spawned):
    for rank, out in enumerate(spawned["api"]):
        assert out["shape"] == {"data": 2, "node": 1}
        assert out["axis_names"] == ("data", "node")
        assert out["rank"] == rank
        assert out["rows"] == (4 * rank, 4 * rank + 4)
        assert (out["device"], out["backend"]) == ("cpu", "gloo")


# ---------------------------------------------- the knobs, refused (no group)

def test_mesh_from_hparams_is_none_for_one_position():
    assert MX.mesh_from_hparams(HParams()) is None
    assert MX.mesh_from_hparams(HParams(mesh_data_axis=1,
                                        mesh_node_axis=1)) is None
    with pytest.raises(RuntimeError, match="process group"):
        MX.make_device_mesh(1)


def _through(entry, over, tmp_path):
    hp_dict = dict(load_commented_json(FIXTURE / "mini_config.json")
                   ["hyperparams_fix"], **over)
    if entry == "mesh_from_hparams":
        MX.mesh_from_hparams(HParams.from_dict(hp_dict))
    elif entry == "Trainer":
        model, hp, *_ = build_training_fixture(hp_overrides=over,
                                               device="cpu")
        Trainer(model, hp, device="cpu")
    elif entry == "run":
        rc = RunConfig(task="mini", project_root=FIXTURE)
        t_runner.SubGNNPipeline(rc, HParams.from_dict(hp_dict),
                                device="cpu").run()
    else:
        hyp = tmp_path / "hyp.json"
        hyp.write_text(json.dumps(hp_dict))
        t_train_cli.main(["-task", "mini", "-project_root", str(tmp_path),
                          "-hyperparams", str(hyp), "-device", "cpu"])


@pytest.mark.parametrize("entry", ["mesh_from_hparams", "Trainer", "run",
                                   "cli.train"])
@pytest.mark.parametrize("over,match", [
    (dict(mesh_data_axis=2), "exceeds the 1 ranks"),
    (dict(mesh_node_axis=2), "exceeds the 1 ranks"),
    (dict(mesh_data_axis=2, mesh_node_axis=2), "exceeds the 1 ranks"),
], ids=["data_axis_past_world", "node_axis", "both_axes"])
def test_mesh_knobs_refused_not_ignored(entry, over, match, tmp_path):
    """A hyperparams.json written for a JAX mesh run raises where the port
    cannot honour it; it never trains on one process silently."""
    with pytest.raises(ValueError, match=match):
        _through(entry, over, tmp_path)
    assert not (tmp_path / "tensorboard").exists()
