"""The node axis of the training mesh (subgnn_tpu_torch/parallel/mesh.py) on
the CPU: the embedding table, Adam's moments of it and the non-compact NP
similarities sharded over mesh_node_axis ranks, the gathers from them masked
and summed over the node group, and the table gradient by segment_matmul on
each rank's shard plan.

Ranks are gloo processes spawned as in tests/test_torch_mesh.py (its
`_spawn`, `_fit` and assertions): one spawn of a (1, 2) mesh and one of a
(2, 2) mesh, each running all its jobs; the references run in this process.
Counterparts of the JAX package's tests/test_parallel.py: the sharded
forward against the local one and against JAX's (2, 2) mesh (:49), the
node-group collective and what a rank holds (:78), fits against one process
(:114, :145), a (2, 2) fused fit against the JAX Trainer's (2, 2) fit, a
resume (:406), and run() through cli.train.

Tolerances: the forward, atol 1e-4 (the JAX test's); a mesh fit against the
one-process port fit, rtol 1e-4 on the metrics and atol 1e-5 on the
parameters (the same sums split over ranks and added in another order);
against JAX, rtol 2e-4 (the JAX mesh tests' own); a resume against the
uninterrupted run, atol 1e-6; a one-process restore of the mesh run's best
checkpoint, rel 1e-5 on its test metrics.

No JAX at module level: the spawned ranks import this module.
"""
import json
import pickle
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from subgnn_tpu_torch.bench import build_flagship, build_training_fixture
from subgnn_tpu_torch.cli import train as t_train_cli
from subgnn_tpu_torch.convert import params_from_jax
from subgnn_tpu_torch.ops import embedding as E
from subgnn_tpu_torch.parallel import mesh as MX
from subgnn_tpu_torch.train import runner as t_runner
from subgnn_tpu_torch.train.checkpoint import load_checkpoint, to_numpy
from subgnn_tpu_torch.train.loop import (Trainer, device_batch,
                                         node_gathers_per_step)
from tests.test_torch_mesh import (ARTIFACTS, FIXTURE, METRIC_KEYS,
                                   _assert_metrics, _assert_ranks_agree,
                                   _assert_trees, _fit, _mini_hyp, _spawn)

EPOCHS = 3
CLIP = 0.05          # below the fixture's gradient norms: clipping acts
# fused with compact sims: every mesh-sensitive piece on
FUSED_HP = dict(trainable_cc=True, batch_norm=True, lin_dropout=0.2,
                grad_clip=CLIP, max_epochs=EPOCHS)
# streaming with the non-compact NP sims (sharded over the node axis)
STREAM_HP = dict(batch_norm=True, lin_dropout=0.2, max_epochs=EPOCHS)
JAX_HP = dict(trainable_cc=True, batch_norm=True, max_epochs=EPOCHS)
ROWS, N_COLS, D = 136, 128, 32      # build_training_fixture's table, NP sims
# tests/test_parallel.py's sharded-forward instance
FLAGSHIP = dict(n_nodes=128, n_sub=8, C=2, L=4, n_pool=16,
                hp_overrides=dict(node_embed_size=16, n_layers=1,
                                  n_anchor_patches_N_in=3,
                                  n_anchor_patches_N_out=3,
                                  n_anchor_patches_pos_in=3,
                                  n_anchor_patches_pos_out=3,
                                  n_anchor_patches_structure=3,
                                  n_triangular_walks=2, random_walk_len=4,
                                  linear_hidden_dim_1=8,
                                  linear_hidden_dim_2=8))


# ----------------------------------------------------------------- jobs

def _job_api(rank, tmp, mesh):
    r = mesh.rows(8)
    return {"shape": mesh.shape, "index": (mesh.data_index, mesh.node_index),
            "batch_rows": (r.start, r.stop),
            "table_rows": mesh.shard_rows(ROWS),
            "np_cols": mesh.shard_cols(N_COLS),
            "node_group": dist.get_process_group_ranks(mesh.node_group),
            "data_group": dist.get_process_group_ranks(mesh.data_group)}


def _case(job):
    """_fit's keywords for a fit case."""
    over, streaming, compact = CASES[job]
    return dict(over=over, streaming=streaming, compact=compact)


def _job_fused(rank, tmp, mesh):
    return _fit(**_case("fused"), mesh=mesh)


def _job_fused_np(rank, tmp, mesh):
    return _fit(**_case("fused_np"), mesh=mesh)


def _job_stream_np(rank, tmp, mesh):
    return _fit(**_case("stream_np"), mesh=mesh)


def _job_frozen(rank, tmp, mesh):
    return _fit(**_case("frozen"), mesh=mesh)


def _job_debug(rank, tmp, mesh):
    return _fit(**_case("debug"), mesh=mesh)


def _job_jax(rank, tmp, mesh):
    with open(Path(tmp) / "jax_weights.pkl", "rb") as f:
        params, state = pickle.load(f)
    return _fit(JAX_HP, mesh=mesh,
                weights=params_from_jax(params, state, device="cpu"))


def _job_resume(rank, tmp, mesh):
    ckpts = Path(tmp) / "resume_ckpt"
    full = _fit(dict(FUSED_HP, max_epochs=4), mesh=mesh)
    _fit(dict(FUSED_HP, max_epochs=2), mesh=mesh, ckpt_dir=str(ckpts),
         checkpoint_k=10)
    dist.barrier()              # rank 0 wrote the checkpoints
    mid, = ckpts.glob("epoch=1-*.ckpt")
    resumed = _fit(dict(FUSED_HP, max_epochs=4), mesh=mesh, resume=mid,
                   start_epoch=2)
    return {"full": full, "resumed": resumed,
            "saved_table": load_checkpoint(mid)["params"]["node_embed"].shape}


def _job_forward(rank, tmp, mesh):
    """The flagship forward from the JAX weights: this rank's table rows,
    batch rows and NP-sim columns; logits gathered to every rank."""
    with open(Path(tmp) / "jax_flagship.pkl", "rb") as f:
        params, state = pickle.load(f)
    model, hp, _, _, batch, anchors = build_flagship(**FLAGSHIP,
                                                     device="cpu")
    params, state = params_from_jax(params, state, device="cpu")
    lo, hi = mesh.shard_rows(params["node_embed"].shape[0])
    params["node_embed"] = params["node_embed"][lo:hi]
    MX.reset_counts()
    with torch.no_grad():
        logits, _ = model(params, state,
                          device_batch(MX.shard_batch(batch, mesh), "cpu"),
                          device_batch(anchors, "cpu"), train=False,
                          mesh=mesh)
        logits = MX.all_gather_rows(logits, mesh)
    return {"logits": logits.numpy(), "node_sums": MX.node_sum.calls,
            "node_sum_bytes": MX.node_sum.bytes}


def _job_run(rank, tmp, mesh):
    """cli.train on the mini fixture with mesh_node_axis=2, as under
    torchrun (the group already joined, so the CLI takes it as it is)."""
    import os
    names = []
    dump = t_runner.dump_json

    def counted_dump(path, obj):
        names.append(Path(path).name)
        dump(path, obj)

    os.environ.update(WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank))
    t_runner.dump_json = counted_dump
    try:
        t_train_cli.main(["-task", "mini", "-project_root",
                          str(Path(tmp) / "run_root"), "-hyperparams",
                          str(Path(tmp) / "run_hyp.json"), "-tb_name",
                          "node", "-device", "cpu"])
    finally:
        t_runner.dump_json = dump
    return {"dump_json": names}


JOBS_12 = {"api": _job_api, "fused": _job_fused, "fused_np": _job_fused_np,
           "stream_np": _job_stream_np, "frozen": _job_frozen,
           "debug": _job_debug, "resume": _job_resume, "run": _job_run}
JOBS_22 = {"api": _job_api, "forward": _job_forward, "fused": _job_fused,
           "stream_np": _job_stream_np, "jax": _job_jax}
CASES = {"fused": (FUSED_HP, False, None),
         "fused_np": (FUSED_HP, False, False),
         "stream_np": (STREAM_HP, True, False),
         "frozen": (dict(STREAM_HP, freeze_node_embeds=True), True, False),
         "debug": (dict(STREAM_HP, debug_mode=True, grad_clip=CLIP), True,
                   False)}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The (1, 2) and (2, 2) spawns; the JAX weights go to them through
    files."""
    import __graft_entry__ as ge
    import jax
    tmp12 = tmp_path_factory.mktemp("mesh12")
    tmp22 = tmp_path_factory.mktemp("mesh22")
    j = ge._build_training_fixture(hp_overrides=JAX_HP)
    with open(tmp22 / "jax_weights.pkl", "wb") as f:
        pickle.dump(jax.tree_util.tree_map(np.asarray, (j[2], j[3])), f)
    j = ge._build_flagship(**FLAGSHIP)
    with open(tmp22 / "jax_flagship.pkl", "wb") as f:
        pickle.dump(jax.tree_util.tree_map(np.asarray, (j[2], j[3])), f)
    shutil.copytree(FIXTURE / "mini", tmp12 / "run_root" / "mini")
    _mini_hyp(tmp12 / "run_hyp.json", mesh_node_axis=2)
    return {(1, 2): _spawn(2, tmp12, JOBS_12, n_node=2),
            (2, 2): _spawn(4, tmp22, JOBS_22, n_node=2),
            "tmp12": tmp12}


# ------------------------------------------------------------ the mesh

@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_node_mesh_positions_and_groups(spawned, shape):
    n_data, n_node = shape
    for rank, out in enumerate(spawned[shape]["api"]):
        d, k = divmod(rank, n_node)      # JAX's reshape(n_data, n_node)
        assert out["shape"] == {"data": n_data, "node": n_node}
        assert out["index"] == (d, k)
        b = 8 // n_data
        assert out["batch_rows"] == (d * b, (d + 1) * b)
        n = ROWS // n_node
        assert out["table_rows"] == (k * n, (k + 1) * n)
        c = N_COLS // n_node
        assert out["np_cols"] == (k * c, (k + 1) * c)
        assert out["node_group"] == [d * n_node + i for i in range(n_node)]
        assert out["data_group"] == [i * n_node + k for i in range(n_data)]


def test_sharded_forward_matches_one_process_and_jax_mesh(spawned):
    """The (2, 2) forward against the port's one-process forward and
    against JAX's forward on a (2, 2) mesh of 4 of the 8 host devices; the
    node-group sums carry the gathered rows and NP-sim values exactly."""
    import __graft_entry__ as ge
    import jax
    from subgnn_tpu.parallel.mesh import (anchor_pspecs, batch_pspecs,
                                          make_device_mesh, param_pspecs,
                                          shard_tree)
    jmodel, jhp, jparams, jstate, jbatch, janchors = ge._build_flagship(
        **FLAGSHIP)
    local, _ = jmodel.forward(jparams, jstate, jbatch, janchors, train=False,
                              rng=None)
    mesh = make_device_mesh(n_data=2, n_node=2, devices=jax.devices()[:4])
    with mesh:
        sp = shard_tree(mesh, jparams, param_pspecs(jparams))
        sb = shard_tree(mesh, jbatch, batch_pspecs(jbatch))
        sa = shard_tree(mesh, janchors, anchor_pspecs(janchors))
        jmesh_logits = jax.jit(lambda p, b: jmodel.forward(
            p, jstate, b, sa, train=False, rng=None)[0])(sp, sb)
    model, hp, _, _, batch, anchors = build_flagship(**FLAGSHIP,
                                                     device="cpu")
    params, state = params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams),
        jax.tree_util.tree_map(np.asarray, jstate), device="cpu")
    with torch.no_grad():
        one, _ = model(params, state, device_batch(batch, "cpu"),
                       device_batch(anchors, "cpu"), train=False)
    ids, cols = node_gathers_per_step(hp, 4, 2, 4, compact=False)
    for out in spawned[(2, 2)]["forward"]:
        np.testing.assert_allclose(out["logits"], one.numpy(), atol=1e-4)
        np.testing.assert_allclose(out["logits"], np.asarray(local),
                                   atol=1e-4)
        np.testing.assert_allclose(out["logits"], np.asarray(jmesh_logits),
                                   atol=1e-4)
        assert out["node_sum_bytes"] == 4 * (ids * hp.node_embed_size + cols)
        # rows: cc, neigh, walks, pos in and out; columns: neigh, pos in, out
        assert out["node_sums"] == 5 + 3


# ------------------------------------------------------------ the fits

def _one(job):
    return _fit(**_case(job))


@pytest.mark.parametrize("shape,job", [
    ((1, 2), "fused"), ((1, 2), "fused_np"), ((1, 2), "stream_np"),
    ((1, 2), "frozen"), ((1, 2), "debug"),
    ((2, 2), "fused"), ((2, 2), "stream_np"),
], ids=["1x2_fused", "1x2_fused_np_sim", "1x2_streaming_np_sim",
        "1x2_frozen_table", "1x2_debug_mode_clipped", "2x2_fused",
        "2x2_streaming_np_sim"])
def test_node_mesh_fit_matches_one_process(spawned, shape, job):
    n_data, n_node = shape
    ranks = spawned[shape][job]
    one = _one(job)
    over, streaming, compact = CASES[job]
    assert ranks[0]["fused"] is one["fused"] is (not streaming)
    # a node-axis rank's plans route its rows alone: the host builds them
    assert ranks[0]["plans_on_device"] is False
    assert one["plans_on_device"] is (not streaming)
    assert ranks[0]["steps"] == one["steps"]
    _assert_ranks_agree(ranks)
    _assert_metrics(ranks[0]["metrics"], one["metrics"], rtol=1e-4)
    _assert_trees(ranks[0]["params"], one["params"], atol=1e-5, rtol=0)
    _assert_trees(ranks[0]["state"], one["state"], atol=1e-5, rtol=0)
    # debug_mode's gradient norms: the whole table's, over the node group
    np.testing.assert_allclose(ranks[0]["grad_norms"], one["grad_norms"],
                               rtol=1e-4)
    assert bool(ranks[0]["grad_norms"]) is (job == "debug")
    assert all(n > CLIP for n in one["grad_norms"])     # clipping acts
    # each rank holds its shard of the table, of both moments (none for a
    # frozen table) and of the NP sims' node axis
    np_cols = None if compact is not False else N_COLS // n_node
    names = ("node_embed",) + (() if job == "frozen" else ("mu", "nu"))
    assert set(one["held"]) - {"NP_sim", "NP_sim_val"} == set(names)
    for name in names:
        assert one["held"][name][0] == (ROWS, D)
    for r in ranks:
        for name in names:
            assert r["held"][name][0] == (ROWS // n_node, D), name
        if np_cols is None:
            assert "NP_sim" not in r["held"]
        else:
            assert r["held"]["NP_sim"][0][2] == np_cols
            assert one["held"]["NP_sim"][0][2] == N_COLS
    # the node-group sums: the gathered rows and NP-sim values of every
    # forward (train steps and one val batch an epoch), exactly
    hp = build_training_fixture(hp_overrides=over, device="cpu")[1]
    ids, cols = node_gathers_per_step(hp, 8 // n_data, 2, 4,
                                      compact=compact is not False)
    forwards = one["steps"] + EPOCHS
    for r in ranks:
        assert r["node_sums"] == (5 + (3 if cols else 0)) * forwards
        assert r["node_sum_bytes"] == forwards * 4 * (ids * D + cols)
    assert one["node_sums"] == one["node_sum_bytes"] == 0


def test_gradient_clipping_acts_in_the_node_mesh_fits():
    """The fused fits clip: their global norm (the table's squared sum
    taken over the node group) is past CLIP."""
    clipped = _one("fused")
    unclipped = _fit(dict(FUSED_HP, grad_clip=0.0))
    diff = np.abs(clipped["params"]["node_embed"]
                  - unclipped["params"]["node_embed"]).max()
    assert diff > 1e-4


def test_node_mesh_fused_fit_matches_jax_mesh_fit(spawned):
    """The (2, 2) fused fit from the JAX weights against the JAX Trainer's
    mesh_data_axis=2, mesh_node_axis=2 fit."""
    import __graft_entry__ as ge
    import jax
    from subgnn_tpu.train.loop import Trainer as JTrainer
    jmodel, jhp, jparams, jstate, jdata, janchors, jeval = \
        ge._build_training_fixture(hp_overrides=dict(
            JAX_HP, mesh_data_axis=2, mesh_node_axis=2))
    jtr = JTrainer(jmodel, jhp, eval_cc_tables=jeval)
    assert jtr.mesh.shape == {"data": 2, "node": 2}
    jtr.fit(jparams, jstate, jdata["train"], jdata["val"], janchors,
            seed=0, log_fn=None)
    ranks = spawned[(2, 2)]["jax"]
    assert ranks[0]["fused"] and hasattr(jtr, "_fused_train_epoch")
    _assert_ranks_agree(ranks)
    for got, want in zip(ranks[0]["metrics"], jtr.metric_scores):
        for k in METRIC_KEYS:
            np.testing.assert_allclose(got[k], want[k], rtol=2e-4,
                                       atol=1e-5, err_msg=k)
    want, _ = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                     jtr.params), {},
                              device="cpu")
    _assert_trees(ranks[0]["params"], to_numpy(want), atol=2e-4, rtol=2e-4)


def test_node_mesh_resume_reproduces_uninterrupted_run(spawned):
    ranks = spawned[(1, 2)]["resume"]
    for r in ranks:
        assert r["saved_table"] == (ROWS, D)     # the whole table on file
        assert [m["epoch"] for m in r["resumed"]["metrics"]] == [2, 3]
        _assert_trees(r["full"]["params"], r["resumed"]["params"],
                      atol=1e-6, rtol=0)
        _assert_metrics(r["resumed"]["metrics"], r["full"]["metrics"][2:],
                        rtol=1e-6)


def test_node_mesh_run_checkpoint_restores_in_one_process(spawned, tmp_path):
    r0, r1 = spawned[(1, 2)]["run"]
    run_dir = spawned["tmp12"] / "run_root" / "tensorboard" / "node"
    assert sorted(r0["dump_json"]) == sorted(ARTIFACTS)
    assert r1["dump_json"] == []
    tkw = json.loads((run_dir / "trainer_kwargs.json").read_text())
    assert tkw["mesh_axes"] == {"data": 1, "node": 2}
    assert tkw["devices"] == ["cpu", "cpu"]
    metas = {p: load_checkpoint(p) for p in
             (run_dir / "checkpoints").glob("*.ckpt")}
    assert metas
    # the whole table in every file: the fixture's embeddings, a PAD row,
    # rows to a multiple of 8 (models/subgnn.py:init_params)
    emb = torch.load(FIXTURE / "mini" / "gin_embeddings.pth")
    whole = (-(-(emb.shape[0] + 1) // 8) * 8, emb.shape[1])
    assert {np.shape(m["params"]["node_embed"])
            for m in metas.values()} == {whole}
    # the trainer's best: the highest val_micro_f1, the earliest on a tie
    best = max(sorted(metas, key=lambda p: metas[p]["meta"]["epoch"]),
               key=lambda p: metas[p]["meta"]["val_micro_f1"])
    # the best checkpoint tested in one process (-noTrain), the mesh knob
    # overridden: the same test metrics as the mesh run's own test pass
    shutil.copytree(FIXTURE / "mini", tmp_path / "mini")
    t_train_cli.main(["-task", "mini", "-project_root", str(tmp_path),
                      "-restoreModelPath", str(run_dir),
                      "-restoreModelName", f"checkpoints/{best.name}",
                      "-hyperparams",
                      str(_mini_hyp(tmp_path / "h.json", mesh_node_axis=1)),
                      "-noTrain", "-tb_name", "restored", "-device", "cpu"])
    got = json.loads((tmp_path / "tensorboard" / "restored"
                      / "test_results.json").read_text())
    want = json.loads((run_dir / "test_results.json").read_text())
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)


# ------------------------------------------------------- the shard plans

@pytest.mark.parametrize("n_node", [2, 4])
def test_shard_plans_sum_to_the_whole_table_gradient(n_node):
    """segment_matmul_torch over each shard's plan, concatenated, is the
    whole plan's output (PAD row 0 included); ids outside a shard get no
    slot, and the range-less call still refuses an id off the table."""
    rng = np.random.default_rng(n_node)
    rows, width = 1024, 16
    ids = rng.integers(0, rows, (3, 700))
    ids[:, :300] = 0                        # a third on the PAD row
    g = torch.as_tensor(rng.normal(size=(ids.size, width)),
                        dtype=torch.float32)
    whole = E.segment_matmul_torch(g, E.make_gather_plan(ids, rows))
    n = rows // n_node
    parts = []
    for k in range(n_node):
        lo, hi = k * n, (k + 1) * n
        plan = E.make_gather_plan(ids, rows, row_range=(lo, hi))
        assert plan.n_rows == n
        assert plan.pos.shape[0] == E.tiles_needed(ids, rows, (lo, hi))
        real = plan.local.numpy() < E.TABLE_BLOCK
        flat = ids.reshape(-1)
        assert sorted(plan.pos.numpy()[real]) == list(
            np.flatnonzero((flat >= lo) & (flat < hi)))
        assert (plan.pos.numpy()[~real] == ids.size).all()
        parts.append(E.segment_matmul_torch(g, plan))
    np.testing.assert_allclose(torch.cat(parts).numpy(), whole.numpy(),
                               rtol=1e-6, atol=1e-5)
    assert np.abs(whole[0].numpy()).sum() > 0          # PAD row 0 routed
    with pytest.raises(ValueError, match="out of range"):
        E.make_gather_plan(np.array([rows]), rows)


@pytest.mark.parametrize("n_node", [2, 4])
def test_shard_gather_is_the_whole_gather_split_by_rows(n_node):
    """shard_gather's terms over the shards sum to table[ids] exactly, and
    each shard's gradient (with its shard plan through segment_matmul, and
    without a plan through autograd's index backward) is the whole
    table's gradient of its rows."""
    rng = np.random.default_rng(n_node)
    rows, width = 256, 8
    ids = rng.integers(0, rows, (6, 40))
    ids[:, :10] = 0
    table = torch.as_tensor(rng.normal(size=(rows, width)),
                            dtype=torch.float32)
    ids_t = torch.as_tensor(ids)
    g = torch.as_tensor(rng.normal(size=ids.shape + (width,)),
                        dtype=torch.float32)
    whole = table.clone().requires_grad_()
    want, = torch.autograd.grad(whole[ids_t], whole, g)
    n = rows // n_node
    total = torch.zeros(ids.shape + (width,))
    for k in range(n_node):
        lo = k * n
        plan = E.make_gather_plan(ids, rows, row_range=(lo, lo + n))
        for p in (plan, None):
            shard = table[lo:lo + n].clone().requires_grad_()
            out = E.shard_gather(shard, ids_t, lo, p)
            grad, = torch.autograd.grad(out, shard, g)
            np.testing.assert_allclose(grad.numpy(), want[lo:lo + n].numpy(),
                                       rtol=1e-6, atol=1e-6)
        total += out.detach()
    assert torch.equal(total, table[ids_t])


def test_table_rows_that_do_not_divide_raise_through_trainer():
    model, hp, params, state, data, anchors, _ = build_training_fixture(
        device="cpu")
    # a mesh object alone: the check comes before any collective
    mesh = MX.Mesh(None, 1, 3, 0, 3, torch.device("cpu"))
    tr = Trainer(model, hp, device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="136 table rows must divide over "
                                         "the 'node' mesh axis"):
        tr.fit(params, state, data["train"], data["val"], anchors,
               log_fn=None)


@pytest.mark.parametrize("n_cols", [77, 78])
def test_np_sim_columns_shard_as_jax_places_them(n_cols):
    """An NP-sim node axis that does not divide raises, as JAX's
    device_put of split_pspecs does on a (4, 2) mesh of the 8 host
    devices; one that does splits where JAX's shards do."""
    import jax
    from subgnn_tpu.parallel.mesh import make_device_mesh, shard_tree, \
        split_pspecs
    a = np.zeros((8, 2, n_cols), np.float32)
    jmesh = make_device_mesh(n_data=4, n_node=2)
    ports = [MX.Mesh(None, 4, 2, k, 8, torch.device("cpu")) for k in (0, 1)]
    if n_cols % 2:
        with pytest.raises(ValueError):
            shard_tree(jmesh, {"NP_sim": a}, split_pspecs({"NP_sim": a}))
        for m in ports:
            with pytest.raises(ValueError, match="must divide"):
                m.shard_cols(n_cols)
        return
    placed = shard_tree(jmesh, {"NP_sim": a},
                        split_pspecs({"NP_sim": a}))["NP_sim"]
    want = {(s.index[2].start, s.index[2].stop)
            for s in placed.addressable_shards}
    assert {m.shard_cols(n_cols) for m in ports} == want
