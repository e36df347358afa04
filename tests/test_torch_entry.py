"""The port's multi-rank tools on the CPU: the ring collectives
(subgnn_tpu_torch/parallel/collectives.py), the collective count
(parallel/audit.py) and the counterpart of __graft_entry__.py
(subgnn_tpu_torch/entry.py): `entry()` and the dry runs.

Rings run on 2, 3 and 4 gloo ranks spawned by tests/test_torch_mesh.py's
`_spawn` (one spawn a world size), with the JAX test's shapes (n, 13) and
(n, 5, 7), whose element counts do not divide by 3 or 4 (the pad path):
held against dist.all_reduce / dist.all_gather on the same ranks, and
against the JAX package's rings under shard_map on the first n of
tests/conftest.py's 8 host devices, on the same inputs (rtol 1e-5 / atol
1e-5, the JAX test's; the gathers exact), with the rotations counted. The
4-rank spawn also counts the collectives of a node-sharded forward (the
counterpart of tests/test_parallel.py:78). `entry()` is held against the
JAX package's entry() on its weights carried across by convert.py (rtol
1e-5). The dry runs spawn their own ranks: dryrun_multichip on 2 and 4
ranks, and dryrun_multichip_full on a (2, 2) mesh at 5,000 nodes, with
the audit's counts and bytes the port's design implies, exactly.

No JAX at module level: the spawned ranks import this module.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from subgnn_tpu_torch import entry as EN
from subgnn_tpu_torch.bench import build_flagship
from subgnn_tpu_torch.parallel import audit as AU
from subgnn_tpu_torch.parallel import collectives as RC
from subgnn_tpu_torch.parallel import mesh as MX
from subgnn_tpu_torch.train.loop import (device_batch, make_optimizer,
                                         node_gathers_per_step)
from tests.test_torch_mesh import _spawn

WORLDS = {2: 1, 3: 1, 4: 2}         # world: n_node
SHAPES = ((13,), (5, 7))            # a rank's part of JAX's (n, 13), (n, 5, 7)
GATHER_WIDTH = 6                    # JAX's (n, 6) gather input
# tests/test_parallel.py:84-92's node-sharded forward
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


def _inputs(n):
    """Every rank's inputs, drawn here: {shape: (n, *shape)}, the gather's
    (n, 6) and the fused variant's (n, 13)."""
    rng = np.random.default_rng(0)
    out = {s: rng.normal(size=(n,) + s).astype(np.float32) for s in SHAPES}
    out["gather"] = rng.normal(size=(n, GATHER_WIDTH)).astype(np.float32)
    out["fused"] = rng.normal(size=(n, 13)).astype(np.float32)
    return out


# --------------------------------------------------------------- the jobs

def _job_ring(rank, tmp, mesh):
    """The rings on this rank's rows against dist's collectives, each
    result with the rotations it counted."""
    inp = _inputs(mesh.world)
    out = {}
    for s in SHAPES:
        x = torch.as_tensor(inp[s][rank])
        want = x.clone()
        dist.all_reduce(want)
        RC.reset_counts()
        got = RC.ring_all_reduce(x, mesh)
        out[s] = (got.numpy(), want.numpy(), x.numpy(),
                  (RC.ring_all_reduce.calls, RC.ring_all_reduce.bytes))
    x = torch.as_tensor(inp["gather"][rank])
    want = [torch.empty_like(x) for _ in range(mesh.world)]
    dist.all_gather(want, x)
    RC.reset_counts()
    audit = AU.count_collectives(RC.ring_all_gather, x, mesh.group)
    out["gather"] = (RC.ring_all_gather(x, mesh.group).numpy(),
                     torch.stack(want).numpy(), audit)
    x = torch.as_tensor(inp["fused"][rank])
    want = x.clone()
    dist.all_reduce(want)
    out["fused"] = (RC.ring_all_reduce_fused(x, mesh.group,
                                             lambda c: 2.0 * c + 1.0).numpy(),
                    (2.0 * want + 1.0).numpy())
    # a group of one rank: x itself, chunk_fn(x), x[None]
    solo = dist.new_group([rank], use_local_synchronization=True)
    out["solo"] = (RC.ring_all_reduce(x, solo) is x,
                   torch.equal(RC.ring_all_reduce_fused(x, solo, lambda c: -c),
                               -x),
                   tuple(RC.ring_all_gather(x, solo).shape))
    return out


def _job_forward(rank, tmp, mesh):
    """count_collectives over the node-sharded flagship forward, this
    rank's rows of the table and of the batch, the logits gathered."""
    model, hp, params, state, batch, anchors = build_flagship(
        **FLAGSHIP, device="cpu")
    lo, hi = mesh.shard_rows(params["node_embed"].shape[0])
    params["node_embed"] = params["node_embed"][lo:hi]

    def forward():
        with torch.no_grad():
            logits, _ = model(params, state,
                              device_batch(MX.shard_batch(batch, mesh), "cpu"),
                              device_batch(anchors, "cpu"), train=False,
                              mesh=mesh)
            return MX.all_gather_rows(logits, mesh)

    return AU.count_collectives(forward)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    out = {}
    for world, n_node in WORLDS.items():
        jobs = {"ring": _job_ring}
        if world == 4:
            jobs["forward"] = _job_forward
        out[world] = _spawn(world, tmp_path_factory.mktemp(f"world{world}"),
                            jobs, n_node)
    return out


# ------------------------------------------------------------- the rings

def _jax_rings(n):
    """The JAX package's rings under shard_map on the first n host
    devices, on _inputs(n): {shape: psum by ring (n, *shape)}, the gather
    (n * n * 6,) and the fused (n, 13)."""
    import jax
    from jax.sharding import Mesh, PartitionSpec as P
    from subgnn_tpu.parallel.collectives import (
        ring_all_gather, ring_all_reduce, ring_all_reduce_fused)
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("r",))
    inp = _inputs(n)

    def run(fn, x):
        return np.asarray(jax.jit(jax.shard_map(
            fn, mesh=mesh, in_specs=P("r"), out_specs=P("r")))(x))

    out = {s: run(lambda xs: ring_all_reduce(xs, "r"), inp[s])
           for s in SHAPES}
    out["gather"] = run(
        lambda xs: ring_all_gather(xs.reshape(-1), "r").reshape(-1),
        inp["gather"])
    out["fused"] = run(
        lambda xs: ring_all_reduce_fused(xs, "r", lambda c: 2.0 * c + 1.0),
        inp["fused"])
    return out


@pytest.mark.parametrize("world", list(WORLDS))
def test_ring_all_reduce_matches_dist_and_jax(spawned, world):
    jax_out = _jax_rings(world)
    for rank, res in enumerate(spawned[world]["ring"]):
        for s in SHAPES:
            got, want, x, (calls, nbytes) = res[s]
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(got, jax_out[s][rank], rtol=1e-5,
                                       atol=1e-5)
            # 2 (n - 1) rotations of one padded chunk each
            chunk = -(-x.size // world)
            assert (calls, nbytes) == (2 * (world - 1),
                                       2 * (world - 1) * 4 * chunk)


@pytest.mark.parametrize("world", list(WORLDS))
def test_ring_all_gather_matches_dist_and_jax(spawned, world):
    jax_out = _jax_rings(world)["gather"].reshape(world, -1)
    for rank, res in enumerate(spawned[world]["ring"]):
        got, want, audit = res["gather"]
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got.reshape(-1), jax_out[rank])
        rot = world - 1
        assert audit == {"counts": {"collective-permute": rot},
                         "bytes": {"collective-permute": rot * 4 * 6},
                         "by_helper": {"ring_all_gather": (rot, rot * 24)}}


@pytest.mark.parametrize("world", list(WORLDS))
def test_ring_all_reduce_fused_applies_chunk_fn_once(spawned, world):
    jax_out = _jax_rings(world)["fused"]
    for rank, res in enumerate(spawned[world]["ring"]):
        got, want = res["fused"]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, jax_out[rank], rtol=1e-5, atol=1e-5)
        assert res["solo"] == (True, True, (1, 13))


# ------------------------------------------------------------ the audit

def test_node_sharded_forward_counts_its_collectives(spawned):
    """With the table sharded over 'node', the anchor gathers are masked
    gathers summed over the node group: all-reduces, counted with their
    bytes (node_gathers_per_step), and the logits' gather over 'data'."""
    model, hp, params, *_ = build_flagship(**FLAGSHIP, device="cpu")
    ids, cols = node_gathers_per_step(hp, 8 // 2, 2, 4, compact=False)
    L = hp.n_layers
    node_sums = (3 + 2 * L + 3 * L,
                 4 * (ids * hp.node_embed_size + cols))
    gather = (1, 4 * 8 * 4)         # the (B, classes) logits, fp32
    for audit in spawned[4]["forward"]:
        assert audit["by_helper"] == {"node_sum": node_sums,
                                      "all_gather_rows": gather}
        assert audit["counts"] == {"all-reduce": node_sums[0] + 1}
        assert audit["bytes"] == {"all-reduce": node_sums[1] + gather[1]}


def test_every_helper_has_a_kind():
    assert set(AU.HELPER_KINDS) == set(MX.COLLECTIVES) | set(
        RC.RING_COLLECTIVES)
    assert set(AU.HELPER_KINDS.values()) <= set(AU.KINDS)
    assert AU.HELPER_KINDS[MX.all_gather_world] == "all-reduce"
    assert AU.count_collectives(lambda: None) == {
        "counts": {}, "bytes": {}, "by_helper": {}}


# ----------------------------------------------------------- the entry

def test_entry_forward_matches_jax():
    """entry()'s forward on the JAX entry()'s weights against JAX's."""
    import jax
    import __graft_entry__ as ge
    from subgnn_tpu_torch.convert import params_from_jax
    jfn, (jparams, jbatch) = ge.entry()
    want = np.asarray(jfn(jparams, jbatch))
    fn, (params, batch) = EN.entry(device="cpu")
    tparams, _ = params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    assert set(tparams) == set(params)
    got = fn(tparams, batch).numpy()
    assert got.shape == want.shape == (32, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_entry_refuses_cuda_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        EN.entry()
    with pytest.raises(RuntimeError, match="cuda"):
        EN.dryrun_multichip(2, full=False)


# --------------------------------------------------------- the dry runs

@pytest.mark.parametrize("n,mesh", [(2, {"data": 1, "node": 2}),
                                    (4, {"data": 2, "node": 2})])
def test_dryrun_multichip(n, mesh):
    """The production Trainer.fit, fused, on n gloo ranks: each rank holds
    half the table."""
    res = EN.dryrun_multichip(n, full=False, device="cpu")
    assert res["mesh"] == mesh and res["backend"] == "gloo"
    assert res["fused"] is True
    assert np.isfinite(res["train_loss"]) and np.isfinite(res["val_loss"])
    assert res["rows_held"] * 2 == res["table_rows"]
    assert "full" not in res


def test_mesh_axes_and_backend():
    assert [EN.mesh_axes(n) for n in (1, 2, 3, 4, 8)] == [
        (1, 1), (1, 2), (3, 1), (2, 2), (4, 2)]
    assert EN.rank_backend(4, "cpu") == "gloo"


@pytest.fixture(scope="module")
def full_run(tmp_path_factory):
    return EN.dryrun_multichip_full(
        4, workdir=tmp_path_factory.mktemp("dry5k"), device="cpu")


def test_dryrun_multichip_full_at_scale(full_run):
    """Prepare, mesh precompute, fused fit, test and checkpoint at 5,000
    nodes on a (2, 2) mesh in one call, with JAX's result keys."""
    res = full_run
    assert {"mesh", "n_nodes", "n_subgraphs", "best_monitor",
            "test_micro_f1", "collective_counts",
            "collective_bytes"} <= set(res)
    assert res["mesh"] == {"data": 2, "node": 2}
    assert res["n_nodes"] == 5000 and res["n_subgraphs"] == 64
    assert np.isfinite(res["best_monitor"])
    assert np.isfinite(res["test_micro_f1"])
    assert res["fused"] is True and res["backend"] == "gloo"
    assert len(res["ranks"]) == 4


def test_dryrun_full_collectives_exact(full_run):
    """One flagship training step at 5,000 nodes on (2, 2): the gradients'
    one all-reduce over 'data' carries each rank's trainable leaves (the
    table's half on the node axis), and the anchor gathers' node sums carry
    node_gathers_per_step's ids and NP-sim columns; nothing else. JAX's
    bounds (__graft_entry__.py:333-340) follow: an all-reduce for each
    sharded axis, at least the held gradients' bytes."""
    model, hp, params, *_ = build_flagship(
        n_nodes=5000, n_sub=16, C=3, L=16, n_pool=40,
        hp_overrides=dict(node_embed_size=64), device="cpu")
    rows = params["node_embed"].shape[0]
    assert rows % 2 == 0
    held = dict(params, node_embed=params["node_embed"][:rows // 2])
    grad_bytes = sum(4 * t.numel()
                     for t in make_optimizer(hp).trainable(held))
    ids, cols = node_gathers_per_step(hp, 16 // 2, 3, 16, compact=False)
    L = hp.n_layers
    node_sums = (3 + 2 * L + 3 * L, 4 * (ids * hp.node_embed_size + cols))
    res = full_run
    assert res["grad_bytes"] == grad_bytes
    assert res["collective_by_helper"] == {
        "all_reduce_sum_": (1, grad_bytes), "node_sum": node_sums}
    assert res["collective_counts"] == {"all-reduce": 1 + node_sums[0]}
    assert res["collective_bytes"] == {"all-reduce":
                                       grad_bytes + node_sums[1]}
    assert res["collective_counts"]["all-reduce"] >= 2
    assert res["collective_bytes"]["all-reduce"] >= grad_bytes
