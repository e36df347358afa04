"""The port's embedding-gather op against the JAX package's
(subgnn_tpu/ops/embedding.py) on the same ids and cotangents.

Plans must come out equal array for array. The plain backward
(`segment_matmul_torch`) is held against `_segment_matmul_xla` and against
the Pallas kernel run in interpret mode, at atol 1e-5 in float32: the same
fp32 sums in another order. Gradients of `embedding_gather` are held against
jax.grad through the JAX op and torch autograd of a plain `table[ids]`.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from subgnn_tpu.ops import embedding as J
from subgnn_tpu.train.plans import PlanBuilder as JPlanBuilder

from subgnn_tpu_torch.ops import embedding as T
from subgnn_tpu_torch.train.plans import PlanBuilder as TPlanBuilder

TOL = dict(rtol=1e-5, atol=1e-5)
BT, W = T.TABLE_BLOCK, T.TILE_WIDTH


def _ids(kind, rng):
    """Id arrays that exercise the plan's cases."""
    if kind == "uniform":
        return rng.integers(0, 700, (4, 9, 13)), 700
    if kind == "hub_skewed":
        # one hot block spread over several tiles, plus sparse others
        return np.concatenate([rng.integers(0, BT, 1400),
                               np.full(700, 5),
                               rng.integers(0, 5 * BT, 300)]), 5 * BT
    if kind == "pad_row":
        # mostly id 0 (the PAD row), as padded CCs and anchors give
        ids = rng.integers(1, 400, (6, 3, 45))
        ids[rng.random(ids.shape) < 0.6] = 0
        return ids, 400
    raise ValueError(kind)


def _plans(ids, n_rows, n_tiles=None):
    return (J.make_gather_plan(ids, n_rows, n_tiles),
            T.make_gather_plan(ids, n_rows, n_tiles))


@pytest.mark.parametrize("kind", ["uniform", "hub_skewed", "pad_row"])
@pytest.mark.parametrize("extra_tiles", [0, 3])
def test_make_gather_plan_matches_jax(kind, extra_tiles):
    ids, n_rows = _ids(kind, np.random.default_rng(0))
    need = T.tiles_needed(ids, n_rows)
    assert need == J.tiles_needed(ids, n_rows)
    jp, tp = _plans(ids, n_rows, need + extra_tiles if extra_tiles else None)
    assert tp.n_rows == jp.n_rows == n_rows
    for name in ("pos", "local", "block"):
        t = getattr(tp, name)
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(jp, name)))
    if extra_tiles:
        # padding tiles: all-padding slots on the last block
        assert (tp.local[-extra_tiles:] == BT).all()
        assert (tp.block[-extra_tiles:] == -(-n_rows // BT) - 1).all()


def test_tile_overflow_and_range_errors_match_jax():
    ids = np.zeros(2 * W, np.int64)           # one hot block, needs 2 tiles
    need = T.tiles_needed(ids, 1000)
    for mod in (J, T):
        with pytest.raises(ValueError, match=f"plan needs {need} tiles > "
                                             f"requested {need - 1}"):
            mod.make_gather_plan(ids, 1000, n_tiles=need - 1)
        with pytest.raises(ValueError, match="out of range"):
            mod.make_gather_plan(np.array([3, 1000]), 1000)


@pytest.mark.parametrize("kind", ["uniform", "hub_skewed", "pad_row"])
def test_segment_matmul_torch_matches_xla_and_pallas(kind, monkeypatch):
    from jax.experimental import pallas as pl

    rng = np.random.default_rng(1)
    ids, n_rows = _ids(kind, rng)
    jp, tp = _plans(ids, n_rows, T.tiles_needed(ids, n_rows) + 2)
    D = 32
    g = rng.normal(size=(ids.size, D)).astype(np.float32)
    g_pad = jnp.asarray(np.concatenate([g, np.zeros((1, D), np.float32)]))

    got = T.segment_matmul(torch.from_numpy(g), tp)          # CPU: plain
    assert got.shape == (n_rows, D) and got.dtype == torch.float32
    np.testing.assert_allclose(
        got.numpy(), np.asarray(J._segment_matmul_xla(g_pad, jp, jnp.float32)),
        **TOL)

    orig = pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(pl, "pallas_call", interp)
    np.testing.assert_allclose(
        got.numpy(),
        np.asarray(J._segment_matmul_pallas(g_pad, jp, jnp.float32)), **TOL)
    # against the exact per-row sum (float64 scatter)
    exact = np.zeros((n_rows, D))
    np.add.at(exact, ids.reshape(-1), g.astype(np.float64))
    np.testing.assert_allclose(got.numpy(), exact, **TOL)


def _jax_grad(table, ids, plan, g):
    _, vjp = jax.vjp(lambda t: J.embedding_gather(t, ids, plan), table)
    return np.asarray(vjp(g)[0].astype(jnp.float32))


@pytest.mark.parametrize("case", ["repeated_ids", "rows_past_plan",
                                  "pad_row", "bf16_table"])
def test_embedding_gather_grad_matches_jax_and_autograd(case):
    rng = np.random.default_rng(2)
    D = 16
    n_rows, table_rows = 300, 300
    ids = rng.integers(0, n_rows, (5, 7, 11))
    dtype = torch.float32
    if case == "repeated_ids":
        ids[:, :, :6] = 17                          # one row many times
    elif case == "rows_past_plan":
        n_rows, table_rows = 130, 144               # table padded past plan
        ids = rng.integers(0, n_rows, (40,))
    elif case == "pad_row":
        ids[rng.random(ids.shape) < 0.5] = 0
    elif case == "bf16_table":
        dtype = torch.bfloat16
    table = rng.normal(size=(table_rows, D)).astype(np.float32)
    g = rng.normal(size=ids.shape + (D,)).astype(np.float32)
    tplan = T.make_gather_plan(ids, n_rows)
    jplan = J.make_gather_plan(ids, n_rows)

    tt = torch.tensor(table, requires_grad=True)
    ti = torch.from_numpy(ids).long()
    tg = torch.from_numpy(g).to(dtype)
    out = T.embedding_gather(tt.to(dtype), ti, tplan)
    np.testing.assert_array_equal(out.float().detach().numpy(),
                                  tt.to(dtype)[ti].float().detach().numpy())
    (d_op,) = torch.autograd.grad(out, tt, tg)
    assert d_op.shape == table.shape and d_op.dtype == torch.float32
    assert (d_op[n_rows:] == 0).all()

    # JAX: the table is cast to the working dtype before the gather, as
    # models/subgnn.py does in bf16 mode, so dtable rounds to bf16 there too
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    d_jax = _jax_grad(jnp.asarray(table).astype(jdt), jnp.asarray(ids),
                      jplan, jnp.asarray(g).astype(jdt))
    # autograd of the plain gather, summed in fp32 and rounded to the
    # table's dtype as the op does (bf16 autograd would sum in bf16)
    (d_plain,) = torch.autograd.grad(tt[ti], tt, tg.float())
    d_plain = d_plain.to(dtype).float()
    if dtype == torch.bfloat16:
        # fp32 sums in another order may round to neighbouring bf16 values
        ulp = np.abs(d_jax) * 2.0 ** -7
        assert (np.abs(d_op.numpy() - d_jax) <= ulp + 1e-5).all()
        assert (np.abs(d_op.numpy() - d_plain.numpy()) <= ulp + 1e-5).all()
    else:
        np.testing.assert_allclose(d_op.numpy(), d_jax, **TOL)
        np.testing.assert_allclose(d_op.numpy(), d_plain.numpy(), **TOL)


def test_plan_builder_growth_matches_jax():
    rng = np.random.default_rng(3)
    jb, tb = JPlanBuilder(1000), TPlanBuilder(1000)
    sizes = [300, 300, 5000, 4000, 5200, 20000, 800]
    for n in sizes:
        ids = rng.integers(0, 1000, n)
        jp, tp = jb.build("neigh", ids), tb.build("neigh", ids)
        assert tb.tiles == jb.tiles
        assert tuple(tp.pos.shape) == tuple(jp.pos.shape)
        np.testing.assert_array_equal(tp.pos.numpy(), np.asarray(jp.pos))


def test_segment_matmul_rejects_what_it_does_not_take():
    ids = np.arange(10)
    plan = T.make_gather_plan(ids, 16)
    g = torch.zeros(10, 8)
    with pytest.raises(TypeError):
        T.segment_matmul(g.double(), plan)
    with pytest.raises(TypeError):
        T.segment_matmul(g, plan._replace(pos=plan.pos.long()))
    with pytest.raises(ValueError):
        T.segment_matmul(g, plan._replace(block=plan.block[:0]))
    with pytest.raises(ValueError):
        T.segment_matmul(g[None], plan)
