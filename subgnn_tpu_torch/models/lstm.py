"""Bidirectional multi-layer LSTM with a linear head, as an explicit cell loop.

Port of subgnn_tpu/models/lstm.py (reference: SubGNN/SubGNN.py:60-88 wraps
nn.LSTM). Semantics of torch.nn.LSTM: gate order i, f, g, o;
c' = f*c + i*g; h' = o*tanh(c'); the backward direction reads the reversed
sequence; stacked layers consume the 2h outputs of the layer below.

The loop is written out (T = random_walk_len steps) instead of calling
nn.LSTM: it keeps the JAX weight layout (w_ih (in, 4h), w_hh (h, 4h)) and
keeps cuDNN, and its TF32 default, out of the numbers.
Aggregator 'last' takes timestep -1 of the unmasked (zero-padded) walk: the
backward direction there has consumed exactly one input, so it is one cell
step from a zero state (quirk preserved). 'sum' sums h over time.
"""
from __future__ import annotations

import torch

from .dropout import KeepMask
from .dropout import dropout as apply_dropout


def _uniform(generator, shape, bound):
    return (torch.rand(shape, generator=generator) * 2 - 1) * bound


def init_lstm_params(generator: torch.Generator, n_features: int, h: int,
                     num_layers: int = 1):
    """Parameter tree for the bi-LSTM + linear head, U(-1/sqrt(h), 1/sqrt(h))."""
    bound = 1.0 / h ** 0.5
    layers = []
    for l in range(num_layers):
        in_dim = n_features if l == 0 else 2 * h
        dirs = [{"w_ih": _uniform(generator, (in_dim, 4 * h), bound),
                 "w_hh": _uniform(generator, (h, 4 * h), bound),
                 "b_ih": _uniform(generator, (4 * h,), bound),
                 "b_hh": _uniform(generator, (4 * h,), bound)}
                for _ in range(2)]
        layers.append({"fwd": dirs[0], "bwd": dirs[1]})
    head_bound = 1.0 / (2 * h) ** 0.5
    return {"layers": layers,
            "head": {"w": _uniform(generator, (2 * h, n_features), head_bound),
                     "b": _uniform(generator, (n_features,), head_bound)}}


def _xw(p, x):
    """Input projection of every timestep: (B, T, in) -> (B, T, 4h)."""
    dt = x.dtype
    return x @ p["w_ih"].to(dt) + (p["b_ih"] + p["b_hh"]).to(dt)


def _cell(xw_t, h, c, w_hh):
    gates = xw_t + h @ w_hh
    i, f, g, o = gates.chunk(4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    c = f * c + i * torch.tanh(g)
    return o * torch.tanh(c), c


def _run(p, x, reverse: bool):
    """One direction over (B, T, in). Returns (hs list in scan order, sum)."""
    xw = _xw(p, x)
    w_hh = p["w_hh"].to(x.dtype)
    B, T = x.shape[:2]
    h = x.new_zeros(B, w_hh.shape[0])
    c = torch.zeros_like(h)
    acc = torch.zeros_like(h)
    hs = []
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        h, c = _cell(xw[:, t], h, c, w_hh)
        acc = acc + h
        hs.append(h)
    return hs, acc


def _bidir_seq(layer, x):
    """Full-sequence bidirectional output (B, T, 2h) of one inner layer."""
    fwd, _ = _run(layer["fwd"], x, reverse=False)
    bwd, _ = _run(layer["bwd"], x, reverse=True)
    return torch.cat([torch.stack(fwd, dim=1),
                      torch.stack(bwd[::-1], dim=1)], dim=-1)


def _single_step(p, x_t):
    """One cell application from the zero state on a single timestep."""
    dt = x_t.dtype
    xw = x_t @ p["w_ih"].to(dt) + (p["b_ih"] + p["b_hh"]).to(dt)
    i, f, g, o = xw.chunk(4, dim=-1)
    c = torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c)


def lstm_forward(params, x, *, aggregator: str = "last",
                 dropout: float = 0.0, keep_mask: KeepMask | None = None):
    """x: (B, T, n_features) -> (B, n_features). In train mode (`keep_mask`
    given) inverted dropout of rate `dropout` follows every layer but the
    last (subgnn_tpu/models/lstm.py:168-186)."""
    out = x
    for layer in params["layers"][:-1]:
        out = _bidir_seq(layer, out)
        if keep_mask is not None and dropout > 0.0:
            out = apply_dropout(out, dropout, keep_mask)

    last = params["layers"][-1]
    if aggregator == "last":
        fwd_hs, _ = _run(last["fwd"], out, reverse=False)
        bwd_h = _single_step(last["bwd"], out[:, -1, :])
        agg = torch.cat([fwd_hs[-1], bwd_h], dim=-1)
    elif aggregator == "sum":
        _, fwd_acc = _run(last["fwd"], out, reverse=False)
        _, bwd_acc = _run(last["bwd"], out, reverse=True)
        agg = torch.cat([fwd_acc, bwd_acc], dim=-1)
    else:
        raise NotImplementedError(aggregator)
    dt = agg.dtype
    return agg @ params["head"]["w"].to(dt) + params["head"]["b"].to(dt)
