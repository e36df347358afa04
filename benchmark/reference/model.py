"""The SubGNN forward pass, its loss and Adam, in plain PyTorch.

Written from the published model (Alsentzer et al., NeurIPS 2020, and its
reference code SubGNN.py, subgraph_mpn.py) in float32, with no kernel, no
plan and no cache: the embedding table is indexed directly and its gradient
is autograd's. It reads the parameter tree in the layout the benchmark
fills (linear weights (in, out), applied as x @ w). Quirks of the reference
that the configuration keeps: the pad row of the table reads zero; a
component embeds as the sum (or max) of its padded rows; an anchor slot
that is padding sends no message but its property score is relu(bias); a
border position anchor's similarity at a pad id reads the last column; the
LSTM's "last" aggregator takes the backward direction one step from a zero
state on the last input.

`rnd`: a rounding of both operands of every matrix product, forward and
backward (None: exact float32); the control passes TF32 rounding.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

PAD = 0
Round = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _tf32(x: torch.Tensor) -> torch.Tensor:
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class _RoundIn(torch.autograd.Function):
    """An operand rounded to TF32; its gradient passes unchanged."""

    @staticmethod
    def forward(ctx, x):
        return _tf32(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundOut(torch.autograd.Function):
    """A product's output as it is; the gradient entering the product's
    backward rounded to TF32."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _tf32(g)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 explicit mantissa bits, round to nearest
    even), kept in float32: what the card's TF32 products read."""
    return _RoundIn.apply(x)


class Ops:
    """Matrix products, with both operands rounded when `rnd` is set."""

    def __init__(self, rnd: Round = None):
        self.r = rnd
        # the backward's products read the incoming gradient rounded too
        self.out = (lambda x: x) if rnd is None else _RoundOut.apply

    def mm(self, a, b):
        if self.r is None:
            return a @ b
        return self.out(self.r(a) @ self.r(b))

    def einsum(self, eq, a, b):
        if self.r is None:
            return torch.einsum(eq, a, b)
        return self.out(torch.einsum(eq, self.r(a), self.r(b)))


def lstm(p, x, ops: Ops):
    """Bidirectional one-layer LSTM over (R, T, D) walks, 'last'
    aggregator, then its linear head: (R, D)."""
    layer = p["layers"][-1]

    def run(d, seq):
        xw = ops.mm(seq, d["w_ih"]) + (d["b_ih"] + d["b_hh"])
        h = seq.new_zeros(seq.shape[0], d["w_hh"].shape[0])
        c = torch.zeros_like(h)
        for t in range(seq.shape[1]):
            g = xw[:, t] + ops.mm(h, d["w_hh"])
            i, f, gg, o = g.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
            h = torch.sigmoid(o) * torch.tanh(c)
        return h

    fwd = run(layer["fwd"], x)
    b = layer["bwd"]
    xw = ops.mm(x[:, -1], b["w_ih"]) + (b["b_ih"] + b["b_hh"])
    i, _, gg, o = xw.chunk(4, dim=-1)
    bwd = torch.sigmoid(o) * torch.tanh(torch.sigmoid(i) * torch.tanh(gg))
    return ops.mm(torch.cat([fwd, bwd], -1), p["head"]["w"]) + p["head"]["b"]


def messages(p, emb, w, layout: str, ops: Ops):
    """(aggregate (B, C, D), property scores (B, C, A)) of one channel's
    messages; w (B, C, A) the masked similarities."""
    eq = {"full": "bca,bcad->bcd", "per_subgraph": "bca,bad->bcd",
          "shared": "bca,ad->bcd"}[layout]
    agg = ops.einsum(eq, w, emb)
    proj = ops.mm(emb, p["linear_position"]["w"])[..., 0]
    if layout == "per_subgraph":
        proj = proj[:, None, :]
    return agg, torch.relu(w * proj + p["linear_position"]["b"])


def update(p, cc, agg, ops: Ops):
    return torch.relu(ops.mm(torch.cat([cc, agg], -1), p["linear"]["w"])
                      + p["linear"]["b"])


def forward(params, hp: Dict, batch: Dict, anchors: Dict,
            rnd: Round = None) -> torch.Tensor:
    """Logits (B, classes). batch: cc (B, C, L) ids; np_sim (B, C, n) hop
    distances (N or P channels); i_sim, b_sim (B, C, pool) structure sims.
    anchors: this batch's rows: neigh_int / neigh_bor (nl, B, C, A),
    pos_int (nl, B, A), pos_ext (nl, A), struc_pool_idx (nl, A_S),
    struc_int_walks / struc_bor_walks (nl, A_S, W, L)."""
    ops = Ops(rnd)
    emb = params["node_embed"]
    table = torch.cat([emb.new_zeros(1, emb.shape[1]), emb[1:]])
    cc = batch["cc"]
    B, C, _ = cc.shape
    rows = table[cc]
    init = rows.sum(2) if hp["cc_aggregator"] == "sum" else rows.max(2).values
    mask = cc[:, :, 0] != PAD
    mask3 = mask[:, :, None]
    state = {k: init for k in ("N_I", "N_B", "P_I", "P_B", "S_I", "S_B")}
    ch = params["channels"]
    if hp["use_structure"]:
        nl, A, W, T = anchors["struc_int_walks"].shape
        walks = torch.cat([anchors["struc_int_walks"],
                           anchors["struc_bor_walks"]])
        enc = lstm(params["lstm"], table[walks.reshape(-1, T)], ops)
        enc = enc.reshape(2 * nl, A, W, -1).sum(2)
        s_int, s_bor = enc[:nl], enc[nl:]
    np_sim = batch.get("np_sim")
    n = np_sim.shape[2] if np_sim is not None else 0
    outputs: List[torch.Tensor] = []
    for l in range(hp["n_layers"]):
        layer_out: List[torch.Tensor] = []
        if hp["use_neighborhood"]:
            p = ch["neighborhood"][l]
            for side, key, pk in (("int", "N_I", "internal"),
                                  ("bor", "N_B", "border")):
                ids = anchors[f"neigh_{side}"][l]                 # (B, C, A)
                sims = torch.gather(np_sim, 2, (ids - 1).clamp(0, n - 1))
                w = torch.where(ids != PAD, sims, torch.zeros_like(sims))
                agg, _ = messages(p[pk], table[ids], w, "full", ops)
                state[key] = update(p[pk], state[key], agg, ops)
            layer_out += [state["N_I"], state["N_B"]]
        if hp["use_position"]:
            p = ch["position"][l]
            ids = anchors["pos_int"][l]                           # (B, A)
            idx = (ids - 1).clamp(0, n - 1)[:, None, :].expand(B, C, -1)
            sims = torch.gather(np_sim, 2, idx)
            w = torch.where(mask3, sims, torch.zeros_like(sims))
            agg, prop_in = messages(p["internal"], table[ids], w,
                                    "per_subgraph", ops)
            state["P_I"] = update(p["internal"], state["P_I"], agg, ops)
            ids = anchors["pos_ext"][l]                           # (A,)
            sims = np_sim[:, :, torch.remainder(ids - 1, n)]
            w = torch.where(mask3, sims, torch.zeros_like(sims))
            agg, prop_out = messages(p["border"], table[ids], w, "shared",
                                     ops)
            state["P_B"] = update(p["border"], state["P_B"], agg, ops)
            layer_out += [prop_in, prop_out]
        if hp["use_structure"]:
            p = ch["structure"][l]
            pool = anchors["struc_pool_idx"][l]
            props = []
            for key, pk, sim, enc_l in (("S_I", "internal", "i_sim", s_int),
                                        ("S_B", "border", "b_sim", s_bor)):
                s = batch[sim][:, :, pool]
                w = torch.where(mask3, s, torch.zeros_like(s))
                agg, prop = messages(p[pk], enc_l[l], w, "shared", ops)
                state[key] = update(p[pk], state[key], agg, ops)
                props.append(prop)
            layer_out += props
        outputs += layer_out
    all_cc = torch.cat([init] + outputs, -1)
    x = torch.where(mask3, all_cc, torch.zeros_like(all_cc)).sum(1)
    h = params["head"]
    x = torch.relu(ops.mm(x, h["lin1"]["w"]) + h["lin1"]["b"])
    x = torch.relu(ops.mm(x, h["lin2"]["w"]) + h["lin2"]["b"])
    return ops.mm(x, h["lin3"]["w"]) + h["lin3"]["b"]


def loss(logits: torch.Tensor, labels: torch.Tensor,
         rows: Optional[int] = None) -> torch.Tensor:
    """Mean softmax cross-entropy; `rows`: over the first rows only (the
    half-batch fault)."""
    per = -torch.log_softmax(logits, -1).gather(1, labels[:, None])[:, 0]
    return per.mean() if rows is None else per[:rows].mean()


class Adam:
    """optax.adam after optax.clip_by_global_norm (when clip > 0)."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, leaves: List[torch.Tensor], lr: float, clip: float):
        self.lr, self.clip = lr, clip
        self.mu = [torch.zeros_like(x) for x in leaves]
        self.nu = [torch.zeros_like(x) for x in leaves]
        self.count = 0

    @torch.no_grad()
    def step(self, leaves: List[torch.Tensor], grads: List[torch.Tensor]):
        if self.clip > 0:
            norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
            if norm >= self.clip:
                grads = [g * (self.clip / norm).float() for g in grads]
        self.count += 1
        c1 = 1 - self.b1 ** self.count
        c2 = 1 - self.b2 ** self.count
        for x, g, m, v in zip(leaves, grads, self.mu, self.nu):
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            x.sub_(self.lr * (m / c1) / (torch.sqrt(v / c2) + self.eps))
