"""The SubGNN model: three property channels x {internal, border} x layers.

Port of subgnn_tpu/models/subgnn.py (reference: SubGNN/SubGNN.py:90-312):
the forward pass is a function of an explicit parameter tree, in the JAX
package's layout (linear weights (in, out), applied as x @ w), so weights
move between the packages unchanged (convert.params_from_jax).

Output layout per layer (reference: SubGNN.py:260-291, order preserved):
  neighborhood -> [N_in_cc (D), N_out_cc (D)]
  position     -> [P_in_prop (A_P_in), P_out_prop (A_P_out)]
  structure    -> [S_in_prop (A_S), S_out_prop (A_S)]
concatenated after the initial CC embedding (D), masked-summed over CCs,
then a 3-layer MLP head (SubGNN.py:295-310).

On a mesh with a node axis (parallel/mesh.py) `params["node_embed"]` is
this rank's rows of the table and `batch["NP_sim"]` its columns; every
read of either is a masked gather summed over the node group (`_lookup`,
`_np_columns`), which gives every rank of the group the one-process values.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..config import HParams
from ..device import resolve_device
from ..ops.embedding import embedding_gather, shard_gather
from ..parallel import mesh as MX
from . import attention as attn
from .dropout import KeepMask
from .dropout import dropout as apply_dropout
from .lstm import init_lstm_params, lstm_forward
from .mpn import init_mpn_params, mpn_messages, mpn_update, mpn_update_stacked

PAD_VALUE = 0

CHANNEL_CC_KEYS = ("N_I", "N_B", "S_I", "S_B", "P_I", "P_B")


def _uniform(generator, shape, bound):
    return (torch.rand(shape, generator=generator) * 2 - 1) * bound


def _linear_init(generator, d_in, d_out):
    b = 1.0 / d_in ** 0.5
    return {"w": _uniform(generator, (d_in, d_out), b),
            "b": _uniform(generator, (d_out,), b)}


def tree_to(tree, device):
    """Move every tensor of a nested dict/list tree to `device`."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


class SubGNNModel(nn.Module):
    """Static model definition; parameters live in an explicit tree that
    `init_params` builds and `forward` reads."""

    def __init__(self, hp: HParams, n_nodes: int, num_classes: int,
                 multilabel: bool):
        super().__init__()
        self.hp = hp
        self.n_nodes = n_nodes
        self.num_classes = num_classes
        self.multilabel = multilabel

    @property
    def hid_dim(self) -> int:
        """Readout width (reference: SubGNN.py:118-147)."""
        hp = self.hp
        d = hp.node_embed_size
        if hp.use_neighborhood:
            d += hp.n_layers * 2 * hp.node_embed_size
        if hp.use_position:
            d += (hp.n_anchor_patches_pos_in
                  + hp.n_anchor_patches_pos_out) * hp.n_layers
        if hp.use_structure:
            d += 2 * hp.n_anchor_patches_structure * hp.n_layers
        return d

    # ------------------------------------------------------------------ init

    def init_params(self, generator: torch.Generator,
                    pretrained_embeds: np.ndarray,
                    train_cc_init: Optional[Dict[str, np.ndarray]] = None,
                    device: str | torch.device = "cuda"):
        """Build (params, state) on `device`, drawing from `generator` (a CPU
        torch.Generator; the draws differ from jax.random's, so parity tests
        carry weights over with convert.params_from_jax).

        pretrained_embeds: (n_nodes, D) WITHOUT the pad row; a zero row is
        prepended and the table is padded to a multiple of 8 rows
        (reference: SubGNN.py:562-568)."""
        device = resolve_device(device)
        hp = self.hp
        D = hp.node_embed_size
        if pretrained_embeds.shape[1] != D:
            raise ValueError(f"embeddings are {pretrained_embeds.shape[1]} "
                             f"wide, hp.node_embed_size={D}")
        if pretrained_embeds.shape[0] < self.n_nodes:
            raise ValueError(
                f"pretrained embeddings have {pretrained_embeds.shape[0]} "
                f"rows < n_nodes={self.n_nodes}: stale/mismatched "
                "embedding file for this graph")
        rows = pretrained_embeds.shape[0] + 1
        aligned = -(-rows // 8) * 8
        table = torch.zeros(aligned, D)
        table[1:rows] = torch.as_tensor(pretrained_embeds, dtype=torch.float32)

        params: Dict[str, Any] = {"node_embed": table}
        state: Dict[str, Any] = {}
        channels = {}
        bn_state = {}
        for name, used in (("neighborhood", hp.use_neighborhood),
                           ("position", hp.use_position),
                           ("structure", hp.use_structure)):
            if not used:
                continue
            layers = []
            for l in range(hp.n_layers):
                layer = {"internal": init_mpn_params(generator, D),
                         "border": init_mpn_params(generator, D)}
                if hp.batch_norm:
                    for side in ("in", "out"):
                        layer[f"bn_{side}"] = {"scale": torch.ones(D),
                                               "bias": torch.zeros(D)}
                        bn_state[f"{name}_{l}_{side}"] = {
                            "mean": torch.zeros(D), "var": torch.ones(D)}
                layers.append(layer)
            channels[name] = layers
        params["channels"] = channels
        if hp.batch_norm:
            state["bn"] = bn_state
        params["lstm"] = init_lstm_params(generator, D, D, hp.lstm_n_layers)
        params["head"] = {
            "lin1": _linear_init(generator, self.hid_dim,
                                 hp.linear_hidden_dim_1),
            "lin2": _linear_init(generator, hp.linear_hidden_dim_1,
                                 hp.linear_hidden_dim_2),
            "lin3": _linear_init(generator, hp.linear_hidden_dim_2,
                                 self.num_classes)}
        if hp.ff_attn:
            bound = (6.0 / (self.hid_dim + 1)) ** 0.5
            params["attn_vector"] = _uniform(generator, (self.hid_dim,), bound)
            params["attn"] = attn.init_additive_attention(
                generator, self.hid_dim, self.hid_dim)
        if hp.trainable_cc and train_cc_init is not None:
            params["train_cc"] = {
                k: torch.as_tensor(v, dtype=torch.float32)
                for k, v in train_cc_init.items()}
        return tree_to(params, device), tree_to(state, device)

    # ------------------------------------------------------------- embedding

    @staticmethod
    def _table(params, node=None):
        # row 0 is the pad embedding and stays zero (torch padding_idx
        # semantics, reference SubGNN.py:568): on a node axis, in the shard
        # that holds it
        table = params["node_embed"].clone()
        if node is None or node.node_index == 0:
            table[0] = 0.0
        return table

    @staticmethod
    def _lookup(table, ids, plan=None, node=None):
        """table[ids]: through `plan`'s kernel backward when given; on a
        node axis (`node`, the mesh) from this rank's rows, masked, summed
        over the node group."""
        if node is not None:
            lo = node.node_index * table.shape[0]
            return MX.node_sum(shard_gather(table, ids, lo, plan), node)
        if plan is not None:
            return embedding_gather(table, ids, plan)
        return table[ids]

    @staticmethod
    def _np_columns(np_sim, idx, node=None):
        """np_sim[b, c, idx[b, c, a]] (idx (B, C, A)) or, for a 1-D idx,
        np_sim[:, :, idx]; idx in [0, n_cols). On a node axis np_sim is this
        rank's columns: masked, summed over the node group."""
        if node is None:
            return (np_sim[:, :, idx] if idx.dim() == 1
                    else torch.gather(np_sim, 2, idx))
        w = np_sim.shape[2]
        local = idx - node.node_index * w
        inside = (local >= 0) & (local < w)
        local = torch.where(inside, local, torch.zeros_like(local))
        if idx.dim() == 1:
            cols = np_sim[:, :, local].masked_fill(~inside, 0)
        else:
            cols = torch.gather(np_sim, 2, local).masked_fill(~inside, 0)
        return MX.node_sum(cols, node)

    def initialize_cc_embeddings(self, table, cc_ids, plan=None, node=None):
        """(B, C, L) ids -> (B, C, D) via sum or max INCLUDING pad zeros
        (reference: SubGNN.py:609-622 does not mask; 'max' therefore clips
        at 0 — quirk preserved). `plan` (ops/embedding.GatherPlan built from
        exactly cc_ids) routes the table gradient through the plan kernel;
        `node`: the mesh of a node-sharded table (`_lookup`)."""
        embeds = self._lookup(table, cc_ids, plan, node)          # (B,C,L,D)
        if self.hp.cc_aggregator == "sum":
            return embeds.sum(dim=2)
        if self.hp.cc_aggregator == "max":
            return embeds.max(dim=2).values
        raise NotImplementedError(self.hp.cc_aggregator)

    def _struct_anchor_embeds(self, params, table, int_walks, bor_walks,
                              keep_mask: Optional[KeepMask], node=None):
        """All structure anchor-patch embeddings in one batched LSTM call:
        (n_layers, A_S, W, L) walks -> (emb_int, emb_bor), each
        (n_layers, A_S, D), the LSTM over each walk summed over walks.
        `keep_mask` (train mode) draws the between-layer LSTM dropout."""
        nl, A_S, W, L = int_walks.shape
        walks = torch.cat([int_walks, bor_walks], dim=0)          # (2nl,A,W,L)
        walk_embeds = self._lookup(table, walks.reshape(2 * nl * A_S * W, L),
                                   node=node)
        hidden = lstm_forward(params["lstm"], walk_embeds,
                              aggregator=self.hp.lstm_aggregator,
                              dropout=self.hp.lstm_dropout,
                              keep_mask=keep_mask)
        emb = hidden.reshape(2 * nl, A_S, W, -1).sum(dim=2)
        return emb[:nl], emb[nl:]

    @staticmethod
    def _batch_norm(p, s, x, *, train: bool, moments=None):
        """BN over the flattened (B*C, D) view incl. padded rows (reference:
        SubGNN.py:267-290). Train mode normalises by the batch statistics
        and updates the running ones (variance with the unbiased factor
        n/(n-1) over n = B*C rows, subgnn_tpu/models/subgnn.py:206-220);
        eval mode uses the running ones. `moments(flat)` -> (mean, biased
        var, n) replaces the batch's own statistics (a data-parallel rank
        passes the global batch's, parallel/mesh.py:bn_moments). Returns
        (y, new_state); the state is detached."""
        B, C, D = x.shape
        flat = x.reshape(B * C, D)
        if train:
            if moments is None:
                mean = flat.mean(dim=0)
                var = flat.var(dim=0, unbiased=False)
                n = B * C
            else:
                mean, var, n = moments(flat)
            new_s = {"mean": (0.9 * s["mean"] + 0.1 * mean).detach(),
                     "var": (0.9 * s["var"] + 0.1 * var * n
                             / max(n - 1, 1)).detach()}
        else:
            mean, var = s["mean"], s["var"]
            new_s = s
        y = (flat - mean) / torch.sqrt(var + 1e-5) * p["scale"] + p["bias"]
        return y.reshape(B, C, D), new_s

    # --------------------------------------------------------------- forward

    def forward(self, params, state, batch: Dict[str, Any],
                anchors: Dict[str, Any], *, train: bool = False,
                keep_mask: Optional[KeepMask] = None,
                cc_tables: Optional[Dict[str, Any]] = None,
                bn_moments: Optional[Callable] = None,
                mesh: Optional[MX.Mesh] = None):
        """(logits (B, num_classes) float32, new_state) for one batch.

        batch: cc_ids (B,C,L) int64; subgraph_idx (B,) int64; either NP_sim
               (B,C,n_nodes) or the compact keys neigh_sims/pos_in_sims/
               pos_out_sims (train/sims.py); I_S_sim/B_S_sim (B,C,n_pool);
               optionally cc_plan/neigh_plan (train/plans.py), which route
               the embedding-table gradient through ops/embedding.
        anchors: layer-major anchor tensors (sampling/anchors.py layouts).
        train: batch-norm on batch statistics with running-stat updates in
               new_state, and dropout drawn through `keep_mask`
               (models/dropout.py), which train mode needs whenever a
               dropout rate is non-zero.
        cc_tables: 6 per-channel (N, C, D) tables when trainable_cc.
        bn_moments: train-mode batch-norm moments (`_batch_norm`); default
               the batch's own.
        mesh:  a mesh with a node axis: node_embed and NP_sim are this
               rank's shards (module docstring); ignored at n_node = 1.
        """
        hp = self.hp
        lstm_drop = (hp.use_structure and hp.lstm_dropout > 0
                     and len(params["lstm"]["layers"]) > 1)
        if train and keep_mask is None and (hp.lin_dropout > 0 or lstm_drop):
            raise ValueError("train mode with dropout needs a keep_mask "
                             "(models/dropout.generator_keep_mask)")
        if not train:
            keep_mask = None
        node = mesh if mesh is not None and mesh.sharded else None
        table = self._table(params, node)
        if hp.dtype == "bfloat16":
            # bf16 activations and matmuls, fp32 master weights; logits
            # return to fp32
            table = table.to(torch.bfloat16)
        cc_ids = batch["cc_ids"]
        sub_idx = batch["subgraph_idx"]
        B, C, _ = cc_ids.shape
        new_state = dict(state)
        bn_state = dict(state.get("bn", {}))

        init_cc = self.initialize_cc_embeddings(
            table, cc_ids, batch.get("cc_plan"), node)            # (B, C, D)
        cc_mask = cc_ids[:, :, 0] != PAD_VALUE                    # (B, C)

        if hp.use_neighborhood:
            A_n_in = hp.n_anchor_patches_N_in
            n_ids_all = torch.cat(
                [anchors["neigh_int"][:, sub_idx],
                 anchors["neigh_bor"][:, sub_idx]], dim=-1)       # (L,B,C,A)
            n_emb_all = self._lookup(table, n_ids_all,
                                     batch.get("neigh_plan"), node)

        if hp.trainable_cc and cc_tables is not None:
            ch_cc = {k: cc_tables[k][sub_idx] for k in CHANNEL_CC_KEYS}
        else:
            ch_cc = {k: init_cc for k in CHANNEL_CC_KEYS}
        N_in, N_out = ch_cc["N_I"], ch_cc["N_B"]
        P_in, P_out = ch_cc["P_I"], ch_cc["P_B"]
        S_in, S_out = ch_cc["S_I"], ch_cc["S_B"]

        if hp.use_structure:
            emb_int_all, emb_bor_all = self._struct_anchor_embeds(
                params, table, anchors["struc_int_walks"],
                anchors["struc_bor_walks"], keep_mask, node)
        # the NP similarities' whole node axis (a node rank holds 1/n_node)
        n_cols = (batch["NP_sim"].shape[2] * (1 if node is None
                                              else node.n_node)
                  if "NP_sim" in batch else 0)

        def np_sims_gather(anchor_ids):
            # sims[b,c,a] = NP_sim[b, c, anchor_id-1]; jnp clamps
            # out-of-range gathers and torch raises, so clip explicitly
            # (invalid slots are masked downstream, subgraph_mpn.py:91-94)
            idx = (anchor_ids - 1).clamp(0, n_cols - 1)
            return self._np_columns(batch["NP_sim"], idx, node)

        neigh_sims = batch.get("neigh_sims")      # (L, B, C, A_in+A_out)
        pos_in_sims = batch.get("pos_in_sims")    # (L, B, C, A_P_in)
        pos_out_sims = batch.get("pos_out_sims")  # (L, B, C, A_P_out)

        outputs = []
        # fused_channel_update: queue every channel's update linear and run
        # them as one stacked contraction per layer (same math)
        fuse = hp.fused_channel_update and hp.use_mpn_projection
        for l in range(hp.n_layers):
            pend_p, pend_cc, pend_agg = [], [], []

            def channel_update(p, cc, agg):
                if fuse:
                    pend_p.append(p)
                    pend_cc.append(cc)
                    pend_agg.append(agg)
                    return len(pend_p) - 1
                return mpn_update(p, cc, agg,
                                  use_mpn_projection=hp.use_mpn_projection)

            if hp.use_neighborhood:
                n_outputs_pos = len(outputs)
                layer_p = params["channels"]["neighborhood"][l]
                a_in = n_ids_all[l, :, :, :A_n_in]                # (B, C, A)
                a_out = n_ids_all[l, :, :, A_n_in:]
                n_sims = (neigh_sims[l] if neigh_sims is not None
                          else np_sims_gather(n_ids_all[l]))
                agg, _ = mpn_messages(
                    layer_p["internal"], n_emb_all[l, :, :, :A_n_in],
                    n_sims[:, :, :A_n_in], a_in != PAD_VALUE,
                    norm_pos_struc_embed=hp.norm_pos_struc_embed)
                N_in = channel_update(layer_p["internal"], N_in, agg)
                agg, _ = mpn_messages(
                    layer_p["border"], n_emb_all[l, :, :, A_n_in:],
                    n_sims[:, :, A_n_in:], a_out != PAD_VALUE,
                    norm_pos_struc_embed=hp.norm_pos_struc_embed)
                N_out = channel_update(layer_p["border"], N_out, agg)

            if hp.use_position:
                layer_p = params["channels"]["position"][l]
                # internal anchors shared across each subgraph's CCs, border
                # anchors across the batch (anchor_patch_samplers.py:366-379)
                A_pi = hp.n_anchor_patches_pos_in
                A_po = hp.n_anchor_patches_pos_out
                ids_in = anchors["pos_int"][l][sub_idx]           # (B, A_in)
                a_in_bc = ids_in[:, None, :].expand(B, C, A_pi)
                valid_in = cc_mask[:, :, None].expand(B, C, A_pi)
                agg, P_in_prop = mpn_messages(
                    layer_p["internal"], self._lookup(table, ids_in,
                                                      node=node),
                    (pos_in_sims[l] if pos_in_sims is not None
                     else np_sims_gather(a_in_bc)), valid_in,
                    norm_pos_struc_embed=hp.norm_pos_struc_embed,
                    layout="per_subgraph")
                P_in = channel_update(layer_p["internal"], P_in, agg)
                ids_out = anchors["pos_ext"][l]                   # (A_out,)
                # a PAD id reads the last column, as jnp's negative index
                sims_out = (pos_out_sims[l] if pos_out_sims is not None
                            else self._np_columns(
                                batch["NP_sim"],
                                torch.remainder(ids_out - 1, n_cols), node))
                valid_out = cc_mask[:, :, None].expand(B, C, A_po)
                agg, P_out_prop = mpn_messages(
                    layer_p["border"], self._lookup(table, ids_out,
                                                    node=node),
                    sims_out, valid_out,
                    norm_pos_struc_embed=hp.norm_pos_struc_embed,
                    layout="shared")
                P_out = channel_update(layer_p["border"], P_out, agg)
                outputs.extend([P_in_prop, P_out_prop])

            if hp.use_structure:
                layer_p = params["channels"]["structure"][l]
                pool_idx = anchors["struc_pool_idx"][l]           # (A_S,)
                emb_int, emb_bor = emb_int_all[l], emb_bor_all[l]  # (A_S, D)
                valid = cc_mask[:, :, None].expand(B, C, pool_idx.shape[0])
                # sims[b,c,a] = sim_matrix[b, c, pool_idx[a]]
                # (reference: subgraph_mpn.py:88,95-99)
                agg, S_in_prop = mpn_messages(
                    layer_p["internal"], emb_int,
                    batch["I_S_sim"][:, :, pool_idx], valid,
                    norm_pos_struc_embed=hp.norm_pos_struc_embed,
                    layout="shared")
                S_in = channel_update(layer_p["internal"], S_in, agg)
                agg, S_out_prop = mpn_messages(
                    layer_p["border"], emb_bor,
                    batch["B_S_sim"][:, :, pool_idx], valid,
                    norm_pos_struc_embed=hp.norm_pos_struc_embed,
                    layout="shared")
                S_out = channel_update(layer_p["border"], S_out, agg)
                outputs.extend([S_in_prop, S_out_prop])

            if fuse:
                upd = mpn_update_stacked(pend_p, pend_cc, pend_agg)
                if hp.use_neighborhood:
                    N_in, N_out = upd[N_in], upd[N_out]
                if hp.use_position:
                    P_in, P_out = upd[P_in], upd[P_out]
                if hp.use_structure:
                    S_in, S_out = upd[S_in], upd[S_out]

            if hp.use_neighborhood:
                layer_p = params["channels"]["neighborhood"][l]
                if hp.batch_norm:
                    N_in, bn_state[f"neighborhood_{l}_in"] = self._batch_norm(
                        layer_p["bn_in"], bn_state[f"neighborhood_{l}_in"],
                        N_in, train=train, moments=bn_moments)
                    N_out, bn_state[f"neighborhood_{l}_out"] = \
                        self._batch_norm(
                            layer_p["bn_out"],
                            bn_state[f"neighborhood_{l}_out"], N_out,
                            train=train, moments=bn_moments)
                outputs[n_outputs_pos:n_outputs_pos] = [N_in, N_out]

        all_cc = torch.cat([init_cc] + outputs, dim=-1)          # (B, C, hid)

        if hp.ff_attn:
            batched_attn = params["attn_vector"][None, :].expand(
                B, self.hid_dim)
            weights = attn.additive_attention(params["attn"], batched_attn,
                                              all_cc, cc_mask)
            sg_embed = attn.weighted_sum(all_cc, weights)
        else:
            sg_embed = attn.masked_sum(all_cc, cc_mask[:, :, None], axis=1)

        # 3-layer head with optional dropout (reference: SubGNN.py:306-310)
        h = params["head"]
        dt = sg_embed.dtype
        x = torch.relu(sg_embed @ h["lin1"]["w"].to(dt) + h["lin1"]["b"].to(dt))
        if train and hp.lin_dropout > 0:
            x = apply_dropout(x, hp.lin_dropout, keep_mask, batch_axis=0)
        x = torch.relu(x @ h["lin2"]["w"].to(dt) + h["lin2"]["b"].to(dt))
        if train and hp.lin_dropout > 0:
            x = apply_dropout(x, hp.lin_dropout, keep_mask, batch_axis=0)
        logits = (x @ h["lin3"]["w"].to(dt)
                  + h["lin3"]["b"].to(dt)).to(torch.float32)
        if hp.batch_norm:
            new_state["bn"] = bn_state
        return logits, new_state

    # ------------------------------------------------------------------ loss

    def loss_fn(self, logits, labels, valid=None, n_valid=None):
        """BCE-with-logits (multilabel) or softmax CE
        (reference: SubGNN.py:169-172,337-342). `valid` masks padded rows of
        short eval batches. `n_valid`: the count the masked sum is divided
        by (default the valid rows here, at least 1); a data-parallel rank
        passes its global batch's, so that the ranks' losses sum to the
        batch's mean (and a rank with no valid rows gives 0)."""
        if self.multilabel:
            lab = labels.to(logits.dtype)
            per = (torch.clamp_min(logits, 0) - logits * lab
                   + torch.log1p(torch.exp(-logits.abs())))
            per = per.mean(dim=-1)
        else:
            logp = torch.log_softmax(logits, dim=-1)
            per = -torch.gather(logp, 1, labels[:, None].long())[:, 0]
        if valid is None:
            return per.mean()
        w = valid.to(per.dtype)
        if n_valid is not None:
            return (per * w).sum() / n_valid
        return (per * w).sum() / w.sum().clamp_min(1.0)
