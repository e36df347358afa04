"""Training loop: the step, Adam, evaluation, top-k checkpoints.

Port of subgnn_tpu/train/loop.py (reference runtime: pl.Trainer with Adam,
global-norm gradient clipping, per-epoch validation, top-3 checkpointing on
the monitored metric, SubGNN/train_config.py:109-158,
SubGNN/SubGNN.py:317-504,1156-1161), with the data axis of its mesh.

Parameters are the model's explicit tree of tensors (JAX layout). A step
runs the training forward, the loss, `torch.autograd.grad` over the
trainable leaves (the embedding-table gradient goes through the plan kernel
of ops/embedding.py when the batch carries plans), and `Adam.step`, which
updates the leaves in place and keeps its step count on the device.

`Trainer.fit` picks one of the JAX trainer's two modes by its rules
(loop.py:431-462):
  * fused (the default whenever every batch is full, `debug_mode` is off
    and the resident splits take under 1 GiB): both splits stay on the
    device, each step gathers its batch there from an index row, the host
    draws an epoch's order and copies it to the device in one go, and each
    train and eval step is one replay of a CUDA graph (train/graphs.py) fed
    by device-to-device copies into its static buffers. Each train step
    builds its batch's gather plans inside the step (`plans_on_device`),
    except on a node axis, whose host builds them an epoch at a time,
    stacked, with the order. The compact similarities are gathered inside
    the step from NP sims kept on the device (`sims_on_device`), or, where
    those stay on the host (a node axis, or NP sims over half the card's
    free memory), built by the host with the order. Losses are read once
    an epoch; the host prepares epoch e+1 while the device runs epoch e.
    On the CPU the same path calls the step instead of replaying it;
  * streaming: one host batch per step, copied to the device, the loss
    read after each step; `debug_mode` streams, records each step's global
    gradient norm and raises FloatingPointError on a non-finite loss or
    gradient.
`fit` also takes the JAX trainer's per-epoch hooks (TensorBoard scalars,
`metrics_callback`, `on_epoch_end` anchor resampling), resumes from a
checkpoint (`resume_from`) and traces itself with torch.profiler into
`profile_dir`; `lr_find` is the LR range test.

On a mesh (`Trainer(mesh=...)`, or the hparams' mesh_data_axis and
mesh_node_axis through parallel/mesh.py:mesh_from_hparams) every rank runs
this same loop over the same epoch orders. Data index d computes rows
[d*b, (d+1)*b) of each batch with its own gather plans, and the step sums
the gradients over the data group before Adam (inside the captured step in
the fused mode), with batch norm's moments, dropout masks and the loss those
of the whole batch (`loss_and_grads`): the fit is the one-process fit. On a
node axis node index k holds rows `shard_rows` of the embedding table (and
Adam's moments of them) and, in the non-compact mode, columns `shard_cols`
of the NP similarities; its plans route its rows alone, the forward sums
its gathers over the node group (models/subgnn.py), and the gradient
clipping norm takes the table's squared sum over the node group. Eval
logits are gathered to every rank before the metrics, so every rank makes
the same checkpoint and early-stop decisions; every rank gathers the whole
table and its moments before each checkpoint (`whole_params`), and rank 0
alone writes checkpoints, TensorBoard scalars and log lines.
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..config import HParams
from ..convert import tree_from_numpy
from ..device import resolve_device
from ..models.dropout import KeepMask, generator_keep_mask
from ..models.subgnn import SubGNNModel
from ..ops.embedding import GatherPlan
from ..parallel import mesh as MX
from . import metrics as M
from .checkpoint import (TopKCheckpoints, load_checkpoint,
                         load_params_filtered)
from .graphs import StepGraph
from .plans import PlanBuilder, batch_plans, device_batch_plans, epoch_plans
from .sims import (compact_sims_for_batch, device_compact_sims,
                   epoch_compact_sims)
from .spans import Spans, begin_fit
from .tb_writer import TBWriter

# combined NP-sim bytes (train+val) above which streaming batches carry
# host-gathered anchor-column similarities (train/sims.py) instead of
# (B, C, n_nodes) rows; the fused mode carries them at every size
COMPACT_NP_SIM_BYTES = 256 << 20
# resident bytes of both splits under which fit takes the fused mode
FUSED_RESIDENT_BYTES = 1 << 30


def _free_device_bytes(device: torch.device) -> Optional[int]:
    """Free memory of a CUDA device, or None where the arrays stay in the
    host's memory (the CPU)."""
    if device.type != "cuda":
        return None
    return torch.cuda.mem_get_info(device)[0]


def sims_fit_on_device(np_bytes: int, device: torch.device,
                       mesh: Optional[MX.Mesh]) -> bool:
    """Whether a fused fit with compact sims keeps both splits' NP sims
    (`np_bytes` together) on the device and gathers each step's anchor
    columns there: off a node axis (whose ranks hold slices of the
    columns), where they take at most half the device's free memory."""
    if mesh is not None and mesh.sharded:
        return False
    free = _free_device_bytes(device)
    return free is None or np_bytes <= free // 2


def plans_fit_on_device(row_range: Optional[tuple]) -> bool:
    """Whether a fused fit's train steps build their own gather plans on the
    device (train/plans.py:device_batch_plans): off a node axis, whose
    ranks' plans route their rows of the table alone (`row_range`) and are
    built by the host."""
    return row_range is None


def mpn_edges_per_step(hp: HParams, batch_size: int, max_n_cc: int) -> int:
    """Anchor-patch -> CC message edges processed by one training step (the
    unit of fit's per-epoch `train_edges_per_s`)."""
    per_layer = 0
    if hp.use_neighborhood:
        per_layer += hp.n_anchor_patches_N_in + hp.n_anchor_patches_N_out
    if hp.use_position:
        per_layer += hp.n_anchor_patches_pos_in + hp.n_anchor_patches_pos_out
    if hp.use_structure:
        per_layer += 2 * hp.n_anchor_patches_structure
    return batch_size * max_n_cc * per_layer * hp.n_layers


def node_gathers_per_step(hp: HParams, rows: int, max_n_cc: int,
                          cc_len: int, compact: bool) -> tuple:
    """(table ids, NP-similarity values) that one forward over `rows` batch
    rows gathers from a node-sharded table and NP sims, i.e. what its
    node-group sums carry (parallel/mesh.py:node_sum): the CC ids, the
    neighborhood anchors, the structure walks and the position anchors, and
    without compact sims the neighborhood and position anchors' columns."""
    nl, C = hp.n_layers, max_n_cc
    ids = rows * C * cc_len
    cols = 0
    if hp.use_neighborhood:
        a = hp.n_anchor_patches_N_in + hp.n_anchor_patches_N_out
        ids += nl * rows * C * a
        cols += nl * rows * C * a
    if hp.use_structure:
        ids += (2 * nl * hp.n_anchor_patches_structure
                * hp.n_triangular_walks * hp.random_walk_len)
    if hp.use_position:
        ids += nl * (rows * hp.n_anchor_patches_pos_in
                     + hp.n_anchor_patches_pos_out)
        cols += nl * rows * C * (hp.n_anchor_patches_pos_in
                                 + hp.n_anchor_patches_pos_out)
    return ids, 0 if compact else cols


def copy_tree(tree, device):
    """A nested dict/list tree of tensors copied to `device` as new leaves
    (detached, never sharing storage with the caller's)."""
    if isinstance(tree, dict):
        return {k: copy_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [copy_tree(v, device) for v in tree]
    return tree.detach().to(device).clone()


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves of a nested dict/list tree, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


class Adam:
    """optax.adam(lr) (b1=0.9, b2=0.999, eps=1e-8), after
    optax.clip_by_global_norm(grad_clip) when grad_clip > 0, over every
    parameter leaf except the top-level keys in `frozen`, which get no
    gradient, no moments and no update (subgnn_tpu/train/loop.py:50-63).

    Clipping follows optax's formula, g * max/||g|| when ||g|| >= max
    (torch's clip_grad_norm_ adds 1e-6 to the norm); the bias corrections
    are taken in float32 as optax takes them. The step count is an int64
    tensor on the parameters' device and the corrections are computed
    there, so a captured step (train/graphs.py) corrects each replay by its
    own count; `host_state` gives the int count a checkpoint stores.
    """

    b1, b2, eps = 0.9, 0.999, 1e-8
    weight_decay = 0.0

    def __init__(self, lr: float, grad_clip: float = 0.0, frozen: tuple = ()):
        self.lr, self.grad_clip, self.frozen = lr, grad_clip, tuple(frozen)
        # the clipping norm; a node-axis trainer sets its sharded form
        self.norm = global_norm

    def trainable(self, params) -> List[torch.Tensor]:
        return [x for k, v in params.items() if k not in self.frozen
                for x in tree_leaves(v)]

    def init(self, params, saved=None) -> Dict[str, Any]:
        """Zero moments for the trainable leaves, or the moments and count
        of `saved` (the opt_state of a checkpoint this class wrote) on the
        leaves' devices; marks those leaves as requiring grad and the
        frozen ones as not."""
        for k, v in params.items():
            for x in tree_leaves(v):
                x.requires_grad_(k not in self.frozen)
        leaves = self.trainable(params)
        dev = leaves[0].device if leaves else None

        def count(n):
            return torch.tensor(n, dtype=torch.int64, device=dev)
        if saved is None:
            return {"count": count(0),
                    "mu": [torch.zeros_like(x) for x in leaves],
                    "nu": [torch.zeros_like(x) for x in leaves]}
        if not (isinstance(saved, dict) and set(saved) == {"count", "mu", "nu"}
                and len(saved["mu"]) == len(saved["nu"]) == len(leaves)):
            raise ValueError(
                "the checkpoint's optimizer state is not this Adam's over "
                "these parameters (a checkpoint written by the JAX package "
                "holds optax state, which cannot be resumed; restore its "
                "weights with restore_path / -restoreModelName instead)")

        def put(arrays):
            return [torch.as_tensor(np.asarray(a), dtype=x.dtype,
                                    device=x.device)
                    for a, x in zip(arrays, leaves)]
        return {"count": count(int(saved["count"])), "mu": put(saved["mu"]),
                "nu": put(saved["nu"])}

    @staticmethod
    def host_state(opt_state: Dict[str, Any]) -> Dict[str, Any]:
        """opt_state with its count as a Python int (what a checkpoint
        stores; reading it waits for the device)."""
        return dict(opt_state, count=int(opt_state["count"]))

    @torch.no_grad()
    def step(self, params, grads: List[torch.Tensor],
             opt_state: Dict[str, Any]) -> None:
        """Update the trainable leaves of `params` in place; `grads` are
        theirs, in `trainable` order (overwritten: clipped in place, each
        leaf's once, where one tensor is two leaves' gradient)."""
        leaves = self.trainable(params)
        if self.grad_clip and self.grad_clip > 0:
            norm = self.norm(grads)
            scale = torch.where(norm < self.grad_clip,
                                torch.ones_like(norm), self.grad_clip / norm)
            torch._foreach_mul_(_unique(grads), scale)
        mu, nu = opt_state["mu"], opt_state["nu"]
        opt_state["count"].add_(1)
        count = opt_state["count"].to(torch.float32)
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - self.b2)
        bc1 = 1 - torch.pow(self.b1, count)      # float32, on the device
        bc2 = 1 - torch.pow(self.b2, count)
        mu_hat = torch._foreach_div(mu, bc1)
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu_hat, denom)
        if self.weight_decay:          # optax.add_decayed_weights (AdamW)
            torch._foreach_add_(upd, leaves, alpha=self.weight_decay)
        torch._foreach_mul_(upd, -self.lr)
        torch._foreach_add_(leaves, upd)


def _unique(grads: List[torch.Tensor]) -> List[torch.Tensor]:
    """`grads` with each tensor (the same elements) once, for an in-place
    update that must scale each leaf's gradient once: autograd can hand one
    tensor to two leaves (the LSTM's `b_ih + b_hh` gives both biases the
    sum's gradient)."""
    seen, out = set(), []
    for g in grads:
        key = (g.data_ptr(), g.shape, g.stride())
        if key not in seen:
            seen.add(key)
            out.append(g)
    return out


def global_norm(grads: List[torch.Tensor],
                shard: Optional[tuple] = None) -> torch.Tensor:
    """optax.global_norm: the L2 norm of all leaves together. `shard`:
    (mesh, i) when leaf i is this rank's shard of a node-sharded leaf: its
    squared sum is summed over the node group, so that every rank gets the
    whole leaf's norm and counts each replicated leaf once."""
    norms = torch.stack(torch._foreach_norm(grads))
    if shard is not None:
        mesh, i = shard
        sq = norms[i:i + 1].square()
        MX.all_reduce_node_([sq], mesh)
        norms = torch.cat([norms[:i], sq.sqrt(), norms[i + 1:]])
    return torch.linalg.vector_norm(norms)


def make_optimizer(hp: HParams) -> Adam:
    """Adam + optional global-norm clipping; node embeddings frozen when
    freeze_node_embeds (reference: SubGNN.py:568,1156-1161)."""
    return Adam(hp.learning_rate, hp.grad_clip,
                frozen=("node_embed",) if hp.freeze_node_embeds else ())


def device_batch(batch: Dict[str, Any], device) -> Dict[str, Any]:
    """Host batch (numpy arrays, GatherPlans) -> tensors on `device`:
    integer arrays as int64, floats as float32, masks as bool."""
    out = {}
    for k, v in batch.items():
        if v is None:
            continue
        if isinstance(v, GatherPlan):
            out[k] = v.to(device)
            continue
        a = np.require(v, requirements="W")        # torch wants writable
        t = torch.as_tensor(a, device=device)
        if a.dtype.kind in "iu":
            t = t.long()
        elif a.dtype.kind == "f":
            t = t.float()
        out[k] = t
    return out


def loss_and_grads(model: SubGNNModel, tx: Adam, params, state, batch,
                   anchors, keep_mask: Optional[KeepMask] = None,
                   mesh: Optional[MX.Mesh] = None,
                   n_valid: Optional[int] = None):
    """Training forward, loss and gradients of the trainable leaves.
    Returns (loss, logits, new_state, grads), the first two detached.

    On a `mesh`, `batch` is this rank's rows and `n_valid` the whole
    batch's valid rows: the loss is this rank's masked sum over n_valid
    (the ranks' losses sum to the batch's mean; a rank with no valid row
    gives 0), batch norm takes the whole batch's moments
    (parallel/mesh.py:bn_moments), and the gradients are summed over the
    data group (`all_reduce_sum_`), so every rank gets the one-process
    batch's gradients (on a node axis, of its table rows), as the JAX
    step's psum gives them."""
    bn_moments = (None if mesh is None
                  else lambda flat: MX.bn_moments(flat, mesh))
    logits, new_state = model(params, state, batch, anchors, train=True,
                              keep_mask=keep_mask,
                              cc_tables=params.get("train_cc"),
                              bn_moments=bn_moments, mesh=mesh)
    loss = model.loss_fn(logits, batch["label"], batch["valid"], n_valid)
    # leaves the forward does not reach get zero gradients, as in jax.grad
    grads = list(torch.autograd.grad(loss, tx.trainable(params),
                                     allow_unused=True,
                                     materialize_grads=True))
    if mesh is not None:
        MX.all_reduce_sum_(grads, mesh)
    return loss.detach(), logits.detach(), new_state, grads


def train_step(model: SubGNNModel, tx: Adam, params, opt_state, state,
               batch, anchors, keep_mask: Optional[KeepMask] = None,
               mesh: Optional[MX.Mesh] = None,
               n_valid: Optional[int] = None):
    """One step (subgnn_tpu/train/loop.py:104-118): forward + loss +
    backward (+ the gradients' sum over a mesh's ranks, `loss_and_grads`)
    + Adam; params and opt_state are updated in place. Returns (loss,
    logits, new_state) without synchronising with the device."""
    loss, logits, new_state, grads = loss_and_grads(
        model, tx, params, state, batch, anchors, keep_mask, mesh, n_valid)
    tx.step(params, grads, opt_state)
    return loss, logits, new_state


class Trainer:
    def __init__(self, model: SubGNNModel, hp: HParams,
                 ckpt_dir: Optional[str] = None,
                 monitor: str = "val_micro_f1", checkpoint_k: int = 3,
                 eval_cc_tables: Optional[Dict[str, Any]] = None,
                 tb_dir: Optional[str] = None,
                 device: str | torch.device = "cuda",
                 mesh: Optional[MX.Mesh] = None):
        self.model = model
        self.hp = hp
        self.device = resolve_device(device)
        # the data axis of the JAX trainer's mesh (loop.py:77): given, or
        # from mesh_data_axis / mesh_node_axis (None: one process)
        self.mesh = (mesh if mesh is not None
                     else MX.mesh_from_hparams(hp, device=self.device))
        if self.mesh is not None:
            self._check_mesh()
        self.monitor = monitor
        lead = self.mesh is None or self.mesh.lead
        # every rank of a node axis gathers what rank 0 saves
        self._saving = bool(ckpt_dir)
        self.ckpt = (TopKCheckpoints(ckpt_dir, checkpoint_k, monitor)
                     if ckpt_dir and lead else None)
        self.tb = TBWriter(tb_dir) if tb_dir and lead else None
        self.metric_scores: List[Dict[str, Any]] = []
        self.eval_cc_tables = eval_cc_tables or {}
        self.tx = make_optimizer(hp)
        self.params = self.state = self.opt_state = None
        self.global_step = 0
        self._resume: Optional[Dict[str, Any]] = None
        # None = chosen by fit (the JAX rules); set True/False to force
        self.compact_sims: Optional[bool] = None
        self.fused: Optional[bool] = None      # the mode of the last fit
        self._sims_on_device: Optional[bool] = None
        self._plans_on_device: Optional[bool] = None
        self._grad_norms: List[float] = []     # debug_mode, per step
        self._graphs: List[StepGraph] = []
        # the last fit's spans and counters (train/spans.py)
        self.spans = Spans()
        # this rank's [lo, hi) of the table on a node axis (set by fit)
        self._rows: Optional[tuple] = None
        # (shape, bytes) of what the last fit held on the device: the
        # table, Adam's moments of it, the NP sims (resident, or a batch's)
        self.held: Dict[str, Any] = {}

    @property
    def sims_on_device(self) -> Optional[bool]:
        """Whether the last fit kept the NP sims on the device and its
        steps gathered their compact sims there (`sims_fit_on_device`);
        None before a fit."""
        return self._sims_on_device

    @property
    def plans_on_device(self) -> Optional[bool]:
        """Whether the last fit's train steps built their gather plans on
        the device (a fused fit, `plans_fit_on_device`); None before a
        fit."""
        return self._plans_on_device

    def _check_mesh(self) -> None:
        """The JAX trainer's checks (loop.py:411-416), and the trainer's
        device as the mesh's."""
        mesh, B = self.mesh, self.hp.batch_size
        if B % mesh.n_data:
            raise ValueError(f"batch_size {B} must divide over the 'data' "
                             f"mesh axis ({mesh.n_data})")
        if mesh.device.type != self.device.type or (
                self.device.index is not None
                and mesh.device != self.device):
            raise ValueError(f"the trainer's device {self.device} is not "
                             f"its mesh's ({mesh.device})")
        self.device = mesh.device

    # ---------------------------------------------------------------- steps

    @torch.no_grad()
    def eval_step(self, batch, anchors, cc_tables):
        """(loss, logits) of a whole batch; on a mesh each rank runs its
        rows and the logits are gathered to every rank."""
        local = batch if self.mesh is None else MX.shard_batch(batch,
                                                                self.mesh)
        logits, _ = self.model(self.params, self.state, local, anchors,
                               train=False, cc_tables=cc_tables,
                               mesh=self.mesh)
        if self.mesh is not None:
            logits = MX.all_gather_rows(logits, self.mesh)
        return self.model.loss_fn(logits, batch["label"], batch["valid"]), \
            logits

    @staticmethod
    def _epoch_order(n, batch_size, rng_np, drop_last):
        """(n_batches, B) shuffled subgraph indices, one shuffle of
        arange(n) per epoch exactly as the JAX trainer draws it; a short
        final batch is padded with index 0 (masked by `valid`)."""
        order = np.arange(n)
        rng_np.shuffle(order)
        n_batches = n // batch_size if drop_last else -(-n // batch_size)
        if n_batches == 0:
            return None
        take = order[: n_batches * batch_size]
        if len(take) < n_batches * batch_size:
            take = np.concatenate(
                [take, np.zeros(n_batches * batch_size - len(take), np.int64)])
        return take.reshape(n_batches, batch_size).astype(np.int32)

    @staticmethod
    def _split_bytes(data) -> int:
        """Bytes of a split's arrays that the fused mode keeps resident."""
        return sum(getattr(data, name).nbytes
                   for name in ("cc_ids", "NP_sim", "I_S_sim", "B_S_sim")
                   if getattr(data, name) is not None)

    @staticmethod
    def _device_split(data, device, include_np_sim: bool,
                      mesh: Optional[MX.Mesh] = None) -> Dict[str, Any]:
        """A whole split's arrays on `device`, once (fused mode); on a node
        axis, this rank's columns of the NP sims (`split_pspecs`)."""
        np_sim = data.NP_sim if include_np_sim else None
        if np_sim is not None and mesh is not None and mesh.sharded:
            lo, hi = mesh.shard_cols(np_sim.shape[2])
            np_sim = np_sim[:, :, lo:hi]
        return device_batch({
            "cc_ids": data.cc_ids, "label": data.labels, "NP_sim": np_sim,
            "I_S_sim": data.I_S_sim, "B_S_sim": data.B_S_sim}, device)

    @staticmethod
    def _gather_batch(split_arrays, idx, valid) -> Dict[str, Any]:
        """The batch at index row `idx`, gathered on the device."""
        batch = {k: v[idx] for k, v in split_arrays.items()}
        batch["subgraph_idx"] = idx
        batch["valid"] = valid
        return batch

    # ----------------------------------------------------------------- eval

    def _use_compact(self, data) -> bool:
        if data.NP_sim is None:
            return False
        if self.compact_sims is None:
            return data.NP_sim.nbytes > COMPACT_NP_SIM_BYTES
        return bool(self.compact_sims)

    def evaluate(self, data, anchors, split: str = "val") -> Dict[str, Any]:
        """Run the eval loop and aggregate metrics with the reference's key
        names (reference: SubGNN.py:408-504). `anchors`: the split's host
        anchor arrays. On a mesh every rank takes part and gets the same
        metrics (`eval_step`)."""
        hp, dev = self.hp, self.device
        compact = self._use_compact(data)
        anchors_dev = device_batch(anchors, dev)
        cc_tables = None
        if hp.trainable_cc:
            cc_tables = self.eval_cc_tables.get(split,
                                                self.params.get("train_cc"))
            cc_tables = {k: torch.as_tensor(v, device=dev)
                         for k, v in cc_tables.items()}
        logits_all, labels_all, losses, accs, f1s = [], [], [], [], []
        for batch in data.batches(hp.batch_size, shuffle=False,
                                  drop_last=False,
                                  include_np_sim=not compact):
            valid = batch["valid"]
            if compact:
                batch.update(compact_sims_for_batch(
                    data.NP_sim, anchors, hp, batch["subgraph_idx"]))
            loss, logits = self.eval_step(device_batch(batch, dev),
                                          anchors_dev, cc_tables)
            logits = logits.cpu().numpy()[valid]
            labels = batch["label"][valid]
            logits_all.append(logits)
            labels_all.append(labels)
            losses.append(float(loss))
            accs.append(M.calc_accuracy(logits, labels, self.model.multilabel))
            f1s.append(M.calc_f1(logits, labels, "macro",
                                 self.model.multilabel))
        return self._metrics(split, np.concatenate(logits_all),
                             np.concatenate(labels_all), losses, accs, f1s)

    def _metrics(self, split, logits, labels, losses, accs, f1s):
        ml = self.model.multilabel
        p = split  # metric key prefix
        auroc, per_class = M.roc_auc_ovr(logits, labels, ml)
        out = {
            f"{p}_loss": float(np.mean(losses)),
            f"{p}_micro_f1": M.calc_f1(logits, labels, "micro", ml),
            f"{p}_macro_f1": M.calc_f1(logits, labels, "macro", ml),
            f"{p}_acc": M.calc_accuracy(logits, labels, ml),
            f"avg_{p}_acc": float(np.mean(accs)),
            f"{'avg_macro_f1' if p == 'val' else p + '_avg_macro_f1'}":
                float(np.mean(f1s)),
            f"{p}_auroc": auroc,
        }
        for c, v in enumerate(per_class):
            out[f"{p}_auroc_class_{c}"] = v
        return out

    # ------------------------------------------------------------------ fit

    # ----------------------------------------------------- the node axis

    def _own_rows(self, params):
        """`params` with its table cut to this rank's rows (a new dict; the
        caller's is untouched), or `params` itself off a node axis."""
        if self._rows is None:
            return params
        lo, hi = self._rows
        return dict(params, node_embed=params["node_embed"][lo:hi])

    def _table_leaf(self, params) -> Optional[int]:
        """The table's index among the trainable leaves (tx.trainable's
        order), or None when it is frozen."""
        i = 0
        for k, v in params.items():
            if k in self.tx.frozen:
                continue
            if k == "node_embed":
                return i
            i += len(tree_leaves(v))
        return None

    def _own_moments(self, saved, whole_params):
        """A checkpoint's Adam state with the table's moments cut to this
        rank's rows."""
        i = self._table_leaf(whole_params)
        if self._rows is None or i is None or not isinstance(saved, dict) \
                or not {"mu", "nu"} <= set(saved):
            return saved
        lo, hi = self._rows
        cut = {}
        for k in ("mu", "nu"):
            cut[k] = list(saved[k])
            if i < len(cut[k]):
                cut[k][i] = np.asarray(cut[k][i])[lo:hi]
        return dict(saved, **cut)

    def whole_params(self):
        """(params, opt_state) with the whole table and its whole moments:
        on a node axis gathered over the node group (a collective: every
        rank of the group calls it), else the trees themselves."""
        if self._rows is None:
            return self.params, self.opt_state
        mesh = self.mesh
        params = dict(self.params, node_embed=MX.all_gather_node(
            self.params["node_embed"].detach(), mesh))
        opt_state = self.opt_state
        i = self._table_leaf(self.params)
        if i is not None:
            opt_state = dict(opt_state)
            for k in ("mu", "nu"):
                opt_state[k] = list(opt_state[k])
                opt_state[k][i] = MX.all_gather_node(opt_state[k][i], mesh)
        return params, opt_state

    def load_weights(self, path, payload=None) -> None:
        """A checkpoint's weights (load_params_filtered: the leaves whose
        path and shape match) and model state into the trained trees; on a
        node axis, this rank's rows of the checkpoint's whole table."""
        payload = load_checkpoint(path) if payload is None else payload
        saved = payload["params"]
        if self._rows is not None:
            whole = self.params["node_embed"].shape[0] * self.mesh.n_node
            if np.shape(saved.get("node_embed"))[:1] == (whole,):
                payload = dict(payload, params=self._own_rows(saved))
        self.params = load_params_filtered(path, self.params,
                                           payload=payload)
        if payload.get("state") is not None:
            self.state = tree_from_numpy(payload["state"], self.device)

    def _hold(self, name: str, t: Optional[torch.Tensor]) -> None:
        if t is not None:
            self.held[name] = (tuple(t.shape), t.numel() * t.element_size())

    def resume_from(self, ckpt_path) -> int:
        """Restore params/state/opt_state, the step count and the dropout
        generator's position from a checkpoint at the next fit(); returns
        the epoch to continue from (subgnn_tpu/train/loop.py:352-359)."""
        payload = load_checkpoint(ckpt_path)
        self._resume = payload
        return int(payload["meta"].get("epoch", -1)) + 1

    def fit(self, params, state, train_data, val_data,
            anchors_by_split: Dict[str, Any], seed: int = 0,
            on_epoch_end: Optional[Callable[[int], Dict[str, Any]]] = None,
            log_fn: Optional[Callable[[str], None]] = print,
            start_epoch: int = 0,
            metrics_callback: Optional[
                Callable[[int, Dict[str, Any]], None]] = None,
            profile_dir: Optional[str] = None) -> Dict[str, Any]:
        """Train epochs start_epoch .. hp.max_epochs - 1, validating after
        every epoch, in the fused or the streaming mode (module docstring;
        `self.fused` says which, `self.fused_captures` how many step graphs
        were captured). Returns the last epoch's metrics; per-epoch metrics
        are in self.metric_scores. The caller's trees and anchor dict are
        copied, never updated. Dropout masks come from a torch.Generator
        seeded with `seed` (different bits from the JAX run's); both modes
        draw the same masks and the same epoch orders.

        After each epoch, in the JAX trainer's order (loop.py:636-664): TB
        scalars, the top-k checkpoint (with the generator's state), the
        log line, metrics_callback(epoch, metrics) (may raise, e.g.
        TrialPruned), then on_epoch_end(epoch), whose anchors replace the
        train/val anchors for the next epoch (in the fused mode they are
        copied into the steps' anchor buffers). After resume_from, the
        checkpoint's params, state, Adam state, step count and generator
        state replace the given ones, the epoch-order draws of epochs before
        start_epoch are skipped, and on_epoch_end(start_epoch - 1) gives the
        anchors the interrupted run trained start_epoch on (the JAX trainer
        restarts from the caller's anchors there), so the resumed run
        continues the uninterrupted trajectory. `profile_dir`: trace the
        fit with torch.profiler (CPU, and CUDA on the card) into that
        directory, in TensorBoard's layout.

        `self.spans` records the fit's spans and counters per epoch
        (train/spans.py, which names them); a metric's `epoch_time_s` is
        its epoch's train and eval phases on their clock."""
        with _profiler(profile_dir, self.device):
            return self._fit(params, state, train_data, val_data,
                             anchors_by_split, seed, on_epoch_end, log_fn,
                             start_epoch, metrics_callback)

    def _select_mode(self, train_data, val_data, drop_last: bool):
        """(fused, compact) by the JAX trainer's rules (loop.py:441-462):
        fused when every batch is full, debug_mode is off and the resident
        splits (without the NP sims when compact) take under 1 GiB; compact
        sims by default whenever fused is possible, else by NP-sim size."""
        np_bytes = sum(d.NP_sim.nbytes for d in (train_data, val_data)
                       if d.NP_sim is not None)
        fused_possible = drop_last and not self.hp.debug_mode
        auto_compact = self.compact_sims is None
        if auto_compact:
            self.compact_sims = (fused_possible
                                 or np_bytes > COMPACT_NP_SIM_BYTES)
        compact = self._use_compact(train_data)
        resident = (self._split_bytes(train_data)
                    + self._split_bytes(val_data)
                    - (np_bytes if compact else 0))
        fused = fused_possible and resident < FUSED_RESIDENT_BYTES
        if auto_compact and not fused:
            self.compact_sims = np_bytes > COMPACT_NP_SIM_BYTES
            compact = self._use_compact(train_data)
        return fused, compact

    def _fit(self, params, state, train_data, val_data, anchors_by_split,
             seed, on_epoch_end, log_fn, start_epoch, metrics_callback):
        hp, dev = self.hp, self.device
        self.metric_scores = []
        self._grad_norms = []
        self._graphs = []
        self.spans = begin_fit()
        if self.ckpt:
            self.ckpt.kept = []
        generator = torch.Generator(device=dev).manual_seed(seed)
        mesh = self.mesh
        lead = mesh is None or mesh.lead
        resume, self._resume = self._resume, None
        whole = params if resume is None else resume["params"]
        rows = int(whole["node_embed"].shape[0])
        # raises where the rows do not divide (the JAX trainer asserts)
        self._rows = (mesh.shard_rows(rows)
                      if mesh is not None and mesh.sharded else None)
        if resume is None:
            self.params = copy_tree(self._own_rows(params), dev)
            self.state = copy_tree(state, dev)
            self.opt_state = self.tx.init(self.params)
            self.global_step = 0
        else:
            self.params = tree_from_numpy(self._own_rows(resume["params"]),
                                          dev)
            self.state = tree_from_numpy(resume["state"] or {}, dev)
            self.opt_state = self.tx.init(
                self.params, self._own_moments(resume["opt_state"], whole))
            self.global_step = int(resume["meta"].get("global_step", 0))
            rng_state = resume.get("rng_state")
            if rng_state is not None:
                rng_state = torch.as_tensor(np.asarray(rng_state))
                if rng_state.numel() != generator.get_state().numel():
                    raise ValueError(
                        "the checkpoint's dropout generator state was saved "
                        f"on another device type than {dev.type}")
                generator.set_state(rng_state)
        table = self._table_leaf(self.params)
        self.tx.norm = (functools.partial(global_norm, shard=(mesh, table))
                        if self._rows is not None and table is not None
                        else global_norm)
        self.held = {}
        self._hold("node_embed", self.params["node_embed"])
        if table is not None:
            self._hold("mu", self.opt_state["mu"][table])
            self._hold("nu", self.opt_state["nu"][table])
        builder = PlanBuilder(rows, self._rows)
        keep_mask = generator_keep_mask(
            generator, None if mesh is None else (mesh.n_data,
                                                  mesh.data_index))
        rng_np = np.random.default_rng(seed)
        n = len(train_data)
        drop_last = hp.batch_size <= n
        fused, compact = self._select_mode(train_data, val_data, drop_last)
        self.fused = fused
        np_sims = [d.NP_sim for d in (train_data, val_data)]
        self._sims_on_device = (
            fused and compact and all(a is not None for a in np_sims)
            and sims_fit_on_device(sum(a.nbytes for a in np_sims), dev,
                                   mesh))
        self._plans_on_device = fused and plans_fit_on_device(self._rows)
        # own the dict: resampled anchors never reach the caller's splits
        anchors_by_split = dict(anchors_by_split)
        # one epoch-order shuffle per skipped epoch, as the JAX trainer
        for _ in range(start_epoch):
            rng_np.shuffle(np.arange(n))
        if start_epoch > 0 and on_epoch_end is not None:
            anchors_by_split.update(on_epoch_end(start_epoch - 1) or {})
        edges_per_step = mpn_edges_per_step(hp, hp.batch_size,
                                            train_data.cc_ids.shape[1])
        run = train_dev = pending = None
        prefetch = False
        if fused:
            run = _FusedRun(self, train_data, val_data, anchors_by_split,
                            compact, self._sims_on_device, generator,
                            None if self._plans_on_device else builder,
                            rng_np)
            # host plans and sims follow the anchors, so epoch e+1 is
            # prepared during epoch e only while they stay fixed (JAX:
            # loop.py:548)
            prefetch = not hp.resample_anchor_patches
            if prefetch:
                pending = run.schedule(run.draw_order(),
                                       anchors_by_split["train"])
        else:
            train_dev = device_batch(anchors_by_split["train"], dev)

        rec = self.spans
        for epoch in range(start_epoch, hp.max_epochs):
            with rec.epoch(epoch) as epoch_span:
                with rec.span("fit.train") as train_span:
                    if fused:
                        sched = (pending if pending is not None
                                 else run.schedule(run.draw_order(),
                                                   anchors_by_split["train"]))
                        losses = run.train_epoch(sched)
                        # epoch e+1's host work overlaps epoch e's replays
                        pending = (run.schedule(run.draw_order(),
                                                anchors_by_split["train"])
                                   if prefetch and epoch + 1 < hp.max_epochs
                                   else None)
                        if mesh is not None:
                            MX.all_reduce_sum_([losses], mesh)
                        with rec.span("fit.train.wait"):
                            train_losses = losses.cpu().double().tolist()
                    else:
                        train_losses = self._stream_epoch(
                            train_data, anchors_by_split["train"], train_dev,
                            builder, rng_np, drop_last, compact, keep_mask)
                with rec.span("fit.eval") as eval_span:
                    val_metrics = (run.eval_epoch() if fused
                                   else self.evaluate(val_data,
                                                      anchors_by_split["val"],
                                                      "val"))
                # train and eval, before the epoch end, on the spans' clock
                train_time = (train_span.end - epoch_span.start) * 1e-9
                val_metrics["train_loss"] = float(np.mean(train_losses))
                val_metrics["epoch"] = epoch
                val_metrics["epoch_time_s"] = (
                    (eval_span.end - epoch_span.start) * 1e-9)
                val_metrics["train_edges_per_s"] = (
                    edges_per_step * len(train_losses) / max(train_time, 1e-9))
                if hp.debug_mode and self._grad_norms:
                    val_metrics["grad_norm"] = float(np.mean(
                        self._grad_norms[-max(len(train_losses), 1):]))
                self.metric_scores.append(val_metrics)
                with rec.span("fit.epoch_end"):
                    if self.tb:
                        self.tb.add_scalars(val_metrics, epoch)
                    if self._saving:
                        # a collective on a node axis: every rank, every
                        # epoch
                        saved_params, saved_opt = self.whole_params()
                    if self.ckpt:
                        self.ckpt.maybe_save(
                            epoch, val_metrics, saved_params, self.state,
                            self.tx.host_state(saved_opt),
                            global_step=self.global_step,
                            rng_state=generator.get_state().numpy())
                    if log_fn and lead:
                        log_fn(f"epoch {epoch}: "
                               f"train_loss={val_metrics['train_loss']:.4f} "
                               f"val_micro_f1="
                               f"{val_metrics['val_micro_f1']:.4f} "
                               f"val_acc={val_metrics['val_acc']:.4f} "
                               f"val_auroc={val_metrics['val_auroc']:.4f} "
                               f"({val_metrics['epoch_time_s']:.1f}s)")
                    if metrics_callback is not None:
                        # may raise (pruning)
                        metrics_callback(epoch, val_metrics)
                    if on_epoch_end is not None:
                        new_anchors = on_epoch_end(epoch)
                        if new_anchors:
                            anchors_by_split.update(new_anchors)
                            if fused:
                                run.set_anchors(anchors_by_split)
                                if pending is not None:
                                    # keep the drawn order, rebuild its
                                    # plans
                                    pending = run.schedule(
                                        pending[0], anchors_by_split["train"])
                            else:
                                train_dev = device_batch(
                                    anchors_by_split["train"], dev)
        if run is not None:
            run.release()      # the graphs' memory pools
        return self.metric_scores[-1] if self.metric_scores else {}

    @property
    def fused_captures(self) -> int:
        """Step graphs the last fit captured (train, eval, and, where the
        host builds the plans, one more train graph each time their tile
        counts grew); on the CPU, where the card would have captured."""
        return sum(g.captures for g in self._graphs)

    def _stream_epoch(self, data, anchors_np, anchors_dev, builder, rng_np,
                      drop_last, compact, keep_mask) -> List[float]:
        """One streaming epoch: a host batch per step (this rank's rows of
        it on a mesh, with its own plans); the step losses (summed over
        the ranks once, at the end)."""
        hp, dev, mesh = self.hp, self.device, self.mesh
        n = len(data)
        order = self._epoch_order(n, hp.batch_size, rng_np, drop_last)
        losses = []
        for i, idx in enumerate([] if order is None else order):
            valid = np.arange(i * hp.batch_size, (i + 1) * hp.batch_size) < n
            batch = _host_batch(data, idx, valid, include_np_sim=not compact)
            if compact:
                batch.update(compact_sims_for_batch(data.NP_sim, anchors_np,
                                                    hp, idx))
            n_valid = None
            if mesh is not None:
                n_valid = int(valid.sum())
                batch = MX.shard_batch(batch, mesh)
            batch.update(batch_plans(builder, hp, batch["cc_ids"],
                                     anchors_np, batch["subgraph_idx"]))
            batch = device_batch(batch, dev)
            self._hold("NP_sim", batch.get("NP_sim"))
            if hp.debug_mode:
                loss = self._debug_step(batch, anchors_dev, keep_mask,
                                        n_valid)
            else:
                loss, _, self.state = train_step(
                    self.model, self.tx, self.params, self.opt_state,
                    self.state, batch, anchors_dev, keep_mask, mesh, n_valid)
            losses.append(float(loss))
            self.global_step += 1
        if mesh is not None and losses:
            summed = torch.tensor(losses, device=dev)
            MX.all_reduce_sum_([summed], mesh)
            losses = summed.cpu().double().tolist()
        return losses

    def _debug_step(self, batch, anchors, keep_mask, n_valid=None):
        """A debug_mode step (JAX loop.py:94-97, 116-117): the global L2 norm
        of the raw gradients (on a mesh, of their sum over the ranks) is
        recorded, and a non-finite loss or gradient raises
        FloatingPointError before the update (the counterpart of
        jax_debug_nans). The norm covers the trainable leaves (a frozen
        table gets no gradient here; the JAX norm includes its), on a node
        axis the whole table's (`global_norm`)."""
        loss, _, new_state, grads = loss_and_grads(
            self.model, self.tx, self.params, self.state, batch, anchors,
            keep_mask, self.mesh, n_valid)
        value, norm = float(loss), float(self.tx.norm(grads))
        if not (math.isfinite(value) and math.isfinite(norm)):
            raise FloatingPointError(
                f"debug_mode: non-finite loss {value!r} or gradient norm "
                f"{norm!r} at step {self.global_step}")
        self._grad_norms.append(norm)
        self.tx.step(self.params, grads, self.opt_state)
        self.state = new_state
        return loss

    def lr_find(self, params, state, train_data, anchors_by_split,
                seed: int = 0, min_lr: float = 1e-6, max_lr: float = 3e-2,
                num_steps: int = 60, beta: float = 0.9,
                damping: float = 3.0) -> float:
        """LR range test (subgnn_tpu/train/loop.py:669-738; PL's
        auto_lr_find): one-batch Adam steps at lrs swept geometrically from
        min_lr to max_lr, an EMA of the loss, and the lr at the steepest
        descent of the smoothed curve divided by `damping`; a non-finite
        loss ends the sweep. Fewer than 5 points keep hp.learning_rate.
        Model state stays fixed, the caller's trees are not updated, and
        the frozen table gets no update (as make_optimizer). The batches
        carry no gather plans (as the JAX sweep's), so the table gradient
        is autograd's index backward, not the plan kernel. Like the JAX
        sweep it has no mesh branch: on a mesh every rank runs the whole
        sweep alone and finds the same lr."""
        hp, dev = self.hp, self.device
        rng_np = np.random.default_rng(seed)
        lrs = np.geomspace(min_lr, max_lr, num_steps)
        anchors = device_batch(anchors_by_split["train"], dev)
        p = copy_tree(params, dev)
        st = copy_tree(state, dev)
        tx = Adam(1e-3, hp.grad_clip, frozen=self.tx.frozen)
        opt_state = tx.init(p)
        keep_mask = generator_keep_mask(
            torch.Generator(device=dev).manual_seed(seed))
        losses: List[float] = []
        smoothed = None
        it = 0
        drop_last = hp.batch_size <= len(train_data)
        while it < num_steps:
            for batch in train_data.batches(hp.batch_size, shuffle=True,
                                            drop_last=drop_last, rng=rng_np):
                if it >= num_steps:
                    break
                tx.lr = float(np.float32(lrs[it]))
                loss, _, _, grads = loss_and_grads(
                    self.model, tx, p, st, device_batch(batch, dev), anchors,
                    keep_mask)
                tx.step(p, grads, opt_state)
                loss = float(loss)
                if not np.isfinite(loss):
                    num_steps = it  # diverged: truncate the sweep
                    break
                smoothed = loss if smoothed is None else (
                    beta * smoothed + (1 - beta) * loss)
                losses.append(smoothed)
                it += 1
        if len(losses) < 5:
            return hp.learning_rate
        grad = np.gradient(np.asarray(losses))
        best = int(np.argmin(grad[: len(losses)]))
        # the steepest-descent point sits just below the divergence edge;
        # damp it (as the JAX trainer)
        return float(lrs[min(best, len(lrs) - 1)]) / damping

    def best_monitor_value(self) -> float:
        """The HPO objective: min over epochs when monitoring val_loss, max
        otherwise (reference train.py:432-435)."""
        vals = [m[self.monitor] for m in self.metric_scores
                if self.monitor in m]
        if not vals:
            return float("nan")
        return float(np.min(vals) if self.monitor == "val_loss"
                     else np.max(vals))


def _host_batch(data, idx: np.ndarray, valid: np.ndarray,
                include_np_sim: bool) -> Dict[str, Any]:
    """The batch dict SubgraphData.batches yields, for given indices."""
    batch = {"cc_ids": data.cc_ids[idx], "subgraph_idx": idx.astype(np.int32),
             "label": data.labels[idx], "valid": valid}
    for name in ("NP_sim", "I_S_sim", "B_S_sim"):
        arr = getattr(data, name)
        if arr is not None and (name != "NP_sim" or include_np_sim):
            batch[name] = arr[idx]
    return batch


def _profiler(profile_dir, device: torch.device):
    """torch.profiler over a fit, its trace written into `profile_dir`
    (TensorBoard's layout; the JAX trainer's jax.profiler trace,
    loop.py:423-424), or nothing without a directory."""
    if not profile_dir:
        return contextlib.nullcontext()
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(str(profile_dir)))


def _copy_into(dst, src) -> None:
    """Copy a tree of tensors into another of the same structure."""
    if isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    elif isinstance(dst, list):
        for a, b in zip(dst, src):
            _copy_into(a, b)
    else:
        dst.copy_(src)


def _slot(stacked):
    """A static buffer for one batch of a stacked tensor or GatherPlan."""
    if isinstance(stacked, GatherPlan):
        return GatherPlan(*(torch.empty_like(t[0]) for t in stacked[:3]),
                          stacked.n_rows)
    return torch.empty_like(stacked[0])


def _load(slot, stacked, i: int) -> None:
    """Copy batch i of a stacked tensor or GatherPlan into its slot."""
    if isinstance(stacked, GatherPlan):
        for dst, src in zip(slot[:3], stacked[:3]):
            dst.copy_(src[i])
    else:
        slot.copy_(stacked[i])


def _layout(extras) -> tuple:
    """The static shapes of a step's per-batch inputs."""
    return tuple(sorted(
        (k, tuple(tuple(t.shape[1:]) for t in v[:3])
         if isinstance(v, GatherPlan) else tuple(v.shape[1:]))
        for k, v in extras.items()))


class _FusedRun:
    """The device side of one fused fit (subgnn_tpu/train/loop.py:178-264,
    473-504, 548-628): both splits resident, anchors in static buffers,
    and a train and an eval StepGraph fed by copies into their static
    buffers. On a mesh the splits are resident on every rank, whole but
    for the NP sims' node axis, of which a node rank keeps its columns
    (JAX's split_pspecs); a train step takes the data index's columns of
    the epoch order, with the node-group gathers and the gradients'
    all-reduce inside its graph, and an eval step runs the data index's
    rows of the batch and gathers the logits inside its graph.

    Without a `builder` (`plans_fit_on_device`: no node axis) each train
    step builds its batch's gather plans from the ids it gathers
    (train/plans.py:device_batch_plans), at tile counts no batch exceeds,
    so the train step is captured once. With one (a node axis, whose plans
    route a rank's rows alone) the host builds each epoch's plans, stacked,
    in `schedule`, each replay copies its batch's plans into the step's
    buffers, and a growth of their tile counts makes a new train step.

    With compact sims, `sims_on_device` (`sims_fit_on_device`: no node
    axis, and the NP sims within half the card's free memory) keeps each
    split's whole NP sims on the device beside, not in, the split arrays
    (a step's gather would take its (B, C, n_nodes) rows), and each train
    and eval step gathers its batch's anchor columns from them
    (train/sims.py:device_compact_sims), reading the static anchor
    buffers. Otherwise the host gathers them with each epoch's order
    (`schedule`) and once for the val order, and each replay copies its
    batch's slice into the step's buffers."""

    def __init__(self, trainer: "Trainer", train_data, val_data,
                 anchors_by_split, compact: bool, sims_on_device: bool,
                 generator: torch.Generator, builder: Optional[PlanBuilder],
                 rng_np: np.random.Generator):
        hp, dev, mesh = trainer.hp, trainer.device, trainer.mesh
        if mesh is not None and dev.type == "cuda" \
                and mesh.backend != "nccl":
            raise ValueError(
                f"a fused fit on {dev} captures the gradients' all-reduce "
                f"in a CUDA graph, which the {mesh.backend!r} backend cannot "
                "be captured in: use NCCL, or a streaming fit (debug_mode)")
        self.tr, self.hp, self.device, self.mesh = trainer, hp, dev, mesh
        # this rank's columns of a (n_batches, B) order
        self.cols = slice(None) if mesh is None else mesh.rows(hp.batch_size)
        self.train_data, self.val_data = train_data, val_data
        self.builder, self.rng_np = builder, rng_np
        # compact sims that the host gathers and the steps copy in
        self.host_sims = compact and not sims_on_device
        self.generator = generator
        self.keep_mask = generator_keep_mask(
            generator, None if mesh is None else (mesh.n_data,
                                                  mesh.data_index))
        self.train_arrays = Trainer._device_split(train_data, dev,
                                                  not compact, mesh)
        self.val_arrays = Trainer._device_split(val_data, dev, not compact,
                                                mesh)
        # each split's whole NP sims, for the steps' compact gathers: a
        # plain copy to the card (no pinned staging of gigabytes), the
        # numpy array itself on the CPU where its layout allows
        self.np_sims = None
        if sims_on_device:
            self.np_sims = {
                s: torch.as_tensor(np.require(d.NP_sim, np.float32,
                                              ["C", "W"]), device=dev)
                for s, d in (("train", train_data), ("val", val_data))}
        held = self.np_sims or {s: a.get("NP_sim") for s, a in (
            ("train", self.train_arrays), ("val", self.val_arrays))}
        trainer._hold("NP_sim", held["train"])
        trainer._hold("NP_sim_val", held["val"])
        self.anchors = {s: device_batch(anchors_by_split[s], dev)
                        for s in ("train", "val")}
        B, n_val = hp.batch_size, len(val_data)
        nb_val = -(-n_val // B)
        flat = np.arange(nb_val * B)
        self.val_order_np = (flat % n_val).reshape(nb_val, B).astype(np.int32)
        self.val_valid_np = (flat < n_val).reshape(nb_val, B)
        self.val_order = self._put(self.val_order_np.astype(np.int64))
        self.val_valid = self._put(self.val_valid_np)
        self.val_extras = self._val_extras(anchors_by_split["val"])
        # the eval forward's CC tables (streaming evaluate's fallback to
        # the train split's learned tables), at fixed addresses
        self.val_cc = None
        if hp.trainable_cc:
            saved = trainer.eval_cc_tables.get("val")
            self.val_cc = (trainer.params.get("train_cc") if saved is None
                           else {k: torch.as_tensor(v, device=dev)
                                 for k, v in saved.items()})
        self.train_graph = self.eval_graph = None
        self.train_key = None

    # ------------------------------------------------------------ host side

    def _put(self, x):
        """A host array or GatherPlan on the device: pinned and copied
        without waiting on the card."""
        if isinstance(x, GatherPlan):
            return GatherPlan(*(self._put(t) for t in x[:3]), x.n_rows)
        t = torch.as_tensor(x)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def draw_order(self) -> np.ndarray:
        return Trainer._epoch_order(len(self.train_data), self.hp.batch_size,
                                    self.rng_np, True)

    def schedule(self, order: np.ndarray, anchors_np):
        """An epoch's order and, where the steps do not build them on the
        device, stacked gather plans and compact sims (host numpy work, for
        this rank's columns of the order), then one copy of each to the
        device."""
        rec = self.tr.spans
        with rec.span("fit.schedule"):
            cols = order[:, self.cols]
            extras = {}
            if self.builder is not None:
                with rec.span("fit.schedule.plans"):
                    extras = epoch_plans(self.builder, self.hp,
                                         self.train_data.cc_ids, anchors_np,
                                         cols)
            if self.host_sims:
                with rec.span("fit.schedule.sims"):
                    extras.update(epoch_compact_sims(
                        self.train_data.NP_sim, anchors_np, self.hp, cols))
            with rec.span("fit.schedule.put"):
                return (order, self._put(cols.astype(np.int64)),
                        {k: self._put(v) for k, v in extras.items()})

    def _val_extras(self, anchors_np):
        if not self.host_sims:
            return {}
        return {k: self._put(v) for k, v in epoch_compact_sims(
            self.val_data.NP_sim, anchors_np, self.hp,
            self.val_order_np[:, self.cols]).items()}

    def set_anchors(self, anchors_by_split) -> None:
        """New anchors into the static anchor buffers, which the step
        graphs read; host-gathered val sims follow the val anchors (JAX
        loop.py:650-660). New anchors keep their shapes (as JAX's
        resampling keeps them, so that it never recompiles)."""
        for split in ("train", "val"):
            new = device_batch(anchors_by_split[split], self.device)
            old = self.anchors[split]
            if set(new) != set(old) or any(new[k].shape != old[k].shape
                                           for k in new):
                raise ValueError(
                    f"on_epoch_end's {split} anchors changed shape: "
                    f"{ {k: tuple(v.shape) for k, v in new.items()} } vs "
                    f"{ {k: tuple(v.shape) for k, v in old.items()} }")
            _copy_into(old, new)
        self.val_extras = self._val_extras(anchors_by_split["val"])

    # ---------------------------------------------------------- the steps

    def _graph(self, fn) -> StepGraph:
        graph = StepGraph(fn, self.device, (self.generator,))
        self.tr._graphs.append(graph)
        return graph

    def _retire(self, name: str) -> None:
        graph = getattr(self, name)
        if graph is not None:
            graph.graph = graph.fn = None
        setattr(self, name, None)

    def release(self) -> None:
        """Free the step graphs and their buffers (their counts stay)."""
        self._retire("train_graph")
        self._retire("eval_graph")

    def _build_train(self, extras) -> None:
        tr, dev, B = self.tr, self.device, self.hp.batch_size
        b = B if self.mesh is None else B // self.mesh.n_data
        # every row of a fused batch is valid: the whole batch's count
        n_valid = None if self.mesh is None else B
        buf = {"idx": torch.zeros(b, dtype=torch.int64, device=dev),
               "valid": torch.ones(b, dtype=torch.bool, device=dev),
               "loss": torch.zeros((), device=dev),
               "extras": {k: _slot(v) for k, v in extras.items()}}
        rows = tr.params["node_embed"].shape[0]

        def step():
            batch = Trainer._gather_batch(self.train_arrays, buf["idx"],
                                          buf["valid"])
            batch.update(buf["extras"])
            if self.builder is None:
                batch.update(device_batch_plans(
                    self.hp, batch["cc_ids"], self.anchors["train"],
                    buf["idx"], rows))
            if self.np_sims is not None:
                batch.update(device_compact_sims(
                    self.np_sims["train"], self.anchors["train"], self.hp,
                    buf["idx"]))
            loss, _, new_state = train_step(
                tr.model, tr.tx, tr.params, tr.opt_state, tr.state, batch,
                self.anchors["train"], self.keep_mask, self.mesh, n_valid)
            _copy_into(tr.state, new_state)
            buf["loss"].copy_(loss)

        self._retire("train_graph")
        self.train_buf, self.train_graph = buf, self._graph(step)
        self.train_key = _layout(extras)

    def _build_eval(self) -> None:
        tr, dev, B = self.tr, self.device, self.hp.batch_size
        buf = {"idx": torch.zeros(B, dtype=torch.int64, device=dev),
               "valid": torch.zeros(B, dtype=torch.bool, device=dev),
               "loss": torch.zeros((), device=dev),
               "logits": torch.zeros(B, tr.model.num_classes, device=dev),
               "extras": {k: _slot(v) for k, v in self.val_extras.items()}}

        @torch.no_grad()
        def step():
            # the whole batch's order row and mask, this rank's rows of them
            idx, valid = buf["idx"], buf["valid"]
            batch = Trainer._gather_batch(self.val_arrays, idx[self.cols],
                                          valid[self.cols])
            batch.update(buf["extras"])
            if self.np_sims is not None:
                batch.update(device_compact_sims(
                    self.np_sims["val"], self.anchors["val"], self.hp,
                    idx[self.cols]))
            logits, _ = tr.model(tr.params, tr.state, batch,
                                 self.anchors["val"], train=False,
                                 cc_tables=self.val_cc, mesh=self.mesh)
            if self.mesh is not None:
                logits = MX.all_gather_rows(logits, self.mesh)
            buf["loss"].copy_(tr.model.loss_fn(
                logits, self.val_arrays["label"][idx], valid))
            buf["logits"].copy_(logits)

        self.eval_buf, self.eval_graph = buf, self._graph(step)

    def train_epoch(self, sched) -> torch.Tensor:
        """Enqueue an epoch: per batch, copies into the train step's static
        buffers and one call of its graph. Returns the step losses, a
        device tensor nobody has waited for."""
        _, order, extras = sched
        if self.train_graph is None or _layout(extras) != self.train_key:
            self._build_train(extras)      # the host plans' tiles grew
        buf, nb = self.train_buf, order.shape[0]
        rec = self.tr.spans
        with rec.span("fit.train.launch"):
            losses = torch.empty(nb, device=self.device)
            for i in range(nb):
                buf["idx"].copy_(order[i])
                for k, v in extras.items():
                    _load(buf["extras"][k], v, i)
                self.train_graph()
                losses[i].copy_(buf["loss"])
        rec.count("replays", nb)
        rec.count("device_sims", nb if self.np_sims is not None else 0)
        rec.count("device_plans", nb if self.builder is None else 0)
        self.tr.global_step += nb
        return losses

    def eval_epoch(self) -> Dict[str, Any]:
        """The eval step over the val order, logits and losses read once;
        per-batch accuracy and macro-F1 means as streaming evaluate and
        the JAX trainer take them (loop.py:598-628)."""
        if self.eval_graph is None:
            self._build_eval()
        buf, nb = self.eval_buf, self.val_order.shape[0]
        rec = self.tr.spans
        with rec.span("fit.eval.launch"):
            losses = torch.empty(nb, device=self.device)
            logits = torch.empty((nb,) + tuple(buf["logits"].shape),
                                 device=self.device)
            for i in range(nb):
                buf["idx"].copy_(self.val_order[i])
                buf["valid"].copy_(self.val_valid[i])
                for k, v in self.val_extras.items():
                    _load(buf["extras"][k], v, i)
                self.eval_graph()
                losses[i].copy_(buf["loss"])
                logits[i].copy_(buf["logits"])
        rec.count("replays", nb)
        rec.count("device_sims", nb if self.np_sims is not None else 0)
        with rec.span("fit.eval.wait"):
            v_losses = losses.cpu().double().numpy()
            v_logits = logits.cpu().numpy()
        with rec.span("fit.eval.metrics"):
            valid, order = self.val_valid_np, self.val_order_np
            labels = np.asarray(self.val_data.labels)
            ml = self.tr.model.multilabel
            accs, f1s = [], []
            for i in range(nb):
                lg, lb = v_logits[i][valid[i]], labels[order[i][valid[i]]]
                accs.append(M.calc_accuracy(lg, lb, ml))
                f1s.append(M.calc_f1(lg, lb, "macro", ml))
            flat = valid.reshape(-1)
            return self.tr._metrics(
                "val", v_logits.reshape(-1, v_logits.shape[-1])[flat],
                labels[order.reshape(-1)[flat]], list(v_losses), accs, f1s)
