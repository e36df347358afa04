"""Whether a training run was correct: the program's set-up, its first
steps, every step of the epoch after the window and that epoch's validation
logits, held against the plain reference, which works everything out again
from the dataset and the benchmark's weights alone; for the later epoch it
starts from the program's own state before each step (recorded by
fit.Watch), since after hundreds of epochs only that state is there to
start from.

Numbers compared (each beside its limit from limits/<cell>.json):
  anchors_mismatch  entries of the component tables and of every anchor
                    array of the train and val splits that differ
  np_sim_gap        largest |difference| of the NP sims (hop distances)
  struct_sim_gap    largest |difference| of the internal and border
                    structure sims at the pool columns the layers read,
                    over the checked rows (the batches of the checked
                    steps and the whole val split)
  loss_gap          largest relative gap of the first three steps' losses
  grad_gap          worst leaf's gap of first-gradient norms (the gradient
                    as Adam got it, mu / (1 - b1) after step 1), over the
                    larger of that leaf's and the median leaf's norm
  update_gap        the same of the parameters' change over three steps,
                    leaves whose step-1 gradient is under a thousandth of
                    the median leaf's left out (they move by round-off)
  late_loss_gap     largest relative loss gap over the later epoch's steps
  late_grad_gap     worst leaf's gap, over those steps, of the gradient as
                    Adam got it ((mu after - b1 mu before) / (1 - b1)),
                    clipped where the configuration clips
  late_update_gap   the median leaf's gap of each step's change of the
                    parameters, leaves left out by the rule above on that
                    step (the worst leaf's is reported beside it)
  val_logit_gap     largest |difference| of the validation logits at the
                    program's state after the later epoch's steps, over the
                    largest |reference logit|
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..reference import graph as RG
from ..reference import model as RM
from ..reference import samplers as RS
from ..reference import sims as RSim
from .fit import SPLITS, epoch_order

B1 = 0.9


class RefInputs:
    """The reference's own inputs of the rows it checks: the first three
    batches of epoch 0 and `late` (the later epoch's (n_batches, B)
    order), and the whole val split."""

    def __init__(self, hp: Dict, data: Dict, seed: int, dev,
                 late: np.ndarray, steps: int = 3):
        self.hp, self.dev = hp, dev
        g = RG.Graph(data["edges"], data["n_nodes"])
        self.g = g
        lists = data["lists"]
        self.labels = data["labels"]
        self.cc = {s: g.cc_table(lists[s]) for s in SPLITS}
        border = {s: (g.border_sets(self.cc[s], hp["neigh_sample_border_size"])
                      if hp["use_neighborhood"] else None) for s in SPLITS}
        self.anchors = {s: {} for s in SPLITS}
        for s in SPLITS:
            a = self.anchors[s]
            tag = RS.SPLIT_TAG[s]
            if hp["use_neighborhood"]:
                a["neigh_int"], a["neigh_bor"] = RS.neighborhood(
                    hp, self.cc[s], border[s], seed, tag)
            if hp["use_position"]:
                a["pos_int"] = RS.position_internal(hp, lists[s], seed, tag)
                a["pos_ext"] = RS.position_border(hp, g, seed)
        self.structure = None
        if hp["use_structure"]:
            self.structure = RS.Structure(g, hp, seed)
            for s in SPLITS:
                self.anchors[s].update(self.structure.anchors())
        n_train = len(lists["train"])
        order = epoch_order(n_train, hp["batch_size"], seed, 1)[0]
        self.batches = [order[i] for i in range(steps)]
        self.late = [np.asarray(r) for r in late]
        self.rows = {"train": np.unique(np.concatenate(self.batches
                                                       + self.late)),
                     "val": np.arange(len(lists["val"]))}
        self.np_sim, self.i_sim, self.b_sim = {}, {}, {}
        for s in SPLITS:
            cc = self.cc[s][self.rows[s]]
            if hp["use_neighborhood"] or hp["use_position"]:
                self.np_sim[s] = g.cc_min_distances(cc, dev)
            if hp["use_structure"]:
                self.i_sim[s] = RSim.split_structure_sims(
                    g, cc, self.structure, True, dev)
                self.b_sim[s] = RSim.split_structure_sims(
                    g, cc, self.structure, False, dev)

    def batch(self, split: str, rows: np.ndarray):
        """(batch, anchors, labels) tensors of split rows `rows`."""
        where = np.searchsorted(self.rows[split], rows)
        t = lambda x: torch.as_tensor(np.asarray(x), device=self.dev)
        b = {"cc": t(self.cc[split][rows]).long()}
        if split in self.np_sim:
            b["np_sim"] = t(self.np_sim[split][where])
        if split in self.i_sim:
            b["i_sim"] = t(self.i_sim[split][where])
            b["b_sim"] = t(self.b_sim[split][where])
        a = {}
        for k, v in self.anchors[split].items():
            v = np.asarray(v)
            if k in ("neigh_int", "neigh_bor", "pos_int"):
                v = v[:, rows]
            a[k] = t(v).long()
        return b, a, t(self.labels[split][rows]).long()


def _grads(R: RefInputs, flat: Dict[str, torch.Tensor], rows: np.ndarray,
           rnd, half: bool):
    """(loss, gradients in `flat`'s order) of the reference's train step
    over batch `rows`."""
    b, a, y = R.batch("train", rows)
    logits = RM.forward(_tree(flat), R.hp, b, a, rnd)
    loss = RM.loss(logits, y, len(rows) // 2 if half else None)
    grads = torch.autograd.grad(loss, list(flat.values()), allow_unused=True,
                                materialize_grads=True)
    return float(loss.detach()), list(grads)


def _global_norm(grads) -> float:
    return float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads)))


def reference_steps(R: RefInputs, params0: Dict[str, torch.Tensor],
                    rnd=None, half: bool = False) -> Dict:
    """The reference's first steps on the first batches of epoch 0:
    {"losses", "g1" (first-step gradients as Adam got them), "params"
    (after the steps), "norms" (global gradient norms before clipping)}.
    `rnd`: TF32 rounding (the control); `half`: the loss over the first
    half of each batch (a fault)."""
    hp = R.hp
    flat = {p: t.to(R.dev).clone().requires_grad_(True)
            for p, t in params0.items()}
    adam = RM.Adam(list(flat.values()), hp["learning_rate"],
                   hp["grad_clip"])
    out = {"losses": [], "norms": [], "g1": None}
    for i, rows in enumerate(R.batches):
        loss, grads = _grads(R, flat, rows, rnd, half)
        out["losses"].append(loss)
        out["norms"].append(_global_norm(grads))
        adam.step(list(flat.values()), grads)
        if i == 0:
            out["g1"] = {p: (m / (1 - B1)).detach().cpu()
                         for p, m in zip(flat, adam.mu)}
    out["params"] = {p: t.detach().cpu() for p, t in flat.items()}
    return out


def reference_late(R: RefInputs, states: List[Dict], rnd=None,
                   half: bool = False) -> List[Dict]:
    """Per step j of the later epoch, the reference's step from the
    program's state before it (states[j]): {"loss", "norm" (before
    clipping), "params", "mu"} after it."""
    hp = R.hp
    out = []
    for rows, st in zip(R.late, states):
        flat = {p: t.to(R.dev).clone().requires_grad_(True)
                for p, t in st["params"].items()}
        adam = RM.Adam(list(flat.values()), hp["learning_rate"],
                       hp["grad_clip"])
        adam.mu = [m.to(R.dev).clone() for m in st["mu"]]
        adam.nu = [v.to(R.dev).clone() for v in st["nu"]]
        adam.count = st["count"]
        loss, grads = _grads(R, flat, rows, rnd, half)
        norm = _global_norm(grads)
        adam.step(list(flat.values()), grads)
        out.append({"loss": loss, "norm": norm,
                    "params": {p: t.detach().cpu() for p, t in flat.items()},
                    "mu": [m.cpu() for m in adam.mu]})
    return out


@torch.no_grad()
def reference_val_logits(R: RefInputs, params: Dict[str, torch.Tensor],
                         rnd=None) -> np.ndarray:
    """(n_val, classes) validation logits at `params`, in batches of
    batch_size in order."""
    tree = _tree({p: t.to(R.dev) for p, t in params.items()})
    n = len(R.rows["val"])
    B = R.hp["batch_size"]
    out = []
    for s in range(0, n, B):
        b, a, _ = R.batch("val", np.arange(s, min(s + B, n)))
        out.append(RM.forward(tree, R.hp, b, a, rnd).cpu().numpy())
    return np.concatenate(out)


def _tree(flat: Dict[str, torch.Tensor]):
    """A nested tree from '/'-joined paths (list levels are digits)."""
    root: Dict = {}
    for path, t in flat.items():
        keys = path.split("/")
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = t

    def lists(x):
        if isinstance(x, dict):
            if x and all(k.isdigit() for k in x):
                return [lists(x[str(i)]) for i in range(len(x))]
            return {k: lists(v) for k, v in x.items()}
        return x
    return lists(root)


def _norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x.double()))


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep: Optional[List[str]] = None) -> Dict[str, float]:
    """Each leaf's | ||prog|| - ||ref|| | over max(||ref||, median leaf
    ||ref||)."""
    keep = list(ref) if keep is None else keep
    norms = {p: _norm(ref[p]) for p in keep}
    med = float(np.median(list(norms.values())))
    return {p: abs(_norm(prog[p]) - norms[p]) / max(norms[p], med, 1e-30)
            for p in keep}


def worst(gaps: Dict[str, float]) -> tuple:
    """(the largest gap, its leaf)."""
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf


def moved_leaves(g1: Dict[str, torch.Tensor]) -> List[str]:
    """Leaves whose first gradient is at least a thousandth of the median
    leaf's (the others move under Adam by round-off alone)."""
    norms = {p: _norm(t) for p, t in g1.items()}
    med = float(np.median(list(norms.values())))
    return [p for p, v in norms.items() if v >= 1e-3 * med]


def readings(prog: Dict, ref: Dict, params0: Dict) -> Dict[str, float]:
    """The first steps' numbers of one side (the program, or the control
    in its place) against the reference."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in
                   zip(prog["losses"], ref["losses"]))
    if len(prog["losses"]) < len(ref["losses"]):
        loss_gap = float("inf")
    keep = moved_leaves(ref["g1"])
    d_prog = {p: prog["params"][p] - params0[p] for p in keep}
    d_ref = {p: ref["params"][p] - params0[p] for p in keep}
    grad_gap, grad_leaf = worst(leaf_gaps(prog["g1"], ref["g1"]))
    update_gap, update_leaf = worst(leaf_gaps(d_prog, d_ref))
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "update_gap": update_gap,
            "leaves": {"grad_gap": grad_leaf, "update_gap": update_leaf}}


def _adam_grads(paths: List[str], mu_after, mu_before) -> Dict:
    """The gradient as Adam got it, from its first moment before and
    after the step: (mu after - b1 mu before) / (1 - b1), in float64."""
    return {p: (a.double() - B1 * b.double()) / (1 - B1)
            for p, a, b in zip(paths, mu_after, mu_before)}


def late_readings(before: List[Dict], after: List[Dict],
                  losses: List[float], ref: List[Dict]) -> Dict:
    """The later epoch's numbers of one side against the reference, the
    largest over its steps: `before` the program's recorded states before
    each step, `after` the side's parameters and moments after it, `losses`
    its losses; `ref` reference_late's steps. The update's number is the
    median leaf's gap (see PERF.md: the worst leaf's swings with the epoch
    checked); the worst leaf's is returned beside it, under
    `late_update_worst` and its leaf, and is not compared."""
    n = len(ref)
    out = {"late_loss_gap": 0.0, "late_grad_gap": 0.0,
           "late_update_gap": 0.0, "late_update_worst": 0.0}
    if n == 0 or len(after) < n or len(losses) < n:
        return dict({k: float("inf") for k in out}, late_update_worst_leaf="")
    paths = list(before[0]["params"])
    leaf = ""
    for b, a, loss, r in zip(before, after, losses, ref):
        g_ref = _adam_grads(paths, r["mu"], b["mu"])
        g_side = _adam_grads(paths, a["mu"], b["mu"])
        keep = moved_leaves(g_ref)
        p0 = b["params"]
        d_ref = {p: r["params"][p].double() - p0[p].double() for p in keep}
        d_side = {p: a["params"][p].double() - p0[p].double() for p in keep}
        gaps = leaf_gaps(d_side, d_ref)
        w, w_leaf = worst(gaps)
        if w > out["late_update_worst"]:
            leaf = w_leaf
        step = {"late_loss_gap": abs(loss - r["loss"]) / abs(r["loss"]),
                "late_grad_gap": worst(leaf_gaps(g_side, g_ref))[0],
                "late_update_gap": float(np.median(list(gaps.values()))),
                "late_update_worst": w}
        out = {k: max(out[k], v) for k, v in step.items()}
    return dict(out, late_update_worst_leaf=leaf)


def _gap(a: np.ndarray, b: np.ndarray) -> float:
    if a.shape != b.shape:
        return float("inf")
    return float(np.abs(a - b).max()) if a.size else 0.0


def set_up_readings(R: RefInputs, ps: Dict) -> Dict[str, float]:
    """Anchors and sims of the program's set-up against the reference's."""
    mismatch = 0
    for s in SPLITS:
        a, b = np.asarray(ps["cc"][s]), R.cc[s]
        mismatch += int((a != b).sum()) if a.shape == b.shape else a.size
        for k, v in R.anchors[s].items():
            p = np.asarray(ps["anchors"][s].get(k))
            mismatch += (int((p != v).sum()) if p.shape == v.shape
                         else max(p.size, v.size))
    np_gap = st_gap = 0.0
    for s in SPLITS:
        rows = R.rows[s]
        if s in R.np_sim:
            np_gap = max(np_gap, _gap(ps["np_sim"][s][rows], R.np_sim[s]))
        if s in R.i_sim:
            cols = R.structure.sel      # the pool columns the model reads
            for prog, ref in ((ps["i_sim"][s], R.i_sim[s]),
                              (ps["b_sim"][s], R.b_sim[s])):
                st_gap = max(st_gap, _gap(prog[rows][:, :, cols],
                                          ref[:, :, cols]))
    return {"anchors_mismatch": float(mismatch), "np_sim_gap": np_gap,
            "struct_sim_gap": st_gap}


def check(cell, ps, seed, dev, params0, watch, late_order, limits,
          controls: bool = False):
    """({name: (value, limit)}, info, controls) of a training run. info
    has the reference's global gradient norms before clipping, of the first
    steps and of the later epoch's (with how many reach the clipping
    norm); `controls` (when asked for) the same numbers of the control (the
    reference in TF32) and of the half-batch fault, each in the program's
    place."""
    hp = cell.config["hparams"]
    R = RefInputs(hp, ps["data"], seed, dev, late_order)
    out = set_up_readings(R, ps)
    ref = reference_steps(R, params0)
    late = watch.late or {"states": [], "losses": [], "val_logits": None}
    inf = float("inf")
    if watch.mu is None or not watch.params:
        out.update(loss_gap=inf, grad_gap=inf, update_gap=inf)
        leaves_ = None
    else:
        prog = {"losses": watch.losses,
                "g1": {p: m / (1 - B1) for p, m in zip(params0, watch.mu)},
                "params": watch.params}
        steps = readings(prog, ref, params0)
        leaves_ = steps.pop("leaves")
        out.update(steps)
    states = late["states"]
    before = states[:len(R.late)]
    ref_late = reference_late(R, before)
    late_r = late_readings(before, states[1:], late["losses"], ref_late)
    worst_late = {k: late_r.pop(k) for k in ("late_update_worst",
                                             "late_update_worst_leaf")}
    out.update(late_r)
    ref_val = (reference_val_logits(R, states[-1]["params"])
               if states else None)
    prog_val = late["val_logits"]
    out["val_logit_gap"] = (_rel_gap(prog_val, ref_val)
                            if prog_val is not None and ref_val is not None
                            else inf)
    clip = float(hp["grad_clip"])
    norms = [r["norm"] for r in ref_late]
    info = {"reference_grad_norms": ref["norms"],
            "reference_late_grad_norms": {
                "min": min(norms, default=None),
                "max": max(norms, default=None),
                "steps": len(norms),
                "clipped": sum(v >= clip for v in norms) if clip > 0 else 0},
            "worst_leaves": leaves_, **worst_late}
    ctl = None
    if controls:
        ctl = {}
        for name, kw in (("control", {"rnd": RM.tf32_round}),
                         ("half_batch", {"half": True})):
            side = reference_steps(R, params0, **kw)
            r = readings(side, ref, params0)
            r.pop("leaves")
            side = reference_late(R, before, **kw)
            r.update(late_readings(before, side,
                                   [x["loss"] for x in side], ref_late))
            if "rnd" in kw and states:
                r["val_logit_gap"] = _rel_gap(
                    reference_val_logits(R, states[-1]["params"], kw["rnd"]),
                    ref_val)
            ctl[name] = r
    return {k: (v, limits.get(k)) for k, v in out.items()}, info, ctl


def _rel_gap(prog: np.ndarray, ref: np.ndarray) -> float:
    if prog.shape != ref.shape:
        return float("inf")
    return float(np.abs(prog.astype(np.float64) - ref).max()
                 / max(np.abs(ref).max(), 1e-30))
