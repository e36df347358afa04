"""Whether a serving run was correct: the logits of a sample of the
window's requests held against the plain reference, which works each one
out again from the graph, the seed and the benchmark's weights: the
component split, the hop distances and NP sims, the border sets, the
anchors, the structure DTW sims and the forward pass.

Number compared (beside its limit from limits/<cell>.json):
  logit_gap  over the sampled requests, the largest |program - reference|
             logit over the largest |reference| logit of that request
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..reference import graph as RG
from ..reference import model as RM
from ..reference import samplers as RS
from ..reference import sims as RSim
from .check_fit import _tree


class RefServing:
    """The reference's serving state: the graph and the structure
    anchors."""

    def __init__(self, hp: Dict, edges: np.ndarray, n_nodes: int, seed: int,
                 dev):
        self.hp, self.seed, self.dev = hp, seed, dev
        self.g = RG.Graph(edges, n_nodes)
        self.fixed: Dict = {}
        if hp["use_position"]:
            self.fixed["pos_ext"] = RS.position_border(hp, self.g, seed)
        self.structure = None
        if hp["use_structure"]:
            self.structure = RS.Structure(self.g, hp, seed)
            self.fixed.update(self.structure.anchors())

    def logits(self, req: List[List[int]], params, rnd=None) -> np.ndarray:
        hp, g = self.hp, self.g
        cc = g.cc_table(req)
        t = lambda x: torch.as_tensor(np.asarray(x), device=self.dev)
        b = {"cc": t(cc).long()}
        a = dict(self.fixed)
        if hp["use_neighborhood"] or hp["use_position"]:
            b["np_sim"] = t(g.cc_min_distances(cc, self.dev))
        if hp["use_neighborhood"]:
            border = g.border_sets(cc, hp["neigh_sample_border_size"])
            a["neigh_int"], a["neigh_bor"] = RS.neighborhood(
                hp, cc, border, self.seed, RS.PREDICT_TAG)
        if hp["use_position"]:
            a["pos_int"] = RS.position_internal(hp, req, self.seed,
                                                RS.PREDICT_TAG)
        if hp["use_structure"]:
            b["i_sim"] = t(RSim.split_structure_sims(
                g, cc, self.structure, True, self.dev))
            b["b_sim"] = t(RSim.split_structure_sims(
                g, cc, self.structure, False, self.dev))
        a = {k: t(v).long() for k, v in a.items()}
        with torch.no_grad():
            return RM.forward(params, hp, b, a, rnd).cpu().numpy()


def sample(n_served: int, sizes: List[int], seed: int, k: int) -> List[int]:
    """k request indices drawn from the seed, with the largest request."""
    rng = np.random.default_rng([seed, 5])
    pick = set(rng.choice(n_served, min(k, n_served), replace=False).tolist())
    pick.add(int(np.argmax(sizes)))
    return sorted(pick)


def gap(prog: np.ndarray, ref: np.ndarray) -> float:
    if prog.shape != ref.shape:
        return float("inf")
    return float(np.abs(prog - ref).max() / max(np.abs(ref).max(), 1e-30))


def check(cell, edges, seed, dev, params0, served, logits, limits):
    """({name: (value, limit)}, the reference's state) of a serving run."""
    hp = cell.config["hparams"]
    R = RefServing(hp, edges, int(cell.config["dataset"]["n_nodes"]), seed,
                   dev)
    params = _tree({p: v.to(dev) for p, v in params0.items()})
    idx = sample(len(served), [len(r) for r in served], seed,
                 int(cell.traffic["check_requests"]))
    worst = max(gap(logits[i], R.logits(served[i], params)) for i in idx)
    return {"logit_gap": (worst, limits.get("logit_gap"))}, R
