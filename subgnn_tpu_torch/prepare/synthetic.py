"""Synthetic dataset generator (DENSITY / CUT RATIO / CORENESS / COMPONENT).

Re-implements the reference's offline generator semantics
(reference: prepare_dataset/prepare_dataset.py:26-831):
  * base graph: Barabasi-Albert or duplication-divergence,
  * subgraph placement: 'bfs' (BFS trees from random seeds), 'plant'
    (overlay a generator subgraph on random / k-core nodes), 'staple'
    (attach generated components k hops apart), 'coreness' (plant on
    same-core-number nodes),
  * optional iterative edge add/remove loop driving each subgraph's
    density / cut-ratio to a randomly chosen target,
  * labels: property value -> quantile bins -> 'A', 'B', ... characters,
  * 80/10/10 split mask and the dash-delimited TSV writer.

This is offline data prep (runs once per dataset); NetworkX builds the
generative graph models as the reference does, imported inside the
functions that build graphs, so the rest of the package never needs it.

The port's copy of subgnn_tpu/prepare/synthetic.py: the same seed writes
the same files.
"""
from __future__ import annotations

import random
from collections import defaultdict
from pathlib import Path
from typing import List, Optional

import numpy as np


class SyntheticGraphBuilder:
    def __init__(self, base_graph_type: str = "barabasi_albert",
                 subgraph_type: str = "bfs",
                 desired_property: str = "density",
                 n: int = 1000, m: int = 5, p: float = 0.5,
                 n_subgraphs: int = 250, n_subgraph_nodes: int = 20,
                 n_connected_components: Optional[int] = 1,
                 n_bins: int = 3,
                 subgraph_generator: str = "complete",
                 modify_graph_for_properties: bool = True,
                 density_range=(0.05, 0.25, 0.45),
                 density_epsilon: float = 0.01,
                 cut_ratio_range=(0.005, 0.0125, 0.02),
                 cut_ratio_epsilon: float = 0.001,
                 k_hops_range=(0.12, 0.5, 1.0),
                 cc_range=(1, 1, 1, 1, 5, 6, 7, 8, 9, 10),
                 max_tries: int = 100,
                 seed: int = 42):
        self.cfg = dict(locals())
        self.cfg.pop("self")
        self.seed = seed
        random.seed(seed)
        np.random.seed(seed)
        self.desired_property = desired_property
        self.n_bins = n_bins
        self.graph = self._base_graph(base_graph_type, n, m, p, seed)
        self.subgraphs = self._place_subgraphs(
            subgraph_type, n_subgraphs, n_subgraph_nodes,
            n_connected_components, subgraph_generator)
        if modify_graph_for_properties:
            self._drive_properties()
        self.labels = self._label_subgraphs()

    # ------------------------------------------------------------- base graph

    @staticmethod
    def _base_graph(kind, n, m, p, seed):
        import networkx as nx
        if kind == "barabasi_albert":
            return nx.barabasi_albert_graph(n, m, seed=seed)
        if kind == "duplication_divergence_graph":
            return nx.duplication_divergence_graph(n, p, seed=seed)
        raise NotImplementedError(kind)

    @staticmethod
    def _component_graph(kind, n_nodes, m=5, p=0.5, seed=None):
        import networkx as nx
        if kind == "mixed":
            # vary the generator per component so structure-derived
            # properties (e.g. avg coreness) span several label bins
            kind = random.choice(["complete", "cycle", "path", "star",
                                  "barabasi_albert"])
            if kind == "barabasi_albert":
                m = random.choice([2, 3, 5])
        if kind == "complete":
            return nx.complete_graph(n_nodes)
        if kind == "path":
            return nx.path_graph(n_nodes)
        if kind == "cycle":
            return nx.cycle_graph(n_nodes)
        if kind == "star":
            return nx.star_graph(n_nodes)
        if kind == "house":
            return nx.house_graph()
        if kind == "barabasi_albert":
            return nx.barabasi_albert_graph(n_nodes, m, seed=seed)
        if kind == "duplication_divergence_graph":
            return nx.duplication_divergence_graph(n_nodes, p)
        raise NotImplementedError(kind)

    # ---------------------------------------------------------- placement

    def _place_subgraphs(self, kind, n_subgraphs, n_nodes_in_sg, n_cc, gen):
        if kind == "bfs":
            return self._by_bfs(n_subgraphs, n_nodes_in_sg, n_cc or 1)
        if kind == "plant":
            if self.desired_property == "coreness":
                return self._by_coreness(n_subgraphs, n_nodes_in_sg, n_cc or 1, gen)
            return self._by_planting(n_subgraphs, n_nodes_in_sg, n_cc or 1, gen)
        if kind == "staple":
            return self._by_staple(n_subgraphs, n_nodes_in_sg, n_cc, gen)
        if kind == "random":
            return [random.sample(list(self.graph.nodes), n_nodes_in_sg)
                    for _ in range(n_subgraphs)]
        raise NotImplementedError(kind)

    def _by_bfs(self, n_subgraphs, n_nodes, n_cc, max_depth=3):
        """BFS trees from random start nodes (prepare_dataset.py:288-327)."""
        import networkx as nx
        subgraphs = []
        for _ in range(n_subgraphs):
            nodes_all: List[int] = []
            for start in random.sample(list(self.graph.nodes), n_cc):
                edges = nx.bfs_edges(self.graph, start, depth_limit=max_depth)
                nodes = [start] + [v for _, v in edges]
                nodes = nodes[:n_nodes]
                assert nx.is_connected(self.graph.subgraph(nodes))
                nodes_all.extend(nodes)
            subgraphs.append(nodes_all)
        return subgraphs

    def _by_planting(self, n_subgraphs, n_nodes, n_cc, gen):
        """Overlay a generated component on random base nodes
        (prepare_dataset.py:469-516)."""
        import networkx as nx
        subgraphs = []
        for _ in range(n_subgraphs):
            cur: List[int] = []
            for _ in range(n_cc):
                comp = self._component_graph(gen, n_nodes)
                ids = random.sample(list(self.graph.nodes), n_nodes)
                mapping = dict(zip(comp.nodes, ids))
                comp = nx.relabel_nodes(comp, mapping)
                self.graph = nx.compose(self.graph, comp)
                cur.extend(ids)
            subgraphs.append(cur)
        return subgraphs

    def _by_coreness(self, n_subgraphs, n_nodes, n_cc, gen):
        """Plant components on same-core-number node groups
        (prepare_dataset.py:227-286).

        Known reference-parity hazard (kept for byte-stability): star
        components have n_nodes+1 nodes, so the zip with the n_nodes
        sampled ids truncates (same as prepare_dataset.py:502-504) and
        the orphan component node keeps its small-int label; if that
        label collides with a sampled base node the compose merges them
        into a SELF-LOOP, and a later nx.core_number raises. The
        reference's generator crashes identically on such draws — they
        are unusable by construction; instance scans skip them
        (scripts/density_instance_scan.py SCAN_SKIP)."""
        import networkx as nx
        subgraphs = []
        core = nx.core_number(self.graph)
        by_core = defaultdict(list)
        for node, k in core.items():
            by_core[k].append(node)
        for k in list(by_core):
            pool = by_core[k]
            for _ in range(n_subgraphs):
                cur: List[int] = []
                for _ in range(n_cc):
                    if len(pool) < n_nodes:
                        break
                    comp = self._component_graph(gen, n_nodes)
                    ids = random.sample(pool, n_nodes)
                    mapping = dict(zip(comp.nodes, ids))
                    comp = nx.relabel_nodes(comp, mapping)
                    self.graph = nx.compose(self.graph, comp)
                    cur.extend(ids)
                    pool = list(set(pool) - set(ids))
                if cur:
                    subgraphs.append(cur)
        return subgraphs

    def _by_staple(self, n_subgraphs, n_nodes, n_cc, gen):
        """Attach generated components to the base graph k hops apart; used
        for the COMPONENT task where #CC is the label
        (prepare_dataset.py:156-225)."""
        import networkx as nx
        diameter = nx.diameter(self.graph)
        k_hops_range = [max(1, int(diameter * k)) for k in self.cfg["k_hops_range"]]
        cc_range = list(self.cfg["cc_range"])
        shuffle_cc = n_cc is None
        subgraphs = []
        for _ in range(n_subgraphs):
            cur: List[int] = []
            k_hops = random.choice(k_hops_range)
            root = random.choice(list(self.graph.nodes))
            ids, cc_root = self._staple_component(gen, n_nodes, root)
            cur.extend(ids)
            reach = nx.single_source_shortest_path_length(self.graph, root,
                                                          cutoff=k_hops)
            cands = [v for v, d in reach.items() if d == k_hops and v not in cur]
            if not cands:
                cands = [v for v, d in reach.items()
                         if d == max(reach.values())]
            ncc = random.choice(cc_range) if shuffle_cc else n_cc
            for _ in range(ncc - 1):
                new_root = random.choice(cands)
                ids, _ = self._staple_component(gen, n_nodes, new_root)
                cur.extend(ids)
            actual = nx.number_connected_components(self.graph.subgraph(cur))
            if shuffle_cc and actual in cc_range:
                subgraphs.append(cur)
            elif not shuffle_cc and (actual > 1 or ncc == 1):
                subgraphs.append(cur)
        return subgraphs

    def _staple_component(self, gen, n_nodes, root):
        # extend in place (the reference's disjoint_union copies the whole
        # growing graph per staple, making generation quadratic —
        # prepare_dataset.py:149-152; identical resulting graph)
        comp = self._component_graph(gen, n_nodes)
        base = len(self.graph.nodes)
        ids = [base + i for i in range(len(comp.nodes))]
        relabel = {v: base + i for i, v in enumerate(comp.nodes)}
        self.graph.add_nodes_from(ids)
        self.graph.add_edges_from((relabel[u], relabel[v])
                                  for u, v in comp.edges)
        cc_root = random.choice(ids)
        self.graph.add_edge(root, cc_root)
        return ids, cc_root

    # ------------------------------------------------------------ properties

    def _property(self, nodes):
        import networkx as nx
        sub = self.graph.subgraph(nodes)
        prop = self.desired_property
        if prop == "density":
            return nx.density(sub)
        if prop == "cut_ratio":
            rest = set(self.graph.nodes) - set(sub.nodes)
            boundary = len(list(nx.edge_boundary(self.graph, sub.nodes, rest)))
            return boundary / (len(sub.nodes) * (len(self.graph.nodes) - len(sub.nodes)))
        if prop == "coreness":
            return float(np.mean(list(nx.core_number(sub).values())))
        if prop == "cc":
            return nx.number_connected_components(sub)
        raise NotImplementedError(prop)

    def _drive_properties(self):
        """Edge add/remove loop until each subgraph's property hits a random
        target (prepare_dataset.py:552-623); then keep the largest CC and
        relabel consecutively (:625-639)."""
        import networkx as nx
        prop = self.desired_property
        if prop == "density":
            rng_vals, eps = self.cfg["density_range"], self.cfg["density_epsilon"]
        elif prop == "cut_ratio":
            rng_vals, eps = self.cfg["cut_ratio_range"], self.cfg["cut_ratio_epsilon"]
        else:
            return
        for s in self.subgraphs:
            target = random.choice(list(rng_vals))
            for _ in range(self.cfg["max_tries"]):
                cur = self._property(s)
                if abs(cur - target) < eps:
                    break
                sub = self.graph.subgraph(s)
                if prop == "density":
                    if cur > target:
                        edge = random.choice(list(sub.edges))
                        self.graph.remove_edge(*edge)
                    else:
                        u, v = random.sample(list(sub.nodes), 2)
                        self.graph.add_edge(u, v)
                else:  # cut_ratio
                    rest = set(self.graph.nodes) - set(sub.nodes)
                    boundary = list(nx.edge_boundary(self.graph, sub.nodes, rest))
                    if cur > target and boundary:
                        self.graph.remove_edge(*random.choice(boundary))
                    else:
                        u = random.choice(list(sub.nodes))
                        v = random.choice(list(rest))
                        self.graph.add_edge(u, v)
        self._relabel_to_largest_cc()

    def _relabel_to_largest_cc(self):
        import networkx as nx
        largest = max(nx.connected_components(self.graph), key=len)
        removed = set(self.graph.nodes) - set(largest)
        self.graph = self.graph.subgraph(largest)
        mapping = {v: i for i, v in enumerate(self.graph.nodes)}
        self.graph = nx.relabel_nodes(self.graph, mapping)
        self.subgraphs = [[mapping[n] for n in s if n not in removed]
                          for s in self.subgraphs]
        self.subgraphs = [s for s in self.subgraphs if s]

    # ----------------------------------------------------------------- labels

    def _label_subgraphs(self):
        import networkx as nx
        if not nx.is_connected(self.graph):
            self._relabel_to_largest_cc()
        values = [self._property(s) for s in self.subgraphs]
        if self.desired_property == "cc":
            # reference parity: 1 CC vs >1 CC (prepare_dataset.py:702).
            # NOTE digitize merges counts 2-4 into the first bin — the
            # reference does the same, and its CC_RANGE {1,5..10} (our
            # cc_range default) never produces those counts
            bins = [1, 5]
        else:
            bins = self._quantile_bins(sorted(values), self.n_bins)
        idx = np.digitize(values, bins=bins)
        return [chr(65 + i) for i in self._renumber(idx)]

    @staticmethod
    def _quantile_bins(sorted_vals, n_bins):
        """Quantile cut points (prepare_dataset.py:712-728)."""
        marks = (len(sorted_vals) / float(n_bins)) * np.arange(1, n_bins + 1)
        bins = np.unique(np.array([sorted_vals[int(b) - 1] for b in marks]))
        return np.delete(bins, len(bins) - 1)

    @staticmethod
    def _renumber(labels):
        remap = {}
        out = []
        for l in labels:
            if l not in remap:
                remap[l] = len(remap)
            out.append(remap[l])
        return out


def generate_mask(n_subgraphs: int, seed: int = 42) -> List[int]:
    """0=train, 1=val, 2=test, 80/10/10 (prepare_dataset.py:756-778)."""
    rng = random.Random(seed)
    idx = list(range(n_subgraphs))
    rng.shuffle(idx)
    n_train = int(n_subgraphs * 0.8)
    n_val = (n_subgraphs - n_train) // 2
    mask = [2] * n_subgraphs
    for i in idx[:n_train]:
        mask[i] = 0
    for i in idx[n_train:n_train + n_val]:
        mask[i] = 1
    return mask


def write_subgraph_tsv(path: str | Path, subgraphs, labels, mask):
    """Dash-delimited TSV writer (prepare_dataset.py:781-799)."""
    names = {0: "train", 1: "val", 2: "test"}
    with open(path, "w") as f:
        for sg, lab, m in zip(subgraphs, labels, mask):
            if not sg:
                continue
            f.write("\t".join(["-".join(str(v) for v in sg), str(lab),
                               names[m]]) + "\n")


def build_synthetic_dataset(out_dir: str | Path, desired_property: str = "density",
                            seed: int = 42, **kwargs):
    """Generate edge_list.txt + subgraphs.pth for a synthetic task."""
    import networkx as nx
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    defaults = dict(density=dict(subgraph_type="bfs"),
                    cut_ratio=dict(subgraph_type="bfs"),
                    coreness=dict(subgraph_type="plant", n_subgraphs=30,
                                  subgraph_generator="mixed", n_bins=5),
                    cc=dict(subgraph_type="staple", n_subgraphs=120,
                            n_connected_components=None))
    cfg = dict(defaults.get(desired_property, {}))
    cfg.update(kwargs)
    synth = SyntheticGraphBuilder(desired_property=desired_property,
                                  seed=seed, **cfg)
    nx.write_edgelist(synth.graph, str(out_dir / "edge_list.txt"), data=False)
    mask = generate_mask(len(synth.labels), seed=seed)
    write_subgraph_tsv(out_dir / "subgraphs.pth", synth.subgraphs,
                       synth.labels, mask)
    return synth
