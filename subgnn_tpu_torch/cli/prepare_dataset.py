"""Dataset preparation: synthetic graph, graph metrics, node embeddings.

Usage:
  python -m subgnn_tpu_torch.cli.prepare_dataset -out <root>/density \\
      -property density [-n 1000] [-n_subgraphs 250] [-conv gin] \\
      [-device cpu]

Port of subgnn_tpu/cli/prepare_dataset.py (the reference's
prepare_dataset.py + train_node_emb.py + precompute_graph_metrics.py flow)
in one command: writes edge_list.txt, subgraphs.pth, shortest_path_matrix.npy
(the C++ all-pairs BFS), degree_sequence.txt, ego_graphs.txt, and
<conv>_embeddings.{pth,npy} from the node-embedding pretrainer, which runs on
`-device` (default cuda; raises without a GPU). Generating the graph needs
networkx; `--skip_graph` (an existing edge_list.txt / subgraphs.pth) does
not.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from ..data.graph import CSRGraph
from ..device import resolve_device
from ..precompute.shortest_paths import (degree_dict, ego_graphs_1hop,
                                         shortest_path_matrix)
from ..prepare.node_emb import (greedy_hyperparam_search, save_embeddings,
                                train_node_embeddings)


def precompute_graph_metrics(task_dir: Path, graph: CSRGraph,
                             override: bool = False,
                             max_sp_nodes: int = 20000):
    """ego_graphs.txt + degree_sequence.txt + shortest_path_matrix.npy
    (reference: prepare_dataset/precompute_graph_metrics.py:28-70). The
    dense all-pairs matrix is skipped above max_sp_nodes nodes; the training
    pipeline then computes the rows it needs."""
    (task_dir / "similarities").mkdir(parents=True, exist_ok=True)
    ego_p = task_dir / "ego_graphs.txt"
    if override or not ego_p.exists():
        ego_p.write_text(json.dumps(ego_graphs_1hop(graph)))
    deg_p = task_dir / "degree_sequence.txt"
    if override or not deg_p.exists():
        deg_p.write_text(json.dumps(degree_dict(graph)))
    sp_p = task_dir / "shortest_path_matrix.npy"
    if (override or not sp_p.exists()) and graph.n_nodes <= max_sp_nodes:
        np.save(sp_p, shortest_path_matrix(graph))


def prepare(out_dir: str, desired_property: str = "density", seed: int = 42,
            conv: str = "gin", emb_dim: int = 64, emb_epochs: int = 100,
            generate_graph: bool = True, generate_emb: bool = True,
            emb_minibatch: str = "full", emb_nb_size: int = -1,
            emb_nb_exact: bool = False, emb_search: bool = False,
            emb_plots: bool = False, log_fn=print, device: str = "cuda",
            **gen_kwargs):
    dev = resolve_device(device)
    task_dir = Path(out_dir)
    if generate_graph:
        from ..prepare.synthetic import build_synthetic_dataset
        build_synthetic_dataset(task_dir, desired_property=desired_property,
                                seed=seed, **gen_kwargs)
        if log_fn:
            log_fn(f"wrote {task_dir}/edge_list.txt + subgraphs.pth")
    graph = CSRGraph.from_edgelist(task_dir / "edge_list.txt")
    # a freshly written graph must regenerate its metrics: cached files
    # from a previous graph in the same dir would be wrong
    precompute_graph_metrics(task_dir, graph, override=generate_graph)
    if log_fn:
        log_fn("precomputed graph metrics")
    if generate_emb:
        if emb_search:
            emb, metrics, best_hp = greedy_hyperparam_search(
                graph, conv_type=conv, minibatch=emb_minibatch,
                epochs=emb_epochs, seed=seed,
                nb_size=(emb_nb_size if emb_nb_size != -1 else None),
                nb_exact=emb_nb_exact, log_fn=log_fn, device=dev)
            (task_dir / "node_emb_hyperparams.json").write_text(
                json.dumps(best_hp, indent=2))
            if log_fn:
                log_fn(f"greedy search winner: {best_hp}")
        else:
            emb, metrics = train_node_embeddings(
                graph, conv_type=conv, out_dim=emb_dim, epochs=emb_epochs,
                seed=seed, minibatch=emb_minibatch, nb_size=emb_nb_size,
                nb_exact=emb_nb_exact, device=dev,
                plots_dir=task_dir / "plots" if emb_plots else None)
        save_embeddings(task_dir, emb, conv)
        if log_fn:
            log_fn(f"node embeddings: {metrics}")
    return task_dir


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-out", type=str, required=True)
    parser.add_argument("-property", type=str, default="density",
                        choices=["density", "cut_ratio", "coreness", "cc"])
    parser.add_argument("-seed", type=int, default=42)
    parser.add_argument("-n", type=int, default=1000)
    # None keeps build_synthetic_dataset's per-property defaults
    parser.add_argument("-n_subgraphs", type=int, default=None)
    parser.add_argument("-n_subgraph_nodes", type=int, default=None)
    parser.add_argument("-conv", type=str, default="gin",
                        choices=["gin", "graphsaint_gcn"])
    parser.add_argument("-emb_dim", type=int, default=64)
    parser.add_argument("-emb_epochs", type=int, default=100)
    parser.add_argument("-emb_minibatch", type=str, default="full",
                        choices=["full", "graphsaint", "neighbor"])
    parser.add_argument("-emb_nb_size", type=int, default=-1,
                        help="neighbor mode only: per-seed in-edge budget "
                             "(-1 = all neighbors, >0 thins i.i.d. at rate "
                             "nb_size/deg by default)")
    parser.add_argument("--emb_nb_exact", action="store_true",
                        help="with -emb_nb_size > 0: keep exactly "
                             "min(nb_size, deg) in-edges per seed without "
                             "replacement instead of the i.i.d. thinning")
    parser.add_argument("--emb_search", action="store_true",
                        help="greedy coordinate-descent node-emb hparam "
                             "search")
    parser.add_argument("--emb_plots", action="store_true",
                        help="save loss/ROC curve plots under <out>/plots")
    parser.add_argument("--skip_graph", action="store_true",
                        help="only precompute metrics + embeddings for an "
                             "existing edge_list.txt/subgraphs.pth")
    parser.add_argument("-device", type=str, default="cuda",
                        help="device of the pretrainer (cuda or cpu)")
    args = parser.parse_args(argv)
    prepare(args.out, args.property, args.seed, args.conv, args.emb_dim,
            args.emb_epochs, generate_graph=not args.skip_graph,
            emb_minibatch=args.emb_minibatch, emb_nb_size=args.emb_nb_size,
            emb_nb_exact=args.emb_nb_exact, emb_search=args.emb_search,
            emb_plots=args.emb_plots, device=args.device, n=args.n,
            **{k: v for k, v in (("n_subgraphs", args.n_subgraphs),
                                 ("n_subgraph_nodes", args.n_subgraph_nodes))
               if v is not None})


if __name__ == "__main__":
    main()
