"""The benchmark's yardstick on the CPU: the generator, finding files by
name, the trace reduction, the kernels' bounds and the FLOP formula."""
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from scipy.sparse import csgraph

from benchmark.harness import bounds, data, flops, trace
from benchmark.harness.common import BENCH_DIR, ROOT, load_json
from benchmark.reference import graph as RG
from benchmark.reference import model as RM
from benchmark.tests import tiny


def config(name):
    return load_json(BENCH_DIR / "configs" / f"{name}.json")


def test_graph_has_the_published_counts_and_its_own_seed():
    ds = config("ppi_bp")["dataset"]
    e = data.make_graph(ds)
    assert e.shape == (ds["n_edges"], 2)
    assert (e[:, 0] < e[:, 1]).all() and e.min() >= 1
    assert e.max() <= ds["n_nodes"]
    assert len(np.unique(e[:, 0] * (ds["n_nodes"] + 1) + e[:, 1])) == len(e)
    g = RG.Graph(e, ds["n_nodes"])
    assert csgraph.connected_components(g.adj[1:, 1:])[0] == 1
    assert (g.degree[1:] >= 1).all()
    assert g.degree.max() > 20 * g.degree[1:].mean()        # heavy tail
    assert (data.make_graph(ds) == e).all()
    assert not (data.make_graph(dict(ds, seed=ds["seed"] + 1)) == e).all()


@pytest.mark.parametrize("name", ["ppi_bp", "hpo_metab"])
def test_subgraph_shapes_follow_table_1(name):
    ds = config(name)["dataset"]
    sh = data.subgraph_shapes(ds, ds["n_subgraphs"])
    assert len(sh) == ds["n_subgraphs"]
    assert abs(sh[:, 0].mean() - ds["subgraph_size_mean"]) < 0.05 * \
        ds["subgraph_size_mean"]
    assert abs(sh[:, 0].std() - ds["subgraph_size_sd"]) < 0.1 * \
        ds["subgraph_size_sd"]
    assert abs(sh[:, 1].mean() - ds["components_mean"]) < 0.05 * \
        ds["components_mean"]
    assert abs(sh[:, 1].std() - ds["components_sd"]) < 0.1 * \
        ds["components_sd"]
    assert (sh[:, 1] >= 1).all() and (sh[:, 1] <= sh[:, 0]).all()


def test_dataset_components_are_the_planned_ones(tmp_path):
    d = tiny.make(tmp_path)
    cfg = load_json(d / "configs" / "ppi_bp.json")
    out = data.make_dataset(cfg)
    ds = cfg["dataset"]
    g = RG.Graph(out["edges"], ds["n_nodes"])
    shapes = data.subgraph_shapes(ds, ds["n_subgraphs"])
    n_val = int((np.arange(len(shapes)) % 10 == 4).sum())
    assert len(out["lists"]["val"]) == n_val
    sizes = sorted(len(s) for sp in out["lists"].values() for s in sp)
    comps = [len(g.components(s)) for sp in out["lists"].values() for s in sp]
    assert sum(comps) >= 0.95 * shapes[np.arange(len(shapes)) % 10 != 9,
                                       1].sum()
    assert max(sizes) <= ds["subgraph_size_max"]
    again = data.make_dataset(cfg)
    assert again["lists"] == out["lists"]


def test_files_are_found_by_name(tmp_path):
    d = tiny.make(tmp_path)
    bench = load_json(d / "BENCHMARK.json")
    cfg = load_json(d / "configs" / "ppi_bp.json")
    (d / "configs" / "new_cfg.json").write_text(json.dumps(cfg))
    t = load_json(d / "traffic" / "train.json")
    t["warmup_epochs"] = 5
    (d / "traffic" / "new_mix.json").write_text(json.dumps(t))
    (d / "metrics" / "new_metric.train.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    bench["workloads"].append({"name": "new_cfg.new_mix", "config": "new_cfg",
                               "traffic": "new_mix", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "new_metric.train", "unit": "%",
                               "better": "higher", "source": "host_clock",
                               "layer": "device", "moves":
                               "train_subgraphs_per_s",
                               "workloads": ["new_cfg.new_mix"]})
    bench["end_to_end"][0]["workloads"].append("new_cfg.new_mix")
    c = tiny.Cell("new_cfg.new_mix", bench, d)
    assert c.traffic["warmup_epochs"] == 5 and c.config == cfg
    assert c.driver().__name__.endswith(".fit")
    assert "new_metric.train" in [m["name"] for m in c.per_layer]
    assert c.reader("new_metric.train")({}) == 42.0


def test_idle_share_union_on_a_made_up_trace():
    ev = lambda a, b, name="k", i=0: SimpleNamespace(
        time_range=SimpleNamespace(start=a, end=b), name=name, id=i)
    dev = [ev(0, 10, i=7), ev(5, 20, i=7), ev(30, 40, i=9), ev(35, 38, i=9),
           ev(60, 70, i=9)]
    host = [ev(20, 30, "aten::copy_"), ev(40, 60, "cudaStreamSynchronize"),
            ev(41, 59, "inner_op"), ev(0, 1, "cudaGraphLaunch", 7),
            ev(29, 30, "cudaGraphLaunch", 9)]
    red = trace.reduce_events(dev, host, wall_s=1e-4)
    assert red["busy_s"] == pytest.approx(40e-6)
    assert red["idle_gaps"][0] == ("inner_op", pytest.approx(20e-6))
    assert red["idle_gaps"][1] == ("aten::copy_", pytest.approx(10e-6))
    assert trace.device_time(red, "k") == (pytest.approx(48e-6), 5)
    assert trace.graph_activities(red) == [2, 3]


def test_segment_bytes_from_ids():
    ids = np.array([[0, 3, 3], [5, 0, 0]])
    assert bounds.segment_bytes(ids, table_rows=10, dim=4) == \
        3 * (4 + 16) + 10 * 16


def test_dtw_bound_from_lengths():
    cl = np.array([3, 0, 2])
    al = np.array([4, 5])
    cells = 2 * 5 * 9
    ops_s = cells * 8 / bounds.PEAK_FP32_FLOPS
    bytes_s = 2 * (4 * (5 + 3 + 9 + 2) + 4 * 6) / bounds.PEAK_HBM_BYTES
    assert bounds.dtw_bound_s(cl, al) == pytest.approx(max(ops_s, bytes_s))


@pytest.mark.parametrize("name", ["ppi_bp", "hpo_metab"])
@pytest.mark.parametrize("backward", [False, True])
def test_flops_match_the_flop_counter(name, backward, tmp_path):
    from torch.utils.flop_counter import FlopCounterMode
    hp = dict(config(name)["hparams"], node_embed_size=8, batch_size=3,
              n_anchor_patches_N_in=2, n_anchor_patches_N_out=3,
              n_anchor_patches_pos_in=2, n_anchor_patches_pos_out=4,
              n_anchor_patches_structure=3, n_triangular_walks=2,
              random_walk_len=4, linear_hidden_dim_1=5, linear_hidden_dim_2=4)
    hp["n_layers"] = min(hp["n_layers"], 2)
    from subgnn_tpu_torch.config import HParams
    from benchmark.harness.weights import program_params
    from benchmark.harness.check_fit import _tree
    n, B, C, L, K, pool = 20, 3, 2, 3, 6, 7
    _, _, _, p0 = program_params(HParams.from_dict(hp), n, K, 1,
                                 torch.device("cpu"))
    flat = {p: t.clone().requires_grad_(True) for p, t in p0.items()}
    tree = _tree(flat)
    g = torch.Generator().manual_seed(0)
    ri = lambda *s, hi=n + 1: torch.randint(1, hi, s, generator=g)
    nl = hp["n_layers"]
    batch = {"cc": ri(B, C, L), "np_sim": torch.rand(B, C, n, generator=g),
             "i_sim": torch.rand(B, C, pool, generator=g),
             "b_sim": torch.rand(B, C, pool, generator=g)}
    a = {"neigh_int": ri(nl, B, C, 2), "neigh_bor": ri(nl, B, C, 3),
         "pos_int": ri(nl, B, 2), "pos_ext": ri(nl, 4),
         "struc_pool_idx": ri(nl, 3, hi=pool) - 1,
         "struc_int_walks": ri(nl, 3, 2, 4),
         "struc_bor_walks": ri(nl, 3, 2, 4)}
    y = torch.randint(0, K, (B,), generator=g)
    with FlopCounterMode(display=False) as fc:
        loss = RM.loss(RM.forward(tree, hp, batch, a), y)
        if backward:
            torch.autograd.grad(loss, list(flat.values()), allow_unused=True)
    assert flops.model_flops(hp, B, C, K, backward) == fc.get_total_flops()


def test_cells_and_metrics_keep_to_the_contract():
    bench = load_json(ROOT / "BENCHMARK.json")
    import re
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert name.match(m["name"]) and unit.match(m["unit"])
        assert (BENCH_DIR / "metrics" / f"{m['name']}.py").exists() or \
            m in bench["end_to_end"]
    for w in bench["workloads"]:
        assert name.match(w["name"]) and len(w["why"]) <= 200
        assert (BENCH_DIR / "limits" / f"{w['name']}.json").exists()
