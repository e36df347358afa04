"""The serving slice as a whole: the port's SubGNNPipeline.predict against
the JAX package's on the mini fixture, with the same weights.

Both pipelines load and precompute their own copy of the fixture (the pool
and walks must come out equal, not be read from each other's cache); the
port receives the JAX weights through convert.params_from_jax and runs on
the CPU. Anchors, pool, walks and predictions must be equal; logits agree
to atol 1e-4 (BFS, DTW and two message-passing layers of float32 sums in
another order).
"""
import ast
import json
import re
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from subgnn_tpu.config import HParams, RunConfig as JRunConfig
from subgnn_tpu.train.runner import SubGNNPipeline as JPipe
from subgnn_tpu.train.checkpoint import save_checkpoint, dump_json
from subgnn_tpu.data.dataset import initialize_cc_ids as j_cc_ids
from subgnn_tpu.precompute.shortest_paths import shortest_path_rows as j_rows
from subgnn_tpu.precompute.border import border_sets_from_rows as j_border
from subgnn_tpu.sampling import anchors as j_anchors

from subgnn_tpu_torch.config import RunConfig as TRunConfig
from subgnn_tpu_torch.convert import params_from_jax
from subgnn_tpu_torch.train.runner import SubGNNPipeline as TPipe
from subgnn_tpu_torch.data.dataset import initialize_cc_ids as t_cc_ids
from subgnn_tpu_torch.precompute.shortest_paths import \
    shortest_path_rows as t_rows
from subgnn_tpu_torch.precompute.border import border_sets_from_rows as \
    t_border

REPO = Path(__file__).parents[1]
FIXTURE = REPO / "tests" / "fixtures" / "mini_multilabel" / "mini"
NOVEL = [[1, 5, 9, 13], [2, 6, 10], [30, 31, 32, 33, 34], [7, 8],
         [11, 12, 21, 22, 23], [3, 4, 14]]
PADS = dict(max_n_cc=4, max_len_cc=6)

# the small all-channel config of tests/test_mini_fixture_e2e.py, two layers
HP = dict(use_neighborhood=True, use_position=True, use_structure=True,
          max_sim_epochs=1, n_triangular_walks=2, random_walk_len=4,
          sample_walk_len=6, batch_size=4, n_layers=2, node_embed_size=8,
          linear_hidden_dim_1=8, linear_hidden_dim_2=8,
          n_anchor_patches_N_in=2, n_anchor_patches_N_out=2,
          n_anchor_patches_pos_in=3, n_anchor_patches_pos_out=3,
          n_anchor_patches_structure=2, seed=0)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture()
def roots(tmp_path):
    """Two independent copies of the fixture: one per package."""
    for name in ("jax_root", "torch_root"):
        shutil.copytree(FIXTURE, tmp_path / name / "mini")
    return tmp_path / "jax_root", tmp_path / "torch_root"


def _jax_pipeline(root, hp):
    pipe = JPipe(JRunConfig(task="mini", project_root=root), hp)
    pipe.load()
    pipe.precompute()
    _, params, state, _ = pipe.build_model()
    return pipe, params, state


def _torch_pipeline(root, hp):
    pipe = TPipe(TRunConfig(task="mini", project_root=root), hp,
                 device="cpu")
    pipe.load()
    pipe.precompute()
    return pipe


@pytest.mark.parametrize("extra", [{}, {"trainable_cc": True,
                                        "cc_aggregator": "max",
                                        "batch_norm": True}],
                         ids=["base", "trainable_cc_max_bn"])
def test_predict_matches_jax(roots, extra):
    hp = HParams(**HP, **extra)
    jpipe, params, state = _jax_pipeline(roots[0], hp)
    jres = jpipe.predict(NOVEL, params=params, state=state, **PADS)

    tpipe = _torch_pipeline(roots[1], hp)
    np.testing.assert_array_equal(tpipe.structure_anchors,
                                  jpipe.structure_anchors)
    np.testing.assert_array_equal(tpipe.int_walks, jpipe.int_walks)
    np.testing.assert_array_equal(tpipe.bor_walks, jpipe.bor_walks)

    p_t, s_t = params_from_jax(_np(params), _np(state), device="cpu")
    tres = tpipe.predict(NOVEL, params=p_t, state=s_t, **PADS)

    assert tres["logits"].shape == jres["logits"].shape == (len(NOVEL), 3)
    np.testing.assert_allclose(tres["logits"], jres["logits"], atol=1e-4,
                               rtol=0)
    np.testing.assert_array_equal(tres["pred"], jres["pred"])
    for key in ("cc_split", "structure_sims", "np_sim", "border_sets",
                "anchors", "forward", "total"):
        assert key in tres["timings"], key
    # a repeated request hits the BFS row cache and gives the same logits
    again = tpipe.predict(NOVEL, params=p_t, state=s_t, **PADS)
    assert again["timings"]["bfs_cache_miss"] == 0
    np.testing.assert_array_equal(again["logits"], tres["logits"])


def test_request_anchors_match_jax(roots):
    """The serving anchors (PREDICT_TAG stream) come out bit-identical."""
    hp = HParams(**HP)
    jpipe, _, _ = _jax_pipeline(roots[0], hp)
    tpipe = _torch_pipeline(roots[1], hp)
    cc_j = j_cc_ids(jpipe.graph, NOVEL, **PADS)
    cc_t = t_cc_ids(tpipe.graph, NOVEL, **PADS)
    np.testing.assert_array_equal(cc_t, cc_j)
    srcs = np.unique(cc_j[cc_j != 0]).astype(np.int64)
    n = jpipe.graph.n_nodes
    bor_j = j_border(srcs, j_rows(jpipe.graph, srcs), cc_j, 1, n)
    bor_t = t_border(srcs, t_rows(tpipe.graph, srcs), cc_t, 1, n)
    np.testing.assert_array_equal(bor_t, bor_j)

    got = tpipe._request_anchors(cc_t, bor_t, NOVEL, hp.seed)
    ni, nb = j_anchors.init_anchors_neighborhood(jpipe.hp, cc_j, bor_j,
                                                 hp.seed, 3)
    _, idx, iw, bw = j_anchors.init_anchors_structure(
        jpipe.hp, jpipe.structure_anchors, jpipe.int_walks, jpipe.bor_walks,
        hp.seed)
    expect = {"neigh_int": ni, "neigh_bor": nb,
              "pos_int": j_anchors.init_anchors_pos_int(jpipe.hp, NOVEL,
                                                        hp.seed, 3),
              "pos_ext": j_anchors.init_anchors_pos_ext(jpipe.hp,
                                                        jpipe.graph, hp.seed),
              "struc_pool_idx": idx, "struc_int_walks": iw,
              "struc_bor_walks": bw}
    assert set(got) == set(expect)
    for k in expect:
        np.testing.assert_array_equal(np.asarray(got[k]), expect[k], k)


def test_cli_serves_a_jax_checkpoint(roots, tmp_path, capsys):
    """The port's predict CLI restores a checkpoint pickled by the JAX
    package and prints the same predictions as the JAX CLI."""
    from subgnn_tpu.cli.predict import run_predict as j_run_predict
    from subgnn_tpu_torch.cli.predict import main as t_main

    hp = HParams(**HP)
    jpipe, params, state = _jax_pipeline(roots[0], hp)
    results = tmp_path / "run"
    dump_json(results / "hyperparams.json", jpipe.hp.to_dict())
    save_checkpoint(results / "checkpoints" /
                    "epoch=0-val_micro_f1=0.50-val_acc=0.50-val_auroc=0.50.ckpt",
                    params, state, meta={"epoch": 0})
    sub_file = tmp_path / "new.txt"
    sub_file.write_text("\n".join("-".join(map(str, s)) for s in NOVEL))

    jout = j_run_predict("mini", str(roots[0]), str(results), NOVEL,
                         log_fn=None)
    out_file = tmp_path / "pred.json"
    t_main(["-task", "mini", "-project_root", str(roots[1]),
            "-restoreModelPath", str(results), "-subgraphs", str(sub_file),
            "-out", str(out_file), "-device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == {"n": len(NOVEL), "pred": jout["pred"]}
    tout = json.loads(out_file.read_text())
    assert tout["pred"] == jout["pred"]
    assert tout["classes"] == jout["classes"]
    np.testing.assert_allclose(tout["probs"], jout["probs"], atol=1e-4)


def test_both_clis_serve_a_port_checkpoint(roots, tmp_path, capsys):
    """A checkpoint written by the port (train/checkpoint.py, the format its
    Trainer saves) is served by the JAX predict CLI and the port's, with the
    same predictions as the port's own predict on those weights."""
    from subgnn_tpu.cli.predict import run_predict as j_run_predict
    from subgnn_tpu_torch.cli.predict import main as t_main
    from subgnn_tpu_torch.train.checkpoint import (
        dump_json as t_dump_json, save_checkpoint as t_save_checkpoint)

    hp = HParams(**HP, batch_norm=True)
    tpipe = _torch_pipeline(roots[1], hp)
    _, params, state = tpipe.build_model(seed=3)
    expect = tpipe.predict(NOVEL, params=params, state=state, **PADS)
    results = tmp_path / "run"
    t_dump_json(results / "hyperparams.json", tpipe.hp.to_dict())
    t_save_checkpoint(results / "checkpoints" /
                      "epoch=0-val_micro_f1=0.50-val_acc=0.50-val_auroc=0.50"
                      ".ckpt", params, state, meta={"epoch": 0})
    jout = j_run_predict("mini", str(roots[0]), str(results), NOVEL,
                         log_fn=None)
    assert jout["pred"] == expect["pred"].tolist()
    np.testing.assert_allclose(jout["probs"], expect["probs"], atol=1e-4)
    out_file = tmp_path / "pred.json"
    sub_file = tmp_path / "new.txt"
    sub_file.write_text("\n".join("-".join(map(str, s)) for s in NOVEL))
    t_main(["-task", "mini", "-project_root", str(roots[1]),
            "-restoreModelPath", str(results), "-subgraphs", str(sub_file),
            "-out", str(out_file), "-device", "cpu"])
    capsys.readouterr()
    tout = json.loads(out_file.read_text())
    assert tout["pred"] == jout["pred"]
    np.testing.assert_allclose(tout["probs"], expect["probs"], atol=1e-6)


def test_entry_points_refuse_cuda_without_a_gpu(roots, tmp_path,
                                                monkeypatch):
    """Asking for the card on a machine without one raises; nothing falls
    back to the CPU silently."""
    from subgnn_tpu_torch.cli.predict import main as t_main
    from subgnn_tpu_torch.models.subgnn import SubGNNModel

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = TRunConfig(task="mini", project_root=roots[1])
    with pytest.raises(RuntimeError, match="cuda"):
        TPipe(rc, HParams(**HP))
    with pytest.raises(RuntimeError, match="cuda"):
        params_from_jax({"w": np.zeros(2, np.float32)})
    with pytest.raises(RuntimeError, match="cuda"):
        SubGNNModel(HParams(**HP), 40, 2, True).init_params(
            torch.Generator(), np.zeros((40, 8), np.float32))
    results = tmp_path / "run"
    dump_json(results / "hyperparams.json", HParams(**HP).to_dict())
    sub_file = tmp_path / "new.txt"
    sub_file.write_text("1-5-9\n")
    with pytest.raises(RuntimeError, match="cuda"):
        t_main(["-task", "mini", "-project_root", str(roots[1]),
                "-restoreModelPath", str(results),
                "-subgraphs", str(sub_file)])


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            yield node.args[0].value


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "subgnn_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    for module in ("parallel/mesh.py", "parallel/collectives.py",
                   "parallel/audit.py", "entry.py"):
        assert REPO / "subgnn_tpu_torch" / module in files
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "optax", "subgnn_tpu"), \
                f"{path.relative_to(REPO)} imports {mod}"
    # nor reads, builds or loads the JAX package's host library: no port
    # file names a path under subgnn_tpu/native, as text or as path parts
    native_files = [REPO / "chip_smoke.py", *sorted(
        p for p in (REPO / "subgnn_tpu_torch").rglob("*")
        if p.suffix in (".py", ".cpp", ".cu"))]
    assert any(p.suffix == ".cpp" for p in native_files)
    for path in native_files:
        text = path.read_text()
        assert not re.search(r"subgnn_tpu[/\\]native|libsubgnn_native\.so",
                             text), f"{path.relative_to(REPO)}"
        if path.suffix == ".py":
            parts = [n.value for n in ast.walk(ast.parse(text))
                     if isinstance(n, ast.Constant)]
            assert "subgnn_tpu" not in parts, f"{path.relative_to(REPO)}"
