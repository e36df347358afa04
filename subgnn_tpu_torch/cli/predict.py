"""Serving CLI: classify NEW subgraphs with a trained checkpoint.

Port of subgnn_tpu/cli/predict.py with the same flags and JSON output, plus
-device (default cuda; pass -device cpu to run on the CPU). Checkpoints
written by the JAX package are served as they are.

Usage:
  python -m subgnn_tpu_torch.cli.predict -task density -project_root data \\
      -restoreModelPath <results dir with hyperparams.json + checkpoints/> \\
      -subgraphs new_subgraphs.txt [-out predictions.json] [-device cuda]

new_subgraphs.txt: one subgraph per line, '-'-joined **1-based** node ids
(0 is PAD). The node-id column of subgraphs.pth uses RAW 0-based ids: add 1
before copying ids from that file.
"""
from __future__ import annotations

import argparse
import json
import re
from pathlib import Path

from ..config import RunConfig
from ..convert import tree_from_numpy
from ..train.checkpoint import dump_json, load_checkpoint, load_params_filtered
from ..train.runner import SubGNNPipeline, load_best_hyperparams


def read_node_lists(path: str | Path):
    """One subgraph per line, '-'-joined 1-based node ids."""
    lists = []
    for line in Path(path).read_text().strip().split("\n"):
        line = line.strip().split("\t")[0]
        if line:
            lists.append([int(tok) for tok in line.split("-")])
    return lists


def find_best_checkpoint(results_dir: str | Path) -> Path:
    """Best .ckpt under <results_dir>/checkpoints by the val_micro_f1
    embedded in the checkpoint filename."""
    ckpt_dir = Path(results_dir) / "checkpoints"
    best, best_v = None, float("-inf")
    for p in sorted(ckpt_dir.glob("*.ckpt")):
        m = re.search(r"val_micro_f1=([0-9.]+)", p.name)
        v = float(m.group(1)) if m else float("-inf")
        if v > best_v:
            best, best_v = p, v
    if best is None:
        raise FileNotFoundError(f"no .ckpt files under {ckpt_dir}")
    return best


def run_predict(task: str, project_root: str, restore_path: str,
                node_lists, checkpoint: str | None = None,
                device: str = "cuda", log_fn=print) -> dict:
    restore = Path(restore_path)
    hp = load_best_hyperparams(restore / "hyperparams.json")
    rc = RunConfig(task=task, project_root=Path(project_root))
    pipe = SubGNNPipeline(rc, hp, device=device)
    pipe.load()
    pipe.precompute()
    _, params, state = pipe.build_model()
    ckpt = Path(checkpoint) if checkpoint else find_best_checkpoint(restore)
    payload = load_checkpoint(ckpt)
    params = load_params_filtered(ckpt, params, payload=payload)
    if payload.get("state"):
        state = tree_from_numpy(payload["state"], pipe.device)
    if log_fn:
        log_fn(f"restored {ckpt.name}; predicting {len(node_lists)} "
               f"subgraphs on {pipe.device}")
    res = pipe.predict(node_lists, params=params, state=state)
    return {"pred": res["pred"].tolist(), "probs": res["probs"].tolist(),
            "checkpoint": str(ckpt),
            "classes": (pipe.binarizer.classes_.tolist()
                        if pipe.multilabel else None)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-task", required=True)
    ap.add_argument("-project_root", required=True)
    ap.add_argument("-restoreModelPath", required=True,
                    help="results dir with hyperparams.json + checkpoints/")
    ap.add_argument("-subgraphs", required=True,
                    help="file with one '-'-joined node-id list per line")
    ap.add_argument("-checkpoint", default=None,
                    help="explicit .ckpt path (default: best by "
                         "val_micro_f1 in the filename)")
    ap.add_argument("-out", default=None, help="write predictions JSON here")
    ap.add_argument("-device", default="cuda",
                    help="torch device (default cuda; 'cpu' must be asked "
                         "for explicitly)")
    args = ap.parse_args(argv)

    node_lists = read_node_lists(args.subgraphs)
    out = run_predict(args.task, args.project_root, args.restoreModelPath,
                      node_lists, checkpoint=args.checkpoint,
                      device=args.device)
    if args.out:
        dump_json(args.out, out)
    print(json.dumps({"n": len(node_lists), "pred": out["pred"]}))


if __name__ == "__main__":
    main()
