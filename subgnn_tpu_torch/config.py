"""Typed hyperparameter / run configuration.

Key names are drop-in compatible with the reference config schema
(reference: SubGNN/config_files/README.md, SubGNN/train_config.py:74-86 and
the frozen dicts under best_model_hyperparameters/*/hyperparams.json), so the
shipped best-hyperparameter JSON files can be loaded unchanged.

A copy of subgnn_tpu/config.py: the PyTorch port imports nothing from the
JAX package, and both read the same hyperparams.json files.
"""
from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path
from typing import Any, Dict, Optional

PAD_VALUE = 0


@dataclasses.dataclass
class HParams:
    """All model/training hyperparameters with reference-compatible names."""

    # --- channels ---
    use_neighborhood: bool = True
    use_structure: bool = True
    use_position: bool = True

    # --- model dims ---
    node_embed_size: int = 32          # overwritten from the embedding matrix
    n_layers: int = 2
    linear_hidden_dim_1: int = 64
    linear_hidden_dim_2: int = 32

    # --- anchor patches ---
    n_anchor_patches_pos_out: int = 50
    n_anchor_patches_pos_in: int = 25
    n_anchor_patches_N_in: int = 10
    n_anchor_patches_N_out: int = 25
    n_anchor_patches_structure: int = 15
    neigh_sample_border_size: int = 1
    resample_anchor_patches: bool = False

    # --- structure channel sampling ---
    structure_patch_type: str = "triangular_random_walk"  # or "ego_graph"
    structure_anchor_patch_radius: int = 1                # only for ego_graph
    sample_walk_len: int = 25
    n_triangular_walks: int = 10
    random_walk_len: int = 15
    rw_beta: float = 0.7
    max_sim_epochs: int = 5
    structure_similarity_fn: str = "dtw"

    # --- LSTM (structure patch encoder) ---
    lstm_aggregator: str = "last"      # 'last' or 'sum'
    lstm_n_layers: int = 1
    lstm_dropout: float = 0.0

    # --- MPN ---
    use_mpn_projection: bool = True
    norm_pos_struc_embed: bool = False
    batch_norm: bool = False

    # --- readout / head ---
    ff_attn: bool = False
    lin_dropout: float = 0.0
    cc_aggregator: str = "sum"         # 'sum' or 'max'
    trainable_cc: bool = False

    # --- embeddings ---
    embedding_type: str = "gin"        # 'gin' or 'graphsaint'
    freeze_node_embeds: bool = False

    # --- optimization ---
    batch_size: int = 64
    learning_rate: float = 5e-4
    grad_clip: float = 0.0
    max_epochs: int = 100
    seed: int = 0
    auto_lr_find: bool = False

    # --- misc / runtime ---
    debug_mode: bool = False           # NaN checks + grad-norm tracking
                                       # (reference: train.py:340-351,439
                                       # anomaly detection + grad tracking)
    compute_similarities: bool = False
    n_processes: int = 4
    subset_data: bool = False
    # vestigial reference keys, accepted so frozen hyperparams.json files
    # load unchanged (reference: train.py:66,122,128,163 — plumbed, unread)
    print_train_times: bool = False
    set2set: bool = False
    gamma_shortest_max_distance_N: int = 0   # vestigial
    gamma_shortest_max_distance_P: int = 0   # vestigial

    # --- extensions absent from the reference ---
    dtype: str = "float32"             # compute dtype for dense ops
    mesh_data_axis: int = 1            # data-parallel size (subgraph axis)
    mesh_node_axis: int = 1            # node-axis sharding of sim tensors
    # batch each layer's K active channel-update matmuls into ONE stacked
    # contraction (models/subgnn.py) — an op-sequencing lever for the
    # fixed ~900us/step (PERF.md round 5); numerically identical math
    fused_channel_update: bool = False

    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "HParams":
        field_names = {f.name for f in dataclasses.fields(cls)}
        known = {k: v for k, v in d.items() if k in field_names and k != "extras"}
        extras = {k: v for k, v in d.items() if k not in field_names}
        hp = cls(**known)
        hp.extras = extras
        return hp

    @classmethod
    def from_json(cls, path: str | Path) -> "HParams":
        return cls.from_dict(load_commented_json(path))

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d.pop("extras")
        d.update(self.extras)
        return d

    def replace(self, **kw) -> "HParams":
        return dataclasses.replace(self, **kw)


def load_commented_json(path: str | Path) -> Dict[str, Any]:
    """Load JSON that may contain //-style comments.

    The reference uses commentjson for its run configs
    (reference: SubGNN/train_config.py:46-51); we strip comments manually to
    avoid the extra dependency.
    """
    text = Path(path).read_text()
    # remove // comments not inside strings (configs never embed '//' in values)
    text = re.sub(r"^\s*//.*$", "", text, flags=re.MULTILINE)
    text = re.sub(r",\s*([}\]])", r"\1", text)  # tolerate trailing commas
    return json.loads(text)


@dataclasses.dataclass
class RunConfig:
    """Run configuration: dataset paths + HPO search spec + trainer settings.

    Mirrors the reference's run-config layout (data/tb/optuna/hyperparams_fix/
    hyperparams_optuna; reference: SubGNN/train_config.py:202-250).
    """

    task: str = "density"
    project_root: Path = Path(".")
    tb_dir: str = "tensorboard"
    tb_name: str = "run"
    monitor_metric: str = "val_micro_f1"
    opt_direction: str = "maximize"
    opt_n_trials: int = 1
    sampler: str = "random"
    pruning: bool = False
    grid_search_space: Optional[Dict[str, Any]] = None
    hyperparams_fix: Dict[str, Any] = dataclasses.field(default_factory=dict)
    hyperparams_optuna: Dict[str, Any] = dataclasses.field(default_factory=dict)
    no_gpu: bool = False
    # optional per-file overrides of the <project_root>/<task>/ layout
    # (reference train.py:52-56 exposes each path as its own flag)
    graph_path_override: Optional[Path] = None
    subgraphs_path_override: Optional[Path] = None
    shortest_paths_path_override: Optional[Path] = None
    similarities_path_override: Optional[Path] = None
    embedding_path_override: Optional[Path] = None

    @classmethod
    def from_json(cls, path: str | Path) -> "RunConfig":
        raw = load_commented_json(path)
        optuna_cfg = raw.get("optuna", {})
        return cls(
            task=raw.get("data", {}).get("task", "density"),
            tb_dir=raw.get("tb", {}).get("dir", "tensorboard"),
            tb_name=raw.get("tb", {}).get("name", "run"),
            monitor_metric=optuna_cfg.get("monitor_metric", "val_micro_f1"),
            opt_direction=optuna_cfg.get("opt_direction", "maximize"),
            opt_n_trials=optuna_cfg.get("opt_n_trials", 1),
            sampler=optuna_cfg.get("sampler", "random"),
            pruning=optuna_cfg.get("pruning", False),
            grid_search_space=optuna_cfg.get("grid_search_space"),
            hyperparams_fix=dict(raw.get("hyperparams_fix", {})),
            hyperparams_optuna=dict(raw.get("hyperparams_optuna", {})),
            no_gpu="no_gpu" in raw,
        )

    # dataset file layout (reference: SubGNN/train_config.py:216-231),
    # each overridable per file (reference: SubGNN/train.py:52-56)
    def data_dir(self) -> Path:
        return Path(self.project_root) / self.task

    def graph_path(self) -> Path:
        return Path(self.graph_path_override or
                    self.data_dir() / "edge_list.txt")

    def subgraphs_path(self) -> Path:
        return Path(self.subgraphs_path_override or
                    self.data_dir() / "subgraphs.pth")

    def shortest_paths_path(self) -> Path:
        return Path(self.shortest_paths_path_override or
                    self.data_dir() / "shortest_path_matrix.npy")

    def degree_sequence_path(self) -> Path:
        return self.data_dir() / "degree_sequence.txt"

    def ego_graph_path(self) -> Path:
        return self.data_dir() / "ego_graphs.txt"

    def similarities_path(self) -> Path:
        return Path(self.similarities_path_override or
                    self.data_dir() / "similarities")

    def embedding_path(self, embedding_type: str) -> Path:
        if self.embedding_path_override:
            return Path(self.embedding_path_override)
        if embedding_type == "gin":
            return self.data_dir() / "gin_embeddings.pth"
        elif embedding_type in ("graphsaint", "graphsaint_gcn"):
            return self.data_dir() / "graphsaint_gcn_embeddings.pth"
        raise NotImplementedError(embedding_type)
