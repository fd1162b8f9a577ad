"""Configuration: one dataclass covering the reference's argparse flag
surface (counterpart of ``immunostruct_tpu/config.py``).

The same fields and defaults as the JAX package, so that one run's
checkpoint paths (``derive_paths``) are the same in both packages. Left out
are the JAX package's persistent compilation cache and the fields that no
flag of the port sets and nothing reads (``param_dtype``, ``mesh_shape``,
``donate_state``, ``allow_microbatch_contrastive``). The flags that select
TPU-only machinery (``scan_layers``, ``stack_twins``, ``device_data``,
``data_parallel``) keep their fields; ``cli/common.py`` says what the port
does with each.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

# Repo root (the directory that contains this package).
ROOT_DIR = os.path.dirname(os.path.dirname(os.path.realpath(__file__)))


@dataclasses.dataclass
class Config:
    # -- model ---------------------------------------------------------------
    model: str = "HybridModelv2"
    use_wt_for_downstream: bool = False
    self_supervision: bool = False
    # architecture hyperparameters (reference: models/hybrid_models.py:11-19)
    gcn_layers: int = 5              # +1 input layer -> 6 EGNN convs total
    vae_hidden_dim: int = 512
    vae_latent_dim: int = 32
    gat_hidden_channels: int = 64
    property_embedding_dim: int = 8
    self_attention_heads: int = 1
    combined_attention_heads: int = 8
    mlp_features: int = 32

    # -- optimization ----------------------------------------------------------
    learning_rate_pretrain: float = 1e-3
    learning_rate_finetune: float = 1e-4
    num_epochs: int = 40
    batch_size: int = 150
    weight_decay: float = 1e-6
    coeff_contrastive: float = 0.0
    min_finetuning_batches: int = 64

    # -- data ------------------------------------------------------------------
    full_sequence: bool = False
    sequence_loss: bool = False
    feature_size: int = 23           # 20 one-hot + 3 coords after join
    coord_size: int = 3
    sequence_pad_count: int = 0      # train-time sequence masking count
    structure_pad_count: int = 0     # train-time structure masking count
    force_graph_augmentation: bool = False  # rotation for non-SSL training too
    num_workers: int = 0             # kept for CLI parity; batches are vectorized

    # paths (``$ROOT`` expands to the repo root)
    model_save_dir: str = "$ROOT/results/PropIEDB_ImmunoIEDB/"
    figure_save_dir: str = "$ROOT/figures/"
    graph_dir_IEDB: str = "$ROOT/data/graph_pyg_IEDB/"
    graph_dir_cancer: str = "$ROOT/data/graph_pyg_Cancer/"
    graph_dir_wildtype: str = "$ROOT/data/graph_pyg_Cancer_WT/"
    graph_dir_clinical: str = "$ROOT/data/graph_pyg_Clinical/"
    property_path_IEDB: str = "$ROOT/data/complete_score_Mprops_1_2_smoothed_sasa_v2.txt"
    property_path_cancer: str = "$ROOT/data/cedar_data_final_with_mprop1_mprop2_v2.txt"
    property_path_wildtype: str = "$ROOT/data/cedar_data_final_WILD_TYPE_with_mprop1_mprop2_v2.txt"
    seq_path_clinical: str = "$ROOT/data/hadrup_cancer_df_29K.txt"
    clinical_table_path: str = "$ROOT/data/All_samples_clinical.txt"
    hla_path: str = "$ROOT/data/HLA_27_seqs_csv.csv"

    # -- reproducibility / logging ----------------------------------------------
    seed: int = 1
    wandb_username: Optional[str] = None
    wandb_project: Optional[str] = None

    # -- accelerator knobs (no reference equivalent) ------------------------------
    compute_dtype: str = "bfloat16"  # activations dtype in the hot path
    pad_nodes_multiple: int = 8      # round corpus max_nodes up
    pad_edges_multiple: int = 128    # round corpus max_edges up ('fused' needs it)
    data_parallel: bool = False
    aggregation: str = "auto"        # ops/egnn.py AGGREGATIONS
    resume: bool = False             # within-stage resume from .resume snapshots
    device_data: object = None
    grad_accum_steps: int = 1
    scan_layers: object = None
    stack_twins: object = None
    # pretrain-collapse guard: detection always warns; reinit_on_collapse
    # additionally restarts the stage from a fresh init (max 2 retries)
    collapse_detection: bool = True
    reinit_on_collapse: bool = False
    # linear LR warmup (lr/100 -> lr) over this many epochs at the start of
    # each pretrain stage; 0 keeps the reference's constant-LR pretrain
    pretrain_warmup_epochs: int = 0
    # where the port runs: 'cuda' (the default) or 'cpu'
    device: str = "cuda"

    # derived (filled by `derive_paths`)
    model_save_path_pretrain: str = ""
    model_save_path_finetune: str = ""
    fig_save_folder: str = ""

    def derive_paths(self, stage_tag: str = "") -> "Config":
        """Build checkpoint paths from a hyperparameter-encoding string
        (reference: train_IEDB_wFT.py:41-45 / train_Cancer_wFT.py:50-57)."""
        model_str = (
            f"{self.model}-wtds_{self.use_wt_for_downstream}"
            f"-lr_pt_{self.learning_rate_pretrain}-lr_ft_{self.learning_rate_finetune}"
            f"-cc_{self.coeff_contrastive}-ssl_{self.self_supervision}"
            f"-ep_{self.num_epochs}-bs_{self.batch_size}-fseq_{self.full_sequence}"
            f"-seql_{self.sequence_loss}-fs_{self.feature_size}-cs_{self.coord_size}"
            f"-seed_{self.seed}"
        )
        if stage_tag:
            model_str = f"{stage_tag}:{model_str}"
        self.model_save_path_pretrain = os.path.join(self.model_save_dir, model_str + "_pretrain.ckpt")
        self.model_save_path_finetune = os.path.join(self.model_save_dir, model_str + "_finetune.ckpt")
        self.fig_save_folder = os.path.join(self.figure_save_dir, model_str)
        return self


def update_paths(config: Config, root: str = ROOT_DIR) -> Config:
    """Expand ``$ROOT`` in all string fields (reference: utils/update_paths.py:6-24)."""
    for field in dataclasses.fields(config):
        value = getattr(config, field.name)
        if isinstance(value, str) and "$ROOT" in value:
            setattr(config, field.name, value.replace("$ROOT", root))
    return config
