"""The Cancer comparative curriculum, the flagship entry point (counterpart
of ``immunostruct_tpu/cli/train_Cancer_wFT.py``; reference:
immunostruct/train_Cancer_wFT.py):

  stage 1: the IEDB foreignness pretrain (plain forward), AdamW;
  stage 2: the comparative cancer-foreignness pretrain (twin forward);
  stage 3: the comparative immunogenicity-BCE finetune, warmup-cosine rate,
           the train split cycled up to ``min_finetuning_batches`` batches;

each stage from the previous one's best checkpoint with a fresh head, then
comparative inference on the train split (its threshold) and the test split,
and the clinical survival validation: the clinical cohort scored with the
finetuned model, the per-patient loads split at their median, OS/PFS
log-rank p-values in the test split's stats (``--skip-clinical`` leaves it
out). The clinical corpus is loaded before any stage, so a sequence-width
mismatch fails before training.

Usage:
  python -m immunostruct_tpu_torch.cli.train_Cancer_wFT \\
      --model HybridModelv2_Comparative --full-sequence --sequence-loss \\
      --aggregation pallas --graph-dir-IEDB ... \\
      --graph-dir-cancer ... --graph-dir-wildtype ... --property-path-IEDB ... \\
      --property-path-cancer ... --property-path-wildtype ... --hla-path ... \\
      --graph-dir-clinical ... --seq-path-clinical ... \\
      --clinical-table-path ... --figure-save-dir ...

``--device`` defaults to cuda; ``--device cpu`` runs the kernels' plain
versions. The three stages' pipelines come from ``pick_pipeline``
(``--device-data``: on a card the corpora stay on the device by default);
the threshold pass and the clinical pass read through the host pipeline.
"""

from __future__ import annotations

import numpy as np
import torch

from immunostruct_tpu_torch.cli.common import (
    base_parser, check_seq_dims, end_run, metrics_path, pick_pipeline,
    to_config, wandb_entity,
)
from immunostruct_tpu_torch.data.dataset import (
    ClinicalDataset, ComparativeDataset, ImmunoDataset, seeded_split,
)
from immunostruct_tpu_torch.data.pipeline import (
    BatchPipeline, ComparativePipeline,
)
from immunostruct_tpu_torch.data.tables import read_rows
from immunostruct_tpu_torch.models import build_model, reset_head
from immunostruct_tpu_torch.parallel.mesh import is_primary
from immunostruct_tpu_torch.procedures.infer import inference
from immunostruct_tpu_torch.procedures.train import derived_seed, train_model
from immunostruct_tpu_torch.utils.checkpoint import load_checkpoint
from immunostruct_tpu_torch.utils.logging import (
    MetricLogger, stage_log_fn, stats_to_wandb,
)
from immunostruct_tpu_torch.utils.losses import (
    LossConfig, pos_weight_from_counts,
)
from immunostruct_tpu_torch.utils.schedule import (
    linear_warmup_constant, linear_warmup_cosine_annealing,
)
from immunostruct_tpu_torch.utils.seeding import seed_everything


def main(argv=None):
    p = base_parser("Cancer comparative curriculum (PyTorch)")
    p.set_defaults(model="HybridModelv2_Comparative", batch_size=128)
    p.add_argument("--use-wt-for-downstream", action="store_true")
    p.add_argument("--min-finetuning-batches", default=64, type=int)
    p.add_argument("--coeff-contrastive", default=0.0, type=float)
    p.add_argument("--graph-dir-IEDB", default="$ROOT/data/graph_pyg_IEDB/", type=str)
    p.add_argument("--graph-dir-cancer", default="$ROOT/data/graph_pyg_Cancer/", type=str)
    p.add_argument("--graph-dir-wildtype", default="$ROOT/data/graph_pyg_Cancer_WT/", type=str)
    p.add_argument("--property-path-IEDB",
                   default="$ROOT/data/complete_score_Mprops_1_2_smoothed_sasa_v2.txt", type=str)
    p.add_argument("--property-path-cancer",
                   default="$ROOT/data/cedar_data_final_with_mprop1_mprop2_v2.txt", type=str)
    p.add_argument("--property-path-wildtype",
                   default="$ROOT/data/cedar_data_final_WILD_TYPE_with_mprop1_mprop2_v2.txt", type=str)
    p.add_argument("--graph-dir-clinical", default="$ROOT/data/graph_pyg_Clinical/", type=str)
    p.add_argument("--seq-path-clinical", default="$ROOT/data/hadrup_cancer_df_29K.txt", type=str)
    p.add_argument("--clinical-table-path", default="$ROOT/data/All_samples_clinical.txt", type=str)
    p.add_argument("--figure-save-dir", default="$ROOT/figures/run/", type=str)
    p.add_argument("--skip-clinical", action="store_true",
                   help="skip the clinical survival validation")
    args = p.parse_args(argv)
    config = to_config(args)
    config.derive_paths()

    logger = MetricLogger(project="ImmunoPred-Cancer-Paper-2",
                          entity=wandb_entity(config),
                          name=f"Comparative:{config.model}-seed{config.seed}",
                          config=vars(args),
                          jsonl_path=metrics_path(config))
    root_gen = seed_everything(config.seed)
    ssl = config.self_supervision
    full = config.full_sequence

    # -- datasets -------------------------------------------------------------
    dataset_pt1 = ImmunoDataset.load(config, config.graph_dir_IEDB,
                                     config.property_path_IEDB,
                                     config.hla_path)
    dataset_pt2 = ComparativeDataset.load(
        config, config.graph_dir_cancer, config.graph_dir_wildtype,
        config.property_path_cancer, config.property_path_wildtype,
        config.hla_path)
    clinical_ds = None
    if not args.skip_clinical:
        clinical_ds = ClinicalDataset.load(config, config.graph_dir_clinical,
                                           config.seq_path_clinical)
    tr1, va1, te1 = seeded_split(len(dataset_pt1), (0.8, 0.1, 0.1),
                                 config.seed)
    tr2, va2, te2 = seeded_split(len(dataset_pt2), (0.8, 0.1, 0.1),
                                 config.seed)
    print("Stage 1 train/val/test:", len(tr1), len(va1), len(te1))
    print("Stage 2/3 train/val/test:", len(tr2), len(va2), len(te2))

    vae_dim = (dataset_pt1.seq_full.shape[1] if full
               else dataset_pt1.seq_pep.shape[1]) * 21
    check_seq_dims(vae_dim, full, IEDB=dataset_pt1, comparative=dataset_pt2,
                   clinical=clinical_ds)
    device = torch.device(config.device)
    _, model = build_model(config.model, vae_dim, root_gen,
                           use_wt_for_downstream=config.use_wt_for_downstream,
                           device=device)

    # optional stage-1/2 warmup (--pretrain-warmup-epochs; the reference's
    # pretrain stages run at a constant rate)
    pretrain_schedule = None
    if config.pretrain_warmup_epochs > 0:
        pretrain_schedule = linear_warmup_constant(
            config.learning_rate_pretrain, config.pretrain_warmup_epochs,
            warmup_start_lr=config.learning_rate_pretrain / 100)

    # -- stage 1: IEDB foreignness pretrain (plain forward) --------------------
    loss_cfg = LossConfig(vae_dim,
                          pos_weight_from_counts(dataset_pt1.class_weights),
                          sequence=config.sequence_loss, ssl=ssl)

    Pipe1 = pick_pipeline(config, comparative=False, ssl=ssl)

    def mk1(idx, split):
        return Pipe1(dataset_pt1, idx, split=split, binary=False, full=full,
                     config=config, ssl=ssl)

    model, _ = train_model(config, model, mk1(tr1, "train"), mk1(va1, "val"),
                           loss_cfg, binary=False,
                           learning_rate=config.learning_rate_pretrain,
                           lr_schedule=pretrain_schedule,
                           optimizer_name="adamw",
                           weight_decay=config.weight_decay,
                           stage="pretrain", resume_tag="stage1",
                           log_fn=stage_log_fn(logger, "pretrain"))
    print("DONE PRE-TRAINING Stage 1")

    load_checkpoint(config.model_save_path_pretrain, model)
    reset_head(model, torch.Generator().manual_seed(
        derived_seed(config.seed, 0xA)))

    # -- stage 2: comparative cancer-foreignness pretrain ----------------------
    loss_cfg = LossConfig(vae_dim,
                          pos_weight_from_counts(dataset_pt2.class_weights),
                          sequence=config.sequence_loss, ssl=ssl)

    Pipe2 = pick_pipeline(config, comparative=True, ssl=ssl)

    def mk2(idx, split, binary, **kw):
        return Pipe2(dataset_pt2, idx, split=split, binary=binary, full=full,
                     config=config, ssl=ssl, **kw)

    model, _ = train_model(config, model, mk2(tr2, "train", False),
                           mk2(va2, "val", False), loss_cfg, binary=False,
                           learning_rate=config.learning_rate_pretrain,
                           lr_schedule=pretrain_schedule,
                           optimizer_name="adamw",
                           weight_decay=config.weight_decay,
                           stage="pretrain", resume_tag="stage2",
                           coeff_contrastive=config.coeff_contrastive,
                           log_fn=stage_log_fn(logger, "pretrain2"))
    print("DONE PRE-TRAINING Stage 2")

    load_checkpoint(config.model_save_path_pretrain, model)
    reset_head(model, torch.Generator().manual_seed(
        derived_seed(config.seed, 0xB)))

    # -- stage 3: comparative immunogenicity finetune --------------------------
    schedule = linear_warmup_cosine_annealing(
        config.learning_rate_finetune, warmup_epochs=config.num_epochs // 4,
        max_epochs=config.num_epochs,
        warmup_start_lr=config.learning_rate_finetune / 100)
    extend_to = config.min_finetuning_batches * config.batch_size
    test_pipe = mk2(te2, "test", True)
    model, _ = train_model(config, model,
                           mk2(tr2, "train", True, extend_to=extend_to),
                           mk2(va2, "val", True), loss_cfg, binary=True,
                           learning_rate=config.learning_rate_finetune,
                           optimizer_name="adamw",
                           weight_decay=config.weight_decay,
                           lr_schedule=schedule, stage="finetune",
                           coeff_contrastive=config.coeff_contrastive,
                           log_fn=stage_log_fn(logger, "finetune"))
    print("DONE FINE TUNING")

    load_checkpoint(config.model_save_path_finetune, model)

    # -- evaluation, with the clinical survival validation ----------------------
    clinical = None
    if clinical_ds is not None:
        clinical = {"pipe": BatchPipeline(
                        clinical_ds, np.arange(len(clinical_ds)),
                        split="infer", binary=True, full=full, config=config),
                    "valid": clinical_ds.valid,
                    "seq_rows": read_rows(config.seq_path_clinical),
                    "clin_rows": read_rows(config.clinical_table_path)}

    # the threshold comes from an un-extended, un-padded view of the train
    # split (the training pipe is oversampled through extend_to), on the
    # host: one pass does not call for another device corpus
    thresh_pipe = ComparativePipeline(dataset_pt2, tr2, split="eval_train",
                                      binary=True, full=full, config=config,
                                      ssl=ssl)
    train_stats = inference(config, model, thresh_pipe)
    test_stats = inference(config, model, test_pipe,
                           optimal_threshold=train_stats["optimal_threshold"],
                           clinical=clinical,
                           fig_save_folder=(config.fig_save_folder
                                            if is_primary() else None))

    logger.log(stats_to_wandb("Train", train_stats))
    logger.log(stats_to_wandb("Test", test_stats))
    logger.finish()
    end_run()
    return train_stats, test_stats


if __name__ == "__main__":
    main()
