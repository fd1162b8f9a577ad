"""IEDB pretrain -> finetune entry point (counterpart of
``immunostruct_tpu/cli/train_IEDB_wFT.py``; reference:
immunostruct/train_IEDB_wFT.py): foreignness-regression pretrain,
best-checkpoint reload with a fresh head, immunogenicity-BCE finetune, then
train/test inference with the train split's threshold reused on test.

Usage:
  python -m immunostruct_tpu_torch.cli.train_IEDB_wFT --model HybridModelv2 \\
      --full-sequence --sequence-loss --aggregation fused \\
      --graph-dir-IEDB ... --property-path-IEDB ... --hla-path ...

``--device`` defaults to cuda; ``--device cpu`` runs the kernels' plain
versions. The train/val/test pipelines come from ``pick_pipeline``
(``--device-data``: on a card the corpus stays on the device by default);
the threshold pass reads the train split through the host pipeline.
"""

from __future__ import annotations

import torch

from immunostruct_tpu_torch.cli.common import (
    base_parser, check_seq_dims, end_run, metrics_path, pick_pipeline,
    to_config, wandb_entity,
)
from immunostruct_tpu_torch.data.dataset import ImmunoDataset, seeded_split
from immunostruct_tpu_torch.data.pipeline import BatchPipeline
from immunostruct_tpu_torch.models import build_model, reset_head
from immunostruct_tpu_torch.procedures.infer import inference
from immunostruct_tpu_torch.procedures.train import derived_seed, train_model
from immunostruct_tpu_torch.utils.checkpoint import load_checkpoint
from immunostruct_tpu_torch.utils.logging import (
    MetricLogger, stage_log_fn, stats_to_wandb,
)
from immunostruct_tpu_torch.utils.losses import (
    LossConfig, pos_weight_from_counts,
)
from immunostruct_tpu_torch.utils.schedule import linear_warmup_constant
from immunostruct_tpu_torch.utils.seeding import seed_everything


def main(argv=None):
    p = base_parser("IEDB pretrain->finetune (PyTorch)")
    p.add_argument("--graph-dir-IEDB", default="$ROOT/data/graph_pyg_IEDB/", type=str)
    p.add_argument("--property-path-IEDB",
                   default="$ROOT/data/complete_score_Mprops_1_2_smoothed_sasa_v2.txt",
                   type=str)
    args = p.parse_args(argv)
    config = to_config(args)
    config.derive_paths()

    logger = MetricLogger(project="ImmunoPred-IEDB-MIT",
                          entity=wandb_entity(config),
                          name=f"PropIEDB_ImmunoIEDB:{config.model}-seed{config.seed}",
                          config=vars(args),
                          jsonl_path=metrics_path(config))
    root_gen = seed_everything(config.seed)

    dataset = ImmunoDataset.load(config, config.graph_dir_IEDB,
                                 config.property_path_IEDB, config.hla_path)
    train_idx, val_idx, test_idx = seeded_split(len(dataset), (0.8, 0.1, 0.1),
                                                config.seed)
    print("Pretraining train/val/test size:",
          len(train_idx), len(val_idx), len(test_idx))

    vae_dim = (dataset.seq_full.shape[1] if config.full_sequence
               else dataset.seq_pep.shape[1]) * 21
    check_seq_dims(vae_dim, config.full_sequence, IEDB=dataset)
    _, model = build_model(config.model, vae_dim, root_gen,
                           device=torch.device(config.device))
    loss_cfg = LossConfig(vae_dim, pos_weight_from_counts(dataset.class_weights),
                          sequence=config.sequence_loss,
                          ssl=config.self_supervision)
    ssl = config.self_supervision
    Pipe = pick_pipeline(config, comparative=False, ssl=ssl)

    def pipes(binary):
        def mk(idx, split):
            return Pipe(dataset, idx, split=split, binary=binary,
                        full=config.full_sequence, config=config, ssl=ssl)
        return mk(train_idx, "train"), mk(val_idx, "val"), mk(test_idx, "test")

    # Stage 1: foreignness-regression pretrain (binary=False)
    pretrain_schedule = None
    if config.pretrain_warmup_epochs > 0:
        pretrain_schedule = linear_warmup_constant(
            config.learning_rate_pretrain, config.pretrain_warmup_epochs,
            warmup_start_lr=config.learning_rate_pretrain / 100)
    train_pipe, val_pipe, _ = pipes(binary=False)
    model, _ = train_model(config, model, train_pipe, val_pipe, loss_cfg,
                           binary=False,
                           learning_rate=config.learning_rate_pretrain,
                           lr_schedule=pretrain_schedule, stage="pretrain",
                           log_fn=stage_log_fn(logger, "pretrain"))
    print("DONE PRE-TRAINING")

    # Stage transition: reload the best checkpoint, fresh classifier head
    load_checkpoint(config.model_save_path_pretrain, model)
    reset_head(model, torch.Generator().manual_seed(
        derived_seed(config.seed, 0xFEED)))

    # Stage 2: immunogenicity BCE finetune (binary=True); Adam wd 1e-6
    train_pipe, val_pipe, test_pipe = pipes(binary=True)
    model, _ = train_model(config, model, train_pipe, val_pipe, loss_cfg,
                           binary=True,
                           learning_rate=config.learning_rate_finetune,
                           weight_decay=1e-6, stage="finetune",
                           log_fn=stage_log_fn(logger, "finetune"))
    print("DONE FINE TUNING")

    load_checkpoint(config.model_save_path_finetune, model)

    # the threshold comes from an un-augmented, un-padded view of the train
    # split, on the host: one pass does not call for another device corpus
    thresh_pipe = BatchPipeline(dataset, train_idx, split="eval_train",
                                binary=True, full=config.full_sequence,
                                config=config, ssl=ssl)
    train_stats = inference(config, model, thresh_pipe)
    test_stats = inference(config, model, test_pipe,
                           optimal_threshold=train_stats["optimal_threshold"])

    logger.log(stats_to_wandb("Train", train_stats))
    logger.log(stats_to_wandb("Test", test_stats))
    logger.finish()
    end_run()
    return train_stats, test_stats


if __name__ == "__main__":
    main()
