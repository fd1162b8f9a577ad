"""The staged curriculum (counterpart of
``immunostruct_tpu/cli/train_curriculum.py``).

One CLI for the reference's 13 legacy scripts under old_scripts/ (every
pretrain->finetune combination of {PropIEDB, ImmunoIEDB, PropCancer,
ImmunoCancer} x {plain, comparative}):

  --stages PropIEDB,PropCancer,ImmunoCancer --comparative
    == old_scripts/train_comparative_PropIEDB_PropCancer_ImmunoCancer.py
  --stages PropIEDB,ImmunoIEDB
    == train_IEDB_wFT.py's two stages

Stage names: Prop* trains the foreignness regression (binary=False),
Immuno* the weighted BCE (binary=True); *IEDB reads the IEDB corpus,
*Cancer the cancer corpus (cancer/WT twins with --comparative). Each
corpus is loaded once, with its ``seeded_split(n, --split-fractions,
seed)``. Every stage trains with AdamW under the resume tag ``stage<i>``;
between stages the best checkpoint is reloaded and the classifier head
drawn anew (from ``derived_seed(seed, 0xA + i)``, as ``train_Cancer_wFT``
draws its heads). The last stage checkpoints to the finetune path under
the warmup-cosine schedule and, when binary, cycles its train split up to
``--min-finetuning-batches`` batches; earlier stages warm up linearly
under ``--pretrain-warmup-epochs``. The run ends with inference on the
last stage's train split (its threshold) and test split.

Usage:
  python -m immunostruct_tpu_torch.cli.train_curriculum \\
      --stages PropIEDB,ImmunoIEDB,PropCancer,ImmunoCancer --comparative \\
      --model HybridModelv2_Comparative --full-sequence --aggregation mega \\
      --graph-dir-IEDB ... --property-path-IEDB ... --graph-dir-cancer ... \\
      --graph-dir-wildtype ... --property-path-cancer ... \\
      --property-path-wildtype ... --hla-path ...

``--device`` defaults to cuda; ``--device cpu`` runs the kernels' plain
versions.
"""

from __future__ import annotations

import torch

from immunostruct_tpu_torch.cli.common import (
    base_parser, check_seq_dims, to_config,
)
from immunostruct_tpu_torch.data.dataset import (
    ComparativeDataset, ImmunoDataset, seeded_split,
)
from immunostruct_tpu_torch.data.pipeline import (
    BatchPipeline, ComparativePipeline,
)
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
from immunostruct_tpu_torch.utils.schedule import (
    linear_warmup_constant, linear_warmup_cosine_annealing,
)
from immunostruct_tpu_torch.utils.seeding import seed_everything

VALID_STAGES = {"PropIEDB", "ImmunoIEDB", "PropCancer", "ImmunoCancer"}


def main(argv=None):
    p = base_parser("Staged curriculum trainer (PyTorch)")
    p.add_argument("--stages", default="PropIEDB,ImmunoIEDB", type=str)
    p.add_argument("--comparative", action="store_true",
                   help="use cancer/WT comparative pairs for *Cancer stages")
    p.add_argument("--use-wt-for-downstream", action="store_true")
    p.add_argument("--coeff-contrastive", default=0.0, type=float)
    p.add_argument("--min-finetuning-batches", default=64, type=int)
    p.add_argument("--split-fractions", default="0.8,0.1,0.1", type=str)
    p.add_argument("--graph-dir-IEDB", default="$ROOT/data/graph_pyg_IEDB/", type=str)
    p.add_argument("--graph-dir-cancer", default="$ROOT/data/graph_pyg_Cancer/", type=str)
    p.add_argument("--graph-dir-wildtype", default="$ROOT/data/graph_pyg_Cancer_WT/", type=str)
    p.add_argument("--property-path-IEDB",
                   default="$ROOT/data/complete_score_Mprops_1_2_smoothed_sasa_v2.txt", type=str)
    p.add_argument("--property-path-cancer",
                   default="$ROOT/data/cedar_data_final_with_mprop1_mprop2_v2.txt", type=str)
    p.add_argument("--property-path-wildtype",
                   default="$ROOT/data/cedar_data_final_WILD_TYPE_with_mprop1_mprop2_v2.txt", type=str)
    args = p.parse_args(argv)

    stages = [s.strip() for s in args.stages.split(",") if s.strip()]
    for s in stages:
        if s not in VALID_STAGES:
            raise SystemExit(
                f"unknown stage '{s}'; valid: {sorted(VALID_STAGES)}")
    fractions = tuple(float(x) for x in args.split_fractions.split(","))
    config = to_config(args)
    config.derive_paths()

    logger = MetricLogger(project="ImmunoPred-Curriculum",
                          entity=config.wandb_username,
                          name=f"{args.stages}:{config.model}-seed{config.seed}",
                          config=vars(args),
                          jsonl_path=config.model_save_path_pretrain + ".metrics.jsonl")
    root_gen = seed_everything(config.seed)
    ssl = config.self_supervision
    full = config.full_sequence
    device = torch.device(config.device)

    # each corpus family loaded at its first stage, then kept
    cache: dict = {}

    def get_dataset(kind: str):
        if kind not in cache:
            if kind == "IEDB":
                ds = ImmunoDataset.load(config, config.graph_dir_IEDB,
                                        config.property_path_IEDB,
                                        config.hla_path)
            elif args.comparative:
                ds = ComparativeDataset.load(
                    config, config.graph_dir_cancer,
                    config.graph_dir_wildtype, config.property_path_cancer,
                    config.property_path_wildtype, config.hla_path)
            else:
                ds = ImmunoDataset.load(config, config.graph_dir_cancer,
                                        config.property_path_cancer,
                                        config.hla_path)
            cache[kind] = (ds, seeded_split(len(ds), fractions, config.seed))
        return cache[kind]

    model = vae_dim = None
    for i, stage in enumerate(stages):
        kind = "IEDB" if stage.endswith("IEDB") else "Cancer"
        binary = stage.startswith("Immuno")
        is_last = i == len(stages) - 1
        ds, (tr, va, te) = get_dataset(kind)
        comparative = kind == "Cancer" and args.comparative

        if vae_dim is None:
            seq_source = ds.cancer if comparative else ds
            vae_dim = (seq_source.seq_full.shape[1] if full
                       else seq_source.seq_pep.shape[1]) * 21
            _, model = build_model(
                config.model, vae_dim, root_gen,
                use_wt_for_downstream=args.use_wt_for_downstream,
                device=device)
        # a later stage's corpus may pad its chains to another length: fail
        # before the stage starts
        check_seq_dims(vae_dim, full, **{stage: ds})

        loss_cfg = LossConfig(vae_dim, pos_weight_from_counts(ds.class_weights),
                              sequence=config.sequence_loss, ssl=ssl)
        pipe_cls = ComparativePipeline if comparative else BatchPipeline
        extend_to = (config.min_finetuning_batches * config.batch_size
                     if (is_last and binary) else 0)

        def mk(idx, split, **kw):
            return pipe_cls(ds, idx, split=split, binary=binary, full=full,
                            config=config, ssl=ssl, **kw)

        schedule = None
        lr = config.learning_rate_pretrain
        if is_last:
            lr = config.learning_rate_finetune
            schedule = linear_warmup_cosine_annealing(
                lr, warmup_epochs=config.num_epochs // 4,
                max_epochs=config.num_epochs, warmup_start_lr=lr / 100)
        elif config.pretrain_warmup_epochs > 0:
            schedule = linear_warmup_constant(
                lr, config.pretrain_warmup_epochs, warmup_start_lr=lr / 100)

        print(f"=== stage {i + 1}/{len(stages)}: {stage} "
              f"(binary={binary}, comparative={comparative}) ===")
        test_pipe = mk(te, "test")
        model, _ = train_model(
            config, model, mk(tr, "train", extend_to=extend_to),
            mk(va, "val"), loss_cfg, binary=binary, learning_rate=lr,
            optimizer_name="adamw", weight_decay=config.weight_decay,
            lr_schedule=schedule,
            stage="finetune" if is_last else "pretrain",
            resume_tag=f"stage{i + 1}",
            coeff_contrastive=config.coeff_contrastive if comparative else 0.0,
            log_fn=stage_log_fn(logger, stage))

        load_checkpoint(config.model_save_path_finetune if is_last
                        else config.model_save_path_pretrain, model)
        if not is_last:
            reset_head(model, torch.Generator().manual_seed(
                derived_seed(config.seed, 0xA + i)))

    # the threshold comes from an un-extended view of the last stage's train
    # split
    train_stats = inference(config, model, mk(tr, "eval_train"))
    test_stats = inference(config, model, test_pipe,
                           optimal_threshold=train_stats["optimal_threshold"])
    logger.log(stats_to_wandb("Train", train_stats))
    logger.log(stats_to_wandb("Test", test_stats))
    logger.finish()
    return train_stats, test_stats


if __name__ == "__main__":
    main()
