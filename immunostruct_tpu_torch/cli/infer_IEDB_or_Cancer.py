"""Batch inference entry point (counterpart of
``immunostruct_tpu/cli/infer_IEDB_or_Cancer.py``; reference:
immunostruct/infer_IEDB_or_Cancer.py).

Rebuilds the dataset (the IEDB corpus, or with ``--comparative`` the
cancer/WT twins), recovers the seeded test fold (``seeded_split(n, (0.8,
0.1, 0.1), seed)``), loads a checkpoint of either kind (an npz of this
package or the JAX package, or a reference torch state_dict, which forces
exact-corpus-max node padding first), evaluates, and writes one row per
test sample, ``probability \\t label \\t chain``, to ``--output``
(reference :102-104).

Usage:
  python -m immunostruct_tpu_torch.cli.infer_IEDB_or_Cancer \\
      --model HybridModelv2 --full-sequence --checkpoint ft.ckpt \\
      --graph-dir-IEDB ... --property-path-IEDB ... --hla-path ... \\
      --output preds.txt

``--device`` defaults to cuda and fails without a card; ``--device cpu``
runs the kernels' plain versions.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from immunostruct_tpu_torch.cli.common import base_parser, to_config
from immunostruct_tpu_torch.data.dataset import (
    ComparativeDataset, ImmunoDataset, seeded_split,
)
from immunostruct_tpu_torch.data.pipeline import (
    BatchPipeline, ComparativePipeline,
)
from immunostruct_tpu_torch.models import build_model
from immunostruct_tpu_torch.procedures.infer import inference
from immunostruct_tpu_torch.utils.seeding import seed_everything
from immunostruct_tpu_torch.utils.torch_import import (
    is_torch_checkpoint, load_any_checkpoint, require_exact_reference_padding,
)


def main(argv=None):
    p = base_parser("Batch inference (PyTorch)")
    p.add_argument("--checkpoint", required=True, type=str)
    p.add_argument("--comparative", action="store_true")
    p.add_argument("--use-wt-for-downstream", action="store_true")
    p.add_argument("--graph-dir-IEDB", default="$ROOT/data/graph_pyg_IEDB/", type=str)
    p.add_argument("--graph-dir-cancer", default="$ROOT/data/graph_pyg_Cancer/", type=str)
    p.add_argument("--graph-dir-wildtype", default="$ROOT/data/graph_pyg_Cancer_WT/", type=str)
    p.add_argument("--property-path-IEDB",
                   default="$ROOT/data/complete_score_Mprops_1_2_smoothed_sasa_v2.txt", type=str)
    p.add_argument("--property-path-cancer",
                   default="$ROOT/data/cedar_data_final_with_mprop1_mprop2_v2.txt", type=str)
    p.add_argument("--property-path-wildtype",
                   default="$ROOT/data/cedar_data_final_WILD_TYPE_with_mprop1_mprop2_v2.txt", type=str)
    p.add_argument("--output", default="predictions_PPI.txt", type=str)
    args = p.parse_args(argv)
    config = to_config(args)
    config.derive_paths()
    root_gen = seed_everything(config.seed)

    # a reference checkpoint was trained at exact-corpus-max padding: decide
    # before the dataset pads (MIGRATION.md, "Padding geometry")
    if is_torch_checkpoint(args.checkpoint):
        require_exact_reference_padding(config)

    if args.comparative:
        dataset = ComparativeDataset.load(
            config, config.graph_dir_cancer, config.graph_dir_wildtype,
            config.property_path_cancer, config.property_path_wildtype,
            config.hla_path)
        seq_source = dataset.cancer
    else:
        dataset = ImmunoDataset.load(config, config.graph_dir_IEDB,
                                     config.property_path_IEDB,
                                     config.hla_path)
        seq_source = dataset

    # the seeded re-split recovers the same test fold (reference :86)
    _, _, test_idx = seeded_split(len(dataset), (0.8, 0.1, 0.1), config.seed)

    vae_dim = (seq_source.seq_full.shape[1] if config.full_sequence
               else seq_source.seq_pep.shape[1]) * 21
    _, model = build_model(config.model, vae_dim, root_gen,
                           use_wt_for_downstream=args.use_wt_for_downstream,
                           device=torch.device(config.device))
    load_any_checkpoint(args.checkpoint, model)

    pipe_cls = ComparativePipeline if args.comparative else BatchPipeline
    pipe = pipe_cls(dataset, test_idx, split="test", binary=True,
                    full=config.full_sequence, config=config)
    stats = inference(config, model, pipe, return_raw_preds=True)

    chains = [seq_source.raw_chain[i] for i in test_idx]
    out = np.stack([stats["predicted_probs"].astype(object),
                    stats["true_targets"].astype(object),
                    np.asarray(chains, object)], axis=1)
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    np.savetxt(args.output, out, fmt="%s", delimiter="\t")
    print(f"wrote {len(out)} predictions to {args.output}")
    return stats


if __name__ == "__main__":
    main()
