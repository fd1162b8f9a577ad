"""Clinical-only inference entry point (counterpart of
``immunostruct_tpu/cli/infer_clinical_only.py``; reference:
immunostruct/infer_clinical_only.py).

Loads a finetuned checkpoint (an npz of this package or the JAX package,
or a reference torch state_dict, which forces exact-corpus-max node padding
before the dataset pads), scores the clinical pMHC table with the plain
forward, sums each patient's predicted-immunogenicity load, and reports the
OS/PFS log-rank p-values, with KM figures where a p-value is at most 0.1.

Usage:
  python -m immunostruct_tpu_torch.cli.infer_clinical_only \\
      --checkpoint ft.ckpt --full-sequence --aggregation mega \\
      --graph-dir-clinical ... --seq-path-clinical ... \\
      --clinical-table-path ... --figure-save-dir ...

Returns the p-values and the rows' probabilities (NaN where a row has no
graph) as ``{"os_p_value", "pfs_p_value", "predicted_probs"}``.
``--device`` defaults to cuda and fails without a card; ``--device cpu``
runs the kernels' plain versions.
"""

from __future__ import annotations

import numpy as np
import torch

from immunostruct_tpu_torch.cli.common import base_parser, to_config
from immunostruct_tpu_torch.data.dataset import ClinicalDataset
from immunostruct_tpu_torch.data.pipeline import BatchPipeline
from immunostruct_tpu_torch.data.tables import read_rows
from immunostruct_tpu_torch.models import build_model
from immunostruct_tpu_torch.procedures.infer import inference_clinical_only
from immunostruct_tpu_torch.utils.seeding import seed_everything
from immunostruct_tpu_torch.utils.torch_import import (
    is_torch_checkpoint, load_any_checkpoint, require_exact_reference_padding,
)


def main(argv=None):
    p = base_parser("Clinical-only inference (PyTorch)")
    p.set_defaults(model="HybridModelv2_Comparative")
    p.add_argument("--checkpoint", required=True, type=str)
    p.add_argument("--use-wt-for-downstream", action="store_true")
    p.add_argument("--graph-dir-clinical", default="$ROOT/data/graph_pyg_Clinical/", type=str)
    p.add_argument("--seq-path-clinical", default="$ROOT/data/hadrup_cancer_df_29K.txt", type=str)
    p.add_argument("--clinical-table-path", default="$ROOT/data/All_samples_clinical.txt", type=str)
    p.add_argument("--figure-save-dir", default="$ROOT/figures/clinical/", type=str)
    # the model's widths as flags (infer_clinical_only.py:21-26)
    p.add_argument("--gcn-layers", default=5, type=int)
    p.add_argument("--vae-hidden-dim", default=512, type=int)
    p.add_argument("--vae-latent-dim", default=32, type=int)
    p.add_argument("--gat-hidden-channels", default=64, type=int)
    p.add_argument("--property-embedding-dim", default=8, type=int)
    args = p.parse_args(argv)
    config = to_config(args)
    # a reference checkpoint was trained at exact-corpus-max padding: decide
    # before the dataset pads (MIGRATION.md, "Padding geometry")
    if is_torch_checkpoint(args.checkpoint):
        require_exact_reference_padding(config)
    config.derive_paths()
    root_gen = seed_everything(config.seed)

    ds = ClinicalDataset.load(config, config.graph_dir_clinical,
                              config.seq_path_clinical)
    vae_dim = (ds.seq_full.shape[1] if config.full_sequence
               else ds.seq_pep.shape[1]) * 21
    _, model = build_model(
        config.model, vae_dim, root_gen,
        use_wt_for_downstream=args.use_wt_for_downstream,
        device=torch.device(config.device), gcn_layers=config.gcn_layers,
        vae_hidden_dim=config.vae_hidden_dim,
        vae_latent_dim=config.vae_latent_dim,
        gat_hidden_channels=config.gat_hidden_channels,
        property_embedding_dim=config.property_embedding_dim)
    load_any_checkpoint(args.checkpoint, model)

    pipe = BatchPipeline(ds, np.arange(len(ds)), split="infer", binary=True,
                         full=config.full_sequence, config=config)
    clinical = {"pipe": pipe, "valid": ds.valid,
                "seq_rows": read_rows(config.seq_path_clinical),
                "clin_rows": read_rows(config.clinical_table_path)}
    return inference_clinical_only(config, model, clinical,
                                   fig_save_folder=config.fig_save_folder,
                                   return_raw_preds=True)


if __name__ == "__main__":
    main()
