"""Shared CLI plumbing (counterpart of ``immunostruct_tpu/cli/common.py``):
the argparse surface of the reference entry scripts
(train_IEDB_wFT.py:16-36, train_Cancer_wFT.py:15-45) and the JAX package's
accelerator flags, plus ``--device``.

What the port does with the JAX package's accelerator flags:

- ``--aggregation``: every name runs ('auto', 'mega', 'fused', 'pallas',
  'onehot', 'onehot_remat', 'scatter'; ``ops/egnn.py``);
- ``--device-data`` (the HBM-resident corpus): not ported, so only the host
  pipeline runs and ``--device-data`` fails;
- ``--data-parallel``: not ported, fails when a stage starts;
- ``--scan-layers``: a compile-time device of XLA; accepted, no effect;
- ``--stack-twins``: the comparative twin forwards as one stacked pass
  (``train_Cancer_wFT``); accepted, no effect on the IEDB entry point.
"""

from __future__ import annotations

import argparse

import torch

from immunostruct_tpu_torch.config import Config, update_paths


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--model", default="StructureModel", type=str)
    p.add_argument("--learning-rate-pretrain", default=1e-3, type=float)
    p.add_argument("--learning-rate-finetune", default=1e-4, type=float)
    p.add_argument("--num-epochs", default=40, type=int)
    p.add_argument("--batch-size", default=150, type=int)
    p.add_argument("--num-workers", default=4, type=int)
    p.add_argument("--full-sequence", action="store_true")
    p.add_argument("--sequence-loss", action="store_true")
    p.add_argument("--feature-size", default=23, type=int)
    p.add_argument("--coord-size", default=3, type=int)
    p.add_argument("--model-save-dir", default="$ROOT/results/run/", type=str)
    p.add_argument("--hla-path", default="$ROOT/data/HLA_27_seqs_csv.csv", type=str)
    p.add_argument("--seed", default=1, type=int)
    p.add_argument("--wandb-username", default=None, type=str)
    p.add_argument("--sequence-pad-count", default=0, type=int)
    p.add_argument("--structure-pad-count", default=0, type=int)
    p.add_argument("--self-supervision", action="store_true")
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device; 'cuda' (default) fails when no CUDA "
                        "device is present, 'cpu' runs the kernels' plain "
                        "versions")
    p.add_argument("--compute-dtype", default="bfloat16", type=str)
    p.add_argument("--aggregation", default="auto",
                   choices=["auto", "mega", "fused", "onehot", "onehot_remat",
                            "scatter", "pallas"],
                   help="EGNN message aggregation: 'mega' (the B1/B2 "
                        "kernels from raw edge indices), 'fused' (gathered "
                        "edge bundles through the B3 kernels, index_add_ "
                        "aggregation), 'pallas' (the B8 segment scatter "
                        "kernel, its gather kernel in the backward), "
                        "'onehot' (one-hot matrix products, plain PyTorch), "
                        "'onehot_remat' (the same, rebuilt per layer under "
                        "checkpointing: less memory), 'scatter' (plain "
                        "PyTorch), 'auto' ('scatter' on the CPU; on CUDA "
                        "'mega', else 'fused', else 'onehot', by shape)")
    p.add_argument("--data-parallel", action="store_true",
                   help="shard batches over all local devices (not ported)")
    p.add_argument("--resume", action="store_true",
                   help="continue an interrupted stage from its .resume snapshot")
    p.add_argument("--device-data", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="keep the corpus resident on the device (not ported: "
                        "the host pipeline feeds every run)")
    p.add_argument("--grad-accum-steps", default=1, type=int,
                   help="microbatches per optimizer step (batch-size must "
                        "be divisible)")
    p.add_argument("--scan-layers", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="accepted for the JAX package's flag surface; no "
                        "effect (PyTorch compiles nothing)")
    p.add_argument("--stack-twins", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="run the comparative twin forwards as one stacked "
                        "pass (no effect on non-comparative models)")
    p.add_argument("--collapse-detection", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="watch the validation AUROC and warn if the "
                        "classifier flatlines at chance")
    p.add_argument("--reinit-on-collapse", action="store_true",
                   help="when the collapse guard fires, restart the pretrain "
                        "stage from fresh weights (up to 2 retries)")
    p.add_argument("--pretrain-warmup-epochs", default=0, type=int,
                   help="linear LR warmup (from lr/100) over this many "
                        "epochs at the start of each pretrain stage")
    return p


def resolve_device(name: str) -> torch.device:
    """The run's device; raises when CUDA is asked for and absent."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but torch finds no CUDA device; "
                           "pass --device cpu to run on the CPU")
    return device


def to_config(args: argparse.Namespace, **extra) -> Config:
    """The Config of the parsed flags; fails on what the port does not
    run (``--device-data``, a missing card)."""
    known = {f.name for f in Config.__dataclass_fields__.values()}
    kv = {k: v for k, v in vars(args).items() if k in known}
    kv.update(extra)
    cfg = Config(**kv)
    update_paths(cfg)
    if cfg.device_data:
        raise ValueError("--device-data (the device-resident corpus) is not "
                         "ported to PyTorch yet; the host pipeline runs "
                         "without the flag")
    resolve_device(cfg.device)
    return cfg


def check_seq_dims(vae_dim: int, full: bool, **named_datasets) -> None:
    """Fail fast on cross-corpus sequence-padding mismatches: the VAE takes
    a fixed L*21 input, and each corpus pads to its own longest chain.
    Pass every dataset the run will touch; a comparative dataset is
    checked on both twins, and a None (a dataset the run skips) is
    skipped."""
    sides = []
    for name, ds in named_datasets.items():
        if ds is None:
            continue
        if hasattr(ds, "cancer"):       # the twins share the VAE
            sides += [(f"{name}.cancer", ds.cancer), (f"{name}.wt", ds.wt)]
        else:
            sides.append((name, ds))
    for name, ds in sides:
        seq = ds.seq_full if full else ds.seq_pep
        dim = seq.shape[1] * 21
        if dim != vae_dim:
            raise ValueError(
                f"sequence-dim mismatch: dataset '{name}' pads "
                f"{'full chains' if full else 'peptides'} to {seq.shape[1]} "
                f"tokens ({dim} flattened) but the model's VAE was built "
                f"for vae_dim={vae_dim}. All corpora in one run must pad "
                "to the model's length — re-featurize/re-pad the corpus or "
                "set --sequence-pad-count/--structure-pad-count so the "
                "lengths agree.")
