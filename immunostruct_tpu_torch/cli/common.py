"""Shared CLI plumbing (counterpart of ``immunostruct_tpu/cli/common.py``):
the argparse surface of the reference entry scripts
(train_IEDB_wFT.py:16-36, train_Cancer_wFT.py:15-45) and the JAX package's
accelerator flags, plus ``--device``.

What the port does with the JAX package's accelerator flags:

- ``--aggregation``: every name runs ('auto', 'mega', 'fused', 'pallas',
  'onehot', 'onehot_remat', 'scatter'; ``ops/egnn.py``);
- ``--device-data`` (the device-resident corpus, ``pick_pipeline``):
  ``--device-data`` keeps the corpus on ``--device`` and batches there
  (``data/device_pipeline.py``, with the augmented and SSL transforms on
  the device), ``--no-device-data`` uses the host pipeline, and left unset
  ('auto') picks the device pipeline on a CUDA device without
  ``--data-parallel`` when the corpus fits the budget
  (``device_data_budget``), the host pipeline otherwise (on the CPU too);
- ``--data-parallel``: not ported, fails when a stage starts;
- ``--scan-layers``: a compile-time device of XLA; accepted, no effect;
- ``--stack-twins``: the comparative twin forwards as one stacked pass
  (``train_Cancer_wFT``); accepted, no effect on the IEDB entry point.
"""

from __future__ import annotations

import argparse
import functools

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
                   help="keep the corpus resident on the device and batch "
                        "there (augmented/SSL transforms run there too). "
                        "Default: auto, on for a CUDA device without "
                        "--data-parallel when the corpus fits the budget; "
                        "--no-device-data forces the host pipeline. auto "
                        "keeps the host pipeline's partial trailing train "
                        "batch, an explicit --device-data pads it with "
                        "repeated rows")
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


# The 'auto' budget of the device corpus, as shares of the device's
# memory: one dataset's corpus, and all corpora admitted in the process
# (the JAX package's 2.5 GiB and 8 GiB of a 16 GiB chip). The rest holds
# the parameters, activations and the allocator's cache.
DATASET_SHARE = 2.5 / 16
TOTAL_SHARE = 8 / 16


def device_data_budget(device) -> tuple:
    """(bytes for one dataset's corpus, bytes for all admitted corpora) on
    a CUDA ``device``: the shares of its memory."""
    total = torch.cuda.get_device_properties(torch.device(device)).total_memory
    return int(DATASET_SHARE * total), int(TOTAL_SHARE * total)


def pick_pipeline(config, comparative: bool, ssl: bool):
    """The pipeline class (or factory) of a run: the host ``BatchPipeline``
    or the device-resident ``DevicePipeline`` (their comparative forms for
    ``comparative``).

    ``config.device_data`` True forces the device pipeline, False the host
    one. Unset ('auto') decides per dataset when the pipeline is built: the
    device pipeline on a CUDA device without ``data_parallel`` when the
    corpus fits ``device_data_budget`` (one dataset, and all admitted
    ones together; a dataset's pipelines share one upload, so it counts
    once), else the host pipeline, saying why. Under 'auto' a trailing
    partial train batch stays partial, as on the host. Augmented and SSL
    configurations run their transforms on the device."""
    from immunostruct_tpu_torch.data.pipeline import (
        BatchPipeline, ComparativePipeline,
    )

    host_cls = ComparativePipeline if comparative else BatchPipeline
    dd = config.device_data
    if dd is None:
        dd = "auto"
    if dd != "auto":
        dd = bool(dd)
    if dd is False:
        return host_cls

    from immunostruct_tpu_torch.data.device_pipeline import (
        ComparativeDevicePipeline, DevicePipeline, admitted_device_bytes,
        estimate_device_bytes, note_admitted,
    )
    wants_augment = (
        ssl or config.force_graph_augmentation
        or (config.sequence_pad_count > 0 and config.full_sequence))
    cls = ComparativeDevicePipeline if comparative else DevicePipeline
    dev_factory = (functools.partial(cls, device_augment=True)
                   if wants_augment else cls)
    if dd is True:
        return dev_factory

    def auto_factory(dataset, indices, **kw):
        device = torch.device(config.device)
        if device.type != "cuda" or config.data_parallel:
            return host_cls(dataset, indices, **kw)
        per_dataset, total = device_data_budget(device)
        need = estimate_device_bytes(dataset, full=kw.get("full", True))
        admitted = admitted_device_bytes()
        if need > per_dataset or admitted + need > total:
            print(f"device-data auto: the corpus ({need / (1 << 30):.2f} "
                  f"GiB, {admitted / (1 << 30):.2f} GiB already admitted) "
                  f"exceeds the budget ({per_dataset / (1 << 30):.2f} GiB a "
                  f"dataset, {total / (1 << 30):.2f} GiB in all); using the "
                  "host pipeline")
            return host_cls(dataset, indices, **kw)
        kw.setdefault("pad_final_batch", False)
        try:
            pipe = dev_factory(dataset, indices, **kw)
        except ValueError as e:
            # a configuration the device pipeline declines falls back
            # loudly, with the reason
            print("device-data auto: falling back to the host pipeline "
                  f"for this configuration ({type(e).__name__}: {e})")
            return host_cls(dataset, indices, **kw)
        note_admitted(dataset, need)
        return pipe

    return auto_factory


def to_config(args: argparse.Namespace, **extra) -> Config:
    """The Config of the parsed flags; fails on a missing card."""
    known = {f.name for f in Config.__dataclass_fields__.values()}
    kv = {k: v for k, v in vars(args).items() if k in known}
    kv.update(extra)
    cfg = Config(**kv)
    update_paths(cfg)
    if (cfg.device_data and torch.device(cfg.device).type == "cuda"
            and not torch.cuda.is_available()):
        raise RuntimeError("--device-data keeps the corpus on --device cuda, "
                           "but torch finds no CUDA device; pass --device cpu "
                           "to keep it on the CPU")
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
