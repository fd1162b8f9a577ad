"""Inference (counterpart of ``immunostruct_tpu/procedures/infer.py``;
reference: procedures/infer.py:9-103, clinical_validation.py:167-211).

Collects sigmoid probabilities over a pipeline with the deterministic
forward (the twin forward for a comparative pipeline, with the cancer
side's target), derives or reuses the Youden-optimal threshold, and
computes the full metric suite. The clinical path scores the clinical
rows with the plain forward (a comparative model too, as the JAX package
does), makes the probabilities of rows without a graph NaN, and hands the
per-patient survival analysis to ``procedures/clinical.py``.
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import numpy as np
import torch

from immunostruct_tpu_torch.models.trunk import (
    ImmunoStructModel, model_apply, model_apply_comparative,
    program_aggregation,
)
from immunostruct_tpu_torch.procedures.clinical import clinical_pvalues
from immunostruct_tpu_torch.procedures.metrics import (
    evaluate_metrics, find_optimal_threshold,
)
from immunostruct_tpu_torch.procedures.train import derived_seed
from immunostruct_tpu_torch.structs import ComparativeBatch
from immunostruct_tpu_torch.utils.capture import Program, module_tensors


def forward_logits(model: ImmunoStructModel, batch, generator, *,
                   aggregation: str, compute_dtype):
    """The deterministic forward's logits of a batch: the twin forward for a
    ``ComparativeBatch``. What a batch-inference program runs or
    captures."""
    kw = dict(generator=generator, deterministic=True,
              aggregation=aggregation, compute_dtype=compute_dtype)
    if isinstance(batch, ComparativeBatch):
        c, w = batch.cancer, batch.wt
        return model_apply_comparative(
            model, (c.graph, w.graph), (c.seq_onehot, w.seq_onehot),
            (c.props, w.props), **kw)[2]
    return model_apply(model, batch.graph, batch.seq_onehot, batch.props,
                       **kw).logits


def collect_probs(config, model: ImmunoStructModel, pipe, seed: int):
    """(probabilities, targets) over one pass of ``pipe``, as numpy; batch
    ``i`` draws its VAE noise from ``step_generator(seed, i)``. A
    ``ComparativeBatch`` goes through the twin forward and gives the cancer
    side's target (infer.py:36-43 of the JAX package). Each batch's
    forward is a ``utils/capture.py`` program, the counterpart of the JAX
    package's jitted forward: captured on the card for each batch shape
    (eager where ``program_aggregation`` says so), eager on the CPU."""
    compute_dtype = getattr(torch, config.compute_dtype)
    forward = functools.partial(forward_logits, model,
                                aggregation=config.aggregation,
                                compute_dtype=compute_dtype)
    program = Program("batch inference")
    probs, targets = [], []
    with torch.inference_mode():
        for i, batch in enumerate(pipe.epoch(0)):
            side = (batch.cancer if isinstance(batch, ComparativeBatch)
                    else batch)
            agg, eager = program_aggregation(model, side.graph,
                                             config.aggregation,
                                             compute_dtype)
            logits = program(forward, batch,
                             static=("forward", agg, compute_dtype),
                             seed=derived_seed(seed, i),
                             state=functools.partial(module_tensors, model),
                             eager=eager)
            probs.append(torch.sigmoid(logits.reshape(-1).float()))
            targets.append(side.target.reshape(-1))
    return (torch.cat(probs).cpu().numpy(),
            torch.cat(targets).float().cpu().numpy())


def inference(config, model: ImmunoStructModel, pipe, *,
              optimal_threshold: Optional[float] = None,
              return_raw_preds: bool = False, clinical: Optional[dict] = None,
              fig_save_folder: Optional[str] = None,
              verbose: bool = True) -> dict:
    """Metric evaluation over a pipeline; batch noise from (seed + 0x1f,
    batch). When ``optimal_threshold`` is None, Youden's optimum is derived
    from THIS split and returned for reuse on another
    (train_IEDB_wFT.py:127-129). ``return_raw_preds`` adds the
    probabilities and targets, in the pipeline's order, as
    ``predicted_probs`` and ``true_targets``. ``clinical`` (see
    ``inference_clinical_only``) adds ``os_p_value`` and ``pfs_p_value``,
    its noise from the same seed, as the JAX package passes its key on."""
    seed = config.seed + 0x1f
    probs, targets = collect_probs(config, model, pipe, seed)
    if optimal_threshold is None:
        optimal_threshold = find_optimal_threshold(targets, probs)
    out = evaluate_metrics(targets, probs, optimal_threshold,
                           verbose=verbose)
    if return_raw_preds:
        out["predicted_probs"] = probs
        out["true_targets"] = targets
    if clinical is not None:
        out.update(inference_clinical_only(
            config, model, clinical, seed=seed,
            fig_save_folder=fig_save_folder, verbose=verbose))
    return out


def inference_clinical_only(config, model: ImmunoStructModel,
                            clinical: dict, *, seed: Optional[int] = None,
                            fig_save_folder: Optional[str] = None,
                            return_raw_preds: bool = False,
                            verbose: bool = True) -> dict:
    """Clinical scoring -> per-patient load -> OS/PFS p-values, as
    ``{"os_p_value", "pfs_p_value"}``; batch noise from (seed, batch),
    ``config.seed + 0x2f`` by default.

    ``clinical`` holds:
      pipe      : a BatchPipeline over the ClinicalDataset's rows, in order
      valid     : bool mask of the rows with a real graph
      seq_rows  : the clinical sequence table's rows (each with 'patient')
      clin_rows : the outcome table's rows (Patient / OS.* / PFS.*)

    The forward runs on the zero-filled rows; the probabilities of invalid
    rows become NaN afterwards and stay out of the loads
    (clinical_validation.py:196-197). A figure goes to
    ``<fig_save_folder>/clinical_p_value.png`` when a p-value is at most
    0.1. ``return_raw_preds`` adds the rows' probabilities as
    ``predicted_probs``."""
    seed = config.seed + 0x2f if seed is None else seed
    probs, _ = collect_probs(config, model, clinical["pipe"], seed)
    probs = probs.astype(float)
    probs[~np.asarray(clinical["valid"], bool)] = np.nan

    fig_path = (os.path.join(fig_save_folder, "clinical_p_value.png")
                if fig_save_folder else None)
    os_p, pfs_p = clinical_pvalues(probs, clinical["seq_rows"],
                                   clinical["clin_rows"],
                                   fig_save_path=fig_path)
    if verbose:
        print(f"OS p-value: {os_p:.4f}\nPFS p-value: {pfs_p:.4f}")
    out = {"os_p_value": os_p, "pfs_p_value": pfs_p}
    if return_raw_preds:
        out["predicted_probs"] = probs
    return out
