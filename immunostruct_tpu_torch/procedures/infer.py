"""Inference (counterpart of ``immunostruct_tpu/procedures/infer.py``;
reference: procedures/infer.py:9-103).

Collects sigmoid probabilities over a pipeline with the deterministic
forward (the twin forward for a comparative pipeline, with the cancer
side's target), derives or reuses the Youden-optimal threshold, and
computes the full metric suite. The clinical path (per-patient survival
analysis) belongs to an entry point that is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from immunostruct_tpu_torch.models.trunk import (
    ImmunoStructModel, model_apply, model_apply_comparative,
)
from immunostruct_tpu_torch.procedures.metrics import (
    evaluate_metrics, find_optimal_threshold,
)
from immunostruct_tpu_torch.procedures.train import step_generator
from immunostruct_tpu_torch.structs import ComparativeBatch, first_tensor


def collect_probs(config, model: ImmunoStructModel, pipe, seed: int):
    """(probabilities, targets) over one pass of ``pipe``, as numpy; batch
    ``i`` draws its VAE noise from ``step_generator(seed, i)``. A
    ``ComparativeBatch`` goes through the twin forward and gives the cancer
    side's target (infer.py:36-43 of the JAX package)."""
    kw = dict(deterministic=True, aggregation=config.aggregation,
              compute_dtype=getattr(torch, config.compute_dtype))
    probs, targets = [], []
    with torch.inference_mode():
        for i, batch in enumerate(pipe.epoch(0)):
            gen = step_generator(seed, i, first_tensor(batch).device)
            if isinstance(batch, ComparativeBatch):
                c, w = batch.cancer, batch.wt
                _, _, logits = model_apply_comparative(
                    model, (c.graph, w.graph), (c.seq_onehot, w.seq_onehot),
                    (c.props, w.props), generator=gen, **kw)
                target = c.target
            else:
                logits = model_apply(model, batch.graph, batch.seq_onehot,
                                     batch.props, generator=gen, **kw).logits
                target = batch.target
            probs.append(torch.sigmoid(logits.reshape(-1).float()))
            targets.append(target.reshape(-1))
    return (torch.cat(probs).cpu().numpy(),
            torch.cat(targets).float().cpu().numpy())


def inference(config, model: ImmunoStructModel, pipe, *,
              optimal_threshold: Optional[float] = None,
              return_raw_preds: bool = False,
              verbose: bool = True) -> dict:
    """Metric evaluation over a pipeline; batch noise from (seed + 0x1f,
    batch). When ``optimal_threshold`` is None, Youden's optimum is derived
    from THIS split and returned for reuse on another
    (train_IEDB_wFT.py:127-129). ``return_raw_preds`` adds the
    probabilities and targets, in the pipeline's order, as
    ``predicted_probs`` and ``true_targets``."""
    probs, targets = collect_probs(config, model, pipe, config.seed + 0x1f)
    if optimal_threshold is None:
        optimal_threshold = find_optimal_threshold(targets, probs)
    out = evaluate_metrics(targets, probs, optimal_threshold,
                           verbose=verbose)
    if return_raw_preds:
        out["predicted_probs"] = probs
        out["true_targets"] = targets
    return out
