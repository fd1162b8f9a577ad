"""Inference (counterpart of ``immunostruct_tpu/procedures/infer.py``;
reference: procedures/infer.py:9-103).

Collects sigmoid probabilities over a pipeline with the deterministic
forward, derives or reuses the Youden-optimal threshold, and computes the
full metric suite. The comparative forward's inference and the clinical
path (per-patient survival analysis) belong to entry points that are not
ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from immunostruct_tpu_torch.models.trunk import ImmunoStructModel, model_apply
from immunostruct_tpu_torch.procedures.metrics import (
    evaluate_metrics, find_optimal_threshold,
)
from immunostruct_tpu_torch.procedures.train import step_generator


def collect_probs(config, model: ImmunoStructModel, pipe, seed: int):
    """(probabilities, targets) over one pass of ``pipe``, as numpy; batch
    ``i`` draws its VAE noise from ``step_generator(seed, i)``."""
    dtype = getattr(torch, config.compute_dtype)
    probs, targets = [], []
    with torch.inference_mode():
        for i, batch in enumerate(pipe.epoch(0)):
            logits = model_apply(
                model, batch.graph, batch.seq_onehot, batch.props,
                generator=step_generator(seed, i, batch.target.device),
                deterministic=True, aggregation=config.aggregation,
                compute_dtype=dtype).logits
            probs.append(torch.sigmoid(logits.reshape(-1).float()))
            targets.append(batch.target.reshape(-1))
    return (torch.cat(probs).cpu().numpy(),
            torch.cat(targets).float().cpu().numpy())


def inference(config, model: ImmunoStructModel, pipe, *,
              optimal_threshold: Optional[float] = None,
              verbose: bool = True) -> dict:
    """Metric evaluation over a pipeline; batch noise from (seed + 0x1f,
    batch). When ``optimal_threshold`` is None, Youden's optimum is derived
    from THIS split and returned for reuse on another
    (train_IEDB_wFT.py:127-129)."""
    probs, targets = collect_probs(config, model, pipe, config.seed + 0x1f)
    if optimal_threshold is None:
        optimal_threshold = find_optimal_threshold(targets, probs)
    return evaluate_metrics(targets, probs, optimal_threshold,
                            verbose=verbose)
