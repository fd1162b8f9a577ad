"""Metric logging to stdout and a JSONL file (counterpart of
``immunostruct_tpu/utils/logging.py``; reference: wandb.init at
train_IEDB_wFT.py:48-53; per-epoch and final dumps train.py:60-63,
train_IEDB_wFT.py:131-163).

The port has no wandb sink: a run asked to log to wandb warns and logs to
the JSONL file only.
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Optional


class MetricLogger:
    def __init__(self, project: Optional[str] = None,
                 entity: Optional[str] = None, name: Optional[str] = None,
                 config: Optional[dict] = None,
                 jsonl_path: Optional[str] = None):
        if entity:
            warnings.warn(
                f"wandb logging (--wandb-username {entity}) is not ported "
                "to PyTorch; metrics go to stdout and "
                f"{jsonl_path or 'nowhere else'}", stacklevel=2)
        self.jsonl_path = jsonl_path
        if jsonl_path:
            os.makedirs(os.path.dirname(jsonl_path) or ".", exist_ok=True)

    def log(self, metrics: dict) -> None:
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                clean = {k: (float(v) if hasattr(v, "__float__") else v)
                         for k, v in metrics.items()}
                f.write(json.dumps(clean) + "\n")

    def finish(self) -> None:
        pass


def stage_log_fn(logger: MetricLogger, stage_prefix: str):
    """Per-stage ``log_fn`` for ``train_model``: prefixes the per-epoch loss
    keys (train_IEDB_wFT.py:97-99); any other payload (collapse-guard
    events, re-init markers) is logged with the prefix on each key."""
    def log_fn(m: dict) -> None:
        if "train_loss" in m:
            logger.log({f"{stage_prefix}_train_loss": m["train_loss"],
                        f"{stage_prefix}_val_loss": m["val_loss"]})
        else:
            logger.log({f"{stage_prefix}_{k}": v for k, v in m.items()})
    return log_fn


def stats_to_wandb(prefix: str, stats: dict) -> dict:
    """Final metric dump layout (train_IEDB_wFT.py:131-163); the clinical
    survival p-values, where ``stats`` has them, under their own names
    without the prefix."""
    names = {
        "roc_auc": "ROC AUC", "pr_auc": "PR AUC",
        "accuracy": "Accuracy @0.5", "accuracy_op": "Accuracy @op",
        "f1": "F1 Score @0.5", "f1_op": "F1 Score @op",
        "precision": "Precision @0.5", "precision_op": "Precision @op",
        "recall": "Recall @0.5", "recall_op": "Recall @op",
        "ppvn": "Mean PPVn @0.5", "ppvn_op": "Mean PPVn @op",
        "ppv30": "PPVn (n=30) @0.5", "ppv30_op": "PPVn (n=30) @op",
    }
    out = {f"{prefix} {label}": stats[key] for key, label in names.items()
           if key in stats}
    for key, label in (("os_p_value", "OS p-value"),
                       ("pfs_p_value", "PFS p-value")):
        if key in stats:
            out[label] = stats[key]
    return out
