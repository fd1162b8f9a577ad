"""Determinism utilities (counterpart of ``immunostruct_tpu/utils/seeding.py``;
reference: utils/seed.py:7-20)."""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def seed_everything(seed: int) -> torch.Generator:
    """Seed Python's, numpy's and torch's global generators and return the
    root ``torch.Generator`` (the counterpart of the root JAX key)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    return torch.Generator().manual_seed(seed)
