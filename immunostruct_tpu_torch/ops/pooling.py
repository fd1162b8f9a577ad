"""Graph readout (counterpart of ``immunostruct_tpu/ops/pooling.py``).

Padding rows are included, as in the JAX package and the reference: every
graph is padded to the same node count and padded nodes carry
node-MLP-constant features.
"""

from __future__ import annotations

import torch


def mean_pool(x: torch.Tensor) -> torch.Tensor:
    """[B, N, C] -> [B, C]; includes padding rows."""
    return x.mean(dim=1)


def max_pool(x: torch.Tensor) -> torch.Tensor:
    """[B, N, C] -> [B, C]; includes padding rows."""
    return x.amax(dim=1)
