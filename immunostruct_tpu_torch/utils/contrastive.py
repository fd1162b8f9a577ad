"""Paired cancer/WT contrastive loss (counterpart of
``immunostruct_tpu/utils/contrastive.py``; reference:
immunostruct/utils/contrastive.py:6-83).

Barlow-Twins-flavoured objective over projected cancer/WT embedding pairs:
a unit-variance hinge on both projections, the pair-similarity matrix
pushed to I on immunogenic rows and to 0 elsewhere, the cross-correlation
matrix pushed to I, off-diagonals down-weighted by ``lambda_off_diag``.

As in the JAX package, the projector's parameters are trained with the
model (``Trainer.init_state`` attaches it as ``contrastive_projector``),
and the reference's Python gate (``len(unique(y)) == 2``) is a
data-dependent factor: the loss is 0 unless the targets are all 0/1 with
both classes present.
"""

from __future__ import annotations

import torch
from torch import nn

from immunostruct_tpu_torch.ops.nnp import Linear
from immunostruct_tpu_torch.parallel.collectives import all_gather
from immunostruct_tpu_torch.parallel.mesh import current_batch_shard


class PairedContrastiveProjector(nn.Module):
    """Linear -> batch norm (batch statistics) -> ReLU -> Linear, with the
    JAX package's parameter names: ``fc1.w``, ``bn_scale``, ``bn_bias``,
    ``fc2.w``."""

    def __init__(self, embedding_dim: int = 104, z_dim: int = 128, *,
                 generator: torch.Generator, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.fc1 = Linear(embedding_dim, z_dim, bias=False, **kw)
        self.bn_scale = nn.Parameter(torch.ones(z_dim, device=device,
                                                dtype=dtype))
        self.bn_bias = nn.Parameter(torch.zeros(z_dim, device=device,
                                                dtype=dtype))
        self.fc2 = Linear(z_dim, z_dim, bias=False, **kw)


def _project(p: PairedContrastiveProjector, e: torch.Tensor) -> torch.Tensor:
    z = e @ p.fc1.w
    mean = z.mean(0, keepdim=True)
    var = z.var(0, unbiased=False, keepdim=True)
    z = (z - mean) / torch.sqrt(var + 1e-5)
    z = torch.relu(z * p.bn_scale + p.bn_bias)
    return z @ p.fc2.w


def paired_contrastive_loss(p: PairedContrastiveProjector,
                            embedding_cancer: torch.Tensor,
                            embedding_wt: torch.Tensor, target: torch.Tensor,
                            lambda_off_diag: float = 1e-2) -> torch.Tensor:
    """The gated contrastive loss (0 when the batch cannot contrast).
    Under a data-parallel ``batch_shard`` (``parallel/mesh.py``) every rank
    computes it on the global batch: the embeddings are gathered (their
    gradient flows back to each rank's rows) and so are the targets."""
    shard = current_batch_shard()
    if shard is not None:
        embedding_cancer = shard.gather(embedding_cancer.float())
        embedding_wt = shard.gather(embedding_wt.float())
        target = all_gather(target.reshape(-1), shard.axis, mesh=shard.mesh)
    y = target.reshape(-1).float()
    is_binary = torch.all((y == 0.0) | (y == 1.0))
    has_both = torch.any(y == 1.0) & torch.any(y == 0.0)
    gate = (is_binary & has_both).float()

    # threshold against the batch mean, as the reference does
    is_immunogenic = y > y.mean()

    z_c = _project(p, embedding_cancer.float())
    z_w = _project(p, embedding_wt.float())
    b, z_dim = z_c.shape
    z_c = z_c - z_c.mean(0)
    z_w = z_w - z_w.mean(0)

    std_c = torch.sqrt(z_c.var(0, unbiased=True) + 1e-4)
    std_w = torch.sqrt(z_w.var(0, unbiased=True) + 1e-4)
    std_loss = (torch.relu(1.0 - std_c).mean() / 2
                + torch.relu(1.0 - std_w).mean() / 2)

    pair_sim = (z_c @ z_w.T) / z_dim                        # [B, B]
    cross_corr = (z_c.T @ z_w) / b                          # [Z, Z]

    eye_b = torch.eye(b, device=z_c.device)
    pair_ideal = eye_b * is_immunogenic[:, None].float()
    pair_diff = (pair_sim - pair_ideal) ** 2
    pair_diff = torch.where(eye_b > 0, pair_diff, pair_diff * lambda_off_diag)

    eye_z = torch.eye(z_dim, device=z_c.device)
    corr_diff = (cross_corr - eye_z) ** 2
    corr_diff = torch.where(eye_z > 0, corr_diff, corr_diff * lambda_off_diag)

    loss = pair_diff.sum() + corr_diff.sum() + std_loss
    return gate * loss
