"""Loss suite (counterpart of ``immunostruct_tpu/utils/losses.py``;
reference: immunostruct/utils/loss.py:5-61).

  regression stage: 2*MSE(pred, foreignness) [+ 0.5*recon-MSE + 0.5*KLD]
  binary stage:     5*weighted-BCE          [+ 0.1*recon     + 0.1*KLD]
  SSL variants add a masked-residue cross-entropy term.

``pos_weight = N_neg / N_pos`` scales the positive examples' BCE terms, as
torch's ``BCEWithLogitsLoss(pos_weight=...)`` does. The expressions are the
JAX package's, in the same dtypes: the recon term in f32, mu/logvar in the
compute dtype.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
from torch.nn import functional as F

from immunostruct_tpu_torch.parallel.mesh import current_batch_shard


@dataclasses.dataclass(frozen=True)
class LossConfig:
    vae_input_dim: int
    pos_weight: float          # N_neg / N_pos
    sequence: bool = True      # include recon + KLD terms (--sequence-loss)
    ssl: bool = False


def _recon_kld(recon, x_flat, mu, logvar):
    mse = torch.mean((recon - x_flat) ** 2)
    kld = -0.5 * torch.mean(1 + logvar - mu ** 2 - torch.exp(logvar))
    return mse, kld


def _ssl_term(node_logits: Optional[torch.Tensor],
              residue: Optional[torch.Tensor]):
    """Cross-entropy over the 20 amino-acid classes for the masked residue;
    0 when either is None, and residues < 0 are left out. Under a
    data-parallel ``batch_shard`` the mean is the global batch's: this
    rank's sum, times the shard count, over the count of valid residues on
    every shard (the ranks' terms are averaged)."""
    if node_logits is None or residue is None:
        return 0.0
    logp = torch.log_softmax(node_logits.float(), dim=-1)
    valid = residue >= 0
    residue = residue.clamp(0, logp.shape[-1] - 1).long()
    nll = -torch.gather(logp, 1, residue[:, None])[:, 0]
    shard = current_batch_shard()
    if shard is not None:
        denom = shard.total(valid.sum()).clamp_min(1)
        return torch.where(valid, nll, 0.0).sum() * shard.size / denom
    denom = valid.sum().clamp_min(1)
    return torch.where(valid, nll, 0.0).sum() / denom


def regression_loss(cfg: LossConfig, recon, x_flat, mu, logvar, pred, target,
                    node_logits=None, residue=None):
    reg = torch.mean((pred.reshape(-1).float() - target.reshape(-1)) ** 2)
    ssl = _ssl_term(node_logits, residue) if cfg.ssl else 0.0
    if cfg.sequence:
        mse, kld = _recon_kld(recon.float(),
                              x_flat.reshape(-1, cfg.vae_input_dim), mu, logvar)
        return 2.0 * reg + 0.5 * mse + 0.5 * kld + ssl
    return reg + ssl


def bce_loss(cfg: LossConfig, recon, x_flat, mu, logvar, pred, target,
             node_logits=None, residue=None):
    logits = pred.reshape(-1).float()
    y = target.reshape(-1).float()
    # weighted BCE-with-logits: -[w*y*log(sig) + (1-y)*log(1-sig)]
    log_sig = F.logsigmoid(logits)
    log_one_minus = F.logsigmoid(-logits)
    bce = torch.mean(-(cfg.pos_weight * y * log_sig
                       + (1.0 - y) * log_one_minus))
    ssl = _ssl_term(node_logits, residue) if cfg.ssl else 0.0
    if cfg.sequence:
        mse, kld = _recon_kld(recon.float(),
                              x_flat.reshape(-1, cfg.vae_input_dim), mu, logvar)
        return 5.0 * bce + 0.1 * mse + 0.1 * kld + ssl
    return bce + ssl


def make_loss_fn(cfg: LossConfig, binary: bool):
    """The stage loss: BCE when ``binary``, else foreignness regression."""
    return functools.partial(bce_loss if binary else regression_loss, cfg)


def pos_weight_from_counts(class_counts: dict) -> float:
    """Counter({0.0: N_neg, 1.0: N_pos}) -> N_neg / N_pos."""
    return float(class_counts.get(0, class_counts.get(0.0, 1.0))) / \
        float(class_counts.get(1, class_counts.get(1.0, 1.0)))


def plot_losses(train_losses, val_losses, save_path: Optional[str] = None):
    """Loss-curve plot (reference: utils/loss.py:64-72), headless (Agg);
    without matplotlib it says so and returns."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib unavailable; skipping loss plot")
        return
    fig = plt.figure(figsize=(10, 5))
    plt.plot(train_losses, label="Train Loss")
    plt.plot(val_losses, label="Validation Loss")
    plt.title("Training and Validation Losses")
    plt.xlabel("Epochs")
    plt.ylabel("Loss")
    plt.legend()
    if save_path:
        fig.savefig(save_path)
    plt.close(fig)
