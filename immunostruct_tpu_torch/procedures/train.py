"""One training step of a zoo model (counterpart of
``immunostruct_tpu/procedures/train.py``: ``make_optimizer``, ``TrainState``
and ``Trainer``'s loss, gradient, train and eval steps).

PyTorch runs the step eagerly: the forward, the stage loss, ``backward()``
(through the EGNN kernels' ``EdgeMega`` on the 'mega' path) and the
optimizer update, on the parameters in place. Master weights stay in their
dtype (f32); ``compute_dtype`` is the forward's.

Parity notes, as in the JAX package:
- the comparative loss averages the twin losses and adds the gated
  contrastive term, whose projector is trained with the model;
- the learning-rate schedule is a function of the epoch, indexed by
  ``step // steps_per_epoch``;
- each step draws its noise (VAE eps, dropout) from a generator seeded
  from (seed, step), the counterpart of ``fold_in(rng, state.step)``, so
  a step can be repeated. ``eps`` replaces the VAE draws (tests replay the
  JAX package's).

``Trainer.fit``, the collapse guard and ``train_model`` need the data
pipeline and are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from immunostruct_tpu_torch.models.trunk import (
    ImmunoStructModel, ModelSpec, model_apply, model_apply_comparative,
)
from immunostruct_tpu_torch.structs import (
    ComparativeBatch, first_tensor, map_tensors,
)
from immunostruct_tpu_torch.utils.contrastive import (
    PairedContrastiveProjector, paired_contrastive_loss,
)
from immunostruct_tpu_torch.utils.losses import LossConfig, make_loss_fn

OPTIMIZERS = ("adam", "adamw")


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """What ``make_optimizer`` returns: ``build`` makes the
    ``torch.optim`` optimizer for a model's parameters, ``lr`` gives the
    rate of a step."""

    name: str
    lr_schedule: Callable
    weight_decay: float = 0.0
    steps_per_epoch: int = 1

    def lr(self, step: int) -> float:
        return float(self.lr_schedule(step // self.steps_per_epoch))

    def build(self, params) -> torch.optim.Optimizer:
        # the rate is set before every step (``Trainer.train_step``)
        if self.name == "adamw":
            return torch.optim.AdamW(params, lr=self.lr(0),
                                     weight_decay=self.weight_decay)
        return torch.optim.Adam(params, lr=self.lr(0),
                                weight_decay=self.weight_decay)


def make_optimizer(name: str, lr_schedule: Callable,
                   weight_decay: float = 0.0,
                   steps_per_epoch: int = 1) -> OptimizerConfig:
    """Adam or AdamW with an epoch-indexed schedule.

    'adam' with ``weight_decay`` is coupled L2 (the decay joins the
    gradient before the moments, ``torch.optim.Adam(weight_decay=...)``,
    the reference's IEDB finetune); 'adamw' decays decoupled."""
    if name not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer '{name}'; choose from "
                         f"{OPTIMIZERS}")
    return OptimizerConfig(name, lr_schedule, weight_decay, steps_per_epoch)


@dataclasses.dataclass
class TrainState:
    model: ImmunoStructModel
    optimizer: torch.optim.Optimizer
    step: int = 0


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The noise generator of one step, seeded from (seed, step)."""
    state = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0]))
    return gen


class Trainer:
    """One training stage (pretrain or finetune) for one model spec."""

    def __init__(self, spec: ModelSpec, loss_cfg: LossConfig, *,
                 binary: bool, optimizer: OptimizerConfig,
                 coeff_contrastive: float = 0.0, aggregation: str = "auto",
                 compute_dtype=torch.float32, grad_accum_steps: int = 1,
                 stack_twins: bool = False):
        if coeff_contrastive > 0 and grad_accum_steps > 1:
            # the contrastive pair-similarity / cross-correlation statistics
            # are taken over the batch the loss sees: under accumulation
            # that is the microbatch, not the reference's full batch
            raise ValueError(
                f"coeff_contrastive={coeff_contrastive} with "
                f"grad_accum_steps={grad_accum_steps}: the contrastive "
                "pair-similarity/cross-correlation statistics would be "
                "computed per microbatch, not per global batch. Either set "
                "grad_accum_steps=1 or disable the contrastive term.")
        self.spec = spec
        self.loss_cfg = loss_cfg
        self.binary = binary
        self.optimizer = optimizer
        self.coeff_contrastive = coeff_contrastive
        self.aggregation = aggregation
        self.compute_dtype = compute_dtype
        self.loss_fn = make_loss_fn(loss_cfg, binary)
        self.grad_accum_steps = grad_accum_steps
        self.stack_twins = stack_twins

    # -- state ---------------------------------------------------------------
    def init_state(self, model: ImmunoStructModel,
                   generator: Optional[torch.Generator] = None
                   ) -> TrainState:
        """Attach the contrastive projector to ``model`` (as
        ``model.contrastive_projector``, drawn from ``generator``) when the
        stage has a contrastive term and the model has none, then build the
        optimizer over all of its parameters."""
        if (self.coeff_contrastive > 0
                and not hasattr(model, "contrastive_projector")):
            device = next(model.parameters()).device
            model.contrastive_projector = PairedContrastiveProjector(
                self.spec.embedding_dim,
                generator=generator or torch.Generator().manual_seed(0),
                device=device)
        return TrainState(model=model,
                          optimizer=self.optimizer.build(model.parameters()))

    # -- loss ----------------------------------------------------------------
    def _batch_loss_aux(self, model: ImmunoStructModel, batch,
                        generator: Optional[torch.Generator],
                        deterministic: bool, eps=None):
        """(loss, (logits, target)). ``eps``: the VAE noise for this batch
        (a tensor; for a comparative batch what ``model_apply_comparative``
        takes), None to draw it from ``generator``."""
        kw = dict(generator=generator, deterministic=deterministic,
                  aggregation=self.aggregation,
                  compute_dtype=self.compute_dtype, eps=eps)
        if isinstance(batch, ComparativeBatch):
            c, w = batch.cancer, batch.wt
            out_c, out_w, logits = model_apply_comparative(
                model, (c.graph, w.graph), (c.seq_onehot, w.seq_onehot),
                (c.props, w.props), stack_twins=self.stack_twins, **kw)
            loss_c = self.loss_fn(out_c.recon, c.seq_onehot, out_c.mu,
                                  out_c.logvar, logits, c.target,
                                  node_logits=out_c.node_logits,
                                  residue=c.aux_residue)
            loss_w = self.loss_fn(out_w.recon, w.seq_onehot, out_w.mu,
                                  out_w.logvar, logits, w.target,
                                  node_logits=out_w.node_logits,
                                  residue=w.aux_residue)
            loss = (loss_c + loss_w) / 2.0
            if self.coeff_contrastive > 0:
                loss = loss + self.coeff_contrastive * paired_contrastive_loss(
                    model.contrastive_projector, out_c.embedding,
                    out_w.embedding, c.target)
            return loss, (logits, c.target)
        out = model_apply(model, batch.graph, batch.seq_onehot, batch.props,
                          **kw)
        loss = self.loss_fn(out.recon, batch.seq_onehot, out.mu, out.logvar,
                            out.logits, batch.target,
                            node_logits=out.node_logits,
                            residue=batch.aux_residue)
        return loss, (out.logits, batch.target)

    # -- steps ---------------------------------------------------------------
    def loss_and_grads(self, model: ImmunoStructModel, batch,
                       generator: Optional[torch.Generator], eps=None
                       ) -> torch.Tensor:
        """The training-mode loss of ``batch``; its gradients are left in
        the parameters' ``.grad`` (which must be empty or zero).

        With ``grad_accum_steps`` k > 1 the batch is cut into k microbatches
        along its leading axis, each forward and backward in turn, and the
        summed gradients and losses are scaled by 1/k. A batch whose size k
        does not divide (a trailing remainder batch) takes one unsplit
        step. ``eps`` then holds one entry per microbatch."""
        k = self.grad_accum_steps
        if k <= 1 or first_tensor(batch).shape[0] % k != 0:
            loss, _ = self._batch_loss_aux(model, batch, generator, False, eps)
            loss.backward()
            return loss.detach()
        size = first_tensor(batch).shape[0] // k
        total = None
        for i in range(k):
            micro = map_tensors(
                lambda t, i=i: t[i * size:(i + 1) * size], batch)
            loss, _ = self._batch_loss_aux(
                model, micro, generator, False,
                None if eps is None else eps[i])
            loss.backward()
            total = loss.detach() if total is None else total + loss.detach()
        with torch.no_grad():
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.mul_(1.0 / k)
        return total * (1.0 / k)

    def train_step(self, state: TrainState, batch, seed: int, eps=None):
        """One optimizer step on ``batch``: (state, loss). The step's noise
        comes from ``step_generator(seed, state.step)``; ``state`` is
        updated in place (parameters, optimizer moments, step)."""
        generator = step_generator(seed, state.step,
                                   first_tensor(batch).device)
        state.optimizer.zero_grad(set_to_none=True)
        loss = self.loss_and_grads(state.model, batch, generator, eps)
        for group in state.optimizer.param_groups:
            group["lr"] = self.optimizer.lr(state.step)
        state.optimizer.step()
        state.step += 1
        return state, loss

    def eval_step(self, model: ImmunoStructModel, batch, seed: int,
                  eps=None):
        """(loss, (logits, target)) of the deterministic forward, without
        gradients."""
        generator = step_generator(seed, 0, first_tensor(batch).device)
        with torch.no_grad():
            return self._batch_loss_aux(model, batch, generator, True, eps)
