"""Data-parallel and model-parallel training steps (counterpart of
``immunostruct_tpu/parallel/trainer.py``).

1. ``make_sharded_trainer``: a ``Trainer`` whose batches are split over
   the mesh's data axis, the counterpart of JAX's GSPMD step. JAX's step
   is the global batch's step, so this one is too (not DDP's mean of
   per-shard losses): each rank keeps its rows of the global batch, draws
   its noise at the global shape and keeps its rows, and sees the global
   batch in every term that mixes examples (the contrastive projector's
   batch norm, its gate and statistics, the SSL mean's count; see
   ``parallel/mesh.py::BatchShard``); the gradients and the loss are
   averaged over the axis in one flat buffer a step (``all_reduce`` then
   divide). ``model_apply`` is called as a function, not a module's
   ``forward``, so ``DistributedDataParallel``'s hooks do not fit, and the
   reduction is explicit.

2. ``shard_map_train_step``: the explicit per-shard step, JAX's
   ``shard_map`` form: each shard's own loss, statistics and noise (the
   rank folded into the step's seed), gradients and loss mean-reduced by
   ``all_reduce`` ('psum') or the hand-written ring ('ring').

3. ``make_mp_train_step``: the step of a Trainer with an ``MPConfig``
   (Megatron VAE over 'model', GPipe hidden convs over 'pipe'),
   optionally with the batch split over 'data' as in 1. A weight's
   gradient lands on the rank's slice or stage, so the step sums the
   split parameters' gradients over 'model' and 'pipe' (JAX's
   ``shard_map`` transpose does this implicitly) and then averages every
   gradient over 'data': every rank's parameters after the step equal the
   dense step's.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from immunostruct_tpu_torch.parallel.collectives import (
    mean_gradients, sum_gradients,
)
from immunostruct_tpu_torch.parallel.mesh import (
    Mesh, make_mesh, shard_batch, shard_rows,
)
from immunostruct_tpu_torch.parallel.mp import sharded_parameters
from immunostruct_tpu_torch.procedures.train import (
    Trainer, derived_seed, step_generator,
)
from immunostruct_tpu_torch.structs import first_tensor


def make_sharded_trainer(spec, loss_cfg, *, binary: bool, optimizer,
                         mesh: Optional[Mesh] = None, axis_name: str = "data",
                         **trainer_kwargs) -> Trainer:
    """A Trainer whose batches are split over the mesh's data axis (the
    whole world by default); its ``init_state`` gives every rank rank 0's
    weights. ``trainer_kwargs`` are ``Trainer``'s. With
    ``grad_accum_steps`` k a rank's k-th local microbatch is its share of
    the global k-th (``shard_rows``), so that a term that mixes examples
    (the contrastive term under ``allow_microbatch_contrastive``) takes
    the global microbatch's statistics, as JAX's GSPMD step does."""
    mesh = mesh if mesh is not None else make_mesh(axis_name)
    k = trainer_kwargs.get("grad_accum_steps", 1)
    return Trainer(spec, loss_cfg, binary=binary, optimizer=optimizer,
                   mesh=mesh, data_axis=axis_name,
                   shard_batch=functools.partial(
                       shard_batch, mesh=mesh, axis_name=axis_name,
                       microbatches=k),
                   **trainer_kwargs)


def _batch_sizes(pipe) -> set:
    """The batch sizes a host or device pipeline yields in an epoch."""
    n, size = len(pipe.indices), pipe.batch_size
    sizes = {min(n, size)}
    if n % size and not pipe.pad_final_batch:
        sizes.add(n % size)
    return sizes


def check_shardable(trainer: Trainer, **pipes) -> None:
    """Fail before the first step when a pipeline would yield a batch that
    the data axis does not divide (``shard_rows`` raises the same at the
    batch): the remainder is never padded or dropped silently."""
    n = trainer.mesh.size(trainer.data_axis)
    for name, pipe in pipes.items():
        for size in sorted(_batch_sizes(pipe)):
            try:
                shard_rows(size, 0, n, trainer.grad_accum_steps)
            except ValueError as e:
                raise ValueError(f"{name}: {e} (its {len(pipe.indices)} "
                                 f"rows in batches of {pipe.batch_size})"
                                 ) from None


def _apply_update(trainer: Trainer, state, loss):
    for group in state.optimizer.param_groups:
        group["lr"] = trainer.optimizer.lr(state.step)
    state.optimizer.step()
    state.step += 1
    return state, loss


def shard_map_train_step(trainer: Trainer, mesh: Mesh,
                         axis_name: str = "data", reduce: str = "psum"):
    """The explicit per-shard step: returns ``step(state, batch, seed) ->
    (state, loss)`` for a rank's shard (``shard_batch``) of equal size on
    every rank. Each rank's noise comes from (seed, step, its index on the
    axis); ``reduce``: 'psum' (``all_reduce``) or 'ring'
    (``ring_all_reduce``)."""

    def step(state, batch, seed: int):
        index = mesh.index(axis_name)
        generator = torch.Generator(device=first_tensor(batch).device)
        generator.manual_seed(derived_seed(seed, state.step, index))
        state.optimizer.zero_grad(set_to_none=True)
        loss = trainer.loss_and_grads(state.model, batch, generator)
        loss = mean_gradients(state.model.parameters(), loss, axis_name,
                              mesh, reduce)
        return _apply_update(trainer, state, loss)

    return step


def make_mp_train_step(trainer: Trainer, mesh: Mesh,
                       data_axis: Optional[str] = None,
                       deterministic: bool = False):
    """The model-parallel (TP and/or PP) step of the real model: returns
    ``step(state, batch, seed, eps=None) -> (state, loss)`` for the global
    ``batch``. ``trainer.mp``'s axes must be ``mesh``'s; ``data_axis``
    also splits the batch, as ``make_sharded_trainer`` does (the global
    batch's semantics). ``deterministic`` turns dropout off, as JAX's
    equivalence checks do."""
    assert trainer.mp is not None, \
        "trainer must be built with mp=MPConfig(...)"
    data = (mesh, data_axis) if data_axis else None

    def step(state, batch, seed: int, eps=None):
        model = state.model
        if data_axis:
            batch = shard_batch(batch, mesh, data_axis,
                                trainer.grad_accum_steps)
        generator = step_generator(seed, state.step,
                                   first_tensor(batch).device)
        state.optimizer.zero_grad(set_to_none=True)
        with mesh:
            loss = trainer.loss_and_grads(model, batch, generator, eps,
                                          deterministic=deterministic,
                                          data=data)
        params = dict(model.named_parameters())
        for axis, names in sharded_parameters(model, trainer.mp).items():
            sum_gradients([params[n] for n in names], axis, mesh)
        if data_axis:
            loss = mean_gradients(model.parameters(), loss, data_axis, mesh)
        return _apply_update(trainer, state, loss)

    return step
