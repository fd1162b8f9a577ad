"""Training engine (counterpart of ``immunostruct_tpu/procedures/train.py``):
``make_optimizer``, ``TrainState``, ``Trainer`` (loss, gradient, train and
eval steps, and ``fit``, the epoch loop), the collapse guard and
``train_model``, the stage runner.

A step is the forward, the stage loss, ``backward()`` (through the EGNN
kernels' ``EdgeMega`` on the 'mega' path) and the optimizer update, on the
parameters in place. Master weights stay in their dtype (f32);
``compute_dtype`` is the forward's. On the card the train and eval steps
are captured programs (``utils/capture.py``), the counterparts of the JAX
package's two jitted steps: each key's first step runs eagerly, its second
is captured as a CUDA graph, and later steps replay it with the eager
step's bits (the step's generator re-seeded, the rate a device tensor).
They run eagerly on the CPU, under a mesh (``--data-parallel``) and with
``Trainer(capture=False)``.

Parity notes, as in the JAX package:
- the comparative loss averages the twin losses and adds the gated
  contrastive term, whose projector is trained with the model;
- the learning-rate schedule is a function of the epoch, indexed by
  ``step // steps_per_epoch``;
- each step draws its noise (VAE eps, dropout) from a generator seeded
  from (seed, step), the counterpart of ``fold_in(rng, state.step)``, so
  a step can be repeated. ``eps`` replaces the VAE draws (tests replay the
  JAX package's).

``Trainer.fit`` keeps the JAX package's epoch loop: best-val checkpoint,
an optional per-epoch resume snapshot removed when the stage ends, and the
collapse guard on the validation AUROC (median-split for soft targets).
Its batches come from ``data/pipeline.py`` through ``prefetch``.

Data parallelism (``parallel/trainer.py::make_sharded_trainer``, as
``--data-parallel``): the Trainer holds a ``Mesh`` and ``shard_batch``;
every rank reads the global batch, keeps its rows, and runs the step
under ``batch_shard`` so that its draws and batch statistics are the
global batch's; the gradients and the loss are then averaged over the
data axis in one flat buffer. The step is the one-process step on the
global batch. Rank 0 alone writes checkpoints and snapshots (the others
wait at a barrier), validation gathers the logits, and every decision
that ends a stage comes from those global values.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from immunostruct_tpu_torch.models.trunk import (
    ImmunoStructModel, ModelSpec, gcn_aggregation, model_apply,
    model_apply_comparative,
)
from immunostruct_tpu_torch.parallel.collectives import (
    all_gather, mean_gradients, pmean,
)
from immunostruct_tpu_torch.parallel.mesh import (
    BatchShard, barrier, batch_shard, is_primary, replicate_tree,
)
from immunostruct_tpu_torch.procedures.metrics import roc_auc_score
from immunostruct_tpu_torch.structs import (
    ComparativeBatch, first_tensor, map_tensors,
)
from immunostruct_tpu_torch.utils.capture import Program, module_tensors
from immunostruct_tpu_torch.utils.contrastive import (
    PairedContrastiveProjector, paired_contrastive_loss,
)
from immunostruct_tpu_torch.utils.losses import LossConfig, make_loss_fn

OPTIMIZERS = ("adam", "adamw")


class PretrainCollapse(RuntimeError):
    """Raised by ``Trainer.fit`` when the collapse guard fires and the
    caller opted into restart (``raise_on_fire``)."""

    def __init__(self, epoch: int, val_auc: float, window: int):
        super().__init__(
            f"pretrain collapse: val AUROC at chance ({val_auc:.3f}) for "
            f"{window} consecutive epochs (epoch {epoch + 1})")
        self.epoch = epoch
        self.val_auc = val_auc


@dataclasses.dataclass
class CollapseGuard:
    """Detects the flatlined-at-chance pretrain failure: fires when the
    validation AUROC stays within ``chance_band`` of 0.5 for ``window``
    consecutive epochs from ``min_epoch`` on. The loss cannot show it (the
    VAE branch keeps improving the combined loss while the classifier is
    dead), so the guard watches the AUROC of the validation logits."""

    window: int = 8           # consecutive at-chance epochs to fire
    chance_band: float = 0.07 # |AUROC - 0.5| below this counts as chance
    min_epoch: int = 6        # ignore the initial epochs
    raise_on_fire: bool = False
    # whether --reinit-on-collapse would act on this stage (pretrain only):
    # picks the advice printed when the guard fires
    reinit_available: bool = True

    _streak: int = dataclasses.field(default=0, init=False)
    fired: bool = dataclasses.field(default=False, init=False)

    def observe(self, epoch: int, val_auc: float) -> bool:
        """Record one epoch; returns True the first time the guard fires."""
        if epoch < self.min_epoch:
            return False
        at_chance = abs(val_auc - 0.5) < self.chance_band
        self._streak = self._streak + 1 if at_chance else 0
        if self._streak >= self.window and not self.fired:
            self.fired = True
            return True
        return False


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

    def build(self, params, device=None) -> torch.optim.Optimizer:
        """The optimizer over ``params``, its rate a tensor that
        ``apply_lr`` fills before every step. On a CUDA ``device`` the rate
        lies there (f32) and the optimizer is ``capturable``, so that a
        captured step reads the step count and the rate from the device;
        the card's eager step uses the same optimizer. Elsewhere the rate is
        an f64 tensor on the CPU, whose update has a float rate's bits."""
        cls = torch.optim.AdamW if self.name == "adamw" else torch.optim.Adam
        cuda = device is not None and torch.device(device).type == "cuda"
        lr = torch.tensor(self.lr(0), device=device if cuda else "cpu",
                          dtype=torch.float32 if cuda else torch.float64)
        return cls(params, lr=lr, weight_decay=self.weight_decay,
                   capturable=cuda)

    def apply_lr(self, optimizer: torch.optim.Optimizer, step: int) -> None:
        """Fill the rate of ``step`` into the optimizer's rate tensors."""
        for group in optimizer.param_groups:
            group["lr"].fill_(self.lr(step))


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


def derived_seed(*words: int) -> int:
    """One 64-bit seed from a tuple of integers (the counterpart of folding
    words into a JAX key)."""
    return int(np.random.SeedSequence(list(words)).generate_state(
        1, np.uint64)[0])


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The noise generator of one step, seeded from (seed, step)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(derived_seed(seed, step))
    return gen


class Trainer:
    """One training stage (pretrain or finetune) for one model spec."""

    def __init__(self, spec: ModelSpec, loss_cfg: LossConfig, *,
                 binary: bool, optimizer: OptimizerConfig,
                 coeff_contrastive: float = 0.0, aggregation: str = "auto",
                 compute_dtype=torch.float32, grad_accum_steps: int = 1,
                 stack_twins: bool = False, mega_variant: str = "hybrid",
                 mesh=None, shard_batch=None, mp=None,
                 data_axis: str = "data",
                 allow_microbatch_contrastive: bool = False,
                 capture: Optional[bool] = None):
        """``mesh``/``shard_batch``: the data-parallel placement (a
        ``parallel/mesh.py::Mesh`` and the function that keeps a rank's
        rows of a global batch; ``make_sharded_trainer`` sets both).
        ``mp``: a ``parallel/mp.py::MPConfig``, whose step is
        ``parallel/trainer.py::make_mp_train_step``.
        ``allow_microbatch_contrastive``: the opt-in that lets the
        contrastive term run under gradient accumulation, on each
        microbatch's statistics. ``capture``: the train and eval steps as
        captured programs (``utils/capture.py``): None captures them on the
        card, except under a mesh or ``mp``, and runs them eagerly on the
        CPU; False runs them eagerly (the comparison); True captures or
        raises."""
        if (coeff_contrastive > 0 and grad_accum_steps > 1
                and not allow_microbatch_contrastive):
            # the contrastive pair-similarity / cross-correlation statistics
            # are taken over the batch the loss sees: under accumulation
            # that is the microbatch, not the reference's full batch
            raise ValueError(
                f"coeff_contrastive={coeff_contrastive} with "
                f"grad_accum_steps={grad_accum_steps}: the contrastive "
                "pair-similarity/cross-correlation statistics would be "
                "computed per microbatch, not per global batch. Either set "
                "grad_accum_steps=1, disable the contrastive term, or pass "
                "allow_microbatch_contrastive=True to opt into microbatch "
                "statistics explicitly.")
        self.spec = spec
        self.loss_cfg = loss_cfg
        self.binary = binary
        self.optimizer = optimizer
        self.coeff_contrastive = coeff_contrastive
        self.aggregation = aggregation
        # the kernel variant of aggregation 'mega' (ops/egnn.py); the JAX
        # package sets its counterparts as module globals
        self.mega_variant = mega_variant
        self.compute_dtype = compute_dtype
        self.loss_fn = make_loss_fn(loss_cfg, binary)
        self.grad_accum_steps = grad_accum_steps
        self.stack_twins = stack_twins
        self.mesh = mesh
        self.shard_batch = shard_batch
        self.mp = mp
        self.data_axis = data_axis
        # the counterparts of the JAX package's two jitted steps
        self.train_program = Program("train step", capture, grads=True)
        self.eval_program = Program("eval step", capture)

    def _data(self):
        """(mesh, data axis) when batches are shards of a global batch."""
        return (self.mesh, self.data_axis) if self.shard_batch else None

    def _shard(self, batch):
        if self.shard_batch is not None:
            return self.shard_batch(batch)
        return batch

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
        if self.mesh is not None:
            replicate_tree(model, self.mesh)
        device = next(model.parameters()).device
        return TrainState(model=model, optimizer=self.optimizer.build(
            model.parameters(), device))

    # -- loss ----------------------------------------------------------------
    def _batch_loss_aux(self, model: ImmunoStructModel, batch,
                        generator: Optional[torch.Generator],
                        deterministic: bool, eps=None):
        """(loss, (logits, target)). ``eps``: the VAE noise for this batch
        (a tensor; for a comparative batch what ``model_apply_comparative``
        takes), None to draw it from ``generator``."""
        kw = dict(generator=generator, deterministic=deterministic,
                  aggregation=self.aggregation,
                  compute_dtype=self.compute_dtype, eps=eps,
                  mega_variant=self.mega_variant, mp=self.mp)
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
    def _sharded_loss_aux(self, model, batch, generator, deterministic, eps,
                          data):
        """``_batch_loss_aux`` of a rank's shard of a global batch under
        ``batch_shard`` (``data``: (mesh, axis); None: a whole batch).
        ``eps``, when given, is the global batch's noise."""
        if data is None:
            return self._batch_loss_aux(model, batch, generator,
                                        deterministic, eps)
        mesh, axis = data
        shard = BatchShard(mesh, axis, first_tensor(batch).shape[0])
        with batch_shard(shard):
            if eps is not None:
                eps = (shard.take(eps) if torch.is_tensor(eps)
                       else tuple(shard.take(e) for e in eps))
            return self._batch_loss_aux(model, batch, generator,
                                        deterministic, eps)

    def loss_and_grads(self, model: ImmunoStructModel, batch,
                       generator: Optional[torch.Generator], eps=None,
                       deterministic: bool = False, data=None
                       ) -> torch.Tensor:
        """The training-mode loss of ``batch``; its gradients are left in
        the parameters' ``.grad`` (which must be empty or zero).

        With ``grad_accum_steps`` k > 1 the batch is cut into k microbatches
        along its leading axis, each forward and backward in turn, and the
        summed gradients and losses are scaled by 1/k. A batch whose size k
        does not divide (a trailing remainder batch) takes one unsplit
        step. ``eps`` then holds one entry per microbatch; drawn noise
        comes from ``generator``, microbatch i+1's after microbatch i's.
        With the contrastive term (``allow_microbatch_contrastive``) each
        microbatch's term takes that microbatch's statistics and gate. ``data``: (mesh,
        axis) when ``batch`` is this rank's shard of a global batch (laid
        out by ``parallel/mesh.py::shard_rows``); the split follows the
        global batch's size. ``deterministic`` turns dropout off."""
        k = self.grad_accum_steps
        n = first_tensor(batch).shape[0]
        ranks = data[0].size(data[1]) if data is not None else 1
        if k <= 1 or (n * ranks) % k != 0:
            loss, _ = self._sharded_loss_aux(model, batch, generator,
                                             deterministic, eps, data)
            loss.backward()
            return loss.detach()
        size = n // k
        total = None
        for i in range(k):
            micro = map_tensors(
                lambda t, i=i: t[i * size:(i + 1) * size], batch)
            loss, _ = self._sharded_loss_aux(
                model, micro, generator, deterministic,
                None if eps is None else eps[i], data)
            loss.backward()
            total = loss.detach() if total is None else total + loss.detach()
        with torch.no_grad():
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.mul_(1.0 / k)
        return total * (1.0 / k)

    def _eager_rule(self) -> Optional[str]:
        """Why this Trainer's steps run eagerly on the card, if they do:
        gloo's hops under a mesh are staged through pinned host memory,
        and ``mp``'s steps run collectives inside the forward."""
        if self.mesh is not None:
            return "data-parallel"
        if self.mp is not None:
            return "model-parallel"
        return None

    def _static(self, mode: str, model: ImmunoStructModel, batch) -> tuple:
        """The static arguments of a step's key (its inputs' shapes and
        dtypes join them in ``Program``)."""
        agg = self.aggregation
        if model.spec.use_structure:
            graph = (batch.cancer.graph if isinstance(batch, ComparativeBatch)
                     else batch.graph)
            agg = gcn_aggregation(model, graph, self.aggregation)
        return (mode, agg, self.mega_variant, self.compute_dtype,
                self.grad_accum_steps, self.coeff_contrastive > 0,
                self.stack_twins)

    def _train_work(self, state: TrainState, inputs, generator):
        """The whole step a train program runs or captures: the gradients
        from zero, the loss and its gradients over the k microbatches, the
        optimizer's update; its loss."""
        batch, eps = inputs
        state.optimizer.zero_grad(set_to_none=True)
        loss = self.loss_and_grads(state.model, batch, generator, eps,
                                   data=self._data())
        if self._data() is not None:
            loss = mean_gradients(state.model.parameters(), loss,
                                  self.data_axis, self.mesh)
        state.optimizer.step()
        return loss

    def _eval_work(self, model: ImmunoStructModel, inputs, generator):
        """What an eval program runs or captures: (loss, (logits, target))
        of the deterministic forward of a (batch, eps) pair."""
        with torch.no_grad():
            return self._sharded_loss_aux(model, inputs[0], generator, True,
                                          inputs[1], self._data())

    def train_step(self, state: TrainState, batch, seed: int, eps=None):
        """One optimizer step on ``batch``: (state, loss). The step's noise
        comes from ``step_generator(seed, state.step)``; ``state`` is
        updated in place (parameters, optimizer moments, step). On the card
        it runs as ``train_program``'s graph for its key."""
        self.optimizer.apply_lr(state.optimizer, state.step)
        loss = self.train_program(
            functools.partial(self._train_work, state), (batch, eps),
            static=self._static("train", state.model, batch),
            seed=derived_seed(seed, state.step),
            state=functools.partial(module_tensors, state.model,
                                    state.optimizer),
            eager=self._eager_rule())
        state.step += 1
        return state, loss

    def eval_step(self, model: ImmunoStructModel, batch, seed: int,
                  eps=None, index: int = 0):
        """(loss, (logits, target)) of the deterministic forward, without
        gradients; its noise from ``step_generator(seed, index)``. On a
        rank's shard the loss is the global batch's and the logits and
        targets are gathered from every rank. On the card it runs as
        ``eval_program``'s graph for its key."""
        data = self._data()
        loss, (logits, target) = self.eval_program(
            functools.partial(self._eval_work, model), (batch, eps),
            static=self._static("eval", model, batch),
            seed=derived_seed(seed, index),
            state=functools.partial(module_tensors, model),
            eager=self._eager_rule())
        if data is not None:
            loss = pmean(loss, self.data_axis, self.mesh)
            logits = all_gather(logits, self.data_axis, mesh=self.mesh)
            target = all_gather(target, self.data_axis, mesh=self.mesh)
        return loss, (logits, target)

    # -- epoch loop ------------------------------------------------------------
    def fit(self, state: TrainState, train_pipe, val_pipe, num_epochs: int,
            seed: int, ckpt_path: Optional[str] = None,
            log_fn: Optional[Callable[[dict], None]] = None,
            verbose: bool = True, resume_path: Optional[str] = None,
            collapse_guard: Optional[CollapseGuard] = None):
        """Best-val-checkpointed training. Returns (state, history).

        Step ``s`` draws its noise from ``step_generator(seed, s)`` and
        validation batch ``i`` from ``step_generator(seed ^ 0xE7A1, i)``.
        ``resume_path``: a snapshot file written after every epoch; when it
        exists at the start, training continues from the saved epoch
        (model, optimizer, step and best-val tracker) and ends in the state
        an uninterrupted run reaches. It is removed when the stage ends.
        ``collapse_guard``: warns when it fires, or raises PretrainCollapse
        when it has ``raise_on_fire``."""
        from immunostruct_tpu_torch.data.pipeline import prefetch
        from immunostruct_tpu_torch.utils.checkpoint import (
            load_resume_state, save_checkpoint, save_resume_state,
        )

        history = {"train_loss": [], "val_loss": [], "epoch_time": [],
                   "train_samples": []}
        lowest_val = float("inf")
        start_epoch = 0
        if resume_path:
            resumed = load_resume_state(resume_path, state)
            if resumed is not None:
                state, start_epoch, lowest_val = resumed
                if verbose:
                    print(f"resumed from {resume_path} at epoch {start_epoch}")
        eval_seed = seed ^ 0xE7A1

        for epoch in range(start_epoch, num_epochs):
            t0 = time.perf_counter()
            losses, n_samples = [], 0
            for batch in prefetch(train_pipe.epoch(epoch)):
                n_samples += first_tensor(batch).shape[0]
                state, loss = self.train_step(state, self._shard(batch),
                                              seed)
                losses.append(loss)
            # one device-to-host read per epoch, not per step
            train_loss = (float(torch.stack(losses).float().mean())
                          if losses else 0.0)

            val_losses, val_logits, val_targets = [], [], []
            for i, batch in enumerate(val_pipe.epoch(epoch)):
                loss, (logits, target) = self.eval_step(
                    state.model, self._shard(batch), eval_seed, index=i)
                val_losses.append(loss)
                if collapse_guard is not None:
                    val_logits.append(logits.reshape(-1).float())
                    val_targets.append(target.reshape(-1).float())
            val_loss = (float(torch.stack(val_losses).float().mean())
                        if val_losses else 0.0)

            if collapse_guard is not None and val_losses:
                self._observe_collapse(collapse_guard, epoch, val_logits,
                                       val_targets, history, log_fn)

            if val_loss < lowest_val:
                lowest_val = val_loss
                if ckpt_path:
                    self._write(save_checkpoint, ckpt_path, state.model)
            if resume_path:
                self._write(save_resume_state, resume_path, state, epoch,
                            lowest_val)

            dt = time.perf_counter() - t0
            history["train_loss"].append(train_loss)
            history["val_loss"].append(val_loss)
            history["epoch_time"].append(dt)
            history["train_samples"].append(n_samples)
            if log_fn:
                log_fn({"epoch": epoch, "train_loss": train_loss,
                        "val_loss": val_loss, "epoch_time_s": dt})
            if verbose:
                print(f"Epoch {epoch + 1}, Train Loss: {train_loss:.4f}, "
                      f"Val Loss: {val_loss:.4f} ({dt:.2f}s)")

        # stage finished: drop the snapshot so that a later stage with the
        # same paths starts fresh
        if resume_path:
            self._write(lambda p: os.path.exists(p) and os.remove(p),
                        resume_path)
        return state, history

    def _write(self, fn, *args) -> None:
        """Run a file write on rank 0 alone; under a mesh the other ranks
        wait until it is done."""
        if is_primary():
            fn(*args)
        if self.mesh is not None:
            barrier()

    @staticmethod
    def _observe_collapse(guard: CollapseGuard, epoch: int, logits: list,
                          targets: list, history: dict, log_fn) -> None:
        t = torch.cat(targets).cpu().numpy()
        s = torch.cat(logits).cpu().numpy()
        # soft-target stages (foreignness pretrain): median-split the
        # targets so that the guard watches the same rank signal
        uniq = np.unique(t)
        y = (t > 0.5) if np.isin(uniq, (0.0, 1.0)).all() \
            else (t > np.median(t))
        # single-class targets make AUROC meaningless: record nan and do
        # not feed the guard
        two_class = len(np.unique(y)) > 1
        val_auc = roc_auc_score(y, s) if two_class else float("nan")
        history.setdefault("val_auc", []).append(val_auc)
        if not (two_class and guard.observe(epoch, val_auc)):
            return
        advice = ("Consider --reinit-on-collapse, a different seed, or a "
                  "lower pretrain LR." if guard.reinit_available else
                  "Consider a different seed or a lower pretrain LR "
                  "(--reinit-on-collapse acts on pretrain stages only and "
                  "would not apply here).")
        print(f"COLLAPSE GUARD: val AUROC at chance ({val_auc:.3f}) for "
              f"{guard.window} consecutive epochs at epoch {epoch + 1} — "
              f"the classifier head has flatlined. {advice}")
        if log_fn:
            log_fn({"epoch": epoch, "collapse_detected": True,
                    "val_auc": val_auc})
        if guard.raise_on_fire:
            raise PretrainCollapse(epoch, val_auc, guard.window)


# --------------------------------------------------------------------------
# the stage runner
# --------------------------------------------------------------------------

def train_model(config, model: ImmunoStructModel, train_pipe, val_pipe,
                loss_cfg: LossConfig, *, binary: bool, learning_rate: float,
                weight_decay: float = 0.0, optimizer_name: str = "adam",
                lr_schedule=None, stage: str = "pretrain",
                coeff_contrastive: float = 0.0, log_fn=None,
                verbose: bool = True, resume_tag: Optional[str] = None):
    """One stage (the reference's train_model/_comparative,
    procedures/train.py:10, :70): trains ``model`` in place with
    ``optimizer_name`` ('adam' or 'adamw') and returns (model, history).
    The comparative twin step follows the pipeline's batches
    (``ComparativeBatch``), with the contrastive term at
    ``coeff_contrastive``; ``--stack-twins`` left at auto (None) is off, as
    in the JAX package's ``resolve_stack_twins``.

    ``resume_tag`` names the stage's ``.resume`` snapshot
    (``<ckpt>.<tag>.resume``): curricula with several pretrain stages share
    one checkpoint path, and a later stage's snapshot must not resume an
    earlier one. With ``config.reinit_on_collapse`` a pretrain stage whose
    collapse guard fires restarts from fresh weights, up to twice. The JAX
    package's ``resolve_scan_layers`` has no counterpart: ``--scan-layers``
    rolls XLA's EGNN layers into one compiled loop, and PyTorch compiles
    nothing. Under ``config.data_parallel`` the stage runs on
    ``make_sharded_trainer``'s data-parallel step over every rank of the
    process group; a batch the ranks do not divide fails before the first
    step."""
    from immunostruct_tpu_torch.utils.schedule import constant_lr

    seed = config.seed
    schedule = (lr_schedule if lr_schedule is not None
                else constant_lr(learning_rate))
    optimizer = make_optimizer(optimizer_name, schedule, weight_decay,
                               steps_per_epoch=max(len(train_pipe), 1))
    accum = config.grad_accum_steps
    if accum > 1 and config.batch_size % accum != 0:
        raise ValueError(
            f"--grad-accum-steps {accum} does not divide --batch-size "
            f"{config.batch_size}; accumulation would be silently skipped on "
            "every full batch. Pick a divisible pair (e.g. batch 128, k=2).")
    kw = dict(binary=binary, optimizer=optimizer,
              coeff_contrastive=coeff_contrastive,
              aggregation=config.aggregation,
              compute_dtype=getattr(torch, config.compute_dtype),
              grad_accum_steps=accum, stack_twins=bool(config.stack_twins),
              allow_microbatch_contrastive=config.allow_microbatch_contrastive)
    if config.data_parallel:
        # the global batch's step on every rank's shard of it (the group
        # is joined by cli/common.py::to_config)
        from immunostruct_tpu_torch.parallel.trainer import (
            check_shardable, make_sharded_trainer,
        )
        trainer = make_sharded_trainer(model.spec, loss_cfg, **kw)
        check_shardable(trainer, train_pipe=train_pipe, val_pipe=val_pipe)
    else:
        trainer = Trainer(model.spec, loss_cfg, **kw)
    ckpt = (config.model_save_path_pretrain if stage == "pretrain"
            else config.model_save_path_finetune)
    suffix = f".{resume_tag}.resume" if resume_tag else ".resume"
    resume_path = ckpt + suffix if config.resume else None

    # the guard watches every stage; re-init is for pretrain stages only
    # (restarting a finetune from fresh weights would discard the trunk)
    reinit = config.reinit_on_collapse and stage == "pretrain"
    guard_on = config.collapse_detection
    max_attempts = 3 if (guard_on and reinit) else 1

    if config.data_parallel and verbose and is_primary():
        ranks = trainer.mesh.size(trainer.data_axis)
        print(f"{stage}: data-parallel over {ranks} ranks; its steps run "
              "eagerly, not as captured CUDA graphs (gloo's hops are "
              "staged through pinned host memory)")
    for attempt in range(max_attempts):
        guard = (CollapseGuard(raise_on_fire=reinit and attempt < max_attempts - 1,
                               reinit_available=(stage == "pretrain"))
                 if guard_on else None)
        attempt_seed = derived_seed(seed, attempt) if attempt else seed
        state = trainer.init_state(
            model, torch.Generator().manual_seed(attempt_seed))
        try:
            state, history = trainer.fit(
                state, train_pipe, val_pipe, config.num_epochs, attempt_seed,
                ckpt_path=ckpt, log_fn=log_fn, verbose=verbose,
                resume_path=resume_path, collapse_guard=guard)
            break
        except PretrainCollapse as e:
            if verbose:
                print(f"{e} — re-initializing (attempt {attempt + 2}/"
                      f"{max_attempts})")
            if log_fn:
                log_fn({"collapse_reinit": True, "attempt": attempt + 1})
            fresh = ImmunoStructModel(
                model.spec, loss_cfg.vae_input_dim,
                generator=torch.Generator().manual_seed(
                    derived_seed(attempt_seed, 0xC011AD5E)),
                device=next(model.parameters()).device)
            model.load_state_dict(fresh.state_dict(), strict=False)
    return state.model, history
