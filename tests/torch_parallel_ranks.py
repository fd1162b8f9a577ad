"""Rank functions of the port's multi-rank CPU tests (test_torch_port_
collectives.py, _parallel.py, _model_parallel.py), spawned through
``immunostruct_tpu_torch.parallel.dryrun.spawn``.

This module imports torch, numpy and the port, never JAX: every spawned
rank imports it, and each reports whether JAX was loaded in it. Inputs
come in as numpy arrays (or paths) from the test process; outputs go back
as numpy arrays and floats, to be held against the JAX package's there.
"""

from __future__ import annotations

import os
import sys
import types

import numpy as np
import torch

from immunostruct_tpu_torch.parallel import collectives as C
from immunostruct_tpu_torch.parallel import dryrun as D
from immunostruct_tpu_torch.parallel.mesh import Mesh, make_mesh


def _np(t):
    return t.detach().cpu().numpy()


def jax_loaded() -> bool:
    return "jax" in sys.modules or any(m.startswith("immunostruct_tpu.")
                                       for m in sys.modules)


# --------------------------------------------------------------------------
# collectives
# --------------------------------------------------------------------------

def collectives(rank: int, per_shard: dict) -> dict:
    """Every collective on this rank's row of each ``per_shard`` array, the
    native form and the one staged through host memory."""
    mesh = make_mesh("data")
    x = torch.from_numpy(per_shard["x"][rank])
    out = {"psum": _np(C.psum(x, mesh=mesh)),
           "pmean": _np(C.pmean(x, mesh=mesh)),
           "pmax": _np(C.pmax(x, mesh=mesh)),
           "jax": jax_loaded()}
    for stage in (False, True):
        tag = "staged" if stage else "native"
        out[f"all_gather_{tag}"] = _np(C.all_gather(x, mesh=mesh,
                                                     stage=stage))
        out[f"stacked_{tag}"] = _np(C.all_gather(x, mesh=mesh, tiled=False,
                                                 stage=stage))
        out[f"ppermute_{tag}"] = _np(C.ppermute_ring(x, mesh=mesh,
                                                     stage=stage))
        for key, a in per_shard.items():
            if key.startswith("ring"):
                out[f"{key}_{tag}"] = _np(C.ring_all_reduce(
                    torch.from_numpy(np.asarray(a[rank])), mesh=mesh, stage=stage))
    for key, a in per_shard.items():
        if key.startswith("ring"):
            out[f"{key}_psum"] = _np(C.psum(torch.from_numpy(np.asarray(a[rank])),
                                            mesh=mesh))
    return out


# --------------------------------------------------------------------------
# data parallel
# --------------------------------------------------------------------------

def _arrays_of(model) -> dict:
    from immunostruct_tpu_torch.utils.checkpoint import jax_params
    return {k: np.asarray(v) for k, v in jax_params(model).items()}


def dp_cases(rank: int, cases: dict) -> dict:
    """Two data-parallel steps of each named ``StepCase``, and on rank 0
    the one-process steps (``dryrun.dp_checks``)."""
    return dict(D.dp_checks(rank, cases, steps=2), jax=jax_loaded())


def accumulated(rank: int, case, k: int, **kw) -> dict:
    """The data-parallel step with ``grad_accum_steps`` k, and on rank 0
    the one-process step with k (``kw``: both trainers' further
    arguments)."""
    from immunostruct_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh("data")
    trainer, state = D.case_trainer(case, "cpu", sharded=True, mesh=mesh,
                                    grad_accum_steps=k, **kw)
    batch = D.case_batch(case, "cpu")
    state, loss = trainer.train_step(state, trainer._shard(batch), case.seed)
    out = {"loss": float(loss), "params": D.params_of(state.model)}
    if rank == 0:
        trainer, state = D.case_trainer(case, "cpu", grad_accum_steps=k,
                                        **kw)
        state, loss = trainer.train_step(state, batch, case.seed)
        out["ref"] = {"loss": float(loss),
                      "params": D.params_of(state.model)}
    return out


def _unsummed_adjoint(ctx, g):
    """The gather's adjoint without the sum over the ranks: each rank keeps
    its own loss's gradient of its rows alone."""
    return g[ctx.index * ctx.rows:(ctx.index + 1) * ctx.rows], None, None


def _scaled_last_rows(ctx, x, axis_name, mesh):
    """The gather with the last rank's rows scaled by 1.001."""
    y = _GATHER_FORWARD(ctx, x, axis_name, mesh)
    return torch.cat([y[:-ctx.rows], y[-ctx.rows:] * 1.001])


_GATHER_FORWARD = C._GatherRows.forward
# faults planted in the gather of the contrastive term's embeddings
# (collectives._GatherRows, reached through BatchShard.gather)
GATHER_FAULTS = {"unsummed_adjoint": ("backward", _unsummed_adjoint),
                 "scaled_last_rows": ("forward", _scaled_last_rows)}


def planted_faults(rank: int, case) -> dict:
    """The data-parallel step of ``case`` with each of ``GATHER_FAULTS``
    planted in turn (the gather restored after each): its gradients and
    parameters, to be held to the rule the faultless step meets."""
    out = {}
    for name, (attr, fn) in GATHER_FAULTS.items():
        kept = getattr(C._GatherRows, attr)
        setattr(C._GatherRows, attr, staticmethod(fn))
        try:
            out[name] = D.dp_step_run(case)
        finally:
            setattr(C._GatherRows, attr, staticmethod(kept))
    return out


def ring_vs_psum(rank: int, case) -> dict:
    return D.ring_vs_psum_run(case)


def non_divisible(rank: int, rows: int) -> str:
    """The error ``shard_batch`` raises on a batch of ``rows`` rows."""
    from immunostruct_tpu_torch.data.synthetic import random_sample_batch
    from immunostruct_tpu_torch.parallel.mesh import shard_batch

    batch = random_sample_batch(rows, 8, 16, 4)
    try:
        shard_batch(batch, make_mesh("data"))
    except ValueError as e:
        return str(e)
    return "no error"


def jax_weights_step(rank: int, ckpt: str, arrays: dict, eps: np.ndarray,
                     small: dict, seq_len: int, lr: float) -> dict:
    """The port's data-parallel step (f32, 'scatter') from the JAX
    package's weights at ``ckpt`` on the global batch ``arrays``, with the
    VAE noise ``eps`` that JAX's step draws: loss, gradients and
    parameters after, by JAX tree path."""
    from immunostruct_tpu_torch.models import build_model
    from immunostruct_tpu_torch.parallel.trainer import make_sharded_trainer
    from immunostruct_tpu_torch.procedures.train import make_optimizer
    from immunostruct_tpu_torch.structs import SampleBatch
    from immunostruct_tpu_torch.utils.checkpoint import (
        jax_keystr, load_jax_checkpoint,
    )
    from immunostruct_tpu_torch.utils.losses import LossConfig
    from immunostruct_tpu_torch.utils.schedule import constant_lr

    vae_dim = seq_len * 21
    _, model = build_model("HybridModelv2", vae_dim,
                           torch.Generator().manual_seed(0), **small)
    trainer = make_sharded_trainer(
        model.spec, LossConfig(vae_dim, pos_weight=1.0, sequence=True),
        binary=True, optimizer=make_optimizer("adam", constant_lr(lr)),
        aggregation="scatter")
    state = trainer.init_state(model)
    load_jax_checkpoint(ckpt, state.model, verbose=False)
    batch = SampleBatch.from_numpy(arrays, "cpu")
    state, loss = trainer.train_step(state, trainer._shard(batch), 0,
                                     eps=torch.from_numpy(eps))
    grads = {jax_keystr(n): _np(p.grad)
             for n, p in state.model.named_parameters()}
    return {"loss": float(loss), "grads": grads,
            "params": _arrays_of(state.model)}


def world2(rank: int, cases: dict, corpus, jax_step: tuple, fits: list,
           argv: list, control: dict) -> dict:
    """test_torch_port_parallel.py's checks in one group of two."""
    return {"cases": dp_cases(rank, cases),
            "accum": accumulated(rank, cases["plain"], 2),
            "accum_twin": accumulated(rank, cases["comparative"], 2,
                                      allow_microbatch_contrastive=True),
            "control": D.dp_checks(rank, control, reverse=("twin_fixed",)),
            "faults": planted_faults(rank, control["twin_fixed"]),
            "ring": ring_vs_psum(rank, cases["plain"]),
            "odd": non_divisible(rank, 3),
            "jax": jax_weights_step(rank, *jax_step),
            "fit": fit_epochs(rank, corpus, fits),
            "entry": entry_point(rank, argv)}


def _small_model(vae_dim, seed=0):
    from immunostruct_tpu_torch.models import build_model
    return build_model("HybridModelv2", vae_dim,
                       torch.Generator().manual_seed(seed),
                       gcn_layers=1, gat_hidden_channels=16,
                       vae_hidden_dim=32, vae_latent_dim=8)[1]


def _pipes(corpus, save_dir, batch_size, sharded):
    from immunostruct_tpu_torch.config import Config
    from immunostruct_tpu_torch.data.dataset import ImmunoDataset
    from immunostruct_tpu_torch.data.pipeline import BatchPipeline
    from immunostruct_tpu_torch.utils.losses import LossConfig

    cfg = Config(device="cpu", batch_size=batch_size, seed=3,
                 full_sequence=True, sequence_loss=True,
                 compute_dtype="float32", aggregation="scatter",
                 model_save_dir=save_dir, data_parallel=sharded)
    cfg.derive_paths()
    ds = ImmunoDataset.load(cfg, *corpus)
    idx = np.arange(len(ds))
    pipes = [BatchPipeline(ds, idx[:12], split="train", binary=True,
                           full=True, config=cfg),
             BatchPipeline(ds, idx[12:], split="val", binary=True,
                           full=True, config=cfg)]
    vae_dim = ds.seq_full.shape[1] * 21
    return cfg, pipes, vae_dim, LossConfig(vae_dim, 1.0, sequence=True)


def fit_epochs(rank: int, corpus, save_dirs: list) -> dict:
    """``Trainer.fit`` for two epochs with the sharded trainer (checkpoint
    and resume snapshot in ``save_dirs[0]``), recording which ranks
    write; on rank 0 also the one-process fit (``save_dirs[1]``). Then
    a collapse guard that fires at once: every rank's decision."""
    from immunostruct_tpu_torch.parallel.trainer import make_sharded_trainer
    from immunostruct_tpu_torch.procedures import train as T
    from immunostruct_tpu_torch.utils import checkpoint
    from immunostruct_tpu_torch.utils.schedule import constant_lr

    writes = []
    real_save, real_resume = checkpoint.save_checkpoint, \
        checkpoint.save_resume_state
    checkpoint.save_checkpoint = lambda *a: (writes.append("ckpt"),
                                             real_save(*a))
    checkpoint.save_resume_state = lambda *a: (writes.append("resume"),
                                               real_resume(*a))
    out = {"jax": jax_loaded()}
    try:
        for sharded, save_dir in ((True, save_dirs[0]),
                                  (False, save_dirs[1])):
            if not sharded and rank != 0:
                continue
            cfg, (tr, va), vae_dim, loss_cfg = _pipes(corpus, save_dir, 4,
                                                      sharded)
            kw = dict(binary=True, optimizer=T.make_optimizer(
                "adam", constant_lr(1e-2)), aggregation="scatter")
            trainer = (make_sharded_trainer(_small_model(vae_dim).spec,
                                            loss_cfg, **kw)
                       if sharded else T.Trainer(_small_model(vae_dim).spec,
                                                 loss_cfg, **kw))
            state = trainer.init_state(_small_model(vae_dim))
            guard = T.CollapseGuard(window=2, chance_band=0.6, min_epoch=0)
            state, hist = trainer.fit(
                state, tr, va, 2, seed=5, ckpt_path=cfg.model_save_path_pretrain,
                verbose=False, resume_path=cfg.model_save_path_pretrain
                + ".resume", collapse_guard=guard)
            tag = "dp" if sharded else "ref"
            out[tag] = {"history": hist, "params": D.params_of(state.model),
                        "writes": list(writes), "fired": guard.fired}
            writes.clear()
        # a guard that fires on the first epoch, raising: every rank stops
        # at the same epoch
        cfg, (tr, va), vae_dim, loss_cfg = _pipes(corpus, save_dirs[0], 4,
                                                  True)
        trainer = make_sharded_trainer(
            _small_model(vae_dim).spec, loss_cfg, binary=True,
            optimizer=T.make_optimizer("adam", constant_lr(1e-2)),
            aggregation="scatter")
        state = trainer.init_state(_small_model(vae_dim))
        guard = T.CollapseGuard(window=1, chance_band=0.6, min_epoch=0,
                                raise_on_fire=True)
        try:
            trainer.fit(state, tr, va, 3, seed=5, verbose=False,
                        collapse_guard=guard)
            out["collapse"] = "no collapse"
        except T.PretrainCollapse as e:
            out["collapse"] = (e.epoch, e.val_auc)
    finally:
        checkpoint.save_checkpoint, checkpoint.save_resume_state = \
            real_save, real_resume
    return out


def stand_in_wandb(fail_init: bool = False) -> types.ModuleType:
    """A module in wandb's place that records each call as (name, args,
    kwargs) in ``calls``; ``fail_init``: its ``init`` raises, as an
    offline one does."""
    mod = types.ModuleType("wandb")
    mod.calls = []

    def record(name):
        def call(*args, **kwargs):
            mod.calls.append((name, args, kwargs))
            if name == "init" and fail_init:
                raise RuntimeError("wandb.init: no network")
        return call

    mod.init, mod.log, mod.finish = (record(n)
                                     for n in ("init", "log", "finish"))
    return mod


def entry_point(rank: int, argv: list) -> dict:
    """``train_IEDB_wFT.main(argv)`` on this rank (the group is the
    spawned one), with a stand-in wandb module: the stats, the files of
    the save dir, the stand-in's calls, and on rank 0 the checkpoints'
    arrays."""
    from immunostruct_tpu_torch.cli import train_IEDB_wFT

    wandb = sys.modules["wandb"] = stand_in_wandb()
    train_stats, test_stats = train_IEDB_wFT.main(argv)
    save_dir = argv[argv.index("--model-save-dir") + 1]
    out = {"train": train_stats, "test": test_stats,
           "files": sorted(os.listdir(save_dir)), "jax": jax_loaded(),
           "wandb": wandb.calls}
    if rank == 0:
        out["ckpt"] = {f: dict(np.load(os.path.join(save_dir, f)))
                       for f in out["files"] if f.endswith(".ckpt")}
    return out


# --------------------------------------------------------------------------
# model parallel
# --------------------------------------------------------------------------

def tp_primitives(rank: int, mlp: list, x: np.ndarray, y: np.ndarray,
                  shape: tuple, axes: tuple) -> dict:
    """On a mesh of ``shape``: ``column_parallel_apply``'s shard,
    ``tp_mlp_apply``'s output and the gradients of the loss (a mean over
    the 'model' axis' replicated output on a 1-D mesh; on a (data, model)
    grid each data shard's sum of squared errors over B * out, summed
    over 'data'), the split weights' gradients summed over 'model'."""
    from immunostruct_tpu_torch.parallel.tensor import (
        column_parallel_apply, row_parallel_apply, tp_mlp_apply,
    )
    mesh = Mesh(shape, axes)
    params = [{k: torch.from_numpy(v).requires_grad_(True)
               for k, v in layer.items()} for layer in mlp]
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = torch.from_numpy(y)
    with mesh:
        h = column_parallel_apply(params[0]["w"], params[0]["b"], xt)
        pair = row_parallel_apply(params[1]["w"], params[1]["b"],
                                  torch.relu(h))
        if "data" in axes:
            n, i = mesh.size("data"), mesh.index("data")
            per = x.shape[0] // n
            rows = slice(i * per, (i + 1) * per)
            pred = tp_mlp_apply(params, xt[rows])
            loss = ((pred - yt[rows]) ** 2).sum() / (x.shape[0] * y.shape[1])
        else:
            pred = tp_mlp_apply(params, xt)
            loss = ((pred - yt) ** 2).mean()
        loss.backward()
        split = [params[0]["w"], params[0]["b"], params[1]["w"]]
        C.sum_gradients(split, "model")
        if "data" in axes:
            C.sum_gradients([p for layer in params for p in layer.values()]
                            + [xt], "data")
            loss = C.psum(loss, "data")
    return {"column": _np(h), "pair": _np(pair), "pred": _np(pred),
            "loss": float(loss), "x_grad": _np(xt.grad),
            "grads": [{k: _np(v.grad) for k, v in layer.items()}
                      for layer in params]}


def gpipe(rank: int, stacked: dict, x: np.ndarray, y: np.ndarray,
          n_micro: tuple) -> dict:
    return D.gpipe_stack_run(rank, stacked, x, y, n_micro)


def mp_steps(rank: int, cases: list) -> dict:
    """Each (label, case, shape, axes, mp kwargs, data axis) as one
    ``make_mp_train_step`` step, and on rank 0 the dense step (pinned,
    deterministic) of each case; parameters after the step."""
    out = {"jax": jax_loaded()}
    for label, case, shape, axes, mp_kw, data_axis in cases:
        run = D.mp_step_run(case, shape, axes, mp_kw, data_axis)
        out[label] = {"loss": run["loss"], "params": run["params"]}
        if rank == 0:
            out[label + "/ref"] = _dense_step(case)
    return out


def _dense_step(case) -> dict:
    from immunostruct_tpu_torch.procedures.train import step_generator

    trainer, state = D.case_trainer(case, "cpu", pinned=True)
    batch = D.case_batch(case, "cpu")
    state.optimizer.zero_grad(set_to_none=True)
    loss = trainer.loss_and_grads(state.model, batch,
                                  step_generator(case.seed, 0, "cpu"),
                                  deterministic=True)
    for group in state.optimizer.param_groups:
        group["lr"] = trainer.optimizer.lr(0)
    state.optimizer.step()
    return {"loss": float(loss), "params": D.params_of(state.model)}



def primitives4(rank: int, inputs: dict) -> dict:
    """test_torch_port_model_parallel.py's primitives in one group of
    four."""
    return {"tp1": tp_primitives(rank, inputs["mlp1"], inputs["x1"],
                                 inputs["y1"], (4,), ("model",)),
            "tp2": tp_primitives(rank, inputs["mlp2"], inputs["x2"],
                                 inputs["y2"], (2, 2), ("data", "model")),
            "gpipe": gpipe(rank, inputs["stacked"], inputs["xs"],
                           inputs["ys"], (1, 2, 4)),
            "jax": jax_loaded()}
