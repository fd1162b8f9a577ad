"""The multi-rank dry run (counterpart of ``__graft_entry__.py``'s
``dryrun_multichip``) and the spawned-rank checks it is built from.

``spawn(fn, n, ...)`` runs ``fn(rank, ...)`` in n fresh processes joined in
one group (a file store in a temporary directory, so concurrent groups do
not collide on a port; gloo on the CPU or when the ranks share a card,
NCCL when each has its own) and returns each rank's result. A rank that
raises fails the call. The ranks import this package and torch, no JAX.
Kernels are built in the parent before ranks are spawned (``ops/_build``),
so that no two ranks build into ``_build/`` at once.

``dryrun_multichip(n, device=)``:
- one comparative data-parallel step (contrastive 0.1, noise on) over n
  ranks, against the one-process step on the global batch: loss within
  rel 2e-5;
- for even n >= 4: TP x DP on a (2 data, n/2 model) grid and GPipe over n
  stages, each with the VAE noise pinned (fc22: w 0, b -80) and dropout
  off, against the dense step: loss within rtol 2e-5, gradients within
  rtol 2e-4 and atol 2e-4 * max|g| (JAX's bounds). With fewer stages than
  the flagship's five hidden convs, GPipe runs a model with one hidden
  conv a stage.

The JAX dry run's ``entry()``, a jit compile check, has no counterpart in
eager PyTorch.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from immunostruct_tpu_torch.parallel.mesh import (
    Mesh, initialize_distributed, shutdown_distributed,
)


def _rank_main(rank, fn, n, tmp, device, timeout_s, tf32, args):
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = \
        tf32
    global _RANK_DEVICE
    _RANK_DEVICE = initialize_distributed(
        f"file://{tmp}/store", n, rank, device=device, local_ranks=n,
        timeout_s=timeout_s, verbose=rank == 0)
    try:
        out = fn(rank, *args)
        torch.save(out, os.path.join(tmp, f"{rank}.pt"))
    finally:
        shutdown_distributed()


def spawn(fn, n: int, *args, device="cpu", timeout_s: float = 600.0
          ) -> list:
    """``fn(rank, *args)`` on ranks 0..n-1, each a fresh process on
    ``device`` (CUDA ranks share ``cuda:(rank % device_count)``); returns
    their results in rank order (``fn`` must be a module-level function
    and its results picklable). The ranks take the caller's TF32
    settings."""
    import torch.multiprocessing as mp

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    with tempfile.TemporaryDirectory(prefix="ranks_") as tmp:
        mp.start_processes(_rank_main,
                           args=(fn, n, tmp, str(device), timeout_s, tf32,
                                 args),
                           nprocs=n, join=True, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"{r}.pt"), weights_only=False)
                for r in range(n)]


# --------------------------------------------------------------------------
# the runs a rank makes
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StepCase:
    """One training step's configuration: model, batch shape (B is the
    global batch), dtype, aggregation, contrastive coefficient, the
    model's overrides (``build_model``) and ``pinned``, the VAE noise
    fixed (``case_trainer``)."""

    name: str = "HybridModelv2_Comparative"
    b: int = 8
    nodes: int = 16
    edges: int = 64
    seq_len: int = 32
    dtype: str = "float32"
    aggregation: str = "scatter"
    coeff: float = 0.0
    ssl: bool = False
    overrides: tuple = ()
    seed: int = 0
    pinned: bool = False


def case_batch(case: StepCase, device):
    """The case's seeded global batch; targets alternate 0/1, so that the
    contrastive gate is open; SSL batches carry one masked residue a row
    (-1: none) in ``aux_residue``."""
    from immunostruct_tpu_torch.data.synthetic import (
        random_comparative_batch, random_sample_batch,
    )
    target = torch.tensor(np.arange(case.b) % 2, dtype=torch.float32,
                          device=device)
    comparative = "Comparative" in case.name
    if comparative:
        batch = random_comparative_batch(case.b, case.nodes, case.edges,
                                         case.seq_len, case.seed, device)
        items = (batch.cancer, batch.wt)
    else:
        batch = random_sample_batch(case.b, case.nodes, case.edges,
                                    case.seq_len, case.seed, device)
        items = (batch,)
    rng = np.random.default_rng(case.seed + 7)
    for item in items:
        item.target = target
        if case.ssl:
            residue = rng.integers(-1, 20, case.b).astype(np.int32)
            item.aux_residue = torch.from_numpy(residue).to(device)
    return batch


def reversed_rows(batch):
    """``batch`` with its rows (every tensor's leading axis: both twins and
    the target) in reverse order."""
    from immunostruct_tpu_torch.structs import first_tensor, map_tensors

    rows = torch.arange(first_tensor(batch).shape[0] - 1, -1, -1)
    return map_tensors(lambda t: t[rows.to(t.device)], batch)


def case_trainer(case: StepCase, device, pinned: bool = False, **kw):
    """(trainer, state) from the case's seeded weights: Adam at 1e-3, the
    bench's loss configuration; ``pinned`` (or the case's) fixes the VAE
    noise (fc22: w 0, b -80, so that z = mu). ``kw``: ``Trainer``'s
    (``mesh``, ``mp``, ``shard_batch``, ``grad_accum_steps``, ...), or
    ``make_sharded_trainer`` when ``kw`` holds ``sharded=True``."""
    from immunostruct_tpu_torch.models import build_model
    from immunostruct_tpu_torch.procedures.train import (
        Trainer, make_optimizer,
    )
    from immunostruct_tpu_torch.utils.losses import LossConfig
    from immunostruct_tpu_torch.utils.schedule import constant_lr

    vae_dim = case.seq_len * 21
    _, model = build_model(case.name, vae_dim,
                           torch.Generator().manual_seed(case.seed + 3),
                           device=device, **dict(case.overrides))
    if pinned or case.pinned:
        with torch.no_grad():
            model.vae.fc22.w.zero_()
            model.vae.fc22.b.fill_(-80.0)
    args = (model.spec, LossConfig(vae_dim, pos_weight=1.0, sequence=True,
                                   ssl=case.ssl))
    kw = dict(binary=True, optimizer=make_optimizer("adam", constant_lr(1e-3)),
              coeff_contrastive=case.coeff, aggregation=case.aggregation,
              compute_dtype=getattr(torch, case.dtype), **kw)
    if kw.pop("sharded", False):
        from immunostruct_tpu_torch.parallel.trainer import (
            make_sharded_trainer,
        )
        trainer = make_sharded_trainer(*args, **kw)
    else:
        trainer = Trainer(*args, **kw)
    return trainer, trainer.init_state(
        model, torch.Generator().manual_seed(case.seed + 4))


_RANK_DEVICE = torch.device("cpu")


def _device() -> torch.device:
    """This rank's device (``spawn``'s ``device``)."""
    return _RANK_DEVICE


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _counts():
    from immunostruct_tpu_torch.cli.race_kernel_variants import counters
    return {k: fn.launches for k, fn in counters().items()}


def _reset_counts():
    from immunostruct_tpu_torch.cli.race_kernel_variants import counters
    for fn in counters().values():
        fn.launches = 0


def params_of(model) -> dict:
    return {n: p.detach().double().cpu() for n, p in model.named_parameters()}


def grads_of(model) -> dict:
    return {n: p.grad.detach().double().cpu()
            for n, p in model.named_parameters() if p.grad is not None}


# the attention key biases: a softmax does not change when one number is
# added to every key, so their true gradient is zero and a step reads
# rounding noise there, which Adam turns into a move of up to lr a step
KEY_BIASES = ("key.b", "w_k.b")


def excess_by_param(got: dict, want: dict, rtol: float, atol: float
                    ) -> dict:
    """{name: max over its entries of |got - want| / (atol + rtol
    |want|)}: <= 1 is within the bound (``np.testing.assert_allclose``'s)."""
    assert got.keys() == want.keys(), set(got) ^ set(want)
    return {k: float(((got[k] - want[k]).abs()
                      / (atol + rtol * want[k].abs())).max()) for k in want}


def worst_excess(got: dict, want: dict, rtol: float, atol: float) -> float:
    return max(excess_by_param(got, want, rtol, atol).values())


def worst_grad_excess(got: dict, want: dict, rtol: float = 2e-4,
                      scale: float = 2e-4) -> float:
    """``worst_excess`` per parameter with atol = scale * max|want|: the
    dry run's gradient bound."""
    return max(worst_excess({k: got[k]}, {k: want[k]}, rtol,
                            scale * max(1e-6, float(want[k].abs().max())))
               for k in want)


# The twin step's rounding noise, as a share of the step's largest gradient
# (test_torch_port_train.py's absolute gradient term). The step is
# ill-conditioned in the order of its sums: the projector's batch norm
# centres embeddings that barely vary over the batch, and some gradients
# (the attention biases, the last node MLP's, entries of the projector's
# fc1.w) sum to nearly nothing, so the one-process step on its rows
# reversed parts from itself there by hundreds of JAX's bounds.
TWIN_NOISE = 1e-5


def twin_excess(got: dict, ref: dict, noise: float = TWIN_NOISE,
                rtol: float = 2e-5, atol: float = 2e-6,
                grad_rtol: float = 2e-4, grad_scale: float = 2e-4) -> dict:
    """One step of the twin (``got``: grads and params) against the
    one-process step ``ref``, with ``nu = noise * G``, G the largest |g| of
    ``ref``'s step:

    - gradients: |dg| <= grad_rtol |g| + grad_scale max|g| (the tensor's:
      the model-parallel checks' rule) + nu, every entry;
    - parameters after one Adam step: JAX's bound (rtol, atol) on every
      entry but those whose reference gradient is nonzero and below nu.
      Adam's first step moves an entry by lr g / (|g| + eps), a direction
      that is rounding noise where g is; those entries are dropped and
      counted.

    Returns the worst excess of each (<= 1: within the rule), the
    parameter it sits in, the entries dropped and the entries in all."""
    nu = noise * max(float(g.abs().max()) for g in ref["grads"].values())
    out = dict(grads=0.0, grads_at=None, params=0.0, params_at=None,
               dropped=0, entries=0, nu=nu)
    for k, g in ref["grads"].items():
        bound = grad_rtol * g.abs() + grad_scale * float(g.abs().max()) + nu
        excess = float(((got["grads"][k] - g).abs() / bound).max())
        if excess > out["grads"]:
            out.update(grads=excess, grads_at=k)
        w = ref["params"][k]
        kept = (g == 0) | (g.abs() >= nu)
        excess = ((got["params"][k] - w).abs() / (atol + rtol * w.abs()))
        excess = float(excess[kept].max()) if bool(kept.any()) else 0.0
        if excess > out["params"]:
            out.update(params=excess, params_at=k)
        out["dropped"] += int(kept.numel() - kept.sum())
        out["entries"] += kept.numel()
    return out


def one_process_step(case: StepCase, device, steps: int = 1,
                     reverse: bool = False) -> dict:
    """The plain step(s) on the global batch (``reverse``: its rows
    reversed): loss(es), parameters after, first-step gradients and
    launches."""
    trainer, state = case_trainer(case, device)
    batch = case_batch(case, device)
    if reverse:
        batch = reversed_rows(batch)
    _reset_counts()
    losses = []
    for _ in range(steps):
        state, loss = trainer.train_step(state, batch, seed=case.seed)
        losses.append(float(loss))
        if len(losses) == 1:
            grads = grads_of(state.model)
    _sync(device)
    return dict(losses=losses, params=params_of(state.model), grads=grads,
                launches=_counts())


def dp_step_run(case: StepCase, steps: int = 1, timed: int = 0,
                reduce_timed: int = 0) -> dict:
    """On every rank of the world: the data-parallel step(s) of ``case``
    (``make_sharded_trainer`` over a 1-D data mesh): losses, parameters
    after, first-step gradients, launches of the first step; then
    ``timed`` more steps (ms each) and ``reduce_timed`` all-reduces of a
    flat f32 buffer of the model's size (ms each)."""
    from immunostruct_tpu_torch.parallel.collectives import psum
    from immunostruct_tpu_torch.parallel.mesh import make_mesh

    device = _device()
    mesh = make_mesh("data")
    trainer, state = case_trainer(case, device, sharded=True, mesh=mesh)
    batch = case_batch(case, device)
    shard = trainer._shard(batch)
    losses, launches, step_ms = [], None, []
    for i in range(steps + timed):
        _reset_counts()
        _sync(device)
        t0 = time.perf_counter()
        state, loss = trainer.train_step(state, shard, seed=case.seed)
        _sync(device)
        ms = (time.perf_counter() - t0) * 1e3
        if i == 0:
            launches, grads = _counts(), grads_of(state.model)
        if i < steps:
            losses.append(float(loss))
            params = params_of(state.model)
        else:
            step_ms.append(ms)
    size = sum(p.numel() for p in state.model.parameters())
    flat = torch.ones(size, device=device)
    reduce_ms = []
    for _ in range(reduce_timed):
        _sync(device)
        t0 = time.perf_counter()
        psum(flat, "data", mesh)
        _sync(device)
        reduce_ms.append((time.perf_counter() - t0) * 1e3)
    return dict(losses=losses, params=params, grads=grads,
                launches=launches, rows=int(torch.numel(
                    shard.cancer.target if hasattr(shard, "cancer")
                    else shard.target)),
                step_ms=step_ms, reduce_ms=reduce_ms,
                parameters=size, jax_loaded="jax" in sys.modules,
                backend=torch.distributed.get_backend())


def ring_vs_psum_run(case: StepCase) -> dict:
    """``shard_map_train_step`` with reduce='psum' and 'ring' from the same
    weights and shard: their losses and parameters."""
    from immunostruct_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from immunostruct_tpu_torch.parallel.trainer import shard_map_train_step

    device = _device()
    mesh = make_mesh("data")
    out = {}
    for reduce in ("psum", "ring"):
        trainer, state = case_trainer(case, device, mesh=mesh)
        shard = shard_batch(case_batch(case, device), mesh)
        state, loss = shard_map_train_step(trainer, mesh, reduce=reduce)(
            state, shard, case.seed)
        out[reduce] = dict(loss=float(loss), params=params_of(state.model))
    return out


def dense_grads(case: StepCase, device) -> dict:
    """The dense step's deterministic loss and gradients with the VAE noise
    pinned (the model-parallel checks' reference)."""
    from immunostruct_tpu_torch.procedures.train import step_generator

    trainer, state = case_trainer(case, device, pinned=True)
    batch = case_batch(case, device)
    _reset_counts()
    loss = trainer.loss_and_grads(state.model, batch,
                                  step_generator(case.seed, 0, device),
                                  deterministic=True)
    _sync(device)
    return dict(loss=float(loss), grads=grads_of(state.model),
                launches=_counts())


def mp_step_run(case: StepCase, shape: tuple, axes: tuple, mp_kw: dict,
                data_axis: Optional[str] = None, timed: int = 0) -> dict:
    """On every rank: one ``make_mp_train_step`` step of ``case`` (pinned,
    deterministic) on a mesh of ``shape``/``axes`` with
    ``MPConfig(**mp_kw)``: its loss, reassembled gradients, parameters
    after and launches; then ``timed`` more steps (ms each)."""
    from immunostruct_tpu_torch.parallel.mp import MPConfig
    from immunostruct_tpu_torch.parallel.trainer import make_mp_train_step

    device = _device()
    mesh = Mesh(shape, axes)
    trainer, state = case_trainer(case, device, pinned=True,
                                  mp=MPConfig(**mp_kw))
    batch = case_batch(case, device)
    step = make_mp_train_step(trainer, mesh, data_axis=data_axis,
                              deterministic=True)
    _reset_counts()
    state, loss = step(state, batch, case.seed)
    out = dict(loss=float(loss), grads=grads_of(state.model),
               params=params_of(state.model), launches=_counts(),
               coords={a: mesh.index(a) for a in axes}, step_ms=[])
    for _ in range(timed):
        _sync(device)
        t0 = time.perf_counter()
        step(state, batch, case.seed)
        _sync(device)
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
    return out


def dp_checks(rank: int, cases: dict, ring_case: Optional[StepCase] = None,
              timed: int = 0, reduce_timed: int = 0, steps: int = 1,
              reverse: tuple = ()) -> dict:
    """On every rank: ``steps`` of ``dp_step_run`` of each named case (with
    ``timed`` steps and ``reduce_timed`` reductions timed for the first),
    and on rank 0 the one-process steps of each, and for the cases named
    in ``reverse`` also on the batch with its rows reversed
    (``name/reversed``); then ``ring_vs_psum_run`` of ``ring_case``."""
    out, first = {"jax_loaded": "jax" in sys.modules}, True
    for name, case in cases.items():
        out[name] = dp_step_run(case, steps, timed if first else 0,
                                reduce_timed if first else 0)
        first = False
        if rank == 0:
            out[name + "/ref"] = one_process_step(case, _device(), steps)
            if name in reverse:
                out[name + "/reversed"] = one_process_step(
                    case, _device(), steps, reverse=True)
    if ring_case is not None:
        out["ring"] = ring_vs_psum_run(ring_case)
    return out


def mp_checks(rank: int, runs: list, timed: int = 0) -> dict:
    """On every rank: ``mp_step_run`` of each (label, case, shape, axes, MP
    kwargs, data axis), and on rank 0 the dense reference of each case."""
    out, refs = {}, {}
    for label, case, shape, axes, mp_kw, data_axis in runs:
        out[label] = mp_step_run(case, shape, axes, mp_kw, data_axis, timed)
        if rank == 0:
            if case not in refs:
                refs[case] = dense_grads(case, _device())
            out[label + "/ref"] = refs[case]
    return out


def gpipe_stack_run(rank: int, stacked: dict, x, y, n_micro: tuple
                    ) -> dict:
    """``gpipe_apply`` of a tanh(linear) stack ({"w": [S, d, d], "b": [S,
    d]} numpy) over the world's ranks, one stage each, for each
    microbatch count, and the gradients of mean((out - y)^2) with 2
    microbatches (the stack's summed over 'pipe'), as numpy."""
    from immunostruct_tpu_torch.parallel.collectives import sum_gradients
    from immunostruct_tpu_torch.parallel.mesh import make_mesh
    from immunostruct_tpu_torch.parallel.pipeline import gpipe_apply

    def layer(p, a):
        return torch.tanh(torch.matmul(a.float(), p["w"].float())
                          + p["b"].float())

    device = _device()
    params = {k: torch.from_numpy(v).to(device).requires_grad_(True)
              for k, v in stacked.items()}
    xt = torch.from_numpy(x).to(device)
    out = {}
    with make_mesh("pipe") as mesh:
        with torch.no_grad():
            for m in n_micro:
                out[f"out{m}"] = gpipe_apply(layer, params, xt,
                                             m).cpu().numpy()
        xg = xt.clone().requires_grad_(True)
        pred = gpipe_apply(layer, params, xg, 2)
        loss = ((pred - torch.from_numpy(y).to(device)) ** 2).mean()
        loss.backward()
        sum_gradients(list(params.values()), "pipe", mesh)
    out.update(loss=float(loss), x_grad=xg.grad.cpu().numpy(),
               grads={k: v.grad.cpu().numpy() for k, v in params.items()})
    return out


# --------------------------------------------------------------------------
# the dry run
# --------------------------------------------------------------------------

def _dryrun_rank(rank: int, n: int, case: StepCase) -> dict:
    out = dp_checks(rank, {"dp": dataclasses.replace(case, coeff=0.1)})
    if n >= 4 and n % 2 == 0:
        dense = dataclasses.replace(case, coeff=0.0)
        pipe = dataclasses.replace(
            dense, overrides=(("gcn_layers", min(5, n)),))
        out.update(mp_checks(rank, [
            ("tp", dense, (2, n // 2), ("data", "model"),
             dict(tp_axis="model"), "data"),
            ("pp", pipe, (n,), ("pipe",),
             dict(pp_axis="pipe", pp_microbatches=2), None)]))
    return out


def dryrun_multichip(n: int, device="cpu", case: Optional[StepCase] = None
                     ) -> dict:
    """The dry run over n spawned ranks (see the module docstring); raises
    when a check fails, prints one line a check and returns the
    readings."""
    case = case or StepCase(b=2 * n, nodes=16, edges=64, seq_len=32,
                            aggregation="scatter"
                            if torch.device(device).type == "cpu"
                            else "mega")
    ranks = spawn(_dryrun_rank, n, n, case, device=device)
    r0 = ranks[0]
    loss, ref = r0["dp"]["losses"][0], r0["dp/ref"]["losses"][0]
    rel = abs(loss - ref) / max(abs(ref), 1e-12)
    assert rel < 2e-5, f"sharded loss {loss} != one-process {ref} ({rel:.2e})"
    readings = {"dp_rel": rel}
    print(f"dryrun_multichip({n}): one comparative DP step over {n} ranks "
          f"OK, loss={loss:.6f}, one process {ref:.6f} (rel {rel:.1e})")
    for key, label in (("tp", f"TP x DP over (2, {n // 2})"),
                       ("pp", f"GPipe over {n} stages")):
        if key not in r0:
            continue
        want = r0[f"{key}/ref"]
        rel = abs(r0[key]["loss"] - want["loss"]) / abs(want["loss"])
        assert rel < 2e-5, f"{label}: loss rel {rel:.2e}"
        worst = max(worst_grad_excess(r[key]["grads"], want["grads"])
                    for r in ranks)
        assert worst <= 1.0, f"{label}: gradients {worst:.3f} of the bound"
        readings[key] = dict(rel=rel, worst_grad=worst)
        print(f"dryrun_multichip({n}): {label} OK, loss rel {rel:.1e}, "
              f"gradients within {worst:.3f} of the bound on every rank")
    return readings
