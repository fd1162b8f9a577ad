"""Checkpoints in the JAX package's format (counterpart of
``immunostruct_tpu/utils/checkpoint.py``), and resume snapshots.

A JAX checkpoint is a plain ``np.savez`` file keyed by parameter treepath,
``jax.tree_util.keystr`` style: ``['gcn'][0]['edge_mlp'][0]['w']``. The
port's ``state_dict`` names the same parameter ``gcn.0.edge_mlp.0.w``, so
the map is one to one and numpy alone reads the file. A training state's
contrastive projector (``['contrastive_projector']['fc1']['w']``) loads into
a model that has one attached (``Trainer.init_state``) like any other
parameter. ``save_checkpoint`` writes the same names, so the JAX
package's ``load_checkpoint`` reads a checkpoint of the port and
``load_checkpoint`` here reads one of the JAX package.

A resume snapshot (``save_resume_state``) holds what a stage needs to go
on after an interruption: the model's and the optimizer's state, the step,
the epoch and the best validation loss. It is a ``torch.save`` file of the
port's own, not the JAX package's (whose optimizer state is optax's).
"""

from __future__ import annotations

import os
import re
from typing import Mapping

import numpy as np
import torch
from torch import nn

_PART = re.compile(r"\['([^'\]]*)'\]|\[(\d+)\]")


def jax_name(keystr: str) -> str:
    """``['gcn'][0]['edge_mlp'][0]['w']`` -> ``gcn.0.edge_mlp.0.w``."""
    parts, pos = [], 0
    for m in _PART.finditer(keystr):
        if m.start() != pos:
            break
        parts.append(m.group(1) if m.group(1) is not None else m.group(2))
        pos = m.end()
    if not parts or pos != len(keystr):
        raise ValueError(f"not a JAX treepath key: {keystr!r}")
    return ".".join(parts)


def jax_keystr(name: str) -> str:
    """``gcn.0.edge_mlp.0.w`` -> ``['gcn'][0]['edge_mlp'][0]['w']``."""
    return "".join(f"[{p}]" if p.isdigit() else f"['{p}']"
                   for p in name.split("."))


def jax_params(model: nn.Module) -> dict:
    """The model's parameters as ``{JAX treepath: numpy array}`` (f32 for
    a bf16 parameter), the keys ``save_checkpoint`` gives the same tree."""
    return {jax_keystr(name): t.detach().cpu().float().numpy()
            for name, t in model.state_dict().items()}


def params_from_jax(flat: Mapping[str, np.ndarray]) -> dict:
    """Map JAX treepath names to the port's ``state_dict`` names."""
    return {jax_name(k): np.asarray(v) for k, v in flat.items()}


def load_params(model: nn.Module, params: Mapping[str, np.ndarray],
                source: str = "params", verbose: bool = True) -> nn.Module:
    """Copy ``params`` (port names -> numpy arrays) into ``model``.

    Shapes must match; values are cast to each parameter's dtype. Raises
    when no name matches, so a foreign file never leaves a model with its
    random weights. Missing and extra names are reported."""
    params = dict(params)
    state = model.state_dict()
    missing, matched = [], 0
    with torch.no_grad():
        for name, tensor in state.items():
            if name not in params:
                missing.append(name)
                continue
            value = params.pop(name)
            if tuple(value.shape) != tuple(tensor.shape):
                raise ValueError(
                    f"{source}: {name} has shape {tuple(value.shape)}, "
                    f"expected {tuple(tensor.shape)}")
            tensor.copy_(torch.from_numpy(np.array(value)).to(tensor.dtype))
            matched += 1
    if matched == 0:
        raise ValueError(
            f"{source} shares no parameter names with the model (file names "
            f"e.g. {sorted(params)[:2]}); refusing to keep random weights")
    if verbose and missing:
        print(f"checkpoint: {len(missing)} parameters not in {source} (kept "
              f"current values), e.g. {missing[0]}")
    if verbose and params:
        print(f"checkpoint: ignored {len(params)} extra entries, "
              f"e.g. {next(iter(params))}")
    return model


def _replace_into(path: str, write) -> None:
    """Write a file through ``write(file)`` into a temporary name, then
    rename it over ``path``, so a reader never sees half a file."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        write(fh)
    os.replace(tmp, path)


def save_checkpoint(path: str, model: nn.Module) -> None:
    """The model's parameters as a name-addressed npz, keyed by JAX
    treepath (f32 for a bf16 parameter), as the JAX package writes them."""
    _replace_into(path, lambda fh: np.savez(fh, **jax_params(model)))


def load_jax_checkpoint(path: str, model: nn.Module,
                        verbose: bool = True) -> nn.Module:
    """Load a checkpoint of ``save_checkpoint`` (this package's or the JAX
    package's npz) into ``model`` in place and return it."""
    try:
        with np.load(path, allow_pickle=False) as z:
            flat = {k: z[k] for k in z.files}
    except (OSError, ValueError) as e:
        raise ValueError(f"{path} is not a name-addressed npz checkpoint "
                         f"({e})") from e
    return load_params(model, params_from_jax(flat), source=path,
                       verbose=verbose)


load_checkpoint = load_jax_checkpoint


def save_resume_state(path: str, state, epoch: int, best_val: float) -> None:
    """Snapshot a ``TrainState`` (model, optimizer, step) with the epoch
    just finished and the best validation loss so far."""
    snapshot = {"model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "step": state.step, "epoch": epoch, "best_val": best_val}
    _replace_into(path, lambda fh: torch.save(snapshot, fh))


def load_resume_state(path: str, state):
    """Restore a snapshot into ``state`` in place; returns (state, next
    epoch, best_val), or None when there is no snapshot."""
    if not os.path.exists(path):
        return None
    snap = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(snap["model"])
    # the rate is set before every step; keep the optimizer's own (a device
    # tensor on the card, which a captured step reads)
    rates = [group["lr"] for group in state.optimizer.param_groups]
    state.optimizer.load_state_dict(snap["optimizer"])
    for group, lr in zip(state.optimizer.param_groups, rates):
        group["lr"] = lr
    state.step = int(snap["step"])
    return state, int(snap["epoch"]) + 1, float(snap["best_val"])
