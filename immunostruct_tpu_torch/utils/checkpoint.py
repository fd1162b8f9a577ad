"""Load the JAX package's checkpoints (counterpart of the restore side of
``immunostruct_tpu/utils/checkpoint.py``).

A JAX checkpoint is a plain ``np.savez`` file keyed by parameter treepath,
``jax.tree_util.keystr`` style: ``['gcn'][0]['edge_mlp'][0]['w']``. The
port's ``state_dict`` names the same parameter ``gcn.0.edge_mlp.0.w``, so
the map is one to one and numpy alone reads the file.
"""

from __future__ import annotations

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


def load_jax_checkpoint(path: str, model: nn.Module,
                        verbose: bool = True) -> nn.Module:
    """Load a JAX package checkpoint (``save_checkpoint`` npz) into
    ``model`` in place and return it."""
    try:
        with np.load(path, allow_pickle=False) as z:
            flat = {k: z[k] for k in z.files}
    except (OSError, ValueError) as e:
        raise ValueError(f"{path} is not a name-addressed npz checkpoint "
                         f"({e})") from e
    return load_params(model, params_from_jax(flat), source=path,
                       verbose=verbose)
