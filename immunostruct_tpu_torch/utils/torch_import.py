"""Import the reference's PyTorch checkpoints (counterpart of
``immunostruct_tpu/utils/torch_import.py``).

The reference saves ``model.state_dict()`` (procedures/train.py:48-55).
Its key layout comes from the reference model definitions:

  vae_fc1/fc21/fc22/fc3/fc4            hybrid_models.py:37-41
  property_embedding.{0,3}             hybrid_models.py:46-52 (Sequential)
  classifier.{1,4} (plain)             hybrid_models.py:54-61 (Flatten at 0)
  classifier.1 + classifier_head +
  node_predictor_head (SSL)            hybrid_models.py:157-160
  self_attention.{query,key,value}     layers.py:6-11 (SelfAttention)
  self_attention.w_{q,k,v,concat}      layers.py:51-64 (MultiHeadAttention)
  combined_attention.w_*               hybrid_models.py:275 (v2)
  GCN_layers.{i}.{edge,node,coord}_mlp.{0,2}   DGL EGNNConv submodules

A torch ``Linear`` stores its weight [out, in]; the port's ``Linear`` (the
JAX package's layout) holds w [in, out], so weights are transposed on the
way in. ``import_torch_state_dict`` returns the port's ``state_dict``
names (the JAX package's treepaths, ``gcn.0.edge_mlp.0.w``) with f32 numpy
arrays, which ``utils/checkpoint.py::load_params`` copies into a model.
It takes a torch state_dict or any mapping of numpy arrays under the same
keys.
"""

from __future__ import annotations

import zipfile
from typing import Mapping

import numpy as np
import torch

from immunostruct_tpu_torch.models.trunk import ImmunoStructModel, ModelSpec
from immunostruct_tpu_torch.utils.checkpoint import (
    load_jax_checkpoint, load_params,
)


def _to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _linear(sd: Mapping, prefix: str, name: str, out: dict,
            bias: bool = True) -> None:
    out[f"{name}.w"] = _to_np(sd[f"{prefix}.weight"]).T
    if bias:
        out[f"{name}.b"] = _to_np(sd[f"{prefix}.bias"])


def _mha(sd: Mapping, prefix: str, name: str, out: dict) -> None:
    for part in ("w_q", "w_k", "w_v", "w_concat"):
        _linear(sd, f"{prefix}.{part}", f"{name}.{part}", out)


def import_torch_state_dict(sd: Mapping, spec: ModelSpec) -> dict:
    """The reference's state_dict -> {port ``state_dict`` name: f32 numpy
    array} for a model of ``spec``."""
    out: dict = {}
    if spec.use_structure:
        i = 0
        while f"GCN_layers.{i}.edge_mlp.0.weight" in sd:
            p, q = f"GCN_layers.{i}", f"gcn.{i}"
            _linear(sd, f"{p}.edge_mlp.0", f"{q}.edge_mlp.0", out)
            _linear(sd, f"{p}.edge_mlp.2", f"{q}.edge_mlp.1", out)
            _linear(sd, f"{p}.node_mlp.0", f"{q}.node_mlp.0", out)
            _linear(sd, f"{p}.node_mlp.2", f"{q}.node_mlp.1", out)
            _linear(sd, f"{p}.coord_mlp.0", f"{q}.coord_mlp.0", out)
            _linear(sd, f"{p}.coord_mlp.2", f"{q}.coord_mlp.1", out,
                    bias=False)
            i += 1
        if i == 0:
            raise KeyError("no GCN_layers.* keys found in state_dict")
        if spec.node_attention == "self":
            for part in ("query", "key", "value"):
                _linear(sd, f"self_attention.{part}", f"node_attn.{part}",
                        out)
        else:
            _mha(sd, "self_attention", "node_attn", out)
    if spec.use_sequence:
        for part in ("fc1", "fc21", "fc22", "fc3", "fc4"):
            _linear(sd, f"vae_{part}", f"vae.{part}", out)
    if spec.use_property and spec.use_sequence:
        _linear(sd, "property_embedding.0", "property_embedding.0", out)
        _linear(sd, "property_embedding.3", "property_embedding.1", out)
    if spec.combined_attention_dim > 0:
        _mha(sd, "combined_attention", "combined_attention", out)
    _linear(sd, "classifier.1", "classifier.trunk", out)
    if spec.ssl:
        _linear(sd, "classifier_head", "classifier.classifier_head", out)
        _linear(sd, "node_predictor_head", "classifier.node_predictor_head",
                out)
    else:
        _linear(sd, "classifier.4", "classifier.out", out)
    return out


def import_torch_checkpoint(path: str, spec: ModelSpec) -> dict:
    """A reference ``.pt`` checkpoint file, read with
    ``torch.load(weights_only=True)``, as ``import_torch_state_dict``
    maps it."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return import_torch_state_dict(sd, spec)


def is_torch_checkpoint(path: str) -> bool:
    """Whether ``path`` is a torch ``state_dict`` file rather than an npz
    checkpoint, by content: both are zip files, but torch's zip format
    holds a ``data.pkl`` member where an npz holds ``*.npy`` members; a
    legacy torch file is a bare pickle (protocol byte ``\\x80``)."""
    try:
        with zipfile.ZipFile(path) as zf:
            return any(n.endswith("data.pkl") for n in zf.namelist())
    except zipfile.BadZipFile:
        with open(path, "rb") as f:
            return f.read(1) == b"\x80"


def require_exact_reference_padding(config) -> None:
    """Pad graphs to the exact corpus maximum for a reference checkpoint,
    in place on ``config``; call it before the dataset is built.

    The reference pads to the exact corpus max node count
    (immunostruct/data/preprocess.py:343-349), its ``global_mean_pool``
    divides by that padded count and its node-attention softmax spans
    every padded row (hybrid_models.py:97, :326-327), so its logits hold
    only at that N, not at N rounded up by ``pad_nodes_multiple``."""
    if config.pad_nodes_multiple != 1:
        print(f"reference checkpoint: overriding pad_nodes_multiple="
              f"{config.pad_nodes_multiple} -> 1 (exact corpus max) so "
              "mean-pool/attention numerics match the reference geometry")
        config.pad_nodes_multiple = 1


def load_any_checkpoint(path: str, model: ImmunoStructModel,
                        verbose: bool = True) -> ImmunoStructModel:
    """Load a checkpoint into ``model`` in place, whichever kind ``path``
    holds (``is_torch_checkpoint``): a reference torch state_dict, or an
    npz of this package or the JAX package."""
    if is_torch_checkpoint(path):
        if verbose:
            print(f"loading reference torch state_dict: {path}")
        return load_params(model, import_torch_checkpoint(path, model.spec),
                           source=path, verbose=verbose)
    return load_jax_checkpoint(path, model, verbose=verbose)
