"""Analytic FLOP model of the training step, and MFU accounting
(counterpart of ``immunostruct_tpu/utils/flops.py``).

Counts the model's mathematical FLOPs, what the architecture requires
(reference forward: immunostruct/models/hybrid_models.py:315-359),
whatever the implementation does: the EGNN message aggregation is counted
as a segment sum (E*C adds), not as the one-hot [B,N,E] matrix product of
the 'onehot' path. ``executed_flops`` counts what PyTorch's ATen ops do
(``torch.utils.flop_counter.FlopCounterMode``), so the two separate "how
fast is the model" (MFU) from "how much work did this path choose".

Conventions: a Linear of in->out costs 2*in*out FLOPs a position (a
multiply and an add); the backward counts 2x the forward; the optimizer's
update ~10 FLOPs a parameter (Adam).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from immunostruct_tpu_torch.models.trunk import ModelSpec


def _linear(positions: int, d_in: int, d_out: int) -> float:
    return 2.0 * positions * d_in * d_out


def egnn_layer_flops(n: int, e: int, f_in: int, h: int,
                     edge_feat: int = 1) -> float:
    """One EGNN layer (ops/egnn.py's math; DGL EGNNConv semantics)."""
    fl = 0.0
    # radial + x_hat: x_diff (3), square+sum (6), sqrt+div (~8)
    fl += e * 17.0
    fl += _linear(e, 2 * f_in + 1 + edge_feat, h) + _linear(e, h, h)  # edge MLP
    fl += e * 2 * h                                  # 2x SiLU
    fl += _linear(e, h, h) + _linear(e, h, 1)        # coord MLP
    fl += e * h                                      # SiLU
    fl += e * 3.0                                    # msg_x = cw * x_hat
    fl += e * (h + 3.0)                              # segment-sum aggregation
    fl += _linear(n, f_in + h, h) + _linear(n, h, h)  # node MLP
    fl += n * h                                      # SiLU
    fl += n * 3.0                                    # coord update add
    return fl


def attention_flops(length: int, d_model: int,
                    d_in: Optional[int] = None) -> float:
    """Q/K/V/out projections + scores + weighted sum (any head count: the
    FLOPs do not depend on it at a fixed d_model)."""
    d_in = d_in if d_in is not None else d_model
    fl = 3 * _linear(length, d_in, d_model) + _linear(length, d_model, d_model)
    fl += 2.0 * length * length * d_model            # QK^T
    fl += 5.0 * length * length                      # softmax
    fl += 2.0 * length * length * d_model            # weights @ V
    return fl


def forward_flops_per_sample(spec: ModelSpec, n_nodes: int, n_edges: int,
                             vae_input_dim: int) -> float:
    """Model FLOPs of ONE branch's forward for one sample."""
    fl = 0.0
    h = spec.gat_hidden_channels
    if spec.use_structure:
        fl += egnn_layer_flops(n_nodes, n_edges, 20, h)
        fl += spec.gcn_layers * egnn_layer_flops(n_nodes, n_edges, h, h)
        fl += attention_flops(n_nodes, h)
        fl += n_nodes * h * (2 if spec.mean_max_pool else 1)   # pool
    if spec.use_sequence:
        d = vae_input_dim
        fl += _linear(1, d, spec.vae_hidden_dim)
        fl += 2 * _linear(1, spec.vae_hidden_dim, spec.vae_latent_dim)
        fl += 6.0 * spec.vae_latent_dim               # reparameterize
        dec_in = spec.vae_latent_dim
        if spec.use_property:
            dec_in += spec.property_embedding_dim
        if spec.raw_property_concat:
            dec_in += 2
        fl += _linear(1, dec_in, spec.vae_hidden_dim)
        fl += _linear(1, spec.vae_hidden_dim, d)
        if spec.use_property:
            fl += _linear(1, 2, 32) + _linear(1, 32, spec.property_embedding_dim)
    if spec.combined_attention_dim > 0:
        # MHA over the fused vector as a length-D sequence of scalars
        fl += attention_flops(spec.embedding_dim, spec.combined_attention_dim,
                              d_in=1)
    fl += _linear(1, spec.classifier_input_dim, spec.mlp_features)
    if spec.ssl:
        fl += _linear(1, spec.mlp_features, 1) + _linear(1, spec.mlp_features, 20)
    else:
        fl += _linear(1, spec.mlp_features, 1)
    return fl


def loss_flops_per_sample(spec: ModelSpec, vae_input_dim: int) -> float:
    fl = 20.0                                         # BCE/MSE on the logit
    if spec.use_sequence:
        fl += 3.0 * vae_input_dim                     # recon MSE
        fl += 8.0 * spec.vae_latent_dim               # KLD
    return fl


def param_count(model: torch.nn.Module) -> int:
    """The number of the model's parameters (every element)."""
    return int(sum(p.numel() for p in model.parameters()))


def train_step_flops(spec: ModelSpec, batch_size: int, n_nodes: int,
                     n_edges: int, vae_input_dim: int,
                     n_params: int = 0) -> float:
    """Model FLOPs of one train step (forward + backward ~= 3x forward,
    plus Adam)."""
    branches = 2 if spec.comparative else 1
    per_sample = branches * (
        forward_flops_per_sample(spec, n_nodes, n_edges, vae_input_dim)
        + loss_flops_per_sample(spec, vae_input_dim))
    return 3.0 * batch_size * per_sample + 10.0 * n_params


# -- the card's peaks ----------------------------------------------------------

# dense peak rates, FLOP/s, from NVIDIA's H100 data sheet (without
# sparsity): bf16 on the tensor cores, f32 outside them; matched by a
# substring of torch.cuda.get_device_name
GPU_PEAK_FLOPS = (
    ("H100 NVL", {"bfloat16": 835e12, "float32": 60e12}),
    ("H100 PCIe", {"bfloat16": 756e12, "float32": 51e12}),
    # the SXM part at 700 W ("NVIDIA H100 80GB HBM3")
    ("H100 80GB HBM3", {"bfloat16": 989e12, "float32": 67e12}),
    ("H100 SXM", {"bfloat16": 989e12, "float32": 67e12}),
)


def peak_flops_of(name: str, dtype="bfloat16") -> Optional[float]:
    """The peak rate of the card called ``name`` for ``dtype`` (a name or
    a torch dtype); None for a card not in the table."""
    dtype = str(dtype).replace("torch.", "")
    for key, peaks in GPU_PEAK_FLOPS:
        if key in name:
            return peaks.get(dtype)
    return None


def peak_flops(device, dtype="bfloat16") -> Optional[float]:
    """The peak rate of a torch device; None for the CPU or an unknown
    card."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return peak_flops_of(torch.cuda.get_device_name(device), dtype)


# -- what one call executes --------------------------------------------------

def executed_flops(fn: Callable, *args, **kwargs) -> int:
    """The FLOPs of one call of ``fn`` as ``FlopCounterMode`` counts the
    ATen ops it executes (matrix products, convolutions, attention). A
    hand-written kernel of ``csrc/`` counts nothing here, as a Pallas call
    counts nothing in XLA's count: no ``pallas_call`` in the repo passes a
    ``cost_estimate``."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return int(counter.get_total_flops())


def peak_device_bytes(fn: Callable, *args, **kwargs) -> Optional[int]:
    """The most bytes the CUDA caching allocator held during one call of
    ``fn`` (what was allocated before it included); None off CUDA."""
    if not torch.cuda.is_available():
        return None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn(*args, **kwargs)
    torch.cuda.synchronize()
    return int(torch.cuda.max_memory_allocated())
