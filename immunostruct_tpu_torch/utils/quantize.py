"""Weight quantization for the serving artifact (counterpart of
``immunostruct_tpu/utils/quantize.py``).

Weight-only int8 with per-output-channel symmetric scales, in numpy, with
the JAX package's arithmetic: the same f32 weights give the same int8
values, scales and dequantized weights bit for bit.

``fake_quant_int8`` rounds every linear weight of a model through int8 and
back to f32: numerically what dequantize-at-load serving computes, so an
artifact exported from the rounded model (``cli/export_model.py --int8``)
shows the accuracy that int8 weights cost. A linear weight is a rank-2
parameter named ``w``; the port keeps JAX's ``[in, out]`` layout, so the
scales are per column, as there.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def _is_weight(name: str, param: torch.Tensor) -> bool:
    """Linear weights: rank-2 parameters stored under the name ``w``."""
    return name.rsplit(".", 1)[-1] == "w" and param.dim() == 2


def quantize_int8(w: np.ndarray):
    """[in, out] f32 -> (int8 [in, out], f32 scale [out])."""
    w = np.asarray(w, np.float32)
    scale = np.max(np.abs(w), axis=0) / 127.0
    scale = np.where(scale == 0, 1.0, scale)
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def dequantize_int8(q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    return q.astype(np.float32) * scale


@torch.no_grad()
def fake_quant_int8(model: nn.Module) -> nn.Module:
    """Round every linear weight of ``model`` through int8 (per output
    channel, symmetric), in place; biases and every other parameter pass
    through unchanged. Returns ``model``."""
    for name, p in model.named_parameters():
        if _is_weight(name, p):
            q, s = quantize_int8(p.detach().float().cpu().numpy())
            p.copy_(torch.from_numpy(dequantize_int8(q, s)))
    return model


def quantized_size_bytes(model: nn.Module) -> tuple[int, int]:
    """(float32 size, int8-weights size) of the model's parameters: int8
    weights carry one f32 scale per output channel."""
    f32 = q = 0
    for name, p in model.named_parameters():
        n = p.numel()
        f32 += 4 * n
        q += n + 4 * p.shape[-1] if _is_weight(name, p) else 4 * n
    return f32, q
