"""The model trunk and the zoo registry."""

from immunostruct_tpu_torch.models.trunk import (
    ModelSpec, model_apply, model_apply_comparative, reset_head,
)
from immunostruct_tpu_torch.models.zoo import build_model, model_map

__all__ = ["ModelSpec", "build_model", "model_apply",
           "model_apply_comparative", "model_map", "reset_head"]
