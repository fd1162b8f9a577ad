"""The model trunk and the zoo registry."""

from immunostruct_tpu_torch.models.trunk import ModelSpec, model_apply
from immunostruct_tpu_torch.models.zoo import build_model, model_map

__all__ = ["ModelSpec", "build_model", "model_apply", "model_map"]
