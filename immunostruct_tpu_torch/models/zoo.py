"""The 14-model registry (counterpart of ``immunostruct_tpu/models/zoo.py``;
reference: immunostruct/models/mapping.py:6-21).

Each entry is a ``ModelSpec`` realizing one reference class as a
configuration of the shared trunk:

  SequenceModel                  VAE only
  SequenceFpModel                VAE + raw 2 props
  StructureModel                 EGNN + MHA(8)
  StructureModel_SSL
  StructureModelv2               mean+max pool
  HybridModel                    self-attn fusion
  HybridModel_SSL
  HybridModelv2                  +fusion MHA(16,8)  (the flagship)
  HybridModelv2_SSL              +fusion MHA(32,8)
  HybridModel_Comparative
  HybridModel_Comparative_SSL
  HybridModelv2_Comparative      +fusion MHA(32,8)
  HybridModelv2_Comparative_SSL
  DualModel                      structure+seq, no prop
"""

from __future__ import annotations

import dataclasses

import torch

from immunostruct_tpu_torch.models.trunk import ImmunoStructModel, ModelSpec

model_map: dict[str, ModelSpec] = {
    "SequenceModel": ModelSpec(
        name="SequenceModel", use_structure=False, use_property=False),
    "SequenceFpModel": ModelSpec(
        name="SequenceFpModel", use_structure=False, use_property=False,
        raw_property_concat=True),
    "StructureModel": ModelSpec(
        name="StructureModel", use_sequence=False, use_property=False,
        node_attention="mha", self_attention_heads=8),
    "StructureModel_SSL": ModelSpec(
        name="StructureModel_SSL", use_sequence=False, use_property=False,
        node_attention="mha", self_attention_heads=8, ssl=True),
    "StructureModelv2": ModelSpec(
        name="StructureModelv2", use_sequence=False, use_property=False,
        node_attention="mha", self_attention_heads=8, ssl=True,
        mean_max_pool=True),
    "HybridModel": ModelSpec(
        name="HybridModel", node_attention="self"),
    "HybridModel_SSL": ModelSpec(
        name="HybridModel_SSL", node_attention="self", ssl=True),
    "HybridModelv2": ModelSpec(
        name="HybridModelv2", node_attention="mha", self_attention_heads=1,
        combined_attention_dim=16, combined_attention_heads=8),
    "HybridModelv2_SSL": ModelSpec(
        name="HybridModelv2_SSL", node_attention="mha", self_attention_heads=1,
        combined_attention_dim=32, combined_attention_heads=8, ssl=True),
    "HybridModel_Comparative": ModelSpec(
        name="HybridModel_Comparative", node_attention="self", comparative=True),
    "HybridModel_Comparative_SSL": ModelSpec(
        name="HybridModel_Comparative_SSL", node_attention="self",
        comparative=True, ssl=True),
    "HybridModelv2_Comparative": ModelSpec(
        name="HybridModelv2_Comparative", node_attention="mha",
        self_attention_heads=1, combined_attention_dim=32,
        combined_attention_heads=8, comparative=True),
    "HybridModelv2_Comparative_SSL": ModelSpec(
        name="HybridModelv2_Comparative_SSL", node_attention="mha",
        self_attention_heads=1, combined_attention_dim=32,
        combined_attention_heads=8, comparative=True, ssl=True),
    "DualModel": ModelSpec(
        name="DualModel", node_attention="self", use_property=False),
}


def build_model(name: str, vae_input_dim: int, generator: torch.Generator,
                use_wt_for_downstream: bool = True, device=None,
                dtype=torch.float32, **overrides):
    """Build (spec, model) for a registry name; weights are drawn from
    ``generator``. ``use_wt_for_downstream`` only affects comparative
    models."""
    if name not in model_map:
        raise KeyError(f"unknown model '{name}'; choose from {sorted(model_map)}")
    spec = model_map[name]
    if spec.comparative:
        overrides = {"use_wt_for_downstream": use_wt_for_downstream,
                     **overrides}
    if overrides:
        spec = dataclasses.replace(spec, **overrides)
    model = ImmunoStructModel(spec, vae_input_dim, generator=generator,
                              device=device, dtype=dtype)
    return spec, model
