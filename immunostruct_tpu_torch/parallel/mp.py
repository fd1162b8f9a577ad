"""Model-parallel configuration of the real flagship forward (counterpart of
``immunostruct_tpu/parallel/mp.py``).

``MPConfig`` is the knob threaded through ``models/trunk.py``'s forward:

  tp_axis  Megatron-split the VAE: fc1 column-parallel (5964x512; with fc4
           that pair is ~96% of the flagship's parameters) feeding
           fc21/fc22 row-parallel, and fc3 column-parallel feeding fc4
           row-parallel: one sum over the 'model' axis per pair.
  pp_axis  GPipe the shape-homogeneous hidden EGNN convs (``gcn[1:]``)
           over the 'pipe' axis, one conv a stage, the edge data as the
           pipeline's aux. With more stages than convs the extra stages
           pass the activation through (``pad_pipeline_stages``).

A forward with an ``MPConfig`` runs under ``with mesh:`` on a mesh that
has those axes (``parallel/trainer.py::make_mp_train_step``); the plain
paths keep ``mp=None``. ``sharded_parameters`` names the parameters whose
gradients each axis splits, the ones the step sums over that axis.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class MPConfig:
    tp_axis: Optional[str] = None   # VAE Megatron axis name
    pp_axis: Optional[str] = None   # EGNN hidden-conv pipeline axis name
    pp_microbatches: int = 4


def pad_pipeline_stages(layers: list, n_stages: int):
    """One hidden conv a stage, padded with identity stages (None) up to
    ``n_stages``. Returns (stages, on [S] f32): stage s applies its layer
    iff on[s] == 1."""
    k = len(layers)
    assert n_stages >= k, (n_stages, k)
    stages = list(layers) + [None] * (n_stages - k)
    on = torch.cat([torch.ones(k), torch.zeros(n_stages - k)])
    return stages, on


# the VAE's weights that the Megatron pairs split (the row-parallel biases
# are added after the sum, on every rank, and stay whole)
TP_SPLIT = ("vae.fc1.w", "vae.fc1.b", "vae.fc21.w", "vae.fc22.w",
            "vae.fc3.w", "vae.fc3.b", "vae.fc4.w")


def sharded_parameters(model: torch.nn.Module, mp: Optional[MPConfig]
                       ) -> dict:
    """{axis name: [parameter names]}: the parameters whose gradient the
    axis splits, each rank holding its slice (TP) or its stage's layer
    (PP) and zeros or nothing elsewhere."""
    out = {}
    if mp is None:
        return out
    names = [n for n, _ in model.named_parameters()]
    if mp.tp_axis is not None and getattr(model.spec, "use_sequence", False):
        out[mp.tp_axis] = [n for n in names if n in TP_SPLIT]
    if (mp.pp_axis is not None and getattr(model.spec, "use_structure", False)
            and model.spec.gcn_layers > 0):
        out[mp.pp_axis] = [n for n in names if n.startswith("gcn.")
                           and n.split(".")[1] != "0"]
    return out
