"""Fixed-shape batch containers (counterpart of ``immunostruct_tpu/structs.py``).

Same fields, shapes and padding semantics as the JAX package: a graph batch
is a set of statically shaped tensors with masks. Padded edges carry
``edge_mask`` False and contribute nothing; padded nodes still flow through
the node MLP, attention and mean pooling.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

_GRAPH_DTYPES = {
    "node_feat": torch.float32,
    "coords": torch.float32,
    "edge_src": torch.int32,
    "edge_dst": torch.int32,
    "edge_feat": torch.float32,
    "edge_mask": torch.bool,
    "node_mask": torch.bool,
    "num_nodes": torch.int32,
}


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dtype)


@dataclasses.dataclass
class GraphBatch:
    """A batch of padded pMHC structure graphs.

      node_feat  [B, N, 20] float  amino-acid one-hot (zeros on padding)
      coords     [B, N, 3]  float  CA coordinates (zeros on padding)
      edge_src   [B, E]     int32  source node of each edge
      edge_dst   [B, E]     int32  destination node of each edge
      edge_feat  [B, E, 1]  float  edge attribute
      edge_mask  [B, E]     bool   True for real edges
      node_mask  [B, N]     bool   True for real nodes
      num_nodes  [B]        int32  real node count per graph
    """

    node_feat: torch.Tensor
    coords: torch.Tensor
    edge_src: torch.Tensor
    edge_dst: torch.Tensor
    edge_feat: torch.Tensor
    edge_mask: torch.Tensor
    node_mask: torch.Tensor
    num_nodes: torch.Tensor

    @classmethod
    def from_numpy(cls, arrays: Mapping[str, np.ndarray],
                   device: torch.device | str) -> "GraphBatch":
        """Build from numpy arrays keyed by field name (extra keys ignored)."""
        return cls(**{name: _tensor(arrays[name], dtype, device)
                      for name, dtype in _GRAPH_DTYPES.items()})

    def to(self, device: torch.device | str) -> "GraphBatch":
        return GraphBatch(**{f.name: getattr(self, f.name).to(device)
                             for f in dataclasses.fields(self)})

    @property
    def batch_size(self) -> int:
        return self.node_feat.shape[0]

    @property
    def max_nodes(self) -> int:
        return self.node_feat.shape[1]

    @property
    def max_edges(self) -> int:
        return self.edge_src.shape[1]


@dataclasses.dataclass
class SampleBatch:
    """One batch for non-comparative models.

      seq_onehot  [B, L, 21]  flattened to the VAE input inside the model
      props       [B, 2]      (Mprop1, Mprop2)
      target      [B]         label or regression target
      aux_residue [B] int32   masked-residue class for SSL (or None)
    """

    graph: GraphBatch
    seq_onehot: torch.Tensor
    props: torch.Tensor
    target: torch.Tensor
    aux_residue: Optional[torch.Tensor] = None

    @classmethod
    def from_numpy(cls, arrays: Mapping[str, np.ndarray],
                   device: torch.device | str) -> "SampleBatch":
        """Build from numpy arrays: the GraphBatch fields plus ``seq_onehot``,
        ``props``, ``target`` and optionally ``aux_residue``."""
        aux = arrays.get("aux_residue")
        return cls(
            graph=GraphBatch.from_numpy(arrays, device),
            seq_onehot=_tensor(arrays["seq_onehot"], torch.float32, device),
            props=_tensor(arrays["props"], torch.float32, device),
            target=_tensor(arrays["target"], torch.float32, device),
            aux_residue=None if aux is None
            else _tensor(aux, torch.int32, device))

    def to(self, device: torch.device | str) -> "SampleBatch":
        return SampleBatch(
            graph=self.graph.to(device),
            seq_onehot=self.seq_onehot.to(device),
            props=self.props.to(device),
            target=self.target.to(device),
            aux_residue=None if self.aux_residue is None
            else self.aux_residue.to(device))
