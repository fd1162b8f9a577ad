"""Graph corpus loading and dense stacking (counterpart of
``immunostruct_tpu/data/graphs.py``; reference: data/preprocess.py:15-43).

Native format: one ``.npz`` per graph with arrays ``x`` [n, 22] (20-dim
residue one-hot + h-donor + h-acceptor), ``coords`` [n, 3], ``edge_index``
[2, e], and a string ``name`` (must contain 'Immuno'; the join key is
``name.split('Immuno')[1]``, preprocess.py:35).

Filtering parity (preprocess.py:29-42): drop graphs whose name contains
'NXVPMVATV' or 'X'; dedup by join key keeping the first; cut the last 2 node
feature columns (h-bond donor/acceptor), leaving the 20-dim one-hot.

Legacy PyG ``.pt`` graphs (the reference featurizer's ``torch.save`` of a
``Data``) are read through ``convert_pt_graph``; a pickle that references
``torch_geometric`` needs that package installed.
``GraphCorpus.stack(paired=True)`` lays the edges out mirror-paired for the
paired mega kernel (B4, ``mega_variant='paired'``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np


def graph_key_from_name(name: str) -> str:
    """Join key (preprocess.py:35): the substring after 'Immuno'."""
    return name.split("Immuno")[1]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class GraphCorpus:
    """Ragged host-side graph store keyed by join key."""

    keys: list[str]
    node_onehot: list[np.ndarray]   # [n_i, 20] float32 (h-bond cols removed)
    coords: list[np.ndarray]        # [n_i, 3] float32
    edge_index: list[np.ndarray]    # [2, e_i] int32

    def __len__(self) -> int:
        return len(self.keys)

    def index(self) -> dict[str, int]:
        return {k: i for i, k in enumerate(self.keys)}

    def subset(self, indices: list[int]) -> "GraphCorpus":
        return GraphCorpus(
            keys=[self.keys[i] for i in indices],
            node_onehot=[self.node_onehot[i] for i in indices],
            coords=[self.coords[i] for i in indices],
            edge_index=[self.edge_index[i] for i in indices],
        )

    @property
    def max_nodes(self) -> int:
        return max(f.shape[0] for f in self.node_onehot)

    @property
    def max_edges(self) -> int:
        return max(e.shape[1] for e in self.edge_index)

    def stack(self, max_nodes: Optional[int] = None,
              max_edges: Optional[int] = None, nodes_multiple: int = 8,
              edges_multiple: int = 128, paired: bool = False) -> dict:
        """Dense padded arrays for the whole corpus:
        node_onehot [M, N, 20] uint8, coords [M, N, 3] f32,
        edge_src/edge_dst [M, E] int32, edge_mask [M, E] bool,
        node_mask [M, N] bool, num_nodes [M] int32; N and E rounded up to
        their multiples.

        ``paired=True`` gives the mirror-paired layout of the paired kernel
        (B4): each graph's arcs are put in order by
        ``structs.mirror_pair_edge_index``, each half is padded on its own
        to a common multiple of ``edges_multiple`` (so E is twice that), and
        slot k + E/2 holds the reverse of slot k, padding mirrored. As in
        the JAX package, ``max_edges`` is then a floor on E, not a cap.
        Raises ValueError naming a graph whose edge list cannot be paired."""
        m = len(self)
        n = _round_up(max_nodes or self.max_nodes, nodes_multiple)
        if paired:
            from immunostruct_tpu_torch.structs import mirror_pair_edge_index

            ordered = []
            for i, ei in enumerate(self.edge_index):
                oi = mirror_pair_edge_index(ei)
                if oi is None:
                    raise ValueError(
                        f"graph {self.keys[i]}: edge list not mirror-"
                        "pairable (self loop / unpaired arc / duplicate) "
                        "— cannot use the paired edge layout")
                ordered.append(oi)
            want_half = max((max_edges or 0) + 1, 2) // 2 if max_edges else 1
            half = _round_up(
                max(want_half, max((ei.shape[1] // 2 for ei in ordered),
                                   default=1), 1), edges_multiple)
            e = 2 * half
        else:
            e = _round_up(max(max_edges or self.max_edges, 1), edges_multiple)
        out = {
            "node_onehot": np.zeros((m, n, 20), np.uint8),
            "coords": np.zeros((m, n, 3), np.float32),
            "edge_src": np.zeros((m, e), np.int32),
            "edge_dst": np.zeros((m, e), np.int32),
            "edge_mask": np.zeros((m, e), bool),
            "node_mask": np.zeros((m, n), bool),
            "num_nodes": np.zeros((m,), np.int32),
        }
        for i in range(m):
            f, c = self.node_onehot[i], self.coords[i]
            ei = ordered[i] if paired else self.edge_index[i]
            ni, ne = f.shape[0], ei.shape[1]
            if ni > n or ne > e:
                raise ValueError(f"graph {self.keys[i]}: {ni} nodes/{ne} "
                                 f"edges exceed pad {n}/{e}")
            out["node_onehot"][i, :ni] = f.astype(np.uint8)
            out["coords"][i, :ni] = c
            if paired:
                u, half = ne // 2, e // 2
                for lo, a, b in ((0, 0, 1), (half, 1, 0)):
                    out["edge_src"][i, lo:lo + u] = ei[a, :u]
                    out["edge_dst"][i, lo:lo + u] = ei[b, :u]
                    out["edge_mask"][i, lo:lo + u] = True
            else:
                out["edge_src"][i, :ne] = ei[0]
                out["edge_dst"][i, :ne] = ei[1]
                out["edge_mask"][i, :ne] = True
            out["node_mask"][i, :ni] = True
            out["num_nodes"][i] = ni
        return out


def convert_pt_graph(path: str):
    """A legacy PyG ``.pt`` graph as (name, x, coords, edge_index), x still
    carrying its 22 columns. The file is unpickled
    (``torch.load(weights_only=False)``): read only files you trust."""
    import torch

    data = torch.load(path, map_location="cpu", weights_only=False)
    return (
        str(data.name),
        np.asarray(data.x, np.float32),
        np.asarray(data.coords, np.float32),
        np.asarray(data.edge_index, np.int64).astype(np.int32),
    )


def load_graph_dir(directory: str, drop_hbond_cols: bool = True) -> GraphCorpus:
    """Load every .npz and .pt graph in a directory, in file-name order,
    with reference filtering."""
    files = sorted(f for f in os.listdir(directory)
                   if f.endswith((".npz", ".pt")))
    keys, feats, coords, edges = [], [], [], []
    seen = set()
    for fname in files:
        path = os.path.join(directory, fname)
        if fname.endswith(".pt"):
            name, x, c, ei = convert_pt_graph(path)
        else:
            with np.load(path, allow_pickle=False) as z:
                name = str(z["name"])
                x = z["x"].astype(np.float32)
                c = z["coords"].astype(np.float32)
                ei = z["edge_index"].astype(np.int32)
        # filtering parity: drop bad names, dedup by key keeping the first
        if "NXVPMVATV" in name or "X" in name:
            continue
        key = graph_key_from_name(name)
        if key in seen:
            continue
        seen.add(key)
        keys.append(key)
        if drop_hbond_cols and x.shape[1] > 20:
            x = x[:, :-2]
        feats.append(x)
        coords.append(c)
        edges.append(ei)
    return GraphCorpus(keys=keys, node_onehot=feats, coords=coords,
                       edge_index=edges)


def save_graph_npz(path: str, name: str, x: np.ndarray, coords: np.ndarray,
                   edge_index: np.ndarray) -> None:
    """Write one graph in the native .npz format."""
    np.savez_compressed(path, name=np.asarray(name), x=x.astype(np.float32),
                        coords=coords.astype(np.float32),
                        edge_index=edge_index.astype(np.int32))
