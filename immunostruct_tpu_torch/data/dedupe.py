"""Exact-duplicate detection across (sequence, properties, graph topology)
(counterpart of ``immunostruct_tpu/data/dedupe.py``; reference:
data/utils.py:91-146).

``duplicate_check`` reports rows whose (one-hot sequence, property tuple)
match an earlier row AND whose graphs match on node count, node features
and edge lists ("double dupes"); ``dedupe`` removes them. The reference
calls duplicate_check in every dataset constructor
(immmunopred_dataloader.py:55) and only prints; here the scan returns
indices, so a caller can filter.
"""

from __future__ import annotations

import dataclasses
from collections import Counter

import numpy as np

from immunostruct_tpu_torch.data.dataset import ImmunoDataset


def find_duplicates(ds: ImmunoDataset) -> tuple[int, list[int]]:
    """Returns (n_seq_prop_dupes, indices of full duplicates to remove)."""
    cache: dict = {}
    dupes = 0
    to_remove: list[int] = []
    g = ds.graphs
    for i in range(len(ds)):
        key = (ds.seq_full[i].tobytes(), ds.props[i].tobytes())
        if key not in cache:
            cache[key] = i
            continue
        dupes += 1
        gi, gj = ds.graph_idx[i], ds.graph_idx[cache[key]]
        if gi == gj or (
                g.num_nodes[gi] == g.num_nodes[gj]
                and np.array_equal(g.edge_mask[gi], g.edge_mask[gj])
                and np.array_equal(g.node_onehot[gi], g.node_onehot[gj])
                and np.array_equal(g.edge_src[gi], g.edge_src[gj])
                and np.array_equal(g.edge_dst[gi], g.edge_dst[gj])):
            to_remove.append(i)
    return dupes, to_remove


def duplicate_check(ds: ImmunoDataset) -> None:
    """Print-only scan, as the reference's constructor-time check."""
    dupes, double = find_duplicates(ds)
    print("dupes", dupes, len(double))


def dedupe(ds: ImmunoDataset) -> ImmunoDataset:
    """A copy of the dataset without its full duplicates, its class weights
    counted anew."""
    _, to_remove = find_duplicates(ds)
    if not to_remove:
        return ds
    keep = np.setdiff1d(np.arange(len(ds)), np.asarray(to_remove))
    immuno = ds.immuno[keep]
    return dataclasses.replace(
        ds, seq_full=ds.seq_full[keep], seq_pep=ds.seq_pep[keep],
        props=ds.props[keep], immuno=immuno,
        foreign_norm=ds.foreign_norm[keep], graph_idx=ds.graph_idx[keep],
        raw_chain=[ds.raw_chain[i] for i in keep], pep_len=ds.pep_len[keep],
        class_weights=Counter(immuno.tolist()))
