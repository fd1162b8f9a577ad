"""Seeded synthetic inputs (counterpart of ``immunostruct_tpu/data/synthetic.py``
``random_sample_batch``/``random_comparative_batch`` and
``immunostruct_tpu/serving.py`` ``write_example``).

The functions make the same ``np.random.default_rng`` calls in the same
order as the JAX package, so one seed gives bit-identical arrays in both
packages.
"""

from __future__ import annotations

import numpy as np
import torch

from immunostruct_tpu_torch.structs import ComparativeBatch, SampleBatch


def random_sample_arrays(batch: int, nodes: int, edges: int, seq_len: int,
                         seed: int = 0) -> dict:
    """The flagship-shaped random batch as numpy arrays keyed by field name.

    Every edge is real (``edge_mask`` all True); indices are drawn uniformly,
    so self-loops occur."""
    rng = np.random.default_rng(seed)
    onehot = np.zeros((batch, nodes, 20), np.float32)
    for b in range(batch):
        onehot[b, np.arange(nodes), rng.integers(0, 20, nodes)] = 1.0
    coords = rng.standard_normal((batch, nodes, 3)).astype(np.float32)
    src = rng.integers(0, nodes, (batch, edges)).astype(np.int32)
    dst = rng.integers(0, nodes, (batch, edges)).astype(np.int32)
    return dict(
        node_feat=onehot, coords=coords, edge_src=src, edge_dst=dst,
        edge_feat=np.ones((batch, edges, 1), np.float32),
        edge_mask=np.ones((batch, edges), bool),
        node_mask=np.ones((batch, nodes), bool),
        num_nodes=np.full((batch,), nodes, np.int32),
        seq_onehot=rng.random((batch, seq_len, 21)).astype(np.float32),
        props=rng.random((batch, 2)).astype(np.float32),
        target=(rng.random(batch) > 0.5).astype(np.float32),
    )


def random_sample_batch(batch: int, nodes: int, edges: int, seq_len: int,
                        seed: int = 0,
                        device: torch.device | str = "cpu") -> SampleBatch:
    """``random_sample_arrays`` as a SampleBatch on ``device``."""
    return SampleBatch.from_numpy(
        random_sample_arrays(batch, nodes, edges, seq_len, seed), device)


def random_comparative_batch(batch: int, nodes: int, edges: int,
                             seq_len: int, seed: int = 0,
                             device: torch.device | str = "cpu"
                             ) -> ComparativeBatch:
    """Cancer/WT twins: the cancer half from ``seed``, the WT half from
    ``seed + 1`` with the cancer half's (pair-level) target."""
    cancer = random_sample_batch(batch, nodes, edges, seq_len, seed, device)
    wt = random_sample_batch(batch, nodes, edges, seq_len, seed + 1, device)
    wt.target = cancer.target
    return ComparativeBatch(cancer=cancer, wt=wt)


def write_example(path, batch: int = 8, nodes: int = 32, edges: int = 128,
                  seq_len: int = 64) -> None:
    """Write a scoring request ``.npz`` (the serving request format)."""
    rng = np.random.default_rng(0)
    onehot = np.zeros((batch, nodes, 20), np.float32)
    onehot[:, np.arange(nodes), rng.integers(0, 20, (batch, nodes))] = 1.0
    np.savez(path,
             node_feat=onehot,
             coords=rng.standard_normal((batch, nodes, 3)).astype(np.float32),
             edge_src=rng.integers(0, nodes, (batch, edges)).astype(np.int32),
             edge_dst=rng.integers(0, nodes, (batch, edges)).astype(np.int32),
             edge_feat=np.ones((batch, edges, 1), np.float32),
             edge_mask=np.ones((batch, edges), bool),
             node_mask=np.ones((batch, nodes), bool),
             num_nodes=np.full((batch,), nodes, np.int32),
             seq=rng.random((batch, seq_len, 21)).astype(np.float32),
             props=rng.random((batch, 2)).astype(np.float32))
