"""Host-side batch pipeline: split views, augmentation, device feed
(counterpart of ``immunostruct_tpu/data/pipeline.py``; reference:
data/util_dataloader.py:11-102, data/utils.py:160-196).

``BatchPipeline`` makes the same numpy calls on the same seeds as the JAX
package's, so both build bit-identical batches; only the last step
differs: each array goes from pinned host memory to the device with a
``non_blocking`` copy (a plain tensor when the device is the CPU).

Reference-parity notes (as in the JAX package):
- label selection: binary -> immunogenicity, else normalized foreignness;
  full -> full-chain one-hot, else peptide;
- sequence masking (train, sequence_pad_count > 0) draws positions from the
  first (L_full - L_pep) padded positions, the HLA region;
- graph augmentation (rotation, structure masking, SSL single-residue
  masking) reaches the model only on the SSL path, or with
  ``config.force_graph_augmentation``;
- the train split is shuffled, the others are not; the last batch of an
  epoch may be partial;
- ``extend_to`` (ExtendedDataset, util_dataloader.py:91-102) cycles a small
  split's indices up to a floor length.

``ComparativePipeline`` yields cancer/WT ``ComparativeBatch``es: independent
rotations per branch, the same sequence-mask columns in both, SSL masks on
residues of one class in both (immmunopred_dataloader.py:216-271), and the
cancer side's target for both twins.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from immunostruct_tpu_torch.data.dataset import (
    ComparativeDataset, ImmunoDataset,
)
from immunostruct_tpu_torch.structs import (
    ComparativeBatch, GraphBatch, SampleBatch,
)


def prefetch(iterator, size: int = 2):
    """Double-buffered host prefetch: assemble the next batch (numpy work
    and its copy to the device) on a background thread while the device
    runs the current step. An exception in the producer is raised here."""
    q: "queue.Queue" = queue.Queue(maxsize=size)
    sentinel = object()
    err: list = []

    def producer():
        try:
            for item in iterator:
                q.put(item)
        except BaseException as e:  # noqa: BLE001 - re-raised on consumer side
            err.append(e)
        finally:
            q.put(sentinel)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is sentinel:
            if err:
                raise err[0]
            return
        yield item


def to_device(a: np.ndarray, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    """A numpy array as a tensor of ``dtype`` on ``device``: through pinned
    host memory and a non-blocking copy for a CUDA device."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _random_rotations(rng: np.random.Generator, count: int) -> np.ndarray:
    """Batch of QR-orthogonalized random 3x3 matrices (data/utils.py:148-155)."""
    m = rng.standard_normal((count, 3, 3))
    q, _ = np.linalg.qr(m)
    return q.astype(np.float32)


def _mask_positions(rng, batch: int, maskable_len: int, count: int) -> np.ndarray:
    """[B, count] distinct positions per row in [0, maskable_len)."""
    return np.argsort(rng.random((batch, maskable_len)), axis=1)[:, :count]


def _mask_sequence_batch(rng, seq: np.ndarray, maskable_len: int,
                         count: int, cols: Optional[np.ndarray] = None
                         ) -> np.ndarray:
    """Mask ``count`` random positions per row within [0, maskable_len)
    with the padding one-hot; ``cols`` [B, count] masks given positions
    (the same in both comparative twins) and draws nothing."""
    if count <= 0 or maskable_len <= 0:
        return seq
    b, _, a = seq.shape
    pad_onehot = np.zeros((a,), np.float32)
    pad_onehot[a - 1] = 1.0  # 'J' is the last alphabet channel
    if cols is None:
        cols = _mask_positions(rng, b, maskable_len, count)
    rows = np.repeat(np.arange(b), count)
    seq = seq.copy()
    seq[rows, cols.reshape(-1)] = pad_onehot
    return seq


def _mask_structure_batch(rng, onehot: np.ndarray, count: int) -> np.ndarray:
    """Zero ``count`` random node rows unless already SSL-masked (sum > 1)."""
    if count <= 0:
        return onehot
    b, n, _ = onehot.shape
    cols = np.argsort(rng.random((b, n)), axis=1)[:, :count]
    onehot = onehot.copy()
    for j in range(count):
        idx = cols[:, j]
        rows_sum = onehot[np.arange(b), idx].sum(-1)
        zero_it = rows_sum <= 1
        onehot[np.nonzero(zero_it)[0], idx[zero_it]] = 0.0
    return onehot


def _ssl_mask_single(rng, onehot: np.ndarray):
    """Mask one random real residue per graph as all-ones; return its class."""
    b = onehot.shape[0]
    classes = np.full((b,), 0, np.int32)
    onehot = onehot.copy()
    for i in range(b):
        real = np.nonzero(onehot[i].sum(-1) == 1)[0]
        if len(real) == 0:
            continue
        pick = real[rng.integers(0, len(real))]
        classes[i] = int(np.argmax(onehot[i, pick]))
        onehot[i, pick] = 1.0
    return onehot, classes


def _ssl_mask_paired(rng, onehot_c: np.ndarray, onehot_w: np.ndarray):
    """Mask same-class residues in the cancer/WT pair; return the class."""
    b = onehot_c.shape[0]
    classes = np.full((b,), 0, np.int32)
    onehot_c, onehot_w = onehot_c.copy(), onehot_w.copy()
    for i in range(b):
        real_c = np.nonzero(onehot_c[i].sum(-1) == 1)[0]
        real_w_cls = onehot_w[i].argmax(-1)
        real_w_valid = onehot_w[i].sum(-1) == 1
        rng.shuffle(real_c)
        for pick in real_c:
            cls = int(np.argmax(onehot_c[i, pick]))
            cand = np.nonzero(real_w_valid & (real_w_cls == cls))[0]
            if len(cand):
                pick_w = cand[rng.integers(0, len(cand))]
                onehot_c[i, pick] = 1.0
                onehot_w[i, pick_w] = 1.0
                classes[i] = cls
                break
    return onehot_c, onehot_w, classes


class BatchPipeline:
    """Epoch iterator over a split of an ImmunoDataset, yielding
    ``SampleBatch``es of ``config.batch_size`` on ``config.device``."""

    def __init__(self, dataset: ImmunoDataset, indices: np.ndarray, *,
                 split: str, binary: bool, full: bool, config,
                 ssl: bool = False, extend_to: int = 0):
        self.ds = dataset
        self.indices = np.asarray(indices, np.int64)
        if extend_to and len(self.indices) < extend_to:
            reps = int(np.ceil(extend_to / len(self.indices)))
            self.indices = np.tile(self.indices, reps)[:extend_to]
        self.split = split
        self.binary = binary
        self.full = full
        self.ssl = ssl
        self.config = config
        self.batch_size = config.batch_size
        self.shuffle = split == "train"
        self.device = torch.device(config.device)

    def __len__(self):
        return int(np.ceil(len(self.indices) / self.batch_size))

    @property
    def maskable_len(self) -> int:
        return self.ds.seq_full.shape[1] - self.ds.seq_pep.shape[1]

    def arrays(self, rng, rows: np.ndarray) -> dict:
        """One batch as numpy arrays keyed by ``SampleBatch``/``GraphBatch``
        field name (``aux_residue`` only for SSL)."""
        g = self.ds.graphs
        gi = self.ds.graph_idx[rows]
        onehot = g.node_onehot[gi].astype(np.float32)
        coords = g.coords[gi]
        classes = None
        train = self.split == "train"
        if train and (self.ssl or self.config.force_graph_augmentation):
            rot = _random_rotations(rng, len(rows))
            coords = np.einsum("bnc,bcd->bnd", coords, rot)
            if self.ssl:
                onehot, classes = _ssl_mask_single(rng, onehot)
            if self.config.structure_pad_count > 0:
                onehot = _mask_structure_batch(
                    rng, onehot, self.config.structure_pad_count)
        if self.full:
            seq = self.ds.seq_full[rows]
            if train and self.config.sequence_pad_count > 0:
                seq = _mask_sequence_batch(rng, seq, self.maskable_len,
                                           self.config.sequence_pad_count)
        else:
            seq = self.ds.seq_pep[rows]
        out = dict(
            node_feat=onehot, coords=coords, edge_src=g.edge_src[gi],
            edge_dst=g.edge_dst[gi], edge_mask=g.edge_mask[gi],
            node_mask=g.node_mask[gi], num_nodes=g.num_nodes[gi],
            seq_onehot=seq, props=self.ds.props[rows],
            target=(self.ds.immuno[rows] if self.binary
                    else self.ds.foreign_norm[rows]))
        if self.ssl:
            # val/test pass no-op residues (train_SSL.py:46 passes empties)
            out["aux_residue"] = (classes if classes is not None and train
                                  else np.full((len(rows),), -1, np.int32))
        return out

    def _assemble(self, rng, rows: np.ndarray) -> SampleBatch:
        return self._sample(self.arrays(rng, rows))

    def _sample(self, a: dict) -> SampleBatch:
        """``arrays``' dict as a SampleBatch on the pipeline's device."""
        dev = self.device
        graph = GraphBatch(
            node_feat=to_device(a["node_feat"], torch.float32, dev),
            coords=to_device(a["coords"], torch.float32, dev),
            edge_src=to_device(a["edge_src"], torch.int32, dev),
            edge_dst=to_device(a["edge_dst"], torch.int32, dev),
            edge_feat=torch.ones((*a["edge_src"].shape, 1),
                                 dtype=torch.float32, device=dev),
            edge_mask=to_device(a["edge_mask"], torch.bool, dev),
            node_mask=to_device(a["node_mask"], torch.bool, dev),
            num_nodes=to_device(a["num_nodes"], torch.int32, dev))
        aux = a.get("aux_residue")
        return SampleBatch(
            graph=graph,
            seq_onehot=to_device(a["seq_onehot"], torch.float32, dev),
            props=to_device(a["props"], torch.float32, dev),
            target=to_device(a["target"], torch.float32, dev),
            aux_residue=None if aux is None
            else to_device(aux, torch.int32, dev))

    def epoch(self, epoch_idx: int) -> Iterator[SampleBatch]:
        """One epoch's batches: the epoch's generator, seeded from (seed,
        epoch), shuffles the indices and then draws the batches'
        augmentations in order."""
        rng = np.random.default_rng((self.config.seed, epoch_idx, 0x5eed))
        order = rng.permutation(len(self.indices)) if self.shuffle \
            else np.arange(len(self.indices))
        idx = self.indices[order]
        for start in range(0, len(idx), self.batch_size):
            yield self._assemble(rng, idx[start:start + self.batch_size])


class ComparativePipeline(BatchPipeline):
    """Paired cancer/WT pipeline over a ComparativeDataset, yielding
    ``ComparativeBatch``es; the same numpy calls on the same seeds as the
    JAX package's."""

    def __init__(self, dataset: ComparativeDataset, indices: np.ndarray,
                 **kw):
        super().__init__(dataset.cancer, indices, **kw)
        self.wt = dataset.wt

    def arrays(self, rng, rows: np.ndarray) -> tuple:
        """One batch as two dicts of numpy arrays (cancer, wt), keyed as
        ``BatchPipeline.arrays``'."""
        train = self.split == "train"
        gc, gw = self.ds.graphs, self.wt.graphs
        gi_c, gi_w = self.ds.graph_idx[rows], self.wt.graph_idx[rows]
        onehot_c = gc.node_onehot[gi_c].astype(np.float32)
        onehot_w = gw.node_onehot[gi_w].astype(np.float32)
        coords_c, coords_w = gc.coords[gi_c], gw.coords[gi_w]
        classes = None
        if train and (self.ssl or self.config.force_graph_augmentation):
            # independent rotations per branch (util_dataloader.py:38-42)
            coords_c = np.einsum("bnc,bcd->bnd", coords_c,
                                 _random_rotations(rng, len(rows)))
            coords_w = np.einsum("bnc,bcd->bnd", coords_w,
                                 _random_rotations(rng, len(rows)))
            if self.ssl:
                onehot_c, onehot_w, classes = _ssl_mask_paired(
                    rng, onehot_c, onehot_w)
            count = self.config.structure_pad_count
            if count > 0:
                onehot_c = _mask_structure_batch(rng, onehot_c, count)
                onehot_w = _mask_structure_batch(rng, onehot_w, count)
        if self.full:
            seq_c, seq_w = self.ds.seq_full[rows], self.wt.seq_full[rows]
            count = self.config.sequence_pad_count
            if train and count > 0:
                # the same mask positions in both branches
                cols = _mask_positions(rng, len(rows), self.maskable_len,
                                       count)
                seq_c = _mask_sequence_batch(rng, seq_c, self.maskable_len,
                                             count, cols)
                seq_w = _mask_sequence_batch(rng, seq_w, self.maskable_len,
                                             count, cols)
        else:
            seq_c, seq_w = self.ds.seq_pep[rows], self.wt.seq_pep[rows]
        target = (self.ds.immuno[rows] if self.binary
                  else self.ds.foreign_norm[rows])

        def side(g, gi, onehot, coords, seq, props):
            out = dict(node_feat=onehot, coords=coords,
                       edge_src=g.edge_src[gi], edge_dst=g.edge_dst[gi],
                       edge_mask=g.edge_mask[gi], node_mask=g.node_mask[gi],
                       num_nodes=g.num_nodes[gi], seq_onehot=seq,
                       props=props[rows], target=target)
            if self.ssl:
                out["aux_residue"] = (
                    classes if classes is not None and train
                    else np.full((len(rows),), -1, np.int32))
            return out

        return (side(gc, gi_c, onehot_c, coords_c, seq_c, self.ds.props),
                side(gw, gi_w, onehot_w, coords_w, seq_w, self.wt.props))

    def _assemble(self, rng, rows: np.ndarray) -> ComparativeBatch:
        cancer, wt = self.arrays(rng, rows)
        return ComparativeBatch(cancer=self._sample(cancer),
                                wt=self._sample(wt))
