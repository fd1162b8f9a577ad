"""Device-resident corpus pipeline (counterpart of
``immunostruct_tpu/data/device_pipeline.py``): the whole corpus lives on
the device once, and a batch is one gather there.

The host ``BatchPipeline`` assembles every batch in numpy and copies it
over, array by array. Here the rows and unique graphs are uploaded once
(sequence and node one-hots as uint8, cast per batch on the device), the
epoch's row order goes up in one pinned, non-blocking copy, and each step
slices it and gathers its batch with ``index_select``: the per-step path
makes no host sync and no host-to-device copy. Augmented and SSL
configurations run their transforms on the device
(``device_augment=True``, ``data/device_augment.py``).

Without augmentation the batches are the host pipeline's, bit for bit: the
same epoch order (``np.random.default_rng((seed, epoch, 0x5eed))``), the
same dtypes and values.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Iterator, Optional

import numpy as np
import torch

from immunostruct_tpu_torch.data.dataset import (
    ComparativeDataset, ImmunoDataset,
)
from immunostruct_tpu_torch.data.device_augment import (
    augment_batch, augment_comparative,
)
from immunostruct_tpu_torch.data.pipeline import to_device
from immunostruct_tpu_torch.procedures.train import derived_seed
from immunostruct_tpu_torch.structs import (
    ComparativeBatch, GraphBatch, SampleBatch,
)


@dataclasses.dataclass
class DeviceCorpus:
    """All rows and unique graphs of a dataset, on one device."""

    seq: torch.Tensor          # [M, L, 21] uint8 (full or peptide, at build)
    props: torch.Tensor        # [M, 2] f32
    target: torch.Tensor       # [M] f32 (immunogenicity or foreignness)
    graph_idx: torch.Tensor    # [M] int32
    node_onehot: torch.Tensor  # [G, N, 20] uint8
    coords: torch.Tensor       # [G, N, 3] f32
    edge_src: torch.Tensor     # [G, E] int32
    edge_dst: torch.Tensor     # [G, E] int32
    edge_mask: torch.Tensor    # [G, E] bool
    node_mask: torch.Tensor    # [G, N] bool
    num_nodes: torch.Tensor    # [G] int32

    def nbytes(self) -> int:
        return sum(getattr(self, f.name).nbytes
                   for f in dataclasses.fields(self))


# One upload per (dataset, full, device): the train/val/test pipelines of a
# dataset, and later stages that reuse it, share one device-resident corpus
# instead of each uploading a copy. Keyed by id(dataset) with a weakref
# guard (the dataset is not hashable); the weakref's callback drops the
# entry, and its device memory, the moment the dataset is collected.
_CORPUS_CACHE: dict = {}  # id(ds) -> (weakref.ref(ds), {key: corpus})


def _corpus_cache_for(ds) -> dict:
    for k in [k for k, (ref, _) in _CORPUS_CACHE.items() if ref() is None]:
        del _CORPUS_CACHE[k]
    entry = _CORPUS_CACHE.get(id(ds))
    if entry is None or entry[0]() is not ds:
        key = id(ds)
        entry = (weakref.ref(ds, lambda _ref, _k=key: _CORPUS_CACHE.pop(_k, None)),
                 {})
        _CORPUS_CACHE[key] = entry
    return entry[1]


# Corpora that pick_pipeline's 'auto' admitted: id(ds) -> (weakref, bytes),
# with the cache's lifetime rule, so that the budget counts only corpora
# that can still be on the device.
_ADMITTED: dict = {}


def note_admitted(ds, nbytes: int) -> None:
    """Record that 'auto' admitted ``nbytes`` of device corpus for ``ds``."""
    key = id(ds)
    _ADMITTED[key] = (
        weakref.ref(ds, lambda _ref, _k=key: _ADMITTED.pop(_k, None)), nbytes)


def admitted_device_bytes() -> int:
    """Total bytes 'auto' has admitted for datasets that are still alive."""
    return sum(n for ref, n in _ADMITTED.values() if ref() is not None)


def estimate_device_bytes(ds, *, full: bool = True) -> int:
    """The bytes ``build_device_corpus`` uploads, from the fields it
    uploads (sequences and node one-hots as uint8). A comparative dataset
    counts both twins."""
    if hasattr(ds, "cancer") and hasattr(ds, "wt"):
        return (estimate_device_bytes(ds.cancer, full=full)
                + estimate_device_bytes(ds.wt, full=full))
    seq = ds.seq_full if full else ds.seq_pep
    g = ds.graphs
    m = seq.shape[0]
    return int(
        seq.size                      # uint8 on the device
        + m * (2 * 4 + 4 + 4)         # props f32, target f32, graph_idx i32
        + g.node_onehot.size          # uint8 on the device
        + g.coords.size * 4
        + g.edge_src.size * 4 + g.edge_dst.size * 4
        + g.edge_mask.size + g.node_mask.size
        + g.num_nodes.size * 4)


def indexed_device(device) -> torch.device:
    """``device`` with its index made explicit (the current CUDA device for
    a bare 'cuda'), so that 'cuda' and 'cuda:0' name one device."""
    device = torch.device(device)
    if device.index is not None:
        return device
    index = torch.cuda.current_device() if device.type == "cuda" else 0
    return torch.device(device.type, index)


def build_device_corpus(ds: ImmunoDataset, *, binary: bool, full: bool,
                        device="cuda") -> DeviceCorpus:
    """The dataset's corpus on ``device``. The large fields are cached per
    (dataset, full, device); the [M] target, the one field that depends on
    ``binary``, is uploaded per call, so stages that flip ``binary`` share
    one upload."""
    device = indexed_device(device)
    cache_key = (bool(full), device.type, device.index)
    per_ds = _corpus_cache_for(ds)
    base = per_ds.get(cache_key)
    if base is None:
        base = _build_device_corpus(ds, binary=binary, full=full,
                                    device=device)
        per_ds[cache_key] = base
    target = ds.immuno if binary else ds.foreign_norm
    return dataclasses.replace(
        base, target=to_device(target, torch.float32, device))


def _build_device_corpus(ds: ImmunoDataset, *, binary: bool, full: bool,
                         device: torch.device) -> DeviceCorpus:
    seq = ds.seq_full if full else ds.seq_pep
    target = ds.immuno if binary else ds.foreign_norm
    g = ds.graphs

    def put(a, dtype):
        return to_device(a, dtype, device)

    return DeviceCorpus(
        seq=put(seq, torch.uint8),
        # a clinical dataset's props hold NaNs; its zero-filled copy runs
        props=put(getattr(ds, "props_filled", ds.props), torch.float32),
        target=put(target, torch.float32),
        graph_idx=put(ds.graph_idx, torch.int32),
        node_onehot=put(g.node_onehot, torch.uint8),
        coords=put(g.coords, torch.float32),
        edge_src=put(g.edge_src, torch.int32),
        edge_dst=put(g.edge_dst, torch.int32),
        edge_mask=put(g.edge_mask, torch.bool),
        node_mask=put(g.node_mask, torch.bool),
        num_nodes=put(g.num_nodes, torch.int32),
    )


def gather_batch(corpus: DeviceCorpus, rows: torch.Tensor) -> SampleBatch:
    """[B] row indices (on the corpus's device) -> a SampleBatch there,
    with the host pipeline's dtypes: one-hots f32, ``edge_feat`` ones
    [B, E, 1] f32, int32 indices, bool masks."""
    gi = corpus.graph_idx.index_select(0, rows)

    def graphs(t):
        return t.index_select(0, gi)

    graph = GraphBatch(
        node_feat=graphs(corpus.node_onehot).to(torch.float32),
        coords=graphs(corpus.coords),
        edge_src=graphs(corpus.edge_src),
        edge_dst=graphs(corpus.edge_dst),
        edge_feat=torch.ones((rows.shape[0], corpus.edge_src.shape[1], 1),
                             dtype=torch.float32, device=rows.device),
        edge_mask=graphs(corpus.edge_mask),
        node_mask=graphs(corpus.node_mask),
        num_nodes=graphs(corpus.num_nodes),
    )
    return SampleBatch(
        graph=graph,
        seq_onehot=corpus.seq.index_select(0, rows).to(torch.float32),
        props=corpus.props.index_select(0, rows),
        target=corpus.target.index_select(0, rows),
        aux_residue=None)


def _with_aux(s: SampleBatch, aux: torch.Tensor) -> SampleBatch:
    return SampleBatch(graph=s.graph, seq_onehot=s.seq_onehot, props=s.props,
                       target=s.target, aux_residue=aux)


class DevicePipeline:
    """A ``BatchPipeline``-compatible epoch iterator over a device-resident
    corpus, yielding ``SampleBatch``es on ``device`` (``config.device`` by
    default).

    ``pad_final_batch`` (default: on for the train split) fills a partial
    trailing batch with rows from the start of the epoch's order.
    Configurations that augment need ``device_augment=True``; each train
    step then draws from a ``torch.Generator`` on the device seeded from
    (seed, epoch, step)."""

    def __init__(self, dataset: ImmunoDataset, indices: np.ndarray, *,
                 split: str, binary: bool, full: bool, config,
                 ssl: bool = False, shuffle: Optional[bool] = None,
                 batch_size: Optional[int] = None, extend_to: int = 0,
                 pad_final_batch: Optional[bool] = None, device=None,
                 device_augment: bool = False):
        # padding duplicates samples, which is fine for SGD but would bias
        # eval metrics: on by default for the train split only
        if pad_final_batch is None:
            pad_final_batch = split == "train"
        # only transforms that reach the model need device_augment: graph
        # rotation and masking apply on the SSL path or when forced (the
        # host pipeline's rule, data/pipeline.py), sequence masking only to
        # full-chain inputs
        wants_augment = (ssl or config.force_graph_augmentation
                         or (config.sequence_pad_count > 0 and full))
        if wants_augment and not device_augment:
            raise ValueError(
                "this configuration needs train-time augmentation; pass "
                "device_augment=True (torch.Generator transforms on the "
                "device) or use the host BatchPipeline")
        self.ds = dataset
        self.ssl = ssl
        self.device_augment = device_augment and wants_augment
        self.maskable_len = dataset.seq_full.shape[1] - dataset.seq_pep.shape[1]
        self.binary = binary
        self.full = full
        self.device = indexed_device(config.device if device is None
                                     else device)
        self.corpus = build_device_corpus(dataset, binary=binary, full=full,
                                          device=self.device)
        self.indices = np.asarray(indices, np.int64)
        if extend_to and len(self.indices) < extend_to:
            reps = int(np.ceil(extend_to / len(self.indices)))
            self.indices = np.tile(self.indices, reps)[:extend_to]
        self.config = config
        self.split = split
        self.batch_size = batch_size or config.batch_size
        self.shuffle = (split == "train") if shuffle is None else shuffle
        self.pad_final_batch = pad_final_batch
        self._epoch = 0

    def __len__(self):
        return int(np.ceil(len(self.indices) / self.batch_size))

    def _augment_kw(self) -> dict:
        # graph transforms reach the model on the SSL path only, unless
        # forced (the host pipeline's rule)
        graph_augment = self.ssl or self.config.force_graph_augmentation
        return dict(
            ssl=self.ssl,
            structure_pad_count=(self.config.structure_pad_count
                                 if graph_augment else 0),
            sequence_pad_count=(self.config.sequence_pad_count
                                if self.full else 0),
            maskable_len=self.maskable_len, rotate=graph_augment)

    def _generator(self, epoch: int, step: int) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(derived_seed(self.config.seed, epoch, step))
        return gen

    def _maybe_augment(self, batch: SampleBatch, epoch: int,
                       step: int) -> SampleBatch:
        if self.split != "train":
            if self.ssl:
                # val/test SSL passes the no-op sentinel (train_SSL.py:46)
                return _with_aux(batch, torch.full(
                    (batch.target.shape[0],), -1, dtype=torch.int32,
                    device=self.device))
            return batch
        if not self.device_augment:
            return batch
        return augment_batch(batch, self._generator(epoch, step),
                             **self._augment_kw())

    def _epoch_rows(self, epoch: int):
        """The epoch's batches of rows, uploaded in one copy: a list of
        [B] int32 slices of one device tensor."""
        rng = np.random.default_rng((self.config.seed, epoch, 0x5eed))
        order = rng.permutation(len(self.indices)) if self.shuffle \
            else np.arange(len(self.indices))
        idx = self.indices[order]
        batches = []
        for start in range(0, len(idx), self.batch_size):
            rows = idx[start:start + self.batch_size]
            if self.pad_final_batch and len(rows) < self.batch_size:
                fill = np.resize(idx, self.batch_size - len(rows))
                rows = np.concatenate([rows, fill])
            batches.append(rows)
        if not batches:
            return []
        flat = to_device(np.concatenate(batches), torch.int32, self.device)
        bounds = np.cumsum([0] + [len(r) for r in batches]).tolist()
        return [flat[a:b] for a, b in zip(bounds[:-1], bounds[1:])]

    def epoch(self, epoch_idx: Optional[int] = None) -> Iterator[SampleBatch]:
        e = self._epoch if epoch_idx is None else epoch_idx
        self._epoch = e + 1
        for step, rows in enumerate(self._epoch_rows(e)):
            yield self._maybe_augment(gather_batch(self.corpus, rows), e, step)

    def __iter__(self):
        return self.epoch()


class ComparativeDevicePipeline(DevicePipeline):
    """The paired cancer/WT device pipeline, yielding ``ComparativeBatch``es:
    the same rows on both twins, the WT twin scored against the cancer
    side's target (immmunopred_dataloader.py:279-285)."""

    def __init__(self, dataset: ComparativeDataset, indices: np.ndarray,
                 **kw):
        if not isinstance(dataset, ComparativeDataset):
            raise TypeError("ComparativeDevicePipeline needs a "
                            f"ComparativeDataset, got {type(dataset).__name__}")
        super().__init__(dataset.cancer, indices, **kw)
        self.wt = dataset.wt
        self.corpus_wt = build_device_corpus(dataset.wt, binary=self.binary,
                                             full=self.full,
                                             device=self.device)

    def _maybe_augment(self, batch: ComparativeBatch, epoch: int,
                       step: int) -> ComparativeBatch:
        if self.split != "train":
            if self.ssl:
                sentinel = torch.full((batch.cancer.target.shape[0],), -1,
                                      dtype=torch.int32, device=self.device)
                return ComparativeBatch(cancer=_with_aux(batch.cancer, sentinel),
                                        wt=_with_aux(batch.wt, sentinel))
            return batch
        if not self.device_augment:
            return batch
        return augment_comparative(batch, self._generator(epoch, step),
                                   **self._augment_kw())

    def epoch(self, epoch_idx: Optional[int] = None):
        e = self._epoch if epoch_idx is None else epoch_idx
        self._epoch = e + 1
        for step, rows in enumerate(self._epoch_rows(e)):
            cancer = gather_batch(self.corpus, rows)
            wt = gather_batch(self.corpus_wt, rows)
            wt.target = cancer.target
            yield self._maybe_augment(
                ComparativeBatch(cancer=cancer, wt=wt), e, step)
