"""The PyTorch port's data layer (immunostruct_tpu_torch/data/*,
procedures/metrics.py, the collapse guard, utils/checkpoint.py) against the
JAX package's, on the CPU.

The JAX package writes a seeded synthetic corpus; both packages read it.
Everything here is numpy on both sides, so the comparisons are exact:
the same arrays, batches, metric values and checkpoints, bit for bit
(float metrics to 1e-12, the order of a sum being the only difference).
"""

import csv
import dataclasses
import hashlib
import os

import jax
import numpy as np
import pytest
import torch

from immunostruct_tpu.config import Config as JaxConfig
from immunostruct_tpu.data.dataset import ImmunoDataset as JaxDataset
from immunostruct_tpu.data.dataset import seeded_split as jax_seeded_split
from immunostruct_tpu.data.pipeline import BatchPipeline as JaxPipeline
from immunostruct_tpu.data.synthetic import (
    synthetic_corpus as jax_synthetic_corpus,
)
from immunostruct_tpu.models import build_model as jax_build_model
from immunostruct_tpu.procedures import metrics as jax_metrics
from immunostruct_tpu.procedures.train import CollapseGuard as JaxGuard
from immunostruct_tpu.utils import checkpoint as jax_checkpoint
from immunostruct_tpu_torch.config import Config
from immunostruct_tpu_torch.data import tables
from immunostruct_tpu_torch.data.dataset import ImmunoDataset, seeded_split
from immunostruct_tpu_torch.data.encoding import one_hot_encode_batch
from immunostruct_tpu_torch.data.pipeline import BatchPipeline, prefetch
from immunostruct_tpu_torch.data.synthetic import synthetic_corpus
from immunostruct_tpu_torch.models import build_model
from immunostruct_tpu_torch.procedures import metrics
from immunostruct_tpu_torch.procedures.train import CollapseGuard
from immunostruct_tpu_torch.utils import checkpoint
from immunostruct_tpu_torch.utils.checkpoint import jax_params

SMALL = dict(gcn_layers=1, gat_hidden_channels=16, vae_hidden_dim=32,
             vae_latent_dim=8)
GRAPH_FIELDS = ("node_onehot", "coords", "edge_src", "edge_dst", "edge_mask",
                "node_mask", "num_nodes")
DATASET_ARRAYS = ("seq_full", "seq_pep", "props", "immuno", "foreign_norm",
                  "graph_idx", "pep_len")


def _read(path, delimiter):
    with open(path, newline="") as fh:
        return list(csv.reader(fh, delimiter=delimiter))


@pytest.mark.parametrize("signal", ["none", "planted", "geometric"])
def test_synthetic_corpus_matches_jax(tmp_path, signal):
    """One seed: the same graph files (every array and name) and the same
    tables, cell for cell."""
    kw = dict(num_samples=10, hla_len=20, seed=7,
              planted_signal=signal == "planted",
              geometric_signal=signal == "geometric")
    jax_out = jax_synthetic_corpus(str(tmp_path / "jax"), **kw)
    port_out = synthetic_corpus(str(tmp_path / "port"), **kw)
    jg, jp, jh = jax_out
    pg, pp, ph = port_out
    files = sorted(os.listdir(jg))
    assert files == sorted(os.listdir(pg)) and len(files) == 10
    for name in files:
        with np.load(os.path.join(jg, name)) as a, \
                np.load(os.path.join(pg, name)) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype, (name, k)
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert _read(jp, "\t") == _read(pp, "\t")
    assert _read(jh, ",") == _read(ph, ",")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A JAX-written corpus whose table also holds a duplicated pep_pair
    (its later row wins) and a row with a NaN Foreignness_Score (dropped)."""
    root = str(tmp_path_factory.mktemp("corpus"))
    graph_dir, props, hla = jax_synthetic_corpus(root, num_samples=24,
                                                 hla_len=20, seed=5)
    rows = _read(props, "\t")
    head, body = rows[0], rows[1:]
    dup = list(body[3])
    dup[head.index("immunogenicity")] = str(1 - int(dup[head.index(
        "immunogenicity")]))
    dup[head.index("smoothed_foreign")] = "0.123"
    nan_row = list(body[5])
    nan_row[head.index("Foreignness_Score")] = "NaN"
    nan_row[head.index("peptide")] = "ACDEFGHIK"
    with open(props, "w", newline="") as fh:
        w = csv.writer(fh, delimiter="\t", lineterminator="\n")
        w.writerows([head, *body, dup, nan_row])
    return graph_dir, props, hla


def _configs(**kw):
    return JaxConfig(**kw), Config(device="cpu", **kw)


def test_dataset_load_matches_jax(corpus):
    jcfg, cfg = _configs()
    want = JaxDataset.load(jcfg, *corpus)
    got = ImmunoDataset.load(cfg, *corpus)
    assert len(got) == len(want) == 24
    for k in DATASET_ARRAYS:
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    for k in GRAPH_FIELDS:
        np.testing.assert_array_equal(getattr(got.graphs, k),
                                      getattr(want.graphs, k), err_msg=k)
    assert got.class_weights == want.class_weights
    assert (got.foreign_min, got.foreign_max) == (want.foreign_min,
                                                  want.foreign_max)
    assert got.raw_chain == want.raw_chain
    # the duplicated pep_pair's later row wins
    f_dict, _, _, pairs = tables.parse_property_table(corpus[1])
    assert len(pairs) == 25 and len(set(pairs)) == 24
    assert f_dict[pairs[-1]] == 0.123


def test_nan_smoothed_foreign_raises_in_both(tmp_path):
    graph_dir, props, hla = jax_synthetic_corpus(str(tmp_path), num_samples=8,
                                                 hla_len=20, seed=2)
    rows = _read(props, "\t")
    rows[2][rows[0].index("smoothed_foreign")] = "nan"
    with open(props, "w", newline="") as fh:
        csv.writer(fh, delimiter="\t", lineterminator="\n").writerows(rows)
    jcfg, cfg = _configs()
    with pytest.raises(ValueError, match="NaN"):
        JaxDataset.load(jcfg, graph_dir, props, hla)
    with pytest.raises(ValueError, match="NaN"):
        ImmunoDataset.load(cfg, graph_dir, props, hla)


def test_missing_value_tokens_and_hash():
    assert np.isnan(tables.to_number("NA")) and np.isnan(tables.to_number(""))
    assert tables.to_number("0.5") == 0.5
    assert tables.get_hash("ACDE") == hashlib.sha1(b"ACDE").hexdigest()
    enc = one_hot_encode_batch(["ACD", "A"], 4)
    assert enc.shape == (2, 4, 21) and (enc.sum(-1) == 1).all()


@pytest.mark.parametrize("n", [24, 25, 101])
def test_seeded_split_matches_jax(n):
    for got, want in zip(seeded_split(n, (0.8, 0.1, 0.1), 3),
                         jax_seeded_split(n, (0.8, 0.1, 0.1), 3)):
        np.testing.assert_array_equal(got, want)


_BATCH_FIELDS = {
    "node_feat": ("graph", "node_feat"), "coords": ("graph", "coords"),
    "edge_src": ("graph", "edge_src"), "edge_dst": ("graph", "edge_dst"),
    "edge_feat": ("graph", "edge_feat"), "edge_mask": ("graph", "edge_mask"),
    "node_mask": ("graph", "node_mask"), "num_nodes": ("graph", "num_nodes"),
    "seq_onehot": (None, "seq_onehot"), "props": (None, "props"),
    "target": (None, "target"), "aux_residue": (None, "aux_residue"),
}


def _field(batch, path):
    obj = batch if path[0] is None else getattr(batch, path[0])
    v = getattr(obj, path[1])
    if v is None:
        return None
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


@pytest.mark.parametrize("mode", ["plain", "augmented", "ssl"])
def test_batch_pipeline_is_bit_identical(corpus, mode):
    """Two epochs of the train split (shuffled, a partial last batch) give
    the same batches as the JAX pipeline, augmentations included."""
    kw = dict(batch_size=5, seed=4)
    if mode != "plain":
        kw.update(sequence_pad_count=3, structure_pad_count=2,
                  force_graph_augmentation=True)
    jcfg, cfg = _configs(**kw)
    jds, ds = JaxDataset.load(jcfg, *corpus), ImmunoDataset.load(cfg, *corpus)
    idx = seeded_split(len(ds), (0.8, 0.1, 0.1), 4)[0]
    ssl = mode == "ssl"
    opts = dict(split="train", binary=mode != "plain", full=True, ssl=ssl)
    jpipe = JaxPipeline(jds, idx, config=jcfg, **opts)
    pipe = BatchPipeline(ds, idx, config=cfg, **opts)
    assert len(pipe) == len(jpipe) == 4
    for epoch in range(2):
        jb, pb = list(jpipe.epoch(epoch)), list(prefetch(pipe.epoch(epoch)))
        assert len(jb) == len(pb) == 4
        for a, b in zip(pb, jb):
            for name, path in _BATCH_FIELDS.items():
                got, want = _field(a, path), _field(b, path)
                if want is None:
                    assert got is None, name
                    continue
                assert got.shape == want.shape, name
                np.testing.assert_array_equal(got, want.astype(got.dtype),
                                              err_msg=name)
    # the epochs differ (shuffle and augmentation draws)
    first, second = (next(pipe.epoch(e)) for e in (0, 1))
    assert not torch.equal(first.target, second.target) or not torch.equal(
        first.graph.coords, second.graph.coords)


def test_prefetch_raises_the_producers_error():
    def boom():
        yield 1
        raise KeyError("producer")

    got = []
    with pytest.raises(KeyError, match="producer"):
        for item in prefetch(boom()):
            got.append(item)
    assert got == [1]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_match_jax(seed):
    rng = np.random.default_rng(seed)
    y = (rng.random(60) < 0.4).astype(np.float32)
    p = np.clip(0.3 * y + 0.7 * rng.random(60), 0, 1).astype(np.float32)
    p[:5] = p[5:10]                                    # ties
    t = metrics.find_optimal_threshold(y, p)
    assert t == jax_metrics.find_optimal_threshold(y, p)
    for thr in (t, 0.5):
        got = metrics.evaluate_metrics(y, p, thr, verbose=False)
        want = jax_metrics.evaluate_metrics(y, p, thr, verbose=False)
        assert sorted(got) == sorted(want) and len(got) == 15
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-12,
                                       atol=1e-12, err_msg=k)


@pytest.mark.parametrize("aucs", [
    [0.5] * 20,
    [0.9, 0.52, 0.48, 0.5, 0.51, 0.5, 0.55, 0.49, 0.5, 0.5, 0.53, 0.47, 0.5,
     0.6, 0.5, 0.5, 0.52, 0.5, 0.5, 0.5],
    [0.8] * 20,
])
def test_collapse_guard_fires_at_the_same_epoch(aucs):
    def first_fire(guard):
        return next((e for e, a in enumerate(aucs) if guard.observe(e, a)),
                    None)

    assert first_fire(CollapseGuard()) == first_fire(JaxGuard())


def _jax_model_params(seed):
    _, params = jax_build_model("HybridModelv2", 6 * 21, jax.random.key(seed),
                                **SMALL)
    return params


def _port_model(seed):
    _, model = build_model("HybridModelv2", 6 * 21,
                           torch.Generator().manual_seed(seed), **SMALL)
    return model


def test_port_checkpoint_loads_in_jax(tmp_path):
    model = _port_model(3)
    path = str(tmp_path / "port.ckpt")
    checkpoint.save_checkpoint(path, model)
    like = _jax_model_params(0)
    loaded = jax_checkpoint.load_checkpoint(path, like, verbose=False)
    want = jax_params(model)
    flat = dict(jax.tree_util.tree_flatten_with_path(loaded)[0])
    assert len(flat) == len(want)
    for kpath, leaf in flat.items():
        key = jax.tree_util.keystr(kpath)
        np.testing.assert_array_equal(np.asarray(leaf), want[key],
                                      err_msg=key)


def test_jax_checkpoint_loads_in_the_port_and_round_trips(tmp_path):
    params = _jax_model_params(4)
    jpath, ppath = str(tmp_path / "jax.ckpt"), str(tmp_path / "port.ckpt")
    jax_checkpoint.save_checkpoint(jpath, params)
    model = checkpoint.load_checkpoint(jpath, _port_model(0), verbose=False)
    checkpoint.save_checkpoint(ppath, model)
    with np.load(jpath) as a, np.load(ppath) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_resume_snapshot_round_trips(tmp_path):
    from immunostruct_tpu_torch.procedures.train import (
        Trainer, make_optimizer,
    )
    from immunostruct_tpu_torch.utils.losses import LossConfig
    from immunostruct_tpu_torch.utils.schedule import constant_lr

    model = _port_model(1)
    trainer = Trainer(model.spec, LossConfig(6 * 21, pos_weight=1.0),
                      binary=True,
                      optimizer=make_optimizer("adam", constant_lr(1e-3)),
                      aggregation="scatter", compute_dtype=torch.float32)
    state = trainer.init_state(model, torch.Generator().manual_seed(2))
    state.step = 7
    path = str(tmp_path / "snap.resume")
    checkpoint.save_resume_state(path, state, epoch=3, best_val=0.25)
    other = trainer.init_state(_port_model(9), torch.Generator().manual_seed(2))
    restored, next_epoch, best = checkpoint.load_resume_state(path, other)
    assert (next_epoch, best, restored.step) == (4, 0.25, 7)
    for (k, a), b in zip(model.state_dict().items(),
                         restored.model.state_dict().values()):
        assert torch.equal(a, b), k
    assert checkpoint.load_resume_state(str(tmp_path / "none"), other) is None


def test_config_paths_match_jax():
    kw = dict(model="HybridModelv2", num_epochs=3, batch_size=8, seed=2,
              full_sequence=True, model_save_dir="/ckpt")
    jcfg, cfg = _configs(**kw)
    jcfg.derive_paths("tag")
    cfg.derive_paths("tag")
    for k in ("model_save_path_pretrain", "model_save_path_finetune",
              "fig_save_folder"):
        assert getattr(cfg, k) == getattr(jcfg, k)
    jax_fields = {f.name for f in dataclasses.fields(JaxConfig)}
    port_fields = {f.name for f in dataclasses.fields(Config)}
    assert jax_fields - port_fields == {
        "param_dtype", "mesh_shape", "donate_state"}
    assert port_fields - jax_fields == {"device"}
