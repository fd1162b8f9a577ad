"""The PyTorch port's device-resident corpus (``data/device_pipeline.py``),
its device augmentation (``data/device_augment.py``) and ``--device-data``
(``cli/common.py::pick_pipeline``) against the JAX package's, on the CPU.

One JAX-written corpus (16 samples, 20-residue HLA chains; 10 cancer/WT
pairs) is read by both packages. Without augmentation everything is a row
gather and a cast, so the comparisons are exact: the port's device batches
equal the JAX package's device batches and the port's host batches, bit
for bit. The augmentation cores are fed the JAX package's own
``jax.random`` draws (with its key splits): the masks and classes equal
its, bit for bit; the rotated coordinates agree within 1e-6 *
max|coords| (a quaternion normalized and multiplied in another order).
The port's own draws come from a ``torch.Generator``, so an augmented
epoch is the JAX package's only in distribution; here it must be the same
bits for one seed and other draws for another step.
"""

import copy
import dataclasses
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from immunostruct_tpu.cli import train_IEDB_wFT as jax_train_IEDB
from immunostruct_tpu.config import Config as JaxConfig
from immunostruct_tpu.data import device_augment as jaug
from immunostruct_tpu.data.dataset import (
    ComparativeDataset as JaxComparativeDataset,
)
from immunostruct_tpu.data.dataset import ImmunoDataset as JaxDataset
from immunostruct_tpu.data.device_pipeline import (
    ComparativeDevicePipeline as JaxComparativeDevicePipeline,
)
from immunostruct_tpu.data.device_pipeline import (
    DevicePipeline as JaxDevicePipeline,
)
from immunostruct_tpu.data.synthetic import (
    synthetic_comparative_corpus as jax_comparative_corpus,
    synthetic_corpus as jax_synthetic_corpus,
)
from immunostruct_tpu.structs import ComparativeBatch as JaxComparativeBatch
from immunostruct_tpu.structs import GraphBatch as JaxGraphBatch
from immunostruct_tpu.structs import SampleBatch as JaxSampleBatch
from immunostruct_tpu_torch.cli import train_IEDB_wFT
from immunostruct_tpu_torch.cli.common import pick_pipeline
from immunostruct_tpu_torch.config import Config
from immunostruct_tpu_torch.data import device_augment as aug
from immunostruct_tpu_torch.data import device_pipeline as dp
from immunostruct_tpu_torch.data.dataset import (
    ComparativeDataset, ImmunoDataset,
)
from immunostruct_tpu_torch.data.pipeline import (
    BatchPipeline, ComparativePipeline,
)
from immunostruct_tpu_torch.structs import ComparativeBatch, SampleBatch
from tests.torch_threads import one_torch_thread  # noqa: F401

GRAPH = ("node_feat", "coords", "edge_src", "edge_dst", "edge_feat",
         "edge_mask", "node_mask", "num_nodes")
KW = dict(batch_size=6, pad_nodes_multiple=4, pad_edges_multiple=16,
          seed=3, full_sequence=True)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("devdata"))
    iedb = jax_synthetic_corpus(root, num_samples=16, hla_len=20, seed=71)
    comp = jax_comparative_corpus(root, num_samples=10, hla_len=20, seed=72,
                                  shared_hla_path=iedb[2])
    return iedb, comp


@pytest.fixture(scope="module")
def datasets(corpus):
    (g, p, h), (dc, dw, pc, pw, hp) = corpus
    jcfg, cfg = JaxConfig(**KW), Config(device="cpu", **KW)
    return dict(
        jax=(jcfg, JaxDataset.load(jcfg, g, p, h),
             JaxComparativeDataset.load(jcfg, dc, dw, pc, pw, hp)),
        port=(cfg, ImmunoDataset.load(cfg, g, p, h),
              ComparativeDataset.load(cfg, dc, dw, pc, pw, hp)))


def _arrays(batch) -> dict:
    """Every field of a (JAX or port) sample batch as numpy."""
    out = {k: np.asarray(getattr(batch.graph, k)) for k in GRAPH}
    for k in ("seq_onehot", "props", "target", "aux_residue"):
        v = getattr(batch, k)
        out[k] = None if v is None else np.asarray(v)
    return out


def _assert_same(a, b):
    if isinstance(a, (ComparativeBatch, JaxComparativeBatch)):
        _assert_same(a.cancer, b.cancer)
        _assert_same(a.wt, b.wt)
        return
    x, y = _arrays(a), _arrays(b)
    for k in x:
        if x[k] is None or y[k] is None:
            assert x[k] is None and y[k] is None, k
            continue
        assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape, k
        np.testing.assert_array_equal(x[k], y[k], err_msg=k)


CASES = {
    "val": dict(split="val"),
    "train_padded": dict(split="train"),
    "train_unpadded": dict(split="train", pad_final_batch=False),
    "extend_to": dict(split="train", extend_to=20),
    "ssl_val": dict(split="val", ssl=True, device_augment=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("comparative", [False, True],
                         ids=["single", "comparative"])
def test_epochs_match_jax_and_the_host_pipeline(datasets, case, comparative):
    """Two epochs of the device pipeline: JAX's device batches and the
    port's host batches (with the same trailing padding), bit for bit."""
    kw = dict(binary=case != "val", full=True, **CASES[case])
    jcfg, jds, jcomp = datasets["jax"]
    cfg, ds, comp = datasets["port"]
    if comparative:
        jpipe = JaxComparativeDevicePipeline(jcomp, np.arange(10),
                                             config=jcfg, **kw)
        pipe = dp.ComparativeDevicePipeline(comp, np.arange(10), config=cfg,
                                            **kw)
        host_cls, host_ds, n = ComparativePipeline, comp, 10
    else:
        jpipe = JaxDevicePipeline(jds, np.arange(16), config=jcfg, **kw)
        pipe = dp.DevicePipeline(ds, np.arange(16), config=cfg, **kw)
        host_cls, host_ds, n = BatchPipeline, ds, 16
    host = host_cls(host_ds, np.arange(n), config=cfg,
                    pad_final_batch=pipe.pad_final_batch,
                    **{k: v for k, v in kw.items()
                       if k not in ("pad_final_batch", "device_augment")})
    assert len(pipe) == len(jpipe) == len(host)
    for epoch in (0, 1):
        got = list(pipe.epoch(epoch))
        want = list(jpipe.epoch(epoch))
        hosted = list(host.epoch(epoch))
        assert len(got) == len(want) == len(hosted) == len(pipe)
        for a, b, c in zip(got, want, hosted):
            _assert_same(a, b)
            _assert_same(a, c)


# -- the transform cores against JAX's, on JAX's draws -----------------------

def _onehots(rng, b, n, real, c=20):
    """[B, N, 20] one-hots with ``real[i]`` real rows (the rest padding)."""
    x = np.zeros((b, n, c), np.float32)
    for i in range(b):
        x[i, np.arange(real[i]), rng.integers(0, 5, real[i])] = 1.0
    return x


def _coords_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_rotation_core_matches_jax():
    key = jax.random.key(0)
    q = np.array(jax.random.normal(key, (5, 4)))
    want = np.asarray(jaug.random_rotations(key, 5))
    got = aug.rotations(torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    for r in got:
        np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-5)
    coords = np.random.default_rng(0).standard_normal((5, 7, 3)).astype(
        np.float32) * 30
    _coords_close(aug.rotate_coords(torch.from_numpy(coords),
                                    torch.from_numpy(q)),
                  jnp.einsum("bnc,bcd->bnd", coords, want))


def test_ssl_mask_single_core_matches_jax():
    """One masked row a graph with a real residue, its class; a graph
    without one (all -inf scores) keeps its rows and gets class 0."""
    rng = np.random.default_rng(1)
    onehot = _onehots(rng, 6, 10, [3, 10, 0, 7, 1, 5])
    for seed in range(3):
        key = jax.random.key(seed)
        want_m, want_c = jaug.ssl_mask_single(key, jnp.asarray(onehot))
        g = np.array(jax.random.gumbel(key, (6, 10)))
        got_m, got_c = aug.ssl_mask_single(torch.from_numpy(onehot),
                                           torch.from_numpy(g))
        np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
        assert got_c.dtype == torch.int32
        assert (got_m.numpy()[2] == 0).all() and int(got_c[2]) == 0


def test_ssl_mask_paired_core_matches_jax():
    """Same-class masks in both twins; with no common class neither twin
    is masked and the class is 0."""
    rng = np.random.default_rng(2)
    oc = _onehots(rng, 4, 8, [6, 6, 3, 0])
    ow = _onehots(rng, 4, 8, [6, 2, 5, 4])
    oc[1], ow[1] = 0.0, 0.0
    oc[1, :4, 0], ow[1, :4, 5] = 1.0, 1.0          # no common class
    for seed in range(3):
        key = jax.random.key(10 + seed)
        want = jaug.ssl_mask_paired(key, jnp.asarray(oc), jnp.asarray(ow))
        k_pick, k_w = jax.random.split(key)
        gc_ = np.array(jax.random.gumbel(k_pick, (4, 8)))
        gw = np.array(jax.random.gumbel(k_w, (4, 8)))
        got = aug.ssl_mask_paired(torch.from_numpy(oc), torch.from_numpy(ow),
                                  torch.from_numpy(gc_), torch.from_numpy(gw))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert int(got[2][1]) == 0 and (got[0].numpy()[1].sum(-1) <= 1).all()


def test_structure_and_sequence_mask_cores_match_jax():
    rng = np.random.default_rng(3)
    onehot = _onehots(rng, 3, 12, [12, 8, 4])
    onehot[:, 2] = 1.0                              # SSL-masked rows stay
    seq = np.zeros((3, 14, 21), np.float32)
    seq[:, :, 0] = 1.0
    for seed, count in ((0, 3), (1, 12)):
        key = jax.random.key(20 + seed)
        noise = torch.from_numpy(np.array(jax.random.uniform(key, (3, 12))))
        got = aug.structure_mask(torch.from_numpy(onehot), noise, count)
        want = jaug.structure_mask(key, jnp.asarray(onehot), count)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert (got.numpy()[:, 2].sum(-1) == 20).all()
        noise = torch.from_numpy(np.array(jax.random.uniform(key, (3, 9))))
        got = aug.sequence_mask(torch.from_numpy(seq), noise, min(count, 9))
        want = jaug.sequence_mask(key, jnp.asarray(seq), 9, min(count, 9))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert ((got.numpy()[:, :, 20] == 1).sum(-1) == min(count, 9)).all()
        assert (got.numpy()[:, 9:, 0] == 1).all()


def _sample_arrays(rng, b=4, n=10, e=24, l=14):
    onehot = _onehots(rng, b, n, [10, 6, 0, 3])
    return dict(
        node_feat=onehot,
        coords=(rng.standard_normal((b, n, 3)) * 20).astype(np.float32),
        edge_src=rng.integers(0, n, (b, e)).astype(np.int32),
        edge_dst=rng.integers(0, n, (b, e)).astype(np.int32),
        edge_feat=np.ones((b, e, 1), np.float32),
        edge_mask=rng.random((b, e)) > 0.2,
        node_mask=onehot.sum(-1) > 0,
        num_nodes=(onehot.sum(-1) > 0).sum(1).astype(np.int32),
        seq_onehot=np.eye(21, dtype=np.float32)[rng.integers(0, 20, (b, l))],
        props=rng.random((b, 2)).astype(np.float32),
        target=(rng.random(b) > 0.5).astype(np.float32))


def _both(arrays):
    jgraph = JaxGraphBatch(**{k: jnp.asarray(arrays[k]) for k in GRAPH})
    jbatch = JaxSampleBatch(graph=jgraph,
                            seq_onehot=jnp.asarray(arrays["seq_onehot"]),
                            props=jnp.asarray(arrays["props"]),
                            target=jnp.asarray(arrays["target"]),
                            aux_residue=None)
    return jbatch, SampleBatch.from_numpy(arrays, "cpu")


def _assert_augmented(got, want):
    """Masks, classes and the untouched fields bit for bit; coordinates
    within 1e-6 * max|coords|."""
    _coords_close(got.graph.coords, want.graph.coords)
    got = dataclasses.replace(got, graph=dataclasses.replace(
        got.graph, coords=torch.from_numpy(np.array(want.graph.coords))))
    _assert_same(got, want)


FLAGS = {
    "all": dict(ssl=True, structure_pad_count=3, sequence_pad_count=4,
                rotate=True),
    "rotate_and_mask": dict(structure_pad_count=2, sequence_pad_count=2,
                            rotate=True),
    "ssl_only": dict(ssl=True),
}


@pytest.mark.parametrize("flags", sorted(FLAGS))
def test_augment_batch_matches_jax_on_its_draws(flags):
    flags = FLAGS[flags]
    arrays = _sample_arrays(np.random.default_rng(4))
    jbatch, batch = _both(arrays)
    key = jax.random.key(30)
    want = jaug.augment_batch(jbatch, key, maskable_len=9, **flags)
    k_rot, k_ssl, k_struct, k_seq = jax.random.split(key, 4)
    draws = {
        "rot": jax.random.normal(k_rot, (4, 4)),
        "ssl": jax.random.gumbel(k_ssl, (4, 10)),
        "structure": jax.random.uniform(k_struct, (4, 10)),
        "sequence": jax.random.uniform(k_seq, (4, 9)),
    }
    draws = {k: torch.tensor(np.asarray(v)) for k, v in draws.items()}
    got = aug.augment_batch_core(batch, draws, **flags)
    _assert_augmented(got, want)
    if flags.get("ssl"):
        assert int(got.aux_residue[2]) == 0        # the graph without a residue


@pytest.mark.parametrize("flags", sorted(FLAGS))
def test_augment_comparative_matches_jax_on_its_draws(flags):
    flags = FLAGS[flags]
    rng = np.random.default_rng(5)
    jc, c = _both(_sample_arrays(rng))
    jw, w = _both(_sample_arrays(rng))
    key = jax.random.key(40)
    want = jaug.augment_comparative(JaxComparativeBatch(cancer=jc, wt=jw),
                                    key, maskable_len=9, **flags)
    keys = jax.random.split(key, 6)
    k_pick, k_w = jax.random.split(keys[2])
    draws = {
        "rot_c": jax.random.normal(keys[0], (4, 4)),
        "rot_w": jax.random.normal(keys[1], (4, 4)),
        "ssl_c": jax.random.gumbel(k_pick, (4, 10)),
        "ssl_w": jax.random.gumbel(k_w, (4, 10)),
        "structure_c": jax.random.uniform(keys[3], (4, 10)),
        "structure_w": jax.random.uniform(keys[4], (4, 10)),
        "sequence": jax.random.uniform(keys[5], (4, 9)),
    }
    draws = {k: torch.tensor(np.asarray(v)) for k, v in draws.items()}
    got = aug.augment_comparative_core(ComparativeBatch(cancer=c, wt=w),
                                       draws, **flags)
    _assert_augmented(got.cancer, want.cancer)
    _assert_augmented(got.wt, want.wt)


def test_generator_draws_repeat_for_a_seed_and_differ_across_steps(
        datasets):
    cfg, ds, comp = datasets["port"]
    cfg = dataclasses.replace(cfg, self_supervision=True,
                              structure_pad_count=3, sequence_pad_count=4)
    pipe = dp.DevicePipeline(ds, np.arange(16), split="train", binary=True,
                             full=True, config=cfg, ssl=True,
                             device_augment=True)
    first, again = list(pipe.epoch(0)), list(pipe.epoch(0))
    for a, b in zip(first, again):
        _assert_same(a, b)
    nf = _arrays(first[0])["node_feat"]
    assert ((nf.sum(-1) == 20).sum(-1) == 1).all()  # one SSL row a graph
    assert first[0].aux_residue.dtype == torch.int32
    pair = dp.ComparativeDevicePipeline(comp, np.arange(10), split="train",
                                        binary=True, full=True, config=cfg,
                                        ssl=True, device_augment=True)
    for a, b in zip(pair.epoch(1), pair.epoch(1)):
        _assert_same(a, b)
    g1 = aug.uniforms(pipe._generator(0, 0), (8,))
    g2 = aug.uniforms(pipe._generator(0, 0), (8,))
    g3 = aug.uniforms(pipe._generator(0, 1), (8,))
    assert torch.equal(g1, g2) and not torch.equal(g1, g3)


def test_gumbel_draws_stay_finite():
    gen = torch.Generator().manual_seed(0)
    assert torch.isfinite(aug.gumbels(gen, (64, 4096))).all()


# -- what carries over from the JAX package's tests ---------------------------

def test_augmentation_needs_device_augment(datasets):
    cfg, ds, _ = datasets["port"]
    cfg2 = dataclasses.replace(cfg, sequence_pad_count=2)
    with pytest.raises(ValueError, match="device_augment"):
        dp.DevicePipeline(ds, np.arange(4), split="train", binary=True,
                          full=True, config=cfg2)
    with pytest.raises(ValueError, match="device_augment"):
        dp.DevicePipeline(ds, np.arange(4), split="train", binary=True,
                          full=True, config=cfg, ssl=True)


def test_pick_pipeline_auto_is_host_on_the_cpu_and_forced_is_device(
        datasets):
    cfg, ds, comp = datasets["port"]
    kw = dict(split="train", binary=True, full=True)
    auto = pick_pipeline(dataclasses.replace(cfg, device_data=None),
                         comparative=False, ssl=False)
    assert type(auto(ds, np.arange(8), config=cfg, **kw)) is BatchPipeline
    assert pick_pipeline(dataclasses.replace(cfg, device_data=False),
                         comparative=True, ssl=False) is ComparativePipeline
    forced = pick_pipeline(dataclasses.replace(cfg, device_data=True),
                           comparative=True, ssl=False)
    pipe = forced(comp, np.arange(8), config=cfg, **kw)
    assert type(pipe) is dp.ComparativeDevicePipeline
    assert pipe.pad_final_batch                   # explicit: pads, as JAX's
    ssl = pick_pipeline(dataclasses.replace(cfg, device_data=True),
                        comparative=False, ssl=True)
    assert ssl(ds, np.arange(8), config=cfg, ssl=True, **kw).device_augment


def test_corpus_is_shared_across_pipelines_and_binary_flips(datasets):
    _, ds, _ = datasets["port"]
    cfg = Config(device="cpu", **KW)
    a = dp.DevicePipeline(ds, np.arange(8), split="train", binary=True,
                          full=True, config=cfg, device=torch.device("cpu"))
    b = dp.DevicePipeline(ds, np.arange(8, 16), split="val", binary=True,
                          full=True, config=cfg, device="cpu")
    c = dp.DevicePipeline(ds, np.arange(8), split="train", binary=False,
                          full=True, config=cfg)
    assert a.corpus.node_onehot is b.corpus.node_onehot is c.corpus.node_onehot
    assert a.corpus.seq is b.corpus.seq
    assert c.corpus.target is not a.corpus.target
    assert not torch.equal(c.corpus.target, a.corpus.target)
    assert dp.indexed_device("cpu") == dp.indexed_device(torch.device("cpu:0"))


def test_corpus_cache_evicts_when_the_dataset_dies(datasets):
    cfg, ds, _ = datasets["port"]
    ghost = copy.copy(ds)
    dp.DevicePipeline(ghost, np.arange(8), split="train", binary=True,
                      full=True, config=cfg)
    key = id(ghost)
    assert key in dp._CORPUS_CACHE
    del ghost
    gc.collect()
    assert key not in dp._CORPUS_CACHE


def test_admitted_bytes_ledger(datasets):
    _, ds, _ = datasets["port"]
    base = dp.admitted_device_bytes()
    ghost = copy.copy(ds)
    dp.note_admitted(ghost, 123)
    dp.note_admitted(ghost, 456)          # noting again replaces
    assert dp.admitted_device_bytes() == base + 456
    del ghost
    gc.collect()
    assert dp.admitted_device_bytes() == base


@pytest.mark.parametrize("full", [True, False], ids=["full", "peptide"])
def test_estimate_equals_the_uploaded_bytes(datasets, full):
    from immunostruct_tpu.data.device_pipeline import (
        estimate_device_bytes as jax_estimate,
    )

    cfg, ds, comp = datasets["port"]
    _, jds, jcomp = datasets["jax"]
    corpus = dp.build_device_corpus(ds, binary=True, full=full, device="cpu")
    assert dp.estimate_device_bytes(ds, full=full) == corpus.nbytes()
    pair = (dp.build_device_corpus(comp.cancer, binary=True, full=full,
                                   device="cpu").nbytes()
            + dp.build_device_corpus(comp.wt, binary=True, full=full,
                                     device="cpu").nbytes())
    assert dp.estimate_device_bytes(comp, full=full) == pair
    assert dp.estimate_device_bytes(ds, full=full) == jax_estimate(jds,
                                                                   full=full)
    assert dp.estimate_device_bytes(comp, full=full) == jax_estimate(
        jcomp, full=full)


# -- the entry point -------------------------------------------------------------

def _plan(module, argv, monkeypatch):
    """``module.main`` with train_model, load_checkpoint and inference
    recording what they are given: per stage the pipelines' kinds, sizes
    and epoch-0 batches; per inference the pipeline's kind and batches."""
    rows = []

    def batches(pipe):
        return [_arrays(b) for b in pipe.epoch(0)]

    def train_model(config, *args, **kw):
        state, train_pipe, val_pipe = args[-4], args[-3], args[-2]
        rows.append(dict(stage=kw["stage"], binary=kw["binary"],
                         kinds=(type(train_pipe).__name__,
                                type(val_pipe).__name__),
                         sizes=(len(train_pipe), len(val_pipe)),
                         train=batches(train_pipe), val=batches(val_pipe)))
        return state, {}

    def load_checkpoint(path, model, *args, **kw):
        return model

    def inference(config, *args, **kw):
        pipe = args[-1]
        rows.append(dict(inference=pipe.split, kind=type(pipe).__name__,
                         batches=batches(pipe)))
        return {"optimal_threshold": 0.25}

    for name, fn in (("train_model", train_model),
                     ("load_checkpoint", load_checkpoint),
                     ("inference", inference)):
        monkeypatch.setattr(module, name, fn)
    module.main(argv)
    return rows


def _cli_args(corpus, save_dir, *extra):
    (g, p, h), _ = corpus
    return ["--model", "HybridModelv2", "--full-sequence", "--sequence-loss",
            "--compute-dtype", "float32", "--batch-size", "6",
            "--num-epochs", "2", "--seed", "1", "--aggregation", "scatter",
            "--model-save-dir", save_dir, "--graph-dir-IEDB", g,
            "--property-path-IEDB", p, "--hla-path", h, *extra]


def test_train_IEDB_wFT_device_data_matches_jax(corpus, tmp_path,
                                                 monkeypatch):
    """--device-data --device cpu: the same stage plan as the JAX
    package's --device-data run (device pipelines for train/val/test, the
    host pipeline for the threshold) and the same batches in every
    pipeline, bit for bit; then the port's run end to end (finite losses,
    both checkpoints)."""
    want = _plan(jax_train_IEDB, _cli_args(corpus, str(tmp_path / "j"),
                                           "--device-data"), monkeypatch)
    got = _plan(train_IEDB_wFT, _cli_args(corpus, str(tmp_path / "p"),
                                          "--device-data", "--device", "cpu"),
                monkeypatch)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            if k in ("train", "val", "batches"):
                assert len(g[k]) == len(w[k])
                for x, y in zip(g[k], w[k]):
                    for f in x:
                        if x[f] is None:
                            assert y[f] is None
                        else:
                            np.testing.assert_array_equal(x[f], y[f])
            else:
                assert g[k] == w[k], k
    assert [r.get("kinds", r.get("kind")) for r in got] == [
        ("DevicePipeline", "DevicePipeline"),
        ("DevicePipeline", "DevicePipeline"),
        "BatchPipeline", "DevicePipeline"]
    monkeypatch.undo()
    train_stats, test_stats = train_IEDB_wFT.main(
        _cli_args(corpus, str(tmp_path / "run"), "--device-data",
                  "--device", "cpu"))
    assert len(train_stats) == len(test_stats) == 15
    assert test_stats["optimal_threshold"] == train_stats["optimal_threshold"]
    assert sorted(p.name.rsplit("_", 1)[1]
                  for p in (tmp_path / "run").iterdir()) == [
        "finetune.ckpt", "pretrain.ckpt", "pretrain.ckpt.metrics.jsonl"]


def test_auto_falls_back_loudly_past_the_budget(datasets, monkeypatch,
                                                capsys):
    """'auto' on a CUDA config: a corpus past the budget stays on the host,
    and the run says why (no device memory is touched)."""
    from immunostruct_tpu_torch.cli import common

    cfg, ds, _ = datasets["port"]
    monkeypatch.setattr(common, "device_data_budget", lambda d: (100, 1000))
    auto = pick_pipeline(dataclasses.replace(cfg, device="cuda"),
                         comparative=False, ssl=False)
    pipe = auto(ds, np.arange(8), split="train", binary=True, full=True,
                config=cfg)
    assert type(pipe) is BatchPipeline and not pipe.pad_final_batch
    assert "exceeds the budget" in capsys.readouterr().out


def test_validate_data_judges_the_estimate_against_the_card(monkeypatch):
    from immunostruct_tpu_torch.cli import validate_data

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert "no CUDA device" in validate_data.device_corpus_line(10**6)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(validate_data, "device_data_budget",
                        lambda d: (5 << 30, 40 << 30))
    line = validate_data.device_corpus_line(10**9)
    assert line.startswith("device-corpus estimate: 1000 MB (1000000000 B)")
    assert "H100 80GB HBM3: 5.00 GiB a dataset (fits: True)" in line
    assert "(fits: False)" in validate_data.device_corpus_line(6 << 30)
