"""The PyTorch port's comparative slice against the JAX package's, on the
CPU: the cancer/WT tables (immunostruct_tpu_torch/data/tables.py, without
pandas), ``ComparativeDataset``, ``ComparativePipeline``,
``synthetic_comparative_corpus``, ``train_model``'s stage-unique resume
snapshots, and the ``train_Cancer_wFT`` entry point end to end.

Everything up to the batches is numpy on both sides, so those comparisons
are exact: the same rows in the same order, the same arrays, the same
batches bit for bit. The entry point runs HybridModelv2_Comparative at its
full width on a 16-sample IEDB corpus and 20 cancer/WT pairs (20-residue
HLA chains, N=32), f32, batch 4; on the CPU every kernel wrapper runs its
plain version, so the run launches nothing.
"""

import csv
import json
import math
import os

import numpy as np
import pandas as pd
import pytest
import torch

from immunostruct_tpu.config import Config as JaxConfig
from immunostruct_tpu.data import tables as jax_tables
from immunostruct_tpu.data.dataset import (
    ComparativeDataset as JaxComparativeDataset,
)
from immunostruct_tpu.data.pipeline import (
    ComparativePipeline as JaxComparativePipeline,
)
from immunostruct_tpu.data.synthetic import (
    synthetic_comparative_corpus as jax_comparative_corpus,
    synthetic_corpus as jax_synthetic_corpus,
)
from immunostruct_tpu_torch.cli import train_Cancer_wFT
from immunostruct_tpu_torch.config import Config
from immunostruct_tpu_torch.data import tables
from immunostruct_tpu_torch.data.dataset import (
    ComparativeDataset, seeded_split,
)
from immunostruct_tpu_torch.data.pipeline import ComparativePipeline, prefetch
from immunostruct_tpu_torch.data.synthetic import (
    synthetic_comparative_corpus, synthetic_corpus,
)
from immunostruct_tpu_torch.models import build_model
from immunostruct_tpu_torch.ops import edge, mega, segment
from immunostruct_tpu_torch.procedures.train import train_model
from immunostruct_tpu_torch.structs import ComparativeBatch
from immunostruct_tpu_torch.utils.losses import LossConfig

DATASET_ARRAYS = ("seq_full", "seq_pep", "props", "immuno", "foreign_norm",
                  "graph_idx", "pep_len")
GRAPH_FIELDS = ("node_onehot", "coords", "edge_src", "edge_dst", "edge_mask",
                "node_mask", "num_nodes")
BATCH_FIELDS = ("node_feat", "coords", "edge_src", "edge_dst", "edge_feat",
                "edge_mask", "node_mask", "num_nodes")
CANCER_COLS = ["mut_pep", "wt_pep", "allele", "immunogenicity", "foreign",
               "smoothed_foreign", "Mprop1", "Mprop2"]
WT_COLS = ["mut_pep", "wt_pep", "allele", "immunogenicity", "foreign",
           "Mprop1_wt", "Mprop2_wt"]


def _read(path, delimiter):
    with open(path, newline="") as fh:
        return list(csv.reader(fh, delimiter=delimiter))


def _write(path, cols, rows):
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh, delimiter="\t", lineterminator="\n")
        w.writerows([cols, *rows])
    return path


def _same(a, b):
    """One cell: equal, or NaN on both sides."""
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


def _assert_same_records(got: list, want: pd.DataFrame):
    records = want.to_dict("records")
    assert len(got) == len(records)
    for g, w in zip(got, records):
        assert list(g) == list(w)
        assert all(_same(g[k], w[k]) for k in w), (g, w)


def test_synthetic_comparative_corpus_matches_jax(tmp_path):
    """One seed and a shared HLA table: the same graph files and tables."""
    out = {}
    for name, make_iedb, make_comp in (
            ("jax", jax_synthetic_corpus, jax_comparative_corpus),
            ("port", synthetic_corpus, synthetic_comparative_corpus)):
        root = str(tmp_path / name)
        _, _, hla = make_iedb(root, num_samples=4, hla_len=20, seed=3)
        out[name] = make_comp(root, num_samples=6, hla_len=20, seed=4,
                              shared_hla_path=hla)
    jdc, jdw, jpc, jpw, jh = out["jax"]
    pdc, pdw, ppc, ppw, ph = out["port"]
    for jd, pd_ in ((jdc, pdc), (jdw, pdw)):
        files = sorted(os.listdir(jd))
        assert files == sorted(os.listdir(pd_)) and len(files) == 6
        for name in files:
            with np.load(os.path.join(jd, name)) as a, \
                    np.load(os.path.join(pd_, name)) as b:
                assert sorted(a.files) == sorted(b.files)
                for k in a.files:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for j, p, d in ((jpc, ppc, "\t"), (jpw, ppw, "\t"), (jh, ph, ",")):
        assert _read(j, d) == _read(p, d)


@pytest.fixture
def paired_tables(tmp_path):
    """A cancer and a WT table by hand: duplicate groups with ties at the
    extreme (immunogenic: largest foreignness; not: smallest), NaN
    ``foreign`` (dropped) and NaN ``smoothed_foreign`` (kept only where its
    group has no other row), out of order."""
    c = [
        ["AAAAAAAAA", "AAAAAAAAC", "HLA-A0101", 1, 0.5, 0.5, 0.1, 0.2],
        ["CCCCCCCCC", "CCCCCCCCD", "HLA-A0201", 0, 0.3, 0.3, 0.3, 0.4],
        ["AAAAAAAAA", "AAAAAAAAC", "HLA-A0101", 1, 0.7, 0.7, 0.5, 0.6],
        ["DDDDDDDDD", "DDDDDDDDE", "HLA-A0301", 1, "NaN", 0.9, 0.7, 0.8],
        ["CCCCCCCCC", "CCCCCCCCD", "HLA-A0201", 0, 0.1, 0.1, 0.9, 0.1],
        ["AAAAAAAAA", "AAAAAAAAC", "HLA-A0101", 1, 0.7, 0.7, 0.2, 0.3],
        ["EEEEEEEEE", "EEEEEEEEF", "HLA-A0401", 1, 0.4, "nan", 0.4, 0.5],
        ["CCCCCCCCC", "CCCCCCCCD", "HLA-A0201", 0, 0.1, 0.1, 0.6, 0.7],
        ["EEEEEEEEE", "EEEEEEEEF", "HLA-A0401", 1, 0.6, 0.2, 0.8, 0.9],
        ["DDDDDDDDD", "DDDDDDDDE", "HLA-A0301", 1, 0.8, 0.8, 0.2, 0.1],
        ["FFFFFFFFF", "FFFFFFFFG", "HLA-A0101", 0, 0.2, "", 0.3, 0.3],
    ]
    w = [
        ["CCCCCCCCC", "CCCCCCCCD", "HLA-A0201", 0, 0.2, 0.11, 0.12],
        ["AAAAAAAAA", "AAAAAAAAC", "HLA-A0101", 1, 0.4, 0.13, 0.14],
        ["CCCCCCCCC", "CCCCCCCCD", "HLA-A0201", 0, 0.2, 0.15, 0.16],
        ["AAAAAAAAA", "AAAAAAAAC", "HLA-A0101", 1, 0.9, 0.17, 0.18],
        ["DDDDDDDDD", "DDDDDDDDE", "HLA-A0301", 1, 0.5, 0.19, 0.2],
        ["EEEEEEEEE", "EEEEEEEEF", "HLA-A0401", 1, 0.1, 0.21, 0.22],
        ["AAAAAAAAA", "AAAAAAAAC", "HLA-A0101", 1, "NA", 0.23, 0.24],
        ["FFFFFFFFF", "FFFFFFFFG", "HLA-A0101", 0, 0.3, 0.25, 0.26],
    ]
    return (_write(str(tmp_path / "c.tsv"), CANCER_COLS, c),
            _write(str(tmp_path / "w.tsv"), WT_COLS, w))


def test_cancer_tables_match_jax(paired_tables):
    path_c, path_w = paired_tables
    # the cancer dialect of parse_property_table
    got = tables.parse_property_table(path_c, cancer=True)
    want = jax_tables.parse_property_table(path_c, cancer=True)
    assert got[3] == want[3] and len(got[3]) == 10
    for g, w in zip(got[:3], want[:3]):
        assert list(g) == list(w)
        for k in w:
            gv, wv = g[k], w[k]
            assert (all(map(_same, gv, wv)) if isinstance(wv, tuple)
                    else _same(gv, float(wv))), k
    # the deduplication, each table alone
    df = pd.read_table(path_c).dropna(subset="foreign")
    rows = [r for r in tables.read_typed_rows(path_c)
            if not math.isnan(r["foreign"])]
    kept = tables.dedup_property_df(rows)
    _assert_same_records(kept, jax_tables.dedup_property_df(df))
    assert [r["Mprop1"] for r in kept] == [0.5, 0.9, 0.8, 0.2, 0.3]
    # the paired table
    _assert_same_records(
        tables.parse_property_tables_cancer_wt(path_c, path_w),
        jax_tables.parse_property_tables_cancer_wt(path_c, path_w))
    assert tables.reformat_cancer_allele("HLA-B5701") == "HLA-B*57:01"
    assert list(jax_tables.reformat_cancer_allele(
        pd.Series(["HLA-B5701"]))) == ["HLA-B*57:01"]


@pytest.mark.parametrize("fault", ["mixed", "misaligned"])
def test_cancer_table_faults_raise_in_both(paired_tables, tmp_path, fault):
    """A group with mixed immunogenicity, and tables whose groups differ."""
    path_c, path_w = paired_tables
    rows = _read(path_c, "\t")
    if fault == "mixed":
        rows[1][3] = "0"        # group AAAAAAAAA: immunogenicity 0 and 1
        match = "different immunogenicity"
    else:
        rows.append(["GGGGGGGGG", "GGGGGGGGH", "HLA-A0101", "1", "0.5",
                     "0.5", "0.1", "0.1"])
        match = "misaligned"
    path = _write(str(tmp_path / "bad.tsv"), rows[0], rows[1:])
    for fn in (tables.parse_property_tables_cancer_wt,
               jax_tables.parse_property_tables_cancer_wt):
        with pytest.raises(ValueError, match=match):
            fn(path, path_w)


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """The JAX package's corpora, one HLA table: IEDB 16 samples, cancer/WT
    20 pairs (the comparative table also gets a duplicated pair, which the
    deduplication drops)."""
    root = str(tmp_path_factory.mktemp("corpora"))
    iedb = jax_synthetic_corpus(root, num_samples=16, hla_len=20, seed=11)
    comp = jax_comparative_corpus(root, num_samples=20, hla_len=20, seed=12,
                                  shared_hla_path=iedb[2])
    for path in comp[2:4]:
        rows = _read(path, "\t")
        with open(path, "a", newline="") as fh:
            csv.writer(fh, delimiter="\t", lineterminator="\n").writerow(
                rows[3])
    return iedb, comp


def _configs(**kw):
    return JaxConfig(**kw), Config(device="cpu", **kw)


def test_comparative_dataset_matches_jax(corpora):
    _, comp = corpora
    jcfg, cfg = _configs()
    want = JaxComparativeDataset.load(jcfg, *comp)
    got = ComparativeDataset.load(cfg, *comp)
    assert len(got) == len(want) == 20
    for side in ("cancer", "wt"):
        g, w = getattr(got, side), getattr(want, side)
        for k in DATASET_ARRAYS:
            a, b = getattr(g, k), getattr(w, k)
            assert a.dtype == b.dtype, (side, k)
            np.testing.assert_array_equal(a, b, err_msg=f"{side}.{k}")
        for k in GRAPH_FIELDS:
            np.testing.assert_array_equal(getattr(g.graphs, k),
                                          getattr(w.graphs, k), err_msg=k)
        assert g.class_weights == w.class_weights
        assert (g.foreign_min, g.foreign_max) == (w.foreign_min, w.foreign_max)
        assert g.raw_chain == w.raw_chain
    assert (got.wt.immuno == 0).all() and (got.wt.foreign_norm == -1).all()


def _batch_arrays(batch):
    """{side.field: numpy} of a ComparativeBatch of either package."""
    out = {}
    for side in ("cancer", "wt"):
        s = getattr(batch, side)
        for k in BATCH_FIELDS:
            out[f"{side}.{k}"] = np.asarray(getattr(s.graph, k))
        for k in ("seq_onehot", "props", "target", "aux_residue"):
            v = getattr(s, k)
            out[f"{side}.{k}"] = None if v is None else np.asarray(v)
    return out


@pytest.mark.parametrize("mode", ["train_extended", "train_ssl", "val",
                                  "eval_train", "test"])
def test_comparative_pipeline_is_bit_identical(corpora, mode):
    """Two epochs give the JAX pipeline's batches: the train split cycled
    up to 7 batches of 3 (extend_to, the last batch partial), the train
    split with SSL, sequence and structure masks, and the unshuffled val,
    eval_train and test views."""
    _, comp = corpora
    kw = dict(batch_size=3, seed=4)
    if mode == "train_ssl":
        kw.update(sequence_pad_count=3, structure_pad_count=2)
    jcfg, cfg = _configs(**kw)
    jds = JaxComparativeDataset.load(jcfg, *comp)
    ds = ComparativeDataset.load(cfg, *comp)
    tr, va, te = seeded_split(len(ds), (0.8, 0.1, 0.1), 4)
    split = {"train_extended": "train", "train_ssl": "train"}.get(mode, mode)
    opts = dict(split=split, binary=mode != "train_ssl", full=True,
                ssl=mode == "train_ssl")
    if mode == "train_extended":
        opts["extend_to"] = 20
    idx = {"val": va, "test": te}.get(mode, tr)
    jpipe = JaxComparativePipeline(jds, idx, config=jcfg, **opts)
    pipe = ComparativePipeline(ds, idx, config=cfg, **opts)
    assert len(pipe) == len(jpipe)
    if mode == "train_extended":
        assert len(pipe.indices) == 20 and len(pipe) == 7
    for epoch in range(2):
        jb, pb = list(jpipe.epoch(epoch)), list(prefetch(pipe.epoch(epoch)))
        assert len(jb) == len(pb) == len(pipe)
        for a, b in zip(pb, jb):
            assert isinstance(a, ComparativeBatch)
            got, want = _batch_arrays(a), _batch_arrays(b)
            assert got.keys() == want.keys()
            for name, w in want.items():
                g = got[name]
                if w is None:
                    assert g is None, name
                    continue
                assert g.shape == w.shape, name
                np.testing.assert_array_equal(g, w.astype(g.dtype),
                                              err_msg=name)
            np.testing.assert_array_equal(got["cancer.target"],
                                          got["wt.target"])


class _Stop(Exception):
    pass


def test_train_model_resume_snapshot_is_stage_unique(corpora, tmp_path):
    """``resume_tag`` names the snapshot ``<ckpt>.<tag>.resume``: it is
    there after an interrupted epoch, and removed when the stage ends."""
    _, comp = corpora
    cfg = Config(device="cpu", batch_size=4, seed=3, num_epochs=2,
                 full_sequence=True, compute_dtype="float32",
                 aggregation="pallas", resume=True,
                 model_save_dir=str(tmp_path))
    cfg.derive_paths()
    ds = ComparativeDataset.load(cfg, *comp)
    tr, va, _ = seeded_split(len(ds), (0.8, 0.1, 0.1), 3)
    pipes = [ComparativePipeline(ds, idx, split=s, binary=True, full=True,
                                 config=cfg) for idx, s in ((tr, "train"),
                                                            (va, "val"))]
    vae_dim = ds.cancer.seq_full.shape[1] * 21
    _, model = build_model("HybridModelv2_Comparative", vae_dim,
                           torch.Generator().manual_seed(0), gcn_layers=1,
                           gat_hidden_channels=16, vae_hidden_dim=32,
                           vae_latent_dim=8)
    snapshot = cfg.model_save_path_pretrain + ".stage2.resume"

    def stop(m):
        if m.get("epoch") == 0:
            raise _Stop

    with pytest.raises(_Stop):
        train_model(cfg, model, *pipes, LossConfig(vae_dim, 1.0),
                    binary=True, learning_rate=1e-3, optimizer_name="adamw",
                    coeff_contrastive=0.1, resume_tag="stage2", log_fn=stop,
                    verbose=False)
    assert os.path.exists(snapshot)
    assert not os.path.exists(cfg.model_save_path_pretrain + ".resume")
    _, history = train_model(cfg, model, *pipes, LossConfig(vae_dim, 1.0),
                             binary=True, learning_rate=1e-3,
                             optimizer_name="adamw", coeff_contrastive=0.1,
                             resume_tag="stage2", verbose=False)
    assert len(history["train_loss"]) == 1          # resumed at epoch 2
    assert not os.path.exists(snapshot)


def _cli_args(corpora, save_dir, aggregation):
    (g, p, h), (dc, dw, pc, pw, _) = corpora
    return ["--model", "HybridModelv2_Comparative", "--full-sequence",
            "--sequence-loss", "--aggregation", aggregation,
            "--compute-dtype", "float32", "--batch-size", "4",
            "--num-epochs", "2", "--device", "cpu", "--seed", "1",
            "--coeff-contrastive", "0.1", "--min-finetuning-batches", "6",
            "--model-save-dir", save_dir, "--graph-dir-IEDB", g,
            "--property-path-IEDB", p, "--hla-path", h,
            "--graph-dir-cancer", dc, "--graph-dir-wildtype", dw,
            "--property-path-cancer", pc, "--property-path-wildtype", pw]


def _counts():
    return (mega.edge_mega.launches, mega.tail_bwd.launches,
            edge.edge_program.launches, edge.edge_program_bwd.launches,
            segment.segment_scatter.launches, segment.segment_gather.launches)


@pytest.mark.parametrize("aggregation", ["pallas", "scatter"])
def test_train_Cancer_wFT_end_to_end(corpora, tmp_path, aggregation):
    """Three stages in order (pretrain, comparative pretrain, comparative
    finetune on 6 batches an epoch), both checkpoints, 15 metrics per split
    with the train threshold reused on test, and no kernel launch on the
    CPU."""
    before = _counts()
    save_dir = str(tmp_path / "ckpt")
    train_stats, test_stats = train_Cancer_wFT.main(
        _cli_args(corpora, save_dir, aggregation) + ["--skip-clinical"])
    assert len(train_stats) == len(test_stats) == 15
    assert test_stats["optimal_threshold"] == train_stats["optimal_threshold"]
    files = sorted(os.listdir(save_dir))
    assert [f.rsplit("_", 1)[1] for f in files] == [
        "finetune.ckpt", "pretrain.ckpt", "pretrain.ckpt.metrics.jsonl"]
    with open(os.path.join(save_dir, files[2])) as fh:
        logged = [json.loads(line) for line in fh]
    stages = []
    for row in logged:
        for key in row:
            stage = key.rsplit("_train_loss", 1)[0]
            if key.endswith("_train_loss") and stage not in stages:
                stages.append(stage)
            if key.endswith("_loss"):
                assert np.isfinite(row[key]), row
    assert stages == ["pretrain", "pretrain2", "finetune"]
    assert _counts() == before



def test_train_Cancer_wFT_microbatch_contrastive(corpora, tmp_path,
                                                 monkeypatch):
    """--coeff-contrastive 0.1 with --grad-accum-steps 2 fails without
    --allow-microbatch-contrastive where JAX fails, when the first twin
    stage builds its Trainer, naming the opt-in; with it the three stages
    run, the two twin stages taking the contrastive
    term on microbatches of 2 (a trailing odd batch on its rows unsplit),
    with finite losses."""
    from immunostruct_tpu_torch.procedures import train as train_module

    save_dir = str(tmp_path / "ckpt")
    args = _cli_args(corpora, save_dir, "scatter") + [
        "--skip-clinical", "--grad-accum-steps", "2"]
    with pytest.raises(ValueError, match="allow_microbatch_contrastive"):
        train_Cancer_wFT.main(args)
    seen, real = [], train_module.paired_contrastive_loss

    def spy(projector, emb_c, emb_w, target, **kw):
        seen.append(target.shape[0])
        return real(projector, emb_c, emb_w, target, **kw)

    monkeypatch.setattr(train_module, "paired_contrastive_loss", spy)
    save_dir = str(tmp_path / "ckpt_opt_in")
    args[args.index("--model-save-dir") + 1] = save_dir
    train_stats, test_stats = train_Cancer_wFT.main(
        args + ["--allow-microbatch-contrastive"])
    assert len(train_stats) == len(test_stats) == 15
    assert seen and set(seen) <= {1, 2, 3}, seen
    assert seen.count(2) > len(seen) // 2, seen
    with open(os.path.join(save_dir, sorted(os.listdir(save_dir))[2])) as fh:
        logged = [json.loads(line) for line in fh]
    losses = [v for row in logged for k, v in row.items()
              if k.endswith("_loss")]
    assert losses and np.isfinite(losses).all()
