"""The PyTorch port's clinical survival validation against the JAX
package's, on the CPU: ``synthetic_clinical_corpus``, the Kaplan-Meier
estimator and log-rank test, ``convert_patient_code``,
``clinical_pvalues`` (rows in place of pandas frames), ``ClinicalDataset``,
``cli.infer_clinical_only`` and ``train_Cancer_wFT`` with its clinical pass.

The statistics are the same numpy code on both sides, so they are held bit
for bit. The per-patient loads are sums in another order (``math.fsum``
here, pandas' group sum there), so the loads agree to rounding and the
p-values, which depend only on the loads' order and the groups' counts,
exactly. The port joins loads to outcomes by patient and raises on
patient sets that differ, where the JAX package joins by position; the
test shows both. ``infer_clinical_only`` runs each package on a
checkpoint the other saved, the VAE's log-variance head at -100 (as
tests/test_torch_port_infer.py sets it), f32, 'scatter': probabilities
within 1e-5 (other f32 summation orders), p-values equal.
"""

import csv
import json
import math
import os
import random

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from immunostruct_tpu.cli import infer_clinical_only as jax_clinical_cli
from immunostruct_tpu.config import Config as JaxConfig
from immunostruct_tpu.data.dataset import ClinicalDataset as JaxClinicalDataset
from immunostruct_tpu.data.synthetic import (
    synthetic_comparative_corpus as jax_comparative_corpus,
    synthetic_corpus as jax_synthetic_corpus,
)
from immunostruct_tpu.data.synthetic import (
    synthetic_clinical_corpus as jax_clinical_corpus,
)
from immunostruct_tpu.models import build_model as jax_build_model
from immunostruct_tpu.procedures import clinical as jax_clinical
from immunostruct_tpu.utils.checkpoint import save_checkpoint as jax_save
from immunostruct_tpu_torch.cli import infer_clinical_only, train_Cancer_wFT
from immunostruct_tpu_torch.config import Config
from immunostruct_tpu_torch.data.dataset import ClinicalDataset
from immunostruct_tpu_torch.data.synthetic import synthetic_clinical_corpus
from immunostruct_tpu_torch.data.tables import read_rows
from immunostruct_tpu_torch.models import build_model
from immunostruct_tpu_torch.ops import edge, mega, segment
from immunostruct_tpu_torch.procedures import clinical
from immunostruct_tpu_torch.utils.checkpoint import (
    load_jax_checkpoint, save_checkpoint,
)
from tests.torch_threads import one_torch_thread  # noqa: F401

CLINICAL_ARRAYS = ("seq_full", "seq_pep", "props", "props_filled",
                   "graph_idx", "valid", "immuno", "foreign_norm")
GRAPH_FIELDS = ("node_onehot", "coords", "edge_src", "edge_dst", "edge_mask",
                "node_mask", "num_nodes")
SMALL = ["--gcn-layers", "1", "--gat-hidden-channels", "16",
         "--vae-hidden-dim", "32", "--vae-latent-dim", "8"]


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("kw", [dict(num_rows=30, num_patients=7, seed=5),
                                dict(num_rows=12, num_patients=3, hla_len=20,
                                     match_rate=0.5, seed=8)])
def test_synthetic_clinical_corpus_matches_jax(tmp_path, kw):
    """The same graph files (every array and name) and the same two tables,
    byte for byte."""
    jg, js, jc = jax_clinical_corpus(str(tmp_path / "jax"), **kw)
    pg, ps, pc = synthetic_clinical_corpus(str(tmp_path / "port"), **kw)
    assert _read(ps) == _read(js) and _read(pc) == _read(jc)
    files = sorted(os.listdir(jg))
    assert files == sorted(os.listdir(pg)) and 0 < len(files) < kw["num_rows"]
    for name in files:
        with np.load(os.path.join(jg, name)) as a, \
                np.load(os.path.join(pg, name)) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype, (name, k)
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _survival_cases():
    rng = np.random.default_rng(0)
    ties = np.asarray([1.0, 2.0, 2.0, 3.0, 5.0, 5.0, 5.0, 8.0])
    yield "random", (rng.random(20) * 30, rng.random(17) * 30,
                     rng.integers(0, 2, 20), rng.integers(0, 2, 17))
    yield "ties", (ties, ties[::-1] + 1.0, np.asarray([1, 1, 0, 1, 1, 0, 1, 0]),
                   np.asarray([1, 0, 1, 1, 0, 1, 1, 1]))
    yield "all_censored", (ties, ties + 0.5, np.zeros(8, int), np.zeros(8, int))
    yield "one_group_without_events", (
        ties, rng.random(6) * 9, np.asarray([1, 0, 1, 1, 0, 1, 0, 1]),
        np.zeros(6, int))


@pytest.mark.parametrize("case", list(_survival_cases()),
                         ids=lambda c: c[0])
def test_kaplan_meier_and_logrank_match_jax(case):
    _, (ta, tb, ea, eb) = case
    for t, e in ((ta, ea), (tb, eb)):
        got, want = clinical.kaplan_meier(t, e), jax_clinical.kaplan_meier(t, e)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    got = clinical.logrank_test(ta, tb, ea, eb)
    assert got == jax_clinical.logrank_test(ta, tb, ea, eb)
    assert 0.0 <= got <= 1.0


def test_convert_patient_code_matches_jax():
    for code in ("mUC-12", "MM-3", "RH-7", "BC-1", "XX-4", "plain"):
        assert clinical.convert_patient_code(code) == \
            jax_clinical.convert_patient_code(code)
    assert clinical.convert_patient_code("mUC-12") == "BC-12"


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """A JAX-written cohort: 48 rows of 8 patients (the rows without a
    graph become NaN probabilities), an outcomes table with comma decimals,
    and seeded probabilities."""
    root = str(tmp_path_factory.mktemp("cohort"))
    g, s, c = jax_clinical_corpus(root, num_rows=48, num_patients=8,
                                  hla_len=20, seed=13)
    with open(c, newline="") as fh:
        rows = list(csv.reader(fh, delimiter="\t"))
    for r in rows[1:]:
        r[2] = r[2].replace(".", ",")           # PFS.Time, comma decimals
    with open(c, "w", newline="") as fh:
        csv.writer(fh, delimiter="\t", lineterminator="\n").writerows(rows)
    ds = ClinicalDataset.load(Config(), g, s)
    probs = np.random.default_rng(3).random(len(ds))
    probs[~ds.valid] = np.nan
    return g, s, c, probs


def test_clinical_pvalues_match_jax(cohort, tmp_path):
    """NaN rows dropped, comma decimals read, the median in both groups:
    the p-values of pandas' frames and of the port's rows are equal, and
    the loads agree to rounding."""
    _, s, c, probs = cohort
    seq_rows, clin_rows = read_rows(s), read_rows(c)
    assert any("," in r["PFS.Time"] for r in clin_rows)
    assert np.isnan(probs).sum() > 0
    want = jax_clinical.clinical_pvalues(
        probs, pd.read_table(s), pd.read_table(c),
        results_csv=str(tmp_path / "jax.csv"))
    got = clinical.clinical_pvalues(probs, seq_rows, clin_rows)
    assert got == want
    jax_loads = pd.read_csv(tmp_path / "jax.csv").set_index("Patient")["load"]
    loads = clinical.patient_loads(probs, seq_rows)
    assert sorted(loads) == sorted(jax_loads.index)
    np.testing.assert_allclose([loads[k] for k in jax_loads.index],
                               jax_loads.to_numpy(), rtol=1e-15)
    # each patient's load is the sum of its rows that are not NaN
    assert len(loads) == 8 and loads["BC-0"] == math.fsum(
        p for r, p in zip(seq_rows, probs)
        if r["patient"] == "mUC-0" and not np.isnan(p))


def test_clinical_join_is_by_patient(cohort, tmp_path):
    """Shuffled outcome rows: the same p-values in both packages. A renamed
    or a missing patient: the port raises naming the patients; the JAX
    package's positional join goes on without a word, each load moved onto
    another patient."""
    _, s, c, probs = cohort
    seq_rows, clin_rows = read_rows(s), read_rows(c)
    want = clinical.clinical_pvalues(probs, seq_rows, clin_rows)
    shuffled = list(clin_rows)
    random.Random(0).shuffle(shuffled)
    assert shuffled != clin_rows
    assert clinical.clinical_pvalues(probs, seq_rows, shuffled) == want
    frame = pd.read_table(c).sample(frac=1.0, random_state=0)
    assert jax_clinical.clinical_pvalues(probs, pd.read_table(s),
                                         frame) == want

    renamed = [dict(r) for r in clin_rows]
    renamed[0]["Patient"] = "BC-99"        # sorts last: every load shifts
    with pytest.raises(ValueError, match=r"scored, no outcome: \['BC-0'\]; "
                                         r"outcome, no scored row: "
                                         r"\['BC-99'\]"):
        clinical.clinical_pvalues(probs, seq_rows, renamed)
    with pytest.raises(ValueError, match=r"scored, no outcome: \['BC-3'\]"):
        clinical.clinical_pvalues(probs, seq_rows,
                                  clin_rows[:3] + clin_rows[4:])
    frame = pd.read_table(c)
    frame.loc[0, "Patient"] = "BC-99"
    out = str(tmp_path / "misjoined.csv")
    jax_clinical.clinical_pvalues(probs, pd.read_table(s), frame,
                                  results_csv=out)
    got = pd.read_csv(out).set_index("Patient")["load"]
    loads = clinical.patient_loads(probs, seq_rows)
    assert got["BC-1"] == pytest.approx(loads["BC-0"], rel=1e-12)
    assert got["BC-99"] == pytest.approx(loads["BC-7"], rel=1e-12)


def test_plot_and_its_skips(cohort, tmp_path, capsys, monkeypatch):
    """A figure where a p-value is at most 0.1; the JAX package's line when
    both are above it, and when matplotlib is absent."""
    _, s, c, probs = cohort
    seq_rows, clin_rows = read_rows(s), read_rows(c)
    # outcomes that follow the loads: the high-load half dies early
    loads = clinical.patient_loads(probs, seq_rows)
    median = np.median(list(loads.values()))
    strong = [dict(r, **{"OS.Time": "1.0" if loads[r["Patient"]] > median
                         else "20.0", "OS.Event": "1"}) for r in clin_rows]
    fig = str(tmp_path / "f" / "km.png")
    os_p, _ = clinical.clinical_pvalues(probs, seq_rows, strong,
                                        fig_save_path=fig)
    assert os_p <= 0.1 and os.path.getsize(fig) > 0
    flat = [dict(r, **{"OS.Event": "0", "PFS.Event": "0"}) for r in clin_rows]
    assert clinical.clinical_pvalues(probs, seq_rows, flat,
                                     fig_save_path=fig) == (1.0, 1.0)
    assert capsys.readouterr().out == (
        "Not plotting clinical KM figures: both p-values > 0.1.\n")
    monkeypatch.setitem(__import__("sys").modules, "matplotlib", None)
    clinical.plot_clinical_validation([], [], 0.0, 0.0, fig)
    assert capsys.readouterr().out == (
        "matplotlib unavailable; skipping clinical KM plot\n")


def test_clinical_dataset_matches_jax(cohort, tmp_path):
    """Every array equal: the placeholder props and graph index, the NaN
    props, the zero-filled copy, the valid mask, the -1 labels; and the
    no-match raise."""
    g, s, _, _ = cohort
    for multiple in (8, 1):
        got = ClinicalDataset.load(Config(pad_nodes_multiple=multiple), g, s)
        want = JaxClinicalDataset.load(JaxConfig(pad_nodes_multiple=multiple),
                                       g, s)
        assert got.patients == want.patients and len(got) == 48
        for k in CLINICAL_ARRAYS:
            a, b = getattr(got, k), getattr(want, k)
            assert a.dtype == b.dtype, k
            np.testing.assert_array_equal(a, b, err_msg=k)
        for k in GRAPH_FIELDS:
            np.testing.assert_array_equal(getattr(got.graphs, k),
                                          getattr(want.graphs, k), err_msg=k)
    assert 0 < got.valid.sum() < len(got)
    assert np.isnan(got.props[~got.valid]).all()
    other = jax_clinical_corpus(str(tmp_path / "other"), num_rows=4,
                                num_patients=2, hla_len=20, seed=99)[0]
    for cls, cfg in ((ClinicalDataset, Config()),
                     (JaxClinicalDataset, JaxConfig())):
        with pytest.raises(ValueError, match="no clinical rows matched a "
                                             "graph"):
            cls.load(cfg, other, s)


def _checkpoints(tmp_path, vae_dim):
    """The same small HybridModelv2_Comparative weights saved by each
    package, the VAE's log-variance head at -100."""
    small = dict(gcn_layers=1, gat_hidden_channels=16, vae_hidden_dim=32,
                 vae_latent_dim=8)
    _, params = jax_build_model("HybridModelv2_Comparative", vae_dim,
                                jax.random.key(4),
                                use_wt_for_downstream=False, **small)
    fc22 = params["vae"]["fc22"]
    fc22["w"] = fc22["w"] * 0
    fc22["b"] = fc22["b"] * 0 - 100.0
    by_jax = str(tmp_path / "jax.ckpt")
    jax_save(by_jax, params)
    _, model = build_model("HybridModelv2_Comparative", vae_dim,
                           torch.Generator().manual_seed(0),
                           use_wt_for_downstream=False, **small)
    load_jax_checkpoint(by_jax, model, verbose=False)
    by_port = str(tmp_path / "port.ckpt")
    save_checkpoint(by_port, model)
    return by_jax, by_port


def test_infer_clinical_only_matches_jax(cohort, tmp_path, monkeypatch):
    g, s, c, _ = cohort
    ds = ClinicalDataset.load(Config(), g, s)
    by_jax, by_port = _checkpoints(tmp_path, ds.seq_full.shape[1] * 21)
    common = ["--full-sequence", "--compute-dtype", "float32",
              "--aggregation", "scatter", "--batch-size", "16", "--seed", "1",
              "--graph-dir-clinical", g, "--seq-path-clinical", s,
              "--clinical-table-path", c,
              "--figure-save-dir", str(tmp_path / "fig"), *SMALL]
    seen = []
    real = jax_clinical.clinical_pvalues

    def recorder(probs, *args, **kw):
        seen.append(np.asarray(probs))
        return real(probs, *args, **kw)

    monkeypatch.setattr(jax_clinical, "clinical_pvalues", recorder)
    got = infer_clinical_only.main(common + ["--device", "cpu",
                                             "--checkpoint", by_jax])
    want = jax_clinical_cli.main(common + ["--checkpoint", by_port])
    assert sorted(got) == ["os_p_value", "pfs_p_value", "predicted_probs"]
    assert (got["os_p_value"], got["pfs_p_value"]) == (
        want["os_p_value"], want["pfs_p_value"])
    probs = got["predicted_probs"]
    assert len(probs) == len(ds) and len(seen) == 1
    np.testing.assert_array_equal(np.isnan(probs), ~ds.valid)
    np.testing.assert_array_equal(np.isnan(seen[0]), ~ds.valid)
    np.testing.assert_allclose(probs[ds.valid], seen[0][ds.valid], atol=1e-5)


def test_infer_clinical_only_needs_a_card_by_default(cohort, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the host has a CUDA device")
    g, s, c, _ = cohort
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer_clinical_only.main([
            "--checkpoint", str(tmp_path / "none.ckpt"),
            "--graph-dir-clinical", g, "--seq-path-clinical", s,
            "--clinical-table-path", c])


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """IEDB 16 samples and 20 cancer/WT pairs sharing one HLA table, and a
    clinical cohort of 40 rows of 8 patients whose chains have the same
    20-residue HLA length."""
    root = str(tmp_path_factory.mktemp("corpora"))
    iedb = jax_synthetic_corpus(root, num_samples=16, hla_len=20, seed=11)
    comp = jax_comparative_corpus(root, num_samples=20, hla_len=20, seed=12,
                                  shared_hla_path=iedb[2])
    clin = jax_clinical_corpus(root, num_rows=40, num_patients=8,
                               hla_len=20, seed=13)
    return iedb, comp, clin


def _cancer_args(corpora, tmp_path, aggregation, clin=None):
    (g, p, h), (dc, dw, pc, pw, _), (gc, sc, cc) = corpora
    gc = clin or gc
    return ["--model", "HybridModelv2_Comparative", "--full-sequence",
            "--sequence-loss", "--aggregation", aggregation,
            "--compute-dtype", "float32", "--batch-size", "4",
            "--num-epochs", "2", "--device", "cpu", "--seed", "1",
            "--coeff-contrastive", "0.1", "--min-finetuning-batches", "6",
            "--model-save-dir", str(tmp_path / "ckpt"),
            "--graph-dir-IEDB", g, "--property-path-IEDB", p,
            "--hla-path", h, "--graph-dir-cancer", dc,
            "--graph-dir-wildtype", dw, "--property-path-cancer", pc,
            "--property-path-wildtype", pw, "--graph-dir-clinical", gc,
            "--seq-path-clinical", sc, "--clinical-table-path", cc,
            "--figure-save-dir", str(tmp_path / "fig")]


def _counts():
    return (mega.edge_mega.launches, mega.tail_bwd.launches,
            edge.edge_program.launches, edge.edge_program_bwd.launches,
            segment.segment_scatter.launches, segment.segment_gather.launches)


@pytest.mark.parametrize("aggregation", ["pallas", "scatter"])
def test_train_Cancer_wFT_with_clinical(corpora, tmp_path, aggregation):
    """The three stages, then the clinical pass: the test split's stats
    gain the OS/PFS p-values (17 keys, 15 on train), both in [0, 1] and
    equal to ``clinical_pvalues`` of the finetuned model's clinical
    probabilities; no kernel launch on the CPU."""
    before = _counts()
    train_stats, test_stats = train_Cancer_wFT.main(
        _cancer_args(corpora, tmp_path, aggregation))
    assert len(train_stats) == 15 and len(test_stats) == 17
    assert set(test_stats) - set(train_stats) == {"os_p_value",
                                                  "pfs_p_value"}
    for k in ("os_p_value", "pfs_p_value"):
        assert 0.0 <= test_stats[k] <= 1.0
    assert _counts() == before
    # the same p-values from the finetuned checkpoint's clinical probabilities
    *_, (gc, sc, cc) = corpora
    ckpt = next(f for f in os.listdir(tmp_path / "ckpt")
                if f.endswith("finetune.ckpt"))
    out = infer_clinical_only.main([
        "--checkpoint", str(tmp_path / "ckpt" / ckpt), "--full-sequence",
        "--sequence-loss", "--aggregation", aggregation, "--compute-dtype",
        "float32", "--batch-size", "4", "--device", "cpu", "--seed", "1",
        "--graph-dir-clinical", gc, "--seq-path-clinical", sc,
        "--clinical-table-path", cc, "--figure-save-dir",
        str(tmp_path / "fig2")])
    assert clinical.clinical_pvalues(out["predicted_probs"], read_rows(sc),
                                     read_rows(cc)) == (
        out["os_p_value"], out["pfs_p_value"])
    with open(next((tmp_path / "ckpt").glob("*.metrics.jsonl"))) as fh:
        logged = [json.loads(line) for line in fh]
    assert any("OS p-value" in row for row in logged)


def test_train_Cancer_wFT_checks_the_clinical_width_first(corpora, tmp_path):
    """A clinical cohort whose chains pad to another length fails before
    any stage runs, as the JAX package's does."""
    gc, _, _ = jax_clinical_corpus(str(tmp_path / "wide"), num_rows=8,
                                   num_patients=2, hla_len=26, seed=2)
    args = _cancer_args(corpora, tmp_path, "scatter")
    args[args.index("--seq-path-clinical") + 1] = os.path.join(
        str(tmp_path / "wide"), "clinical_seq.tsv")
    args[args.index("--graph-dir-clinical") + 1] = gc
    with pytest.raises(ValueError, match="dataset 'clinical' pads"):
        train_Cancer_wFT.main(args)
    assert not list(tmp_path.glob("ckpt/*.ckpt"))
