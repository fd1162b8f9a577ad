"""The PyTorch port's staged curriculum (``cli/train_curriculum.py``)
against the JAX package's, on the CPU.

The stage plan: both ``main``s run on the same small corpora with
``train_model``, ``load_checkpoint`` and ``inference`` replaced by
recorders in each module (nothing in the JAX package changes). Per stage
they must agree on everything the plan decides: binary, stage, the
learning rate and the schedule's value at every epoch, the optimizer and
its weight decay, the resume tag, the contrastive coefficient, the
pipeline kind, the split sizes and the train pipeline's length; then the
threshold's split and the test split. Then the unknown-stage exit, the
sequence-width raise, and the curriculum end to end under 'mega' (the
kernels' plain versions on the CPU) and 'scatter'.
"""

import json
import os

import numpy as np
import pytest
import torch

from immunostruct_tpu.cli import train_curriculum as jax_curriculum
from immunostruct_tpu.data.synthetic import (
    synthetic_comparative_corpus as jax_comparative_corpus,
    synthetic_corpus as jax_synthetic_corpus,
)
from immunostruct_tpu_torch.cli import train_curriculum
from immunostruct_tpu_torch.ops import edge, mega, segment
from immunostruct_tpu_torch.utils.checkpoint import load_checkpoint
from tests.torch_threads import one_torch_thread  # noqa: F401

EPOCHS = 4


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """IEDB 20 samples and 20 cancer/WT pairs sharing one HLA table."""
    root = str(tmp_path_factory.mktemp("curriculum"))
    iedb = jax_synthetic_corpus(root, num_samples=20, hla_len=20, seed=31)
    comp = jax_comparative_corpus(root, num_samples=20, hla_len=20, seed=32,
                                  shared_hla_path=iedb[2])
    return iedb, comp


def _args(corpora, save_dir, *extra, iedb=None):
    (g, p, h), (dc, dw, pc, pw, _) = corpora
    if iedb is not None:
        g, p = iedb
    return ["--full-sequence", "--sequence-loss", "--compute-dtype",
            "float32", "--batch-size", "4", "--num-epochs", str(EPOCHS),
            "--seed", "1", "--min-finetuning-batches", "7",
            "--model-save-dir", save_dir, "--graph-dir-IEDB", g,
            "--property-path-IEDB", p, "--hla-path", h,
            "--graph-dir-cancer", dc, "--graph-dir-wildtype", dw,
            "--property-path-cancer", pc, "--property-path-wildtype", pw,
            *extra]


def _plan(module, argv, monkeypatch):
    """Run ``module.main`` with recorders: one row per stage, then one per
    inference."""
    rows = []

    def train_model(config, *args, **kw):
        # (model, ...) in the port, (spec, params, ...) in the JAX package
        state, train_pipe, val_pipe = args[-4], args[-3], args[-2]
        schedule = kw.get("lr_schedule")
        rows.append(dict(
            binary=kw["binary"], stage=kw["stage"],
            learning_rate=kw["learning_rate"],
            schedule=[float(schedule(e)) if schedule is not None else None
                      for e in range(EPOCHS)],
            optimizer=kw["optimizer_name"], weight_decay=kw["weight_decay"],
            resume_tag=kw["resume_tag"],
            coeff_contrastive=kw["coeff_contrastive"],
            pipeline=type(train_pipe).__name__,
            splits=(len(train_pipe.indices), len(val_pipe.indices)),
            train_batches=len(train_pipe), val_split=val_pipe.split))
        return state, {}

    def load_checkpoint(path, model, *args, **kw):
        rows.append(dict(loaded=os.path.basename(path).rsplit("_", 1)[1]))
        return model

    def inference(config, *args, **kw):
        pipe = args[-1]
        rows.append(dict(inference=pipe.split, rows=len(pipe.indices),
                         pipeline=type(pipe).__name__,
                         threshold=kw.get("optimal_threshold")))
        return {"optimal_threshold": 0.25}

    for name, fn in (("train_model", train_model),
                     ("load_checkpoint", load_checkpoint),
                     ("inference", inference)):
        monkeypatch.setattr(module, name, fn)
    module.main(argv)
    return rows


@pytest.mark.parametrize("stages", [
    ["--stages", "PropIEDB,ImmunoIEDB"],
    ["--stages", "PropIEDB,PropCancer,ImmunoCancer", "--comparative",
     "--model", "HybridModelv2_Comparative", "--coeff-contrastive", "0.1"],
    ["--stages", "PropCancer,ImmunoIEDB,ImmunoCancer",
     "--pretrain-warmup-epochs", "2"],
    ["--stages", "ImmunoIEDB,PropCancer", "--comparative",
     "--model", "HybridModelv2_Comparative"],
], ids=["iedb", "comparative", "warmup", "last_stage_not_binary"])
def test_stage_plan_matches_jax(corpora, tmp_path, monkeypatch, stages):
    got = _plan(train_curriculum,
                _args(corpora, str(tmp_path / "port"), "--device", "cpu",
                      *stages), monkeypatch)
    want = _plan(jax_curriculum,
                 _args(corpora, str(tmp_path / "jax"), *stages), monkeypatch)
    # the JAX package's schedules evaluate in float32, the port's in float64
    for g_row, w_row in zip(got, want):
        g_sched, w_sched = g_row.pop("schedule", 0), w_row.pop("schedule", 0)
        if g_sched and g_sched[0] is not None:
            np.testing.assert_allclose(g_sched, w_sched, rtol=1e-6)
        else:
            assert g_sched == w_sched
        g_row["has_schedule"] = g_sched
    assert got == [dict(w, has_schedule=g["has_schedule"])
                   for g, w in zip(got, want)]
    trained = [r for r in got if "stage" in r]
    assert [r["resume_tag"] for r in trained] == [
        f"stage{i + 1}" for i in range(len(trained))]
    assert got[-2]["threshold"] is None and got[-1]["threshold"] == 0.25
    if "--pretrain-warmup-epochs" in stages:
        ramp = trained[0]["has_schedule"]
        assert ramp[0] < ramp[1] == ramp[-1]


def test_unknown_stage_exits_before_reading_data(tmp_path):
    missing = str(tmp_path / "nowhere")
    argv = ["--stages", "PropIEDB,Bogus", "--graph-dir-IEDB", missing,
            "--model-save-dir", str(tmp_path / "save")]
    with pytest.raises(SystemExit) as port:
        train_curriculum.main(argv + ["--device", "cpu"])
    with pytest.raises(SystemExit) as jax_exit:
        jax_curriculum.main(argv)
    assert str(port.value) == str(jax_exit.value)
    assert "unknown stage 'Bogus'" in str(port.value)
    assert not os.path.exists(str(tmp_path / "save"))


def test_seq_dims_raise_when_a_later_stage_pads_otherwise(corpora, tmp_path,
                                                         monkeypatch):
    """The IEDB table cut to its 8-residue peptides (chains of 28 tokens,
    the cancer corpus's reach 30): the first stage trains, the cancer stage
    fails before it starts, naming the stage, in both packages."""
    (g, p, _), _ = corpora
    with open(p) as fh:
        lines = fh.read().splitlines()
    col = lines[0].split("\t").index("peptide")
    short = [ln for ln in lines[1:] if len(ln.split("\t")[col]) == 8]
    assert 0 < len(short) < len(lines) - 1
    cut = tmp_path / "props_8mers.tsv"
    cut.write_text("\n".join([lines[0], *short]) + "\n")
    errors = []
    for module, extra in ((train_curriculum, ["--device", "cpu"]),
                          (jax_curriculum, [])):
        with pytest.raises(ValueError, match="sequence-dim mismatch: dataset "
                                             "'PropCancer.cancer' pads") as e:
            _plan(module, _args(corpora, str(tmp_path / module.__name__),
                                "--stages", "PropIEDB,PropCancer",
                                "--comparative", *extra,
                                iedb=(g, str(cut))), monkeypatch)
        errors.append(str(e.value))
    # the same message, but for the JAX package's note on jit
    assert errors[1].startswith(errors[0].rstrip("."))


def _counts():
    return (mega.edge_mega.launches, mega.tail_bwd.launches,
            edge.edge_program.launches, edge.edge_program_bwd.launches,
            segment.segment_scatter.launches, segment.segment_gather.launches)


@pytest.mark.parametrize("aggregation", ["mega", "scatter"])
def test_curriculum_end_to_end(corpora, tmp_path, aggregation):
    """The four-stage comparative curriculum at the model's full width:
    stages in order with finite losses, both checkpoints load, 15 metrics
    per split with the train threshold reused on test, and no kernel launch
    on the CPU."""
    from immunostruct_tpu_torch.models import build_model

    before = _counts()
    save_dir = str(tmp_path / "ckpt")
    argv = _args(corpora, save_dir, "--device", "cpu", "--stages",
                 "PropIEDB,ImmunoIEDB,PropCancer,ImmunoCancer",
                 "--comparative", "--model", "HybridModelv2_Comparative",
                 "--aggregation", aggregation)
    argv[argv.index("--num-epochs") + 1] = "2"
    train_stats, test_stats = train_curriculum.main(argv)
    assert len(train_stats) == len(test_stats) == 15
    assert test_stats["optimal_threshold"] == train_stats["optimal_threshold"]
    assert _counts() == before
    files = sorted(os.listdir(save_dir))
    assert [f.rsplit("_", 1)[1] for f in files] == [
        "finetune.ckpt", "pretrain.ckpt", "pretrain.ckpt.metrics.jsonl"]
    with open(os.path.join(save_dir, files[2])) as fh:
        logged = [json.loads(line) for line in fh]
    stages = []
    for row in logged:
        for key, value in row.items():
            stage = key.rsplit("_train_loss", 1)[0]
            if key.endswith("_train_loss") and stage not in stages:
                stages.append(stage)
            if key.endswith("_loss"):
                assert np.isfinite(value), row
    assert stages == ["PropIEDB", "ImmunoIEDB", "PropCancer", "ImmunoCancer"]
    for f in files[:2]:
        with np.load(os.path.join(save_dir, f)) as z:
            vae_dim = z["['vae']['fc1']['w']"].shape[0]
        _, fresh = build_model("HybridModelv2_Comparative", vae_dim,
                               torch.Generator().manual_seed(0),
                               use_wt_for_downstream=False)
        load_checkpoint(os.path.join(save_dir, f), fresh, verbose=False)
