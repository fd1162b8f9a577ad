"""The port's remaining public helpers against the JAX package's, on the
CPU: ``MetricLogger``'s optional wandb sink (a stand-in module in
``sys.modules``: wandb is not installed), ``plot_losses``,
``find_matching_allele``, ``get_z_peps`` and ``sequence_input_dim``.

The tables are seeded: 40 peptides over a 20-letter alphabet, 5 alleles,
a third of the (peptide, allele) keys present, immunogenicity 0, 1 or
NaN. The port's table helpers take rows (a list of dicts), JAX's pandas
frames built from the same rows; the results must be equal.
"""

import json
import math
import sys

import numpy as np
import pandas as pd
import pytest

from immunostruct_tpu.config import sequence_input_dim as jax_seq_dim
from immunostruct_tpu.data import tables as jax_tables
from immunostruct_tpu.utils.logging import MetricLogger as JaxMetricLogger
from immunostruct_tpu.utils.losses import plot_losses as jax_plot_losses
from immunostruct_tpu_torch.config import sequence_input_dim
from immunostruct_tpu_torch.data import tables
from immunostruct_tpu_torch.utils.logging import MetricLogger
from immunostruct_tpu_torch.utils.losses import plot_losses
from tests.torch_parallel_ranks import stand_in_wandb
from tests.torch_threads import one_torch_thread  # noqa: F401

PAYLOADS = [{"pretrain_train_loss": np.float32(1.5),
             "pretrain_val_loss": 2.0},
            {"Test ROC AUC": 0.75, "OS p-value": float("nan")},
            {"finetune_collapse_detected": True, "finetune_val_auc": 0.5}]


def _run_logger(cls, path, monkeypatch, fail_init=False, **kw):
    """The stand-in's calls and the JSONL lines of one logger's run."""
    wandb = stand_in_wandb(fail_init)
    monkeypatch.setitem(sys.modules, "wandb", wandb)
    logger = cls(jsonl_path=path, **kw)
    for m in PAYLOADS:
        logger.log(m)
    logger.finish()
    with open(path) as fh:
        lines = [json.loads(line) for line in fh]
    return wandb.calls, lines, logger.wandb is not None


@pytest.mark.parametrize("kw", [
    dict(project="ImmunoPred-IEDB-MIT", entity="someone", name="run",
         config={"seed": 1}),
    dict(project="ImmunoPred-IEDB-MIT", entity=None),
    dict(project=None, entity="someone")])
def test_metric_logger_makes_jax_wandb_calls(tmp_path, monkeypatch, kw):
    """The same init/log/finish calls in the same order, and the same
    JSONL lines; without a project and an entity, no call at all."""
    jax = _run_logger(JaxMetricLogger, str(tmp_path / "j.jsonl"),
                      monkeypatch, **kw)
    port = _run_logger(MetricLogger, str(tmp_path / "p.jsonl"),
                       monkeypatch, **kw)
    np.testing.assert_equal(port, jax)
    calls, _, opened = port
    if kw["project"] and kw["entity"]:
        assert opened
        assert [c[0] for c in calls] == ["init", "log", "log", "log",
                                         "finish"]
        assert calls[0][2] == dict(project=kw["project"],
                                   entity=kw["entity"], name=kw["name"],
                                   config=kw["config"])
    else:
        assert calls == [] and not opened


def test_metric_logger_falls_back_when_init_fails(tmp_path, monkeypatch,
                                                  capsys):
    """An init that raises: JAX's line, then stdout and the JSONL file
    alone (no log or finish reaches wandb)."""
    kw = dict(project="p", entity="someone", name="run", config={})
    jax = _run_logger(JaxMetricLogger, str(tmp_path / "j.jsonl"),
                      monkeypatch, fail_init=True, **kw)
    jax_out = capsys.readouterr().out
    port = _run_logger(MetricLogger, str(tmp_path / "p.jsonl"),
                       monkeypatch, fail_init=True, **kw)
    assert capsys.readouterr().out == jax_out
    assert jax_out.startswith("wandb unavailable (wandb.init: no network)")
    np.testing.assert_equal(port, jax)
    calls, lines, opened = port
    assert [c[0] for c in calls] == ["init"] and not opened
    assert len(lines) == len(PAYLOADS)


def test_plot_losses_writes_a_png_as_jax(tmp_path, monkeypatch, capsys):
    """Headless: a PNG of the two curves (the same size as JAX's); without
    matplotlib, JAX's line and nothing written."""
    losses = ([3.0, 2.0, 1.5, 1.25], [3.5, 2.5, 2.0, 1.9])
    paths = [str(tmp_path / f"{tag}.png") for tag in ("port", "jax")]
    plot_losses(*losses, save_path=paths[0])
    jax_plot_losses(*losses, save_path=paths[1])
    heads = []
    for path in paths:
        with open(path, "rb") as fh:
            data = fh.read()
        heads.append((data[:8], data[16:24]))       # signature, width/height
    assert heads[0] == heads[1] and heads[0][0] == b"\x89PNG\r\n\x1a\n"
    capsys.readouterr()
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    plot_losses(*losses, save_path=str(tmp_path / "none.png"))
    port_out = capsys.readouterr().out
    jax_plot_losses(*losses, save_path=str(tmp_path / "none_jax.png"))
    assert port_out == capsys.readouterr().out == \
        "matplotlib unavailable; skipping loss plot\n"
    assert not (tmp_path / "none.png").exists()


def _seeded_tables(seed):
    rng = np.random.default_rng(seed)
    letters = np.array(list("ACDEFGHIKLMNPQRSTVWY"))
    peptides = ["".join(rng.choice(letters, rng.integers(8, 12)))
                for _ in range(40)]
    alleles = [f"HLA-A*0{i}:01" for i in range(1, 6)]
    pep_pairs = {p + a for p in peptides for a in alleles
                 if rng.random() < 1 / 3}
    immuno = rng.choice([0.0, 1.0, math.nan], size=80, p=[0.6, 0.3, 0.1])
    expanded = [{"peptide": peptides[rng.integers(40)],
                 "immunogenicity": float(v)} for v in immuno]
    return peptides, alleles, pep_pairs, expanded


@pytest.mark.parametrize("seed", [0, 1])
def test_table_helpers_match_jax(seed):
    peptides, alleles, pep_pairs, expanded = _seeded_tables(seed)
    combos = [tables.find_matching_allele(p, alleles, pep_pairs)
              for p in peptides]
    assert combos == [jax_tables.find_matching_allele(p, alleles, pep_pairs)
                      for p in peptides]
    assert 0 < combos.count(0) < len(combos)
    seq_rows = [{"peptide": p, "combo2": c} for p, c in zip(peptides, combos)]
    got = tables.get_z_peps(expanded, seq_rows)
    want = jax_tables.get_z_peps(pd.DataFrame(expanded),
                                 pd.DataFrame(seq_rows))
    assert got == want and got


def test_sequence_input_dim_matches_jax():
    for args in ((283, 11, True), (283, 11, False), (30, 9, True)):
        assert sequence_input_dim(*args) == jax_seq_dim(*args)
    assert sequence_input_dim(12, 9, False, alphabet_size=4) == \
        jax_seq_dim(12, 9, False, alphabet_size=4) == 36
