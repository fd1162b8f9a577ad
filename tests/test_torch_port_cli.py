"""The PyTorch port's epoch loop (``Trainer.fit``, ``train_model``), its
stage glue (``reset_head``, ``inference``, ``MetricLogger``) and the
``train_IEDB_wFT`` entry point, end to end on the CPU.

The corpus is the port's ``synthetic_corpus`` (16 samples, 20-residue HLA
chains, so 28-30 tokens and N=32); the model is HybridModelv2 at
gcn_layers=1, gat_hidden_channels=16 for the loop's tests, and at its full
width for the entry point, in f32. On the CPU every kernel wrapper runs its
plain version, so these runs launch nothing. Parameters are compared
exactly: each step draws its noise from (seed, step), so a resumed run and
an uninterrupted one do the same arithmetic.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from immunostruct_tpu_torch.cli import train_IEDB_wFT
from immunostruct_tpu_torch.config import Config
from immunostruct_tpu_torch.data.dataset import ImmunoDataset, seeded_split
from immunostruct_tpu_torch.data.pipeline import BatchPipeline
from immunostruct_tpu_torch.data.synthetic import synthetic_corpus
from immunostruct_tpu_torch.models import build_model, reset_head
from immunostruct_tpu_torch.ops import edge, mega
from immunostruct_tpu_torch.procedures.infer import inference
from immunostruct_tpu_torch.procedures.train import (
    Trainer, make_optimizer, train_model,
)
from immunostruct_tpu_torch.utils.checkpoint import jax_params
from immunostruct_tpu_torch.utils.logging import MetricLogger, stage_log_fn
from immunostruct_tpu_torch.utils.losses import LossConfig
from immunostruct_tpu_torch.utils.schedule import constant_lr
from tests.torch_threads import one_torch_thread  # noqa: F401

SMALL = dict(gcn_layers=1, gat_hidden_channels=16, vae_hidden_dim=32,
             vae_latent_dim=8)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("corpus"))
    return synthetic_corpus(root, num_samples=16, hla_len=20, seed=11,
                            planted_signal=True)


def _setup(corpus, tmp_path, **kw):
    cfg = Config(device="cpu", batch_size=4, seed=3, full_sequence=True,
                 sequence_loss=True, compute_dtype="float32",
                 aggregation="fused", model_save_dir=str(tmp_path), **kw)
    cfg.derive_paths()
    ds = ImmunoDataset.load(cfg, *corpus)
    tr, va, _ = seeded_split(len(ds), (0.8, 0.1, 0.1), cfg.seed)
    pipes = [BatchPipeline(ds, idx, split=split, binary=True, full=True,
                           config=cfg) for idx, split in ((tr, "train"),
                                                          (va, "val"))]
    vae_dim = ds.seq_full.shape[1] * 21
    return cfg, pipes, vae_dim, LossConfig(vae_dim, 1.0, sequence=True)


def _model(vae_dim, seed=0):
    return build_model("HybridModelv2", vae_dim,
                       torch.Generator().manual_seed(seed), **SMALL)[1]


def _trainer(model, loss_cfg, lr=1e-2):
    return Trainer(model.spec, loss_cfg, binary=True,
                   optimizer=make_optimizer("adam", constant_lr(lr)),
                   aggregation="fused", compute_dtype=torch.float32)


def _params(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def test_fit_keeps_the_lowest_val_checkpoint(corpus, tmp_path):
    """The checkpoint on disk is the model of the epoch with the lowest
    validation loss, not the last one."""
    cfg, (train, val), vae_dim, loss_cfg = _setup(corpus, tmp_path)
    model = _model(vae_dim)
    trainer = _trainer(model, loss_cfg, lr=3e-2)
    state = trainer.init_state(model, torch.Generator().manual_seed(1))
    net = state.model                   # trained in place, epoch by epoch
    snapshots = []
    state, history = trainer.fit(
        state, train, val, 5, seed=cfg.seed,
        ckpt_path=cfg.model_save_path_pretrain, verbose=False,
        log_fn=lambda m: snapshots.append(
            {k: v.copy() for k, v in jax_params(net).items()}))
    best = int(np.argmin(history["val_loss"]))
    assert best < 4, history["val_loss"]        # not simply the last epoch
    with np.load(cfg.model_save_path_pretrain) as z:
        assert sorted(z.files) == sorted(snapshots[best])
        for k in z.files:
            np.testing.assert_array_equal(z[k], snapshots[best][k])
    assert len(history["train_loss"]) == 5
    assert history["train_samples"] == [len(train.indices)] * 5


class _Stop(Exception):
    pass


def test_resumed_fit_ends_where_an_uninterrupted_one_does(corpus, tmp_path):
    cfg, (train, val), vae_dim, loss_cfg = _setup(corpus, tmp_path)
    resume = str(tmp_path / "stage.resume")

    def run(log_fn=None):
        model = _model(vae_dim)
        trainer = _trainer(model, loss_cfg)
        state = trainer.init_state(model, torch.Generator().manual_seed(1))
        state, _ = trainer.fit(state, train, val, 3, seed=cfg.seed,
                               verbose=False, resume_path=resume,
                               log_fn=log_fn)
        return state

    whole = run()
    assert not os.path.exists(resume)           # removed when the stage ends

    def stop_after_first_epoch(m):
        if m["epoch"] == 0:
            raise _Stop

    with pytest.raises(_Stop):
        run(stop_after_first_epoch)
    assert os.path.exists(resume)               # the epoch-0 snapshot
    resumed = run()
    assert resumed.step == whole.step
    got, want = _params(resumed.model), _params(whole.model)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert not os.path.exists(resume)


def test_train_model_collapse_guard_records_val_auroc(corpus, tmp_path):
    cfg, (train, val), vae_dim, loss_cfg = _setup(corpus, tmp_path,
                                                  num_epochs=2)
    model, history = train_model(cfg, _model(vae_dim), train, val, loss_cfg,
                                 binary=True, learning_rate=1e-3,
                                 stage="finetune", verbose=False)
    assert len(history["val_auc"]) == 2
    assert os.path.exists(cfg.model_save_path_finetune)


def test_train_model_rejects_what_is_not_ported(corpus, tmp_path,
                                                monkeypatch):
    """Under data_parallel a stage whose batches the data axis does not
    divide (13 train rows in batches of 4 over two ranks: a trailing batch
    of 1) fails before its first step, naming both numbers; it is never
    padded or dropped. The two ranks are a stand-in mesh."""
    from immunostruct_tpu_torch.parallel import trainer as parallel_trainer

    class TwoRanks:
        axis_names = ("data",)

        @staticmethod
        def size(axis):
            return 2

        @staticmethod
        def index(axis):
            return 0

    monkeypatch.setattr(parallel_trainer, "make_mesh",
                        lambda axis: TwoRanks)
    cfg, (train, val), vae_dim, loss_cfg = _setup(corpus, tmp_path,
                                                  data_parallel=True)
    with pytest.raises(ValueError, match="a batch of 1 rows does not divide "
                                         "over 2 ranks"):
        train_model(cfg, _model(vae_dim), train, val, loss_cfg, binary=True,
                    learning_rate=1e-3)
    assert not os.path.exists(cfg.model_save_path_pretrain)


def test_reset_head_replaces_only_the_classifier(corpus, tmp_path):
    _, _, vae_dim, _ = _setup(corpus, tmp_path)
    model = _model(vae_dim)
    before = _params(model)
    reset_head(model, torch.Generator().manual_seed(5))
    after = _params(model)
    changed = {k for k in before if not torch.equal(before[k], after[k])}
    assert changed and all(k.startswith("classifier.") for k in changed)
    again = reset_head(_model(vae_dim), torch.Generator().manual_seed(5))
    for k, v in _params(again).items():
        assert torch.equal(v, after[k]), k


def test_inference_reuses_a_given_threshold(corpus, tmp_path):
    cfg, (train, val), vae_dim, _ = _setup(corpus, tmp_path)
    model = _model(vae_dim)
    derived = inference(cfg, model, train, verbose=False)
    reused = inference(cfg, model, val, verbose=False,
                       optimal_threshold=derived["optimal_threshold"])
    assert len(derived) == len(reused) == 15
    assert reused["optimal_threshold"] == derived["optimal_threshold"]
    again = inference(cfg, model, train, verbose=False)
    assert again == derived                     # noise seeded per batch


def test_metric_logger_writes_jsonl_and_warns_for_wandb(tmp_path, capsys,
                                                        monkeypatch):
    """A project and an entity ask for wandb; where it cannot be imported
    the logger says so and writes the JSONL file alone."""
    monkeypatch.setitem(sys.modules, "wandb", None)     # import fails
    path = str(tmp_path / "run" / "m.metrics.jsonl")
    logger = MetricLogger(project="p", entity="someone", jsonl_path=path)
    assert "wandb unavailable" in capsys.readouterr().out
    assert logger.wandb is None
    stage_log_fn(logger, "pretrain")({"epoch": 0, "train_loss": 1.5,
                                      "val_loss": 2.0, "epoch_time_s": 0.1})
    logger.log({"x": np.float32(0.25)})
    with open(path) as fh:
        lines = [json.loads(line) for line in fh]
    assert lines == [{"pretrain_train_loss": 1.5, "pretrain_val_loss": 2.0},
                     {"x": 0.25}]


def _cli_args(corpus, save_dir, aggregation):
    graph_dir, props, hla = corpus
    return ["--model", "HybridModelv2", "--full-sequence", "--sequence-loss",
            "--aggregation", aggregation, "--compute-dtype", "float32",
            "--batch-size", "8", "--num-epochs", "2", "--device", "cpu",
            "--seed", "1", "--model-save-dir", save_dir,
            "--graph-dir-IEDB", graph_dir, "--property-path-IEDB", props,
            "--hla-path", hla]


@pytest.mark.parametrize("aggregation", ["fused", "scatter"])
def test_train_IEDB_wFT_end_to_end(corpus, tmp_path, aggregation):
    """Both stages at full width, both checkpoints, the metrics file, 15
    metrics per split with the train threshold reused on test, and no
    kernel launch on the CPU."""
    before = (edge.edge_program.launches, edge.edge_program_bwd.launches,
              mega.edge_mega.launches, mega.tail_bwd.launches)
    save_dir = str(tmp_path / "ckpt")
    train_stats, test_stats = train_IEDB_wFT.main(
        _cli_args(corpus, save_dir, aggregation))
    assert len(train_stats) == len(test_stats) == 15
    assert test_stats["optimal_threshold"] == train_stats["optimal_threshold"]
    files = sorted(os.listdir(save_dir))
    assert [f.rsplit("_", 1)[1] for f in files] == [
        "finetune.ckpt", "pretrain.ckpt", "pretrain.ckpt.metrics.jsonl"]
    with open(os.path.join(save_dir, files[2])) as fh:
        logged = [json.loads(line) for line in fh]
    keys = {k for row in logged for k in row}
    assert {"pretrain_train_loss", "finetune_val_loss",
            "Test ROC AUC"} <= keys
    assert all(np.isfinite(row["pretrain_train_loss"]) for row in logged
               if "pretrain_train_loss" in row)
    assert (edge.edge_program.launches, edge.edge_program_bwd.launches,
            mega.edge_mega.launches, mega.tail_bwd.launches) == before


@pytest.mark.parametrize("flag,match", [
    (["--device-data", "--device", "cuda"], "device-data"),
    # --data-parallel runs (test_torch_port_parallel.py); asked for the
    # card where there is none, it fails and does not train on the CPU
    pytest.param(["--data-parallel", "--device", "cuda"], "no CUDA device",
                 id="flag1-not ported"),
    (["--device", "cuda"], "no CUDA device"),
])
def test_train_IEDB_wFT_refuses_what_is_not_ported(corpus, tmp_path, flag,
                                                   match):
    """--device-data keeps the corpus on --device, so with --device cuda
    and no card it fails (it does not run on the CPU); so does a
    data-parallel run on --device cuda. With a card, each case asks for
    an accumulation the batch does not divide instead."""
    if "cuda" in flag and torch.cuda.is_available():
        flag = ["--grad-accum-steps", "3"]
        match = "does not divide"
    args = _cli_args(corpus, str(tmp_path), "fused") + flag
    with pytest.raises((ValueError, RuntimeError), match=match):
        train_IEDB_wFT.main(args)
    assert not os.listdir(tmp_path)             # failed before any stage


def test_scan_layers_and_stack_twins_are_accepted(corpus, tmp_path):
    from immunostruct_tpu_torch.cli.common import base_parser, to_config

    args = base_parser("t").parse_args(
        ["--scan-layers", "--stack-twins", "--device", "cpu"])
    cfg = to_config(args)
    assert cfg.scan_layers and cfg.stack_twins and cfg.device == "cpu"


def test_flags_that_do_nothing_here_are_rejected():
    """Only --scan-layers and --stack-twins are accepted as no-ops; a flag
    the port does not have (the JAX Config's ``param_dtype``, which no flag
    of either package sets) is an argparse error, and every JAX flag,
    --allow-microbatch-contrastive too, reaches the Config."""
    from immunostruct_tpu_torch.cli.common import base_parser, to_config

    with pytest.raises(SystemExit):
        base_parser("t").parse_args(["--param-dtype", "float32"])
    cfg = to_config(base_parser("t").parse_args(
        ["--allow-microbatch-contrastive", "--device", "cpu"]))
    assert cfg.allow_microbatch_contrastive
