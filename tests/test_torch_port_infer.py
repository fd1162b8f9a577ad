"""Batch inference and reference checkpoints in the PyTorch port
(immunostruct_tpu_torch/cli/infer_IEDB_or_Cancer.py,
immunostruct_tpu_torch/utils/torch_import.py) against the JAX package's,
and two divergences repaired in cli/common.py and utils/logging.py, each
held against the JAX function beside it.

- ``import_torch_state_dict``: a state_dict under the reference's names
  (numpy, and the same as torch tensors) maps to the JAX package's
  parameters bit for bit, for six registry specs.
- ``infer_IEDB_or_Cancer`` end to end on ``synthetic_corpus`` (20 samples,
  20-residue HLA chains; with ``--comparative`` 20 cancer/WT pairs), f32,
  'scatter', each side on a checkpoint the other saved (the same weights).
  The VAE's log-variance head is set to -100 in that checkpoint, so the
  VAE noise (drawn by jax.random on one side, a torch Generator on the
  other) is multiplied by exp(-50) and the two forwards compute the same
  function. Both write the same test fold: the same rows, labels and chains
  in the same order, the probabilities within 1e-5 (other f32 summation
  orders; measured below 1e-6).
"""

import os

import jax
import numpy as np
import pytest
import torch

from immunostruct_tpu.cli import infer_IEDB_or_Cancer as jax_infer_cli
from immunostruct_tpu.cli.common import check_seq_dims as jax_check_seq_dims
from immunostruct_tpu.models import build_model as jax_build_model
from immunostruct_tpu.models import model_map as jax_model_map
from immunostruct_tpu.utils import torch_import as jax_torch_import
from immunostruct_tpu.utils.checkpoint import save_checkpoint as jax_save
from immunostruct_tpu.utils.logging import stats_to_wandb as jax_stats
from immunostruct_tpu_torch.cli import infer_IEDB_or_Cancer
from immunostruct_tpu_torch.cli.common import check_seq_dims
from immunostruct_tpu_torch.config import Config
from immunostruct_tpu_torch.data.dataset import ImmunoDataset
from immunostruct_tpu_torch.data.synthetic import (
    synthetic_comparative_corpus, synthetic_corpus,
)
from immunostruct_tpu_torch.models import build_model
from immunostruct_tpu_torch.models.zoo import model_map
from immunostruct_tpu_torch.utils import torch_import
from immunostruct_tpu_torch.utils.checkpoint import (
    jax_name, load_jax_checkpoint, save_checkpoint,
)
from immunostruct_tpu_torch.utils.logging import stats_to_wandb
from tests.test_torch_import import fake_state_dict
from tests.torch_threads import one_torch_thread  # noqa: F401

VAE_DIM = 12 * 21


def _jax_flat(tree):
    flat, _ = jax.tree.flatten_with_path(tree)
    return {jax_name(jax.tree_util.keystr(p)): np.asarray(v) for p, v in flat}


@pytest.mark.parametrize("name", ["HybridModelv2", "HybridModel_SSL",
                                  "SequenceFpModel", "StructureModel",
                                  "HybridModelv2_Comparative", "DualModel"])
def test_import_state_dict_matches_jax(name):
    sd = fake_state_dict(jax_model_map[name], VAE_DIM,
                         np.random.default_rng(5))
    want = _jax_flat(jax_torch_import.import_torch_state_dict(
        sd, jax_model_map[name]))
    for source in (sd, {k: torch.from_numpy(v) for k, v in sd.items()}):
        got = torch_import.import_torch_state_dict(source, model_map[name])
        assert got.keys() == want.keys()
        for k, w in want.items():
            assert got[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], w, err_msg=k)
    _, model = build_model(name, VAE_DIM, torch.Generator().manual_seed(0))
    assert got.keys() == model.state_dict().keys()


def test_torch_checkpoint_files_load_as_jax_reads_them(tmp_path):
    """A ``torch.save``d reference state_dict: both packages sniff it, and
    ``load_any_checkpoint`` puts JAX's arrays into the model; an npz
    checkpoint is told apart and loads too."""
    name = "HybridModelv2"
    sd = fake_state_dict(jax_model_map[name], VAE_DIM,
                         np.random.default_rng(6))
    pt = str(tmp_path / "ref.pt")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, pt)
    npz = str(tmp_path / "port.ckpt")
    _, model = build_model(name, VAE_DIM, torch.Generator().manual_seed(0))
    save_checkpoint(npz, model)
    for path, kind in ((pt, True), (npz, False)):
        assert torch_import.is_torch_checkpoint(path) is kind
        assert jax_torch_import.is_torch_checkpoint(path) is kind
    _, model = build_model(name, VAE_DIM, torch.Generator().manual_seed(1))
    torch_import.load_any_checkpoint(pt, model, verbose=False)
    want = _jax_flat(jax_torch_import.import_torch_checkpoint(
        pt, jax_model_map[name]))
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    torch_import.load_any_checkpoint(npz, model, verbose=False)


def test_require_exact_reference_padding_as_jax():
    for fn in (torch_import.require_exact_reference_padding,
               jax_torch_import.require_exact_reference_padding):
        cfg = Config()
        assert cfg.pad_nodes_multiple == 8
        fn(cfg)
        assert cfg.pad_nodes_multiple == 1
        fn(cfg)
        assert cfg.pad_nodes_multiple == 1


# --------------------------------------------------------------------------
# the repaired divergences (cli/common.py, utils/logging.py)
# --------------------------------------------------------------------------

def test_check_seq_dims_skips_none_as_jax(tmp_path):
    corpus = synthetic_corpus(str(tmp_path), num_samples=4, hla_len=20,
                              seed=2)
    ds = ImmunoDataset.load(Config(), *corpus)
    dim = ds.seq_pep.shape[1] * 21
    for fn in (check_seq_dims, jax_check_seq_dims):
        fn(dim, False, IEDB=ds, clinical=None)
        with pytest.raises(ValueError, match="sequence-dim mismatch"):
            fn(dim + 21, False, IEDB=ds, clinical=None)


def test_stats_to_wandb_carries_the_survival_p_values_as_jax():
    stats = {"roc_auc": 0.7, "f1_op": 0.5, "os_p_value": 0.01,
             "pfs_p_value": 0.2, "optimal_threshold": 0.4}
    assert stats_to_wandb("Test", stats) == jax_stats("Test", stats)
    assert stats_to_wandb("Test", stats)["OS p-value"] == 0.01
    plain = {"roc_auc": 0.7}
    assert stats_to_wandb("Train", plain) == jax_stats("Train", plain)


# --------------------------------------------------------------------------
# infer_IEDB_or_Cancer end to end
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("infer"))
    iedb = synthetic_corpus(root, num_samples=20, hla_len=20, seed=7)
    comp = synthetic_comparative_corpus(root, num_samples=20, hla_len=20,
                                        seed=8, shared_hla_path=iedb[2])
    return iedb, comp


def _checkpoints(tmp_path, name, vae_dim):
    """The same weights saved by each package: JAX's ``build_model`` with
    the VAE's log-variance head at -100, saved by JAX, loaded into the
    port and saved again by the port."""
    spec, params = jax_build_model(name, vae_dim, jax.random.key(4),
                                   use_wt_for_downstream=False)
    if spec.use_sequence:
        fc22 = params["vae"]["fc22"]
        fc22["w"] = fc22["w"] * 0
        fc22["b"] = fc22["b"] * 0 - 100.0
    by_jax = str(tmp_path / "jax.ckpt")
    jax_save(by_jax, params)
    _, model = build_model(name, vae_dim, torch.Generator().manual_seed(0),
                           use_wt_for_downstream=False)
    load_jax_checkpoint(by_jax, model, verbose=False)
    by_port = str(tmp_path / "port.ckpt")
    save_checkpoint(by_port, model)
    return by_jax, by_port


def _rows(path):
    with open(path) as fh:
        return [line.rstrip("\n").split("\t") for line in fh]


@pytest.mark.parametrize("comparative", [False, True])
def test_infer_cli_matches_jax(corpora, tmp_path, comparative):
    (g, p, h), (dc, dw, pc, pw, _) = corpora
    name = "HybridModel_Comparative" if comparative else "HybridModel"
    common = ["--model", name, "--compute-dtype", "float32",
              "--aggregation", "scatter", "--batch-size", "4", "--seed", "1",
              "--graph-dir-IEDB", g, "--property-path-IEDB", p,
              "--hla-path", h, "--graph-dir-cancer", dc,
              "--graph-dir-wildtype", dw, "--property-path-cancer", pc,
              "--property-path-wildtype", pw,
              "--model-save-dir", str(tmp_path)]
    if comparative:
        common.append("--comparative")
    cfg = Config(seed=1)
    ds = ImmunoDataset.load(cfg, g, p, h)
    by_jax, by_port = _checkpoints(tmp_path, name,
                                   ds.seq_pep.shape[1] * 21)
    out_port, out_jax = (str(tmp_path / "port.txt"),
                         str(tmp_path / "jax.txt"))
    stats = infer_IEDB_or_Cancer.main(common + [
        "--device", "cpu", "--checkpoint", by_jax, "--output", out_port])
    jax_stats_ = jax_infer_cli.main(common + ["--checkpoint", by_port,
                                              "--output", out_jax])
    got, want = _rows(out_port), _rows(out_jax)
    assert len(got) == len(want) == 2 and all(len(r) == 3 for r in got)
    for g_row, w_row in zip(got, want):
        assert g_row[1:] == w_row[1:]                  # label, chain
        assert abs(float(g_row[0]) - float(w_row[0])) <= 1e-5
    np.testing.assert_allclose(stats["predicted_probs"],
                               np.asarray(jax_stats_["predicted_probs"]),
                               atol=1e-5)
    assert os.path.getsize(out_port) > 0


def test_infer_cli_needs_a_card_by_default(corpora, tmp_path):
    """``--device`` defaults to cuda, which fails on a host without one,
    before any data is read, as the train CLIs do."""
    if torch.cuda.is_available():
        pytest.skip("the host has a CUDA device")
    (g, p, h), _ = corpora
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer_IEDB_or_Cancer.main([
            "--checkpoint", str(tmp_path / "none.ckpt"),
            "--graph-dir-IEDB", g, "--property-path-IEDB", p,
            "--hla-path", h, "--output", str(tmp_path / "p.txt")])
