"""The PyTorch port's HybridModelv2 forward against the JAX package's.

JAX ``build_model`` params are saved with the JAX ``save_checkpoint`` and
loaded into the port with ``load_jax_checkpoint``; the same seeded numpy
batch (with padded edges and self-loops) goes through both ``model_apply``
calls with ``deterministic=True``. The VAE noise is the one JAX draws,
replayed from the key splits of ``model_apply``/``forward_item``, and
handed to the port as ``eps``. Outputs are compared in f32 within
atol=1e-5, rtol=1e-4, under aggregation 'scatter' and 'mega' (the JAX mega
kernel in interpret mode; the port's plain version of its kernel).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from immunostruct_tpu.data.synthetic import (
    random_sample_batch as jax_random_sample_batch,
)
from immunostruct_tpu.models import build_model as jax_build_model
from immunostruct_tpu.models.trunk import model_apply as jax_model_apply
from immunostruct_tpu.serving import write_example as jax_write_example
from immunostruct_tpu.structs import GraphBatch as JaxGraphBatch
from immunostruct_tpu.utils.checkpoint import save_checkpoint
from immunostruct_tpu_torch.data.synthetic import (
    random_sample_arrays, random_sample_batch, write_example,
)
from immunostruct_tpu_torch.models import build_model, model_apply
from immunostruct_tpu_torch.models.zoo import model_map
from immunostruct_tpu_torch.structs import GraphBatch
from immunostruct_tpu_torch.utils.checkpoint import (
    jax_name, load_jax_checkpoint, params_from_jax,
)

B, N, E, L = 3, 16, 128, 6
SMALL = dict(gcn_layers=2, gat_hidden_channels=16, vae_hidden_dim=32,
             vae_latent_dim=8)
FIELDS = ("logits", "mu", "logvar", "recon", "embedding", "attention")


def _arrays(seed=0):
    a = random_sample_arrays(B, N, E, L, seed=seed)
    rng = np.random.default_rng(seed + 100)
    a["edge_mask"] = rng.random((B, E)) >= 0.2               # padded edges
    a["edge_src"][:, :4] = a["edge_dst"][:, :4]              # self-loops
    a["edge_feat"] = rng.standard_normal((B, E, 1)).astype(np.float32)
    return a


def _jax_graph(a):
    return JaxGraphBatch(**{k: jnp.asarray(a[k]) for k in (
        "node_feat", "coords", "edge_src", "edge_dst", "edge_feat",
        "edge_mask", "node_mask", "num_nodes")})


def _jax_eps(key, shape):
    """The eps model_apply draws: key -> (k_item, k_cls); k_item ->
    (k_eps, k_drop); normal(k_eps)."""
    k_item, _ = jax.random.split(key)
    k_eps, _ = jax.random.split(k_item)
    return np.array(jax.random.normal(k_eps, shape, jnp.float32))


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    spec, params = jax_build_model("HybridModelv2", L * 21,
                                   jax.random.key(3), **SMALL)
    path = str(tmp_path_factory.mktemp("ckpt") / "model.ckpt")
    save_checkpoint(path, params)
    _, model = build_model("HybridModelv2", L * 21,
                           torch.Generator().manual_seed(0), **SMALL)
    load_jax_checkpoint(path, model, verbose=False)
    return spec, params, model, path


@pytest.mark.parametrize("aggregation", ["scatter", "mega"])
def test_hybridv2_forward_matches_jax(models, aggregation):
    spec, params, model, _ = models
    a = _arrays()
    key = jax.random.key(11)
    ref = jax_model_apply(params, spec, _jax_graph(a),
                          jnp.asarray(a["seq_onehot"]),
                          jnp.asarray(a["props"]), key, deterministic=True,
                          aggregation=aggregation)
    eps = torch.from_numpy(_jax_eps(key, (B, SMALL["vae_latent_dim"])))
    with torch.no_grad():
        out = model_apply(model, GraphBatch.from_numpy(a, "cpu"),
                          torch.from_numpy(a["seq_onehot"]),
                          torch.from_numpy(a["props"]), deterministic=True,
                          aggregation=aggregation, eps=eps)
    for name in FIELDS:
        got, want = getattr(out, name).numpy(), np.asarray(getattr(ref, name))
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4,
                                   err_msg=name)


def test_auto_is_scatter_on_cpu(models):
    *_, model, _ = models
    b = random_sample_batch(B, N, E, L, seed=4)
    eps = torch.zeros(B, SMALL["vae_latent_dim"])
    with torch.no_grad():
        outs = [model_apply(model, b.graph, b.seq_onehot, b.props,
                            deterministic=True, aggregation=agg, eps=eps)
                for agg in ("auto", "scatter")]
    torch.testing.assert_close(outs[0].logits, outs[1].logits,
                               atol=0.0, rtol=0.0)


@pytest.mark.parametrize("name", ["onehot", "fused", "onehot_remat",
                                  "pallas"])
def test_unported_aggregations_raise(models, name):
    *_, model, _ = models
    b = random_sample_batch(B, N, E, L, seed=4)
    with pytest.raises(ValueError, match="ROADMAP.md"):
        model_apply(model, b.graph, b.seq_onehot, b.props,
                    deterministic=True, aggregation=name,
                    generator=torch.Generator().manual_seed(0))


def test_training_mode_forward_draws_from_generator(models):
    *_, model, _ = models
    b = random_sample_batch(B, N, E, L, seed=5)

    def run(seed):
        with torch.no_grad():
            return model_apply(model, b.graph, b.seq_onehot, b.props,
                               deterministic=False,
                               generator=torch.Generator().manual_seed(seed))

    o1, o2, o3 = run(0), run(0), run(1)
    torch.testing.assert_close(o1.logits, o2.logits, atol=0.0, rtol=0.0)
    assert not torch.equal(o1.logits, o3.logits)
    with pytest.raises(ValueError, match="Generator"):
        model_apply(model, b.graph, b.seq_onehot, b.props,
                    deterministic=False)


def test_random_sample_batch_bit_identical_to_jax():
    want = jax_random_sample_batch(2, 12, 40, 5, seed=9)
    got = random_sample_batch(2, 12, 40, 5, seed=9)
    for k in ("node_feat", "coords", "edge_src", "edge_dst", "edge_feat",
              "edge_mask", "node_mask", "num_nodes"):
        np.testing.assert_array_equal(getattr(got.graph, k).numpy(),
                                      np.asarray(getattr(want.graph, k)))
    for k in ("seq_onehot", "props", "target"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)))


def test_write_example_bit_identical_to_jax(tmp_path):
    jax_write_example(str(tmp_path / "jax.npz"), seq_len=7)
    write_example(str(tmp_path / "port.npz"), seq_len=7)
    with np.load(tmp_path / "jax.npz") as zj, \
            np.load(tmp_path / "port.npz") as zp:
        assert sorted(zj.files) == sorted(zp.files)
        for k in zj.files:
            assert zj[k].dtype == zp[k].dtype, k
            np.testing.assert_array_equal(zj[k], zp[k])


def test_state_dict_names_are_jax_treepaths(models):
    _, params, model, _ = models
    flat, _ = jax.tree.flatten_with_path(params)
    jax_names = {jax_name(jax.tree_util.keystr(p)) for p, _ in flat}
    assert jax_names == set(model.state_dict())


def test_jax_name_parsing():
    assert jax_name("['gcn'][0]['edge_mlp'][0]['w']") == "gcn.0.edge_mlp.0.w"
    assert params_from_jax({"['vae']['fc1']['b']": np.zeros(2)}).keys() == {
        "vae.fc1.b"}
    with pytest.raises(ValueError):
        jax_name("gcn.0.w")


def test_load_raises_on_shape_mismatch_and_foreign_file(models, tmp_path):
    *_, path = models
    _, wide = build_model("HybridModelv2", L * 21,
                          torch.Generator().manual_seed(0),
                          **{**SMALL, "gat_hidden_channels": 32})
    with pytest.raises(ValueError, match="shape"):
        load_jax_checkpoint(path, wide, verbose=False)
    foreign = str(tmp_path / "foreign.npz")
    np.savez(foreign, **{"['other']['w']": np.zeros(3)})
    with pytest.raises(ValueError, match="no parameter names"):
        load_jax_checkpoint(foreign, wide, verbose=False)


def test_zoo_matches_jax_registry():
    from immunostruct_tpu.models.zoo import model_map as jax_map
    assert len(model_map) == 14
    for name, spec in jax_map.items():
        assert (dataclasses.asdict(model_map[name])
                == dataclasses.asdict(spec))
