"""The PyTorch port's HybridModelv2 forward against the JAX package's.

JAX ``build_model`` params are saved with the JAX ``save_checkpoint`` and
loaded into the port with ``load_jax_checkpoint``; the same seeded numpy
batch (with padded edges and self-loops) goes through both ``model_apply``
calls with ``deterministic=True``. The VAE noise is the one JAX draws,
replayed from the key splits of ``model_apply``/``forward_item``, and
handed to the port as ``eps``. Outputs are compared in f32 within
atol=1e-5, rtol=1e-4, under aggregation 'scatter' and 'mega' (the JAX mega
kernel in interpret mode; the port's plain version of its kernel).

Serving runs bf16, so the forward is also compared in bf16, with the noise
drawn as JAX draws it there (in the compute dtype, ``trunk.py:274``).
logits, mu, logvar, recon and the attention weights are within one bf16
step of JAX's, element by element, and differ in at most 1% of their
entries (measured: none, and 0.13% of the attention weights under
'mega'). The embedding (the mean over nodes of values that differ by one
step in a few places) is held to max|diff| <= 1e-3 * max|JAX| (measured
9.8e-4 at a largest value of 2.1, 4.6e-4 of it).
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
from tests.torch_threads import one_torch_thread  # noqa: F401

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


def _jax_eps(key, shape, dtype=jnp.float32):
    """The eps model_apply draws: key -> (k_item, k_cls); k_item ->
    (k_eps, k_drop); normal(k_eps), in the compute dtype."""
    k_item, _ = jax.random.split(key)
    k_eps, _ = jax.random.split(k_item)
    eps = jax.random.normal(k_eps, shape, dtype)
    return torch.from_numpy(np.array(eps.astype(jnp.float32))).to(
        getattr(torch, jnp.dtype(dtype).name))


def _within_one_bf16_step(got, want, share):
    """Each element within one bf16 step (the spacing at the larger of the
    two magnitudes) of ``want``; at most ``share`` of them differ."""
    mag = np.maximum(np.abs(got), np.abs(want))
    step = 2.0 ** (np.floor(np.log2(np.where(mag > 0, mag, 1.0))) - 7)
    assert (np.abs(got - want) <= np.where(mag > 0, step, 0.0)).all()
    assert (got != want).mean() <= share, (got != want).mean()


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
    eps = _jax_eps(key, (B, SMALL["vae_latent_dim"]))
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


@pytest.mark.parametrize("aggregation", ["scatter", "mega"])
def test_hybridv2_bf16_forward_matches_jax(models, aggregation):
    spec, params, model, _ = models
    a = _arrays()
    key = jax.random.key(11)
    ref = jax_model_apply(params, spec, _jax_graph(a),
                          jnp.asarray(a["seq_onehot"]),
                          jnp.asarray(a["props"]), key, deterministic=True,
                          aggregation=aggregation,
                          compute_dtype=jnp.bfloat16)
    eps = _jax_eps(key, (B, SMALL["vae_latent_dim"]), jnp.bfloat16)
    with torch.no_grad():
        out = model_apply(model, GraphBatch.from_numpy(a, "cpu"),
                          torch.from_numpy(a["seq_onehot"]),
                          torch.from_numpy(a["props"]), deterministic=True,
                          aggregation=aggregation, eps=eps,
                          compute_dtype=torch.bfloat16)
    for name in FIELDS:
        got, want = getattr(out, name), getattr(ref, name)
        assert str(got.dtype).split(".")[-1] == str(want.dtype), name
        got = got.float().numpy()
        want = np.asarray(want.astype(jnp.float32))
        assert got.shape == want.shape, name
        if name == "embedding":
            assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()
        else:
            _within_one_bf16_step(got, want, 0.01)


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
    """At an E that is not a multiple of 128, where the JAX package falls
    back from 'fused' and 'pallas' to 'onehot': 'fused' and 'pallas' raise
    and name 'onehot', and 'onehot' and 'onehot_remat' (ported now) run and
    give 'scatter''s logits in f32."""
    *_, model, _ = models
    b = random_sample_batch(B, N, 100, L, seed=4)

    def run(aggregation):
        with torch.no_grad():
            return model_apply(model, b.graph, b.seq_onehot, b.props,
                               deterministic=True, aggregation=aggregation,
                               generator=torch.Generator().manual_seed(0))

    if name in ("fused", "pallas"):
        with pytest.raises(ValueError, match="use 'onehot'"):
            run(name)
    else:
        torch.testing.assert_close(run(name).logits, run("scatter").logits,
                                   atol=1e-5, rtol=1e-4)


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


ZOO_FIELDS = ("logits", "node_logits", "mu", "logvar", "recon", "embedding",
              "attention")


@pytest.mark.parametrize("name", sorted(model_map))
def test_zoo_forward_matches_jax(name, tmp_path):
    """Every registry spec's forward against JAX's: f32, 'scatter', B=3,
    N=16, E=128, the small widths above, JAX's eps injected; every output
    field (None on both sides, or within atol=1e-5, rtol=1e-4)."""
    spec, params = jax_build_model(name, L * 21, jax.random.key(21), **SMALL)
    path = str(tmp_path / "model.ckpt")
    save_checkpoint(path, params)
    _, model = build_model(name, L * 21, torch.Generator().manual_seed(0),
                           **SMALL)
    load_jax_checkpoint(path, model, verbose=False)
    a = _arrays(seed=2)
    key = jax.random.key(13)
    ref = jax_model_apply(params, spec, _jax_graph(a),
                          jnp.asarray(a["seq_onehot"]),
                          jnp.asarray(a["props"]), key, deterministic=True,
                          aggregation="scatter")
    eps = _jax_eps(key, (B, SMALL["vae_latent_dim"]))
    with torch.no_grad():
        out = model_apply(model, GraphBatch.from_numpy(a, "cpu"),
                          torch.from_numpy(a["seq_onehot"]),
                          torch.from_numpy(a["props"]), deterministic=True,
                          aggregation="scatter", eps=eps)
    for field in ZOO_FIELDS:
        got, want = getattr(out, field), getattr(ref, field)
        assert (got is None) == (want is None), field
        if got is not None:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-5, rtol=1e-4, err_msg=field)


def test_ssl_train_step_matches_jax(tmp_path):
    """One Adam step of an SSL spec (HybridModel_SSL: the node_logits head
    and its cross-entropy on the masked residue) against the JAX Trainer:
    f32, 'scatter', dropout off; the loss within rtol=1e-5, the gradients
    and the updated parameters as tests/test_torch_port_train.py holds
    them."""
    from immunostruct_tpu.procedures.train import Trainer as JaxTrainer
    from immunostruct_tpu.procedures.train import make_optimizer as jax_opt
    from immunostruct_tpu.structs import SampleBatch as JaxSampleBatch
    from immunostruct_tpu.utils.losses import LossConfig as JaxLossConfig
    from immunostruct_tpu.utils.schedule import constant_lr as jax_lr
    from immunostruct_tpu_torch.procedures.train import (
        Trainer, make_optimizer, step_generator,
    )
    from immunostruct_tpu_torch.structs import SampleBatch
    from immunostruct_tpu_torch.utils.losses import LossConfig
    from immunostruct_tpu_torch.utils.schedule import constant_lr
    from tests.test_torch_port_train import (
        _assert_grads_match, _assert_params_match, _grads_of, _plain_eps,
    )

    name, vae_dim = "HybridModel_SSL", L * 21
    small = dict(SMALL, dropout_rate=0.0)
    spec, params = jax_build_model(name, vae_dim, jax.random.key(3), **small)
    jt = JaxTrainer(spec, JaxLossConfig(vae_dim, 1.0, sequence=True, ssl=True),
                    binary=True, optimizer=jax_opt("adam", jax_lr(1e-3)),
                    aggregation="scatter", donate=False)
    js = jt.init_state(params, jax.random.key(5))
    path = str(tmp_path / "init.ckpt")
    save_checkpoint(path, js.params)
    _, model = build_model(name, vae_dim, torch.Generator().manual_seed(0),
                           **small)
    pt = Trainer(model.spec, LossConfig(vae_dim, 1.0, sequence=True, ssl=True),
                 binary=True, optimizer=make_optimizer("adam",
                                                       constant_lr(1e-3)),
                 aggregation="scatter")
    ps = pt.init_state(model)
    load_jax_checkpoint(path, ps.model, verbose=False)
    a = _arrays(seed=6)
    a["target"] = (np.arange(B) % 2 == 0).astype(np.float32)
    a["aux_residue"] = np.array([3, -1, 17], np.int32)   # one unmasked row
    jbatch = JaxSampleBatch(graph=_jax_graph(a),
                            seq_onehot=jnp.asarray(a["seq_onehot"]),
                            props=jnp.asarray(a["props"]),
                            target=jnp.asarray(a["target"]),
                            aux_residue=jnp.asarray(a["aux_residue"]))
    batch = SampleBatch.from_numpy(a, "cpu")
    key = jax.random.key(7)
    eps = _plain_eps(jax.random.fold_in(key, 0), B)
    jloss, jgrads = jt._loss_and_grads(js.params, jbatch,
                                       jax.random.fold_in(key, 0))
    loss = pt.loss_and_grads(ps.model, batch, step_generator(0, 0, "cpu"),
                             eps)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _assert_grads_match(ps.model, jgrads)
    js, jl = jt._train_step(js, jbatch, key)
    ps, pl = pt.train_step(ps, batch, 0, eps=eps)
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-5)
    _assert_params_match(ps.model, js.params, [_grads_of(ps.model)])
