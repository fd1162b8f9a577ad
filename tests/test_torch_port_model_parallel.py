"""Model parallelism in the port (immunostruct_tpu_torch/parallel/{tensor,
pipeline,mp,trainer,dryrun}.py and the hooks in models/trunk.py), on the
CPU: gloo ranks spawned once a group size (tests/torch_parallel_ranks.py,
JAX-free); JAX's side under ``shard_map`` on a sub-mesh of the conftest's
8 virtual devices of the same size.

- ``column_parallel_apply`` / ``row_parallel_apply`` / ``tp_mlp_apply``:
  outputs and gradients against JAX's at world 4 (1-D 'model') and on a
  (2 data, 2 model) grid, to JAX's test_tensor_parallel.py bounds (rtol
  2e-5 outputs, rtol 2e-4 / atol 2e-5 gradients);
- ``gpipe_apply`` against JAX's at 4 stages for 1, 2 and 4 microbatches,
  and its gradients against the sequential stack (test_pipeline_
  parallel.py's bounds);
- ``pad_pipeline_stages`` against JAX's;
- the real comparative model's ``make_mp_train_step`` against the port's
  dense step (B=8, N=24, E=64, L=12 as JAX's test_model_parallel.py, VAE
  noise pinned, dropout off): TP x DP on (2 data, 4 model), GPipe over 8
  stages (the 5 hidden convs and 3 identity stages) and TP x PP x DP on
  (2, 2, 2) with 2 hidden convs: loss within rtol 2e-5, parameters after
  the step to ``_assert_trees_close``'s rtol 2e-4, atol 2e-5. The port's
  dense step is held to JAX's elsewhere (test_torch_port_train.py); JAX's
  own model-parallel steps are multi-minute compiles and stay out of
  tier 1;
- ``dryrun_multichip(4)`` on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from immunostruct_tpu.ops.nnp import linear_apply, mlp_init
from immunostruct_tpu.parallel.mp import (
    pad_pipeline_stages as jax_pad_pipeline_stages,
)
from immunostruct_tpu.parallel.pipeline import gpipe_apply as jax_gpipe
from immunostruct_tpu.parallel.tensor import (
    column_parallel_apply as jax_column, tp_mlp_apply as jax_tp_mlp,
)
from immunostruct_tpu_torch.parallel.dryrun import (
    StepCase, dryrun_multichip, spawn,
)
from immunostruct_tpu_torch.parallel.mp import pad_pipeline_stages
from tests import torch_parallel_ranks as ranks
from tests.torch_threads import one_torch_thread  # noqa: F401

B, N, E, L = 8, 24, 64, 12
CASE = StepCase(name="HybridModelv2_Comparative", b=B, nodes=N, edges=E,
                seq_len=L)


def _mlp(key, sizes):
    return [{k: np.asarray(v) for k, v in layer.items()}
            for layer in mlp_init(jax.random.key(key), sizes)]


def _dense_mlp(params, x):
    return linear_apply(params[1], jax.nn.relu(linear_apply(params[0], x)))


@pytest.fixture(scope="module")
def world4():
    """The TP primitives on a 1-D 'model' axis of 4 and on a (2, 2) grid,
    and the GPipe schedule over 4 stages, in one group of four."""
    rng = np.random.default_rng(0)
    mlp1 = _mlp(0, [48, 64, 40])
    x1 = rng.standard_normal((16, 48)).astype(np.float32)
    y1 = rng.standard_normal((16, 40)).astype(np.float32)
    mlp2 = _mlp(4, [24, 32, 16])
    x2 = rng.standard_normal((8, 24)).astype(np.float32)
    y2 = rng.standard_normal((8, 16)).astype(np.float32)
    ks = jax.random.split(jax.random.key(3), 4)
    stack = [{k: np.asarray(v) for k, v in
              mlp_init(k_, [12, 12])[0].items()} for k_ in ks]
    stacked = {k: np.stack([s[k] for s in stack]) for k in stack[0]}
    xs = rng.standard_normal((8, 12)).astype(np.float32)
    ys = rng.standard_normal((8, 12)).astype(np.float32)
    inputs = dict(mlp1=mlp1, x1=x1, y1=y1, mlp2=mlp2, x2=x2, y2=y2,
                  stacked=stacked, xs=xs, ys=ys)
    return inputs, spawn(ranks.primitives4, 4, inputs)


def test_tp_mlp_matches_jax_1d(world4):
    inputs, outs = world4
    mlp, x, y = inputs["mlp1"], inputs["x1"], inputs["y1"]
    jmlp = jax.tree.map(jnp.asarray, mlp)
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("model",))

    def inner(p, x):
        return (jax_tp_mlp(p, x),
                jax_column(p[0]["w"], p[0]["b"], x))

    def tp_loss(p, x):
        # one program: the pair's output and (aux) the column shards
        out, shard = shard_map(inner, mesh=mesh, in_specs=(P(), P()),
                               out_specs=(P(), P(None, "model")))(p, x)
        return jnp.mean((out - y) ** 2), shard

    want = np.asarray(_dense_mlp(jmlp, x))
    (jl, shard), (jg, jgx) = jax.value_and_grad(
        tp_loss, argnums=(0, 1), has_aux=True)(jmlp, jnp.asarray(x))
    per = 64 // 4
    for r, out in enumerate(outs):
        tp = out["tp1"]
        assert tp["column"].shape == (16, per)
        np.testing.assert_allclose(tp["column"],
                                   np.asarray(shard)[:, r * per:(r + 1) * per],
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(tp["pair"], want, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(tp["pred"], want, rtol=2e-5, atol=2e-5)
        assert tp["loss"] == pytest.approx(float(jl), rel=2e-5)
        np.testing.assert_allclose(tp["x_grad"], np.asarray(jgx),
                                   rtol=2e-4, atol=2e-5)
        for got, layer in zip(tp["grads"], jg):
            for k, w in layer.items():
                np.testing.assert_allclose(got[k], np.asarray(w),
                                           rtol=2e-4, atol=2e-5, err_msg=k)


def test_tp_dp_grid_with_grads_matches_jax(world4):
    """JAX's test_tp_dp_2d_mesh_with_grads on a (2, 2) grid."""
    inputs, outs = world4
    mlp, x, y = inputs["mlp2"], inputs["x2"], inputs["y2"]
    jmlp = jax.tree.map(jnp.asarray, mlp)
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                ("data", "model"))

    def inner(p, xs, ys):
        se = jnp.sum((jax_tp_mlp(p, xs) - ys) ** 2)
        return jax.lax.psum(se, "data") / (8 * 16)

    def sharded_loss(p):
        return shard_map(inner, mesh=mesh,
                         in_specs=(P(), P("data"), P("data")),
                         out_specs=P())(p, jnp.asarray(x), jnp.asarray(y))

    jl, jg = jax.value_and_grad(sharded_loss)(jmlp)
    for out in outs:
        tp = out["tp2"]
        assert tp["loss"] == pytest.approx(float(jl), rel=2e-5)
        for got, layer in zip(tp["grads"], jg):
            for k, w in layer.items():
                np.testing.assert_allclose(got[k], np.asarray(w),
                                           rtol=2e-4, atol=2e-5, err_msg=k)


def _layer(p, x):
    return jax.nn.tanh(linear_apply(p, x))


@pytest.mark.parametrize("n_micro", [1, 2, 4])
def test_gpipe_matches_jax(world4, n_micro):
    inputs, outs = world4
    stacked = jax.tree.map(jnp.asarray, inputs["stacked"])
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("pipe",))
    want = shard_map(lambda p, x: jax_gpipe(_layer, p, x, n_micro),
                     mesh=mesh, in_specs=(P(), P()), out_specs=P())(
        stacked, jnp.asarray(inputs["xs"]))
    for out in outs:
        np.testing.assert_allclose(out["gpipe"][f"out{n_micro}"],
                                   np.asarray(want), rtol=2e-5, atol=2e-5)


def test_gpipe_grads_match_sequential_stack(world4):
    inputs, outs = world4
    stacked = {k: torch.from_numpy(v).requires_grad_(True)
               for k, v in inputs["stacked"].items()}
    x = torch.from_numpy(inputs["xs"]).requires_grad_(True)
    h = x
    for s in range(4):
        h = torch.tanh(h @ stacked["w"][s] + stacked["b"][s])
    loss = ((h - torch.from_numpy(inputs["ys"])) ** 2).mean()
    loss.backward()
    for out in outs:
        g = out["gpipe"]
        assert g["loss"] == pytest.approx(loss.item(), rel=2e-5)
        np.testing.assert_allclose(g["x_grad"], x.grad.numpy(), rtol=2e-4,
                                   atol=2e-5)
        for k, p in stacked.items():
            np.testing.assert_allclose(g["grads"][k], p.grad.numpy(),
                                       rtol=2e-4, atol=2e-5, err_msg=k)


def test_no_rank_loads_jax(world4, world8):
    assert not any(out["jax"] for out in world4[1])
    assert not any(out["jax"] for out in world8)


@pytest.mark.parametrize("layers,stages", [(3, 5), (5, 8), (2, 2)])
def test_pad_pipeline_stages_matches_jax(layers, stages):
    mods = [torch.nn.Linear(2, 2) for _ in range(layers)]
    got, on = pad_pipeline_stages(mods, stages)
    _, jon = jax_pad_pipeline_stages(
        [{"w": jnp.zeros((2, 2))} for _ in range(layers)], stages)
    np.testing.assert_array_equal(on.numpy(), np.asarray(jon))
    assert got[:layers] == mods and got[layers:] == [None] * (stages - layers)
    with pytest.raises(AssertionError):
        pad_pipeline_stages(mods, layers - 1)


MP_CASES = [
    ("tp_dp", CASE, (2, 4), ("data", "model"), dict(tp_axis="model"), "data"),
    ("pp", CASE, (8,), ("pipe",), dict(pp_axis="pipe", pp_microbatches=4),
     None),
    ("tp_pp_dp", dataclasses.replace(CASE, seed=1,
                                     overrides=(("gcn_layers", 2),)),
     (2, 2, 2), ("data", "model", "pipe"),
     dict(tp_axis="model", pp_axis="pipe", pp_microbatches=2), "data"),
]


@pytest.fixture(scope="module")
def world8():
    return spawn(ranks.mp_steps, 8, MP_CASES)


@pytest.mark.parametrize("label", [c[0] for c in MP_CASES])
def test_mp_step_matches_dense(world8, label):
    ref = world8[0][label + "/ref"]
    for out in world8:
        got = out[label]
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=2e-5)
        for k, want in ref["params"].items():
            np.testing.assert_allclose(got["params"][k].numpy(),
                                       want.numpy(), rtol=2e-4, atol=2e-5,
                                       err_msg=k)


def test_dryrun_multichip_on_the_cpu():
    readings = dryrun_multichip(4)
    assert readings["dp_rel"] < 2e-5
    assert readings["tp"]["worst_grad"] <= 1.0
    assert readings["pp"]["worst_grad"] <= 1.0
