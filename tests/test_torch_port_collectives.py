"""The port's collectives (immunostruct_tpu_torch/parallel/collectives.py)
against the JAX package's, on the CPU.

The port's side runs in spawned gloo ranks (tests/torch_parallel_ranks.py,
JAX-free), one group of 4 and one of 3 for the module; JAX's runs under
``shard_map`` on a sub-mesh of the conftest's 8 virtual devices of the
same size. Each rank's input is its row of a seeded numpy array.

- psum / pmean / pmax / all_gather (tiled and stacked) / ppermute_ring
  against JAX's at world 4: equal bits (one sum of four f32 values: gloo
  and XLA may associate it differently, so the sums are held to one f32
  rounding of each partial sum, 4 * 2^-24 * sum|x|; the rest are copies);
- ring_all_reduce bit for bit against JAX's ring_all_reduce for the shapes
  (), (5,), (8,), (3, 7), (16, 9) at world 4 and 3 (padding): both follow
  one schedule, and f32 addition is commutative;
- the form staged through host memory (what gloo needs for CUDA send/recv)
  equal to the native form, bit for bit, for all_gather, ppermute_ring and
  the ring;
- no spawned rank loaded JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from immunostruct_tpu.parallel import collectives as jc
from immunostruct_tpu_torch.parallel.dryrun import spawn
from tests import torch_parallel_ranks as ranks

SHAPES = [(), (5,), (8,), (3, 7), (16, 9)]


def _inputs(world):
    rng = np.random.default_rng(world)
    arrays = {"x": rng.standard_normal((world, 6)).astype(np.float32)}
    for i, shape in enumerate(SHAPES):
        arrays[f"ring{i}"] = rng.standard_normal((world,) + shape).astype(
            np.float32)
    return arrays


@pytest.fixture(scope="module", params=[4, 3], ids=["world4", "world3"])
def group(request):
    world = request.param
    inputs = _inputs(world)
    return world, inputs, spawn(ranks.collectives, world, inputs)


def _jax(world, fn, x, out_spec=P("data")):
    mesh = Mesh(np.asarray(jax.devices()[:world]), ("data",))
    return np.asarray(shard_map(jax.jit(fn), mesh=mesh, in_specs=P("data"),
                                out_specs=out_spec)(jnp.asarray(x)))


def _per_rank(out, world):
    """A shard_map output of per-rank rows [world * k, ...] as a list."""
    return np.split(out, world)


def test_psum_pmean_pmax_match_jax(group):
    world, inputs, outs = group
    x = inputs["x"]
    want = {name: _per_rank(_jax(world, lambda v, f=f: f(v), x), world)
            for name, f in (("psum", jc.psum), ("pmean", jc.pmean),
                            ("pmax", jc.pmax))}
    bound = world * 2.0 ** -24 * np.abs(x).sum(0)
    for r, out in enumerate(outs):
        assert np.array_equal(out["pmax"], want["pmax"][r][0])
        assert (np.abs(out["psum"] - want["psum"][r][0]) <= bound).all()
        assert (np.abs(out["pmean"] - want["pmean"][r][0])
                <= bound / world).all()


def test_all_gather_and_ppermute_match_jax(group):
    world, inputs, outs = group
    x = inputs["x"]
    gathered = _per_rank(_jax(world, lambda v: jc.all_gather(v[0])[None], x),
                         world)
    permuted = _jax(world, lambda v: jc.ppermute_ring(v, shift=1), x)
    for r, out in enumerate(outs):
        assert np.array_equal(out["all_gather_native"], gathered[r][0])
        assert np.array_equal(out["stacked_native"], x)
        assert np.array_equal(out["ppermute_native"], permuted[r])


@pytest.mark.parametrize("i", range(len(SHAPES)),
                         ids=[str(s) for s in SHAPES])
def test_ring_all_reduce_bits_match_jax(group, i):
    world, inputs, outs = group
    a, shape = inputs[f"ring{i}"], SHAPES[i]

    def f(v):
        return jc.ring_all_reduce(v.reshape(shape))[None]

    want = _jax(world, f, a)
    for r, out in enumerate(outs):
        got = out[f"ring{i}_native"]
        assert got.shape == shape and got.dtype == np.float32
        assert np.array_equal(got, want[r]), (shape, r)
        # and the ring is a sum: within the f32 roundoff of gloo's
        np.testing.assert_allclose(got, out[f"ring{i}_psum"],
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("op", ["all_gather", "stacked", "ppermute", "ring"])
def test_staged_form_equals_native(group, op):
    _, _, outs = group
    for out in outs:
        keys = [k[:-len("_native")] for k in out if k.endswith("_native")
                and k.startswith(op)]
        assert keys
        for k in keys:
            assert np.array_equal(out[k + "_staged"], out[k + "_native"]), k


def test_no_rank_loads_jax(group):
    assert not any(out["jax"] for out in group[2])
