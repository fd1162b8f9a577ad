"""The PyTorch port's losses, contrastive term, schedules, optimizers and
seeding against the JAX package's, on the CPU, from the same seeded numpy
inputs.

Tolerances: losses and the contrastive term rtol=1e-5, atol=1e-7 (f32
roundoff of other summation orders), their gradients atol=1e-6,
rtol=1e-4; schedules rtol=1e-6 (the JAX ones compute in f32, the port's in
Python floats); parameters after five optimizer steps atol=1e-6,
rtol=1e-6 (optax and torch.optim write the same update with other
roundings; measured 1.9e-7, three f32 steps at a parameter of 0.6).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from immunostruct_tpu.procedures.train import make_optimizer as jax_make_opt
from immunostruct_tpu.utils import contrastive as jax_contrastive
from immunostruct_tpu.utils import losses as jax_losses
from immunostruct_tpu.utils import schedule as jax_schedule
from immunostruct_tpu_torch.procedures.train import make_optimizer
from immunostruct_tpu_torch.utils import contrastive, losses, schedule
from immunostruct_tpu_torch.utils.checkpoint import load_params, params_from_jax
from immunostruct_tpu_torch.utils.seeding import seed_everything
from tests.torch_threads import one_torch_thread  # noqa: F401

B, L = 6, 5
VAE = L * 21
LOSS_TOL = dict(rtol=1e-5, atol=1e-7)


def _loss_inputs(seed, binary_target=True):
    rng = np.random.default_rng(seed)
    target = ((rng.random(B) > 0.5).astype(np.float32) if binary_target
              else rng.random(B).astype(np.float32))
    return dict(
        recon=rng.standard_normal((B, VAE)).astype(np.float32),
        x_flat=rng.random((B, L, 21)).astype(np.float32),
        mu=rng.standard_normal((B, 8)).astype(np.float32),
        logvar=0.3 * rng.standard_normal((B, 8)).astype(np.float32),
        pred=rng.standard_normal((B, 1)).astype(np.float32),
        target=target,
        node_logits=rng.standard_normal((B, 20)).astype(np.float32),
        residue=np.array([3, -1, 19, 0, 7, -1], np.int32),
    )


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("sequence", [True, False])
@pytest.mark.parametrize("ssl", [True, False])
def test_stage_losses_match_jax(binary, sequence, ssl):
    a = _loss_inputs(int(binary) * 4 + int(sequence) * 2 + int(ssl),
                     binary_target=binary)
    cfg = dict(vae_input_dim=VAE, pos_weight=2.5, sequence=sequence, ssl=ssl)
    want = jax_losses.make_loss_fn(jax_losses.LossConfig(**cfg), binary)(
        *(jnp.asarray(a[k]) for k in ("recon", "x_flat", "mu", "logvar",
                                      "pred", "target")),
        node_logits=jnp.asarray(a["node_logits"]),
        residue=jnp.asarray(a["residue"]))
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    got = losses.make_loss_fn(losses.LossConfig(**cfg), binary)(
        t["recon"], t["x_flat"], t["mu"], t["logvar"], t["pred"],
        t["target"], node_logits=t["node_logits"], residue=t["residue"])
    np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)


def test_stage_weights_are_the_references():
    """5 * BCE + 0.1 * recon + 0.1 * KLD and 2 * MSE + 0.5 + 0.5: each term
    alone, with the others made zero."""
    cfg = losses.LossConfig(VAE, pos_weight=1.0, sequence=True)
    x = torch.zeros(B, L, 21)
    zeros = torch.zeros(B, 8)
    pred = torch.zeros(B, 1)
    bce = losses.bce_loss(cfg, torch.ones(B, VAE), x, zeros, zeros, pred,
                          torch.zeros(B))
    np.testing.assert_allclose(float(bce), 5 * np.log(2) + 0.1 * 1.0,
                               rtol=1e-6)
    reg = losses.regression_loss(cfg, torch.ones(B, VAE), x, zeros, zeros,
                                 pred + 1.0, torch.zeros(B))
    np.testing.assert_allclose(float(reg), 2.0 + 0.5, rtol=1e-6)


def test_ssl_term_skips_and_masks():
    assert losses._ssl_term(None, torch.zeros(B)) == 0.0
    a = _loss_inputs(9)
    want = jax_losses._ssl_term(jnp.asarray(a["node_logits"]),
                                jnp.asarray(a["residue"]))
    got = losses._ssl_term(torch.from_numpy(a["node_logits"]),
                           torch.from_numpy(a["residue"]))
    np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)


def test_pos_weight_from_counts_matches_jax():
    for counts in ({0: 30, 1: 10}, {0.0: 7.0, 1.0: 2.0}, {1: 4}):
        assert (losses.pos_weight_from_counts(counts)
                == jax_losses.pos_weight_from_counts(counts))


def _projector(seed, emb):
    params = jax_contrastive.paired_contrastive_init(jax.random.key(seed),
                                                     embedding_dim=emb)
    flat, _ = jax.tree.flatten_with_path(params)
    proj = contrastive.PairedContrastiveProjector(
        emb, generator=torch.Generator().manual_seed(0))
    load_params(proj, params_from_jax(
        {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}),
        verbose=False)
    return params, proj


@pytest.mark.parametrize("target", ["two_class", "one_class", "soft"])
def test_contrastive_loss_and_gradients_match_jax(target):
    rng = np.random.default_rng(3)
    emb_c = rng.standard_normal((B, 24)).astype(np.float32)
    emb_w = rng.standard_normal((B, 24)).astype(np.float32)
    y = {"two_class": np.array([1, 0, 1, 1, 0, 0], np.float32),
         "one_class": np.ones(B, np.float32),
         "soft": rng.random(B).astype(np.float32)}[target]
    params, proj = _projector(2, 24)

    def jax_loss(p, c, w):
        return jax_contrastive.paired_contrastive_loss(p, c, w,
                                                       jnp.asarray(y))

    want, (gp, gc) = jax.value_and_grad(jax_loss, argnums=(0, 1))(
        params, jnp.asarray(emb_c), jnp.asarray(emb_w))
    c = torch.from_numpy(emb_c).requires_grad_(True)
    got = contrastive.paired_contrastive_loss(
        proj, c, torch.from_numpy(emb_w), torch.from_numpy(y))
    got.backward()
    got = got.item()
    np.testing.assert_allclose(got, float(want), **LOSS_TOL)
    if target != "two_class":
        # the gate: no contrast without both classes of binary targets
        assert got == 0.0
        assert torch.count_nonzero(c.grad) == 0
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(gc), atol=1e-6,
                               rtol=1e-4)
    np.testing.assert_allclose(proj.fc1.w.grad.numpy(),
                               np.asarray(gp["fc1"]["w"]), atol=1e-6,
                               rtol=1e-4)


def test_projector_names_are_jax_treepaths():
    params, proj = _projector(0, 16)
    flat, _ = jax.tree.flatten_with_path(params)
    assert ({".".join(str(getattr(k, "key", k)) for k in p) for p, _ in flat}
            == set(proj.state_dict()))


@pytest.mark.parametrize("epoch", [0, 1, 2, 3, 7, 10, 15])
def test_schedules_match_jax(epoch):
    pairs = [
        (schedule.linear_warmup_cosine_annealing(1e-3, 4, 12, 1e-5, 1e-6),
         jax_schedule.linear_warmup_cosine_annealing(1e-3, 4, 12, 1e-5,
                                                     1e-6)),
        (schedule.linear_warmup_cosine_annealing(2e-3, 0, 10),
         jax_schedule.linear_warmup_cosine_annealing(2e-3, 0, 10)),
        (schedule.constant_lr(3e-4), jax_schedule.constant_lr(3e-4)),
        (schedule.linear_warmup_constant(1e-3, 5, 1e-4),
         jax_schedule.linear_warmup_constant(1e-3, 5, 1e-4)),
    ]
    for port, ref in pairs:
        np.testing.assert_allclose(port(epoch), float(ref(epoch)),
                                   rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("name,decay", [("adam", 0.0), ("adam", 0.1),
                                        ("adamw", 0.05)])
def test_optimizers_match_optax(name, decay):
    """Five updates of two parameters from the same gradients, with a
    warmup schedule over epochs of two steps each (the rate changes at
    steps 2 and 4): Adam, Adam with coupled L2, AdamW."""
    rng = np.random.default_rng(1)
    p0 = {"a": rng.standard_normal((3, 4)).astype(np.float32),
          "b": rng.standard_normal(5).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(5)]
    sched = (schedule.linear_warmup_cosine_annealing(1e-2, 2, 6),
             jax_schedule.linear_warmup_cosine_annealing(1e-2, 2, 6))

    opt = jax_make_opt(name, sched[1], decay, steps_per_epoch=2)
    params = {k: jnp.asarray(v) for k, v in p0.items()}
    state = opt.init(params)
    for g in grads:
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                state, params)
        params = optax.apply_updates(params, upd)

    config = make_optimizer(name, sched[0], decay, steps_per_epoch=2)
    tensors = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in p0.items()}
    torch_opt = config.build(tensors.values())
    for step, g in enumerate(grads):
        for k, t in tensors.items():
            t.grad = torch.from_numpy(g[k])
        for group in torch_opt.param_groups:
            group["lr"] = config.lr(step)
        torch_opt.step()
    assert [config.lr(s) for s in range(5)] == pytest.approx(
        [float(sched[1](s // 2)) for s in range(5)], rel=1e-6)
    for k, t in tensors.items():
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(params[k]),
                                   atol=1e-6, rtol=1e-6, err_msg=k)


def test_make_optimizer_rejects_unknown_names():
    with pytest.raises(ValueError, match="adam"):
        make_optimizer("sgd", schedule.constant_lr(1e-3))
    cfg = make_optimizer("adamw", schedule.constant_lr(1e-3), 0.01)
    assert dataclasses.asdict(cfg)["weight_decay"] == 0.01


def test_seed_everything_returns_the_root_generator():
    g1 = seed_everything(5)
    a = torch.rand(3, generator=g1), np.random.random(), torch.rand(2)
    g2 = seed_everything(5)
    b = torch.rand(3, generator=g2), np.random.random(), torch.rand(2)
    assert torch.equal(a[0], b[0]) and a[1] == b[1] and torch.equal(a[2],
                                                                    b[2])
    assert g1.initial_seed() == 5
