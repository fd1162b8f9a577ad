"""The contrastive term on microbatches (``allow_microbatch_contrastive``)
of the port's twin step against the JAX package's ``Trainer``, and a
planted fault that the rule for microbatches of 2 fails. The weights,
batches, noise and tolerances are ``test_torch_port_train.py``'s (its
docstring).

A case and the planted fault of the same ``stack_twins`` build the same
JAX trainer and batch and start from the same weights, so JAX's side of
their first step is computed once (``share``, ``_shared``)."""

import jax
import pytest

from tests.test_torch_port_train import (
    _comparative_batches, _run_steps, _setup, _twin_eps, _twin_steps,
)
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("rows", [2, 4])
@pytest.mark.parametrize("stack_twins", [False, True])
def test_microbatch_contrastive_step_matches_jax(tmp_path, stack_twins,
                                                 rows):
    """The opt-in (allow_microbatch_contrastive): the twin step with the
    contrastive term at 0.1 and grad_accum_steps=2 on a batch of 2 * rows,
    each microbatch (both classes) with its own contrastive statistics and
    its own noise (fold_in(rng, i), then model_apply_comparative's split:
    one 2B draw for the stacked twins, one a twin otherwise), gradients
    summed and halved, the projector trained with the model.

    Microbatches of 2 are held on the loss of each step and the first
    step's gradients by the file's rules, then (``_twin_steps``) each of
    the 3 steps from the port's own state against JAX's step from that
    state: the gradients by the file's gradient rule (0.08-0.24 of it) and
    by ``dryrun.twin_excess``'s; the parameters by ``_reach_excess`` at
    every step (0.10-0.99; an entry whose gradient sign the gradient rule
    admits flipping reads up to 1 by construction, as Adam's first step
    moves it by lr either way) and, after the first step, the one it is
    stated for, by ``twin_excess`` (0.005). ``twin_excess``'s parameter
    bound does not hold after later steps even from the port's own state
    (0.68-2.26): an entry whose gradient sits a little above its nu (the
    worst, node_attn.w_concat.b, at 1.8 nu with a 3.8% difference, inside
    the gradient rule) is divided by a second moment its earlier noise-
    level gradients left small, so Adam moves it by most of lr in a
    direction that difference shifts; the port's Adam fed JAX's gradient
    from the same state gives JAX's step to 0.0054 of that bound. The
    twin step at 2 rows (the projector's batch norm over 2 rows) is
    ill-conditioned: JAX's own gradient at the port's parameters after a
    step moves by 1.2-4.9x the file's gradient rule from JAX's gradient on
    its own trajectory, so parameters compared along two trajectories
    after several steps (the file's rule: 1.30x, 1.72x on vae.fc1.w) read
    how far the trajectories drift, not one step of the port. A fault
    fails what is held:
    ``test_microbatch_twin_rule_fails_a_planted_fault``."""
    jbatch, batch = _comparative_batches(2 * rows, seed=9)
    jt, js, pt, ps = _setup("HybridModelv2_Comparative", tmp_path,
                            "scatter", coeff=0.1, accum=2,
                            stack_twins=stack_twins, microbatch=True)

    def eps_of(rng):
        return [_twin_eps(jax.random.fold_in(rng, i), rows, stack_twins)
                for i in range(2)]

    _run_steps(jt, js, pt, ps, jbatch, batch, eps_of,
               params="file" if rows > 2 else "twin",
               share=("microbatches", stack_twins))


@pytest.mark.parametrize("stack_twins", [False, True])
def test_microbatch_twin_rule_fails_a_planted_fault(tmp_path, stack_twins):
    """At microbatches of 2, a port whose second microbatch draws its VAE
    noise from the first one's key (``fold_in(rng, 0)`` twice) fails what
    ``test_microbatch_contrastive_step_matches_jax`` holds: its gradients
    part from JAX's at the same parameters by far, its parameters after
    the first step leave ``dryrun.twin_excess``'s bound, and after every
    step they leave ``_reach_excess``'s."""
    jbatch, batch = _comparative_batches(4, seed=9)
    jt, js, pt, ps = _setup("HybridModelv2_Comparative", tmp_path,
                            "scatter", coeff=0.1, accum=2,
                            stack_twins=stack_twins, microbatch=True)

    def one_key(rng):
        return [_twin_eps(jax.random.fold_in(rng, 0), 2, stack_twins)] * 2

    steps = _twin_steps(jt, js, pt, ps, jbatch, batch, one_key,
                        share=("microbatches", stack_twins))
    worst = max(max(r["same_point"], r["rule"]["grads"]) for r in steps)
    print("planted fault: worst gradient excess", worst, "parameters after"
          " the first step", steps[0]["rule"]["params"], "parameters by the"
          " reach", [r["reach"] for r in steps])
    assert steps[0]["rule"]["params"] > 1
    assert all(r["reach"] > 1 for r in steps)
