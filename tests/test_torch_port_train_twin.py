"""The comparative (twin) training step of the port against the JAX
package's ``Trainer``: HybridModelv2_Comparative with the contrastive term,
under Adam and AdamW. The weights, batches, noise and tolerances are
``test_torch_port_train.py``'s (its docstring)."""

import pytest
import torch

from tests.test_torch_port_train import (
    _comparative_batches, _run_steps, _setup, _twin_eps,
)
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("aggregation,stack_twins",
                         [("scatter", False), ("mega", True),
                          ("pallas", False)])
def test_comparative_step_matches_jax(tmp_path, aggregation, stack_twins):
    """HybridModelv2_Comparative with the contrastive term (coeff 0.1):
    the twin forward (two passes, or one over the stacked twins), the
    averaged twin loss and the projector trained with the model."""
    jbatch, batch = _comparative_batches(4, seed=3)
    jt, js, pt, ps = _setup("HybridModelv2_Comparative", tmp_path,
                            aggregation, coeff=0.1, stack_twins=stack_twins)
    assert hasattr(ps.model, "contrastive_projector")
    _run_steps(jt, js, pt, ps, jbatch, batch,
               lambda rng: _twin_eps(rng, 4, stack_twins))


def test_comparative_adamw_step_matches_jax(tmp_path):
    """The twin step as train_Cancer_wFT takes it: 'pallas', the
    contrastive term at 0.1 and AdamW (decoupled decay, here 1e-2 so that
    it shows), against optax.adamw."""
    jbatch, batch = _comparative_batches(4, seed=8)
    jt, js, pt, ps = _setup("HybridModelv2_Comparative", tmp_path, "pallas",
                            coeff=0.1, optimizer=("adamw", 1e-2))
    assert isinstance(ps.optimizer, torch.optim.AdamW)
    _run_steps(jt, js, pt, ps, jbatch, batch,
               lambda rng: _twin_eps(rng, 4, False))
