"""``test_torch_port_bf16.py``'s bf16 training step against the JAX
package's, for HybridModelv2 at two EGNN layers of 16 under every
aggregation the CPU runs but 'mega' (``test_torch_port_bf16_hybrid_mega.py``
holds those): the same weights, batch, readings and bounds."""

import pytest

from tests.test_torch_port_bf16 import NOT_MEGA, _check, _step_readings
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("aggregation,variant", NOT_MEGA)
@pytest.mark.parametrize("name", ["HybridModelv2"])
def test_bf16_step_matches_jax(tmp_path, name, aggregation, variant):
    _check(_step_readings(name, tmp_path, aggregation, variant))
