"""``test_torch_port_bf16.py``'s bf16 training step against the JAX
package's, for StructureModel at its full width (six EGNN layers of 64)
under 'scatter', 'mega' and 'fused': the same weights, batch, readings and
bounds."""

import pytest

from tests.test_torch_port_bf16 import _check, _step_readings
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("aggregation", ["scatter", "mega", "fused"])
def test_bf16_step_matches_jax_at_full_width(tmp_path, aggregation):
    _check(_step_readings("StructureModel", tmp_path, aggregation,
                          width="full"))
