"""The PyTorch port's weight quantization (immunostruct_tpu_torch/utils/
quantize.py) against the JAX package's ``utils/quantize.py`` on the CPU:

- ``quantize_int8`` / ``dequantize_int8`` give JAX's int8 values, scales
  and dequantized weights bit for bit on seeded weights, within JAX's
  half-quantum bound;
- ``fake_quant_int8`` on the port's HybridModelv2 (JAX's weights carried
  across by ``load_jax_checkpoint``) equals JAX's ``fake_quant_int8(params)``
  bit for bit for every weight, and leaves every other parameter untouched;
- ``quantized_size_bytes`` gives JAX's two numbers;
- an artifact of ``cli.export_model --int8`` stays within 0.05 of the f32
  one's probabilities (JAX's bound, tests/test_export.py).
"""

import jax
import numpy as np
import pytest
import torch

from immunostruct_tpu.models import build_model as jax_build_model
from immunostruct_tpu.utils.checkpoint import save_checkpoint
from immunostruct_tpu.utils.quantize import (
    dequantize_int8 as jax_dequantize_int8,
    fake_quant_int8 as jax_fake_quant_int8,
    quantize_int8 as jax_quantize_int8,
    quantized_size_bytes as jax_quantized_size_bytes,
)
from immunostruct_tpu_torch.cli import export_model
from immunostruct_tpu_torch.data.synthetic import random_sample_arrays
from immunostruct_tpu_torch.models import build_model
from immunostruct_tpu_torch.utils.checkpoint import (
    jax_params, load_jax_checkpoint,
)
from immunostruct_tpu_torch.utils.export import REQUEST_KEYS, load_exported
from immunostruct_tpu_torch.utils.quantize import (
    dequantize_int8, fake_quant_int8, quantize_int8, quantized_size_bytes,
)
from tests.torch_threads import one_torch_thread  # noqa: F401

L = 12


@pytest.fixture(scope="module")
def jax_model(tmp_path_factory):
    spec, params = jax_build_model("HybridModelv2", L * 21, jax.random.key(4))
    path = str(tmp_path_factory.mktemp("ckpt") / "model.ckpt")
    save_checkpoint(path, params)
    return params, path


def _port_model(path):
    _, model = build_model("HybridModelv2", L * 21,
                           torch.Generator().manual_seed(0))
    return load_jax_checkpoint(path, model, verbose=False)


@pytest.mark.parametrize("shape,scale", [((512, 32), 1.0), ((64, 64), 0.05),
                                         ((21, 1), 3.0)])
def test_quantize_int8_matches_jax_bit_for_bit(shape, scale):
    rng = np.random.default_rng(11)
    w = (scale * rng.standard_normal(shape)).astype(np.float32)
    w[:, 0] = 0.0 if shape[1] > 1 else w[:, 0]      # an all-zero channel
    q, s = quantize_int8(w)
    jq, js = jax_quantize_int8(w)
    assert q.dtype == np.int8 and s.dtype == np.float32
    assert np.array_equal(q, jq) and np.array_equal(s, js)
    back = dequantize_int8(q, s)
    assert back.dtype == np.float32
    assert np.array_equal(back, jax_dequantize_int8(jq, js))
    bound = np.broadcast_to(s[None, :] * 0.502 + 1e-8, w.shape)
    np.testing.assert_array_less(np.abs(back - w), bound)


def test_fake_quant_matches_jax_for_every_weight(jax_model):
    params, path = jax_model
    model = _port_model(path)
    before = {k: v.copy() for k, v in jax_params(model).items()}
    assert fake_quant_int8(model) is model
    got = jax_params(model)
    want = jax.tree_util.tree_flatten_with_path(jax_fake_quant_int8(params))[0]
    want = {jax.tree_util.keystr(p): np.asarray(v) for p, v in want}
    assert set(got) == set(want)
    weights = 0
    for name, value in got.items():
        assert np.array_equal(value, want[name]), name
        if name.endswith("['w']") and value.ndim == 2:
            weights += 1
            # a one-row weight is its own scale: exact in int8
            assert (value.shape[0] == 1) == np.array_equal(
                value, before[name]), name
        else:
            assert np.array_equal(value, before[name]), name
    assert weights > 20


def test_quantized_size_matches_jax(jax_model):
    params, path = jax_model
    f32, q = quantized_size_bytes(_port_model(path))
    assert (f32, q) == jax_quantized_size_bytes(params)
    assert q < 0.3 * f32


def test_int8_artifact_stays_near_the_f32_one(jax_model, tmp_path):
    _, path = jax_model
    b, n, e = 4, 16, 128
    flags = ["--model", "HybridModelv2", "--checkpoint", path,
             "--batch-size", str(b), "--max-nodes", str(n), "--max-edges",
             str(e), "--seq-len", str(L), "--compute-dtype", "float32",
             "--aggregation", "mega", "--device", "cpu"]
    f32_path, int8_path = str(tmp_path / "f32.pt2"), str(tmp_path / "q.pt2")
    export_model.main(flags + ["--output", f32_path])
    export_model.main(flags + ["--output", int8_path, "--int8"])
    a = random_sample_arrays(b, n, e, L, seed=9)
    a["seq"] = a.pop("seq_onehot")
    tensors = [torch.from_numpy(a[k]) for k in REQUEST_KEYS]
    full = load_exported(f32_path, "cpu")(*tensors).numpy()
    quant = load_exported(int8_path, "cpu")(*tensors).numpy()
    assert not np.array_equal(full, quant)
    assert float(np.abs(full - quant).max()) < 0.05
