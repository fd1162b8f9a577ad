"""The PyTorch port's observability tools (``utils/flops.py``,
``utils/profiling.py``, ``utils/attribution.py``, ``cli/profile_step.py``)
against the JAX package's, on the CPU.

The analytic FLOP model is arithmetic on the model spec, so its counts
must equal the JAX package's exactly, for every zoo model; ``param_count``
must equal JAX's on the same (carried) weights. ``executed_flops`` counts
the ATen ops a call runs (``FlopCounterMode``): for the dense
SequenceFpModel within the band the JAX package's test holds XLA's count
to (0.5-1.6x the analytic count), and above the analytic count for the
'onehot' aggregation, which does more work than a segment sum.
``occupancy`` is pure Python and must give JAX's dict. On the CPU the
profiler's CPU ops stand in for the device lane.
"""

import time

import jax
import pytest
import torch

from immunostruct_tpu.models import build_model as jax_build_model
from immunostruct_tpu.models import model_map as jax_model_map
from immunostruct_tpu.utils import attribution as jax_attribution
from immunostruct_tpu.utils import flops as jax_flops
from immunostruct_tpu.utils.checkpoint import save_checkpoint
from immunostruct_tpu_torch.cli import profile_step
from immunostruct_tpu_torch.data.synthetic import random_sample_batch
from immunostruct_tpu_torch.models import build_model, model_apply, model_map
from immunostruct_tpu_torch.utils import attribution, flops
from immunostruct_tpu_torch.utils.checkpoint import load_jax_checkpoint
from immunostruct_tpu_torch.utils.profiling import StepTimer, trace
from tests.torch_threads import one_torch_thread  # noqa: F401

B, N, E, L = 2, 16, 64, 12
VAE_DIM = L * 21


@pytest.mark.parametrize("name", sorted(model_map))
def test_analytic_counts_equal_jax(name):
    spec, jspec = model_map[name], jax_model_map[name]
    for n, e, vae in ((288, 2560, 284 * 21), (32, 128, 30 * 21)):
        assert flops.forward_flops_per_sample(spec, n, e, vae) == \
            jax_flops.forward_flops_per_sample(jspec, n, e, vae)
        assert flops.loss_flops_per_sample(spec, vae) == \
            jax_flops.loss_flops_per_sample(jspec, vae)
        for b, params in ((128, 6_354_853), (1, 0)):
            assert flops.train_step_flops(spec, b, n, e, vae, params) == \
                jax_flops.train_step_flops(jspec, b, n, e, vae, params)
    assert flops.egnn_layer_flops(288, 2560, 20, 64) == \
        jax_flops.egnn_layer_flops(288, 2560, 20, 64)
    assert flops.attention_flops(288, 64) == jax_flops.attention_flops(288, 64)


@pytest.mark.parametrize("name", ["HybridModelv2", "SequenceModel",
                                  "HybridModelv2_Comparative_SSL"])
def test_param_count_equals_jax_on_carried_weights(name, tmp_path):
    _, params = jax_build_model(name, VAE_DIM, jax.random.key(0))
    path = str(tmp_path / "w.ckpt")
    save_checkpoint(path, params)
    _, model = build_model(name, VAE_DIM, torch.Generator().manual_seed(0))
    load_jax_checkpoint(path, model, verbose=False)
    assert flops.param_count(model) == jax_flops.param_count(params)


def test_peaks_by_card_name():
    assert flops.peak_flops_of("NVIDIA H100 80GB HBM3") == 989e12
    assert flops.peak_flops_of("NVIDIA H100 80GB HBM3", torch.float32) == 67e12
    assert flops.peak_flops_of("NVIDIA H100 PCIe") == 756e12
    assert flops.peak_flops_of("NVIDIA H100 PCIe", "float32") == 51e12
    assert flops.peak_flops_of("NVIDIA H100 NVL", torch.bfloat16) == 835e12
    assert flops.peak_flops_of("NVIDIA H100 NVL", "float32") == 60e12
    assert flops.peak_flops_of("NVIDIA A100-SXM4-80GB") is None
    assert flops.peak_flops("cpu") is None


def test_peak_device_bytes_is_none_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert flops.peak_device_bytes(lambda: None) is None


def _inputs():
    batch = random_sample_batch(B, N, E, L, seed=0)
    return batch.graph, batch.seq_onehot, batch.props


def test_executed_flops_of_the_dense_model_lie_in_jax_band():
    _, model = build_model("SequenceFpModel", VAE_DIM,
                           torch.Generator().manual_seed(0))
    _, seq, props = _inputs()
    with torch.no_grad():
        counted = flops.executed_flops(model_apply, model, None, seq, props,
                                       generator=torch.Generator(),
                                       deterministic=True)
    analytic = B * flops.forward_flops_per_sample(model.spec, 0, 0, VAE_DIM)
    assert 0.5 < counted / analytic < 1.6, (counted, analytic)


def test_onehot_executes_more_than_the_model_flops():
    _, model = build_model("HybridModelv2", VAE_DIM,
                           torch.Generator().manual_seed(0))
    graph, seq, props = _inputs()
    with torch.no_grad():
        counted = flops.executed_flops(model_apply, model, graph, seq, props,
                                       generator=torch.Generator(),
                                       deterministic=True,
                                       aggregation="onehot")
    analytic = B * flops.forward_flops_per_sample(model.spec, N, E, VAE_DIM)
    assert analytic < counted < 20 * analytic, (counted, analytic)


TIMELINES = {
    "overlap_and_gaps": [(0.0, 200.0, "a"), (300.0, 500.0, "b"),
                         (400.0, 550.0, "c"), (600.0, 800.0, "a"),
                         (900.0, 1000.0, "b")],
    "abutting": [(0.0, 10.0, "x"), (10.0, 30.0, "y"), (25.0, 26.0, "z"),
                 (50.0, 51.0, "x")],
    "one": [(5.0, 9.0, "k")],
    "empty": [],
}


@pytest.mark.parametrize("timeline", sorted(TIMELINES))
@pytest.mark.parametrize("steps", [1, 2])
def test_occupancy_equals_jax(timeline, steps):
    tl = TIMELINES[timeline]
    assert attribution.occupancy(tl, steps) == \
        jax_attribution.occupancy(tl, steps)


def test_attribute_labels_buckets_and_sorts():
    """Rule (a) by name, helpers by their neighbour (the projection ahead
    of its kernel, a reduction after it), else the event's own label."""
    ev = [
        (0.0, 100.0, "void egnn::egnn_mega_proj_kernel<64>(bf16 const*)", "x"),
        (100.0, 1100.0, "void egnn::egnn_mega_fwd_mma_kernel<64, "
         "egnn::EdgeTiles>(int const*)", "x"),
        (1100.0, 1200.0, "void egnn::reduce_node_chunks(float const*)", "x"),
        (1200.0, 1250.0, "void egnn::egnn_mega_proj_kernel<64>(bf16)", "y"),
        (1250.0, 1750.0, "void egnn::egnn_mega_fwd_mma_kernel<64, "
         "egnn::ArcTiles>(int const*)", "y"),
        (2000.0, 2600.0, "void egnn::tail_bwd_mma_kernel<64, 0>(int const*)",
         "z"),
        (2600.0, 2700.0, "void egnn::reduce_blocks(float const*)", "z"),
        (2700.0, 3100.0, "void egnn::tail_bwd_kernel<64, 2>(int const*)", "z"),
        (3100.0, 3200.0, "void segment_scatter_kernel<float>(int const*)", "z"),
        (3200.0, 3300.0, "void segment_gather_kernel<float>(int const*)", "z"),
        (3300.0, 3400.0, "void egnn_edge_bwd_reduce(float const*)", "z"),
        (3400.0, 5400.0, "ampere_sgemm_128x64_nn",
         "immunostruct_tpu_torch/ops/nnp.py:53"),
        (5400.0, 5500.0, "Memcpy HtoD (Pageable -> Device)", "[aten::copy_]"),
    ]
    rows = attribution.attribute(list(reversed(ev)), steps=2)
    got = {label: ms for ms, label in rows}
    assert got == {
        "[kernel:B1]": 0.6, "[kernel:B4]": 0.275, "[kernel:B2]": 0.35,
        "[kernel:B5b]": 0.2, "[kernel:B8 scatter]": 0.05,
        "[kernel:B8 gather]": 0.05, "[kernel:B3 bwd]": 0.05,
        "immunostruct_tpu_torch/ops/nnp.py:53": 1.0, "[aten::copy_]": 0.05}
    assert rows == sorted(rows, reverse=True)
    assert rows[0] == (1.0, "immunostruct_tpu_torch/ops/nnp.py:53")
    assert attribution.csrc_kernel(
        "void (anonymous namespace)::egnn_layer_fwd_mma_kernel<bf16, 64>") == "B7"
    assert attribution.csrc_kernel("void egnn::egnn_stack_fwd_kernel<64>") == "B6"
    assert attribution.csrc_kernel("void egnn_mega_paired_fwd_kernel") == "B4"
    assert attribution.csrc_kernel("void egnn::tail_bwd_kernel<64, 1>(") == "B5a"
    assert attribution.csrc_kernel("void egnn_edge_fwd_mma_kernel<64>") == \
        "B3 fwd"
    assert attribution.csrc_kernel("aten::mm") is None


def test_profile_fn_runs_and_threads_state(tmp_path):
    calls = []

    def step(s):
        calls.append(s)
        ns = s @ s * 1e-3 + s
        return ns, ns.sum()

    s0 = torch.eye(8)
    rows = attribution.profile_fn(step, (s0,), str(tmp_path / "trace"),
                                  steps=2, warmup=1, thread_state=True)
    assert len(calls) == 3 and calls[0] is s0
    assert all(c is not s0 for c in calls[1:])     # out[0] fed back
    assert rows and rows == sorted(rows, reverse=True)
    for ms, label in rows:
        assert ms >= 0 and isinstance(label, str)
    assert any(label.startswith("[aten::") for _, label in rows)
    tl = attribution.load_trace_timeline(str(tmp_path / "trace"
                                             / "_attribution_run"))
    assert tl and tl == sorted(tl)
    assert all(e >= s for s, e, _ in tl)


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path)) as prof:
        torch.ones(4).sum()
    files = list(tmp_path.glob("*.json"))
    assert len(files) == 1 and prof.events()


class TestStepTimer:
    def test_warmup_skipped_and_stats(self):
        t = StepTimer(warmup=2)
        for _ in range(5):
            with t.step():
                time.sleep(0.002)
        s = t.stats()
        assert s["steps"] == 3
        assert s["mean_s"] > 0.001 and s["p95_s"] >= s["p50_s"]
        assert s["steps_per_sec"] > 0

    def test_empty(self):
        assert StepTimer().stats() == {"steps": 0}


@pytest.mark.parametrize("mode", ["train", "inference", "comparative"])
def test_profile_step_on_the_cpu(mode, tmp_path, capsys):
    argv = ["--device", "cpu", "--batch", "2", "--nodes", "16", "--edges",
            "64", "--seq-len", "12", "--steps", "2", "--warmup", "1",
            "--logdir", str(tmp_path), "--top", "5"]
    argv += {"train": ["--occupancy"], "inference": ["--inference"],
             "comparative": ["--comparative"]}[mode]
    out = profile_step.main(argv)
    printed = capsys.readouterr().out
    assert f"mode={'inference' if mode == 'inference' else 'train'}" in printed
    assert "dtype=torch.float32" in printed
    rows = out["rows"]
    assert rows and out["device_total_ms"] == pytest.approx(
        sum(ms for ms, _ in rows))
    assert any(label.startswith("immunostruct_tpu_torch/")
               for _, label in rows)
    assert not any(label.startswith("[kernel:") for _, label in rows)
    if mode == "train":
        occ = out["occupancy"]
        assert 0.0 <= occ["idle_frac"] < 1.0 and occ["busy_ms"] > 0
        assert "# occupancy" in printed


def test_profile_step_refuses_inference_of_a_twin_model():
    with pytest.raises(SystemExit):
        profile_step.main(["--device", "cpu", "--inference", "--comparative"])


def test_profile_step_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_step.main(["--batch", "1"])
