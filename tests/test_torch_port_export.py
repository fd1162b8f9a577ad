"""The PyTorch port's serving artifact (immunostruct_tpu_torch/utils/export.py,
cli/export_model.py, serving.py ``--artifact``) on the CPU, with a small
HybridModelv2 (two hidden EGNN layers, narrow widths) at B=4, N=16, E=128,
L=12, on requests made from a numpy seed (a fifth of the edges masked,
self-loops):

- the four kernel ops (B1, B3's forward, B8's scatter and gather) pass
  ``torch.library.opcheck`` on CPU tensors, and their fakes give the plain
  versions' shapes and dtypes;
- an artifact of each aggregation calls the ops that aggregation runs (B1
  without its residuals under 'mega') and, saved and loaded, gives
  ``Scorer``'s probabilities bit for bit; a fresh process loads it through
  ``load_exported`` without the model code, and ``torch.export.load`` alone
  cannot resolve its ops;
- against the JAX package: JAX's ``export_inference_fn`` artifact
  (aggregation 'onehot') and the port's under 'mega' and 'scatter', with
  the weights carried by ``load_jax_checkpoint`` and the noise of JAX's key
  0, agree in f32 within atol=1e-5, rtol=1e-4 (the model parity's
  tolerance), as do the two export CLIs' artifacts of one JAX checkpoint;
- ``serve --artifact``: ``--oneshot`` and HTTP give the artifact's
  probabilities, a request of another shape or dtype is a 400 and the
  server survives, a failed forward is a 500 and an unhealthy /healthz,
  ``--artifact`` with ``--checkpoint`` is refused, and a process that
  serves an artifact has imported no ``immunostruct_tpu_torch.models`` and
  no JAX.
"""

import functools
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from immunostruct_tpu.cli.export_model import main as jax_export_main
from immunostruct_tpu.models import build_model as jax_build_model
from immunostruct_tpu.structs import GraphBatch as JaxGraphBatch
from immunostruct_tpu.utils.checkpoint import save_checkpoint
from immunostruct_tpu.utils.export import (
    export_inference_fn as jax_export_inference_fn,
    load_exported as jax_load_exported,
)
from immunostruct_tpu_torch import serving
from immunostruct_tpu_torch.cli import export_model
from immunostruct_tpu_torch.data.synthetic import random_sample_arrays
from immunostruct_tpu_torch.models import build_model
from immunostruct_tpu_torch.ops import edge as edge_ops
from immunostruct_tpu_torch.ops import mega as mega_ops
from immunostruct_tpu_torch.ops import segment as segment_ops
from immunostruct_tpu_torch.structs import GraphBatch
from immunostruct_tpu_torch.utils.checkpoint import load_jax_checkpoint
from immunostruct_tpu_torch.utils.export import (
    REQUEST_KEYS, export_inference_fn, load_exported, read_meta,
    save_exported,
)
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, N, E, L = 4, 16, 128, 12
SMALL = dict(gcn_layers=2, gat_hidden_channels=16, vae_hidden_dim=32,
             vae_latent_dim=8)
LAYERS = SMALL["gcn_layers"] + 1
OPS = torch.ops.immunostruct
# the ops each aggregation's forward calls, with their counts a forward
KERNEL_OPS = {
    "mega": {"edge_mega_fwd": LAYERS},
    "fused": {"edge_program_fwd": LAYERS, "segment_scatter": LAYERS},
    "pallas": {"segment_scatter": LAYERS},
    "scatter": {},
    "onehot": {},
}


def _request_arrays(seed=0, b=B):
    a = random_sample_arrays(b, N, E, L, seed=seed)
    rng = np.random.default_rng(seed + 100)
    a["edge_mask"] = rng.random((b, E)) >= 0.2               # padded edges
    a["edge_src"][:, :4] = a["edge_dst"][:, :4]              # self-loops
    a["seq"] = a.pop("seq_onehot")
    return {k: a[k] for k in REQUEST_KEYS}


def _write_request(path, seed=0, b=B):
    np.savez(path, **_request_arrays(seed, b))
    return path


def _batch(arrays):
    return (GraphBatch.from_numpy(arrays, "cpu"),
            torch.from_numpy(arrays["seq"]), torch.from_numpy(arrays["props"]))


def _tensors(arrays):
    return [torch.from_numpy(arrays[k]) for k in REQUEST_KEYS]


def _model(seed=0, **widths):
    _, model = build_model("HybridModelv2", L * 21,
                           torch.Generator().manual_seed(seed),
                           **(widths or SMALL))
    return model


def _run(program, tensors):
    """An exported program's probabilities, run in this process."""
    with torch.no_grad():
        return program.module()(*tensors)


def _graph_ops(program):
    """{op name: calls} of the immunostruct ops in an exported graph."""
    found = {}
    for node in program.graph.nodes:
        if node.op == "call_function" and "immunostruct" in str(node.target):
            name = node.target.name().split("::")[1].split(".")[0]
            found[name] = found.get(name, 0) + 1
    return found


# --------------------------------------------------------------------------
# (a) the ops
# --------------------------------------------------------------------------

def _op_cases(dtype):
    """(op, args, the plain version's output) for the four ops at a small
    size, from a numpy seed."""
    rng = np.random.default_rng(7)
    b, n, e, f, hid, c = 2, 12, 64, 8, 16, 5

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (scale * rng.standard_normal(shape)).astype(np.float32))

    src = torch.from_numpy(rng.integers(0, n, (b, e)).astype(np.int32))
    dst = torch.from_numpy(rng.integers(0, n, (b, e)).astype(np.int32))
    mask = torch.from_numpy(rng.random((b, e)) >= 0.2)
    weights = (t(2 * f, hid, scale=0.3), t(hid, hid, scale=0.3),
               t(hid, hid, scale=0.3), t(hid, 6, scale=0.3))
    ef = t(b, e, 1).to(dtype)
    h, x = t(b, n, f).to(dtype), t(b, n, 3).to(dtype)
    hsx, hdx = t(b, f + 3, e).to(dtype), t(b, f + 3, e).to(dtype)
    m, rows = t(b, e, c).to(dtype), t(b, n, c).to(dtype)
    mega_args = (src, dst, mask, ef, h, x, *weights)
    return {
        "edge_mega_fwd": (OPS.edge_mega_fwd.default, (*mega_args, False),
                          mega_ops.edge_mega_fwd_reference(*mega_args)[:1]),
        "edge_mega_fwd residuals": (
            OPS.edge_mega_fwd.default, (*mega_args, True),
            mega_ops.edge_mega_fwd_reference(*mega_args)),
        "edge_program_fwd": (
            OPS.edge_program_fwd.default,
            (hsx, hdx, ef.transpose(1, 2).contiguous(), *weights),
            (edge_ops.edge_program_reference(
                hsx, hdx, ef.transpose(1, 2).contiguous(), *weights),)),
        "segment_scatter": (
            OPS.segment_scatter.default, (dst, mask, m, n),
            (segment_ops.segment_scatter_reference(dst, mask, m, n),)),
        "segment_gather": (
            OPS.segment_gather.default, (src, mask, rows),
            (segment_ops.segment_gather_reference(src, mask, rows),)),
    }


CASES = ("edge_mega_fwd", "edge_mega_fwd residuals", "edge_program_fwd",
         "segment_scatter", "segment_gather")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_op_passes_opcheck_and_its_fake_matches_the_plain_version(case,
                                                                  dtype):
    from torch._subclasses.fake_tensor import FakeTensorMode

    op, args, plain = _op_cases(dtype)[case]
    torch.library.opcheck(op, args)
    got = op(*args)
    got = got if isinstance(got, tuple) else (got,)
    for g, want in zip(got, plain):
        assert torch.equal(g, want)
    with FakeTensorMode() as mode:
        fake = op(*[mode.from_tensor(a) if isinstance(a, torch.Tensor)
                    else a for a in args])
    fake = fake if isinstance(fake, tuple) else (fake,)
    for f, want in zip(fake, plain):
        assert (f.shape, f.dtype) == (want.shape, want.dtype)
    if case == "edge_mega_fwd":      # the form without residuals
        assert [tuple(f.shape) for f in fake[1:]] == [(0,), (0,)]


def test_wrappers_call_the_ops():
    """The launch wrappers go through the ops (so ``torch.export`` sees
    them) and keep their contracts: B1 gives None residuals without
    ``residuals``."""
    cases = _op_cases(torch.float32)
    _, args, plain = cases["edge_mega_fwd"]
    out, a1, xd = mega_ops.edge_mega_fwd(*args[:-1], residuals=False)
    assert torch.equal(out, plain[0]) and a1 is None and xd is None
    _, args, plain = cases["segment_scatter"]
    program = torch.export.export(_Call(segment_ops.segment_scatter,
                                        args[3]), args[:3])
    assert _graph_ops(program) == {"segment_scatter": 1}
    _, args, plain = cases["segment_gather"]
    program = torch.export.export(_Call(segment_ops.segment_gather), args)
    assert _graph_ops(program) == {"segment_gather": 1}
    _, args, plain = cases["edge_program_fwd"]
    program = torch.export.export(_Call(edge_ops.edge_program), args)
    assert _graph_ops(program) == {"edge_program_fwd": 1}


class _Call(torch.nn.Module):
    def __init__(self, fn, *extra):
        super().__init__()
        self.fn, self.extra = fn, extra

    def forward(self, *args):
        return self.fn(*args, *self.extra)


# --------------------------------------------------------------------------
# (b) export each aggregation; the loaded artifact gives Scorer's bits
# --------------------------------------------------------------------------

@pytest.mark.parametrize("aggregation,dtype", [
    ("mega", torch.float32), ("mega", torch.bfloat16),
    ("fused", torch.float32), ("pallas", torch.float32),
    ("scatter", torch.float32), ("onehot", torch.float32)])
def test_artifact_calls_the_ops_and_gives_the_scorers_bits(tmp_path,
                                                           aggregation,
                                                           dtype):
    model = _model()
    arrays = _request_arrays(seed=1)
    program = export_inference_fn(model, _batch(arrays),
                                  aggregation=aggregation,
                                  compute_dtype=dtype, seed=5)
    assert _graph_ops(program) == KERNEL_OPS[aggregation]
    if aggregation == "mega":           # B1 without its residual stores
        calls = [n for n in program.graph.nodes
                 if n.target == OPS.edge_mega_fwd.default]
        assert [n.args[-1] for n in calls] == [False] * LAYERS
    path = str(tmp_path / "model.pt2")
    save_exported(program, path)
    meta = read_meta(path)
    assert (meta["device"], meta["aggregation"]) == ("cpu", aggregation)
    artifact = load_exported(path, "cpu")
    scorer = serving.Scorer(model, device="cpu", compute_dtype=dtype,
                            aggregation=aggregation, seed=5)
    want = scorer(*_batch(arrays))
    for seed in (1, 1, 2):              # the same request twice, another
        arrays = _request_arrays(seed)
        got = artifact(*_tensors(arrays)).numpy()
        assert np.array_equal(got, scorer(*_batch(arrays)))
    assert np.array_equal(artifact(*_tensors(_request_arrays(1))).numpy(),
                          want)


@pytest.mark.parametrize("aggregation", ["scatter", "auto"])
def test_bf16_scatter_is_refused_at_export(aggregation):
    """'scatter' in bf16 ('auto' on the CPU resolves to it) sums in edge
    order with its passes read from the data on the host
    (``ops/segment.py::sum_rows_in_order``): a traced program would hold
    the example batch's passes, so the export raises and names why."""
    with pytest.raises(ValueError, match="ordered sums"):
        export_inference_fn(_model(), _batch(_request_arrays(seed=1)),
                            aggregation=aggregation,
                            compute_dtype=torch.bfloat16, seed=5)


def test_auto_resolves_at_export_and_other_devices_are_refused(tmp_path):
    """'auto' is traced as 'scatter' on the CPU and says so; the artifact
    refuses another device type before it loads anything, and a file that
    is no artifact is refused."""
    program = export_inference_fn(_model(), _batch(_request_arrays()),
                                  aggregation="auto")
    assert program.immunostruct["aggregation"] == "scatter"
    assert _graph_ops(program) == {}
    path = str(tmp_path / "model.pt2")
    save_exported(program, path)
    with pytest.raises(ValueError, match="exported on cpu"):
        load_exported(path, "cuda")
    other = tmp_path / "other.pt2"
    np.savez(str(other), x=np.zeros(2))
    with pytest.raises(ValueError, match="not an artifact"):
        load_exported(str(other) + ".npz")


def test_artifact_refuses_another_shape(tmp_path):
    program = export_inference_fn(_model(), _batch(_request_arrays()),
                                  aggregation="scatter")
    path = str(tmp_path / "model.pt2")
    save_exported(program, path)
    artifact = load_exported(path)
    arrays = _request_arrays(b=B + 1)
    with pytest.raises(ValueError, match=r"node_feat has shape \(5, 16, 20\)"):
        artifact.check(arrays)
    arrays = _request_arrays()
    arrays["edge_src"] = arrays["edge_src"].astype(np.int64)
    with pytest.raises(ValueError, match="edge_src has dtype int64"):
        artifact.check(arrays)
    with pytest.raises(Exception):      # the program's own guard
        artifact(*_tensors(_request_arrays(b=B + 1)))


_LOADER = """
import sys
sys.modules["jax"] = None
import numpy as np, torch
from immunostruct_tpu_torch.utils.export import REQUEST_KEYS, load_exported
path, req, out = sys.argv[1:4]
try:
    torch.export.load(path)
    print("plain load resolved the ops")
except Exception as e:
    print("plain load failed:", type(e).__name__)
artifact = load_exported(path, "cpu")
with np.load(req) as z:
    probs = artifact(*[torch.from_numpy(z[k]) for k in REQUEST_KEYS])
np.save(out, probs.numpy())
assert not [m for m in sys.modules if m.startswith("immunostruct_tpu_torch.models")]
print("loaded without the models")
"""


def test_a_fresh_process_loads_the_artifact_without_the_models(tmp_path):
    """``.pt2`` loading needs the ops registered: ``torch.export.load``
    alone cannot resolve them in a fresh process; ``load_exported``
    registers them, imports no model module, and gives the exporting
    process's probabilities."""
    arrays = _request_arrays(seed=3)
    program = export_inference_fn(_model(), _batch(arrays),
                                  aggregation="mega")
    path = str(tmp_path / "model.pt2")
    save_exported(program, path)
    req = str(tmp_path / "req.npz")
    np.savez(req, **arrays)
    out = str(tmp_path / "probs.npy")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"     # one torch thread, as in the workers
    proc = subprocess.run([sys.executable, "-c", _LOADER, path, req, out],
                          capture_output=True, text=True, cwd=REPO, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "plain load failed" in proc.stdout
    assert "loaded without the models" in proc.stdout
    assert np.array_equal(np.load(out),
                          _run(program, _tensors(arrays)).numpy())


# --------------------------------------------------------------------------
# (c), (d) against the JAX package's artifact and CLI
# --------------------------------------------------------------------------

def _jax_eps0(shape):
    """The noise of JAX's export (key 0): key -> (k_item, k_cls); k_item ->
    (k_eps, k_drop); normal(k_eps) in f32."""
    k_item, _ = jax.random.split(jax.random.key(0))
    k_eps, _ = jax.random.split(k_item)
    return torch.from_numpy(np.array(jax.random.normal(k_eps, shape)))


def _jax_batch(arrays):
    graph = JaxGraphBatch(**{k: jnp.asarray(arrays[k]) for k in REQUEST_KEYS
                             if k not in ("seq", "props")})
    return graph, jnp.asarray(arrays["seq"]), jnp.asarray(arrays["props"])


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    spec, params = jax_build_model("HybridModelv2", L * 21,
                                   jax.random.key(3), **SMALL)
    path = str(tmp_path_factory.mktemp("ckpt") / "model.ckpt")
    save_checkpoint(path, params)
    return spec, params, path


@pytest.mark.parametrize("aggregation", ["mega", "scatter"])
def test_artifact_matches_the_jax_artifact(jax_checkpoint, aggregation):
    spec, params, path = jax_checkpoint
    arrays = _request_arrays(seed=4)
    jax_art = jax_export_inference_fn(spec, params, _jax_batch(arrays),
                                      aggregation="onehot")
    want = np.asarray(jax_art.call(*_jax_batch(arrays)))
    model = load_jax_checkpoint(path, _model(), verbose=False)
    program = export_inference_fn(
        model, _batch(arrays), aggregation=aggregation,
        eps=_jax_eps0((B, SMALL["vae_latent_dim"])))
    got = _run(program, _tensors(arrays)).numpy()
    assert got.shape == want.shape == (B,)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)


def test_export_cli_matches_the_jax_cli(tmp_path, monkeypatch):
    """One JAX checkpoint through both export CLIs (flags as
    tests/test_export_cli.py passes them, plus ``--device cpu``). The port's
    CLI bakes the noise ``serve --seed`` draws; here it is handed JAX's
    key-0 draw instead, so that the two artifacts compute the same
    function."""
    b, n, e, l = 4, 16, 128, 12
    spec, params = jax_build_model("HybridModel", l * 21, jax.random.key(0))
    ckpt = str(tmp_path / "m.ckpt")
    save_checkpoint(ckpt, params)
    flags = ["--model", "HybridModel", "--checkpoint", ckpt,
             "--batch-size", str(b), "--max-nodes", str(n), "--max-edges",
             str(e), "--seq-len", str(l), "--compute-dtype", "float32",
             "--aggregation", "scatter"]
    jax_out, out = str(tmp_path / "m.stablehlo"), str(tmp_path / "m.pt2")
    jax_export_main(flags + ["--output", jax_out])
    monkeypatch.setattr(export_model, "export_inference_fn", functools.partial(
        export_inference_fn, eps=_jax_eps0((b, spec.vae_latent_dim))))
    export_model.main(flags + ["--output", out, "--device", "cpu"])
    assert read_meta(out)["inputs"][0] == ["node_feat", [b, n, 20], "float32"]

    arrays = _request_arrays(seed=5)
    want = np.asarray(jax_load_exported(jax_out).call(*_jax_batch(arrays)))
    got = load_exported(out, "cpu")(*_tensors(arrays)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)


def test_export_cli_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_model.main(["--checkpoint", "x.ckpt", "--output",
                           str(tmp_path / "m.pt2")])


# --------------------------------------------------------------------------
# (e) serve --artifact
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def artifact_path(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("artifact")
    program = export_inference_fn(_model(), _batch(_request_arrays()),
                                  aggregation="mega", seed=2)
    path = str(tmp / "model.pt2")
    save_exported(program, path)
    return path, program


def _post(url, body):
    r = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(r, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def _running(scorer):
    srv = serving.make_http_server(scorer)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    host, port = srv.server_address[:2]
    try:
        yield f"http://{host}:{port}"
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_serve_artifact_oneshot_and_http(artifact_path, tmp_path):
    path, program = artifact_path
    req = _write_request(str(tmp_path / "req.npz"), seed=6)
    want = _run(program, _tensors(_request_arrays(6))).numpy()
    serving.main(["--artifact", path, "--device", "cpu", "--oneshot", req])
    assert np.array_equal(np.load(str(tmp_path / "req.probs.npy")), want)

    scorer = serving.ArtifactScorer(load_exported(path, "cpu"))
    for base in _running(scorer):
        with open(req, "rb") as fh:
            body = fh.read()
        for _ in range(2):
            status, reply = _post(base + "/score", body)
            assert status == 200
            assert np.array_equal(np.asarray(reply["probs"], np.float32),
                                  want)
        for bad in ("shape", "dtype"):
            arrays = _request_arrays(seed=6, b=B + 1 if bad == "shape" else B)
            if bad == "dtype":
                arrays["node_mask"] = arrays["node_mask"].astype(np.int32)
            other = str(tmp_path / f"{bad}.npz")
            np.savez(other, **arrays)
            with open(other, "rb") as fh, \
                    pytest.raises(urllib.error.HTTPError) as err:
                _post(base + "/score", fh.read())
            assert err.value.code == 400
            assert ("shape" if bad == "shape" else "dtype int32") in \
                json.loads(err.value.read())["error"]
        with urllib.request.urlopen(base + "/healthz", timeout=30) as resp:
            assert resp.status == 200
        status, reply = _post(base + "/score", body)
        assert status == 200


class _BrokenArtifact:
    def __init__(self, artifact):
        self.device, self.inputs = artifact.device, artifact.inputs
        self.check = artifact.check

    def __call__(self, *tensors):
        raise RuntimeError("egnn_mega_fwd launch failed with CUDA error 700")


def test_failed_artifact_forward_is_500_and_unhealthy(artifact_path,
                                                      tmp_path):
    path, _ = artifact_path
    req = _write_request(str(tmp_path / "req.npz"))
    scorer = serving.ArtifactScorer(
        _BrokenArtifact(load_exported(path, "cpu")))
    for base in _running(scorer):
        with open(req, "rb") as fh, \
                pytest.raises(urllib.error.HTTPError) as err:
            _post(base + "/score", fh.read())
        assert err.value.code == 500
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(base + "/healthz", timeout=30)
        assert err.value.code == 503


def test_serve_refuses_artifact_with_checkpoint(artifact_path, tmp_path):
    path, _ = artifact_path
    with pytest.raises(SystemExit) as err:
        serving.main(["--artifact", path, "--checkpoint", "x.ckpt",
                      "--device", "cpu", "--oneshot", "req.npz"])
    assert err.value.code == 2


_SERVER = """
import sys
sys.modules["jax"] = None
from immunostruct_tpu_torch import serving
serving.main(sys.argv[1:])
loaded = sorted(m for m in sys.modules if m.startswith(
    ("immunostruct_tpu_torch.models", "immunostruct_tpu.", "jax."))
    or m == "immunostruct_tpu")
assert not loaded, loaded
print("served without the models")
"""


def test_artifact_server_imports_no_model_and_no_jax(artifact_path,
                                                     tmp_path):
    path, program = artifact_path
    req = _write_request(str(tmp_path / "req.npz"), seed=8)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"     # one torch thread, as in the workers
    proc = subprocess.run(
        [sys.executable, "-c", _SERVER, "--artifact", path, "--device", "cpu",
         "--oneshot", req], capture_output=True, text=True, cwd=REPO,
        env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "served without the models" in proc.stdout
    assert np.array_equal(np.load(str(tmp_path / "req.probs.npy")),
                          _run(program, _tensors(_request_arrays(8)))
                          .numpy())
