"""The PyTorch port's scoring server (immunostruct_tpu_torch/serving.py) on the
CPU with a tiny model: /healthz answers, a ``write_example`` request scores
the same as a direct forward with the same VAE noise and the same every time
it is sent, a malformed request gets a 400, a failed forward a 500 and an
unhealthy /healthz, and the CLI's --oneshot, --write-example and --device
paths behave."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from immunostruct_tpu_torch import serving
from immunostruct_tpu_torch.data.synthetic import write_example
from immunostruct_tpu_torch.models import build_model, model_apply
from tests.torch_threads import one_torch_thread  # noqa: F401

L = 5
TINY = dict(gcn_layers=1, gat_hidden_channels=16, vae_hidden_dim=16,
            vae_latent_dim=4)


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


def _tiny_scorer(cls=serving.Scorer):
    _, model = build_model("HybridModelv2", L * 21,
                           torch.Generator().manual_seed(0), **TINY)
    return cls(model, device="cpu", compute_dtype=torch.float32, seed=5)


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve")
    req = str(tmp / "req.npz")
    write_example(req, batch=4, nodes=16, edges=64, seq_len=L)
    scorer = _tiny_scorer()
    for base in _running(scorer):
        yield base, req, scorer


def _post(url, body):
    r = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(r, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def test_healthz(server):
    base, *_ = server
    with urllib.request.urlopen(base + "/healthz", timeout=30) as resp:
        assert resp.status == 200
        assert json.loads(resp.read()) == {"status": "ok"}


def test_score_matches_direct_forward(server):
    base, req, scorer = server
    with open(req, "rb") as fh:
        status, reply = _post(base + "/score", fh.read())
    assert status == 200
    probs = np.asarray(reply["probs"])
    assert probs.shape == (4,) and np.all((probs > 0) & (probs < 1))
    assert reply["ms"] > 0

    gen = torch.Generator().manual_seed(scorer.seed)
    graph, seq, props = serving.request_to_args(req, "cpu")
    with torch.no_grad():
        out = model_apply(scorer.model, graph, seq, props, generator=gen,
                          deterministic=True, aggregation="scatter")
    want = torch.sigmoid(out.logits.reshape(-1)).numpy()
    np.testing.assert_allclose(probs, want, rtol=1e-6, atol=1e-7)


def test_same_request_scores_the_same_every_time(server, tmp_path):
    base, req, _ = server
    other = str(tmp_path / "other.npz")
    write_example(other, batch=3, nodes=12, edges=40, seq_len=L)
    with open(req, "rb") as fh:
        body = fh.read()
    _, first = _post(base + "/score", body)
    with open(other, "rb") as fh:           # another request in between
        _post(base + "/score", fh.read())
    _, second = _post(base + "/score", body)
    assert first["probs"] == second["probs"]


def test_bad_request_is_400_and_server_survives(server):
    base, *_ = server
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(base + "/score", b"not an npz")
    assert err.value.code == 400
    assert "error" in json.loads(err.value.read())
    with urllib.request.urlopen(base + "/healthz", timeout=30) as resp:
        assert resp.status == 200


def test_wrong_shape_request_is_400(server, tmp_path):
    base, *_ = server
    bad = str(tmp_path / "bad.npz")
    write_example(bad, batch=2, nodes=16, edges=64, seq_len=L + 3)
    with open(bad, "rb") as fh, pytest.raises(urllib.error.HTTPError) as err:
        _post(base + "/score", fh.read())
    assert err.value.code == 400


class _BrokenScorer(serving.Scorer):
    def __call__(self, graph, seq, props):
        raise RuntimeError("egnn_mega_fwd launch failed with CUDA error 700")


def test_failed_forward_is_500_and_unhealthy(tmp_path):
    req = str(tmp_path / "req.npz")
    write_example(req, batch=2, nodes=16, edges=64, seq_len=L)
    for base in _running(_tiny_scorer(_BrokenScorer)):
        with urllib.request.urlopen(base + "/healthz", timeout=30) as resp:
            assert resp.status == 200
        with open(req, "rb") as fh, \
                pytest.raises(urllib.error.HTTPError) as err:
            _post(base + "/score", fh.read())
        assert err.value.code == 500
        assert "CUDA error 700" in json.loads(err.value.read())["error"]
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(base + "/healthz", timeout=30)
        assert err.value.code == 503


def test_cli_write_example_and_oneshot(tmp_path, capsys):
    req = str(tmp_path / "one.npz")
    serving.main(["--write-example", req, "--seq-len", str(L)])
    serving.main(["--oneshot", req, "--device", "cpu", "--seq-len", str(L),
                  "--compute-dtype", "float32", "--model", "SequenceModel"])
    probs = np.load(str(tmp_path / "one.probs.npy"))
    assert probs.shape == (8,) and np.all(np.isfinite(probs))
    assert "random weights" in capsys.readouterr().out


def test_cli_cuda_device_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    req = str(tmp_path / "one.npz")
    write_example(req, seq_len=L)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.main(["--oneshot", req, "--seq-len", str(L)])


def test_cli_requires_a_transport():
    with pytest.raises(SystemExit):
        serving.main(["--device", "cpu"])


def _paired_request(path, broken=False):
    """A request of build_batch's mirror-paired batch (B=2, N=16, E=128);
    ``broken`` moves one mirror edge."""
    from immunostruct_tpu_torch.data.synthetic import build_batch

    b = build_batch(2, 16, 128, L, paired=True)
    g = {k: getattr(b.graph, k).numpy() for k in (
        "node_feat", "coords", "edge_src", "edge_dst", "edge_feat",
        "edge_mask", "node_mask", "num_nodes")}
    if broken:
        g["edge_dst"][0, 64] = (g["edge_dst"][0, 64] + 1) % 16
    np.savez(path, seq=b.seq_onehot.numpy(), props=b.props.numpy(), **g)


def test_paired_scorer_refuses_a_broken_layout_on_the_host(tmp_path):
    """Under mega_variant='paired' the request is held to the layout while
    it is still numpy (no device round trip per forward): a paired request
    scores, a broken one is a BadRequest, as is the same batch handed to
    the stack on CPU tensors."""
    from immunostruct_tpu_torch.ops.egnn import egnn_stack_apply

    scorer = _tiny_scorer()
    scorer.aggregation, scorer.mega_variant = "mega", "paired"
    good, bad = str(tmp_path / "good.npz"), str(tmp_path / "bad.npz")
    _paired_request(good)
    _paired_request(bad, broken=True)
    probs, _ = scorer.score_request(good)
    assert probs.shape == (2,) and np.isfinite(probs).all()
    with pytest.raises(serving.BadRequest, match="mirror-paired"):
        scorer.score_request(bad)
    graph, _, _ = serving.request_to_args(bad, "cpu")
    h = graph.node_feat[..., :20]
    with pytest.raises(ValueError, match="mirror-paired"):
        egnn_stack_apply(scorer.model.gcn, h, graph.coords, graph.edge_src,
                         graph.edge_dst, graph.edge_feat, graph.edge_mask,
                         aggregation="mega", mega_variant="paired")


def test_fused_stack_scorer_matches_scatter_and_refuses_other_features(
        tmp_path):
    """Scorer(fused_stack=True) (B7's plain version on the CPU) scores a
    request as 'scatter' does, in f32; a request with an edge feature
    other than 1 is a BadRequest."""
    req = str(tmp_path / "req.npz")
    write_example(req, batch=2, nodes=16, edges=128, seq_len=L)
    fused, plain = _tiny_scorer(), _tiny_scorer()
    fused.fused_stack = True
    plain.aggregation = "scatter"
    np.testing.assert_allclose(fused.score_request(req)[0],
                               plain.score_request(req)[0], atol=1e-5)
    with np.load(req) as z:
        arrays = dict(z)
    arrays["edge_feat"][1, 3] = 0.5
    np.savez(req, **arrays)
    with pytest.raises(serving.BadRequest, match="other than 1"):
        fused.score_request(req)
