"""Batch scoring of ``.npz`` requests (counterpart of ``immunostruct_tpu/serving.py``).

Two scorers, one interface (``score_request``), the same transports:

- ``ArtifactScorer`` (``--artifact model.pt2``), as the JAX server serves
  its StableHLO artifact: a ``torch.export`` program of the deterministic
  forward written by ``cli/export_model.py`` (``utils/export.py``), run
  without the model code. A process that serves an artifact imports no
  ``immunostruct_tpu_torch.models``. Each request is held to the program's
  shapes and dtypes on the host (400 when they differ).
- ``Scorer`` rebuilds the model from what the JAX export CLI takes
  (``--checkpoint``, ``--model``, ``--compute-dtype``, ``--aggregation``)
  and runs it directly: ``probs = sigmoid(model_apply(...,
  deterministic=True).logits)``. ``--artifact`` and ``--checkpoint`` do not
  combine.

Transports (stdlib only):

1. A filesystem request queue (``--watch-dir``): responses are written next
   to each request as ``<name>.probs.npy``.
2. An HTTP endpoint (``--http PORT``): ``POST /score`` with the request
   ``.npz`` bytes as the body returns ``{"probs": [...], "ms": t}``;
   ``GET /healthz`` answers liveness; a malformed request gets a 400; a
   failed forward gets a 500, after which ``/healthz`` answers 503.
3. ``--oneshot req.npz`` scores one file.

Request npz keys (the JAX package's format):
  node_feat [B,N,20] coords [B,N,3] edge_src/edge_dst [B,E] edge_feat
  [B,E,1] edge_mask [B,E]->bool node_mask [B,N]->bool, num_nodes,
  seq [B,L,21], props [B,2]
(produce one with ``--write-example``).

``Scorer(fused_stack=True)`` runs the conv stack through B7 (one kernel per
layer, ops/fused_layer.py), which reads no edge features: a request whose
unmasked edges have features other than 1 is refused (400) before anything
reaches the device. ``Scorer(mega_variant='paired')`` holds each request to
the mirror-paired edge layout the same way, on the host. Neither has a
command-line flag.

The VAE noise of every request comes from a ``torch.Generator`` seeded
afresh with ``--seed``, so the same request always gets the same scores,
whatever came before it (the JAX export folds in one fixed key for the same
purpose).

Both scorers run their forward as a ``utils/capture.py`` program, as the JAX
server runs a compiled one: on the card a request shape's first forward
runs eagerly, its second is captured as a CUDA graph and later ones replay
it, with the eager forward's bits; on the CPU it runs eagerly. The
constructors' ``capture=False`` keeps the forward eager, for comparison;
there is no command-line flag.

Usage:
  python -m immunostruct_tpu_torch.cli.serve --artifact model.pt2 --http 8788
  python -m immunostruct_tpu_torch.cli.serve --http 8788                 # seeded weights
  python -m immunostruct_tpu_torch.cli.serve --checkpoint ft.ckpt --oneshot req.npz
  python -m immunostruct_tpu_torch.cli.serve --checkpoint ft.ckpt --watch-dir q/
"""

from __future__ import annotations

import argparse
import functools
import io
import json
import os
import time
from http.server import BaseHTTPRequestHandler, HTTPServer
from typing import Optional

import numpy as np
import torch

from immunostruct_tpu_torch.data.synthetic import write_example
from immunostruct_tpu_torch.ops.mega import check_paired
from immunostruct_tpu_torch.structs import GraphBatch
from immunostruct_tpu_torch.utils.capture import Program, module_tensors
from immunostruct_tpu_torch.utils.export import REQUEST_KEYS, load_exported

__all__ = ["BadRequest", "Scorer", "ArtifactScorer", "request_to_args",
           "write_example", "serve_one", "make_http_server", "main"]


class BadRequest(ValueError):
    """The request is not an ``.npz`` of the expected arrays and shapes."""


def _load_npz(source) -> dict:
    try:
        with np.load(source, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    except Exception as e:  # noqa: BLE001 - any unreadable body
        raise BadRequest(f"not a readable .npz: {type(e).__name__}: {e}") from e


def _read_request(source, model=None) -> dict:
    """The request's arrays, checked against each other and, given
    ``model``, against its input widths. Raises ``BadRequest``."""
    arrays = _load_npz(source)
    missing = sorted(set(REQUEST_KEYS) - set(arrays))
    if missing:
        raise BadRequest(f"missing arrays {missing}")
    if arrays["node_feat"].ndim != 3:
        raise BadRequest(f"node_feat has shape {arrays['node_feat'].shape}, "
                         f"expected [B, N, F]")
    b, n, _ = arrays["node_feat"].shape
    e = arrays["edge_src"].shape[-1] if arrays["edge_src"].ndim == 2 else -1
    seq = arrays["seq"]
    want = {"coords": (b, n, 3), "edge_src": (b, e), "edge_dst": (b, e),
            "edge_feat": (b, e, 1), "edge_mask": (b, e),
            "node_mask": (b, n), "num_nodes": (b,),
            "seq": (b,) + seq.shape[1:2] + (21,), "props": (b, 2)}
    for name, shape in want.items():
        if arrays[name].shape != shape:
            raise BadRequest(f"{name} has shape {arrays[name].shape}, "
                             f"expected {shape}")
    if model is not None:
        from immunostruct_tpu_torch.models.trunk import NUM_AMINO_ACIDS

        if (model.spec.use_structure
                and arrays["node_feat"].shape[2] < NUM_AMINO_ACIDS):
            raise BadRequest(f"node_feat has {arrays['node_feat'].shape[2]} "
                             f"features, the model reads {NUM_AMINO_ACIDS}")
        if (model.spec.use_sequence
                and seq.shape[1] * 21 != model.vae.fc1.w.shape[0]):
            raise BadRequest(f"seq has length {seq.shape[1]}, the model "
                             f"takes {model.vae.fc1.w.shape[0] // 21}")
    return arrays


def request_to_args(source, device, model=None, *, paired: bool = False,
                    ones_edge_feat: bool = False):
    """Parse a request ``.npz`` (path or file-like) into (graph, seq, props)
    on ``device``. A malformed request raises ``BadRequest`` before anything
    reaches the device; so does, on the host, a request that breaks the
    mirror-paired layout (``paired``) or has edge features other than 1 on
    an unmasked edge (``ones_edge_feat``)."""
    arrays = _read_request(source, model)
    if paired:
        try:
            check_paired(arrays["edge_src"], arrays["edge_dst"],
                         arrays["edge_mask"].astype(bool))
        except ValueError as e:
            raise BadRequest(str(e)) from e
    if ones_edge_feat and not (arrays["edge_feat"][
            arrays["edge_mask"].astype(bool)] == 1).all():
        raise BadRequest("edge_feat holds values other than 1 on unmasked "
                         "edges; the fused_stack forward (B7) takes all-ones "
                         "edge features")
    graph = GraphBatch.from_numpy(arrays, device)
    seq = torch.as_tensor(arrays["seq"]).to(device=device,
                                            dtype=torch.float32)
    props = torch.as_tensor(arrays["props"]).to(device=device,
                                                dtype=torch.float32)
    return graph, seq, props


def _timed(scorer, args):
    """``scorer(*args)`` as (probs, ms), ms the wall time on the host; a
    failed forward is recorded in ``scorer.failure`` (``/healthz`` then
    answers 503) and raised."""
    t0 = time.perf_counter()
    try:
        probs = scorer(*args)
    except Exception as e:
        scorer.failure = f"{type(e).__name__}: {e}"
        raise
    return probs, (time.perf_counter() - t0) * 1e3


class Scorer:
    """The deterministic inference function ``probs = f(graph, seq, props)``.
    ``mega_variant`` and ``fused_stack`` are ``model_apply``'s; with either
    set, ``score_request`` holds each request to what the path reads (the
    mirror-paired layout; all-ones edge features) on the host. The forward
    is a ``utils/capture.py`` program (``program``): on the card each
    request shape's forward is captured as a CUDA graph and replayed;
    ``capture=False`` keeps it eager (the comparison), True captures or
    raises."""

    def __init__(self, model, *, device, compute_dtype=torch.bfloat16,
                 aggregation: str = "auto", seed: int = 0,
                 mega_variant: str = "hybrid", fused_stack: bool = False,
                 capture: Optional[bool] = None):
        self.model = model.eval()
        self.device = torch.device(device)
        self.compute_dtype = compute_dtype
        self.aggregation = aggregation
        self.seed = seed
        self.mega_variant = mega_variant
        self.fused_stack = fused_stack
        self.failure = None     # the first failed forward, as text
        self.program = Program("served forward", capture)

    def generator(self) -> torch.Generator:
        """The VAE noise source of one request: seeded afresh each time."""
        return torch.Generator(device=self.device).manual_seed(self.seed)

    def _forward(self, inputs, generator):
        from immunostruct_tpu_torch.models.trunk import model_apply

        graph, seq, props = inputs
        out = model_apply(self.model, graph, seq, props,
                          generator=generator, deterministic=True,
                          aggregation=self.aggregation,
                          compute_dtype=self.compute_dtype,
                          mega_variant=self.mega_variant,
                          fused_stack=self.fused_stack)
        return torch.sigmoid(out.logits.reshape(-1))

    def probs(self, graph, seq, props) -> torch.Tensor:
        """The probabilities on the device, without waiting for them."""
        from immunostruct_tpu_torch.models.trunk import program_aggregation

        agg, eager = program_aggregation(self.model, graph, self.aggregation,
                                         self.compute_dtype)
        with torch.inference_mode():
            return self.program(
                self._forward, (graph, seq, props),
                static=(agg, self.compute_dtype, self.mega_variant,
                        self.fused_stack),
                seed=self.seed,
                state=functools.partial(module_tensors, self.model),
                eager=eager)

    def __call__(self, graph, seq, props) -> np.ndarray:
        return self.probs(graph, seq, props).cpu().numpy()

    def score_request(self, source):
        """Score a request path or file-like; returns (probs, ms), where ms
        is the wall time from parsed request to probabilities on the host."""
        args = request_to_args(source, self.device, self.model,
                               paired=self.mega_variant == "paired",
                               ones_edge_feat=self.fused_stack)
        return _timed(self, args)


class ArtifactScorer:
    """A loaded artifact (``utils/export.py::load_exported``) with
    ``Scorer``'s interface: ``score_request`` holds the request to the
    program's signature on the host (``BadRequest`` when a shape or dtype
    differs), runs it on the artifact's device and records a failed
    forward in ``failure``."""

    def __init__(self, artifact, capture: Optional[bool] = None):
        self.artifact = artifact
        self.device = artifact.device
        self.failure = None     # the first failed forward, as text
        # the loaded program's forward, captured on the card as Scorer's
        self.program = Program("artifact", capture)

    def probs(self, *tensors) -> torch.Tensor:
        """The probabilities on the device, without waiting for them."""
        return self.program(
            lambda inputs, _: self.artifact(*inputs), tensors, seed=0,
            state=functools.partial(module_tensors, self.artifact.module))

    def __call__(self, *tensors) -> np.ndarray:
        return self.probs(*tensors).cpu().numpy()

    def score_request(self, source):
        """Score a request path or file-like; returns (probs, ms), where ms
        is the wall time from parsed request to probabilities on the host."""
        arrays = _load_npz(source)
        try:
            self.artifact.check(arrays)
        except ValueError as e:
            raise BadRequest(str(e)) from e
        tensors = [torch.from_numpy(arrays[k]).to(self.device)
                   for k in REQUEST_KEYS]
        return _timed(self, tensors)


def serve_one(scorer, req_path: str) -> str:
    probs, ms = scorer.score_request(req_path)
    out_path = req_path[: -len(".npz")] + ".probs.npy"
    np.save(out_path, probs)
    print(f"{os.path.basename(req_path)}: {probs.shape[0]} probs in "
          f"{ms:.1f} ms -> {out_path}")
    return out_path


def make_http_server(scorer, host: str = "127.0.0.1",
                     port: int = 0) -> HTTPServer:
    """HTTP scoring endpoint. Returns the ``HTTPServer`` (not started);
    callers read the bound port from ``server_address`` and drive
    ``serve_forever``/``shutdown``. Single-threaded: one card, one request
    at a time."""

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (http.server API)
            if self.path == "/healthz" and scorer.failure is None:
                self._reply(200, {"status": "ok"})
            elif self.path == "/healthz":
                self._reply(503, {"status": "failed",
                                  "error": scorer.failure})
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):  # noqa: N802
            if self.path != "/score":
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
            except ValueError:
                self._reply(400, {"error": "Content-Length is not a number"})
                return
            try:
                probs, ms = scorer.score_request(io.BytesIO(self.rfile.read(n)))
            except BadRequest as e:
                self._reply(400, {"error": str(e)})
                return
            except Exception as e:  # noqa: BLE001 - the forward failed
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                return
            try:
                self._reply(200, {"probs": probs.tolist(), "ms": ms})
            except (BrokenPipeError, ConnectionResetError):
                pass  # the client went away; nothing to send it

        def log_message(self, fmt, *a):  # responses carry the information
            pass

    return HTTPServer((host, port), Handler)


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_scorer(args):
    """The scorer of parsed command-line arguments: the artifact's, or a
    Scorer of the model rebuilt from the checkpoint (the model modules are
    imported here, on that path only)."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but torch finds no CUDA device; "
                           "pass --device cpu to serve on the CPU")
    if args.artifact:
        return ArtifactScorer(load_exported(args.artifact, device))
    from immunostruct_tpu_torch.models.zoo import build_model
    from immunostruct_tpu_torch.utils.checkpoint import load_jax_checkpoint

    gen = torch.Generator().manual_seed(args.seed)
    _, model = build_model(args.model, args.seq_len * 21, gen, device=device)
    if args.checkpoint:
        load_jax_checkpoint(args.checkpoint, model)
    else:
        print(f"WARNING: no --checkpoint; serving {args.model} with random "
              f"weights drawn from seed {args.seed}")
    return Scorer(model, device=device,
                  compute_dtype=_DTYPES[args.compute_dtype],
                  aggregation=args.aggregation, seed=args.seed)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--artifact", type=str, default=None,
                    help="a torch.export program of cli/export_model.py; "
                         "serves it without the model code (the model "
                         "flags and --checkpoint do not apply)")
    ap.add_argument("--checkpoint", type=str, default=None,
                    help="JAX package checkpoint (npz); without it the "
                         "weights are drawn from --seed")
    ap.add_argument("--model", type=str, default="HybridModelv2")
    ap.add_argument("--compute-dtype", default="bfloat16",
                    choices=sorted(_DTYPES))
    ap.add_argument("--aggregation", default="auto",
                    choices=["auto", "mega", "scatter"],
                    help="EGNN aggregation: 'mega' (the Hopper kernel), "
                         "'scatter' (plain PyTorch), 'auto' ('mega' on "
                         "CUDA, 'scatter' on CPU)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' (default) fails when no CUDA "
                         "device is present")
    ap.add_argument("--seed", type=int, default=1,
                    help="seeds the random weights (without --checkpoint) "
                         "and the VAE noise generator")
    ap.add_argument("--seq-len", type=int, default=284,
                    help="sequence length L of requests (VAE input L*21)")
    ap.add_argument("--watch-dir", type=str)
    ap.add_argument("--oneshot", type=str)
    ap.add_argument("--write-example", type=str,
                    help="write an example request (B=8, N=32, E=128, "
                         "L=--seq-len) to this path")
    ap.add_argument("--poll-secs", type=float, default=0.2)
    ap.add_argument("--http", type=int, default=None, metavar="PORT",
                    help="serve POST /score + GET /healthz on this port")
    ap.add_argument("--host", type=str, default="127.0.0.1")
    return ap


def main(argv=None):
    ap = parser()
    args = ap.parse_args(argv)

    if args.write_example:
        write_example(args.write_example, seq_len=args.seq_len)
        print(f"wrote example request {args.write_example}")
        if not (args.oneshot or args.http is not None or args.watch_dir):
            return
    if not (args.oneshot or args.http is not None or args.watch_dir):
        ap.error("one of --watch-dir, --oneshot, --http or --write-example "
                 "is required")
    if args.artifact and args.checkpoint:
        ap.error("--artifact serves an exported program; it does not take "
                 "--checkpoint (export the checkpoint with "
                 "cli/export_model.py)")

    scorer = build_scorer(args)

    if args.oneshot:
        serve_one(scorer, args.oneshot)
        return

    if args.http is not None:
        server = make_http_server(scorer, args.host, args.http)
        host, port = server.server_address[:2]
        print(f"scoring at http://{host}:{port}/score (ctrl-c to stop)",
              flush=True)
        try:
            server.serve_forever()
        finally:
            server.server_close()
        return

    print(f"serving from {args.watch_dir} (ctrl-c to stop)")
    # processed state is keyed by (name, size, mtime): a request caught
    # mid-copy is retried once the writer finishes; a bad file is rejected
    # once per version
    done = set()
    while True:
        for fname in sorted(os.listdir(args.watch_dir)):
            if not fname.endswith(".npz"):
                continue
            path = os.path.join(args.watch_dir, fname)
            try:
                st = os.stat(path)
            except OSError:
                continue
            key = (fname, st.st_size, st.st_mtime_ns)
            if key in done:
                continue
            try:
                serve_one(scorer, path)
            except BadRequest as e:  # a failed forward stops the server
                print(f"REJECTED {fname} (will retry if the file changes): {e}")
            done.add(key)
        time.sleep(args.poll_secs)
