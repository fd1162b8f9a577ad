"""Model export for serving (counterpart of ``immunostruct_tpu/utils/export.py``):
the deterministic forward as a ``torch.export`` program.

``export_inference_fn`` traces ``probs = sigmoid(model_apply(...,
deterministic=True).logits)`` into an ``ExportedProgram``; ``save_exported``
writes it as a ``.pt2`` file with the facts a server needs beside it
(``immunostruct.json``: the device type, the aggregation that ran, the
input signature); ``load_exported`` gives back a callable
that needs none of the model code. The kernels are ``torch.library`` ops
(``immunostruct::edge_mega_fwd``, ``edge_program_fwd``, ``segment_scatter``,
``segment_gather``), so the program calls them by name and a process that
loads it must have registered them: ``load_exported`` imports the three op
modules first.

The program takes the request's ten arrays flat, in the order of
``REQUEST_KEYS`` (the npz's), at the example batch's shapes and dtypes: as
in JAX's export, shapes are static, and a request of another shape is
refused (``Artifact.check``).

What tracing fixes is baked in, so an artifact belongs to the device type it
was exported on, as a JAX artifact belongs to its platform:

- the aggregation (``models/trunk.py::gcn_aggregation``, the decision
  the eager forward makes: 'auto' is 'scatter' on the CPU, 'mega' for the
  published widths on the card) and the admission rules;
- the VAE noise. ``eps`` defaults to the draw that ``Scorer(seed=seed)``
  makes for every request (a ``torch.Generator`` on the model's device,
  ``torch.randn`` as ``models/trunk.py::_reparameterize`` calls it, in the
  compute dtype), kept in the program as a constant buffer: the artifact
  gives that Scorer's bits for the same request. (JAX's folds in a fixed
  key for the same purpose.)

The kernels' launch geometry (SM counts, chunks) is read when an op runs,
not when it is traced.
"""

from __future__ import annotations

import json
import os
import zipfile

import numpy as np
import torch
from torch import nn

REQUEST_KEYS = ("node_feat", "coords", "edge_src", "edge_dst", "edge_feat",
                "edge_mask", "node_mask", "num_nodes", "seq", "props")
META_NAME = "immunostruct.json"
_DTYPE_NAMES = {torch.float32: "float32", torch.int32: "int32",
                torch.bool: "bool"}


class _Serve(nn.Module):
    """The traced function of the ten request arrays (no ``GraphBatch``
    and no generator cross the program's boundary)."""

    def __init__(self, model, eps, aggregation, compute_dtype):
        super().__init__()
        self.model = model
        self.aggregation = aggregation
        self.compute_dtype = compute_dtype
        if eps is None:
            self.eps = None
        else:
            self.register_buffer("eps", eps)

    def forward(self, node_feat, coords, edge_src, edge_dst, edge_feat,
                edge_mask, node_mask, num_nodes, seq, props):
        from immunostruct_tpu_torch.models.trunk import model_apply
        from immunostruct_tpu_torch.structs import GraphBatch

        graph = GraphBatch(node_feat, coords, edge_src, edge_dst, edge_feat,
                           edge_mask, node_mask, num_nodes)
        out = model_apply(self.model, graph, seq, props, deterministic=True,
                          aggregation=self.aggregation,
                          compute_dtype=self.compute_dtype, eps=self.eps)
        return torch.sigmoid(out.logits.reshape(-1))


def _noise(model, batch: int, device, compute_dtype, seed: int):
    """The VAE noise ``Scorer(seed=seed)`` draws for a batch of ``batch``
    requests (None for a model without the sequence branch)."""
    from immunostruct_tpu_torch.ops.nnp import draw

    if not model.spec.use_sequence:
        return None
    gen = torch.Generator(device=device).manual_seed(seed)
    return draw(torch.randn, (batch, model.spec.vae_latent_dim), gen,
                device, compute_dtype)


def export_inference_fn(model, example_batch, *, aggregation: str = "onehot",
                        compute_dtype=torch.float32, seed: int = 0,
                        eps=None) -> torch.export.ExportedProgram:
    """An ``ExportedProgram`` of ``probs = f(*request arrays)`` (the ten of
    ``REQUEST_KEYS``) at ``example_batch``'s shapes, on the model's device.

    ``example_batch`` is (graph, seq, props). ``eps``: the VAE noise baked
    into the program; None takes the draw of ``Scorer(seed=seed)``
    (module docstring). Traced under ``torch.no_grad()`` with the model in
    eval mode, so ``'mega'`` takes B1's form without residuals. The
    aggregation that ran is kept on the program as ``.immunostruct`` and
    written beside it by ``save_exported``. A forward that must run eagerly
    (``program_aggregation``: 'scatter' in a narrow dtype, whose ordered
    sums read their passes from the data on the host) is refused: a traced
    program would hold the example batch's passes."""
    from immunostruct_tpu_torch.models.trunk import program_aggregation
    from immunostruct_tpu_torch.structs import GraphBatch

    graph, seq, props = example_batch
    device = next(model.parameters()).device
    args = tuple(t.to(device) for t in (
        graph.node_feat, graph.coords, graph.edge_src, graph.edge_dst,
        graph.edge_feat, graph.edge_mask, graph.node_mask, graph.num_nodes,
        seq, props))
    b = args[0].shape[0]
    if eps is None:
        eps = _noise(model, b, device, compute_dtype, seed)
    else:
        eps = eps.to(device=device, dtype=compute_dtype)
    ran, eager = program_aggregation(model, GraphBatch(*args[:8]),
                                     aggregation, compute_dtype)
    if eager is not None:
        raise ValueError(
            f"aggregation {aggregation!r} runs {ran!r} in {compute_dtype}, "
            f"which cannot be exported ({eager}: the passes of its sums in "
            "edge order are read from the data on the host); export in "
            "float32 or under another aggregation")
    model.eval()
    with torch.no_grad():
        program = torch.export.export(
            _Serve(model, eps, ran, compute_dtype), args)
    # torch.export.save would also write the example batch (10.6 MB at
    # B=128, N=288, E=2560); nothing reads it back
    program.example_inputs = None
    program.immunostruct = dict(
        device=device.type, aggregation=ran,
        inputs=[[k, list(t.shape), _DTYPE_NAMES[t.dtype]]
                for k, t in zip(REQUEST_KEYS, args)])
    return program


def save_exported(exported: torch.export.ExportedProgram, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.export.save(exported, path, extra_files={
        META_NAME: json.dumps(exported.immunostruct)})


def read_meta(path: str) -> dict:
    """The facts ``save_exported`` wrote beside the program, read from the
    archive without loading the program (or its weights)."""
    with zipfile.ZipFile(path) as z:
        names = [n for n in z.namelist()
                 if n.endswith(f"extra/{META_NAME}")]
        if not names:
            raise ValueError(f"{path} holds no {META_NAME}: not an artifact "
                             "of immunostruct_tpu_torch.utils.export")
        return json.loads(z.read(names[0]))


class Artifact:
    """A loaded artifact: ``artifact(*arrays)`` runs the program on tensors
    on ``device``; ``inputs`` is its signature, [(name, shape, dtype
    name)] in ``REQUEST_KEYS`` order; ``meta`` what ``save_exported``
    wrote."""

    def __init__(self, module, meta: dict):
        self.module = module
        self.meta = meta
        self.device = torch.device(meta["device"])
        self.inputs = [(k, tuple(s), d) for k, s, d in meta["inputs"]]

    def check(self, arrays) -> None:
        """Raise ValueError, naming the first fault, unless ``arrays``
        (name -> numpy array) holds each input at the program's shape and
        dtype."""
        for name, shape, dtype in self.inputs:
            if name not in arrays:
                raise ValueError(f"missing array {name}")
            a = np.asarray(arrays[name])
            if tuple(a.shape) != shape:
                raise ValueError(f"{name} has shape {tuple(a.shape)}, the "
                                 f"artifact takes {shape}")
            if a.dtype.name != dtype:
                raise ValueError(f"{name} has dtype {a.dtype.name}, the "
                                 f"artifact takes {dtype}")

    def __call__(self, *arrays) -> torch.Tensor:
        with torch.inference_mode():
            return self.module(*arrays)


def load_exported(path: str, device=None) -> Artifact:
    """Load an artifact of ``save_exported``. ``device`` (a device or its
    name; None: the artifact's own) must be of the device type the artifact
    was exported on, else ValueError before anything is loaded. Imports the
    kernels' op modules first, so that the program's ops resolve; imports
    nothing of ``immunostruct_tpu_torch.models``."""
    import immunostruct_tpu_torch.ops.edge  # noqa: F401  (registers the ops)
    import immunostruct_tpu_torch.ops.mega  # noqa: F401
    import immunostruct_tpu_torch.ops.segment  # noqa: F401

    meta = read_meta(path)
    if device is not None and torch.device(device).type != meta["device"]:
        raise ValueError(
            f"{path} was exported on {meta['device']} (the aggregation "
            f"'{meta['aggregation']}' and the weights' placement are baked "
            f"in); it does not run on {torch.device(device).type}: export "
            "it again there")
    if meta["device"] == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{path} was exported on cuda and torch finds no "
                           "CUDA device")
    return Artifact(torch.export.load(path).module(), meta)
