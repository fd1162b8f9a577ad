"""Export a trained checkpoint as a serving artifact (counterpart of
``immunostruct_tpu/cli/export_model.py``): a ``torch.export`` program of
the deterministic forward, written with ``utils/export.py``.

Usage:
  python -m immunostruct_tpu_torch.cli.export_model --checkpoint ft.ckpt \\
      --model HybridModelv2 --output model.pt2 \\
      --batch-size 128 --max-nodes 288 --max-edges 2560 --seq-len 284

The checkpoint is an npz of this package or of the JAX package. The program
is traced on ``--device`` (default cuda; it fails without a card) and runs
only there: ``--aggregation auto`` resolves there ('mega' at the published
widths on the card, 'scatter' on the CPU) and is baked in, as is the VAE
noise that ``serve --seed`` would draw (``--seed``). Serve it with
``python -m immunostruct_tpu_torch.cli.serve --artifact model.pt2``.
"""

from __future__ import annotations

import torch

from immunostruct_tpu_torch.cli.common import base_parser, to_config
from immunostruct_tpu_torch.models import build_model
from immunostruct_tpu_torch.structs import GraphBatch
from immunostruct_tpu_torch.utils.checkpoint import load_jax_checkpoint
from immunostruct_tpu_torch.utils.export import (
    export_inference_fn, save_exported,
)


def example_batch(b: int, n: int, e: int, l: int, device):
    """The JAX CLI's example batch: zeros, all-ones edge features, every
    mask False."""
    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    graph = GraphBatch(
        node_feat=zeros(b, n, 20), coords=zeros(b, n, 3),
        edge_src=zeros(b, e, dtype=torch.int32),
        edge_dst=zeros(b, e, dtype=torch.int32),
        edge_feat=torch.ones((b, e, 1), device=device),
        edge_mask=zeros(b, e, dtype=torch.bool),
        node_mask=zeros(b, n, dtype=torch.bool),
        num_nodes=zeros(b, dtype=torch.int32))
    return graph, zeros(b, l, 21), zeros(b, 2)


def main(argv=None):
    p = base_parser("Export the inference function as a torch.export "
                    "program")
    p.add_argument("--checkpoint", required=True, type=str)
    p.add_argument("--output", required=True, type=str)
    p.add_argument("--use-wt-for-downstream", action="store_true")
    p.add_argument("--max-nodes", default=288, type=int)
    p.add_argument("--max-edges", default=2560, type=int)
    p.add_argument("--seq-len", default=284, type=int)
    p.add_argument("--int8", action="store_true",
                   help="weight-only int8 (per-out-channel symmetric) fake-"
                        "quantized weights baked into the artifact; see "
                        "utils/quantize.py")
    args = p.parse_args(argv)
    config = to_config(args)
    device = torch.device(config.device)

    b, n, e, l = config.batch_size, args.max_nodes, args.max_edges, args.seq_len
    _, model = build_model(config.model, l * 21,
                           torch.Generator().manual_seed(config.seed),
                           use_wt_for_downstream=args.use_wt_for_downstream,
                           device=device)
    load_jax_checkpoint(args.checkpoint, model, verbose=False)
    if args.int8:
        from immunostruct_tpu_torch.utils.quantize import fake_quant_int8
        fake_quant_int8(model)

    exported = export_inference_fn(
        model, example_batch(b, n, e, l, device),
        aggregation=config.aggregation,
        compute_dtype=getattr(torch, config.compute_dtype), seed=config.seed)
    save_exported(exported, args.output)
    print(f"exported {config.model} -> {args.output} "
          f"(batch={b}, nodes={n}, edges={e}, seq_len={l}, "
          f"aggregation={exported.immunostruct['aggregation']}, "
          f"device={device.type})")
    return exported


if __name__ == "__main__":
    main()
