"""ImmunoStruct in PyTorch for one NVIDIA H100: the port of ``immunostruct_tpu``.

The JAX package (``immunostruct_tpu``) is the reference this package is held
against; module names mirror it so that each counterpart is easy to find:

  structs.py           GraphBatch / SampleBatch as torch dataclasses
  data/synthetic.py    seeded numpy inputs, bit-identical to the JAX package's
  ops/nnp.py           Linear ([in, out] weights, f32 accumulation), dropout
  ops/egnn.py          EGNN layers; aggregation 'scatter' | 'mega' | 'auto'
  ops/mega.py          edge_mega: the hand-written Hopper kernel
                       (csrc/egnn_mega_fwd.cu) and its plain PyTorch version
  ops/_build.py        nvcc build of csrc/*.cu at first use, ctypes binding
  ops/attention.py     self-attention and multi-head attention
  ops/pooling.py       mean / max readout over the node axis
  models/trunk.py      ModelSpec, the model nn.Module, model_apply
  models/zoo.py        the 14-entry model registry
  utils/checkpoint.py  loads the JAX package's npz checkpoints
  serving.py           HTTP / file-queue scoring of .npz requests
  cli/serve.py         ``python -m immunostruct_tpu_torch.cli.serve``

This package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"
