"""ImmunoStruct in PyTorch for one NVIDIA H100: the port of ``immunostruct_tpu``.

The JAX package (``immunostruct_tpu``) is the reference this package is held
against; module names mirror it so that each counterpart is easy to find:

  structs.py           GraphBatch / SampleBatch / ComparativeBatch dataclasses
  data/synthetic.py    seeded numpy inputs, bit-identical to the JAX package's
  ops/nnp.py           Linear ([in, out] weights, f32 accumulation), dropout
  ops/egnn.py          EGNN layers; aggregation 'scatter' | 'mega' | 'auto'
  ops/mega.py          edge_mega (a torch.autograd.Function): the Hopper
                       kernels B1 (csrc/egnn_mega_fwd.cu, forward with
                       residuals) and B2 (csrc/egnn_tail_bwd.cu, backward),
                       each beside its plain PyTorch version
  ops/_build.py        nvcc build of csrc/*.cu at first use, ctypes binding
  ops/attention.py     self-attention and multi-head attention
  ops/pooling.py       mean / max readout over the node axis
  models/trunk.py      ModelSpec, the model nn.Module, model_apply,
                       model_apply_comparative
  models/zoo.py        the 14-entry model registry
  procedures/train.py  make_optimizer, TrainState, Trainer (train/eval step)
  utils/losses.py      stage losses; utils/contrastive.py the twin term
  utils/schedule.py    learning-rate schedules; utils/seeding.py
  utils/checkpoint.py  loads the JAX package's npz checkpoints
  serving.py           HTTP / file-queue scoring of .npz requests
  cli/serve.py         ``python -m immunostruct_tpu_torch.cli.serve``

This package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"
