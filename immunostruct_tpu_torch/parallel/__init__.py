"""Parallelism over ``torch.distributed`` (counterpart of
``immunostruct_tpu/parallel/``): the rank grid and batch placement
(``mesh``), collectives and the ring all-reduce (``collectives``), the
data-parallel and model-parallel steps (``trainer``), Megatron pairs
(``tensor``), the GPipe schedule (``pipeline``), the model-parallel
configuration (``mp``) and the multi-rank dry run (``dryrun``).

Only ``mesh`` and ``collectives`` load here: ``ops/nnp.py`` and the loss
modules read the data axis from ``mesh``, and ``trainer`` imports the
training engine, which imports them.
"""

from immunostruct_tpu_torch.parallel.collectives import (
    all_gather, pmax, pmean, ppermute_ring, psum, ring_all_reduce,
)
from immunostruct_tpu_torch.parallel.mesh import (
    Mesh, initialize_distributed, make_mesh, replicate_tree, shard_batch,
    shard_indices_for_process,
)
