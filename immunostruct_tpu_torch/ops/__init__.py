"""Operators: linear, EGNN, the edge_mega kernel, attention, pooling."""


def launch_counters() -> dict:
    """The hand-written kernels' launch wrappers, by kernel: each wrapper's
    ``launches`` counts the launches of its kernel. The wrappers' modules
    are imported here, not when this package is."""
    from immunostruct_tpu_torch.ops.edge import edge_program, edge_program_bwd
    from immunostruct_tpu_torch.ops.fused_layer import fused_egnn_layer
    from immunostruct_tpu_torch.ops.mega import (
        edge_mega, edge_mega_paired_fwd, tail_bwd, tail_bwd_db,
        tail_bwd_nodes,
    )
    from immunostruct_tpu_torch.ops.segment import (
        segment_gather, segment_scatter,
    )
    from immunostruct_tpu_torch.ops.stack import stack_fwd

    return {"B1": edge_mega, "B2": tail_bwd, "B3_fwd": edge_program,
            "B3_bwd": edge_program_bwd, "B4": edge_mega_paired_fwd,
            "B5a": tail_bwd_db, "B5b": tail_bwd_nodes, "B6": stack_fwd,
            "B7": fused_egnn_layer, "B8_scatter": segment_scatter,
            "B8_gather": segment_gather}


def read_launch_counts() -> dict:
    """Each kernel's launches so far (``launch_counters``' keys)."""
    return {k: fn.launches for k, fn in launch_counters().items()}
