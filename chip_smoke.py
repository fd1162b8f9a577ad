"""Smoke test of the PyTorch port (immunostruct_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (none catches its own failure; any failure exits non-zero):
  1. require CUDA;
  2. print the card's name and power limit (nvidia-smi);
  3. build the ten Hopper kernel sources with nvcc, one process per source,
     all at once: csrc/egnn_mega_fwd.cu (B1, the EGNN edge forward from raw
     indices), csrc/egnn_tail_bwd.cu (B2, its backward), csrc/egnn_edge_fwd.cu
     and csrc/egnn_edge_bwd.cu (B3, the edge program over gathered bundles,
     forward and backward), csrc/segment.cu (B8, the segment scatter and
     gather), and the 'mega' variants: csrc/egnn_mega_paired_fwd.cu (B4, B1
     on the mirror-paired layout), csrc/egnn_tail_bwd_db.cu (B5a, B2 reading
     g[dst] itself), csrc/egnn_tail_bwd_nodes.cu (B5b, the edge half's
     backward up to node space) and csrc/egnn_stack_fwd.cu (B6, the whole
     conv stack forward), and csrc/egnn_layer_fwd.cu (B7, one whole EGNN
     layer forward), with their shared csrc/egnn_common.cuh, csrc/
     egnn_hopper.cuh (the tensor-core building blocks of B1, B2, B5a, B5b
     and B3's backward in bf16) and csrc/egnn_tail.cuh (the tail backward
     of B2, B5a and B5b);
  4. compare B1 with its plain PyTorch version on the card at the main
     path's shapes (B=128, N=288, H=64, E=2560 and 1408, F=20 and 64, 10% of
     the edges masked, self-loops), in f32 (TF32 off) and bf16, and in bf16
     at E=2560, F=64 also at B=1 (one graph over many CTAs) and B=200 (more
     graphs than SMs), output and the a1/xd residuals; time the kernel with
     and without its residual stores and the plain version, and print its
     shared memory a CTA and CTAs an SM;
  5. compare B2 with its plain version at the same shapes (its residuals
     from B1, a seeded cotangent), and in bf16 at E=2560, F=64 also at B=1
     and B=200 (one graph; more graphs than SMs); the same bits twice; time
     both and print the kernel's shared memory per CTA;
  6. compare the EdgeMega gradients (B1 + B2 + the node-level backward) with
     autograd through the plain forward (f32) and with the plain backward
     (bf16) at B=128, E=2560, F=64;
  7. compare B3's forward and backward with their plain versions at the same
     shapes (bundles gathered as 'fused' gathers them, zeros for masked
     edges; a seeded cotangent; in bf16 also dbc1 against the sum of d_p3
     unrounded), check that its weight gradients are the
     same bits twice, and time all four, printing the backward's shared
     memory a CTA and CTAs an SM; at E=2560 in bf16, read the weight
     gradients of the kernel, of the plain version on the card and of the
     plain version on the CPU against the exact (float64) sums;
  8. compare one EGNN layer under 'fused' (B3 + the gathers and the
     index_add_ aggregation) with the same layer on B3's plain versions:
     outputs and gradients, f32 and bf16, B=128, E=2560, F=64;
  9. compare B8's scatter and gather with their plain versions (B=128,
     N=288, C=H+3=67, E=2560 and 1408, 10% of the edges masked, indices at
     -1 and N on masked and unmasked edges; f32 with TF32 off and bf16): the
     gather bit for bit, the scatter within its bounds (SCATTER_BF16_FLOOR)
     and the same bits twice; time each beside its plain version and the
     nearest library call (index_add_, index_select), and print the bound;
  10. compare one EGNN layer under 'pallas' (B8's scatter, its gather in the
     backward) with the same layer on B8's plain versions: outputs and
     gradients, f32 and bf16, B=128, E=2560, F=64;
  11. compare B4 with its plain version on mirror-paired batches (B=128,
     N=288, H=64, E=2560 and 1408, F=20 and 64, f32 and bf16, 10% of the arcs
     masked, arcs at -1 and N, self-loops): B1's bounds, its residuals
     against B1's on the same batch; time it with and without residuals,
     beside its plain version and B1;
  12. compare B5a with its plain version and with B2 on the same operands
     (bit for bit), at phase 5's shapes, the same bits twice; time it beside
     both;
  13. compare B5b with its plain version (the node sums per column, d_ef and
     the weight gradients) at phase 5's shapes, the same bits twice; time it
     beside its plain version and beside what it replaces on the 'hybrid'
     path;
  14. compare B6 (six layers, F0=20, H=64) layer by layer with the plain
     version of that layer run from the kernel's own previous h and x, f32
     and bf16, E=2560 and 1408; time it with and without residuals, beside
     its plain version and the per-layer forward;
  14a. compare B7 with its plain version at phase 4's shapes (unmasked
     edges with src or dst at -1 and N among them): h' and x' per column
     within one bf16 step at the column's largest value and BF16_COL_MEAN
     in bf16, F32_TOL in f32, the same bits twice; time it beside its plain
     version and print its bound;
  15. serve full-width HybridModelv2 with seeded weights in bf16 over HTTP on
     127.0.0.1 (ephemeral port), POST requests (B=128 at E=2560, B=128 at
     E=1408, B=1): probabilities finite, in (0, 1), matching the same batch
     through aggregation='scatter', the same when a request is sent again,
     6 B1 launches and no other launch per request;
  15a. the sixth slice's main path: the same model and requests through
     Scorer(fused_stack=True): probabilities within PROB_ATOL of 'scatter',
     a repeated request the same bits, exactly 6 B7 launches and no other
     per request, the median forward beside phase 15's 'mega';
  16. train full-width HybridModelv2 (bf16 over f32 master weights, Adam
     1e-3, the loss config of the JAX package's bench) on
     random_sample_batch(128, 288, E, 284) for E=2560 and 1408: the first
     step's loss and gradients under 'mega' against 'scatter' from the same
     weights, then 20 'mega' steps (6 B1 + 6 B2 launches each, finite loss
     that falls) and 10 'scatter' steps, with the median step time;
  16a. the first full-width train step under 'onehot' and 'onehot_remat'
     against 'scatter' (phase 16's bounds) at E=2560, no kernel launched;
     torch.cuda.max_memory_allocated for one step under each and under
     'mega' (onehot_remat below onehot);
  17. the comparative twin step (HybridModelv2_Comparative, the contrastive
     term at 0.1, random_comparative_batch at E=2560): the first step's loss
     and gradients under 'mega' against 'scatter', in f32 and in bf16, then
     6 steps: 12 B1 + 12 B2 launches per step, finite loss, median step
     time. Its loss is not required to fall: the contrastive term dominates
     it and wanders with each step's noise (PERF.md, Findings);
  18. the same train step under 'fused' at both edge counts: the first
     step against 'scatter', then 20 steps with 6 B3 forward + 6 B3
     backward launches each and a falling loss, beside phase 16's 'mega';
  19. the IEDB entry point: synthetic_corpus writes 512 samples with
     275-residue HLA chains (283-285 tokens, N padded to 288), and
     cli.train_IEDB_wFT.main runs HybridModelv2 at full width with
     --aggregation fused, bf16, batch 128, 2 epochs per stage: both stages
     finish with finite losses, both checkpoints load, the train and test
     metrics have 15 keys with the train threshold reused on test, both B3
     kernels ran in both stages and B3's forward in inference; epoch
     times and pMHC/s printed. Then B3 forward and backward against their
     plain versions as in phase 7, on the operands the entry point gave
     B3's forward (the first of each shape: full and partial batches), in
     bf16 and cast to f32;
  20. the same train step under 'pallas' at both edge counts: the first
     step against 'scatter', then 20 steps with 6 B8 scatter + 6 B8 gather
     launches each (and none of B1-B3) and a falling loss, beside phase 16's
     'mega' and 'scatter';
  21. the Cancer entry point, the fourth slice's main path: the corpus of
     phase 19 and synthetic_comparative_corpus's 256 cancer/WT pairs sharing its
     HLA table (N=288 on both twins); cli.train_Cancer_wFT.main runs
     HybridModelv2_Comparative at full width with --aggregation pallas
     --skip-clinical, bf16, batch 128, the contrastive term at 0.1, 2 epochs
     per stage and the default 64 finetune batches per epoch: three stages
     in order (pretrain, comparative pretrain, comparative finetune) with
     finite losses, both checkpoints load into a fresh
     HybridModelv2_Comparative, 15 metrics per split with the train
     threshold reused on test, both B8 kernels in every stage and the
     scatter alone in both inference passes, no launch of B1-B3; epoch
     times and pMHC/s printed. Then B8 against its plain versions as in
     phase 9 on the operands the entry point gave it (the first of each
     kernel, shape and dtype);
  21a. batch inference: cli.infer_IEDB_or_Cancer.main in-process on phase
     19's finetune checkpoint under --aggregation auto (6 B1 launches per
     batch) and onehot (no kernel): 51 test rows of three columns, the same
     rows and labels, probabilities within PROB_ATOL of each other; then
     --comparative on phase 21's checkpoint (12 B1 launches per batch);
  22. each 'mega' variant's first full-width HybridModelv2 train step
     (bf16) against 'scatter' from the same weights and noise, on
     build_batch's mirror-paired batch at E=2560 and 1408 (phase 16's
     bounds): 'dboth', 'inkernel', 'paired', 'stack';
  23. this slice's main path, the race: cli.race_kernel_variants in-process
     at B=128, E=2560 and 1408, --paired-batch, all six variants (warm-up,
     each variant's first step, a burn-in of 3, two interleaved windows of 5
     steps ending in a value fetch): per step 'diff16' ('hybrid') 6 B1 + 6
     B2, 'dboth' 6 B1 + 6 B5a, 'inkernel' 6 B1 + 6 B5b, 'paired' 6 B4 + 6 B2,
     'stack' 1 B6 + 6 B2, 'fused' 6 + 6 B3, no other kernel, and a finite
     loss that falls for each (its least over the timed steps below the
     first step's: on one fixed batch the loss spikes now and then); every
     count set to 0 before each race and read after it;
  24. serve one B=128 forward with no gradient under 'stack' and 'paired'
     (the served model, a mirror-paired batch at E=2560): probabilities
     within 5e-4 of 'scatter', the variant's kernel alone launched;
  24a. phase 24's 'paired' forward and one 'paired' train step under
     torch.cuda.set_sync_debug_mode("error"): no host sync;
  25. trace forwards and train steps with torch.profiler ('mega',
     'scatter' and fused_stack (B7) for the forwards; for the step also
     'fused', 'pallas' and 'mega' under 'stack', 'inkernel' and 'paired')
     and print the device-busy time, the device's idle share and the
     kernels that take the most device time;
  26. print the times beside the card's name and power limit, then the
     kernel record (eleven kernels) as one JSON line, the card line and, last,
     the result line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
B, N, H, L = 128, 288, 64, 284
EDGE_COUNTS = (2560, 1408)
REQUESTS = (("B=128 E=2560", 128, 2560), ("B=128 E=1408", 128, 1408),
            ("B=1 E=2560", 1, 2560))
F32_TOL = dict(atol=1e-5, rtol=1e-4)
# bf16: the kernels and their plain versions round at the same points, so
# they differ only where a different f32 summation order flips one
# rounding. B1, per output column (H message sums, 3 coordinate sums), over
# all graphs and nodes: max|diff| <= BF16_COL_MAX * max|plain| (one bf16
# step at the column's largest value) and mean|diff| <= BF16_COL_MEAN *
# mean|plain|. A kernel that leaves out any one rounding point fails the
# mean bound (tests/test_torch_port_cuda.py builds such kernels).
BF16_COL_MAX = 4e-3
BF16_COL_MEAN = 1e-4
# B2, bf16, per row of d_cat (over graphs and edges), for d_ef and for each
# weight gradient: mean|diff| <= TAIL_MEAN * mean|plain|; max|diff| <=
# TAIL_MAX_EDGE * max|plain| for d_cat and d_ef (four bf16 steps: one
# flipped rounding moves the rest of its edge's chain), TAIL_MAX_GRAD for
# the weight gradients. f32: d_cat, d_ef as F32_TOL; the weight gradients
# (f32 sums over every edge) |diff| <= 1e-5 * max|plain| + 1e-4 * |plain|.
TAIL_MEAN = 2e-5
TAIL_MAX_EDGE = 1.6e-2
TAIL_MAX_GRAD = 1e-3
# EdgeMega gradients against the plain path, per input: f32 |diff| <=
# 1e-4 * max|plain| + 1e-3 * |plain| (other summation orders through the
# whole backward); bf16 (both round at the JAX backward's points, and the
# plain gradients are cast to the inputs' dtypes as EdgeMega casts them)
# mean|diff| <= GRAD_BF16_MEAN * mean|plain| (the CPU tests' bound against
# the JAX backward).
GRAD_BF16_MEAN = 1e-4
PROB_ATOL = 5e-4          # served probabilities vs the 'scatter' path, bf16
# first train step, bf16, 'mega' against 'scatter' (they round at other
# points in the forward): |loss diff| <= STEP_LOSS_RTOL * |loss|, and per
# parameter ||grad diff|| <= STEP_GRAD_RTOL * ||grad scatter|| +
# STEP_GRAD_ATOL * (the largest ||grad scatter|| of any parameter). An H100
# run read 1.2e-5 on the loss and gradients within 3.4% of a bound 5x this
# wide (||grad diff|| <= 0.34% of ||grad||).
STEP_LOSS_RTOL = 1e-3
STEP_GRAD_RTOL = 0.02
STEP_GRAD_ATOL = 2e-4
# the twin step's first step, 'mega' against 'scatter'. f32 (TF32 off):
# |loss diff| <= TWIN_F32_LOSS_RTOL * |loss|, ||grad diff|| <= TWIN_F32_RTOL
# * ||grad|| + TWIN_F32_ATOL * (the largest ||grad||); an H100 run read the
# same loss and ||grad diff|| <= 1e-5 * ||grad||. bf16: the loss as above,
# ||grad diff|| <= TWIN_BF16_NOISE * ||grad scatter bf16 - grad scatter
# f32|| + STEP_GRAD_ATOL * (the largest ||grad||). The twin model's fusion
# attention is sensitive to bf16: the plain path's own bf16 gradients moved
# 6.7% (of ||grad||) from its f32 ones, and 'mega' differed from 'scatter'
# by 4.0%, on combined_attention.w_concat.w (PERF.md, Findings).
TWIN_F32_LOSS_RTOL = 1e-5
TWIN_F32_RTOL = 1e-3
TWIN_F32_ATOL = 1e-5
TWIN_BF16_NOISE = 2.0
# B3, forward and backward, against its plain versions: f32 edge outputs as
# F32_TOL, weight gradients as B2's; bf16 per row of the [B, C, E] outputs
# (over graphs and edges) and for def, B2's bounds (TAIL_MEAN,
# TAIL_MAX_EDGE): the same chain, rounded at the same points.
# tests/test_torch_port_cuda.py builds B3 mutant kernels, each without one
# rounding point, that fail them. The bf16 weight gradients here sum 16x
# the card tests' edges (B=128): max|diff| <= TAIL_MAX_GRAD * max|plain|
# and mean|diff| <= EDGE_GRAD_MEAN * mean|plain|; dbc1 (dsmall's bc1
# column) no farther from the plain version's than from the sum of d_p3
# unrounded (dbc1_rounding). Against the float64 sums of the plain
# version's own terms, an H100 run read at E=2560 (F=20 and 64): the plain version 2e-7 to 7e-7, the kernel 1.2e-5 to 4.2e-5, and the
# same plain version run on the CPU 7e-6 to 3.0e-5. The spread is other f32
# orders flipping other bf16 roundings along the per-edge chains (B3
# recomputes a1 itself, where B2 is handed B1's); the CPU would fail a
# bound of 2e-5 as well. Every backward mutant fails the bounds at this
# shape (test_edge_bwd_smoke_bound_sees_every_rounding_point).
EDGE_GRAD_MEAN = 1e-4
# Least time for a kernel's work (NVIDIA's H100 SXM data sheet at 700 W): device memory 3.35 TB/s; 989 TFLOP/s for bf16
# operands (tensor cores), 67 TFLOP/s for f32 (outside the tensor cores).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TIMED_REQUESTS = 5
TRAIN_STEPS = 20
SCATTER_STEPS = 10
COMPARATIVE_STEPS = 6
# the entry point at full width: synthetic_corpus with 275-residue HLA
# chains (283-285 tokens, N padded to 288), two epochs per stage
CLI_SAMPLES = 512
CLI_EPOCHS = 2
METRIC_KEYS = 15
# the Cancer entry point: 256 cancer/WT pairs sharing the IEDB corpus's HLA
# table (N=288 on both twins), the flagship's finetune floor of 64 batches
CANCER_PAIRS = 256
MIN_FINETUNING_BATCHES = 64
# B8's scatter, bf16: within one bf16 step of the larger magnitude, or of
# this floor below it (near a cancellation the f32 roundoff of a sum of
# terms of size ~1 can exceed a step there); f32: within 2 * k * 2^-24 *
# (the sum of |m| over the element's k edges), the bound of two f32 sums of
# the same terms in other orders (the plain version sums with atomics).
# tests/test_torch_port_cuda.py builds a scatter that accumulates in bf16,
# which fails it.
SCATTER_BF16_FLOOR = 2.0 ** -10


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def alternate_ms(plain, kernel) -> tuple:
    """(kernel ms, plain ms), timed plain, kernel, kernel, plain."""
    plain_ms = cuda_ms(plain)
    ms = (cuda_ms(kernel) + cuda_ms(kernel)) / 2
    return ms, (plain_ms + cuda_ms(plain)) / 2


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(nbytes: int, flops: float, dtype) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate of their type."""
    mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    return dict(bytes=nbytes, flops=flops, bound_ms=max(mem_ms, ops_ms),
                bound_by="bytes" if mem_ms >= ops_ms else "operations")


def rel_stats(out: torch.Tensor, ref: torch.Tensor) -> dict:
    """The worst row's max and mean of |out - ref|, each relative to the
    same statistic of |ref| in that row. Rows: dim 0 after flattening the
    rest."""
    diff = (out.float() - ref.float()).abs().flatten(1)
    mag = ref.float().abs().flatten(1)
    tiny = torch.finfo(torch.float32).tiny
    return dict(
        max_rel=(diff.amax(1) / mag.amax(1).clamp_min(tiny)).max().item(),
        mean_rel=(diff.mean(1) / mag.mean(1).clamp_min(tiny)).max().item())


def bf16_errors(out: torch.Tensor, ref: torch.Tensor) -> dict:
    """B1: the worst output column's max and mean of |out - ref|, each
    relative to the same statistic of |ref| in that column."""
    s = rel_stats(out.flatten(0, 1).T, ref.flatten(0, 1).T)
    return dict(col_max_rel=s["max_rel"], col_mean_rel=s["mean_rel"])


def kernel_inputs(b: int, e: int, f: int, dtype, seed: int):
    from immunostruct_tpu_torch.ops.egnn import EGNNLayer
    from immunostruct_tpu_torch.ops.mega import pack_params

    gen = torch.Generator().manual_seed(seed)
    dev = torch.device("cuda")
    src = torch.randint(0, N, (b, e), generator=gen, dtype=torch.int32)
    dst = torch.randint(0, N, (b, e), generator=gen, dtype=torch.int32)
    src[:, :8] = dst[:, :8]                                  # self-loops
    mask = torch.rand(b, e, generator=gen) >= 0.1            # 10% padded
    ef = torch.randn(b, e, 1, generator=gen)
    h = torch.randn(b, N, f, generator=gen)
    x = torch.randn(b, N, 3, generator=gen)
    layer = EGNNLayer(f, H, H, generator=gen, device=dev)
    weights = [w.detach().contiguous()
               for w in pack_params(layer.edge_mlp, layer.coord_mlp)]
    return (src.to(dev), dst.to(dev), mask.to(dev), ef.to(dev, dtype),
            h.to(dev, dtype), x.to(dev, dtype), *weights)


def residual_errors(got, ref, dtype) -> float:
    """Worst |diff| of a1/xd against the plain version, in units of the
    allowed one (f32: atol + rtol*|ref|; bf16: one bf16 step at the value,
    or at 2^-10 below that: a1 is an f32 sum of terms of size ~1)."""
    worst = 0.0
    for g, r in zip(got, ref):
        assert g.dtype == dtype and g.shape == r.shape
        g, r = g.float(), r.float()
        if dtype == torch.float32:
            allowed = F32_TOL["atol"] + F32_TOL["rtol"] * r.abs()
        else:
            mag = torch.maximum(torch.maximum(g.abs(), r.abs()),
                                torch.tensor(2.0 ** -10, device=g.device))
            allowed = torch.exp2(torch.floor(torch.log2(mag)) - 7)
        worst = max(worst, ((g - r).abs() / allowed).max().item())
    return worst


def fwd_errors(out, ref, dtype) -> tuple:
    """B1's (or B4's) aggregate against its plain version; asserts the
    bounds above. (max |diff|, the bf16 column statistics, the bound)."""
    assert out.shape[1:] == (N, H + 3) and out.dtype == torch.float32
    assert torch.isfinite(out).all()
    err = (out - ref).abs().max().item()
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, **F32_TOL)
        return err, {}, f"atol={F32_TOL['atol']} rtol={F32_TOL['rtol']}"
    rel = bf16_errors(out, ref)
    assert rel["col_max_rel"] <= BF16_COL_MAX, rel
    assert rel["col_mean_rel"] <= BF16_COL_MEAN, rel
    return err, rel, (f"per column: max <= {BF16_COL_MAX}*max|ref|, "
                      f"mean <= {BF16_COL_MEAN}*mean|ref|")


# B1's shapes: the main path's, and the grid's edge cases in bf16 at
# E=2560, F=64: one graph (its edges over many CTAs), more graphs than SMs
FWD_CASES = ([(B, e, f, name, dtype) for e in EDGE_COUNTS for f in (20, 64)
              for name, dtype in (("float32", torch.float32),
                                  ("bfloat16", torch.bfloat16))]
             + [(b, 2560, 64, "bfloat16", torch.bfloat16) for b in (1, 200)])


def occupancy(lib, entry: str, size: int, dtype) -> dict:
    """Shared memory per CTA of a kernel's main kernel and the CTAs of it
    that fit on one SM (B1: size N; B3's backward: size F)."""
    bf16 = int(dtype == torch.bfloat16)
    return dict(smem_per_cta=getattr(lib, f"{entry}_smem_bytes")(size, H,
                                                                   bf16),
                ctas_per_sm=getattr(lib, f"{entry}_ctas_per_sm")(size, H,
                                                                 bf16))


def check_fwd_kernel() -> list:
    from immunostruct_tpu_torch.ops import mega
    from immunostruct_tpu_torch.ops.mega import (
        edge_mega_fwd, edge_mega_fwd_reference, valid_edges,
    )

    rows = []
    for b, e, f, name, dtype in FWD_CASES:
        args = kernel_inputs(b, e, f, dtype, seed=e + f)
        out, a1, xd = edge_mega_fwd(*args, residuals=True)
        torch.cuda.synchronize()
        ref, a1_ref, xd_ref = edge_mega_fwd_reference(*args)
        err, rel, tol = fwd_errors(out, ref, dtype)
        res_err = residual_errors((a1, xd), (a1_ref, xd_ref), dtype)
        assert res_err <= 1.0, res_err
        out_nores = edge_mega_fwd(*args, residuals=False)[0]
        torch.testing.assert_close(out_nores, out, atol=1e-5, rtol=1e-5)
        ms, plain_ms = alternate_ms(
            lambda: edge_mega_fwd_reference(*args),
            lambda: edge_mega_fwd(*args, residuals=False))
        res_ms = cuda_ms(lambda: edge_mega_fwd(*args, residuals=True))
        # the work of the launch with residuals: node projections and the
        # edge chain's two HxH products on the valid edges
        valid = valid_edges(*args[:3], N).sum().item()
        flops = 2 * b * N * f * 2 * H + 2 * valid * 2 * H * H
        work = bound(tensor_bytes(*args, out, a1, xd), flops, dtype)
        # serving's launch: the same work without the a1/xd stores
        bare = bound(tensor_bytes(*args, out), flops, dtype)
        row = dict(B=b, E=e, F=f, dtype=name, max_abs_err=err, **work,
                   bound_ms_without_residuals=bare["bound_ms"],
                   bound_by_without_residuals=bare["bound_by"],
                   max_abs_ref=ref.abs().max().item(), **rel,
                   tolerance=tol, residual_err_in_tol=res_err,
                   ms=ms, ms_with_residuals=res_ms, plain_ms=plain_ms,
                   **occupancy(mega._fwd_lib(), "egnn_mega_fwd", N, dtype))
        print("kernel B1:", json.dumps(row), flush=True)
        rows.append(row)
        del args, out, ref, a1, xd, a1_ref, xd_ref
    return rows


def tail_inputs(e: int, f: int, dtype, seed: int, b: int = B):
    """B2's operands: B1's residuals on seeded inputs, and a seeded node
    cotangent gathered at dst (zero on skipped edges)."""
    from immunostruct_tpu_torch.ops.mega import edge_mega_fwd, valid_edges

    args = kernel_inputs(b, e, f, dtype, seed)
    src, dst, mask, ef = args[:4]
    _, a1, xd = edge_mega_fwd(*args, residuals=True)
    valid = valid_edges(src, dst, mask, N)
    g = torch.randn(b, N, H + 3, generator=torch.Generator().manual_seed(seed))
    d = torch.where(valid, dst, 0).long()[..., None].expand(-1, -1, H + 3)
    d_both = torch.gather(g.to("cuda", dtype), 1, d)
    d_both = torch.where(valid[..., None], d_both, 0.0)
    return (ef, *args[7:], a1, xd, d_both.transpose(1, 2).contiguous(), valid)


def tail_errors(out, ref, dtype) -> dict:
    """B2 against its plain version; asserts the bounds above."""
    assert out[0].dtype == out[1].dtype == dtype
    for t in out:
        assert torch.isfinite(t).all()
    if dtype == torch.float32:
        for g, r in zip(out[:2], ref[:2]):
            torch.testing.assert_close(g, r, **F32_TOL)
        for g, r in zip(out[2:], ref[2:]):
            assert ((g - r).abs() <= 1e-5 * r.abs().max()
                    + 1e-4 * r.abs()).all()
        return dict(max_abs_err=max((g.float() - r.float()).abs().max().item()
                                    for g, r in zip(out, ref)))
    stats = dict(
        d_cat=rel_stats(out[0].transpose(0, 1), ref[0].transpose(0, 1)),
        d_ef=rel_stats(out[1].flatten()[None], ref[1].flatten()[None]),
        weights={k: rel_stats(g.flatten()[None], r.flatten()[None])
                 for k, g, r in zip(("dw2", "dwc1", "dsmall"), out[2:],
                                    ref[2:])})
    for key in ("d_cat", "d_ef"):
        assert stats[key]["max_rel"] <= TAIL_MAX_EDGE, stats
        assert stats[key]["mean_rel"] <= TAIL_MEAN, stats
    for s in stats["weights"].values():
        assert s["max_rel"] <= TAIL_MAX_GRAD, stats
        assert s["mean_rel"] <= TAIL_MEAN, stats
    stats["max_abs_err"] = max((g.float() - r.float()).abs().max().item()
                               for g, r in zip(out, ref))
    return stats


# the tail kernels' (B2, B5a, B5b) shapes: the main path's, and the grid's
# edge cases in bf16 at E=2560, F=64: one graph, and more graphs than SMs
TAIL_CASES = ([(B, e, f, name, dtype) for e in EDGE_COUNTS for f in (20, 64)
               for name, dtype in (("float32", torch.float32),
                                   ("bfloat16", torch.bfloat16))]
              + [(b, 2560, 64, "bfloat16", torch.bfloat16) for b in (1, 200)])


def tail_smem(entry: str, dtype) -> int:
    """Shared memory per CTA of a tail kernel's main kernel."""
    from immunostruct_tpu_torch.ops import mega

    lib = {"egnn_tail_bwd": mega._tail_lib,
           "egnn_tail_bwd_db": mega._tail_db_lib,
           "egnn_tail_bwd_nodes": mega._tail_nodes_lib}[entry]()
    return getattr(lib, f"{entry}_smem_bytes")(H, int(dtype == torch.bfloat16))


def check_tail_kernel() -> list:
    from immunostruct_tpu_torch.ops.mega import tail_bwd, tail_bwd_reference

    rows = []
    for b, e, f, name, dtype in TAIL_CASES:
        args = tail_inputs(e, f, dtype, seed=e + f + 1, b=b)
        out = tail_bwd(*args)
        torch.cuda.synchronize()
        ref = tail_bwd_reference(*args)
        stats = tail_errors(out, ref, dtype)
        again = tail_bwd(*args)
        assert all(torch.equal(g, h) for g, h in zip(out, again)), \
            "B2 changed from one run to the next"
        ms, plain_ms = alternate_ms(
            lambda: tail_bwd_reference(*args),
            lambda: tail_bwd(*args))
        # six HxH products per valid edge
        work = bound(tensor_bytes(*args, *out),
                     2 * args[-1].sum().item() * 6 * H * H, dtype)
        row = dict(B=b, E=e, F=f, dtype=name, **stats, **work, ms=ms,
                   plain_ms=plain_ms,
                   smem_per_cta=tail_smem("egnn_tail_bwd", dtype))
        print("kernel B2:", json.dumps(row), flush=True)
        rows.append(row)
        del args, out, ref, again
    return rows


def check_edge_mega_grads() -> list:
    """EdgeMega's gradients (B1 + B2 + edge_half_bwd) against the plain
    path at B=128, E=2560, F=64."""
    from immunostruct_tpu_torch.ops.mega import (
        EdgeMega, edge_half_bwd, edge_mega_fwd_reference, edge_mega_reference,
        valid_edges,
    )

    rows = []
    for name, dtype in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        args = kernel_inputs(B, 2560, 64, dtype, seed=5)
        cot = torch.randn(B, N, H + 3, generator=torch.Generator()
                          .manual_seed(5)).cuda()
        leaves = [t.detach().clone().requires_grad_(True) for t in args[3:]]
        (EdgeMega.apply(*args[:3], *leaves) * cot).sum().backward()
        got = [t.grad for t in leaves]
        if dtype == torch.float32:
            # autograd through the plain forward: exact math in f32
            plain = [t.detach().clone().requires_grad_(True)
                     for t in args[3:]]
            (edge_mega_reference(*args[:3], *plain) * cot).sum().backward()
            want = [t.grad for t in plain]
        else:
            # the plain backward, which rounds where the JAX backward does
            src, dst, mask = args[:3]
            _, a1, xd = edge_mega_fwd_reference(*args)
            want = edge_half_bwd(src, dst, valid_edges(src, dst, mask, N),
                                 *args[3:], a1, xd, cot, plain=True)
        worst = 0.0
        for g, w, t in zip(got, want, args[3:]):
            g, w = g.float(), w.to(t.dtype).float().reshape(g.shape)
            assert torch.isfinite(g).all()
            if dtype == torch.float32:
                allowed = 1e-4 * w.abs().max() + 1e-3 * w.abs()
                worst = max(worst, ((g - w).abs() / allowed).max().item())
            else:
                worst = max(worst, ((g - w).abs().mean()
                                    / w.abs().mean()).item())
        bound = 1.0 if dtype == torch.float32 else GRAD_BF16_MEAN
        assert worst <= bound, (name, worst)
        row = dict(dtype=name, worst=worst, bound=bound,
                   measure=("max |diff|/allowed" if dtype == torch.float32
                            else "max over inputs of mean|diff|/mean|plain|"))
        print("EdgeMega gradients:", json.dumps(row), flush=True)
        rows.append(row)
    return rows


def post(url: str, body: bytes):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=300) as resp:
        return resp.status, json.loads(resp.read())


def write_requests(tmp: str) -> list:
    from immunostruct_tpu_torch.data.synthetic import write_example

    paths = []
    for label, b, e in REQUESTS:
        path = os.path.join(tmp, f"req_b{b}_e{e}.npz")
        write_example(path, batch=b, nodes=N, edges=e, seq_len=L)
        paths.append((label, b, path))
    return paths


def full_width_scorer():
    from immunostruct_tpu_torch.serving import build_scorer, parser

    args = parser().parse_args(
        ["--http", "0", "--device", "cuda", "--model", "HybridModelv2",
         "--compute-dtype", "bfloat16", "--aggregation", "mega",
         "--seq-len", str(L), "--seed", "1"])
    return build_scorer(args)


def plain_probs(scorer, path):
    """The request's probabilities through the plain 'scatter' path, with
    the VAE noise the server draws for every request."""
    from immunostruct_tpu_torch.models.trunk import model_apply
    from immunostruct_tpu_torch.serving import request_to_args

    graph, seq, props = request_to_args(path, scorer.device, scorer.model)
    with torch.inference_mode():
        out = model_apply(scorer.model, graph, seq, props,
                          generator=scorer.generator(), deterministic=True,
                          aggregation="scatter",
                          compute_dtype=scorer.compute_dtype)
        return torch.sigmoid(out.logits.reshape(-1)).double().cpu()


def _counted():
    """The eleven launch wrappers, in read_counts' order."""
    from immunostruct_tpu_torch.cli.race_kernel_variants import counters

    wrappers = counters()
    return tuple(wrappers[k] for k in ("B1", "B2", "B3_fwd", "B3_bwd",
                                       "B8_scatter", "B8_gather", "B4",
                                       "B5a", "B5b", "B6", "B7"))


def reset_counts():
    for fn in _counted():
        fn.launches = 0


def read_counts() -> tuple:
    """(B1, B2, B3 forward, B3 backward, B8 scatter, B8 gather, B4, B5a,
    B5b, B6, B7) launches."""
    return tuple(fn.launches for fn in _counted())


B7_INDEX = 10                   # B7's place in read_counts()


def check_serving(scorer, requests, kernel: int = 0) -> tuple:
    """Serve ``requests`` over HTTP: each request launches ``kernel`` (its
    index in read_counts(): B1 under 'mega', B7 under fused_stack) once per
    layer and no other kernel; its probabilities are within PROB_ATOL of
    'scatter''s and, sent again, of the first reply's (B7 sums without
    atomics: the same bits)."""
    from immunostruct_tpu_torch.serving import make_http_server

    layers = len(scorer.model.gcn)
    server = make_http_server(scorer, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    host, port = server.server_address[:2]
    base = f"http://{host}:{port}"
    rows = []
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=60) as resp:
            assert json.loads(resp.read()) == {"status": "ok"}
        bodies = []
        for _, _, path in requests:
            with open(path, "rb") as fh:
                bodies.append(fh.read())
        reset_counts()                  # every count to 0: serving starts
        for (label, b, path), body in zip(requests, bodies):
            before = read_counts()
            status, reply = post(base + "/score", body)
            launches = tuple(a - z for a, z in zip(read_counts(), before))
            assert status == 200, reply
            want = tuple(layers if i == kernel else 0 for i in range(11))
            assert launches == want, (label, launches)
            probs = torch.tensor(reply["probs"], dtype=torch.float64)
            assert probs.shape == (b,), probs.shape
            assert torch.isfinite(probs).all()
            assert ((probs > 0) & (probs < 1)).all()
            # the same batch through the plain path, same VAE noise
            prob_err = (probs - plain_probs(scorer, path)).abs().max().item()
            assert prob_err <= PROB_ATOL, (label, prob_err)
            # latency: TIMED_REQUESTS more posts of the same request, each
            # scored as the first was (up to the order of the kernel's f32
            # atomic sums)
            walls, server_ms, repeat_err = [], [], 0.0
            before = read_counts()
            for _ in range(TIMED_REQUESTS):
                t0 = time.perf_counter()
                status, reply = post(base + "/score", body)
                walls.append((time.perf_counter() - t0) * 1e3)
                assert status == 200, reply
                server_ms.append(reply["ms"])
                again = torch.tensor(reply["probs"], dtype=torch.float64)
                repeat_err = max(repeat_err,
                                 (again - probs).abs().max().item())
            assert read_counts()[kernel] - before[kernel] == \
                layers * TIMED_REQUESTS
            assert repeat_err <= PROB_ATOL, (label, repeat_err)
            if kernel == B7_INDEX:
                assert repeat_err == 0.0, (label, repeat_err)
            row = dict(request=label, launches_per_request=launches[kernel],
                       max_abs_prob_err_vs_scatter=prob_err,
                       max_abs_prob_diff_repeated=repeat_err,
                       median_http_wall_ms=statistics.median(walls),
                       median_forward_ms=statistics.median(server_ms))
            print("served:", json.dumps(row), flush=True)
            rows.append(row)
        total = read_counts()           # read just after serving
        try:
            urllib.request.urlopen(base + "/nope", timeout=60).close()
            raise AssertionError("an unknown path was answered")
        except urllib.error.HTTPError as err:
            assert err.code == 404, err
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
    return rows, total


def make_trainer(name: str, aggregation: str, coeff: float = 0.0,
                 seed: int = 0, compute_dtype=torch.bfloat16,
                 mega_variant: str = "hybrid"):
    """A full-width model with seeded weights, its trainer (bf16 over f32
    master weights unless ``compute_dtype`` says otherwise, Adam at 1e-3,
    the JAX bench's loss config, ``mega_variant`` under 'mega') and
    state."""
    from immunostruct_tpu_torch.models import build_model
    from immunostruct_tpu_torch.procedures.train import (
        Trainer, make_optimizer,
    )
    from immunostruct_tpu_torch.utils.losses import LossConfig
    from immunostruct_tpu_torch.utils.schedule import constant_lr

    _, model = build_model(name, L * 21, torch.Generator().manual_seed(seed),
                           device="cuda")
    trainer = Trainer(model.spec, LossConfig(L * 21, pos_weight=1.0,
                                             sequence=True),
                      binary=True,
                      optimizer=make_optimizer("adam", constant_lr(1e-3)),
                      coeff_contrastive=coeff, aggregation=aggregation,
                      compute_dtype=compute_dtype, mega_variant=mega_variant)
    return trainer, trainer.init_state(
        model, torch.Generator().manual_seed(seed + 1))


def timed_steps(trainer, state, batch, steps: int) -> tuple:
    """``steps`` train steps; (losses, step ms), each step ending in a
    synchronize."""
    losses, ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, loss = trainer.train_step(state, batch, seed=0)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    return losses, ms


def first_step(batch, name: str, aggregation: str, compute_dtype,
               coeff: float = 0.0, mega_variant: str = "hybrid") -> tuple:
    """The first step's loss and gradients (float64, by parameter name),
    from seeded weights and the step's seeded noise."""
    from immunostruct_tpu_torch.procedures.train import step_generator

    trainer, state = make_trainer(name, aggregation, coeff,
                                  compute_dtype=compute_dtype,
                                  mega_variant=mega_variant)
    loss = trainer.loss_and_grads(state.model, batch,
                                  step_generator(0, 0, "cuda"))
    grads = {n: p.grad.double() for n, p in state.model.named_parameters()}
    assert all(torch.isfinite(g).all() for g in grads.values()), name
    return float(loss), grads


def worst_grad(got: dict, want: dict, allowed) -> tuple:
    """(largest ||got - want|| / allowed(name) over the parameters, its
    name)."""
    ratios = {n: (got[n] - g).norm().item() / allowed(n)
              for n, g in want.items()}
    name = max(ratios, key=ratios.get)
    return ratios[name], name


def largest_norm(grads: dict) -> float:
    return max(g.norm().item() for g in grads.values())


def first_step_vs_scatter(batch, aggregation: str = "mega",
                          mega_variant: str = "hybrid") -> dict:
    """HybridModelv2's first step in bf16 under ``aggregation`` ('mega',
    with ``mega_variant``, 'fused' or 'pallas') against 'scatter', from the
    same weights and the same noise."""
    lm, gm = first_step(batch, "HybridModelv2", aggregation, torch.bfloat16,
                        mega_variant=mega_variant)
    ls, gs = first_step(batch, "HybridModelv2", "scatter", torch.bfloat16)
    top = largest_norm(gs)
    worst, worst_name = worst_grad(
        gm, gs, lambda n: STEP_GRAD_RTOL * gs[n].norm().item()
        + STEP_GRAD_ATOL * top)
    loss_rel = abs(lm - ls) / abs(ls)
    assert loss_rel <= STEP_LOSS_RTOL, (lm, ls)
    assert worst <= 1.0, (worst_name, worst)
    return {f"loss_{aggregation}": lm, "loss_scatter": ls,
            "loss_rel_diff": loss_rel, "grad_worst_in_tol": worst,
            "grad_worst_param": worst_name}


def twin_first_step_mega_vs_scatter(batch) -> dict:
    """The comparative twin step's first step (contrastive term at 0.1),
    'mega' against 'scatter': in f32 within TWIN_F32_*, and in bf16 within
    TWIN_BF16_NOISE times the plain path's own bf16 rounding noise."""
    name, coeff = "HybridModelv2_Comparative", 0.1
    runs = {(agg, dt): first_step(batch, name, agg, dt, coeff)
            for dt in (torch.float32, torch.bfloat16)
            for agg in ("mega", "scatter")}
    (lm, gm), (ls, gs) = (runs["mega", torch.float32],
                          runs["scatter", torch.float32])
    top = largest_norm(gs)
    f32_worst, f32_name = worst_grad(
        gm, gs, lambda n: TWIN_F32_RTOL * gs[n].norm().item()
        + TWIN_F32_ATOL * top)
    f32_loss_rel = abs(lm - ls) / abs(ls)
    (lbm, gbm), (lbs, gbs) = (runs["mega", torch.bfloat16],
                              runs["scatter", torch.bfloat16])
    noise = {n: (gbs[n] - g).norm().item() for n, g in gs.items()}
    top_bf16 = largest_norm(gbs)
    bf16_worst, bf16_name = worst_grad(
        gbm, gbs, lambda n: TWIN_BF16_NOISE * noise[n]
        + STEP_GRAD_ATOL * top_bf16)
    bf16_loss_rel = abs(lbm - lbs) / abs(lbs)
    assert f32_loss_rel <= TWIN_F32_LOSS_RTOL, (lm, ls)
    assert f32_worst <= 1.0, (f32_name, f32_worst)
    assert bf16_loss_rel <= STEP_LOSS_RTOL, (lbm, lbs)
    assert bf16_worst <= 1.0, (bf16_name, bf16_worst)
    return dict(f32_loss_rel_diff=f32_loss_rel, f32_grad_worst_in_tol=f32_worst,
                f32_grad_worst_param=f32_name, loss_mega=lbm,
                loss_scatter=lbs, loss_rel_diff=bf16_loss_rel,
                grad_worst_in_tol=bf16_worst, grad_worst_param=bf16_name,
                grad_worst_rel_diff=(gbm[bf16_name] - gbs[bf16_name]).norm()
                .item() / gbs[bf16_name].norm().item(),
                grad_worst_rel_bf16_noise=noise[bf16_name]
                / gs[bf16_name].norm().item())


def check_training() -> tuple:
    """Phase 16: the train step ('mega')."""
    from immunostruct_tpu_torch.data.synthetic import random_sample_batch

    layers = 6
    rows = []
    main_counts = (0,) * 11
    for e in EDGE_COUNTS:
        batch = random_sample_batch(B, N, e, L, seed=0, device="cuda")
        first = first_step_vs_scatter(batch, "mega")
        print(f"train first step E={e}:", json.dumps(first), flush=True)
        trainer, state = make_trainer("HybridModelv2", "mega")
        reset_counts()                  # every count to 0: training starts
        losses, ms = timed_steps(trainer, state, batch, TRAIN_STEPS)
        counts = read_counts()          # read just after the 'mega' steps
        assert counts == (layers * TRAIN_STEPS, layers * TRAIN_STEPS) + (
            0,) * 9, counts
        main_counts = tuple(a + c for a, c in zip(main_counts, counts))
        assert all(map(lambda v: v == v and abs(v) < float("inf"), losses))
        assert losses[-1] < losses[0], losses
        del trainer, state
        trainer, state = make_trainer("HybridModelv2", "scatter")
        s_losses, s_ms = timed_steps(trainer, state, batch, SCATTER_STEPS)
        assert read_counts() == counts            # 'scatter' launches none
        del trainer, state
        # the first steps include the allocator's warm-up
        mega_ms = statistics.median(ms[3:])
        scatter_ms = statistics.median(s_ms[3:])
        row = dict(E=e, steps=TRAIN_STEPS,
                   launches_per_step=[c // TRAIN_STEPS for c in counts],
                   loss_first=losses[0], loss_last=losses[-1],
                   median_step_ms_mega=mega_ms,
                   median_step_ms_scatter=scatter_ms,
                   pmhc_per_s_mega=B / (mega_ms / 1e3),
                   pmhc_per_s_scatter=B / (scatter_ms / 1e3),
                   scatter_loss_first=s_losses[0],
                   scatter_loss_last=s_losses[-1], **first)
        print("train:", json.dumps(row), flush=True)
        rows.append(row)
    return rows, main_counts


def check_comparative() -> tuple:
    """Phase 17: the comparative twin step with the contrastive term."""
    from immunostruct_tpu_torch.data.synthetic import random_comparative_batch

    batch = random_comparative_batch(B, N, EDGE_COUNTS[0], L, seed=0,
                                     device="cuda")
    first = twin_first_step_mega_vs_scatter(batch)
    print(f"comparative first step E={EDGE_COUNTS[0]}:", json.dumps(first),
          flush=True)
    trainer, state = make_trainer("HybridModelv2_Comparative", "mega",
                                  coeff=0.1)
    reset_counts()                      # every count to 0: twin steps start
    losses, ms = timed_steps(trainer, state, batch, COMPARATIVE_STEPS)
    counts = read_counts()              # read just after them
    assert counts == (12 * COMPARATIVE_STEPS, 12 * COMPARATIVE_STEPS) + (
        0,) * 9, counts
    assert all(map(lambda v: v == v and abs(v) < float("inf"), losses))
    row = dict(E=EDGE_COUNTS[0], steps=COMPARATIVE_STEPS,
               launches_per_step=[c // COMPARATIVE_STEPS for c in counts],
               loss_first=losses[0], loss_last=losses[-1],
               losses=losses,
               median_step_ms=statistics.median(ms[2:]),
               pmhc_pairs_per_s=B / (statistics.median(ms[2:]) / 1e3),
               **first)
    print("comparative:", json.dumps(row), flush=True)
    return row, counts


def edge_inputs(e: int, f: int, dtype, seed: int):
    """B3's operands as the 'fused' path builds them from kernel_inputs:
    [h ++ x] bundles [B, F+3, E] gathered by src and dst (zeros for a
    masked edge), ef [B, 1, E], the packed weights; and a seeded cotangent
    of the output [B, H+3, E]."""
    src, dst, mask, ef, h, x, *weights = kernel_inputs(B, e, f, dtype, seed)
    rows = torch.cat([h, x], dim=-1)

    def bundle(idx):
        got = torch.gather(rows, 1, idx.long()[..., None].expand(-1, -1, f + 3))
        return torch.where(mask[..., None], got, 0.0).transpose(1, 2) \
            .contiguous()

    dout = torch.randn(B, H + 3, e, generator=torch.Generator()
                       .manual_seed(seed)).to("cuda", dtype)
    return (bundle(src), bundle(dst), ef.transpose(1, 2).contiguous(),
            *weights), dout


def edge_errors(out, ref, dtype) -> dict:
    """B3 against its plain version (the forward's output, or the
    backward's seven outputs); asserts the bounds above."""
    out = out if isinstance(out, tuple) else (out,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for g, r in zip(out, ref):
        assert g.shape == r.shape and torch.isfinite(g).all()
        assert g.dtype == (dtype if g.dim() == 3 else torch.float32)
    stats = dict(max_abs_err=max((g.float() - r.float()).abs().max().item()
                                 for g, r in zip(out, ref)))
    if dtype == torch.float32:
        for g, r in zip(out, ref):
            if g.dim() == 3:
                torch.testing.assert_close(g, r, **F32_TOL)
            else:
                assert ((g - r).abs() <= 1e-5 * r.abs().max()
                        + 1e-4 * r.abs()).all()
        return stats
    names = (("out",) if len(out) == 1 else
             ("dhsx", "dhdx", "def", "dw1ab", "dw2", "dwc1", "dsmall"))
    for name, g, r in zip(names, out, ref):
        if g.dim() == 3:
            s = rel_stats(g.transpose(0, 1), r.transpose(0, 1))
            max_tol, mean_tol = TAIL_MAX_EDGE, TAIL_MEAN
        else:
            s = rel_stats(g.flatten()[None], r.flatten()[None])
            max_tol, mean_tol = TAIL_MAX_GRAD, EDGE_GRAD_MEAN
        assert s["max_rel"] <= max_tol, (name, s)
        assert s["mean_rel"] <= mean_tol, (name, s)
        stats[name] = s
    return stats


def weight_grad_readings(args, dout, grads, ref) -> dict:
    """B3's bf16 weight gradients, per gradient, as mean|diff| / mean|exact|
    against ``exact``, the float64 sums of the plain version's own per-edge
    terms: for the kernel, the plain version on the card and the plain
    version on the CPU (another f32 order in every product and every sum,
    so other flipped bf16 roundings along the chain). Also the kernel and
    the CPU's plain version against the card's."""
    from immunostruct_tpu_torch.ops.edge import edge_program_bwd_reference

    exact = edge_program_bwd_reference(*args, dout,
                                       weight_sums=torch.float64)[3:]
    cpu = edge_program_bwd_reference(*(t.cpu() for t in args),
                                     dout.cpu())[3:]

    def ratio(got, want):
        got, want = got.double().cpu(), want.double().cpu()
        return ((got - want).abs().mean() / want.abs().mean()).item()

    return {name: dict(kernel_vs_exact=ratio(k, x), plain_vs_exact=ratio(p, x),
                       plain_cpu_vs_exact=ratio(c, x),
                       kernel_vs_plain=ratio(k, p),
                       plain_cpu_vs_plain=ratio(c, p))
            for name, k, p, c, x in zip(("dw1ab", "dw2", "dwc1", "dsmall"),
                                        grads[3:], ref[3:], cpu, exact)}


def dbc1_rounding(args, dout, grads, ref) -> float:
    """mean|dbc1 - plain| / mean|dbc1 - the sum of d_p3 unrounded| for B3's
    bf16 backward (dbc1: dsmall's bc1 column): at most 1 when the kernel
    rounds d_p3 before that sum as the plain version does, which no bound
    on dsmall's rows sees; asserted."""
    from immunostruct_tpu_torch.ops.edge import BC1, d_p3_unrounded_sum

    k, r = grads[6][:, BC1], ref[6][:, BC1]
    near = (k - r).abs().mean().item()
    far = (k - d_p3_unrounded_sum(*args, dout)).abs().mean().item()
    assert near <= far, ("B3 dbc1 nearer the sum of d_p3 unrounded", near,
                         far)
    return near / far if far > 0 else 0.0


def check_edge_case(args, dout, where: str, readings: bool = False) -> list:
    """B3 forward and backward on one set of operands against their plain
    versions (the bounds above), the backward's weight gradients the same
    bits twice, all four timed; a forward and a backward row."""
    from immunostruct_tpu_torch.ops import edge
    from immunostruct_tpu_torch.ops.edge import (
        edge_program_bwd, edge_program_bwd_reference, edge_program_fwd,
        edge_program_reference,
    )

    b, f, e = args[0].shape[0], args[0].shape[1] - 3, args[0].shape[2]
    dtype = args[0].dtype
    out = edge_program_fwd(*args)
    grads = edge_program_bwd(*args, dout)
    torch.cuda.synchronize()
    fwd = edge_errors(out, edge_program_reference(*args), dtype)
    ref = edge_program_bwd_reference(*args, dout)
    bwd = edge_errors(grads, ref, dtype)
    if dtype == torch.bfloat16:
        bwd["dbc1_rounding"] = dbc1_rounding(args, dout, grads, ref)
    if readings:
        bwd["weight_sums"] = weight_grad_readings(args, dout, grads, ref)
    again = edge_program_bwd(*args, dout)
    assert all(torch.equal(g, h) for g, h in zip(grads[3:], again[3:])), \
        "B3 weight gradients changed from one run to the next"
    fwd_ms, fwd_plain = alternate_ms(
        lambda: edge_program_reference(*args),
        lambda: edge_program_fwd(*args))
    bwd_ms, bwd_plain = alternate_ms(
        lambda: edge_program_bwd_reference(*args, dout),
        lambda: edge_program_bwd(*args, dout))
    # every edge is computed: three products forward; the backward
    # recomputes them, adds three transposed products and three
    # weight-gradient outer products
    fwd_work = bound(tensor_bytes(*args, out),
                     2 * b * e * (2 * f * H + 2 * H * H), dtype)
    bwd_work = bound(tensor_bytes(*args, dout, *grads),
                     2 * b * e * (3 * 2 * f * H + 6 * H * H), dtype)
    rows = []
    occ = occupancy(edge._bwd_lib(), "egnn_edge_bwd", f, dtype)
    for kind, stats, ms, plain, work in (
            ("fwd", fwd, fwd_ms, fwd_plain, fwd_work),
            ("bwd", bwd, bwd_ms, bwd_plain, bwd_work)):
        row = dict(kernel=kind, shapes=where, B=b, E=e, F=f,
                   dtype=str(dtype).split(".")[1], **stats, ms=ms,
                   plain_ms=plain, **work, **(occ if kind == "bwd" else {}))
        print(f"kernel B3 {kind}:", json.dumps(row), flush=True)
        rows.append(row)
    return rows


def check_edge_kernels() -> list:
    """B3 forward and backward against their plain versions at the bench's
    shapes, timed; at E=2560 in bf16 with the weight gradients' readings
    against their exact sums."""
    rows = []
    for e in EDGE_COUNTS:
        for f in (20, 64):
            for dtype in (torch.float32, torch.bfloat16):
                args, dout = edge_inputs(e, f, dtype, seed=e + f + 2)
                rows += check_edge_case(
                    args, dout, "bench",
                    readings=dtype == torch.bfloat16 and e == EDGE_COUNTS[0])
                del args, dout
    return rows


def check_entry_edge_kernels(operands: dict) -> list:
    """B3 against its plain versions on the operands the entry point gave
    its forward, the first call of each shape (B, F+3, E): full and partial
    batches, bf16 as the entry point ran them and cast to f32, with a
    seeded cotangent for the backward."""
    rows = []
    for key in sorted(operands, key=str):
        (b, c, e, _), args = key, operands[key]
        dout = torch.randn(b, H + 3, e, generator=torch.Generator()
                           .manual_seed(b + c + e))
        for dtype in (torch.float32, torch.bfloat16):
            cast = tuple(t.to(dtype) if t.dim() == 3 else t for t in args)
            rows += check_edge_case(cast, dout.to("cuda", dtype),
                                    "entry point")
    return rows


@contextlib.contextmanager
def plain_b3():
    """Within the block, edge_program runs B3's plain versions on CUDA
    tensors, forward and backward."""
    from immunostruct_tpu_torch.ops import edge

    saved = edge.edge_program_fwd, edge.edge_program_bwd
    edge.edge_program_fwd = edge.edge_program_reference
    edge.edge_program_bwd = edge.edge_program_bwd_reference
    try:
        yield
    finally:
        edge.edge_program_fwd, edge.edge_program_bwd = saved


def check_fused_layer_grads() -> list:
    """EdgeProgram's gradients through one EGNN layer under 'fused' (B3
    forward and backward, the gathers and the index_add_ aggregation)
    against the same layer with B3's plain versions, at B=128, E=2560,
    F=64."""
    from immunostruct_tpu_torch.ops.egnn import EGNNLayer, egnn_apply

    rows = []
    for name, dtype in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        gen = torch.Generator().manual_seed(11)
        layer = EGNNLayer(64, H, H, generator=gen, device="cuda")
        src, dst, mask, ef, h, x = kernel_inputs(B, 2560, 64, torch.float32,
                                                 seed=11)[:6]
        cot_h = torch.randn(B, N, H, generator=gen).to("cuda", dtype)
        cot_x = torch.randn(B, N, 3, generator=gen).to("cuda", dtype)

        def run(kernels):
            layer.zero_grad()
            hin = h.to(dtype).requires_grad_(True)
            xin = x.to(dtype).requires_grad_(True)
            before = read_counts()
            with contextlib.nullcontext() if kernels else plain_b3():
                h2, x2 = egnn_apply(layer, hin, xin, src, dst, ef, mask,
                                    "fused")
                ((h2 * cot_h).float().sum()
                 + (x2 * cot_x).float().sum()).backward()
            torch.cuda.synchronize()
            launched = tuple(a - z for a, z in zip(read_counts(), before))
            assert launched == ((0, 0, 1, 1) + (0,) * 7 if kernels
                                else (0,) * 11), launched
            return [h2.detach(), x2.detach(), hin.grad, xin.grad] + [
                p.grad.clone() for p in layer.parameters()]

        worst = 0.0
        for g, w in zip(run(True), run(False)):
            assert torch.isfinite(g).all()
            g, w = g.float(), w.float()
            if dtype == torch.float32:
                allowed = 1e-4 * w.abs().max() + 1e-3 * w.abs()
                worst = max(worst, ((g - w).abs() / allowed).max().item())
            else:
                worst = max(worst, ((g - w).abs().mean()
                                    / w.abs().mean()).item())
        limit = 1.0 if dtype == torch.float32 else GRAD_BF16_MEAN
        assert worst <= limit, (name, worst)
        row = dict(dtype=name, worst=worst, bound=limit,
                   measure=("max |diff|/allowed" if dtype == torch.float32
                            else "max over outputs and gradients of "
                                 "mean|diff|/mean|plain|"))
        print("EdgeProgram gradients ('fused' layer):", json.dumps(row),
              flush=True)
        rows.append(row)
    return rows


def check_fused_training(mega_rows) -> tuple:
    """The 'fused' train step: its first step against 'scatter', then
    TRAIN_STEPS steps with 6 B3 forward + 6 B3 backward launches each."""
    from immunostruct_tpu_torch.data.synthetic import random_sample_batch

    layers = 6
    rows = []
    for e, mega in zip(EDGE_COUNTS, mega_rows):
        batch = random_sample_batch(B, N, e, L, seed=0, device="cuda")
        first = first_step_vs_scatter(batch, "fused")
        print(f"fused first step E={e}:", json.dumps(first), flush=True)
        trainer, state = make_trainer("HybridModelv2", "fused")
        reset_counts()                  # every count to 0: 'fused' steps
        losses, ms = timed_steps(trainer, state, batch, TRAIN_STEPS)
        counts = read_counts()          # read just after them
        n = layers * TRAIN_STEPS
        assert counts == (0, 0, n, n) + (0,) * 7, counts
        assert all(map(lambda v: v == v and abs(v) < float("inf"), losses))
        assert losses[-1] < losses[0], losses
        del trainer, state
        fused_ms = statistics.median(ms[3:])
        row = dict(E=e, steps=TRAIN_STEPS,
                   launches_per_step=[c // TRAIN_STEPS for c in counts],
                   loss_first=losses[0], loss_last=losses[-1],
                   median_step_ms_fused=fused_ms,
                   pmhc_per_s_fused=B / (fused_ms / 1e3),
                   median_step_ms_mega=mega["median_step_ms_mega"],
                   pmhc_per_s_mega=mega["pmhc_per_s_mega"], **first)
        print("train fused:", json.dumps(row), flush=True)
        rows.append(row)
    return rows, counts


def check_entry_point(tmp: str) -> tuple:
    """The third slice's main path: the train_IEDB_wFT entry point at full
    width under --aggregation fused on a synthetic corpus. Returns its row and
    the operands of B3's forward, the first call of each shape."""
    from immunostruct_tpu_torch.cli import train_IEDB_wFT as cli
    from immunostruct_tpu_torch.data.synthetic import synthetic_corpus
    from immunostruct_tpu_torch.models import build_model
    from immunostruct_tpu_torch.ops import edge
    from immunostruct_tpu_torch.utils.checkpoint import load_checkpoint

    t0 = time.perf_counter()
    graph_dir, props, hla = synthetic_corpus(
        os.path.join(tmp, "corpus"), num_samples=CLI_SAMPLES, hla_len=275,
        seed=3)
    corpus_s = time.perf_counter() - t0
    save_dir = os.path.join(tmp, "ckpt")
    stages, inferences = [], []
    real_train, real_infer = cli.train_model, cli.inference

    def train_model(config, model, train_pipe, *args, **kw):
        before = read_counts()
        model, history = real_train(config, model, train_pipe, *args, **kw)
        graphs = train_pipe.ds.graphs       # the corpus's padded shapes
        stages.append(dict(stage=kw["stage"], history=history, launches=[
            a - z for a, z in zip(read_counts(), before)],
            N=graphs.max_nodes, E=graphs.max_edges,
            edges_per_graph=[int(graphs.edge_mask.sum(1).min()),
                             int(graphs.edge_mask.sum(1).max())]))
        return model, history

    def inference(*args, **kw):
        before = read_counts()
        stats = real_infer(*args, **kw)
        inferences.append([a - z for a, z in zip(read_counts(), before)])
        return stats

    # B3's forward wrapper, called as edge_program and EdgeProgram call it
    # (through the module), keeps a copy of its first operands of each
    # shape; the launch is counted in the wrapped function as before
    operands, real_fwd = {}, edge.edge_program_fwd

    def edge_program_fwd(*args):
        key = (*args[0].shape, args[0].dtype)
        if key not in operands:
            # copies that are not inference tensors (inference runs
            # under torch.inference_mode)
            with torch.inference_mode(False):
                operands[key] = [t.detach().clone() for t in args]
        return real_fwd(*args)

    cli.train_model, cli.inference = train_model, inference
    edge.edge_program_fwd = edge_program_fwd
    try:
        reset_counts()                  # every count to 0: the entry point
        t0 = time.perf_counter()
        train_stats, test_stats = cli.main([
            "--model", "HybridModelv2", "--full-sequence", "--sequence-loss",
            "--aggregation", "fused", "--compute-dtype", "bfloat16",
            "--batch-size", str(B), "--num-epochs", str(CLI_EPOCHS),
            "--device", "cuda", "--seed", "1", "--model-save-dir", save_dir,
            "--graph-dir-IEDB", graph_dir, "--property-path-IEDB", props,
            "--hla-path", hla])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = read_counts()          # read just after the entry point
    finally:
        cli.train_model, cli.inference = real_train, real_infer
        edge.edge_program_fwd = real_fwd

    assert [s["stage"] for s in stages] == ["pretrain", "finetune"], stages
    for s in stages:
        h = s["history"]
        assert len(h["train_loss"]) == CLI_EPOCHS, h
        assert all(v == v and abs(v) < float("inf")
                   for v in h["train_loss"] + h["val_loss"]), h
        b3f, b3b = s["launches"][2:4]
        assert s["launches"][:2] == [0, 0] and b3f > 0 and b3b > 0, s
        assert s["launches"][4:] == [0] * 7, s
    assert len(inferences) == 2, inferences
    for launched in inferences:
        assert launched[2] > 0 and launched.count(0) == 10, launched
    for stats in (train_stats, test_stats):
        assert len(stats) == METRIC_KEYS, sorted(stats)
    assert test_stats["optimal_threshold"] == \
        train_stats["optimal_threshold"]
    ckpts = sorted(f for f in os.listdir(save_dir) if f.endswith(".ckpt"))
    assert [c.rsplit("_", 1)[1] for c in ckpts] == ["finetune.ckpt",
                                                     "pretrain.ckpt"], ckpts
    for c in ckpts:
        path = os.path.join(save_dir, c)
        with np.load(path) as z:        # the VAE's width: the corpus's L*21
            vae_dim = z["['vae']['fc1']['w']"].shape[0]
        _, fresh = build_model("HybridModelv2", vae_dim,
                               torch.Generator().manual_seed(0),
                               device="cuda")
        load_checkpoint(path, fresh, verbose=False)
    epochs = []
    for s in stages:
        h = s["history"]
        for i, (dt, n) in enumerate(zip(h["epoch_time"],
                                        h["train_samples"])):
            epochs.append(dict(stage=s["stage"], epoch=i + 1, epoch_s=dt,
                               train_pmhc=n, pmhc_per_s=n / dt,
                               train_loss=h["train_loss"][i],
                               val_loss=h["val_loss"][i]))
    assert stages[0]["N"] == N and stages[0]["E"] % 128 == 0, stages[0]
    row = dict(save_dir=save_dir, infer_args=[
                   "--graph-dir-IEDB", graph_dir, "--property-path-IEDB",
                   props, "--hla-path", hla],
               samples=CLI_SAMPLES, N=stages[0]["N"], E=stages[0]["E"],
               edges_per_graph=stages[0]["edges_per_graph"],
               corpus_s=corpus_s, wall_s=wall_s,
               launches=counts, launches_by_stage={
                   s["stage"]: s["launches"] for s in stages},
               b3_shapes=sorted(k[:3] for k in operands),
               launches_inference=inferences, epochs=epochs,
               train_roc_auc=train_stats["roc_auc"],
               test_roc_auc=test_stats["roc_auc"],
               threshold=train_stats["optimal_threshold"])
    print("entry point:", json.dumps(row), flush=True)
    return row, operands


# --------------------------------------------------------------------------
# B8: segment scatter and gather ('pallas')
# --------------------------------------------------------------------------

def alternate3_ms(plain, kernel, library) -> tuple:
    """(kernel ms, plain ms, library ms), timed plain, library, kernel,
    kernel, library, plain."""
    plain_ms, library_ms = cuda_ms(plain), cuda_ms(library)
    ms = (cuda_ms(kernel) + cuda_ms(kernel)) / 2
    library_ms = (library_ms + cuda_ms(library)) / 2
    return ms, (plain_ms + cuda_ms(plain)) / 2, library_ms


def segment_inputs(e: int, dtype, seed: int):
    """B8's operands at the main path's shapes: idx/mask [B, E] (10% of the
    edges masked, indices at -1 and N on masked and unmasked edges, some
    nodes repeated), m [B, E, H+3] and h [B, N, H+3]."""
    gen = torch.Generator().manual_seed(seed)
    idx = torch.randint(0, N, (B, e), generator=gen, dtype=torch.int32)
    mask = torch.rand(B, e, generator=gen) >= 0.1
    idx[:, 0:4], idx[:, 4:8] = -1, N
    mask[:, 0:8:2] = False
    idx[:, 8:16] = idx[:, 16:24]
    m = torch.randn(B, e, H + 3, generator=gen)
    h = torch.randn(B, N, H + 3, generator=gen)
    return (idx.cuda(), mask.cuda(), m.to("cuda", dtype),
            h.to("cuda", dtype))


def _valid_rows(idx, mask, n):
    """The valid edges [B, E] and every edge's row of a [B*N, C] view
    (row 0 of its graph where not valid)."""
    valid = mask & (idx >= 0) & (idx < n)
    offs = torch.arange(idx.shape[0], device=idx.device)[:, None] * n
    return valid, (torch.where(valid, idx, 0).long() + offs).reshape(-1)


def scatter_errors(out, ref, idx, mask, m) -> dict:
    """B8's scatter against its plain version; asserts SCATTER_* bounds.
    Returns the max |diff| and the worst |diff| / allowed."""
    from immunostruct_tpu_torch.ops.segment import segment_scatter_reference

    n = out.shape[1]
    assert out.shape == ref.shape and out.dtype == ref.dtype == m.dtype
    assert torch.isfinite(out).all()
    got, want = out.float(), ref.float()
    diff = (got - want).abs()
    if m.dtype == torch.float32:
        abs_sum = segment_scatter_reference(idx, mask, m.abs(), n)
        count = segment_scatter_reference(
            idx, mask, torch.ones_like(m[..., :1]), n)
        allowed = 2 * count * 2.0 ** -24 * abs_sum
    else:
        mag = torch.maximum(torch.maximum(got.abs(), want.abs()),
                            torch.tensor(SCATTER_BF16_FLOOR,
                                         device=got.device))
        allowed = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    assert (diff <= allowed).all(), diff.max().item()
    worst = torch.where(diff > 0, diff / allowed, 0.0).max().item()
    return dict(max_abs_err=diff.max().item(), worst_in_tol=worst)


def check_scatter_case(idx, mask, m, n: int, where: str) -> dict:
    """B8's scatter on one set of operands against its plain version, the
    same bits twice, and timed beside the plain version and the nearest
    library call (index_add_ of the masked messages in f32 into [B*N, C],
    then one cast; the messages and rows are made before the timing)."""
    from immunostruct_tpu_torch.ops.segment import (
        segment_scatter, segment_scatter_reference,
    )

    b, e, c = m.shape
    dtype = m.dtype
    out = segment_scatter(idx, mask, m, n)
    torch.cuda.synchronize()
    ref = segment_scatter_reference(idx, mask, m, n)
    stats = scatter_errors(out, ref, idx, mask, m)
    assert torch.equal(out, segment_scatter(idx, mask, m, n)), \
        "B8 scatter changed from one run to the next"
    valid, rows = _valid_rows(idx, mask, n)
    msgs = torch.where(valid[..., None], m.float(), 0.0).reshape(b * e, c)

    def library():
        return torch.zeros(b * n, c, device=m.device).index_add_(
            0, rows, msgs).to(dtype)

    scatter_errors(library().view(b, n, c), ref, idx, mask, m)
    ms, plain_ms, library_ms = alternate3_ms(
        lambda: segment_scatter_reference(idx, mask, m, n),
        lambda: segment_scatter(idx, mask, m, n), library)
    # this run's data: idx and mask, the valid edges' messages, the output;
    # one f32 add per valid message element
    n_valid = int(valid.sum().item())
    work = bound(tensor_bytes(idx, mask, out) + n_valid * c * m.element_size(),
                 n_valid * c, torch.float32)
    row = dict(kernel="scatter", shapes=where, B=b, E=e, N=n, C=c,
               dtype=str(dtype).split(".")[1], valid_edges=n_valid, **stats,
               ms=ms, plain_ms=plain_ms, library_ms=library_ms, **work)
    print("kernel B8 scatter:", json.dumps(row), flush=True)
    return row


def check_gather_case(idx, mask, h, where: str) -> dict:
    """B8's gather on one set of operands: bit for bit against its plain
    version, and timed beside it and the nearest library call
    (index_select, then the mask)."""
    from immunostruct_tpu_torch.ops.segment import (
        segment_gather, segment_gather_reference,
    )

    b, n, c = h.shape
    e = idx.shape[1]
    out = segment_gather(idx, mask, h)
    torch.cuda.synchronize()
    ref = segment_gather_reference(idx, mask, h)
    assert out.dtype == h.dtype and torch.equal(out, ref), "B8 gather"
    valid, rows = _valid_rows(idx, mask, n)
    hf, keep = h.reshape(b * n, c), valid[..., None]
    zero = torch.zeros((), dtype=h.dtype, device=h.device)

    def library():
        return torch.where(keep, hf.index_select(0, rows).view(b, e, c),
                           zero)

    assert torch.equal(library(), ref)
    ms, plain_ms, library_ms = alternate3_ms(
        lambda: segment_gather_reference(idx, mask, h),
        lambda: segment_gather(idx, mask, h), library)
    # this run's data: idx and mask, the node rows the valid edges read
    # (each once), the output
    used = torch.unique(rows[valid.reshape(-1)]).numel()
    work = bound(tensor_bytes(idx, mask, out) + used * c * h.element_size(),
                 0, torch.float32)
    row = dict(kernel="gather", shapes=where, B=b, E=e, N=n, C=c,
               dtype=str(h.dtype).split(".")[1], rows_read=used,
               max_abs_err=(out.float() - ref.float()).abs().max().item(),
               ms=ms, plain_ms=plain_ms, library_ms=library_ms, **work)
    print("kernel B8 gather:", json.dumps(row), flush=True)
    return row


def check_segment_kernels() -> list:
    """B8 against its plain versions at the main path's shapes, f32 (TF32
    off) and bf16, timed."""
    rows = []
    for e in EDGE_COUNTS:
        for dtype in (torch.float32, torch.bfloat16):
            idx, mask, m, h = segment_inputs(e, dtype, seed=e + 3)
            rows.append(check_scatter_case(idx, mask, m, N, "bench"))
            rows.append(check_gather_case(idx, mask, h, "bench"))
            del idx, mask, m, h
    return rows


def check_entry_segment_kernels(operands: dict) -> list:
    """B8 against its plain versions on the operands the entry point gave
    it, the first call of each (kernel, shape, dtype)."""
    rows = []
    for key in sorted(operands, key=str):
        kind, args = key[0], operands[key]
        if kind == "scatter":
            rows.append(check_scatter_case(*args, "entry point"))
        else:
            rows.append(check_gather_case(*args, "entry point"))
    return rows


@contextlib.contextmanager
def plain_b8():
    """Within the block, SegmentScatter and SegmentGather run B8's plain
    versions on CUDA tensors, forward and backward."""
    from immunostruct_tpu_torch.ops import segment

    saved = segment.segment_scatter, segment.segment_gather
    segment.segment_scatter = segment.segment_scatter_reference
    segment.segment_gather = segment.segment_gather_reference
    try:
        yield
    finally:
        segment.segment_scatter, segment.segment_gather = saved


def check_pallas_layer_grads() -> list:
    """One EGNN layer under 'pallas' (B8's scatter, its gather in the
    backward) against the same layer on B8's plain versions, at B=128,
    E=2560, F=64: outputs and gradients. f32 as the 'fused' layer; bf16 per
    tensor mean|diff| <= 2 * (the plain layer's own run-to-run mean|diff|)
    + GRAD_BF16_MEAN * mean|plain|: the backward of the layer's index_select
    gathers adds in bf16 with atomics, so h's and the edge MLP's gradients
    move from run to run."""
    from immunostruct_tpu_torch.ops.egnn import EGNNLayer, egnn_apply

    rows = []
    for name, dtype in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        gen = torch.Generator().manual_seed(13)
        layer = EGNNLayer(64, H, H, generator=gen, device="cuda")
        src, dst, mask, ef, h, x = kernel_inputs(B, 2560, 64, torch.float32,
                                                 seed=13)[:6]
        cot_h = torch.randn(B, N, H, generator=gen).to("cuda", dtype)
        cot_x = torch.randn(B, N, 3, generator=gen).to("cuda", dtype)

        def run(kernels):
            layer.zero_grad()
            hin = h.to(dtype).requires_grad_(True)
            xin = x.to(dtype).requires_grad_(True)
            before = read_counts()
            with contextlib.nullcontext() if kernels else plain_b8():
                h2, x2 = egnn_apply(layer, hin, xin, src, dst, ef, mask,
                                    "pallas")
                ((h2 * cot_h).float().sum()
                 + (x2 * cot_x).float().sum()).backward()
            torch.cuda.synchronize()
            launched = tuple(a - z for a, z in zip(read_counts(), before))
            assert launched == ((0, 0, 0, 0, 1, 1) + (0,) * 5 if kernels
                                else (0,) * 11), launched
            return [h2.detach(), x2.detach(), hin.grad, xin.grad] + [
                p.grad.clone() for p in layer.parameters()]

        worst, noise_worst = 0.0, 0.0
        for g, w, w2 in zip(run(True), run(False), run(False)):
            assert torch.isfinite(g).all()
            g, w, w2 = g.float(), w.float(), w2.float()
            if dtype == torch.float32:
                allowed = 1e-4 * w.abs().max() + 1e-3 * w.abs()
                worst = max(worst, ((g - w).abs() / allowed).max().item())
            else:
                noise = (w2 - w).abs().mean()
                allowed = 2 * noise + GRAD_BF16_MEAN * w.abs().mean() + 1e-12
                worst = max(worst, ((g - w).abs().mean() / allowed).item())
                noise_worst = max(noise_worst,
                                  (noise / w.abs().mean()).item())
        assert worst <= 1.0, (name, worst)
        row = dict(dtype=name, worst_in_tol=worst,
                   plain_run_to_run_mean_rel=noise_worst,
                   measure=("max |diff|/allowed" if dtype == torch.float32
                            else "max over outputs and gradients of "
                                 "mean|diff| / (2 * plain noise + 1e-4 * "
                                 "mean|plain|)"))
        print("SegmentScatter gradients ('pallas' layer):", json.dumps(row),
              flush=True)
        rows.append(row)
    return rows


def check_pallas_training(mega_rows) -> tuple:
    """The 'pallas' train step: its first step against 'scatter', then
    TRAIN_STEPS steps with 6 B8 scatter + 6 B8 gather launches each, beside
    phase 16's 'mega' and 'scatter' steps."""
    from immunostruct_tpu_torch.data.synthetic import random_sample_batch

    layers = 6
    rows = []
    for e, mega in zip(EDGE_COUNTS, mega_rows):
        batch = random_sample_batch(B, N, e, L, seed=0, device="cuda")
        first = first_step_vs_scatter(batch, "pallas")
        print(f"pallas first step E={e}:", json.dumps(first), flush=True)
        trainer, state = make_trainer("HybridModelv2", "pallas")
        reset_counts()                  # every count to 0: 'pallas' steps
        losses, ms = timed_steps(trainer, state, batch, TRAIN_STEPS)
        counts = read_counts()          # read just after them
        n = layers * TRAIN_STEPS
        assert counts == (0, 0, 0, 0, n, n) + (0,) * 5, counts
        assert all(map(lambda v: v == v and abs(v) < float("inf"), losses))
        assert losses[-1] < losses[0], losses
        del trainer, state
        pallas_ms = statistics.median(ms[3:])
        row = dict(E=e, steps=TRAIN_STEPS,
                   launches_per_step=[c // TRAIN_STEPS for c in counts],
                   loss_first=losses[0], loss_last=losses[-1],
                   median_step_ms_pallas=pallas_ms,
                   pmhc_per_s_pallas=B / (pallas_ms / 1e3),
                   median_step_ms_mega=mega["median_step_ms_mega"],
                   median_step_ms_scatter=mega["median_step_ms_scatter"],
                   **first)
        print("train pallas:", json.dumps(row), flush=True)
        rows.append(row)
    return rows, counts


def check_cancer_entry_point(tmp: str) -> tuple:
    """The fourth slice's main path: the train_Cancer_wFT entry point at
    full width under --aggregation pallas --skip-clinical, on a synthetic IEDB
    corpus and cancer/WT pairs sharing its HLA table. Returns its row and
    B8's operands, the first call of each (kernel, shape, dtype)."""
    from immunostruct_tpu_torch.cli import train_Cancer_wFT as cli
    from immunostruct_tpu_torch.data.synthetic import (
        synthetic_comparative_corpus, synthetic_corpus,
    )
    from immunostruct_tpu_torch.models import build_model
    from immunostruct_tpu_torch.ops import segment
    from immunostruct_tpu_torch.utils.checkpoint import load_checkpoint

    t0 = time.perf_counter()
    root = os.path.join(tmp, "cancer_corpus")
    graph_iedb, props_iedb, hla = synthetic_corpus(
        root, num_samples=CLI_SAMPLES, hla_len=275, seed=3)
    dir_c, dir_w, props_c, props_w, _ = synthetic_comparative_corpus(
        root, num_samples=CANCER_PAIRS, hla_len=275, seed=4,
        shared_hla_path=hla)
    corpus_s = time.perf_counter() - t0
    save_dir = os.path.join(tmp, "cancer_ckpt")
    stages, inferences = [], []
    real_train, real_infer = cli.train_model, cli.inference

    def train_model(config, model, train_pipe, *args, **kw):
        before = read_counts()
        model, history = real_train(config, model, train_pipe, *args, **kw)
        graphs = train_pipe.ds.graphs
        stages.append(dict(stage=kw["stage"], resume_tag=kw.get("resume_tag"),
                           comparative=hasattr(train_pipe, "wt"),
                           steps_per_epoch=len(train_pipe), history=history,
                           launches=[a - z for a, z in zip(read_counts(),
                                                           before)],
                           N=graphs.max_nodes, E=graphs.max_edges))
        return model, history

    def inference(*args, **kw):
        before = read_counts()
        stats = real_infer(*args, **kw)
        inferences.append([a - z for a, z in zip(read_counts(), before)])
        return stats

    # B8's launch helpers keep copies of their first operands of each
    # shape; the wrappers that call them count the launches as before
    operands = {}
    real_scatter, real_gather = segment._scatter_launch, segment._gather_launch

    def keep(kind, args):
        key = (kind, *args[2].shape, args[2].dtype)
        if key not in operands:
            with torch.inference_mode(False):
                operands[key] = tuple(
                    t.detach().clone() if torch.is_tensor(t) else t
                    for t in args)

    def scatter(*args):
        keep("scatter", args)
        return real_scatter(*args)

    def gather(*args):
        keep("gather", args)
        return real_gather(*args)

    cli.train_model, cli.inference = train_model, inference
    segment._scatter_launch, segment._gather_launch = scatter, gather
    try:
        reset_counts()                  # every count to 0: the entry point
        t0 = time.perf_counter()
        train_stats, test_stats = cli.main([
            "--model", "HybridModelv2_Comparative", "--full-sequence",
            "--sequence-loss", "--aggregation", "pallas",
            "--compute-dtype", "bfloat16", "--batch-size", str(B),
            "--num-epochs", str(CLI_EPOCHS), "--coeff-contrastive", "0.1",
            "--skip-clinical", "--device", "cuda", "--seed", "1",
            "--model-save-dir", save_dir,
            "--graph-dir-IEDB", graph_iedb, "--property-path-IEDB",
            props_iedb, "--hla-path", hla, "--graph-dir-cancer", dir_c,
            "--graph-dir-wildtype", dir_w, "--property-path-cancer", props_c,
            "--property-path-wildtype", props_w])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = read_counts()          # read just after the entry point
    finally:
        cli.train_model, cli.inference = real_train, real_infer
        segment._scatter_launch, segment._gather_launch = (real_scatter,
                                                           real_gather)

    assert [(s["stage"], s["comparative"], s["resume_tag"]) for s in stages] \
        == [("pretrain", False, "stage1"), ("pretrain", True, "stage2"),
            ("finetune", True, None)], stages
    assert stages[2]["steps_per_epoch"] == MIN_FINETUNING_BATCHES, stages[2]
    for s in stages:
        h = s["history"]
        assert len(h["train_loss"]) == CLI_EPOCHS, h
        assert all(v == v and abs(v) < float("inf")
                   for v in h["train_loss"] + h["val_loss"]), h
        assert s["launches"][:4] == [0, 0, 0, 0], s
        assert s["launches"][6:] == [0] * 5, s
        assert s["launches"][4] > 0 and s["launches"][5] > 0, s
    assert len(inferences) == 2, inferences
    for launched in inferences:
        assert launched[4] > 0 and launched.count(0) == 10, launched
    assert counts[:4] == (0, 0, 0, 0) and counts[6:] == (0,) * 5, counts
    for stats in (train_stats, test_stats):
        assert len(stats) == METRIC_KEYS, sorted(stats)
    assert test_stats["optimal_threshold"] == \
        train_stats["optimal_threshold"]
    ckpts = sorted(f for f in os.listdir(save_dir) if f.endswith(".ckpt"))
    assert [c.rsplit("_", 1)[1] for c in ckpts] == ["finetune.ckpt",
                                                     "pretrain.ckpt"], ckpts
    for c in ckpts:
        path = os.path.join(save_dir, c)
        with np.load(path) as z:        # the VAE's width: the corpus's L*21
            vae_dim = z["['vae']['fc1']['w']"].shape[0]
        _, fresh = build_model("HybridModelv2_Comparative", vae_dim,
                               torch.Generator().manual_seed(0),
                               use_wt_for_downstream=False, device="cuda")
        load_checkpoint(path, fresh, verbose=False)
    epochs = []
    for s, label in zip(stages, ("stage 1", "stage 2", "stage 3")):
        h = s["history"]
        per = 2 if s["comparative"] else 1      # pMHCs per sample (twins)
        for i, (dt, n) in enumerate(zip(h["epoch_time"],
                                        h["train_samples"])):
            epochs.append(dict(stage=label, epoch=i + 1, epoch_s=dt,
                               steps=s["steps_per_epoch"], train_samples=n,
                               samples_per_s=n / dt, pmhc_per_s=per * n / dt,
                               train_loss=h["train_loss"][i],
                               val_loss=h["val_loss"][i]))
    assert stages[1]["N"] == N and stages[1]["E"] % 128 == 0, stages[1]
    row = dict(save_dir=save_dir, infer_args=[
                   "--graph-dir-cancer", dir_c, "--graph-dir-wildtype", dir_w,
                   "--property-path-cancer", props_c,
                   "--property-path-wildtype", props_w, "--hla-path", hla],
               iedb_samples=CLI_SAMPLES, pairs=CANCER_PAIRS,
               N=stages[1]["N"], E_iedb=stages[0]["E"], E_cancer=stages[1]["E"],
               corpus_s=corpus_s, wall_s=wall_s, launches=counts,
               launches_by_stage=[s["launches"] for s in stages],
               launches_inference=inferences,
               b8_shapes=sorted([k[0], *k[1:4]] for k in operands),
               epochs=epochs, train_roc_auc=train_stats["roc_auc"],
               test_roc_auc=test_stats["roc_auc"],
               threshold=train_stats["optimal_threshold"])
    print("entry point (Cancer):", json.dumps(row), flush=True)
    return row, operands


# --------------------------------------------------------------------------
# the 'mega' kernel variants: B4, B5a, B5b, B6, and the race
# --------------------------------------------------------------------------

DTYPES = (("float32", torch.float32), ("bfloat16", torch.bfloat16))
# per train step of six layers, by the race's variant names
VARIANT_LAUNCHES = {
    "diff16": {"B1": 6, "B2": 6}, "dboth": {"B1": 6, "B5a": 6},
    "inkernel": {"B1": 6, "B5b": 6}, "paired": {"B4": 6, "B2": 6},
    "stack": {"B6": 1, "B2": 6}, "fused": {"B3_fwd": 6, "B3_bwd": 6},
}
RACE_WINDOWS, RACE_STEPS, RACE_BURNIN = 2, 5, 3
# B6, bf16, each layer run from the kernel's own previous h and x: aggs
# (rounded to bf16 on both sides) per column max|diff| <= one bf16 step at
# the column's largest |plain| and mean|diff| <= BF16_COL_MEAN * mean|plain|,
# a1s/xds as B1's residuals, hs/xs per column mean|diff| <= BF16_COL_MEAN *
# mean|plain|; f32 as F32_TOL.
# tests/test_torch_port_cuda.py builds B6 mutant kernels, each without one
# rounding point, that fail them.


def paired_inputs(e: int, f: int, dtype, seed: int):
    """kernel_inputs on the mirror-paired layout: the arc half's indices
    (arcs at -1 and N among them, self-loops) and mask, mirrored."""
    src, dst, mask, *rest = kernel_inputs(B, e, f, dtype, seed)
    half = e // 2
    s0, d0, m0 = (t[:, :half].clone() for t in (src, dst, mask))
    s0[:, 8:12] = -1
    d0[:, 12:16] = N
    return (torch.cat([s0, d0], 1), torch.cat([d0, s0], 1),
            torch.cat([m0, m0], 1), *rest)


def check_paired_kernel() -> list:
    """B4 against its plain version on paired batches, timed beside it and
    beside B1 on the same batch (whose residuals it should equal)."""
    from immunostruct_tpu_torch.ops.mega import (
        check_paired, edge_mega_fwd, edge_mega_paired_fwd,
        edge_mega_paired_fwd_reference, mirror_edges, valid_edges,
    )

    rows = []
    for e in EDGE_COUNTS:
        for f in (20, 64):
            for name, dtype in DTYPES:
                args = paired_inputs(e, f, dtype, seed=e + f + 2)
                check_paired(*args[:3])
                out, a1, xd = edge_mega_paired_fwd(*args)
                torch.cuda.synchronize()
                ref, a1_ref, xd_ref = edge_mega_paired_fwd_reference(*args)
                err, rel, tol = fwd_errors(out, ref, dtype)
                res_err = residual_errors((a1, xd), (a1_ref, xd_ref), dtype)
                assert res_err <= 1.0, res_err
                _, a1_b1, xd_b1 = edge_mega_fwd(*args)
                same = torch.equal(a1, a1_b1) and torch.equal(xd, xd_b1)
                ms, plain_ms = alternate_ms(
                    lambda: edge_mega_paired_fwd_reference(*args),
                    lambda: edge_mega_paired_fwd(*args))
                b1_ms = cuda_ms(lambda: edge_mega_fwd(*args))
                bare_ms = cuda_ms(lambda: edge_mega_paired_fwd(
                    *args, residuals=False))
                valid = valid_edges(*mirror_edges(*args[:3]), N).sum().item()
                flops = 2 * B * N * f * 2 * H + 2 * valid * 2 * H * H
                # the arc half of src, dst and mask is read
                nbytes = (tensor_bytes(*args[3:], out, a1, xd)
                          + tensor_bytes(*args[:3]) // 2)
                row = dict(E=e, F=f, dtype=name, max_abs_err=err,
                           **bound(nbytes, flops, dtype), **rel,
                           tolerance=tol, residual_err_in_tol=res_err,
                           residuals_equal_b1=same, ms=ms,
                           ms_without_residuals=bare_ms, plain_ms=plain_ms,
                           b1_ms_same_batch=b1_ms)
                print("kernel B4:", json.dumps(row), flush=True)
                rows.append(row)
                del args, out, ref, a1, xd, a1_ref, xd_ref, a1_b1, xd_b1
    return rows


def tail_g_inputs(e: int, f: int, dtype, seed: int, b: int = B):
    """B5's operands: B1's residuals on seeded inputs (indices at -1 and N
    on a few edges), a seeded node cotangent g [B, N, H+3] in the compute
    dtype: (src, dst, valid, ef, w2, wc1, small, a1, xd, g)."""
    from immunostruct_tpu_torch.ops.mega import edge_mega_fwd, valid_edges

    args = list(kernel_inputs(b, e, f, dtype, seed))
    args[0][:, 8:12] = -1
    args[1][:, 12:16] = N
    src, dst, mask, ef = args[:4]
    _, a1, xd = edge_mega_fwd(*args, residuals=True)
    g = torch.randn(b, N, H + 3, generator=torch.Generator().manual_seed(seed))
    return (src, dst, valid_edges(src, dst, mask, N), ef, *args[7:], a1, xd,
            g.to("cuda", dtype))


def b2_operands(src, dst, valid, ef, w2, wc1, small, a1, xd, g):
    """B2's operands from B5's, d_both = g[dst] gathered as 'hybrid' does."""
    from immunostruct_tpu_torch.ops.mega import _gather_rows

    d_both = _gather_rows(g, dst, valid).transpose(1, 2).contiguous()
    return ef, w2, wc1, small, a1, xd, d_both, valid


def check_tail_db_kernel() -> list:
    """B5a against its plain version and against B2 on the same inputs."""
    from immunostruct_tpu_torch.ops.mega import (
        tail_bwd, tail_bwd_db, tail_bwd_db_reference,
    )

    rows = []
    for b, e, f, name, dtype in TAIL_CASES:
        args = tail_g_inputs(e, f, dtype, seed=e + f + 3, b=b)
        db = args[1:]
        out = tail_bwd_db(*db)
        torch.cuda.synchronize()
        stats = tail_errors(out, tail_bwd_db_reference(*db), dtype)
        b2_args = b2_operands(*args)
        b2 = tail_bwd(*b2_args)
        equal_b2 = all(torch.equal(g, h) for g, h in zip(out, b2))
        again = tail_bwd_db(*db)
        assert all(torch.equal(g, h) for g, h in zip(out, again)), \
            "B5a changed from one run to the next"
        ms, plain_ms = alternate_ms(
            lambda: tail_bwd_db_reference(*db),
            lambda: tail_bwd_db(*db))
        b2_ms = cuda_ms(lambda: tail_bwd(*b2_args))
        gather_b2_ms = cuda_ms(lambda: tail_bwd(*b2_operands(*args)))
        valid = args[2].sum().item()
        work = bound(tensor_bytes(*db, *out),
                     2 * valid * 6 * H * H, dtype)
        row = dict(B=b, E=e, F=f, dtype=name, **stats, **work,
                   smem_per_cta=tail_smem("egnn_tail_bwd_db", dtype),
                   equals_b2_bit_for_bit=equal_b2, ms=ms,
                   plain_ms=plain_ms, b2_ms=b2_ms,
                   gather_and_b2_ms=gather_b2_ms)
        print("kernel B5a:", json.dumps(row), flush=True)
        rows.append(row)
        del args, db, out, b2, b2_args, again
    return rows


def nodes_errors(got, ref, dtype) -> dict:
    """B5b's d_nodes [B, N, 2(H+3)] f32 against its plain version, per
    column over graphs and nodes: f32 |diff| <= 1e-5 * max|plain| + 1e-4 *
    |plain|; bf16 B2's d_cat bounds (TAIL_MAX_EDGE, TAIL_MEAN)."""
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    g, r = got.flatten(0, 1).T, ref.flatten(0, 1).T
    if dtype == torch.float32:
        assert ((g - r).abs() <= 1e-5 * r.abs().amax(1, keepdim=True)
                + 1e-4 * r.abs()).all()
        return dict(d_nodes_max_abs_err=(g - r).abs().max().item())
    stats = rel_stats(g, r)
    assert stats["max_rel"] <= TAIL_MAX_EDGE, stats
    assert stats["mean_rel"] <= TAIL_MEAN, stats
    return dict(d_nodes=stats, d_nodes_max_abs_err=(g - r).abs().max().item())


def check_tail_nodes_kernel() -> list:
    """B5b against its plain version, the same bits twice, and timed beside
    what it replaces on the 'hybrid' path (the gather, B2, two
    scatter_add_)."""
    from immunostruct_tpu_torch.ops.mega import (
        tail_bwd, tail_bwd_nodes, tail_bwd_nodes_reference,
    )

    def hybrid_glue(src, dst, valid, ef, w2, wc1, small, a1, xd, g):
        d_cat = tail_bwd(*b2_operands(src, dst, valid, ef, w2, wc1, small,
                                      a1, xd, g))[0]
        dcf = d_cat.transpose(1, 2).float()
        for idx in (src, dst):
            i = torch.where(valid, idx, 0).long()[..., None].expand(
                -1, -1, H + 3)
            torch.zeros(src.shape[0], N, H + 3,
                        device="cuda").scatter_add_(1, i, dcf)

    rows = []
    for b, e, f, name, dtype in TAIL_CASES:
        args = tail_g_inputs(e, f, dtype, seed=e + f + 4, b=b)
        out = tail_bwd_nodes(*args)
        torch.cuda.synchronize()
        ref = tail_bwd_nodes_reference(*args)
        stats = nodes_errors(out[0], ref[0], dtype)
        zeros = torch.zeros(1, 1, 1, dtype=dtype, device="cuda")
        stats.update(tail_errors((zeros, *out[1:]),
                                 (zeros, *ref[1:]), dtype))
        stats["max_abs_err"] = max(stats["max_abs_err"],
                                   stats["d_nodes_max_abs_err"])
        again = tail_bwd_nodes(*args)
        assert all(torch.equal(g, h) for g, h in zip(out, again)), \
            "B5b changed from one run to the next"
        ms, plain_ms = alternate_ms(
            lambda: tail_bwd_nodes_reference(*args),
            lambda: tail_bwd_nodes(*args))
        glue_ms = cuda_ms(lambda: hybrid_glue(*args))
        valid = args[2].sum().item()
        work = bound(tensor_bytes(*args, *out),
                     2 * valid * 6 * H * H, dtype)
        row = dict(B=b, E=e, F=f, dtype=name, **stats, **work, ms=ms,
                   smem_per_cta=tail_smem("egnn_tail_bwd_nodes", dtype),
                   plain_ms=plain_ms,
                   gather_b2_scatter_adds_ms=glue_ms)
        print("kernel B5b:", json.dumps(row), flush=True)
        rows.append(row)
        del args, out, ref, again
    return rows


def stack_inputs(e: int, dtype, seed: int):
    """B6's operands: HybridModelv2's six conv layers (F0=20, H=64) with
    seeded weights, and kernel_inputs at F=20 with indices at -1 and N on a
    few edges: ([src, dst, mask, ef, h0, x0], the layers' packed weights)."""
    from immunostruct_tpu_torch.ops.egnn import egnn_stack
    from immunostruct_tpu_torch.ops.stack import pack_layer

    args = list(kernel_inputs(B, e, 20, dtype, seed)[:6])
    args[0][:, 8:12] = -1
    args[1][:, 12:16] = N
    layers = egnn_stack(5, 20, H, generator=torch.Generator().manual_seed(
        seed), device="cuda")
    return args, [tuple(t.detach() for t in pack_layer(p)) for p in layers]


def stack_layer_errors(out, args, packed, dtype) -> dict:
    """Each layer of B6 against the plain version of that layer run from
    the kernel's own previous h and x (so that a flipped rounding does not
    carry into the next layer's check); asserts the bounds above."""
    from immunostruct_tpu_torch.ops.stack import stack_fwd_reference

    h, x, hs, xs, aggs, a1s, xds = out
    assert torch.equal(h, hs[:, -1]) and torch.equal(x, xs[:, -1])
    src, dst, mask, ef, h0, x0 = args
    worst = dict(max_abs_err=0.0, residual_err_in_tol=0.0,
                 agg_col_max_in_steps=0.0, agg_col_mean_rel=0.0,
                 hx_col_mean_rel=0.0)
    for layer, weights in enumerate(packed):
        h_in = h0 if layer == 0 else hs[:, layer - 1]
        x_in = x0 if layer == 0 else xs[:, layer - 1]
        ref = stack_fwd_reference(src, dst, mask, ef, h_in, x_in, [weights])
        got = [t[:, layer] for t in (hs, xs, aggs, a1s, xds)]
        want = [t[:, 0] for t in ref[2:]]
        assert all(torch.isfinite(g).all() for g in got)
        worst["max_abs_err"] = max(worst["max_abs_err"], *(
            (g.float() - w.float()).abs().max().item()
            for g, w in zip(got, want)))
        worst["residual_err_in_tol"] = max(
            worst["residual_err_in_tol"],
            residual_errors(got[3:], want[3:], dtype))
        if dtype == torch.float32:
            for g, w in zip(got[:3], want[:3]):
                torch.testing.assert_close(g, w, **F32_TOL)
            continue
        g, w = got[2].float().flatten(0, 1), want[2].float().flatten(0, 1)
        top = w.abs().amax(0).clamp_min(torch.finfo(torch.float32).tiny)
        steps = (g - w).abs().amax(0) / torch.exp2(
            torch.floor(torch.log2(top)) - 7)
        worst["agg_col_max_in_steps"] = max(worst["agg_col_max_in_steps"],
                                            steps.max().item())
        worst["agg_col_mean_rel"] = max(
            worst["agg_col_mean_rel"],
            bf16_errors(got[2].float(), want[2].float())["col_mean_rel"])
        for g, w in zip(got[:2], want[:2]):
            worst["hx_col_mean_rel"] = max(
                worst["hx_col_mean_rel"],
                bf16_errors(g.float(), w.float())["col_mean_rel"])
    assert worst["residual_err_in_tol"] <= 1.0, worst
    if dtype == torch.bfloat16:
        assert worst["agg_col_max_in_steps"] <= 1.0, worst
        assert worst["agg_col_mean_rel"] <= BF16_COL_MEAN, worst
        assert worst["hx_col_mean_rel"] <= BF16_COL_MEAN, worst
    return worst


def check_stack_kernel() -> list:
    """B6 against its plain version, layer by layer, timed beside it and
    beside the per-layer path's forward with no gradient."""
    from immunostruct_tpu_torch.ops.egnn import egnn_stack
    from immunostruct_tpu_torch.ops.mega import valid_edges
    from immunostruct_tpu_torch.ops.stack import (
        stack_fwd, stack_fwd_reference,
    )

    rows = []
    for e in EDGE_COUNTS:
        for name, dtype in DTYPES:
            args, packed = stack_inputs(e, dtype, seed=e + 6)
            out = stack_fwd(*args, packed)
            torch.cuda.synchronize()
            stats = stack_layer_errors(out, args, packed, dtype)
            ms, plain_ms = alternate_ms(
                lambda: stack_fwd_reference(*args, packed),
                lambda: stack_fwd(*args, packed))
            bare_ms = cuda_ms(lambda: stack_fwd(*args, packed,
                                                residuals=False))
            layers = egnn_stack(5, 20, H, generator=torch.Generator()
                                .manual_seed(e + 6), device="cuda")

            def per_layer():
                from immunostruct_tpu_torch.ops.egnn import egnn_stack_apply

                with torch.no_grad():
                    egnn_stack_apply(layers, args[4], args[5], *args[:2],
                                     args[3], args[2], "mega")

            hybrid_ms = cuda_ms(per_layer)
            valid = valid_edges(*args[:3], N).sum().item()
            flops = 0
            for weights in packed:
                f = weights[0].shape[0] // 2
                flops += (2 * B * N * f * 2 * H + 2 * valid * 2 * H * H
                          + 2 * B * N * (f + H) * H + 2 * B * N * H * H)
            work = bound(tensor_bytes(*args, *(t for w in packed for t in w),
                                      *out), flops, dtype)
            row = dict(E=e, F="20, then 64", dtype=name, **stats, **work,
                       ms=ms, ms_without_residuals=bare_ms, plain_ms=plain_ms,
                       per_layer_forward_no_grad_ms=hybrid_ms)
            print("kernel B6:", json.dumps(row), flush=True)
            rows.append(row)
            del args, packed, out, layers
    return rows


def check_variant_first_steps() -> list:
    """Each variant's first full-width HybridModelv2 step (bf16) against
    'scatter' on a mirror-paired batch, as phase 16 holds 'mega''s."""
    from immunostruct_tpu_torch.data.synthetic import build_batch

    rows = []
    for e in EDGE_COUNTS:
        batch = build_batch(B, N, e, L, paired=True, device="cuda")
        for v in ("dboth", "inkernel", "paired", "stack"):
            first = first_step_vs_scatter(batch, "mega", v)
            row = dict(E=e, variant=v, **first)
            print("variant first step:", json.dumps(row), flush=True)
            rows.append(row)
    return rows


def check_race() -> tuple:
    """This slice's main path: cli.race_kernel_variants in-process at B=128,
    E=2560 and 1408, --paired-batch, all six variants. Each variant's
    launches per step are the ones VARIANT_LAUNCHES names, and its loss
    falls."""
    from immunostruct_tpu_torch.cli import race_kernel_variants as race

    rows = []
    total = (0,) * 11
    for e in EDGE_COUNTS:
        reset_counts()                  # every count to 0: the race starts
        out = race.main(["--edges", str(e), "--batch", str(B),
                         "--paired-batch", "--windows", str(RACE_WINDOWS),
                         "--steps", str(RACE_STEPS), "--burnin",
                         str(RACE_BURNIN), "--device", "cuda"])
        counts = read_counts()          # read just after it
        total = tuple(a + c for a, c in zip(total, counts))
        assert list(out) == list(VARIANT_LAUNCHES), list(out)
        for v, r in out.items():
            assert r["launches_per_step"] == VARIANT_LAUNCHES[v], (v, r)
            assert all(t == t and abs(t) < float("inf")
                       for t in (r["loss0"], r["min_loss"],
                                 *r["windows_loss"])), (v, r)
            # the loss falls: on one fixed batch every variant's loss, the
            # 'fused' control's too, spikes now and then and recovers
            assert r["min_loss"] < r["loss0"], (v, r)
        rows.append(dict(E=e, launches=counts, race=out))
        print(f"race E={e}:", json.dumps(rows[-1]), flush=True)
    # the path's kernels: every one but B8's ran
    assert all(total[i] > 0 for i in (0, 1, 2, 3, 6, 7, 8, 9)), total
    return rows, total


def check_variant_serving(scorer) -> list:
    """One B=128 forward with no gradient under 'stack' and 'paired' (the
    served model, a mirror-paired batch at E=2560): probabilities within
    PROB_ATOL of 'scatter', the variant's kernel alone launched."""
    from immunostruct_tpu_torch.data.synthetic import build_batch
    from immunostruct_tpu_torch.models.trunk import model_apply

    batch = build_batch(B, N, EDGE_COUNTS[0], L, paired=True, device="cuda")

    def probs(aggregation, variant):
        with torch.inference_mode():
            out = model_apply(scorer.model, batch.graph, batch.seq_onehot,
                              batch.props, generator=scorer.generator(),
                              deterministic=True, aggregation=aggregation,
                              compute_dtype=scorer.compute_dtype,
                              mega_variant=variant)
            return torch.sigmoid(out.logits.reshape(-1)).double().cpu()

    def forward_ms(aggregation, variant):
        walls = []
        for _ in range(6):
            t0 = time.perf_counter()
            probs(aggregation, variant)     # ends in a copy to the host
            walls.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(walls[1:])

    want = probs("scatter", "hybrid")
    rows = []
    for variant, kernel in (("stack", 9), ("paired", 6)):
        before = read_counts()
        got = probs("mega", variant)
        launched = tuple(a - z for a, z in zip(read_counts(), before))
        layers = 1 if variant == "stack" else 6
        assert launched == tuple(layers if i == kernel else 0
                                 for i in range(11)), (variant, launched)
        err = (got - want).abs().max().item()
        assert torch.isfinite(got).all() and err <= PROB_ATOL, (variant, err)
        row = dict(variant=variant, launches=launched,
                   max_abs_prob_err_vs_scatter=err,
                   median_forward_ms=forward_ms("mega", variant),
                   median_forward_ms_hybrid=forward_ms("mega", "hybrid"))
        print("served variant:", json.dumps(row), flush=True)
        rows.append(row)
    return rows


# --------------------------------------------------------------------------
# the forward-only paths: B7, 'onehot'/'onehot_remat', batch inference
# --------------------------------------------------------------------------

def b7_inputs(b: int, e: int, f: int, dtype, seed: int):
    """B7's operands at the main path's shapes: a seeded EGNN layer (H=64)
    and seeded inputs with 10% of the edges masked, self-loops, and
    unmasked edges whose src or dst is -1 or N."""
    from immunostruct_tpu_torch.ops.egnn import EGNNLayer

    src, dst, mask, _, h, x = kernel_inputs(b, e, f, dtype, seed)[:6]
    src[:, 8:10], src[:, 10:12] = -1, N
    dst[:, 12:14], dst[:, 14:16] = -1, N
    mask[:, 8:16] = True
    layer = EGNNLayer(f, H, H, generator=torch.Generator().manual_seed(seed),
                      device="cuda")
    return layer, (h, x, src, dst, mask)


def b7_errors(out, ref, dtype) -> dict:
    """h' and x' against the plain version: f32 within F32_TOL; bf16 per
    column (over graphs and nodes) max|diff| within one bf16 step at the
    column's largest |plain| (phase 14's form: one flipped rounding at a
    value just above a power of two is up to 2^-7 of it, over
    BF16_COL_MAX) and mean|diff| <= BF16_COL_MEAN * mean|plain|. The card
    tests' ten mutant kernels, each without one of B7's rounding points,
    fail these bounds (tests/test_torch_port_cuda.py)."""
    row = dict(max_abs_err=max((o.float() - r.float()).abs().max().item()
                               for o, r in zip(out, ref)))
    for name, o, r in zip(("h", "x"), out, ref):
        assert o.dtype == r.dtype and o.shape == r.shape, name
        assert torch.isfinite(o).all(), name
        if dtype == torch.float32:
            torch.testing.assert_close(o, r, **F32_TOL)
            continue
        g, w = o.float().flatten(0, 1), r.float().flatten(0, 1)
        diff, mag = (g - w).abs(), w.abs()
        top = mag.amax(0).clamp_min(torch.finfo(torch.float32).tiny)
        steps = (diff.amax(0) / torch.exp2(torch.floor(torch.log2(top))
                                           - 7)).max().item()
        rel = bf16_errors(o, r)
        assert steps <= 1.0, (name, steps)
        assert rel["col_mean_rel"] <= BF16_COL_MEAN, (name, rel)
        row.update({f"{name}_{k}": v for k, v in rel.items()},
                   **{f"{name}_col_max_steps": steps})
    return row


def check_b7_kernel() -> list:
    """B7-check: B7 against its plain version at phase 4's shapes, the same
    bits twice, kernel, plain and bound times."""
    from immunostruct_tpu_torch.ops.fused_layer import (
        _lib, fused_egnn_layer, fused_egnn_layer_reference,
    )

    rows = []
    with torch.no_grad():
        for e in EDGE_COUNTS:
            for f in (20, 64):
                for name, dtype in DTYPES:
                    layer, args = b7_inputs(B, e, f, dtype, seed=e + f + 7)
                    out = fused_egnn_layer(layer, *args)
                    again = fused_egnn_layer(layer, *args)
                    torch.cuda.synchronize()
                    assert all(torch.equal(a, z) for a, z in zip(out, again))
                    ref = fused_egnn_layer_reference(layer, *args)
                    err = b7_errors(out, ref, dtype)
                    ms, plain_ms = alternate_ms(
                        lambda: fused_egnn_layer_reference(layer, *args),
                        lambda: fused_egnn_layer(layer, *args))
                    h, x, src, dst, mask = args
                    summed = (mask & (dst >= 0) & (dst < N)).sum().item()
                    # the products this run's edges need (those summed at a
                    # dst: the others touch no output), then the node MLP
                    flops = (2 * summed * (2 * f * H + 2 * H * H + H)
                             + 2 * B * N * ((f + H) * H + H * H))
                    weights = _lib().egnn_layer_fwd_weight_count(f, H)
                    nbytes = (tensor_bytes(h, x, src, dst, mask, *out)
                              + weights * h.element_size())
                    row = dict(E=e, F=f, dtype=name, **err,
                               **bound(nbytes, flops, dtype), same_bits=True,
                               edges_summed=summed, ms=ms,
                               plain_ms=plain_ms)
                    print("kernel B7:", json.dumps(row), flush=True)
                    rows.append(row)
                    del layer, args, out, again, ref
    return rows


def fused_stack_scorer(scorer):
    """The served model of phase 15 behind a Scorer with fused_stack."""
    from immunostruct_tpu_torch.serving import Scorer

    return Scorer(scorer.model, device=scorer.device,
                  compute_dtype=scorer.compute_dtype, aggregation="auto",
                  seed=scorer.seed, fused_stack=True)


def check_onehot_training() -> list:
    """The first full-width train step under 'onehot' and 'onehot_remat'
    against 'scatter' (phase 16's bounds) at E=2560, and the peak device
    memory of one step under each and under 'mega'."""
    from immunostruct_tpu_torch.data.synthetic import random_sample_batch

    batch = random_sample_batch(B, N, EDGE_COUNTS[0], L, seed=0,
                                device="cuda")
    row = dict(E=EDGE_COUNTS[0])
    for agg in ("onehot", "onehot_remat"):
        first = first_step_vs_scatter(batch, agg)
        row[agg] = first
        print(f"{agg} first step E={EDGE_COUNTS[0]}:", json.dumps(first),
              flush=True)
    peak = {}
    for agg in ("onehot", "onehot_remat", "mega"):
        trainer, state = make_trainer("HybridModelv2", agg)
        trainer.train_step(state, batch, seed=0)    # optimizer state made
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = read_counts()
        t0 = time.perf_counter()
        trainer.train_step(state, batch, seed=0)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        launched = tuple(a - z for a, z in zip(read_counts(), before))
        want = (6, 6) + (0,) * 9 if agg == "mega" else (0,) * 11
        assert launched == want, (agg, launched)
        peak[agg] = dict(max_memory_allocated_bytes=
                         torch.cuda.max_memory_allocated(), step_ms=step_ms)
        del trainer, state
    assert (peak["onehot_remat"]["max_memory_allocated_bytes"]
            < peak["onehot"]["max_memory_allocated_bytes"]), peak
    row["peak_memory"] = peak
    print("onehot training:", json.dumps(row), flush=True)
    return row


def check_batch_inference(entry: dict, cancer: dict, tmp: str) -> dict:
    """cli.infer_IEDB_or_Cancer in-process on phase 19's finetune
    checkpoint, under --aggregation auto (6 B1 launches per batch) and
    onehot (no kernel): 51 test rows of three columns each, the same rows
    and labels, probabilities within PROB_ATOL of each other; then
    --comparative on phase 21's checkpoint."""
    from immunostruct_tpu_torch.cli import infer_IEDB_or_Cancer as cli

    def finetune(save_dir):
        return os.path.join(save_dir, next(
            f for f in sorted(os.listdir(save_dir))
            if f.endswith("_finetune.ckpt")))

    def run(args, aggregation, out):
        reset_counts()                  # every count to 0: inference starts
        t0 = time.perf_counter()
        stats = cli.main(args + ["--aggregation", aggregation, "--output",
                                 out, "--compute-dtype", "bfloat16",
                                 "--batch-size", str(B), "--device", "cuda",
                                 "--seed", "1", "--full-sequence"])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = read_counts()          # read just after it
        with open(out) as fh:
            rows = [line.rstrip("\n").split("\t") for line in fh]
        assert all(len(r) == 3 for r in rows), rows[:2]
        probs = np.array([float(r[0]) for r in rows])
        assert np.isfinite(probs).all() and ((probs > 0) & (probs < 1)).all()
        assert len(stats["predicted_probs"]) == len(rows)
        return rows, probs, counts, wall_s

    out = {}
    for label, args, model in (
            ("IEDB", entry["infer_args"], "HybridModelv2"),
            ("comparative", cancer["infer_args"] + ["--comparative"],
             "HybridModelv2_Comparative")):
        args = ["--model", model, "--checkpoint",
                finetune(entry["save_dir"] if label == "IEDB"
                         else cancer["save_dir"])] + args
        auto = run(args, "auto", os.path.join(tmp, f"preds_{label}_auto.txt"))
        onehot = run(args, "onehot",
                     os.path.join(tmp, f"preds_{label}_onehot.txt"))
        batches = -(-len(auto[0]) // B)
        per = 12 if label == "comparative" else 6     # twins: two passes
        assert auto[2] == (per * batches,) + (0,) * 10, auto[2]
        assert onehot[2] == (0,) * 11, onehot[2]
        assert [r[1:] for r in auto[0]] == [r[1:] for r in onehot[0]]
        err = float(np.abs(auto[1] - onehot[1]).max())
        assert err <= PROB_ATOL, (label, err)
        if label == "IEDB":
            assert len(auto[0]) == int(CLI_SAMPLES * 0.1), len(auto[0])
        row = dict(rows=len(auto[0]), batches=batches,
                   launches_auto=auto[2], launches_onehot=onehot[2],
                   max_abs_prob_diff=err, wall_s_auto=auto[3],
                   wall_s_onehot=onehot[3])
        print(f"batch inference ({label}):", json.dumps(row), flush=True)
        out[label] = row
    return out


def check_paired_no_sync(scorer) -> dict:
    """Phase 24's 'paired' forward and one 'paired' train step under
    torch.cuda.set_sync_debug_mode('error'): neither waits for the
    device."""
    from immunostruct_tpu_torch.data.synthetic import build_batch
    from immunostruct_tpu_torch.models.trunk import model_apply

    batch = build_batch(B, N, EDGE_COUNTS[0], L, paired=True, device="cuda")
    trainer, state = make_trainer("HybridModelv2", "mega",
                                  mega_variant="paired")
    trainer.train_step(state, batch, seed=0)
    gen = scorer.generator()
    torch.cuda.synchronize()
    before = read_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode():
            out = model_apply(scorer.model, batch.graph, batch.seq_onehot,
                              batch.props, generator=gen, deterministic=True,
                              aggregation="mega",
                              compute_dtype=scorer.compute_dtype,
                              mega_variant="paired")
        state, loss = trainer.train_step(state, batch, seed=0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launched = tuple(a - z for a, z in zip(read_counts(), before))
    assert launched[6] == 12 and launched[1] == 6, launched   # B4, B2
    assert torch.isfinite(out.logits).all() and torch.isfinite(loss)
    row = dict(launches=launched, loss=float(loss))
    print("paired without a host sync:", json.dumps(row), flush=True)
    return row


def device_profile(fn, traced: int) -> dict:
    """``traced`` calls of ``fn`` under torch.profiler: device time per call
    by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(traced):
            fn()
        torch.cuda.synchronize()
    per_name = {}
    for ev in prof.events():
        # user annotations (e.g. Optimizer.step) span device work that the
        # kernels' own events already count
        if (ev.device_type != torch.autograd.DeviceType.CUDA
                or getattr(ev, "is_user_annotation", False)):
            continue
        us = ev.time_range.end - ev.time_range.start
        tot, cnt = per_name.get(ev.name, (0.0, 0))
        per_name[ev.name] = (tot + us, cnt + 1)
    assert per_name, "torch.profiler recorded no device activity"
    return per_name


def profile_row(label, agg, per_name, traced, wall) -> dict:
    busy_ms = sum(t for t, _ in per_name.values()) / 1e3 / traced
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:5]

    def kernel_ms(tag, also=""):
        return sum(t for name, (t, _) in per_name.items()
                   if tag in name and also in name) / 1e3 / traced

    row = dict(
        work=label, aggregation=agg, wall_ms_median=wall,
        device_busy_ms=busy_ms,
        device_ops_per_call=sum(c for _, c in per_name.values()) / traced,
        idle_share=max(0.0, 1.0 - busy_ms / wall),
        # B1: its f32 kernel, or the bf16 form's projections and edge
        # kernel; the chunk sums (B1 at small B, B5b) are chunk_sum_ms
        b1_ms=kernel_ms("egnn_mega_fwd") + kernel_ms("egnn_mega_proj"),
        b2_ms=kernel_ms("tail_bwd", ", 0>("),
        b3_fwd_ms=kernel_ms("egnn_edge_fwd"),
        b3_bwd_ms=kernel_ms("egnn_edge_bwd"),
        b8_scatter_ms=kernel_ms("segment_scatter_kernel"),
        b8_gather_ms=kernel_ms("segment_gather_kernel"),
        b4_ms=kernel_ms("egnn_mega_paired_fwd_kernel"),
        b5a_ms=kernel_ms("tail_bwd", ", 1>("),
        b5b_ms=kernel_ms("tail_bwd", ", 2>("),
        chunk_sum_ms=kernel_ms("reduce_node_chunks"),
        b6_ms=kernel_ms("egnn_stack_fwd_kernel"),
        b7_ms=kernel_ms("egnn_layer_fwd_kernel"),
        top=[[name[:90], t / 1e3 / traced, c // traced]
             for name, (t, c) in top])
    print("profile:", json.dumps(row), flush=True)
    return row


def profile_forwards(scorer, requests, traced: int = 3) -> list:
    """Per request shape and forward ('mega', 'scatter', and 'auto' with
    fused_stack, B7): median wall time of 10 untraced forwards, then
    ``traced`` forwards under torch.profiler."""
    from immunostruct_tpu_torch.serving import request_to_args

    rows = []
    for label, _, path in requests:
        args = request_to_args(path, scorer.device, scorer.model)
        for agg in ("mega", "scatter", "fused_stack"):
            scorer.fused_stack = agg == "fused_stack"
            scorer.aggregation = "auto" if scorer.fused_stack else agg
            for _ in range(3):
                scorer(*args)
            walls = []
            for _ in range(10):
                t0 = time.perf_counter()
                scorer(*args)           # ends in a copy to the host
                walls.append((time.perf_counter() - t0) * 1e3)
            per_name = device_profile(lambda: scorer(*args), traced)
            rows.append(profile_row(f"forward {label}", agg, per_name,
                                    traced, statistics.median(walls)))
    scorer.aggregation, scorer.fused_stack = "mega", False
    return rows


def profile_training(traced: int = 3) -> list:
    """Train steps at B=128, E=2560 under 'mega', 'scatter', 'fused',
    'pallas' and 'mega' with mega_variant 'stack', 'inkernel' and 'paired'
    (those three on build_batch's mirror-paired batch): median wall of 8 untraced steps
    (after 3), then ``traced`` steps traced."""
    from immunostruct_tpu_torch.data.synthetic import (
        build_batch, random_sample_batch,
    )

    batch = random_sample_batch(B, N, EDGE_COUNTS[0], L, seed=0,
                                device="cuda")
    paired = build_batch(B, N, EDGE_COUNTS[0], L, paired=True, device="cuda")
    rows = []
    for agg, variant, data in (("mega", "hybrid", batch),
                               ("scatter", "hybrid", batch),
                               ("fused", "hybrid", batch),
                               ("pallas", "hybrid", batch),
                               ("mega", "stack", paired),
                               ("mega", "inkernel", paired),
                               ("mega", "paired", paired)):
        trainer, state = make_trainer("HybridModelv2", agg,
                                      mega_variant=variant)
        _, ms = timed_steps(trainer, state, data, 11)

        def step():
            trainer.train_step(state, data, seed=0)

        per_name = device_profile(step, traced)
        label = agg if variant == "hybrid" else f"{agg} / {variant}"
        rows.append(profile_row("train step B=128 E=2560", label, per_name,
                                traced, statistics.median(ms[3:])))
        del trainer, state
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from immunostruct_tpu_torch.ops import (
        _build, edge, fused_layer, mega, segment, stack,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}  (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s))", flush=True)

    t0 = time.perf_counter()
    _build.build()                      # one nvcc per source, in parallel
    mega._kernel_libs()
    edge._kernel_libs()
    segment._lib()
    stack._lib()
    fused_layer._lib()
    build_s = time.perf_counter() - t0
    sources = len(list(_build.CSRC.glob("*.cu")))
    assert sources == 10, sources
    print(f"kernel build + load (all {sources} sources): {build_s:.1f} s",
          flush=True)

    fwd_rows = check_fwd_kernel()
    tail_rows = check_tail_kernel()
    check_edge_mega_grads()
    edge_rows = check_edge_kernels()
    check_fused_layer_grads()
    segment_rows = check_segment_kernels()
    check_pallas_layer_grads()
    paired_rows = check_paired_kernel()
    db_rows = check_tail_db_kernel()
    nodes_rows = check_tail_nodes_kernel()
    stack_rows = check_stack_kernel()
    b7_rows = check_b7_kernel()
    scorer = full_width_scorer()
    with tempfile.TemporaryDirectory() as tmp:
        requests = write_requests(tmp)
        served, serving_counts = check_serving(scorer, requests)
        b7_served, b7_counts = check_serving(fused_stack_scorer(scorer),
                                             requests, kernel=B7_INDEX)
        train_rows, train_counts = check_training()
        onehot_row = check_onehot_training()
        comp_row, comp_counts = check_comparative()
        fused_rows, fused_counts = check_fused_training(train_rows)
        entry, entry_operands = check_entry_point(tmp)
        edge_rows += check_entry_edge_kernels(entry_operands)
        pallas_rows, pallas_counts = check_pallas_training(train_rows)
        cancer, cancer_operands = check_cancer_entry_point(tmp)
        segment_rows += check_entry_segment_kernels(cancer_operands)
        inference_rows = check_batch_inference(entry, cancer, tmp)
        variant_firsts = check_variant_first_steps()
        race_rows, race_counts = check_race()
        variant_served = check_variant_serving(scorer)
        paired_sync = check_paired_no_sync(scorer)
        profile_forwards(scorer, requests)
        profile_training()

    def pick(rows, **want):
        return next(r for r in rows if r["E"] == 2560 and r["F"] == 64
                    and r["dtype"] == "bfloat16" and r.get("B", B) == B
                    and all(r[k] == v for k, v in want.items()))

    for r, r7 in zip(served, b7_served):
        print(f"latency [{card}]: {r['request']}: median forward "
              f"{r['median_forward_ms']:.3f} ms, median HTTP round trip "
              f"{r['median_http_wall_ms']:.3f} ms; with fused_stack (B7) "
              f"{r7['median_forward_ms']:.3f} ms, round trip "
              f"{r7['median_http_wall_ms']:.3f} ms")
    for r in b7_rows:
        print(f"kernel  [{card}]: B7 B={B} E={r['E']} F={r['F']} "
              f"{r['dtype']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})")
    for agg, v in onehot_row["peak_memory"].items():
        print(f"memory  [{card}]: train step B=128 E=2560 bf16 {agg}: peak "
              f"{v['max_memory_allocated_bytes']} B allocated, step "
              f"{v['step_ms']:.3f} ms")
    for label, r in inference_rows.items():
        print(f"infer   [{card}]: infer_IEDB_or_Cancer {label}: {r['rows']} "
              f"rows, {r['wall_s_auto']:.3f} s under auto, "
              f"{r['wall_s_onehot']:.3f} s under onehot")
    print(f"paired  [{card}]: forward and step without a host sync, "
          f"launches {list(paired_sync['launches'])}")
    for r in train_rows:
        print(f"train   [{card}]: B=128 E={r['E']} bf16: median step "
              f"{r['median_step_ms_mega']:.3f} ms 'mega' "
              f"({r['pmhc_per_s_mega']:.0f} pMHC/s), "
              f"{r['median_step_ms_scatter']:.3f} ms 'scatter' "
              f"({r['pmhc_per_s_scatter']:.0f} pMHC/s)")
    for r in fused_rows:
        print(f"train   [{card}]: B=128 E={r['E']} bf16: median step "
              f"{r['median_step_ms_fused']:.3f} ms 'fused' "
              f"({r['pmhc_per_s_fused']:.0f} pMHC/s)")
    print(f"twins   [{card}]: B=128 E=2560 bf16: median step "
          f"{comp_row['median_step_ms']:.3f} ms")
    for r in pallas_rows:
        print(f"train   [{card}]: B=128 E={r['E']} bf16: median step "
              f"{r['median_step_ms_pallas']:.3f} ms 'pallas' "
              f"({r['pmhc_per_s_pallas']:.0f} pMHC/s)")
    for ep in entry["epochs"]:
        print(f"entry   [{card}]: train_IEDB_wFT --aggregation fused, "
              f"N={entry['N']} E={entry['E']}, {ep['stage']} epoch "
              f"{ep['epoch']}: {ep['epoch_s']:.3f} s, "
              f"{ep['pmhc_per_s']:.0f} pMHC/s")
    for ep in cancer["epochs"]:
        print(f"entry   [{card}]: train_Cancer_wFT --aggregation pallas, "
              f"N={cancer['N']}, {ep['stage']} epoch {ep['epoch']} "
              f"({ep['steps']} steps): {ep['epoch_s']:.3f} s, "
              f"{ep['pmhc_per_s']:.0f} pMHC/s")
    for r in segment_rows:
        print(f"kernel  [{card}]: B8 {r['kernel']} ({r['shapes']}) B={r['B']} "
              f"E={r['E']} N={r['N']} C={r['C']} {r['dtype']}: kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})")
    for r in race_rows:
        for v, t in r["race"].items():
            print(f"race    [{card}]: B=128 E={r['E']} bf16 paired batch: "
                  f"{v} p50 {t['p50_ms']:.3f} ms (best {t['best_ms']:.3f}, "
                  f"windows {t['windows_ms']}), loss {t['loss0']:.4f} -> "
                  f"window medians {t['windows_loss']}, least "
                  f"{t['min_loss']:.4f}")
    for r in variant_firsts:
        print(f"variant [{card}]: first step E={r['E']} {r['variant']}: "
              f"loss rel diff {r['loss_rel_diff']:.2e}, worst gradient "
              f"{r['grad_worst_in_tol']:.3f} of its bound")
    for r in variant_served:
        print(f"serve   [{card}]: B=128 E=2560 {r['variant']}: median "
              f"forward {r['median_forward_ms']:.3f} ms ('hybrid' "
              f"{r['median_forward_ms_hybrid']:.3f} ms), prob err "
              f"{r['max_abs_prob_err_vs_scatter']:.2e}")
    for kind, rows in (("B4", paired_rows), ("B5a", db_rows),
                       ("B5b", nodes_rows), ("B6", stack_rows)):
        for r in rows:
            smem = ("" if "smem_per_cta" not in r else
                    f", {r['smem_per_cta']} B shared memory a CTA")
            print(f"kernel  [{card}]: {kind} B={r.get('B', B)} E={r['E']} "
                  f"F={r['F']} {r['dtype']}: kernel {r['ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}){smem}")
    for kind, rows in (("B1", fwd_rows), ("B2", tail_rows),
                       ("B3", edge_rows)):
        for r in rows:
            label = f"{kind} {r['kernel']}" if kind == "B3" else kind
            bare = ("" if kind != "B1" else
                    f"; without residuals {r['bound_ms_without_residuals']:.4f}"
                    f" ms ({r['bound_by_without_residuals']})")
            if "smem_per_cta" in r:
                bare += f", {r['smem_per_cta']} B shared memory a CTA"
            if "ctas_per_sm" in r:
                bare += f", {r['ctas_per_sm']} CTAs an SM"
            print(f"kernel  [{card}]: {label} B={r.get('B', B)} E={r['E']} "
                  f"F={r['F']} "
                  f"{r['dtype']}: kernel {r['ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}){bare}")

    launches = dict(serving=serving_counts, serving_b7=b7_counts,
                    train=train_counts,
                    comparative=comp_counts, train_fused=fused_counts,
                    entry_point=entry["launches"], train_pallas=pallas_counts,
                    entry_point_cancer=cancer["launches"], race=race_counts)
    b1, b2 = pick(fwd_rows), pick(tail_rows)
    b3f, b3b = pick(edge_rows, kernel="fwd"), pick(edge_rows, kernel="bwd")
    b8s, b8g = (next(r for r in segment_rows if r["kernel"] == kind
                     and r["shapes"] == "bench" and r["E"] == 2560
                     and r["dtype"] == "bfloat16")
                for kind in ("scatter", "gather"))
    b4, b5a, b5b = pick(paired_rows), pick(db_rows), pick(nodes_rows)
    b6 = next(r for r in stack_rows if r["E"] == 2560
              and r["dtype"] == "bfloat16")
    b7 = pick(b7_rows)

    def kernel_record(name, source, replaces, index, main_count, row, rows,
                      ms_key="ms"):
        return {
            "name": name, "route": "cuda",
            "source": f"immunostruct_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": main_count,
            "launches_by_path": {k: v[index] for k, v in launches.items()},
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": row[ms_key], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row.get("library_ms"),
        }

    # no single PyTorch call computes B1-B7 (B7 a whole EGNN layer): their
    # library_ms is null; B8's is index_add_ (scatter) and index_select
    # (gather)
    record = {"kernels": [
        kernel_record("egnn_mega_fwd", "egnn_mega_fwd.cu",
                      "immunostruct_tpu/ops/pallas_mega.py:226", 0,
                      train_counts[0], b1, fwd_rows,
                      ms_key="ms_with_residuals"),
        kernel_record("egnn_tail_bwd", "egnn_tail_bwd.cu",
                      "immunostruct_tpu/ops/pallas_mega.py:370", 1,
                      train_counts[1], b2, tail_rows),
        kernel_record("egnn_edge_fwd", "egnn_edge_fwd.cu",
                      "immunostruct_tpu/ops/pallas_edge.py:152", 2,
                      entry["launches"][2], b3f,
                      [r for r in edge_rows if r["kernel"] == "fwd"]),
        kernel_record("egnn_edge_bwd", "egnn_edge_bwd.cu",
                      "immunostruct_tpu/ops/pallas_edge.py:168", 3,
                      entry["launches"][3], b3b,
                      [r for r in edge_rows if r["kernel"] == "bwd"]),
        kernel_record("segment_scatter", "segment.cu",
                      "immunostruct_tpu/ops/experimental/pallas_segment.py:60",
                      4, cancer["launches"][4], b8s,
                      [r for r in segment_rows if r["kernel"] == "scatter"]),
        kernel_record("segment_gather", "segment.cu",
                      "immunostruct_tpu/ops/experimental/pallas_segment.py:79",
                      5, cancer["launches"][5], b8g,
                      [r for r in segment_rows if r["kernel"] == "gather"]),
        kernel_record("egnn_mega_paired_fwd", "egnn_mega_paired_fwd.cu",
                      "immunostruct_tpu/ops/pallas_mega.py:303", 6,
                      race_counts[6], b4, paired_rows),
        kernel_record("egnn_tail_bwd_db", "egnn_tail_bwd_db.cu",
                      "immunostruct_tpu/ops/pallas_mega.py:501", 7,
                      race_counts[7], b5a, db_rows),
        kernel_record("egnn_tail_bwd_nodes", "egnn_tail_bwd_nodes.cu",
                      "immunostruct_tpu/ops/pallas_mega.py:525", 8,
                      race_counts[8], b5b, nodes_rows),
        kernel_record("egnn_stack_fwd", "egnn_stack_fwd.cu",
                      "immunostruct_tpu/ops/experimental/pallas_stack.py:98",
                      9, race_counts[9], b6, stack_rows),
        kernel_record("egnn_layer_fwd", "egnn_layer_fwd.cu",
                      "immunostruct_tpu/ops/experimental/pallas_egnn.py:48",
                      B7_INDEX, b7_counts[B7_INDEX], b7, b7_rows),
    ]}
    assert len(record["kernels"]) == 11
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
