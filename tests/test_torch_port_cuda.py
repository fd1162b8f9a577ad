"""The Hopper kernels behind ``edge_mega`` (immunostruct_tpu_torch/csrc/
egnn_mega_fwd.cu, B1, and egnn_tail_bwd.cu, B2) and behind ``edge_program``
(egnn_edge_fwd.cu and egnn_edge_bwd.cu, B3) against their plain PyTorch
versions, on the card.

This file imports no JAX, so it also runs on a GPU machine without JAX.
There ``tests/conftest.py`` (which imports JAX) is skipped:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q

The tests marked ``cuda`` skip on a host without a CUDA device. Tolerances:

- B1, f32 (TF32 off; the CUDA-core form): atol=1e-5, rtol=1e-4, the
  roundoff of a different summation order (the kernel sums each node's
  edges in edge order, the plain version with ``scatter_add_``). bf16 (the
  tensor-core form, one CTA per (graph, edge chunk), each chunk's tiles
  summed in tile and slot order, the chunks' node blocks in chunk order),
  per output
  column over all graphs and nodes: max|diff| <= 4e-3 * max|plain| (one
  bf16 step at the column's largest value) and mean|diff| <= 1e-4 *
  mean|plain|. The residuals a1/xd: f32 as above; bf16 each element within
  one bf16 step at its magnitude, or at 2^-10 below that (a1 is an f32 sum
  of terms of size ~1 that can cancel). Both forms also run at B=1 and
  B=200 with an all-masked graph (``test_kernel_at_the_grid_edges``), and
  ``fwd_smem_bytes`` (the 'auto' admission rule) is held above each form's
  shared memory for every N it admits.
- B2, f32: d_cat and d_ef atol=1e-5, rtol=1e-4; the weight gradients (f32
  sums over every edge of the batch) |diff| <= 1e-5 * max|plain| + 1e-4 *
  |plain|. bf16, per row of d_cat (over graphs and edges), for d_ef and for
  each weight gradient: mean|diff| <= 2e-5 * mean|plain|, and max|diff| <=
  1.6e-2 * max|plain| for d_cat and d_ef (four bf16 steps: one flipped
  rounding moves the rest of its edge's chain), 1e-3 for the weight
  gradients. A CPU simulation at these shapes read 2.1e-6 on the means for
  a change of summation order alone and 5.2e-5 to 2.7e-3 with any one of
  B2's rounding points removed. The bounds are the same for B2's f32 form
  (CUDA cores) and its bf16 form (tensor cores, csrc/egnn_tail.cuh). In
  bf16 also B3's dbc1 check: dbc1 no farther from the plain version's than
  from the sum of d_p3 unrounded (``_assert_tail_close`` with B2's
  operands, for B2, B5a and B5b).

- B3 forward and backward, f32: the outputs atol=1e-5, rtol=1e-4; the
  weight gradients as B2's. The bf16 forms run their products (the
  forward's three, the backward's nine) on the tensor cores with B2's
  near-tie recompute and share the chain's steps (csrc/egnn_hopper.cuh);
  the f32 forms stay on the CUDA cores. The forward also runs at B=1 and
  B=200, E=2560 and 1000, the last graph's bundles zero
  (``test_edge_fwd_kernel_at_the_grid_edges``). bf16, per row of the [B, C, E]
  outputs (over graphs and edges), for def and for each weight gradient:
  mean|diff| <= 2e-5 * mean|plain|, max|diff| <= 1.6e-2 * max|plain| for
  the edge outputs, 1e-3 for the weight gradients (B2's bounds: the same
  chain); and dbc1 no farther from the plain version's than from the sum
  of d_p3 unrounded (``_assert_edge_bwd_close``).
  chip_smoke.py holds B3's backward at B=128 to the same bounds under
  the rule below (the weight gradients' mean 2e-5);
  ``test_edge_bwd_smoke_bound_sees_every_rounding_point`` checks that
  every backward mutant fails it at that shape.

The kernels and the plain versions round at the same points, so they
differ only where a summation order flips one rounding. The bf16 checks,
their seeded inputs and the rule that reads them are
immunostruct_tpu_torch/ops/kernel_checks.py's: each unit of a check (row,
column or tensor) within its bound where the plain version run on the CPU
on the same operands meets it, within the bound plus twice the CPU's own
statistic where it does not. A kernel that leaves out any one rounding
point fails the rule, which ``test_bf16_bound_sees_every_rounding_point``
(B1), ``test_tail_bf16_bound_sees_every_rounding_point`` (B2),
``test_edge_bf16_bound_sees_every_rounding_point`` (B3) and the other
mutant tests check by building such kernels (each prints its ratio to what
the rule allows, ``-s``). ``test_kernel_meets_the_rule_on_every_seeded_input``
runs each kernel on every input of its card tests at the test's own seed
and at 1..8 (``kernel_checks.cases``).

- B4 (csrc/egnn_mega_paired_fwd.cu; in bf16 B1's tensor-core kernel,
  csrc/egnn_mega.cuh, with tiles of 32 arcs and their mirrors) on
  mirror-paired batches: B1's bounds against its plain version; its
  residuals equal B1's bit for bit on the same batch. Also at B=1 and
  B=200, E=2560 and 1000, the last graph all masked, and on a batch whose
  second half breaks the layout (B4 reads the arc half only).
- B5a (csrc/egnn_tail_bwd_db.cu): B2's bounds against its plain version,
  and B2's outputs bit for bit on the same inputs (the same arithmetic, the
  same block partition and reduction order). B5b
  (csrc/egnn_tail_bwd_nodes.cu): d_ef and the weight gradients as B2's; the
  node sums d_nodes, f32, per column (over graphs and nodes) |diff| <= 1e-5
  * max|plain| + 1e-4 * |plain|; bf16, per column, B2's bounds for d_cat
  (TAIL_MEAN, TAIL_MAX_EDGE: the sums of its rows). B5b's outputs are the
  same bits twice (no atomics). B2, B5a and B5b also run at B=1 and
  B=200, at E=2560 and 1000, with an all-masked graph (its outputs exactly
  zero) and with no valid edge at all (every output zero).
- B6 (csrc/egnn_stack_fwd.cu), six layers (F0=20, H=64): each layer is held
  against the plain version of that one layer run from the kernel's own
  previous h and x (so a flipped rounding does not carry into the next
  layer's check): f32 as B1's; bf16, aggs (rounded to bf16 on both sides)
  per column max|diff| <= one bf16 step at the column's largest |plain|
  (B1's 4e-3 * max is under one step where that largest value lies just
  below a power of two, which a one-step flip at E=1408 reached) and
  mean|diff| <= 1e-4 * mean|plain|, a1s/xds B1's residual rule, hs/xs per
  column mean|diff| <= 1e-4 * mean|plain|. Also at B=1 and 200, E=2560 and
  1000, the last graph all masked. Its bf16 form runs B1's tensor-core body
  layer by layer: where B1 runs one chunk a graph (B=128 on 132 SMs), each
  layer's a1s, xds and aggs are B1's on the same h and x bit for bit
  (``test_stack_layers_are_b1_bit_for_bit``). chip_smoke.py's B=1 row
  (seed 2566) is a named input of kernel_checks' sweep and has a test of
  its own.
- B1's body (which B4 and B6 run) sums a1 and cw op by op in the plain
  version's order and recomputes an a1s, m or c1 near a bf16 tie in it;
  the plain version sums pa/pb, cw and the sums at dst in the kernels'
  order (``ops/mega.py``), so on the card it is no longer the odd one out
  of kernel, card and CPU (cuBLAS and atomics were).
- Mutants: seven of B1's bf16 form (W1ab, xd, radial, m, c1, cw,
  cw*x_hat; the table says why W2/Wc1, silu(a1) and pa/pb have none),
  four of B3's forward (xd, radial, c1, cw; its table says why W1ab, W2,
  Wc1, a1s, m and cw*x_hat have none), seven of B3's backward (xd, radial,
  c1, cw, d_p2, d_p3, d_a1; its table says why W1ab, W2, Wc1, a1s and m
  have none), six of B2's tensor-core body (radial, c1, cw, d_p2, d_a1,
  d_p3; the table says why W2/Wc1, a1s and m have none), nine of B4's bf16
  form (B1's seven on B4's tiles, the mirror's sign, and the mirror's
  geometry formed anew from the second half), two of the shared tail body
  through B5a (d_p2, d_a1), one of B5b (d_xd before the node sums), eight
  of B6's tensor-core form (W1ab, xd, radial, m, c1, cw, cw*x_hat, agg; its
  table says why pa/pb, silu(a1), hmid, h and x have none), B1's body
  without its edge chain's near-tie recompute (through B6 at B=1), seven
  of B7's (its table); each fails its kernel's bf16 bound.

- B8 (csrc/segment.cu, behind ``segment_scatter``/``segment_gather``): the
  gather bit for bit. The scatter, f32: |diff| <= 2 * k * 2^-24 * (the sum
  of |m| over the k edges of the element), the bound of two f32 sums of the
  same terms in other orders (the plain version on the card sums with
  atomics); bf16: within one bf16 step of the larger magnitude, or of
  2^-10 below that (both sum in f32 and round once). It sums each element
  in edge order, so it is also bit for bit the plain version run on the
  CPU (``index_add_`` there sums in edge order), at the grids' edges (B=1,
  25, 200; E=128, 1280, 1283, 2560; C=1, 3, 67, 128; N=1, 288, 2048; an
  all-masked graph; the corpus's padding to node 0).
  ``test_segment_bf16_bound_sees_f32_accumulation`` builds a scatter that
  accumulates in the compute dtype, which fails the bf16 bound.

- B7 (csrc/egnn_layer_fwd.cu, behind ``fused_egnn_layer``) at B=128,
  N=288, E=2560/1408/256, F=20/64, with unmasked edges whose src or dst is
  -1 or N: h' and x' f32 atol=1e-5, rtol=1e-4; bf16 per column (over graphs
  and nodes) max|diff| within one bf16 step at the column's largest
  |plain| (B6's form: a flip at a value just above a power of two is 2^-7
  of it, over B1's 4e-3) and mean|diff| <= 1e-4 * mean|plain|. Its bf16
  form (every product on the tensor cores, a graph over a cluster of
  ``layer_cluster_size`` CTAs) also runs at B=1 and 200, E=2560 and 1024,
  bf16 and f32 coordinates, the last graph all masked. Eleven mutants of
  its tensor-core form, each without one of B7's rounding points (those of
  the 'mega' forward: the x cast, x_diff, radial, the dst projection, m,
  c1, cw, msg_x, x_agg, zn, x' from x's own dtype; the two on x run f32
  coordinates under bf16 features), fail the bf16 bound; silu(z1), the src
  projection, agg, a and h' reach only bf16 storage and have none. c1, cw,
  msg_x and x_agg reach x' only, through x_agg: at unit-scale coordinates
  x carries x' and their change can stay under the mean bound, so they run
  coordinates at 1/16 scale, where x_agg carries x'.

Repeat. Every kernel and the glue around it sums in a fixed order, without
atomics, so the same inputs give the same bits: two launches of B1 and B4
(both dtypes, with their residuals), B6, B7, the 'hybrid' and 'dboth'
backward's node sums and a 'fused' and a 'pallas' layer's forward and
backward (their sums through B8's scatter) at B=1, 8 and 128 are equal
(``torch.equal``); and a seed trained twice from fresh state (full-width
HybridModelv2, B=16, E=2560, bf16, three steps, the same batch) gives equal
losses, parameters and Adam moments under every aggregation ('mega' under
each variant, 'fused', 'pallas', 'onehot', 'auto'), and a request served
twice equal logits, also under ``fused_stack``. 'scatter' (``index_add_``
with atomics, the reference algorithm's baseline) is run and read, not
held to it.
- 'paired' forward and train step under
  ``torch.cuda.set_sync_debug_mode("error")``; 'onehot'/'onehot_remat'
  layers and ``model_apply(fused_stack=True)`` against 'scatter' in f32.

The serving artifact (utils/export.py): the four kernel ops (B1, B3's
forward, B8's scatter and gather) pass ``torch.library.opcheck`` on CUDA
tensors in f32 and bf16; a full-width HybridModelv2 exported under 'mega'
(bf16, B=16, E=2560) launches 6 B1 a call and no other kernel, gives the
eager ``Scorer``'s bits, and refuses to load for the CPU.
"""

import contextlib
import copy
import functools
import json
import re

import numpy as np
import pytest
import torch

from immunostruct_tpu_torch.data.synthetic import random_sample_batch
from immunostruct_tpu_torch.models import build_model, model_apply
from immunostruct_tpu_torch.data.synthetic import build_batch
from immunostruct_tpu_torch.ops import _build, edge, mega, segment, stack
from immunostruct_tpu_torch.ops import kernel_checks as kc
from immunostruct_tpu_torch.ops.kernel_checks import (
    b2_of as _b2_of, b7_args as _b7_args, corpus_layout as _corpus_layout,
    edge_args as _edge_args, mega_args as _args, paired_args as _paired_args,
    scrambled_mirror_half as _scrambled_mirror_half, segment_args as
    _segment_args, stack_args as _stack_args, tail_args as _tail_args,
    tail_g_args as _tail_g_args,
)
from immunostruct_tpu_torch.ops.egnn import (
    EGNNLayer, egnn_apply, egnn_stack, egnn_stack_apply,
)
from immunostruct_tpu_torch.procedures.train import Trainer, make_optimizer
from immunostruct_tpu_torch.utils.losses import LossConfig
from immunostruct_tpu_torch.utils.schedule import constant_lr

N = 288


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread_without_a_card():
    """One torch thread where this file runs on the CPU beside the suite's
    other workers; on a machine with a card it runs alone, and its plain
    versions keep torch's threads."""
    threads = torch.get_num_threads()
    if not torch.cuda.is_available():
        torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _assert_close(out, ref, dtype):
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-4)
    else:
        kc.assert_rule(kc.mega_checks("out", out, ref))


def _assert_residuals_close(got, ref, dtype):
    for g, r in zip(got, ref):
        assert g.dtype == dtype and g.shape == r.shape
        if dtype == torch.float32:
            torch.testing.assert_close(g, r, atol=1e-5, rtol=1e-4)
        else:
            # one bf16 step; below 2^-10 the f32 roundoff of a1's sum of
            # terms of size ~1 (FMA on the card) can exceed a step
            kc.assert_rule([kc.elem_steps_check("residual", g, r, None)])


def _assert_tail_close(out, ref, dtype, args=None):
    """B2 against its plain version (module docstring); in bf16, given B2's
    operands ``args``, also dbc1 (dsmall's bc1 column, the sum of the
    rounded d_p3 over the edges) no farther from the plain version's than
    from the same sum of d_p3 unrounded (``mega.tail_d_p3_unrounded_sum``),
    B3's check (``_assert_edge_bwd_close``): the bound on dsmall's row does
    not see that rounding."""
    d_cat, d_ef = out[:2]
    assert d_cat.dtype == d_ef.dtype == dtype
    for t in out:
        assert torch.isfinite(t).all()
    for g, r in zip(out[2:], ref[2:]):
        assert g.dtype == torch.float32 and g.shape == r.shape
    if dtype == torch.float32:
        for g, r in zip(out[:2], ref[:2]):
            torch.testing.assert_close(g, r, atol=1e-5, rtol=1e-4)
        for g, r in zip(out[2:], ref[2:]):
            assert ((g - r).abs() <= 1e-5 * r.abs().max()
                    + 1e-4 * r.abs()).all()
        return
    kc.assert_rule(kc.tail_all_checks(out, ref, args))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def test_plain_version_on_cpu_is_finite():
    args = _args(2, 100, 20, 16, torch.float32, "cpu", seed=0)
    out = mega.edge_mega(*args)
    assert out.shape == (2, N, 19) and torch.isfinite(out).all()


@pytest.mark.cuda
@pytest.mark.parametrize("e", [2560, 1408, 100])
@pytest.mark.parametrize("f", [20, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version(cuda, e, f, dtype):
    args = _args(8, e, f, 64, dtype, cuda, seed=e + f)
    before = mega.edge_mega.launches
    out = mega.edge_mega(*args)
    torch.cuda.synchronize()
    assert mega.edge_mega.launches == before + 1
    ref, a1_ref, xd_ref = mega.edge_mega_fwd_reference(*args)
    _assert_close(out, ref, dtype)
    # with the residuals the backward reads
    out2, a1, xd = mega.edge_mega_fwd(*args, residuals=True)
    torch.cuda.synchronize()
    _assert_close(out2, ref, dtype)
    _assert_residuals_close((a1, xd), (a1_ref, xd_ref), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("e", [2560, 1408, 100])
@pytest.mark.parametrize("f", [20, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tail_kernel_matches_plain_version(cuda, e, f, dtype):
    args = _tail_args(8, e, f, dtype, cuda, seed=e + f + 1)
    before = mega.tail_bwd.launches
    out = mega.tail_bwd(*args)
    torch.cuda.synchronize()
    assert mega.tail_bwd.launches == before + 1
    _assert_tail_close(out, mega.tail_bwd_reference(*args), dtype, args)
    # the weight gradients are the same from run to run (no atomics)
    again = mega.tail_bwd(*args)
    for g, h in zip(out[2:], again[2:]):
        assert torch.equal(g, h)


@pytest.mark.cuda
def test_tail_kernel_all_edges_masked_gives_zeros(cuda):
    args = list(_tail_args(2, 256, 20, torch.float32, cuda, seed=1,
                           mask_rate=1.0))
    # residuals of skipped edges are never read: fill them with NaN
    args[4] = torch.full_like(args[4], float("nan"))
    args[5] = torch.full_like(args[5], float("nan"))
    for t in mega.tail_bwd(*args):
        assert torch.count_nonzero(t) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_edge_mega_gradients_match_scatter_on_card(cuda, dtype):
    """One EGNN layer through 'mega' (B1 forward, B2 backward) against
    autograd through 'scatter' (plain PyTorch): gradients of the layer's
    parameters and inputs. f32: atol=1e-4 * max|scatter| + rtol=1e-3 (the
    two paths sum in other orders); bf16 rounds at other points on the two
    paths, so only finiteness and the launches are checked there (the bf16
    gradients are held against the JAX backward on the CPU and B2 against
    its plain version above)."""
    gen = torch.Generator().manual_seed(7)
    layer = EGNNLayer(20, 64, 64, generator=gen, device=cuda)
    args = _args(4, 1408, 20, 64, torch.float32, "cpu", seed=7)
    src, dst, mask, ef, h, x = (t.to(cuda) for t in args[:6])
    cot_h = torch.randn(4, N, 64, generator=gen).to(cuda, dtype)
    cot_x = torch.randn(4, N, 3, generator=gen).to(cuda, dtype)
    grads = {}
    for agg in ("mega", "scatter"):
        layer.zero_grad()
        hin = h.to(dtype).requires_grad_(True)
        xin = x.to(dtype).requires_grad_(True)
        before = mega.edge_mega.launches, mega.tail_bwd.launches
        h2, x2 = egnn_apply(layer, hin, xin, src, dst, ef, mask, agg)
        ((h2 * cot_h).float().sum() + (x2 * cot_x).float().sum()).backward()
        torch.cuda.synchronize()
        launched = (mega.edge_mega.launches - before[0],
                    mega.tail_bwd.launches - before[1])
        assert launched == ((1, 1) if agg == "mega" else (0, 0))
        grads[agg] = [hin.grad, xin.grad] + [
            p.grad.clone() for p in layer.parameters()]
    for g, r in zip(grads["mega"], grads["scatter"]):
        assert torch.isfinite(g).all()
        if dtype == torch.float32:
            g, r = g.float(), r.float()
            assert ((g - r).abs() <= 1e-4 * r.abs().max()
                    + 1e-3 * r.abs()).all()


@pytest.mark.cuda
def test_train_step_launches_both_kernels_per_layer(cuda):
    """One bf16 training step of full-width HybridModelv2 (6 EGNN layers)
    at B=16: 6 B1 and 6 B2 launches, a finite loss, finite gradients."""
    _, model = build_model("HybridModelv2", 20 * 21,
                           torch.Generator().manual_seed(0), device=cuda)
    trainer = Trainer(model.spec, LossConfig(20 * 21, 1.0), binary=True,
                      optimizer=make_optimizer("adam", constant_lr(1e-3)),
                      aggregation="mega", compute_dtype=torch.bfloat16)
    state = trainer.init_state(model)
    batch = random_sample_batch(16, N, 1408, 20, seed=3, device=cuda)
    before = mega.edge_mega.launches, mega.tail_bwd.launches
    state, loss = trainer.train_step(state, batch, seed=0)
    torch.cuda.synchronize()
    assert (mega.edge_mega.launches - before[0],
            mega.tail_bwd.launches - before[1]) == (6, 6)
    assert torch.isfinite(loss)
    for p in model.parameters():
        assert torch.isfinite(p.grad).all() and torch.isfinite(p).all()


# B1's bf16 form (the tensor-core kernel of csrc/egnn_mega.cuh, and the
# geometry it shares in csrc/egnn_common.cuh) with one bf16 rounding point
# left out: (pattern, replacement) pairs. W2, Wc1 and silu(a1) have no
# mutant: each reaches the tensor cores as a bf16 operand and is used
# nowhere else, so its rounding is the operand's type, which no edit of the
# arithmetic removes; nor pa/pb, which reach the edges through a bf16
# scratch whose store rounds them. m keeps one through its f32 consumer,
# the node block's sum (its rounding for the product is the operand's).
_B1_SOURCES = ("egnn_mega_fwd.cu", "egnn_mega.cuh", "egnn_common.cuh")
_MUTANTS = {
    "weights": [(r"(w1s\[i\] = )rnd<\w+>\((w1ab\[i\])\)", r"\1\2")],
    "xd": [(r"rnd<T>\((to_f\(xb\[s \* 3 \+ \d\]\) - to_f\(xb\[d \* 3 \+ "
            r"\d\]\))\)", r"(\1)")],
    "radial": [(r"(r = )rnd<T>\((d0 \* d0 \+ d1 \* d1 \+ d2 \* d2)\)",
                r"\1\2")],
    "m": [(r"(p2\[nt\]\[i\] = )rnd<bf>\((mv)\)", r"\1\2"),
          (r"(set_at\(p2, i, )rnd<bf>\((p \* sigmoid\(p\))\)", r"\1\2")],
    "coord_hidden": [(r"(p3\[nt\]\[i\] = )rnd<bf>\((cv)\)", r"\1\2"),
                     (r"(set_at\(p3, i, )rnd<bf>\((p \* sigmoid\(p\))\)",
                      r"\1\2")],
    "cw": [(r"(const float cwb = )rnd<bf>\((cw)\)", r"\1\2")],
    "cw_xhat": [(r"rnd<bf>\((cwb \* g\.xh\[t \* 3 \+ k\])\)", r"(\1)")],
}

# B1's body (csrc/egnn_mega.cuh mma_edge_chunk, which B4 and B6 run too) as
# it was before its edge chain recomputed near-tie roundings in the plain
# version's order (a1s, m and c1) and rounded a1's and cw's sums op by op:
# the near_tie tests of the body off (B6's node MLP keeps its own, in
# csrc/egnn_stack_fwd.cu) and those sums as plain expressions, which nvcc
# fuses into multiply-adds
_NO_EDGE_RECOMPUTE = [
    (r"near_tie\(", r"0 && near_tie("),
    (r"__fadd_rn\(pa, pb\)", r"pa + pb"),
    (r"__fadd_rn\(a, __fmul_rn\((\w+), (\w+)\)\)", r"a + \1 * \2"),
    (r"__fadd_rn\(a, b1\)", r"a + b1"),
    (r"__fadd_rn\(part\[i >> 1\],\s*__fmul_rn\((p3\[nt\]\[i\]), "
     r"(sms\[kWC2 \* H \+ j\])\)\)", r"part[i >> 1] + \1 * \2")]


@contextlib.contextmanager
def unordered_plain():
    """B1's plain version (so B4's and B6's) as it was before it took the
    kernels' order: pa/pb by torch.matmul, cw by .sum and the sums at dst
    by scatter_add_ (on the card cuBLAS, which sums pa/pb at M=288 out of
    k order, and atomics)."""
    def scatter_add(d, both, valid, n):
        out = torch.zeros(both.shape[0], n, both.shape[2],
                          dtype=torch.float32, device=both.device)
        return out.scatter_add_(1, d[..., None].expand_as(both),
                                both * valid[..., None])
    def cw_sum(c1, wc2):
        return (c1 * wc2).sum(-1, keepdim=True)
    names = ("projection_in_order", "cw_in_order", "sum_at_dst_in_edge_order")
    saved = [getattr(mega, name) for name in names]
    for name, fn in zip(names, (torch.matmul, cw_sum, scatter_add)):
        setattr(mega, name, fn)
    try:
        yield
    finally:
        for name, fn in zip(names, saved):
            setattr(mega, name, fn)


def _mutant_kernel(sources, mutants, tmp_path, monkeypatch):
    """Build csrc/ with each (pattern, replacement) applied to ``sources``
    (a file name, or a tuple of them; each pattern matches in at least one),
    in place of the repo's kernels, until the test ends."""
    sources = (sources,) if isinstance(sources, str) else sources
    texts = {name: (_build.CSRC / name).read_text() for name in sources}
    for pattern, repl in mutants:
        n = 0
        for name in texts:
            texts[name], k = re.subn(pattern, repl, texts[name])
            n += k
        assert n >= 1, f"{pattern} matches nothing in {sources}"
    (tmp_path / "csrc").mkdir()
    for other in [*_build.CSRC.glob("*.cu"), *_build.CSRC.glob("*.cuh")]:
        (tmp_path / "csrc" / other.name).write_text(other.read_text())
    for name, text in texts.items():
        (tmp_path / "csrc" / name).write_text(text)
    monkeypatch.setattr(_build, "CSRC", tmp_path / "csrc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    _clear_libraries()


def _clear_libraries():
    _build.load_library.cache_clear()
    for lib in (mega._fwd_lib, mega._tail_lib, mega._paired_lib,
                mega._tail_db_lib, mega._tail_nodes_lib, stack._lib,
                edge._fwd_lib, edge._bwd_lib, segment._lib):
        lib.cache_clear()


@pytest.fixture
def restore_kernels():
    yield
    _clear_libraries()


def _on_cpu(plain, *args):
    """``plain`` run on the CPU on the same operands, back on the card: the
    rule's yardstick (ops/kernel_checks.py)."""
    return kc.on("cuda", plain(*kc.on("cpu", args)))


def _mutant_fails_rule(what, checks):
    """A mutant kernel judged by the rule, the plain version on the CPU its
    yardstick: it must fail it (if it met it, the rule would be blind
    there). Prints its worst ratio to what the rule allows (pytest -s)."""
    v = kc.judge(checks)
    print(f"mutant {what}:", json.dumps(dict(
        worst=round(v["worst"], 4), worst_vs_bound=round(v["worst_vs_bound"],
                                                         4),
        cpu_worst=v["cpu_worst"] and round(v["cpu_worst"], 4),
        restated=v["restated"])), flush=True)
    assert not v["ok"], f"{what} meets the rule: the rule is blind there"


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_MUTANTS))
def test_bf16_bound_sees_every_rounding_point(cuda, name, tmp_path,
                                              monkeypatch, restore_kernels):
    _mutant_kernel(_B1_SOURCES, _MUTANTS[name], tmp_path, monkeypatch)
    for e, f in ((2560, 20), (1408, 64)):
        args = _args(8, e, f, 64, torch.bfloat16, cuda, seed=e + f)
        out = mega.edge_mega(*args)
        _mutant_fails_rule(f"B1 {name} E={e} F={f}", kc.mega_checks(
            "out", out, mega.edge_mega_reference(*args),
            _on_cpu(mega.edge_mega_reference, *args)))


# B2 with one bf16 rounding point left out, in the tensor-core body it
# shares with B5a and B5b (csrc/egnn_tail.cuh, bf16 only) and the chain
# steps that body shares with B3's backward (csrc/egnn_hopper.cuh). W2/Wc1, a1s and m
# have no mutant: each reaches the tensor cores as a bf16 operand and is
# used nowhere else, so its rounding is the operand's store, which no edit
# of the arithmetic removes. d_p2, d_p3 and d_a1 also feed bf16 operands;
# a mutant leaves out the rounding where the value meets an f32 consumer
# outside the products: d_p2 in db2, d_a1 in the per-edge sums that give
# d_rad (hence d_xd) and d_ef, d_p3 in dbc1 (where gbc1 adds
# `__low2float(q)`, add `d3[0]`, and `d3[1]` for `__high2float(q)`): dbc1
# is one of the six columns of dsmall, held as one row, and among its
# smallest, so the row's mean bound does not see that mutant; the dbc1
# check of ``_assert_tail_close`` (B3's since its backward's redesign)
# does. d_xd and d_ef round at their store in the compute dtype, which no
# edit of the arithmetic removes.
_TAIL_SOURCES = ("egnn_tail.cuh", "egnn_hopper.cuh")
_TAIL_MUTANTS = {
    "radial": [(r"(const float r = )rnd<bf>\((x\[0\] \* x\[0\] \+ x\[1\] \* "
                r"x\[1\] \+ x\[2\] \* x\[2\])\)", r"\1\2")],
    "c1": [(r"(const float c1 = )rnd<bf>\((p \* s)\)", r"\1\2")],
    "cw": [(r"(ev\[kECw \* kTile \+ m0 \+ fr \+ 8 \* h\] = )rnd<bf>\((cw)\)",
            r"\1\2")],
    "d_p2": [(r"(const float dp2 = )rnd<bf>\((dm \* g2\[nt\]\[2 \* h \+ c\])\)",
              r"\1\2")],
    "d_a1": [(r"(const float da = )rnd<bf>\((dsum \* g1)\)", r"\1\2")],
    "d_p3": [(r"(gbc1\[2 \* nt\] \+= )__low2float\(q\);", r"\1d3[0];"),
             (r"(gbc1\[2 \* nt \+ 1\] \+= )__high2float\(q\);",
              r"\1d3[1];")],
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_TAIL_MUTANTS))
def test_tail_bf16_bound_sees_every_rounding_point(cuda, name, tmp_path,
                                                   monkeypatch,
                                                   restore_kernels):
    inputs = [_tail_args(8, e, f, torch.bfloat16, cuda, seed=e + f + 1)
              for e, f in ((2560, 20), (1408, 64))]
    _mutant_kernel(_TAIL_SOURCES, _TAIL_MUTANTS[name], tmp_path,
                   monkeypatch)
    for args in inputs:
        out = mega.tail_bwd(*args)
        _mutant_fails_rule(f"B2 {name} E={args[6].shape[2]}",
                           kc.tail_all_checks(
                               out, mega.tail_bwd_reference(*args), args,
                               _on_cpu(mega.tail_bwd_reference, *args)))


# the near-tie recompute of the tensor-core forms (csrc/egnn_hopper.cuh)
# turned off
_NO_TIE_RECOMPUTE = [(r"(constexpr int kTieUlps = )\d+;", r"\g<1>-1;")]


@pytest.mark.cuda
def test_tail_bf16_bound_sees_the_near_tie_recompute(cuda, tmp_path,
                                                     monkeypatch,
                                                     restore_kernels):
    """Without the near-tie recompute (csrc/egnn_hopper.cuh), one d_p2 of
    test_tail_kernel_matches_plain_version's bf16 B=8, E=100, F=64 input
    rounds the other way from the plain version's, and the d_a1 it moves
    fail the per-row mean bound at 800 edges."""
    args = _tail_args(8, 100, 64, torch.bfloat16, cuda, seed=165)
    _mutant_kernel("egnn_hopper.cuh", _NO_TIE_RECOMPUTE, tmp_path,
                   monkeypatch)
    out = mega.tail_bwd(*args)
    _mutant_fails_rule("B2 without the near-tie recompute", kc.tail_checks(
        out, mega.tail_bwd_reference(*args),
        _on_cpu(mega.tail_bwd_reference, *args)))


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 200])
@pytest.mark.parametrize("e", [2560, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_at_the_grid_edges(cuda, b, e, dtype):
    """B1 at one graph (bf16: its edges split over many CTAs, the chunks'
    node blocks summed by a second kernel) and at more graphs than SMs, at
    an E that is a multiple of 64 and one that is not, with the last graph
    all masked when B > 1: output and residuals against the plain
    version's, that graph's output and residuals exactly zero."""
    args = _args(b, e, 64, 64, dtype, cuda, seed=b + e)
    if b > 1:
        args[2] = args[2].clone()
        args[2][-1] = False
    out, a1, xd = mega.edge_mega_fwd(*args)
    torch.cuda.synchronize()
    ref, a1_ref, xd_ref = mega.edge_mega_fwd_reference(*args)
    _assert_close(out, ref, dtype)
    _assert_residuals_close((a1, xd), (a1_ref, xd_ref), dtype)
    if b > 1:
        for t in (out[-1], a1[-1], xd[-1]):
            assert torch.count_nonzero(t) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("paired", [False, True])
@pytest.mark.parametrize("residuals", [True, False])
def test_forward_scratch_outlives_the_launch(cuda, paired, residuals,
                                             monkeypatch):
    """B1 and B4 in bf16 at B=16, E=1408 (8 chunks a graph): no two buffers
    the launch writes (out, the projections' scratch, the chunks' node
    blocks, the residuals) overlap, and the output is the plain version's.
    A scratch freed before the launch goes to the caching allocator's next
    request, the node blocks, and the kernels overwrite one with the
    other."""
    args = _paired_args(16, 1408, 64, torch.bfloat16, cuda, seed=3)
    lib = mega._paired_lib() if paired else mega._fwd_lib()
    entry = "egnn_mega_paired_fwd" if paired else "egnn_mega_fwd"
    launch = getattr(lib, entry)
    spans = []

    def recorded(*a):
        b, n, e, _, hid, chunks = a[15:21]
        c = hid + 3
        for ptr, size in ((a[10], b * n * c * 4), (a[11], b * n * 2 * hid * 4),
                          (a[12], b * chunks * n * c * 4),
                          (a[13], b * hid * e * 2), (a[14], b * 3 * e * 2)):
            if ptr:
                spans.append((ptr, ptr + size))
        return launch(*a)

    monkeypatch.setattr(lib, entry, recorded)
    torch.cuda.empty_cache()
    fwd = mega.edge_mega_paired_fwd if paired else mega.edge_mega_fwd
    out = fwd(*args, residuals=residuals)[0]
    torch.cuda.synchronize()
    spans.sort()
    assert len(spans) == (5 if residuals else 3)
    assert all(x[1] <= y[0] for x, y in zip(spans, spans[1:]))
    ref = (mega.edge_mega_paired_fwd_reference if paired
           else mega.edge_mega_fwd_reference)(*args)[0]
    _assert_close(out, ref, torch.bfloat16)


@pytest.mark.cuda
def test_admission_covers_the_kernels_shared_memory(cuda):
    """``mega_admits`` decides 'auto' from ``fwd_smem_bytes``, a copy of
    the f32 form's formula: for every N it admits, from 16 up, B1's and
    B4's forms in either dtype need no more shared memory a CTA than that.
    ``fused_admits`` takes every F <= 64 whatever the card: B3's forward
    in either dtype fits the card's opt-in limit there, and its bf16 form
    two CTAs an SM at F=64. B6's and B7's tensor-core layouts admit at
    least the N their CUDA-core forms admitted."""
    lib, paired = mega._fwd_lib(), mega._paired_lib()
    n = 16
    while mega.mega_admits(n, 64, 64, 1):
        for bf16 in (0, 1):
            assert (mega.fwd_smem_bytes(n, 64)
                    >= lib.egnn_mega_fwd_smem_bytes(n, 64, bf16))
            assert (mega.fwd_smem_bytes(n, 64)
                    >= paired.egnn_mega_paired_fwd_smem_bytes(n, 64, bf16))
        n += 1
    assert n > N
    fwd = edge._fwd_lib()
    optin = torch.cuda.get_device_properties(cuda) \
        .shared_memory_per_block_optin
    for f in range(1, edge.KERNEL_MAX_F + 1):
        assert edge.fused_admits(2560, f, 64, 1)
        for bf16 in (0, 1):
            assert fwd.egnn_edge_fwd_smem_bytes(f, 64, bf16) <= optin
    assert fwd.egnn_edge_fwd_ctas_per_sm(64, 64, 1) == 2
    # B6: the bf16 form (h and x resident in bf16) needs no more shared
    # memory a CTA than the f32 form, whose size the wrapper admits
    slib = stack._lib()
    for n in range(16, N + 64):
        assert (slib.egnn_stack_fwd_smem_bytes(n, 64, 1)
                <= slib.egnn_stack_fwd_smem_bytes(n, 64, 0))
    assert slib.egnn_stack_fwd_smem_bytes(N, 64, 1) <= optin
    assert slib.egnn_stack_fwd_ctas_per_sm(N, 64, 1) == 1
    # B7: the tensor-core form (h gathered from device memory, not held)
    # takes, at F=20 and F=64, every N the CUDA-core form took with bf16
    # features at F=64 (its smem formula: 408 N + 37,772 B), one CTA an SM
    flib = fused_layer._lib()
    n = 16
    while 408 * n + 37772 <= optin:
        for f in (20, 64):
            assert flib.egnn_layer_fwd_smem_bytes(n, f, 64, 1) <= optin
        n += 1
    assert n > N
    for x_bf16 in (0, 1):
        assert flib.egnn_layer_fwd_ctas_per_sm(N, 64, x_bf16) == 1


@pytest.mark.cuda
def test_kernel_all_edges_masked_gives_zeros(cuda):
    args = _args(2, 256, 20, 64, torch.float32, cuda, seed=1, mask_rate=1.0)
    out = mega.edge_mega(*args)
    assert torch.count_nonzero(out) == 0


@pytest.mark.cuda
def test_tail_kernel_rejects_what_it_does_not_take(cuda):
    args = list(_tail_args(2, 128, 20, torch.float32, cuda, seed=2))
    half = list(args)
    half[4], half[5] = half[4].half(), half[5].half()
    half[0], half[6] = half[0].half(), half[6].half()
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        mega.tail_bwd(*half)
    strided = list(args)
    strided[6] = args[6].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        mega.tail_bwd(*strided)
    wrong = list(args)
    wrong[7] = args[7][:, :100]
    with pytest.raises(ValueError, match="valid"):
        mega.tail_bwd(*wrong)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    args = _args(2, 128, 20, 64, torch.float32, cuda, seed=2)
    half = list(args)
    half[4], half[5] = half[4].half(), half[5].half()
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        mega.edge_mega(*half)
    strided = list(args)
    strided[4] = args[4].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        mega.edge_mega(*strided)
    for hid in (32, 48):
        narrow = _args(2, 128, 20, hid, torch.float32, cuda, seed=3)
        with pytest.raises(ValueError, match="H=64"):
            mega.edge_mega(*narrow)


@pytest.mark.cuda
def test_model_mega_matches_scatter_on_card(cuda):
    _, model = build_model("HybridModelv2", 20 * 21,
                           torch.Generator().manual_seed(0), device=cuda)
    b = random_sample_batch(16, N, 1408, 20, seed=1, device=cuda)
    eps = torch.randn(16, 32, generator=torch.Generator().manual_seed(2))
    outs = {}
    for agg in ("mega", "scatter"):
        before = mega.edge_mega.launches
        with torch.inference_mode():
            outs[agg] = model_apply(model, b.graph, b.seq_onehot, b.props,
                                    deterministic=True, aggregation=agg,
                                    eps=eps.to(cuda))
        launched = mega.edge_mega.launches - before
        assert launched == (len(model.gcn) if agg == "mega" else 0)
    for name in ("logits", "embedding", "attention"):
        torch.testing.assert_close(getattr(outs["mega"], name),
                                   getattr(outs["scatter"], name),
                                   atol=1e-4, rtol=1e-3)


# --------------------------------------------------------------------------
# B3: the edge program over gathered bundles
# --------------------------------------------------------------------------

_rows = kc.edge_rows        # [B, C, E] -> [C, B*E]: one row per channel


def _assert_edge_close(out, ref, dtype, grad_mean=2e-5):
    """B3 against its plain version (module docstring). ``out``/``ref``:
    the forward's output alone, or the backward's seven outputs;
    ``grad_mean`` the bf16 mean bound of the weight gradients."""
    out = out if isinstance(out, tuple) else (out,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    edge_out = [(g, r) for g, r in zip(out, ref) if g.dim() == 3]
    grads = [(g, r) for g, r in zip(out, ref) if g.dim() == 2]
    for g, r in edge_out:
        assert g.dtype == dtype and g.shape == r.shape
    for g, r in grads:
        assert g.dtype == torch.float32 and g.shape == r.shape
    for g, _ in edge_out + grads:
        assert torch.isfinite(g).all()
    if dtype == torch.float32:
        for g, r in edge_out:
            torch.testing.assert_close(g, r, atol=1e-5, rtol=1e-4)
        for g, r in grads:
            assert ((g - r).abs() <= 1e-5 * r.abs().max()
                    + 1e-4 * r.abs()).all()
        return
    kc.assert_rule(kc.edge_checks(out, ref, grad_mean=grad_mean))


def _assert_edge_bwd_close(args, dout, out, ref, dtype, grad_mean=2e-5):
    """B3's backward against its plain version: ``_assert_edge_close``
    and, in bf16, dbc1 (dsmall's bc1 column, the sum of the rounded d_p3
    over the edges) no farther from the plain version's than from the same
    sum of d_p3 unrounded (``edge.d_p3_unrounded_sum``). The bound on
    dsmall's row does not see that rounding: dbc1 is small beside dsmall's
    other columns. On an H100 (scripts/torch_kernel_ties.py --kernel
    edge_bwd, the tests' shapes at their seeds and 1..8) the kernel read
    0-0.011 of the way, the kernel without the rounding 138 or more."""
    _assert_edge_close(out, ref, dtype, grad_mean)
    if dtype == torch.bfloat16:
        kc.assert_rule([kc.dbc1_check(args, dout, out, ref)])


@pytest.mark.cuda
@pytest.mark.parametrize("b,e,tail", [(8, 2560, 0), (8, 256, 56),
                                      (26, 1280, 0), (51, 1280, 0),
                                      (8, 100, 0)])
@pytest.mark.parametrize("f", [20, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_edge_kernels_match_plain_versions(cuda, b, e, tail, f, dtype):
    """B=26 and B=51 at E=1280 are the partial batches of chip_smoke.py's
    entry-point run; on a 132-SM card B=26 runs 6 chunks of 256 edges per
    graph, the sixth of them empty. E=100, not a multiple of 8, takes the
    bf16 backward's element-wise tile loads (cp.async needs 16-byte runs)."""
    args, dout = _edge_args(b, e, f, dtype, cuda, seed=e + f, tail=tail)
    before = edge.edge_program.launches, edge.edge_program_bwd.launches
    out = edge.edge_program(*args)
    grads = edge.edge_program_bwd(*args, dout)
    torch.cuda.synchronize()
    assert (edge.edge_program.launches - before[0],
            edge.edge_program_bwd.launches - before[1]) == (1, 1)
    _assert_edge_close(out, edge.edge_program_reference(*args), dtype)
    _assert_edge_bwd_close(args, dout, grads,
                           edge.edge_program_bwd_reference(*args, dout),
                           dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_edge_bwd_weight_gradients_are_deterministic(cuda, dtype):
    args, dout = _edge_args(16, 1408, 64, dtype, cuda, seed=3)
    first = edge.edge_program_bwd(*args, dout)
    again = edge.edge_program_bwd(*args, dout)
    for g, h in zip(first, again):
        assert torch.equal(g, h)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 200])
@pytest.mark.parametrize("e", [2560, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_edge_fwd_kernel_at_the_grid_edges(cuda, b, e, dtype):
    """B3's forward at one graph (its edges over many CTAs) and at more
    graphs than SMs, at an E that is a multiple of 64 and one that is not,
    with the last graph all masked when B > 1 (its bundles zero, as the
    'fused' path gathers them): against the plain version, one launch."""
    args, _ = _edge_args(b, e, 64, dtype, cuda, seed=b + e + 5)
    if b > 1:
        for t in args[:2]:
            t[-1] = 0
    before = edge.edge_program.launches
    out = edge.edge_program_fwd(*args)
    torch.cuda.synchronize()
    assert edge.edge_program.launches == before + 1
    _assert_edge_close(out, edge.edge_program_reference(*args), dtype)


@pytest.mark.cuda
def test_edge_program_autograd_launches_both_kernels(cuda):
    """EdgeProgram through autograd on the card: B3 forward, B3 backward,
    gradients equal to the backward kernel's on the same cotangent."""
    args, dout = _edge_args(4, 256, 20, torch.float32, cuda, seed=9)
    leaves = [t.detach().clone().requires_grad_(True) for t in args]
    before = edge.edge_program.launches, edge.edge_program_bwd.launches
    out = edge.edge_program(*leaves)
    (out * dout).sum().backward()
    torch.cuda.synchronize()
    assert (edge.edge_program.launches - before[0],
            edge.edge_program_bwd.launches - before[1]) == (1, 1)
    want = edge.edge_program_bwd(*args, dout)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w.reshape(leaf.shape))


# B3's forward in bf16 (the tensor-core kernel of csrc/egnn_edge_fwd.cu and
# the chain steps it shares with B3's backward and B2 in
# csrc/egnn_hopper.cuh) with one rounding point left out. W1ab, W2, Wc1,
# a1s and m have no mutant: each reaches the tensor cores as a bf16 operand
# (m also the output, rounded by its store in the compute dtype) and is
# used nowhere else; nor cw * x_hat, rounded by its store. c1 keeps its
# rounding through cw's f32 sum, cw through cw * x_hat.
_EDGE_FWD_MUTANTS = {
    "xd": [(r"(d\[k\] = )rnd<bf>\(", r"\1(")],
    "radial": [(r"(const float r = )rnd<bf>\((d\[0\] \* d\[0\] \+ "
                r"d\[1\] \* d\[1\] \+ d\[2\] \* d\[2\])\)", r"\1\2")],
    "coord_hidden": [(r"(const float c1 = )rnd<bf>\((p \* s)\)", r"\1\2")],
    "cw": [(r"(ev\[kECw \* kTile \+ m0 \+ fr \+ 8 \* h\] = )rnd<bf>\((cw)\)",
            r"\1\2")],
}
# B3's backward in bf16 (the tensor-core kernel of csrc/egnn_edge_bwd.cu and
# the chain steps it shares with B2 in csrc/egnn_hopper.cuh) with one
# rounding point left out, as B2's table: W1ab, W2, Wc1, a1s and m
# have no mutant (each reaches the tensor cores as a bf16 operand and is
# used nowhere else), nor d_hsd (rounded by its store); d_p2 keeps its
# rounding through db2, d_a1 through d_rad (hence d_xd) and d_ef, d_p3
# through dbc1 (``_assert_edge_bwd_close``).
_EDGE_BWD_MUTANTS = {
    "xd": [(r"(d\[k\] = )rnd<bf>\(", r"\1(")],
    "radial": [(r"(const float r = )rnd<bf>\((d\[0\] \* d\[0\] \+ "
                r"d\[1\] \* d\[1\] \+ d\[2\] \* d\[2\])\)", r"\1\2")],
    "c1": [(r"(const float c1 = )rnd<bf>\((p \* s)\)", r"\1\2")],
    "cw": [(r"(ev\[kECw \* kTile \+ m0 \+ fr \+ 8 \* h\] = )rnd<bf>\((cw)\)",
            r"\1\2")],
    "d_p2": [(r"(const float dp2 = )rnd<bf>\((dm \* g2\[nt\]\[2 \* h \+ c\])\)",
              r"\1\2")],
    "d_a1": [(r"(const float da = )rnd<bf>\((dsum \* g1)\)", r"\1\2")],
    "d_p3": [(r"(gbc1\[2 \* nt\] \+= )__low2float\(q\);", r"\1d3[0];"),
             (r"(gbc1\[2 \* nt \+ 1\] \+= )__high2float\(q\);",
              r"\1d3[1];")],
}
_EDGE_MUTANTS = ([("egnn_edge_fwd.cu", k) for k in sorted(_EDGE_FWD_MUTANTS)]
                 + [("egnn_edge_bwd.cu", k) for k in sorted(_EDGE_BWD_MUTANTS)])


@pytest.mark.cuda
@pytest.mark.parametrize("source,name", _EDGE_MUTANTS)
def test_edge_bf16_bound_sees_every_rounding_point(cuda, source, name,
                                                   tmp_path, monkeypatch,
                                                   restore_kernels):
    inputs = [_edge_args(8, e, f, torch.bfloat16, cuda, seed=e + f)
              for e, f in ((2560, 20), (1408, 64))]
    fwd = source == "egnn_edge_fwd.cu"
    table = _EDGE_FWD_MUTANTS if fwd else _EDGE_BWD_MUTANTS
    _mutant_kernel((source, "egnn_hopper.cuh"), table[name], tmp_path,
                   monkeypatch)
    for args, dout in inputs:
        what = f"B3 {'fwd' if fwd else 'bwd'} {name} E={dout.shape[2]}"
        if fwd:
            out = edge.edge_program_fwd(*args)
            ref = edge.edge_program_reference(*args)
            cpu = _on_cpu(edge.edge_program_reference, *args)
            _mutant_fails_rule(what, kc.edge_checks(out, ref, cpu))
        else:
            out = edge.edge_program_bwd(*args, dout)
            ref = edge.edge_program_bwd_reference(*args, dout)
            cpu = _on_cpu(edge.edge_program_bwd_reference, *args, dout)
            _mutant_fails_rule(what, kc.edge_bwd_checks(args, dout, out, ref,
                                                        cpu))


def _mean_ratios(out, ref):
    """Per output of B3's backward, the worst row's mean|diff| / mean|plain|
    (rows as ``_assert_edge_close`` takes them)."""
    names = ("dhsx", "dhdx", "def", "dw1ab", "dw2", "dwc1", "dsmall")
    ratios = {}
    for name, g, r in zip(names, out, ref):
        g, r = ((_rows(g), _rows(r)) if g.dim() == 3
                else (g.flatten()[None], r.flatten()[None]))
        ratios[name] = ((g - r).abs().mean(1) / r.abs().mean(1)).max().item()
    return ratios


@pytest.mark.cuda
def test_edge_bwd_bf16_bound_sees_the_near_tie_recompute(
        cuda, tmp_path, monkeypatch, restore_kernels):
    """Without the near-tie recompute (csrc/egnn_hopper.cuh), B3's bf16
    backward on test_edge_kernels_match_plain_versions' B=8, E=2560, F=64
    input rounds values near a bf16 tie the other way from the plain
    version, and the chains they move fail the bf16 mean bounds."""
    args, dout = _edge_args(8, 2560, 64, torch.bfloat16, cuda, seed=2624)
    _mutant_kernel("egnn_hopper.cuh", _NO_TIE_RECOMPUTE, tmp_path,
                   monkeypatch)
    out = edge.edge_program_bwd(*args, dout)
    _mutant_fails_rule("B3 bwd without the near-tie recompute",
                       kc.edge_checks(
                           out, edge.edge_program_bwd_reference(*args, dout),
                           _on_cpu(edge.edge_program_bwd_reference, *args,
                                   dout)))


@pytest.mark.cuda
def test_edge_fwd_bf16_bound_sees_the_near_tie_recompute(
        cuda, tmp_path, monkeypatch, restore_kernels):
    """Without the near-tie recompute (csrc/egnn_hopper.cuh), B3's bf16
    forward on a B=1, E=1000, F=64 input rounds values of a1s, m and c1
    near a bf16 tie the other way from the plain version, and the edges
    they move fail the per-row mean bound; with it, the kernel passes. On
    an H100 (scripts/torch_kernel_ties.py --kernel edge_fwd) this input
    read 1.17 of the mean bound without the recompute and 0 with it."""
    args, _ = _edge_args(1, 1000, 64, torch.bfloat16, cuda, seed=5)
    ref = edge.edge_program_reference(*args)
    _assert_edge_close(edge.edge_program_fwd(*args), ref, torch.bfloat16)
    _mutant_kernel("egnn_hopper.cuh", _NO_TIE_RECOMPUTE, tmp_path,
                   monkeypatch)
    out = edge.edge_program_fwd(*args)
    _mutant_fails_rule("B3 fwd without the near-tie recompute",
                       kc.edge_checks(out, ref, _on_cpu(
                           edge.edge_program_reference, *args)))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_EDGE_BWD_MUTANTS))
def test_edge_bwd_smoke_bound_sees_every_rounding_point(
        cuda, name, tmp_path, monkeypatch, restore_kernels):
    """At chip_smoke.py's shape (B=128, E=2560, F=20, bf16) and with its
    checks (the card tests' bounds under the rule, the plain version on the
    CPU its yardstick; dbc1 as above), each backward mutant still fails.
    The per-output mean ratios are printed (pytest -s)."""
    args, dout = _edge_args(128, 2560, 20, torch.bfloat16, cuda, seed=2582)
    ref = edge.edge_program_bwd_reference(*args, dout)
    cpu = _on_cpu(edge.edge_program_bwd_reference, *args, dout)
    _mutant_kernel(("egnn_edge_bwd.cu", "egnn_hopper.cuh"),
                   _EDGE_BWD_MUTANTS[name], tmp_path, monkeypatch)
    out = edge.edge_program_bwd(*args, dout)
    print(f"B3 bwd mutant {name}:", json.dumps(_mean_ratios(out, ref)))
    _mutant_fails_rule(f"B3 bwd {name} B=128",
                       kc.edge_bwd_checks(args, dout, out, ref, cpu))


@pytest.mark.cuda
def test_edge_kernels_reject_what_they_do_not_take(cuda):
    args, dout = _edge_args(2, 128, 20, torch.float32, cuda, seed=2)
    half = [t.half() if t.dim() == 3 else t for t in args]
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        edge.edge_program(*half)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        edge.edge_program_bwd(*half, dout.half())
    strided = list(args)
    strided[0] = args[0].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        edge.edge_program(*strided)
    with pytest.raises(ValueError, match="contiguous"):
        edge.edge_program_bwd(*strided, dout)
    short = list(args)
    short[1] = args[1][:, :, :100].contiguous()
    with pytest.raises(ValueError, match="hdx"):
        edge.edge_program(*short)
    with pytest.raises(ValueError, match="dout"):
        edge.edge_program_bwd(*args, dout[:, :, :100].contiguous())
    wide, _ = _edge_args(2, 128, 65, torch.float32, cuda, seed=2)
    with pytest.raises(ValueError, match="F <= 64"):
        edge.edge_program(*wide)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_layer_gradients_on_card(cuda, dtype, monkeypatch):
    """One EGNN layer through 'fused' (B3 forward and backward, the gathers
    and the aggregation) against the same layer with B3's plain versions:
    one B3 forward and one B3 backward launch; outputs and gradients within
    |diff| <= 1e-4 * max + 1e-3 * |plain| in f32, and a mean ratio of 1e-4
    per tensor in bf16."""
    gen = torch.Generator().manual_seed(11)
    layer = EGNNLayer(20, 64, 64, generator=gen, device=cuda)
    src, dst, mask, ef, h, x = (t.to(cuda) for t in _args(
        4, 1408, 20, 64, torch.float32, "cpu", seed=11)[:6])
    cot_h = torch.randn(4, N, 64, generator=gen).to(cuda, dtype)
    cot_x = torch.randn(4, N, 3, generator=gen).to(cuda, dtype)

    def run(kernels):
        layer.zero_grad()
        hin = h.to(dtype).requires_grad_(True)
        xin = x.to(dtype).requires_grad_(True)
        before = edge.edge_program.launches, edge.edge_program_bwd.launches
        with monkeypatch.context() as m:
            if not kernels:
                # B3's plain versions on CUDA tensors, forward and backward
                m.setattr(edge, "edge_program_fwd",
                          edge.edge_program_reference)
                m.setattr(edge, "edge_program_bwd",
                          edge.edge_program_bwd_reference)
            h2, x2 = egnn_apply(layer, hin, xin, src, dst, ef, mask, "fused")
            ((h2 * cot_h).float().sum()
             + (x2 * cot_x).float().sum()).backward()
        torch.cuda.synchronize()
        launched = (edge.edge_program.launches - before[0],
                    edge.edge_program_bwd.launches - before[1])
        assert launched == ((1, 1) if kernels else (0, 0))
        return [h2.detach(), x2.detach(), hin.grad, xin.grad] + [
            p.grad.clone() for p in layer.parameters()]

    for g, r in zip(run(True), run(False)):
        assert torch.isfinite(g).all()
        g, r = g.float(), r.float()
        if dtype == torch.float32:
            assert ((g - r).abs() <= 1e-4 * r.abs().max()
                    + 1e-3 * r.abs()).all()
        else:
            assert (g - r).abs().mean() <= 1e-4 * r.abs().mean() + 1e-12


# --------------------------------------------------------------------------
# B8: segment scatter and gather
# --------------------------------------------------------------------------

def _assert_scatter_close(out, ref, idx, mask, m):
    """B8's scatter against its plain version (module docstring)."""
    n = out.shape[1]
    assert out.dtype == ref.dtype == m.dtype and out.shape == ref.shape
    assert torch.isfinite(out).all()
    got, want = out.float(), ref.float()
    if m.dtype == torch.float32:
        abs_sum = segment.segment_scatter_reference(idx, mask, m.abs(), n)
        count = segment.segment_scatter_reference(
            idx, mask, torch.ones_like(m[..., :1]), n)
        allowed = 2 * count * 2.0 ** -24 * abs_sum
        assert ((got - want).abs() <= allowed).all()
    else:
        kc.assert_rule([kc.elem_steps_check("scatter", got, want, None)])


def test_segment_plain_versions_skip_what_is_not_valid():
    idx, mask, m, h = _segment_args(2, 128, 16, 5, torch.float32, "cpu", 0)
    out = segment.segment_scatter_reference(idx, mask, m, 16)
    keep = (mask & (idx >= 0) & (idx < 16))[..., None]
    torch.testing.assert_close(out.sum(1), (m * keep).sum(1))
    g = segment.segment_gather_reference(idx, mask, h)
    assert not g[:, :8].any() and torch.equal(g[~keep[..., 0]],
                                              torch.zeros_like(g[~keep[..., 0]]))


@pytest.mark.cuda
@pytest.mark.parametrize("b,e,n,c", [(4, 256, 24, 16), (4, 1000, 40, 67),
                                     (128, 2560, N, 67), (128, 1408, N, 67)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_kernels_match_plain_versions(cuda, b, e, n, c, dtype):
    """Small shapes (E=1000: not a multiple of any tile; C=16: one channel
    block short of 32) and chip_smoke.py's (B=128, N=288, C=67 = H+3)."""
    idx, mask, m, h = _segment_args(b, e, n, c, dtype, cuda, seed=e + c)
    before = segment.segment_scatter.launches, segment.segment_gather.launches
    out = segment.segment_scatter(idx, mask, m, n)
    gat = segment.segment_gather(idx, mask, h)
    torch.cuda.synchronize()
    assert (segment.segment_scatter.launches - before[0],
            segment.segment_gather.launches - before[1]) == (1, 1)
    _assert_scatter_close(out, segment.segment_scatter_reference(
        idx, mask, m, n), idx, mask, m)
    assert gat.dtype == dtype
    assert torch.equal(gat, segment.segment_gather_reference(idx, mask, h))
    assert not gat[:, :8].any()         # masked or out of range: zeros


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_scatter_is_deterministic(cuda, dtype):
    idx, mask, m, _ = _segment_args(128, 2560, N, 67, dtype, cuda, seed=4)
    first = segment.segment_scatter(idx, mask, m, N)
    assert torch.equal(first, segment.segment_scatter(idx, mask, m, N))


@pytest.mark.cuda
def test_segment_out_of_range_indices_touch_nothing(cuda):
    """Every index outside [0, N), masked or not, with NaN messages: the
    scatter writes zeros, the gather reads nothing (zeros)."""
    idx, mask, m, h = _segment_args(4, 512, 24, 16, torch.float32, cuda, 5)
    idx = torch.where(torch.arange(512, device=cuda) % 2 == 0, -7, 24 + 9)
    idx = idx.expand(4, -1).to(torch.int32).contiguous()
    mask = torch.ones_like(mask)
    m = torch.full_like(m, float("nan"))
    assert not segment.segment_scatter(idx, mask, m, 24).any()
    assert not segment.segment_gather(idx, mask, h).any()


@pytest.mark.cuda
def test_segment_scatter_shared_memory_oversize_raises(cuda):
    """The scatter's shared memory grows with E (each CTA sorts its
    graph's edges: 8 B an edge, ``segment_scatter_smem_bytes``); past the
    card's limit it raises before any launch, and at the largest E that
    fits it launches."""
    lib = segment._lib()
    props = torch.cuda.get_device_properties(cuda)
    optin = props.shared_memory_per_block_optin
    r = segment.scatter_range_nodes(24, 1, props.multi_processor_count)
    assert r == 8                       # three ranges: one wave on any card
    fits = max(e for e in range(0, 40000, 8)
               if lib.segment_scatter_smem_bytes(e, r) <= optin)
    idx, mask, m, _ = _segment_args(1, fits, 24, 2, torch.float32, cuda, 6)
    _assert_scatter_close(segment.segment_scatter(idx, mask, m, 24),
                          segment.segment_scatter_reference(idx, mask, m, 24),
                          idx, mask, m)
    idx, mask, m, _ = _segment_args(1, fits + 8, 24, 2, torch.float32, cuda,
                                    6)
    with pytest.raises(ValueError, match="shared memory"):
        segment.segment_scatter(idx, mask, m, 24)


def _cpu(*ts):
    return [t.cpu() for t in ts]


# B, E, N, C: the grids' edges (one graph over many CTAs, more graphs than
# SMs), the entry point's B=25 at E=1280, E=1283 (not a multiple of 8: no
# chunk's run starts on 16 bytes), C=1, 3, 128, N=1, and N=2048 (which the
# first form's shared memory did not take)
_SEGMENT_GRIDS = [(1, 2560, N, 67), (25, 1280, N, 67), (200, 2560, N, 67),
                  (25, 128, N, 3), (8, 1283, N, 67), (25, 1280, N, 1),
                  (25, 1280, N, 128), (8, 128, 1, 67), (2, 128, 2048, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,e,n,c", _SEGMENT_GRIDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_kernels_on_their_grids(cuda, b, e, n, c, dtype):
    """Both kernels at the edges of their grids, the first graph all
    masked and the last on the corpus's layout (its last 40% of edges
    padded to node 0, masked): the scatter bit for bit the CPU plain
    version's (each element summed in edge order) and the same bits twice,
    the gather bit for bit its plain version's."""
    idx, mask, m, h = _segment_args(b, e, n, c, dtype, cuda, seed=b + e + c)
    mask[0] = False
    last_i, last_m = _corpus_layout(idx[-1:], mask[-1:], e - 2 * e // 5)
    idx[-1:], mask[-1:] = last_i, last_m
    before = segment.segment_scatter.launches, segment.segment_gather.launches
    out = segment.segment_scatter(idx, mask, m, n)
    gat = segment.segment_gather(idx, mask, h)
    torch.cuda.synchronize()
    assert (segment.segment_scatter.launches - before[0],
            segment.segment_gather.launches - before[1]) == (1, 1)
    want = segment.segment_scatter_reference(*_cpu(idx, mask, m), n)
    assert out.dtype == dtype and torch.equal(out.cpu(), want)
    assert torch.equal(out, segment.segment_scatter(idx, mask, m, n))
    assert not out[0].any() and not gat[0].any()
    assert torch.equal(gat, segment.segment_gather_reference(idx, mask, h))


@pytest.mark.cuda
@pytest.mark.parametrize("b,e,n,c", _SEGMENT_GRIDS + [(128, 2560, N, 64),
                                                      (128, 2560, N, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rounded_scatter_is_its_plain_version(cuda, b, e, n, c, dtype):
    """B8's scatter with each add rounded (the backward of 'pallas''s
    gathers), on the grids' edges and on the cotangents of a full-width
    'pallas' layer (C=64 of h, 3 of x): bit for bit its plain version on
    the card and on the CPU (both add in edge order, rounding each add),
    the same bits twice, one launch counted as B8's scatter; in f32 the
    plain scatter's bits. In bf16 the scatter that rounds once (the
    kernel without its per-add rounding) parts from it."""
    idx, mask, m, _ = _segment_args(b, e, n, c, dtype, cuda, seed=b + e + c)
    last_i, last_m = _corpus_layout(idx[-1:], mask[-1:], e - 2 * e // 5)
    idx[-1:], mask[-1:] = last_i, last_m
    before = segment.segment_scatter.launches
    out = segment.segment_scatter_rounded(idx, mask, m, n)
    torch.cuda.synchronize()
    assert segment.segment_scatter.launches - before == 1
    want = segment.segment_scatter_rounded_reference(idx, mask, m, n)
    assert out.dtype == dtype and torch.equal(out, want)
    assert torch.equal(out.cpu(), segment.segment_scatter_rounded_reference(
        *_cpu(idx, mask, m), n))
    assert torch.equal(out, segment.segment_scatter_rounded(idx, mask, m, n))
    once = segment.segment_scatter(idx, mask, m, n)
    if dtype == torch.float32:
        assert torch.equal(out, once)
    elif e >= 256:
        assert not torch.equal(out, once)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_scatter_on_the_corpus_layout(cuda, dtype):
    """chip_smoke.py's B=128, E=2560 with 1408 real edges, the rest padded
    to node 0 and masked, as the corpus pads them: node 0 sums its real
    edges alone, bit for bit the CPU plain version."""
    idx, mask, m, h = _segment_args(128, 2560, N, 67, dtype, cuda, seed=9)
    idx, mask = _corpus_layout(idx, mask, 1408)
    out = segment.segment_scatter(idx, mask, m, N)
    want = segment.segment_scatter_reference(*_cpu(idx, mask, m), N)
    assert torch.equal(out.cpu(), want)
    assert torch.equal(segment.segment_gather(idx, mask, h),
                       segment.segment_gather_reference(idx, mask, h))


@pytest.mark.cuda
def test_segment_kernels_reject_what_they_do_not_take(cuda):
    idx, mask, m, h = _segment_args(2, 128, 24, 8, torch.float32, cuda, 7)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        segment.segment_scatter(idx, mask, m.half(), 24)
    with pytest.raises(ValueError, match="idx has dtype"):
        segment.segment_gather(idx.long(), mask, h)
    with pytest.raises(ValueError, match="contiguous"):
        segment.segment_scatter(idx, mask, m.transpose(1, 2).contiguous()
                                .transpose(1, 2), 24)
    with pytest.raises(ValueError, match="mask has shape"):
        segment.segment_gather(idx, mask[:, :64].contiguous(), h)


# the scatter with its sums in the compute dtype: every add rounded
_SEGMENT_MUTANT = [(r"acc\[v\] \+= (val\[u\]\[v\]);",
                    r"acc[v] = to_f<T>(from_f<T>(acc[v] + \1));")]


@pytest.mark.cuda
def test_segment_bf16_bound_sees_f32_accumulation(cuda, tmp_path,
                                                  monkeypatch,
                                                  restore_kernels):
    inputs = [_segment_args(b, e, N, 67, torch.bfloat16, cuda, seed=e)
              for b, e in ((8, 2560), (128, 1408))]
    refs = [segment.segment_scatter_reference(i, k, m, N)
            for i, k, m, _ in inputs]
    _mutant_kernel("segment.cu", _SEGMENT_MUTANT, tmp_path, monkeypatch)
    for (idx, mask, m, _), ref in zip(inputs, refs):
        out = segment.segment_scatter(idx, mask, m, N)
        _mutant_fails_rule(f"B8 scatter bf16 sums E={idx.shape[1]}",
                           [kc.elem_steps_check(
                               "scatter", out, ref,
                               _on_cpu(segment.segment_scatter_reference,
                                       idx, mask, m, N))])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pallas_layer_gradients_on_card(cuda, dtype, monkeypatch):
    """One EGNN layer through 'pallas' (B8's scatter forward, its gather in
    the backward, and its scatter, each add rounded, as the backward of the
    layer's four gathers) against the same layer with B8's plain versions:
    five scatter launches and one gather; outputs and gradients within |diff| <= 1e-4 *
    max + 1e-3 * |plain| in f32. bf16, per tensor: mean|diff| <= 2 * (the
    plain layer's own run-to-run mean|diff|) + 1e-4 * mean|plain|: the plain
    scatter (``index_add_``) sums with atomics on the card, so h's and the
    edge MLP's gradients move from run to run there (the outputs do
    not)."""
    gen = torch.Generator().manual_seed(12)
    layer = EGNNLayer(20, 64, 64, generator=gen, device=cuda)
    src, dst, mask, ef, h, x = (t.to(cuda) for t in _args(
        4, 1408, 20, 64, torch.float32, "cpu", seed=12)[:6])
    cot_h = torch.randn(4, N, 64, generator=gen).to(cuda, dtype)
    cot_x = torch.randn(4, N, 3, generator=gen).to(cuda, dtype)

    def run(kernels):
        layer.zero_grad()
        hin = h.to(dtype).requires_grad_(True)
        xin = x.to(dtype).requires_grad_(True)
        before = (segment.segment_scatter.launches,
                  segment.segment_gather.launches)
        with monkeypatch.context() as mp:
            if not kernels:
                mp.setattr(segment, "segment_scatter",
                           segment.segment_scatter_reference)
                mp.setattr(segment, "segment_gather",
                           segment.segment_gather_reference)
                mp.setattr(segment, "segment_scatter_rounded",
                           segment.segment_scatter_rounded_reference)
            h2, x2 = egnn_apply(layer, hin, xin, src, dst, ef, mask,
                                "pallas")
            ((h2 * cot_h).float().sum()
             + (x2 * cot_x).float().sum()).backward()
        torch.cuda.synchronize()
        launched = (segment.segment_scatter.launches - before[0],
                    segment.segment_gather.launches - before[1])
        assert launched == ((5, 1) if kernels else (0, 0))
        return [h2.detach(), x2.detach(), hin.grad, xin.grad] + [
            p.grad.clone() for p in layer.parameters()]

    for g, r, r2 in zip(run(True), run(False), run(False)):
        assert torch.isfinite(g).all()
        g, r, r2 = g.float(), r.float(), r2.float()
        if dtype == torch.float32:
            assert ((g - r).abs() <= 1e-4 * r.abs().max()
                    + 1e-3 * r.abs()).all()
        else:
            noise = (r2 - r).abs().mean()
            assert (g - r).abs().mean() <= (2 * noise + 1e-4 * r.abs().mean()
                                            + 1e-12)


# --------------------------------------------------------------------------
# B4, B5a, B5b, B6: the 'mega' kernel variants
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("e", [2560, 1408])
@pytest.mark.parametrize("f", [20, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paired_kernel_matches_plain_version(cuda, e, f, dtype):
    args = _paired_args(128, e, f, dtype, cuda, seed=e + f + 2)
    mega.check_paired(*args[:3])
    before = mega.edge_mega_paired_fwd.launches
    out, a1, xd = mega.edge_mega_paired_fwd(*args)
    torch.cuda.synchronize()
    assert mega.edge_mega_paired_fwd.launches == before + 1
    ref, a1_ref, xd_ref = mega.edge_mega_paired_fwd_reference(*args)
    _assert_close(out, ref, dtype)
    _assert_residuals_close((a1, xd), (a1_ref, xd_ref), dtype)
    bare = mega.edge_mega_paired_fwd(*args, residuals=False)[0]
    _assert_close(bare, ref, dtype)
    # B1 on the same batch: the same residuals, bit for bit
    _, a1_b1, xd_b1 = mega.edge_mega_fwd(*args)
    assert torch.equal(a1, a1_b1) and torch.equal(xd, xd_b1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paired_kernel_reads_only_the_arc_half(cuda, dtype):
    """B4 on a batch whose second half breaks the mirror-paired layout:
    its output and residuals those of the layout the arc half implies (the
    plain version's, and B1's residuals on ``mirror_edges`` bit for
    bit)."""
    args = _scrambled_mirror_half(
        _paired_args(8, 2560, 20, dtype, cuda, seed=41), seed=42)
    out, a1, xd = mega.edge_mega_paired_fwd(*args)
    torch.cuda.synchronize()
    ref, a1_ref, xd_ref = mega.edge_mega_paired_fwd_reference(*args)
    _assert_close(out, ref, dtype)
    _assert_residuals_close((a1, xd), (a1_ref, xd_ref), dtype)
    _, a1_b1, xd_b1 = mega.edge_mega_fwd(*mega.mirror_edges(*args[:3]),
                                         *args[3:])
    assert torch.equal(a1, a1_b1) and torch.equal(xd, xd_b1)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 200])
@pytest.mark.parametrize("e", [2560, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paired_kernel_at_the_grid_edges(cuda, b, e, dtype):
    """B4 at one graph (bf16: its arcs over many CTAs, the chunks' node
    blocks summed by a second kernel) and at more graphs than SMs, at an
    E/2 that is a multiple of 32 arcs and one that is not, with the last
    graph all masked when B > 1: output and residuals against the plain
    version's, that graph's exactly zero; the residuals B1's bit for bit."""
    args = _paired_args(b, e, 64, dtype, cuda, seed=b + e + 3)
    if b > 1:
        args[2] = args[2].clone()
        args[2][-1] = False
    out, a1, xd = mega.edge_mega_paired_fwd(*args)
    torch.cuda.synchronize()
    ref, a1_ref, xd_ref = mega.edge_mega_paired_fwd_reference(*args)
    _assert_close(out, ref, dtype)
    _assert_residuals_close((a1, xd), (a1_ref, xd_ref), dtype)
    _, a1_b1, xd_b1 = mega.edge_mega_fwd(*args)
    assert torch.equal(a1, a1_b1) and torch.equal(xd, xd_b1)
    if b > 1:
        for t in (out[-1], a1[-1], xd[-1]):
            assert torch.count_nonzero(t) == 0


# B4's bf16 form (B1's tensor-core kernel of csrc/egnn_mega.cuh with B4's
# tiles and arc geometry, csrc/egnn_mega_paired_fwd.cu) with one bf16
# rounding point left out, as B1's table takes them, or the mirror's sign,
# or the mirror's geometry formed anew from the second half's indices (as
# a kernel that reads the mirror edge would) rather than the arc's negated.
# Each runs on a batch whose second half is scrambled, which B4 never
# reads. The CUDA-core chain of B4's f32 form (csrc/egnn_common.cuh) runs
# in f32 only, held by the f32 bounds.
_PAIRED_SOURCES = ("egnn_mega_paired_fwd.cu", "egnn_mega.cuh")
_PAIRED_MUTANTS = {
    "mirror_sign": [(r"g\.xh\[m \* 3 \+ (\d)\] = -h\1;",
                     r"g.xh[m * 3 + \1] = h\1;")],
    "mirror_anew": [(r"g\.xh\[m \* 3 \+ (\d)\] = -h\1;",
                     r"g.xh[m * 3 + \1] = ok ? rnd<T>("
                     r"to_f(xb[srcb[k + half] * 3 + \1]) - "
                     r"to_f(xb[dstb[k + half] * 3 + \1])) * "
                     r"(1.0f / (sqrtf(r > 0.0f ? r : 1.0f) + 1e-30f)) : 0.0f;")],
    "xd": [(r"rnd<T>\((to_f\(xb\[s \* 3 \+ \d\]\) - to_f\(xb\[d \* 3 \+ "
            r"\d\]\))\)", r"(\1)")],
    "radial": [(r"(r = )rnd<T>\((d0 \* d0 \+ d1 \* d1 \+ d2 \* d2)\)",
                r"\1\2")],
    "weights": [(r"(w1s\[i\] = )rnd<\w+>\((w1ab\[i\])\)", r"\1\2")],
    "m": _MUTANTS["m"],
    "coord_hidden": _MUTANTS["coord_hidden"],
    "cw": [(r"(const float cwb = )rnd<bf>\((cw)\)", r"\1\2")],
    "cw_xhat": [(r"rnd<bf>\((cwb \* g\.xh\[t \* 3 \+ k\])\)", r"(\1)")],
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_PAIRED_MUTANTS))
def test_paired_bf16_bound_sees_every_rounding_point(cuda, name, tmp_path,
                                                     monkeypatch,
                                                     restore_kernels):
    _mutant_kernel(_PAIRED_SOURCES, _PAIRED_MUTANTS[name], tmp_path,
                   monkeypatch)
    for e, f in ((2560, 20), (1408, 64)):
        args = _scrambled_mirror_half(
            _paired_args(8, e, f, torch.bfloat16, cuda, seed=e + f),
            seed=e + f + 1)
        out = mega.edge_mega_paired_fwd(*args, residuals=False)[0]
        _mutant_fails_rule(f"B4 {name} E={e} F={f}", kc.mega_checks(
            "out", out, mega.edge_mega_paired_fwd_reference(*args)[0],
            _on_cpu(mega.edge_mega_paired_fwd_reference, *args)[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("e", [2560, 1408])
@pytest.mark.parametrize("f", [20, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tail_db_kernel_matches_plain_version_and_b2(cuda, e, f, dtype):
    args = _tail_g_args(128, e, f, dtype, cuda, seed=e + f + 3)
    db_args = (args[1], *args[2:])
    before = mega.tail_bwd_db.launches
    out = mega.tail_bwd_db(*db_args)
    torch.cuda.synchronize()
    assert mega.tail_bwd_db.launches == before + 1
    _assert_tail_close(out, mega.tail_bwd_db_reference(*db_args), dtype,
                       _b2_of(*args))
    for got, want in zip(out, mega.tail_bwd(*_b2_of(*args))):
        assert torch.equal(got, want)


def _assert_nodes_close(got, ref, dtype):
    """B5b's d_nodes [B, N, 2(H+3)] f32 (module docstring), per column."""
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    g, r = got.flatten(0, 1).T, ref.flatten(0, 1).T
    if dtype == torch.float32:
        assert ((g - r).abs() <= 1e-5 * r.abs().amax(1, keepdim=True)
                + 1e-4 * r.abs()).all()
        return
    kc.assert_rule(kc.nodes_checks(got, ref))


TAIL_MEAN, TAIL_MAX_EDGE = 2e-5, 1.6e-2


@pytest.mark.cuda
@pytest.mark.parametrize("e", [2560, 1408])
@pytest.mark.parametrize("f", [20, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tail_nodes_kernel_matches_plain_version(cuda, e, f, dtype):
    args = _tail_g_args(128, e, f, dtype, cuda, seed=e + f + 4)
    before = mega.tail_bwd_nodes.launches
    out = mega.tail_bwd_nodes(*args)
    torch.cuda.synchronize()
    assert mega.tail_bwd_nodes.launches == before + 1
    ref = mega.tail_bwd_nodes_reference(*args)
    _assert_nodes_close(out[0], ref[0], dtype)
    # d_ef and the weight gradients as B2's (zeros stand in for d_cat)
    fake = torch.zeros(128, 67, e, dtype=dtype, device=cuda)
    _assert_tail_close((fake, *out[1:]), (fake, *ref[1:]), dtype)
    # the same bits twice: no atomics
    again = mega.tail_bwd_nodes(*args)
    for g, h in zip(out, again):
        assert torch.equal(g, h)


# the shared tail body (csrc/egnn_tail.cuh, egnn_hopper.cuh) with one
# rounding point left out, built through B5a (B2's table); B5b's own point, d_xd before the node
# sums (B2 and B5a round d_xd again at its store)
_TAIL_G_MUTANTS = {k: _TAIL_MUTANTS[k] for k in ("d_p2", "d_a1")}
_NODES_MUTANTS = {
    "d_xd": [(r"(ev\[\(kEDxd \+ k\) \* kTile \+ t\] = )rnd<bf>\((dx\[k\])\)",
              r"\1\2")],
}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,name", [("db", k) for k in
                                         sorted(_TAIL_G_MUTANTS)]
                         + [("nodes", k) for k in sorted(_NODES_MUTANTS)])
def test_tail_variant_bf16_bound_sees_rounding_points(cuda, kernel, name,
                                                      tmp_path, monkeypatch,
                                                      restore_kernels):
    inputs = [_tail_g_args(8, e, f, torch.bfloat16, cuda, seed=e + f + 5)
              for e, f in ((2560, 20), (1408, 64))]
    table = _TAIL_G_MUTANTS if kernel == "db" else _NODES_MUTANTS
    _mutant_kernel(_TAIL_SOURCES, table[name], tmp_path, monkeypatch)
    for args in inputs:
        what = f"B5{'a' if kernel == 'db' else 'b'} {name} E={args[3].shape[1]}"
        if kernel == "db":
            db_args = (args[1], *args[2:])
            out = mega.tail_bwd_db(*db_args)
            _mutant_fails_rule(what, kc.tail_checks(
                out, mega.tail_bwd_db_reference(*db_args),
                _on_cpu(mega.tail_bwd_db_reference, *db_args)))
        else:
            out = mega.tail_bwd_nodes(*args)
            _mutant_fails_rule(what, kc.nodes_checks(
                out[0], mega.tail_bwd_nodes_reference(*args)[0],
                _on_cpu(mega.tail_bwd_nodes_reference, *args)[0]))


def _tail_cases(args):
    """(kernel, plain version, operands) of B2, B5a and B5b on B5's
    operands."""
    return ((mega.tail_bwd, mega.tail_bwd_reference, _b2_of(*args)),
            (mega.tail_bwd_db, mega.tail_bwd_db_reference,
             (args[1], *args[2:])),
            (mega.tail_bwd_nodes, mega.tail_bwd_nodes_reference, tuple(args)))


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 200])
@pytest.mark.parametrize("e", [2560, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tail_kernels_at_the_grid_edges(cuda, b, e, dtype):
    """B2, B5a and B5b at one graph (its edges split over many CTAs) and at
    more graphs than SMs (one CTA each), at an E that is a multiple of 64
    and one that is not, with the last graph all masked when B > 1: each
    against its plain version, that graph's d_cat, d_ef and node sums
    exactly zero, the same bits twice."""
    args = list(_tail_g_args(b, e, 20, dtype, cuda, seed=b + e))
    if b > 1:
        args[2] = args[2].clone()
        args[2][-1] = False
    for fn, plain, operands in _tail_cases(args):
        out = fn(*operands)
        torch.cuda.synchronize()
        ref = plain(*operands)
        if fn is mega.tail_bwd_nodes:
            _assert_nodes_close(out[0], ref[0], dtype)
            fake = torch.zeros(b, 67, e, dtype=dtype, device=cuda)
            _assert_tail_close((fake, *out[1:]), (fake, *ref[1:]), dtype,
                               _b2_of(*args))
        else:
            _assert_tail_close(out, ref, dtype, _b2_of(*args))
        if b > 1:
            assert torch.count_nonzero(out[0][-1]) == 0
            assert torch.count_nonzero(out[1][-1]) == 0
        again = fn(*operands)
        for g, h in zip(out, again):
            assert torch.equal(g, h)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tail_kernels_all_masked_give_zeros(cuda, dtype):
    """No valid edge: every output of B2, B5a and B5b is exactly zero, with
    NaN in the residuals that are never read."""
    args = list(_tail_g_args(3, 1000, 20, dtype, cuda, seed=9,
                             mask_rate=1.0))
    args[7] = torch.full_like(args[7], float("nan"))
    args[8] = torch.full_like(args[8], float("nan"))
    for fn, _, operands in _tail_cases(args):
        for t in fn(*operands):
            assert torch.count_nonzero(t) == 0


def _assert_agg_steps_close(got, ref):
    """B6's aggregate, rounded to bf16 by kernel and plain version alike:
    per column (over graphs and nodes) max|diff| <= one bf16 step at the
    column's largest |plain| and mean|diff| <= 1e-4 * mean|plain|."""
    kc.assert_rule(kc.col_steps_checks("agg", got, ref, None))


def _assert_stack_layers_close(out, args, packed, dtype):
    """Each layer of B6's outputs against the plain version of that layer
    run from the kernel's own previous h and x (module docstring)."""
    h, x, hs, xs, aggs, a1s, xds = out
    if dtype == torch.bfloat16:
        for t in (hs, xs, aggs, a1s, xds):
            assert torch.isfinite(t).all()
        kc.assert_rule(kc.stack_checks(out, args, packed))
        return
    assert torch.equal(h, hs[:, -1]) and torch.equal(x, xs[:, -1])
    src, dst, mask, ef, h0, x0 = args
    for layer, weights in enumerate(packed):
        h_in = h0 if layer == 0 else hs[:, layer - 1]
        x_in = x0 if layer == 0 else xs[:, layer - 1]
        ref = stack.stack_fwd_reference(src, dst, mask, ef, h_in, x_in,
                                        [weights])
        got = [t[:, layer] for t in (hs, xs, aggs, a1s, xds)]
        want = [t[:, 0] for t in ref[2:]]
        for g in got:
            assert torch.isfinite(g).all()
        _assert_residuals_close(got[3:], want[3:], dtype)
        for g, w in zip(got[:3], want[:3]):
            torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("e", [2560, 1408])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stack_kernel_matches_plain_version(cuda, e, dtype):
    args, packed = _stack_args(128, e, dtype, cuda, seed=e + 6)
    before = stack.stack_fwd.launches
    out = stack.stack_fwd(*args, packed)
    torch.cuda.synchronize()
    assert stack.stack_fwd.launches == before + 1
    _assert_stack_layers_close(out, args, packed, dtype)
    h, x = stack.stack_fwd(*args, packed, residuals=False)[:2]
    if dtype == torch.float32:
        torch.testing.assert_close(h, out[0], atol=1e-5, rtol=1e-4)
        torch.testing.assert_close(x, out[1], atol=1e-5, rtol=1e-4)


@pytest.mark.cuda
def test_stack_kernel_shared_memory_oversize_raises(cuda):
    args, packed = _stack_args(2, 256, torch.float32, cuda, seed=7)
    big = [args[0], args[1], args[2], args[3],
           torch.zeros(2, 400, 20, device=cuda),
           torch.zeros(2, 400, 3, device=cuda)]
    with pytest.raises(ValueError, match="shared memory"):
        stack.stack_fwd(*big, packed)


# B6's bf16 form (csrc/egnn_stack_fwd.cu, and B1's tensor-core body and
# geometry that it runs layer by layer: csrc/egnn_mega.cuh,
# csrc/egnn_common.cuh) with one bf16 rounding point left out. pa/pb,
# silu(a1), hmid and h have no mutant: each reaches only bf16 storage (the
# projections' scratch, an mma operand, the hmid tile, the resident h and
# its residual), whose store rounds it, so no edit of the arithmetic
# removes it; nor x (resident in bf16), nor W2, Wc1 and the node MLP's
# weights (bf16 operands). The f32 form's CUDA-core chain runs in f32 only.
# hmid and h have a near-tie recompute, and a test without it below.
_STACK_SOURCES = ("egnn_stack_fwd.cu", "egnn_mega.cuh", "egnn_common.cuh")
_STACK_MUTANTS = {
    "w1ab": [(r"(w1s\[i\] = )rnd<bf>\((w1ab\[i\])\)", r"\1\2")],
    "xd": _MUTANTS["xd"],
    "radial": _MUTANTS["radial"],
    "m": _MUTANTS["m"],
    "coord_hidden": _MUTANTS["coord_hidden"],
    "cw": _MUTANTS["cw"],
    "cw_xhat": _MUTANTS["cw_xhat"],
    "agg": [(r"(const float v = )rnd<bf>\((acc\[i\])\)", r"\1\2")],
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_STACK_MUTANTS))
def test_stack_bf16_bound_sees_every_rounding_point(cuda, name, tmp_path,
                                                    monkeypatch,
                                                    restore_kernels):
    inputs = [_stack_args(8, e, torch.bfloat16, cuda, seed=e + 8)
              for e in (2560, 1408)]
    _mutant_kernel(_STACK_SOURCES, _STACK_MUTANTS[name], tmp_path,
                   monkeypatch)
    for args, packed in inputs:
        out = stack.stack_fwd(*args, packed)
        _mutant_fails_rule(f"B6 {name} E={args[0].shape[1]}",
                           kc.stack_checks(out, args, packed, cpu=True))


@pytest.mark.cuda
def test_stack_bf16_bound_sees_the_near_tie_recompute(cuda, tmp_path,
                                                      monkeypatch,
                                                      restore_kernels):
    """Without the near-tie recompute of its node MLP (csrc/egnn_hopper.cuh
    kTieUlps), one h of ``test_stack_kernel_at_the_grid_edges``' bf16 B=1,
    E=1000 input (the graph's edges all masked) rounds one step off the
    plain version's in a column of small mean, past the per-column mean
    bound (an H100 run)."""
    args, packed = _stack_args(1, 1000, torch.bfloat16, cuda, seed=1047)
    args[2][-1] = False
    _mutant_kernel("egnn_hopper.cuh", _NO_TIE_RECOMPUTE, tmp_path,
                   monkeypatch)
    out = stack.stack_fwd(*args, packed)
    _mutant_fails_rule("B6 without the near-tie recompute",
                       kc.stack_checks(out, args, packed, cpu=True))


def _smoke_b1_case():
    (case,) = [c for c in kc.cases("B6") if c.shape.get("smoke")]
    return case


@pytest.mark.cuda
def test_stack_kernel_meets_the_rule_on_chip_smokes_b1_row(cuda):
    """chip_smoke.py's B6 row at B=1 (E=2560, seed 2566; kernel_checks'
    named case) within the rule, the plain version run on the CPU on every
    unit its yardstick. Before B1's body recomputed its edge chain's
    near-tie roundings and the plain version summed in the kernels' order,
    layer 1's h, column 0 read 1.2477 of its bound there and the CPU 0.8795
    (an H100 run)."""
    r = kc.run_case(_smoke_b1_case(), cuda, "all")
    assert r["ok"], r["failing"]


@pytest.mark.cuda
def test_stack_bf16_rule_sees_the_edge_chain_recompute(cuda, tmp_path,
                                                       monkeypatch,
                                                       restore_kernels):
    """Without its edge chain's near-tie recompute (B1's body as it was:
    _NO_EDGE_RECOMPUTE), B6 on a B=1, E=2560 graph (seed 352) rounds a1s
    and m otherwise than the plain version where they lie near a bf16 tie,
    and layer 4's h, column 18 fails the per-column mean bound (3.595 of
    what the rule allows, an H100 run, where 62 of 452 B=1 inputs fail)."""
    args, packed = _stack_args(1, 2560, torch.bfloat16, cuda, seed=352)
    _mutant_kernel("egnn_mega.cuh", _NO_EDGE_RECOMPUTE, tmp_path,
                   monkeypatch)
    out = stack.stack_fwd(*args, packed)
    _mutant_fails_rule("B6 without the edge chain's near-tie recompute",
                       kc.stack_checks(out, args, packed, cpu=True))


@pytest.mark.cuda
def test_stack_b1_row_fails_with_both_faults(cuda, tmp_path, monkeypatch,
                                             restore_kernels):
    """chip_smoke.py's B6 row at B=1 as it was judged before it was
    repaired: B1's body without its edge chain's near-tie recompute, against
    the plain version that summed with cuBLAS and atomics
    (unordered_plain), fails the rule at layer 1's h, column 0, where the
    CPU meets the bound. With either repair alone the row meets it: the
    body's recompute against that plain version, and the body without it
    against the plain version in the kernels' order (H100 runs)."""
    case = _smoke_b1_case()
    args, packed = _stack_args(1, 2560, torch.bfloat16, cuda, seed=case.seed)
    repaired = stack.stack_fwd(*args, packed)
    with unordered_plain():
        assert kc.judge(kc.stack_checks(repaired, args, packed,
                                        cpu=True))["ok"]
    _mutant_kernel("egnn_mega.cuh", _NO_EDGE_RECOMPUTE, tmp_path,
                   monkeypatch)
    out = stack.stack_fwd(*args, packed)
    assert kc.judge(kc.stack_checks(out, args, packed, cpu=True))["ok"]
    with unordered_plain():
        v = kc.judge(kc.stack_checks(out, args, packed, cpu=True))
    assert not v["ok"] and v["failing"][0][:2] == ("layer 1 h mean", [0]), v


_VARIANT_LAUNCHES = {                   # per train step of six layers
    "hybrid": dict(B1=6, B2=6, B8_scatter=12),
    "dboth": dict(B1=6, B5a=6, B8_scatter=12),
    "inkernel": dict(B1=6, B5b=6), "paired": dict(B4=6, B2=6, B8_scatter=12),
    "stack": dict(B6=1, B2=6, B8_scatter=12),
}


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(_VARIANT_LAUNCHES))
def test_variant_train_step_launches_its_kernels(cuda, variant):
    """One bf16 training step of full-width HybridModelv2 at B=16 on a
    mirror-paired batch: the variant's kernels and no other (B8's scatter
    sums the node gradients of every backward but B5b's), a finite loss and
    finite gradients."""
    from immunostruct_tpu_torch.cli.race_kernel_variants import read_counts

    _, model = build_model("HybridModelv2", 20 * 21,
                           torch.Generator().manual_seed(0), device=cuda)
    trainer = Trainer(model.spec, LossConfig(20 * 21, 1.0), binary=True,
                      optimizer=make_optimizer("adam", constant_lr(1e-3)),
                      aggregation="mega", compute_dtype=torch.bfloat16,
                      mega_variant=variant)
    state = trainer.init_state(model)
    batch = build_batch(16, N, 1408, 20, paired=True, device=cuda)
    before = read_counts()
    state, loss = trainer.train_step(state, batch, seed=0)
    torch.cuda.synchronize()
    launched = {k: n - before[k] for k, n in read_counts().items()
                if n != before[k]}
    assert launched == _VARIANT_LAUNCHES[variant]
    assert torch.isfinite(loss)
    for p in model.parameters():
        assert torch.isfinite(p.grad).all() and torch.isfinite(p).all()


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["paired", "stack"])
def test_variant_forward_matches_scatter_on_card(cuda, variant):
    """A forward with no gradient (serving) under the variant against
    'scatter' in f32 (TF32 off)."""
    _, model = build_model("HybridModelv2", 20 * 21,
                           torch.Generator().manual_seed(0), device=cuda)
    b = build_batch(16, N, 1408, 20, paired=True, device=cuda)
    eps = torch.randn(16, 32, generator=torch.Generator().manual_seed(2))
    outs = {}
    for agg, v in (("mega", variant), ("scatter", "hybrid")):
        with torch.inference_mode():
            outs[agg] = model_apply(model, b.graph, b.seq_onehot, b.props,
                                    deterministic=True, aggregation=agg,
                                    eps=eps.to(cuda), mega_variant=v)
    for name in ("logits", "embedding", "attention"):
        torch.testing.assert_close(getattr(outs["mega"], name),
                                   getattr(outs["scatter"], name),
                                   atol=1e-4, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["dboth", "inkernel", "paired"])
def test_variant_layer_gradients_match_scatter_on_card(cuda, variant):
    """One EGNN layer under the variant against autograd through 'scatter'
    in f32: gradients within 1e-4 * max + 1e-3 * |scatter|."""
    gen = torch.Generator().manual_seed(9)
    layer = EGNNLayer(20, 64, 64, generator=gen, device=cuda)
    src, dst, mask, ef, h, x = _paired_args(4, 1408, 20, torch.float32,
                                            "cpu", seed=9)[:6]
    src, dst = src.clamp(0, N - 1), dst.clamp(0, N - 1)     # 'scatter' indexes
    src, dst, mask, ef, h, x = (t.to(cuda) for t in (src, dst, mask, ef, h, x))
    cot_h = torch.randn(4, N, 64, generator=gen).to(cuda)
    cot_x = torch.randn(4, N, 3, generator=gen).to(cuda)
    grads = {}
    for agg, v in (("mega", variant), ("scatter", "hybrid")):
        layer.zero_grad()
        hin, xin = h.clone().requires_grad_(True), x.clone().requires_grad_(True)
        h2, x2 = egnn_stack_apply([layer], hin, xin, src, dst, ef, mask, agg,
                                  v)
        ((h2 * cot_h).sum() + (x2 * cot_x).sum()).backward()
        grads[agg] = [hin.grad, xin.grad] + [
            p.grad.clone() for p in layer.parameters()]
    for g, r in zip(grads["mega"], grads["scatter"]):
        assert ((g - r).abs() <= 1e-4 * r.abs().max() + 1e-3 * r.abs()).all()


# --------------------------------------------------------------------------
# B7: one whole EGNN layer, forward only (csrc/egnn_layer_fwd.cu)
# --------------------------------------------------------------------------

from immunostruct_tpu_torch.ops import fused_layer  # noqa: E402

B7_BF16_COL_MEAN = 1e-4         # h', x' per column, bf16 (module docstring)


def _assert_b7_close(out, ref, dtype):
    """h' and x' against the plain version: f32 atol=1e-5, rtol=1e-4; bf16
    per column (over graphs and nodes) max|diff| within one bf16 step at
    the column's largest |plain| and mean|diff| <= B7_BF16_COL_MEAN *
    mean|plain| (``_assert_agg_steps_close``, B6's form)."""
    for got, want in zip(out, ref):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.isfinite(got).all()
        if dtype == torch.float32 and got.dtype == torch.float32:
            torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)
            continue
        kc.assert_rule(kc.col_steps_checks("b7", got, want, None,
                                           B7_BF16_COL_MEAN))


@pytest.mark.cuda
@pytest.mark.parametrize("e", [2560, 1408, 256])
@pytest.mark.parametrize("f", [20, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_layer_kernel_matches_plain_version(cuda, e, f, dtype):
    layer, args = _b7_args(128, e, f, dtype, cuda, seed=e + f + 7)
    before = fused_layer.fused_egnn_layer.launches
    with torch.no_grad():
        out = fused_layer.fused_egnn_layer(layer, *args)
        torch.cuda.synchronize()
        assert fused_layer.fused_egnn_layer.launches == before + 1
        _assert_b7_close(out, fused_layer.fused_egnn_layer_reference(
            layer, *args), dtype)
        # no atomics: the same bits every run
        again = fused_layer.fused_egnn_layer(layer, *args)
    for a, b in zip(out, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_fused_layer_kernel_keeps_f32_coordinates(cuda):
    """bf16 features over f32 coordinates: x' comes back f32."""
    layer, args = _b7_args(16, 1408, 20, torch.bfloat16, cuda, seed=3,
                           x_dtype=torch.float32)
    with torch.no_grad():
        out = fused_layer.fused_egnn_layer(layer, *args)
        ref = fused_layer.fused_egnn_layer_reference(layer, *args)
    assert out[1].dtype == torch.float32
    _assert_b7_close(out, ref, torch.bfloat16)


@pytest.mark.cuda
def test_fused_layer_kernel_all_edges_masked(cuda):
    """Nothing is summed: x' is x, h' the node MLP of (h, 0)."""
    layer, args = _b7_args(4, 256, 20, torch.float32, cuda, seed=4,
                           mask_rate=1.0)
    args[4][:] = False
    with torch.no_grad():
        h2, x2 = fused_layer.fused_egnn_layer(layer, *args)
        ref = fused_layer.fused_egnn_layer_reference(layer, *args)
    assert torch.equal(x2, args[1])
    torch.testing.assert_close(h2, ref[0], atol=1e-5, rtol=1e-4)


@pytest.mark.cuda
def test_fused_layer_kernel_raises(cuda):
    layer, args = _b7_args(2, 256, 20, torch.float32, cuda, seed=5)
    big = [torch.zeros(2, 400, 64, device=cuda),
           torch.zeros(2, 400, 3, device=cuda), *args[2:]]
    wide = EGNNLayer(64, 64, 64, generator=torch.Generator().manual_seed(0),
                     device=cuda)
    with torch.no_grad(), pytest.raises(ValueError, match="shared memory"):
        fused_layer.fused_egnn_layer(wide, *big)
    narrow = EGNNLayer(20, 32, 32, generator=torch.Generator().manual_seed(0),
                       device=cuda)
    with torch.no_grad(), pytest.raises(ValueError, match="H=64"):
        fused_layer.fused_egnn_layer(narrow, *args)
    with pytest.raises(ValueError, match="forward only"):
        fused_layer.fused_egnn_layer(layer, *args)


# B7's tensor-core form (csrc/egnn_layer_fwd.cu) with one bf16 rounding
# point of the 'mega' forward (B1's, then the node update's) left out.
# silu(z1), the src projection (held packed), agg, a and h' have no mutant:
# each reaches only bf16 storage (an mma operand, a packed register, the A
# tile, the a tile, h'), whose store rounds it. m and c1 drop their
# rounding where no near-tie recompute takes them (all but ~0.1%).
_B7_MUTANTS = {
    "x_cast": [(r"(\? )rnd<bf>\((to_f\(xb\[i\]\))\)", r"\1\2")],
    "x_diff": [(r"(const float d(\d) = )rnd<bf>\((__fsub_rn\(xc\[s \* 3 "
                r"\+ \d\], xc\[d \* 3 \+ \d\]\))\);", r"\1\3;")],
    "radial": [(r"(const float r = )rnd<bf>\((__fadd_rn\(\s*__fadd_rn\("
                r"__fmul_rn\(d0, d0\), __fmul_rn\(d1, d1\)\), "
                r"__fmul_rn\(d2, d2\)\))\);", r"\1\2;")],
    "projection": [(r"__fadd_rn\(pav, rnd<bf>\((pbv)\)\)",
                    r"__fadd_rn(pav, \1)")],
    "m": [(r"(const float mv = )rnd<bf>\((v)\)", r"\1\2")],
    "c1": [(r"(const float c1 = )rnd<bf>\((v)\)", r"\1\2")],
    "cw": [(r"rnd<bf>\((sum4\(part\[hh\]\))\)", r"\1")],
    "msg_x": [(r"rnd<bf>\((__fmul_rn\(cw, g\.xh\[t \* 3 \+ k\]\))\)",
               r"\1")],
    "x_agg": [(r"(to_f\(xb\[node \* 3 \+ k\]\) \+ )rnd<bf>\((accx)\)",
               r"\1\2")],
    "zn": [(r"\n\s*zn = rnd<bf>\(zn\);", "")],
    "a": [(r"rnd<T>\(expf\(-v\)\)", "expf(-v)")],
    "x_own_dtype": [(r"from_f<XT>\(to_f\(xb\[node \* 3 \+ k\]\) \+ "
                     r"(rnd<bf>\(accx\))\)",
                     r"from_f<XT>(xc[node * 3 + k] + \1)")],
}


def _clear_b7():
    _build.load_library.cache_clear()
    fused_layer._lib.cache_clear()


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_B7_MUTANTS))
def test_fused_layer_bf16_bound_sees_every_rounding_point(cuda, name,
                                                          tmp_path,
                                                          monkeypatch):
    """Each mutant fails the bf16 bound. The x cast and x' from x's own
    dtype only show with coordinates that are not already bf16: those two
    run bf16 features over f32 coordinates. c1, cw, msg_x and x_agg reach
    x' only through x_agg: those run coordinates at 1/16 scale (module
    docstring)."""
    x_dtype = torch.float32 if name in ("x_cast", "x_own_dtype") else None
    x_scale = 1 / 16 if name in ("c1", "cw", "msg_x", "x_agg") else 1.0
    inputs = [_b7_args(32, e, f, torch.bfloat16, cuda, seed=e + f,
                       x_dtype=x_dtype, x_scale=x_scale)
              for e, f in ((2560, 20), (1408, 64))]
    _mutant_kernel("egnn_layer_fwd.cu", _B7_MUTANTS[name], tmp_path,
                   monkeypatch)
    fused_layer._lib.cache_clear()
    try:
        for layer, args in inputs:
            with torch.no_grad():
                out = fused_layer.fused_egnn_layer(layer, *args)
                ref = fused_layer.fused_egnn_layer_reference(layer, *args)
                cpu = kc.on("cuda", fused_layer.fused_egnn_layer_reference(
                    copy.deepcopy(layer).cpu(), *kc.on("cpu", args)))
            _mutant_fails_rule(f"B7 {name} E={args[2].shape[1]}",
                               kc.b7_checks(out, ref, cpu))
    finally:
        monkeypatch.undo()
        _clear_b7()


@pytest.mark.cuda
def test_fused_stack_forward_matches_scatter_and_launches_b7(cuda):
    """model_apply(fused_stack=True), f32: 6 B7 launches and no other
    kernel, the outputs within atol=1e-4, rtol=1e-3 of 'scatter'."""
    from immunostruct_tpu_torch.cli.race_kernel_variants import read_counts

    _, model = build_model("HybridModelv2", 20 * 21,
                           torch.Generator().manual_seed(0), device=cuda)
    b = random_sample_batch(16, N, 1408, 20, seed=2, device=cuda)
    eps = torch.randn(16, 32, generator=torch.Generator().manual_seed(2))
    outs = {}
    for fused in (True, False):
        before = read_counts()
        with torch.inference_mode():
            outs[fused] = model_apply(
                model, b.graph, b.seq_onehot, b.props, deterministic=True,
                aggregation="auto" if fused else "scatter",
                eps=eps.to(cuda), fused_stack=fused)
        launched = {k: n - before[k] for k, n in read_counts().items()
                    if n != before[k]}
        assert launched == ({"B7": 6} if fused else {})
    for name in ("logits", "embedding", "attention"):
        torch.testing.assert_close(getattr(outs[True], name),
                                   getattr(outs[False], name),
                                   atol=1e-4, rtol=1e-3)


@pytest.mark.cuda
def test_paired_forward_and_step_make_no_host_sync(cuda):
    """Under mega_variant='paired' neither a forward nor a train step waits
    for the device (torch.cuda.set_sync_debug_mode('error') raises on any
    synchronising call)."""
    _, model = build_model("HybridModelv2", 20 * 21,
                           torch.Generator().manual_seed(0), device=cuda)
    batch = build_batch(16, N, 1408, 20, paired=True, device=cuda)
    trainer = Trainer(model.spec, LossConfig(20 * 21, 1.0), binary=True,
                      optimizer=make_optimizer("adam", constant_lr(1e-3)),
                      aggregation="mega", compute_dtype=torch.bfloat16,
                      mega_variant="paired")
    state = trainer.init_state(model)
    eps = torch.randn(16, 32, generator=torch.Generator().manual_seed(1),
                      device="cpu").to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode():
            out = model_apply(model, batch.graph, batch.seq_onehot,
                              batch.props, deterministic=True,
                              aggregation="mega", eps=eps,
                              compute_dtype=torch.bfloat16,
                              mega_variant="paired")
        state, loss = trainer.train_step(state, batch, seed=0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(out.logits).all() and torch.isfinite(loss)


@pytest.mark.cuda
@pytest.mark.parametrize("aggregation", ["onehot", "onehot_remat"])
def test_onehot_layers_match_scatter_on_card(cuda, aggregation):
    """Two layers under 'onehot'/'onehot_remat' against 'scatter' in f32
    (TF32 off): outputs atol=1e-5, rtol=1e-4; gradients within 1e-4 * max
    + 1e-3 * |scatter|."""
    gen = torch.Generator().manual_seed(11)
    layers = egnn_stack(1, 20, 64, generator=gen, device=cuda)
    src, dst, mask, ef, h, x = _args(4, 1408, 20, 64, torch.float32, "cpu",
                                     seed=11)[:6]
    src, dst, mask, ef, h, x = (t.to(cuda) for t in (src, dst, mask, ef, h,
                                                       x))
    cot = torch.randn(4, N, 64, generator=gen).to(cuda)
    res = {}
    for agg in (aggregation, "scatter"):
        for p in layers:
            p.zero_grad()
        hin = h.clone().requires_grad_(True)
        h2, x2 = egnn_stack_apply(layers, hin, x, src, dst, ef, mask, agg)
        ((h2 * cot).sum() + x2.sum()).backward()
        res[agg] = [h2.detach(), x2.detach(), hin.grad] + [
            p.grad.clone() for p in layers.parameters()]
    for got, want in zip(res[aggregation][:2], res["scatter"][:2]):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)
    for got, want in zip(res[aggregation][2:], res["scatter"][2:]):
        assert ((got - want).abs() <= 1e-4 * want.abs().max()
                + 1e-3 * want.abs()).all()


# --------------------------------------------------------------------------
# Same seed, same bits: every kernel and the glue repeat on the card
# --------------------------------------------------------------------------

def _assert_same_bits(first, again, what=""):
    assert len(first) == len(again)
    for i, (a, b) in enumerate(zip(first, again)):
        assert (a is None) == (b is None), (what, i)
        if a is not None:
            assert torch.equal(a, b), (what, i)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 8, 128])
@pytest.mark.parametrize("paired", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_kernels_repeat(cuda, b, paired, dtype):
    """B1 (paired False) and B4 (True), with their residuals: two launches
    on the same inputs give the same bits (each (n, c) an f32 sum in one
    fixed order, no atomics; at B=1 and 8 the chunks' node blocks summed in
    chunk order)."""
    make = _paired_args if paired else functools.partial(_args, hid=64)
    args = make(b, 2560, 20, dtype=dtype, device=cuda, seed=b + 40)
    fwd = mega.edge_mega_paired_fwd if paired else mega.edge_mega_fwd
    _assert_same_bits(fwd(*args), fwd(*args), "B4" if paired else "B1")


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 8, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stack_kernel_repeats(cuda, b, dtype):
    """B6, six layers with their residuals, twice: the same bits."""
    args, packed = _stack_args(b, 2560, dtype, cuda, seed=b + 41)
    _assert_same_bits(stack.stack_fwd(*args, packed),
                      stack.stack_fwd(*args, packed), "B6")


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 8, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_layer_kernel_repeats(cuda, b, dtype):
    """B7 twice (at B=1 and 8 a graph over a cluster of CTAs, whose node
    blocks meet in rank order): the same bits."""
    layer, args = _b7_args(b, 2560, 64, dtype, cuda, seed=b + 42)
    with torch.no_grad():
        _assert_same_bits(fused_layer.fused_egnn_layer(layer, *args),
                          fused_layer.fused_egnn_layer(layer, *args), "B7")


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 8, 128])
@pytest.mark.parametrize("backward", ["hybrid", "dboth"])
def test_edge_half_backward_glue_repeats(cuda, b, backward):
    """The 'hybrid' and 'dboth' backward, whose node sums by src and by dst
    go through B8's scatter: twice on the same residuals and cotangent,
    the same bits (bf16)."""
    args = _args(b, 2560, 20, 64, torch.bfloat16, cuda, seed=b + 43)
    src, dst, mask, ef, h, x, w1ab, w2, wc1, small = args
    _, a1, xd = mega.edge_mega_fwd(*args)
    valid = mega.valid_edges(src, dst, mask, N)
    g = torch.randn(b, N, 67, generator=torch.Generator().manual_seed(b)
                    ).to(cuda)

    def run():
        return mega.edge_half_bwd(src, dst, valid, ef, h, x, w1ab, w2, wc1,
                                  small, a1, xd, g, backward)

    _assert_same_bits(run(), run(), backward)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 8, 128])
@pytest.mark.parametrize("aggregation", ["fused", "pallas"])
def test_layer_glue_repeats(cuda, b, aggregation):
    """One bf16 layer through 'fused' (its aggregation and its gathers'
    backward through B8's scatter) or 'pallas' (its gathers' backward
    through B8's scatter), forward and backward twice: the same bits."""
    gen = torch.Generator().manual_seed(b + 44)
    layer = EGNNLayer(20, 64, 64, generator=gen, device=cuda)
    src, dst, mask, ef, h, x = (t.to(cuda) for t in _args(
        b, 2560, 20, 64, torch.float32, "cpu", seed=b + 44)[:6])
    cot_h = torch.randn(b, N, 64, generator=gen).to(cuda, torch.bfloat16)
    cot_x = torch.randn(b, N, 3, generator=gen).to(cuda, torch.bfloat16)

    def run():
        layer.zero_grad()
        hin = h.to(torch.bfloat16).requires_grad_(True)
        xin = x.to(torch.bfloat16).requires_grad_(True)
        h2, x2 = egnn_apply(layer, hin, xin, src, dst,
                            ef.to(torch.bfloat16), mask, aggregation)
        ((h2 * cot_h).float().sum() + (x2 * cot_x).float().sum()).backward()
        return [h2.detach(), x2.detach(), hin.grad, xin.grad] + [
            p.grad.clone() for p in layer.parameters()]

    _assert_same_bits(run(), run(), aggregation)


# every aggregation of the train step: (aggregation, mega_variant)
_PATHS = [("mega", v) for v in mega.MEGA_VARIANTS] + [
    ("fused", "hybrid"), ("pallas", "hybrid"), ("onehot", "hybrid"),
    ("auto", "hybrid"), ("scatter", "hybrid")]


def _train_three_steps(cuda, aggregation, variant, batch):
    """Full-width HybridModelv2 from seed 0, bf16 over f32 master weights,
    Adam: three steps on ``batch``; (losses, parameters, Adam moments)."""
    _, model = build_model("HybridModelv2", 20 * 21,
                           torch.Generator().manual_seed(0), device=cuda)
    trainer = Trainer(model.spec, LossConfig(20 * 21, 1.0), binary=True,
                      optimizer=make_optimizer("adam", constant_lr(1e-3)),
                      aggregation=aggregation, compute_dtype=torch.bfloat16,
                      mega_variant=variant)
    state = trainer.init_state(model)
    losses = []
    for _ in range(3):
        state, loss = trainer.train_step(state, batch, seed=0)
        losses.append(loss.detach().clone())
    torch.cuda.synchronize()
    params = [p.detach().clone() for p in model.parameters()]
    moments = [state.optimizer.state[p][k].clone()
               for p in model.parameters() for k in ("exp_avg", "exp_avg_sq")]
    return losses, params, moments


@pytest.mark.cuda
@pytest.mark.parametrize("aggregation,variant", _PATHS)
def test_same_seed_trains_and_serves_the_same_bits(cuda, aggregation,
                                                    variant):
    """One seed trained twice from fresh state (B=16, E=2560, bf16, three
    steps on one mirror-paired batch): the losses, every parameter and
    every Adam moment equal bit for bit; and one request served twice
    (B=16, E=2560, bf16, the same VAE noise): the logits equal bit for bit,
    also through B7 (``fused_stack``) where the aggregation is 'auto'.
    'scatter', the reference algorithm's baseline (``index_add_`` with
    atomics on the card), is run and its reading printed, not asserted."""
    batch = build_batch(16, N, 2560, 20, paired=True, device=cuda)
    runs = [_train_three_steps(cuda, aggregation, variant, batch)
            for _ in range(2)]
    trained = all(torch.equal(a, b) for part in zip(*runs)
                  for a, b in zip(*part))
    _, model = build_model("HybridModelv2", 20 * 21,
                           torch.Generator().manual_seed(1), device=cuda)
    req = random_sample_batch(16, N, 2560, 20, seed=5, device=cuda)
    eps = torch.randn(16, 32, generator=torch.Generator().manual_seed(5))
    stacks = [False, True] if aggregation == "auto" else [False]
    served = True
    for fused in stacks:
        logits = []
        for _ in range(2):
            with torch.inference_mode():
                logits.append(model_apply(
                    model, req.graph, req.seq_onehot, req.props,
                    deterministic=True, aggregation=aggregation,
                    eps=eps.to(cuda), compute_dtype=torch.bfloat16,
                    mega_variant=variant, fused_stack=fused).logits)
        assert torch.isfinite(logits[0]).all()
        served = served and torch.equal(*logits)
    print(f"repeat {aggregation}/{variant}: trained the same bits {trained},"
          f" served the same bits {served}")
    if aggregation != "scatter":
        assert trained and served


@pytest.mark.cuda
def test_stack_layers_are_b1_bit_for_bit(cuda):
    """Where B1 runs one chunk a graph (B=128 on 132 SMs), layer l of B6 is
    B1 on (hs[l-1], xs[l-1]) bit for bit: a1s and xds are B1's residuals
    and aggs B1's sums rounded (one body, csrc/egnn_mega.cuh)."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert mega.fwd_chunks(2560, 128, sms) == 1
    args, packed = _stack_args(128, 2560, torch.bfloat16, cuda, seed=45)
    h, x, hs, xs, aggs, a1s, xds = stack.stack_fwd(*args, packed)
    src, dst, mask, ef, h0, x0 = args
    for layer, weights in enumerate(packed):
        h_in = h0 if layer == 0 else hs[:, layer - 1]
        x_in = x0 if layer == 0 else xs[:, layer - 1]
        out, a1, xd = mega.edge_mega_fwd(src, dst, mask, ef,
                                         h_in.contiguous(),
                                         x_in.contiguous(), *weights[:4])
        assert torch.equal(a1, a1s[:, layer]), layer
        assert torch.equal(xd, xds[:, layer]), layer
        assert torch.equal(out.to(torch.bfloat16), aggs[:, layer]), layer


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 200])
@pytest.mark.parametrize("e", [2560, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stack_kernel_at_the_grid_edges(cuda, b, e, dtype):
    """B6 at B=1 and 200, E=2560 and 1000 (a ragged last tile), the last
    graph's edges all masked: each layer within its bounds."""
    args, packed = _stack_args(b, e, dtype, cuda, seed=b + e + 46)
    args[2][-1] = False
    out = stack.stack_fwd(*args, packed)
    _assert_stack_layers_close(out, args, packed, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 200])
@pytest.mark.parametrize("e", [2560, 1024])
@pytest.mark.parametrize("x_dtype", [None, torch.float32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_layer_kernel_at_the_grid_edges(cuda, b, e, x_dtype, dtype):
    """B7 at B=1 (a graph over a cluster of CTAs) and 200 (one CTA a
    graph, more CTAs than SMs), E=2560 and 1024 (the wrapper takes E a
    multiple of 128, as JAX does), bf16 or f32 coordinates, the last graph's
    edges all masked: within its bounds."""
    layer, args = _b7_args(b, e, 64, dtype, cuda, seed=b + e + 47,
                           x_dtype=x_dtype)
    args[4][-1] = False
    with torch.no_grad():
        out = fused_layer.fused_egnn_layer(layer, *args)
        ref = fused_layer.fused_egnn_layer_reference(layer, *args)
    _assert_b7_close(out, ref, dtype)


@pytest.mark.cuda
def test_fused_layer_cluster_reaches_more_than_one_sm(cuda):
    """At B=1 B7's bf16 form spans a cluster of more than one CTA (one an
    SM, ``layer_cluster_size``), and the card holds such clusters."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    k = fused_layer.layer_cluster_size(2560, 1, sms)
    assert k > 1
    lib = fused_layer._lib()
    assert lib.egnn_layer_fwd_ctas_per_sm(N, 64, 1) == 1
    assert lib.egnn_layer_fwd_max_clusters(N, 64, k) >= 1


# --------------------------------------------------------------------------
# the twelfth slice's entry points: the curriculum under 'mega', the
# clinical-only inference, the native featurizer
# --------------------------------------------------------------------------

def _launches():
    from immunostruct_tpu_torch.cli.race_kernel_variants import read_counts
    return read_counts()


@pytest.mark.cuda
def test_curriculum_launches_b1_b2_b8_on_the_card(cuda, tmp_path,
                                                  monkeypatch):
    """A two-stage curriculum (PropIEDB, ImmunoIEDB) under 'mega' at small
    width (two EGNN layers at the kernel's H=64, a narrow VAE), bf16: per
    train step B2 once a layer and B8's scatter twice a layer (the
    backward's node sums), B1 at least once a layer; in inference B1 alone;
    no other kernel."""
    from immunostruct_tpu_torch.cli import train_curriculum
    from immunostruct_tpu_torch.data.synthetic import synthetic_corpus

    g, p, h = synthetic_corpus(str(tmp_path / "c"), num_samples=24,
                               hla_len=20, seed=5)
    real_build = train_curriculum.build_model
    monkeypatch.setattr(train_curriculum, "build_model", functools.partial(
        real_build, gcn_layers=1, vae_hidden_dim=32, vae_latent_dim=8))
    stages, inferences = [], []
    real_train, real_infer = (train_curriculum.train_model,
                              train_curriculum.inference)

    def train_model(config, model, train_pipe, *args, **kw):
        before = _launches()
        out = real_train(config, model, train_pipe, *args, **kw)
        after = _launches()
        stages.append(({k: after[k] - before[k] for k in after},
                       len(train_pipe) * config.num_epochs))
        return out

    def inference(*args, **kw):
        before = _launches()
        out = real_infer(*args, **kw)
        after = _launches()
        inferences.append({k: after[k] - before[k] for k in after})
        return out

    monkeypatch.setattr(train_curriculum, "train_model", train_model)
    monkeypatch.setattr(train_curriculum, "inference", inference)
    train_stats, test_stats = train_curriculum.main([
        "--stages", "PropIEDB,ImmunoIEDB", "--model", "HybridModelv2",
        "--full-sequence", "--aggregation", "mega", "--compute-dtype",
        "bfloat16", "--batch-size", "8", "--num-epochs", "2",
        "--min-finetuning-batches", "4", "--seed", "1",
        "--model-save-dir", str(tmp_path / "ckpt"), "--graph-dir-IEDB", g,
        "--property-path-IEDB", p, "--hla-path", h])
    assert len(train_stats) == len(test_stats) == 15
    layers = 2
    assert len(stages) == 2 and len(inferences) == 2
    for counts, steps in stages:
        assert counts["B2"] == layers * steps, counts
        assert counts["B8_scatter"] == 2 * layers * steps, counts
        assert counts["B1"] >= layers * steps and counts["B1"] % layers == 0
        others = {k: v for k, v in counts.items()
                  if k not in ("B1", "B2", "B8_scatter")}
        assert not any(others.values()), counts
    for counts in inferences:
        assert counts["B1"] > 0 and counts["B1"] % layers == 0, counts
        assert sum(counts.values()) == counts["B1"], counts


def _small_clinical_checkpoint(path, vae_dim):
    """Seeded small HybridModelv2_Comparative weights, the VAE's
    log-variance head at -100: the VAE noise (drawn on each device by its
    own generator) is multiplied by exp(-50)."""
    from immunostruct_tpu_torch.utils.checkpoint import save_checkpoint

    _, model = build_model("HybridModelv2_Comparative", vae_dim,
                           torch.Generator().manual_seed(6),
                           use_wt_for_downstream=False, gcn_layers=1,
                           vae_hidden_dim=32, vae_latent_dim=8)
    with torch.no_grad():
        model.vae.fc22.w.zero_()
        model.vae.fc22.b.fill_(-100.0)
    save_checkpoint(path, model)


@pytest.mark.cuda
def test_infer_clinical_only_on_the_card_matches_the_cpu(cuda, tmp_path):
    """``cli.infer_clinical_only`` under 'mega' on the card against the same
    checkpoint under 'scatter' on the CPU, f32 (TF32 off): the valid rows'
    probabilities within 5e-4 (chip_smoke's PROB_ATOL), the invalid rows
    NaN on both, the p-values equal; B1 alone launched, once a layer a
    batch."""
    from immunostruct_tpu_torch.cli import infer_clinical_only
    from immunostruct_tpu_torch.data.synthetic import (
        synthetic_clinical_corpus,
    )

    g, s, c = synthetic_clinical_corpus(str(tmp_path / "c"), num_rows=96,
                                        num_patients=8, hla_len=20, seed=4)
    ckpt = str(tmp_path / "m.ckpt")
    _small_clinical_checkpoint(ckpt, 30 * 21)
    common = ["--checkpoint", ckpt, "--full-sequence", "--compute-dtype",
              "float32", "--batch-size", "16", "--seed", "1",
              "--graph-dir-clinical", g, "--seq-path-clinical", s,
              "--clinical-table-path", c, "--gcn-layers", "1",
              "--vae-hidden-dim", "32", "--vae-latent-dim", "8",
              "--figure-save-dir", str(tmp_path / "fig")]
    cpu = infer_clinical_only.main(common + ["--device", "cpu",
                                             "--aggregation", "scatter"])
    before = _launches()
    card = infer_clinical_only.main(common + ["--device", "cuda",
                                              "--aggregation", "mega"])
    after = _launches()
    launched = {k: after[k] - before[k] for k in after}
    assert launched["B1"] == 2 * 6 and sum(launched.values()) == 12, launched
    a, b = card["predicted_probs"], cpu["predicted_probs"]
    valid = ~np.isnan(b)
    np.testing.assert_array_equal(np.isnan(a), ~valid)
    assert 0 < valid.sum() < len(b)
    np.testing.assert_allclose(a[valid], b[valid], atol=5e-4, rtol=0)
    assert (card["os_p_value"], card["pfs_p_value"]) == (
        cpu["os_p_value"], cpu["pfs_p_value"])


def test_native_featurizer_builds_and_matches_numpy(tmp_path):
    """The featurizer library is built from native/featurizer.cc on this
    host (no -march=native) and writes the numpy path's graphs bit for bit
    on a synthetic corpus written back as PDBs."""
    from immunostruct_tpu_torch.data.synthetic import (
        synthetic_corpus, write_corpus_pdbs,
    )
    from immunostruct_tpu_torch.featurize import featurize_directory, native

    lib = native.build()
    assert lib.exists() and "-march=native" not in native.CXX_FLAGS
    g, _, _ = synthetic_corpus(str(tmp_path / "c"), num_samples=8,
                               hla_len=275, seed=3)
    write_corpus_pdbs(g, str(tmp_path / "pdb"), hla_len=275)
    out = {}
    for use_native in (True, False):
        out[use_native] = featurize_directory(
            str(tmp_path / "pdb"), str(tmp_path / f"g{use_native}"),
            workers=4, use_native=use_native)
    assert len(out[True]) == len(out[False]) == 8
    for a_path, b_path in zip(out[True], out[False]):
        with np.load(a_path) as a, np.load(b_path) as b:
            assert str(a["name"]) == str(b["name"])
            for k in ("x", "coords", "edge_index"):
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


# --------------------------------------------------------------------------
# the serving artifact: the kernels as torch.library ops
# --------------------------------------------------------------------------

def _op_args(dtype, device, seed):
    """(op, args) of the four kernel ops at a small size on ``device``."""
    gen = torch.Generator().manual_seed(seed)
    src, dst, mask, ef, h, x, *weights = _args(2, 256, 20, 64, dtype, device,
                                               seed)
    f = h.shape[2]

    def bundle(idx):
        rows = torch.cat([h, x], dim=-1)
        return torch.gather(rows, 1, idx.long()[..., None].expand(
            -1, -1, f + 3)).transpose(1, 2).contiguous()

    m = torch.randn(2, 256, 67, generator=gen).to(device, dtype)
    ops = torch.ops.immunostruct
    return {
        "edge_mega_fwd": (ops.edge_mega_fwd.default,
                          (src, dst, mask, ef, h, x, *weights, False)),
        "edge_mega_fwd residuals": (ops.edge_mega_fwd.default,
                                    (src, dst, mask, ef, h, x, *weights,
                                     True)),
        "edge_program_fwd": (ops.edge_program_fwd.default,
                             (bundle(src), bundle(dst),
                              ef.transpose(1, 2).contiguous(), *weights)),
        "segment_scatter": (ops.segment_scatter.default, (dst, mask, m, N)),
        "segment_gather": (ops.segment_gather.default,
                           (src, mask, h.contiguous())),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["edge_mega_fwd", "edge_mega_fwd residuals",
                                  "edge_program_fwd", "segment_scatter",
                                  "segment_gather"])
def test_kernel_op_passes_opcheck_on_the_card(cuda, case, dtype):
    op, args = _op_args(dtype, cuda, seed=61)[case]
    counters = {"edge_mega_fwd": mega.edge_mega,
                "edge_program_fwd": edge.edge_program,
                "segment_scatter": segment.segment_scatter,
                "segment_gather": segment.segment_gather}
    counter = counters[case.split()[0]]
    before = counter.launches
    torch.library.opcheck(op, args)
    assert counter.launches > before        # the kernel ran, counted in the op


@pytest.mark.cuda
def test_mega_artifact_launches_b1_and_gives_the_scorers_bits(cuda,
                                                              tmp_path):
    """A full-width HybridModelv2 exported on the card under 'mega' (bf16,
    B=16, E=2560): 6 B1 launches a call and no other kernel, the eager
    Scorer's bits (same weights, seed and aggregation), the same bits
    twice; the artifact refuses to load for the CPU."""
    from immunostruct_tpu_torch.cli.race_kernel_variants import counters
    from immunostruct_tpu_torch.serving import Scorer
    from immunostruct_tpu_torch.utils.export import (
        REQUEST_KEYS, export_inference_fn, load_exported, save_exported,
    )

    _, model = build_model("HybridModelv2", 20 * 21,
                           torch.Generator().manual_seed(1), device=cuda)
    req = random_sample_batch(16, N, 2560, 20, seed=5, device=cuda)
    program = export_inference_fn(
        model, (req.graph, req.seq_onehot, req.props), aggregation="mega",
        compute_dtype=torch.bfloat16, seed=3)
    path = str(tmp_path / "model.pt2")
    save_exported(program, path)
    with pytest.raises(ValueError, match="exported on cuda"):
        load_exported(path, "cpu")
    artifact = load_exported(path, "cuda")
    tensors = [getattr(req.graph, k) for k in REQUEST_KEYS[:8]] + [
        req.seq_onehot, req.props]
    wrappers = counters()
    before = {k: fn.launches for k, fn in wrappers.items()}
    probs = [artifact(*tensors) for _ in range(2)]
    torch.cuda.synchronize()
    launched = {k: fn.launches - before[k] for k, fn in wrappers.items()}
    assert launched == {k: 12 if k == "B1" else 0 for k in wrappers}
    scorer = Scorer(model, device=cuda, compute_dtype=torch.bfloat16,
                    aggregation="mega", seed=3)
    want = scorer(req.graph, req.seq_onehot, req.props)
    assert torch.equal(probs[0], probs[1])
    assert np.array_equal(probs[0].cpu().numpy(), want)


# --------------------------------------------------------------------------
# the device-resident corpus (data/device_pipeline.py, data/device_augment.py)
# --------------------------------------------------------------------------

def _device_data_corpus(tmp_path, samples=40):
    from immunostruct_tpu_torch.config import Config
    from immunostruct_tpu_torch.data.dataset import ImmunoDataset
    from immunostruct_tpu_torch.data.synthetic import synthetic_corpus

    cfg = Config(device="cuda", batch_size=16, seed=3, full_sequence=True)
    paths = synthetic_corpus(str(tmp_path / "corpus"), num_samples=samples,
                             hla_len=40, seed=9)
    return cfg, ImmunoDataset.load(cfg, *paths)


def _tensors(batch) -> list:
    from immunostruct_tpu_torch.structs import map_tensors

    out = []
    map_tensors(out.append, batch)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("split", ["train", "val"])
def test_device_batches_equal_host_batches_on_the_card(cuda, tmp_path,
                                                       split):
    """One epoch (shuffled for train, the trailing batch partial): the
    device pipeline's batches are the host pipeline's, bit for bit, dtype
    and device included."""
    from immunostruct_tpu_torch.data.device_pipeline import DevicePipeline
    from immunostruct_tpu_torch.data.pipeline import BatchPipeline

    cfg, ds = _device_data_corpus(tmp_path)
    idx = np.arange(len(ds))
    host = BatchPipeline(ds, idx, split=split, binary=True, full=True,
                         config=cfg)
    dev = DevicePipeline(ds, idx, split=split, binary=True, full=True,
                         config=cfg, pad_final_batch=False)
    pairs = list(zip(host.epoch(2), dev.epoch(2)))
    assert len(pairs) == len(dev) == 3
    for hb, db in pairs:
        for a, b in zip(_tensors(hb), _tensors(db)):
            assert a.dtype == b.dtype and a.device == b.device
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_gather_and_augment_make_no_host_sync(cuda, tmp_path):
    """gather_batch, augment_batch and augment_comparative under
    torch.cuda.set_sync_debug_mode('error'); the same bits for one seed."""
    from immunostruct_tpu_torch.data.device_augment import (
        augment_batch, augment_comparative,
    )
    from immunostruct_tpu_torch.data.device_pipeline import (
        build_device_corpus, gather_batch,
    )
    from immunostruct_tpu_torch.structs import ComparativeBatch

    _, ds = _device_data_corpus(tmp_path)
    corpus = build_device_corpus(ds, binary=True, full=True, device=cuda)
    rows = torch.arange(16, device=cuda, dtype=torch.int32)
    kw = dict(ssl=True, structure_pad_count=5, sequence_pad_count=5,
              maskable_len=ds.seq_full.shape[1] - ds.seq_pep.shape[1],
              rotate=True)
    outs = []
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            batch = gather_batch(corpus, rows)
            gen = torch.Generator(device=cuda)
            gen.manual_seed(11)
            outs.append((augment_batch(batch, gen, **kw),
                         augment_comparative(
                             ComparativeBatch(cancer=batch, wt=batch), gen,
                             **kw)))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for a, b in zip(_tensors(outs[0][0]) + _tensors(outs[0][1]),
                    _tensors(outs[1][0]) + _tensors(outs[1][1])):
        assert torch.equal(a, b)
    nf = outs[0][0].graph.node_feat
    assert ((nf.sum(-1) == 20).sum(-1) == 1).all()


@pytest.mark.cuda
def test_device_corpus_estimate_equals_the_allocated_bytes(cuda, tmp_path):
    """estimate_device_bytes is the sum of the uploaded tensors' nbytes; the
    caching allocator's growth is that, rounded up to its blocks."""
    from immunostruct_tpu_torch.data.device_pipeline import (
        build_device_corpus, estimate_device_bytes,
    )

    _, ds = _device_data_corpus(tmp_path)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    corpus = build_device_corpus(ds, binary=False, full=True, device="cuda")
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - before
    need = estimate_device_bytes(ds, full=True)
    assert need == corpus.nbytes()
    # the cached eleven tensors and the returned [M] target, each rounded
    # up to the allocator's 512 B
    assert need <= grown <= need + 4 * len(ds) + 12 * 512
    again = build_device_corpus(ds, binary=True, full=True, device="cuda:0")
    assert again.node_onehot is corpus.node_onehot     # 'cuda' is 'cuda:0'


# --------------------------------------------------------------------------
# parallelism on the card (parallel/*): ranks that share cuda:0 over gloo,
# and the NCCL group of one
# --------------------------------------------------------------------------

def _build_for_ranks():
    """The kernels the ranks launch, built here before they are spawned."""
    mega._kernel_libs()
    segment._lib()


@pytest.mark.cuda
def test_data_parallel_step_over_two_ranks_on_the_card(cuda):
    """Two ranks share the card (gloo): the 'mega' step (f32, B=16,
    E=512) with noise on equals the one-process step (loss rel 1e-5,
    parameters rtol 2e-5, atol 2e-6; the attention key biases, whose true
    gradient is zero, within Adam's lr) and each rank launches its
    kernels."""
    from immunostruct_tpu_torch.parallel.dryrun import (
        KEY_BIASES, StepCase, dp_checks, excess_by_param, spawn,
    )
    _build_for_ranks()
    case = StepCase(name="HybridModelv2", b=16, nodes=64, edges=512,
                    seq_len=16, aggregation="mega")
    ranks = spawn(dp_checks, 2, {"f32": case}, device="cuda")
    ref = ranks[0]["f32/ref"]
    for r in ranks:
        got = r["f32"]
        assert got["backend"] == "gloo" and got["rows"] == 8
        assert got["losses"][0] == pytest.approx(ref["losses"][0], rel=1e-5)
        excess = excess_by_param(got["params"], ref["params"], 2e-5, 2e-6)
        assert max(v for k, v in excess.items()
                   if not k.endswith(KEY_BIASES)) <= 1.0, excess
        for k in excess:
            if k.endswith(KEY_BIASES):
                assert (got["params"][k] - ref["params"][k]).abs().max() \
                    <= 1e-3, k
        assert got["launches"]["B1"] == got["launches"]["B2"] == 6
        assert got["launches"] == ref["launches"]


@pytest.mark.cuda
def test_twin_rule_on_the_card_holds_and_fails_planted_faults(cuda):
    """The twin control at full width (f32, 'mega', B=128 over two ranks
    sharing the card, N=288, E=2560, L=284, contrastive 0.1, dropout 0,
    VAE noise pinned): the one-process step on its rows reversed and the
    two-rank step meet ``dryrun.twin_excess``'s rule (chip_smoke.py phase
    29b's), and the two-rank step with a fault planted in the gather of
    the contrastive term's embeddings
    (``tests/torch_parallel_ranks.py::GATHER_FAULTS``) fails it by far, in
    its gradients and in its parameters."""
    from immunostruct_tpu_torch.parallel.dryrun import (
        StepCase, dp_checks, spawn, twin_excess,
    )
    # beside this file (a package named tests elsewhere may shadow ours)
    from torch_parallel_ranks import GATHER_FAULTS, planted_faults

    _build_for_ranks()
    case = StepCase(name="HybridModelv2_Comparative", b=128, nodes=288,
                    edges=2560, seq_len=284, aggregation="mega",
                    dtype="float32", coeff=0.1,
                    overrides=(("dropout_rate", 0.0),), pinned=True)
    runs = spawn(dp_checks, 2, {"twin_fixed": case}, None, 0, 0, 1,
                 ("twin_fixed",), device="cuda")
    ref = runs[0]["twin_fixed/ref"]
    readings = {"reversed": twin_excess(runs[0]["twin_fixed/reversed"],
                                        ref)}
    for i, r in enumerate(runs):
        readings[f"rank {i}"] = twin_excess(r["twin_fixed"], ref)
    faults = spawn(planted_faults, 2, case, device="cuda")
    for name in GATHER_FAULTS:
        for i, r in enumerate(faults):
            readings[f"{name}, rank {i}"] = twin_excess(r[name], ref)
    print(json.dumps(readings))
    for label, rule in readings.items():
        if label == "reversed" or label.startswith("rank"):
            assert rule["grads"] <= 1.0 and rule["params"] <= 1.0, (label,
                                                                   rule)
        else:
            assert rule["grads"] > 10 and rule["params"] > 10, (label, rule)


@pytest.mark.cuda
def test_gpipe_hop_staged_through_host_on_the_card(cuda):
    """GPipe over two ranks sharing the card: gloo's send/recv takes no
    CUDA tensor, so each hop goes through pinned host memory; the output
    and the gradients equal the sequential stack's."""
    import numpy as np

    from immunostruct_tpu_torch.parallel.dryrun import (
        gpipe_stack_run, spawn,
    )

    rng = np.random.default_rng(0)
    stacked = {"w": rng.standard_normal((2, 12, 12)).astype(np.float32) / 4,
               "b": rng.standard_normal((2, 12)).astype(np.float32) / 4}
    x = rng.standard_normal((8, 12)).astype(np.float32)
    y = rng.standard_normal((8, 12)).astype(np.float32)
    outs = spawn(gpipe_stack_run, 2, stacked, x, y, (1, 2, 4),
                 device="cuda")
    params = {k: torch.from_numpy(v).requires_grad_(True)
              for k, v in stacked.items()}
    h = torch.from_numpy(x)
    for s in range(2):
        h = torch.tanh(h @ params["w"][s] + params["b"][s])
    ((h - torch.from_numpy(y)) ** 2).mean().backward()
    for out in outs:
        for m in (1, 2, 4):
            np.testing.assert_allclose(out[f"out{m}"], h.detach().numpy(),
                                       rtol=1e-5, atol=1e-6)
        for k, p in params.items():
            np.testing.assert_allclose(out["grads"][k], p.grad.numpy(),
                                       rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
def test_nccl_group_of_one_on_the_card(cuda):
    """Without torchrun's environment the process is a group of one over
    NCCL; a sharded step there gives the plain step's bits."""
    import torch.distributed as dist

    from immunostruct_tpu_torch.parallel import collectives as C
    from immunostruct_tpu_torch.parallel.dryrun import (
        StepCase, case_batch, case_trainer, params_of,
    )
    from immunostruct_tpu_torch.parallel.mesh import (
        initialize_distributed, make_mesh, shutdown_distributed,
    )
    _build_for_ranks()
    assert initialize_distributed(device="cuda") == torch.device("cuda", 0)
    try:
        assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
        mesh = make_mesh("data")
        x = torch.randn(1000, device=cuda)
        assert torch.equal(C.psum(x, mesh=mesh), x)
        assert torch.equal(C.all_gather(x, mesh=mesh), x)
        assert torch.equal(C.ring_all_reduce(x, mesh=mesh), x)
        case = StepCase(name="HybridModelv2", b=8, nodes=64, edges=512,
                        seq_len=16, aggregation="mega")
        params = []
        for kw in ({"sharded": True, "mesh": mesh}, {}):
            trainer, state = case_trainer(case, cuda, **kw)
            batch = trainer._shard(case_batch(case, cuda))
            state, loss = trainer.train_step(state, batch, seed=0)
            params.append((float(loss), params_of(state.model)))
        (l1, p1), (l2, p2) = params
        assert l1 == l2
        assert all(torch.equal(p1[k], p2[k]) for k in p1)
    finally:
        shutdown_distributed()


# --------------------------------------------------------------------------
# every kernel on every seeded input, judged by the rule
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("kernel", kc.KERNELS)
def test_kernel_meets_the_rule_on_every_seeded_input(cuda, kernel):
    """Every bf16 input of the kernel's card tests, at the test's own seed
    and at 1..8 (``kernel_checks.cases``), judged by the rule
    (``kernel_checks.judge``: each unit within its bound where the plain
    version run on the CPU meets it, within the bound plus twice the CPU's
    own distance where it does not; the CPU runs on the inputs past the
    bound). Names every failing input and unit."""
    _, line = kc.sweep(kernel, yardstick="failing")
    print("sweep:", json.dumps({k: v for k, v in line.items()
                                if k != "failing_inputs"}))
    assert line["failing"] == 0, line["failing_inputs"]


# --------------------------------------------------------------------------
# captured programs (utils/capture.py): the train step, the eval step and
# the served forward as CUDA graphs, against the eager path
# --------------------------------------------------------------------------

# (label, model, aggregation, mega_variant, grad_accum_steps, contrastive,
# paired batch)
_CAPTURED_STEPS = [
    ("mega", "HybridModelv2", "mega", "hybrid", 1, 0.0, False),
    ("fused", "HybridModelv2", "fused", "hybrid", 1, 0.0, False),
    ("pallas", "HybridModelv2", "pallas", "hybrid", 1, 0.0, False),
    ("paired", "HybridModelv2", "mega", "paired", 1, 0.0, True),
    ("dboth", "HybridModelv2", "mega", "dboth", 1, 0.0, False),
    ("inkernel", "HybridModelv2", "mega", "inkernel", 1, 0.0, True),
    ("stack", "HybridModelv2", "mega", "stack", 1, 0.0, True),
    ("twin", "HybridModelv2_Comparative", "mega", "hybrid", 1, 0.1, False),
    ("k2", "HybridModelv2", "mega", "hybrid", 2, 0.0, False),
]
_CAPTURED_B = 16


def _counts() -> tuple:
    """The eleven kernels' launch counts, in ``counters()``' order (B1
    first)."""
    return tuple(_launches().values())


def _captured_batch(cuda, name, paired, seed=0):
    from immunostruct_tpu_torch.structs import ComparativeBatch

    if name.endswith("Comparative"):
        c = build_batch(_CAPTURED_B, N, 2560, 20, paired=paired, device=cuda)
        w = random_sample_batch(_CAPTURED_B, N, 2560, 20, seed=seed + 1,
                                device=cuda)
        c.target = (torch.arange(_CAPTURED_B, device=cuda) % 2).float()
        w.target = c.target
        return ComparativeBatch(cancer=c, wt=w)
    return build_batch(_CAPTURED_B, N, 2560, 20, paired=paired, device=cuda)


def _captured_trainer(cuda, name, aggregation, variant, accum, coeff,
                      capture, dtype=torch.bfloat16):
    """Full-width ``name`` from seed 0, ``dtype`` (bf16) over f32 master
    weights, dropout at the spec's rate, Adam at 1e-3: a Trainer whose
    steps are captured (``capture`` None) or eager (False), and its
    state."""
    _, model = build_model(name, 20 * 21, torch.Generator().manual_seed(0),
                           device=cuda)
    trainer = Trainer(model.spec, LossConfig(20 * 21, 1.0, sequence=True),
                      binary=True,
                      optimizer=make_optimizer("adam", constant_lr(1e-3)),
                      aggregation=aggregation, compute_dtype=dtype,
                      mega_variant=variant, grad_accum_steps=accum,
                      coeff_contrastive=coeff,
                      allow_microbatch_contrastive=coeff > 0 and accum > 1,
                      capture=capture)
    return trainer, trainer.init_state(model,
                                       torch.Generator().manual_seed(1))


def _step_readings(trainer, state, batch, steps):
    """Per step: (loss, launches by kernel, gradients); then the
    parameters and Adam moments."""
    out = []
    for _ in range(steps):
        before = _counts()
        state, loss = trainer.train_step(state, batch, seed=4)
        torch.cuda.synchronize()
        out.append((loss, tuple(a - b for a, b in zip(_counts(), before)),
                    [None if p.grad is None else p.grad.clone()
                     for p in state.model.parameters()]))
    params = [p.detach().clone() for p in state.model.parameters()]
    moments = [state.optimizer.state[p][k].clone()
               for p in state.model.parameters()
               for k in ("exp_avg", "exp_avg_sq")]
    return out, params, moments


@pytest.mark.cuda
@pytest.mark.parametrize("case", _CAPTURED_STEPS, ids=lambda c: c[0])
def test_captured_step_equals_the_eager_step(cuda, case):
    """Five steps of full-width HybridModelv2 (the twin model with the
    contrastive term at 0.1 for 'twin'), B=16, E=2560, bf16, dropout on,
    noise drawn: the first step runs eagerly, the second is captured, the
    rest replay. Captured and eager give the same bits in the loss, every
    gradient, parameter and Adam moment, and each step launches the same
    kernels the same number of times (the counts follow the replays)."""
    label, name, agg, variant, accum, coeff, paired = case
    batch = _captured_batch(cuda, name, paired)
    runs = []
    for capture in (None, False):
        trainer, state = _captured_trainer(cuda, name, agg, variant, accum,
                                           coeff, capture)
        runs.append(_step_readings(trainer, state, batch, 5))
        program = trainer.train_program
        if capture is None:
            assert (program.eager_calls, program.captures,
                    program.replays) == ({"first call": 1}, 1, 4)
        else:
            assert program.eager_calls == {"asked": 5}
        del trainer, state
    (steps_c, params_c, moments_c), (steps_e, params_e, moments_e) = runs
    for (lc, nc, gc), (le, ne, ge) in zip(steps_c, steps_e):
        assert nc == ne
        assert torch.equal(lc, le), label
        assert all(a is None and b is None or torch.equal(a, b)
                   for a, b in zip(gc, ge)), label
    assert all(torch.equal(a, b) for a, b in zip(params_c, params_e))
    assert all(torch.equal(a, b) for a, b in zip(moments_c, moments_e))
    print(f"captured {label}: launches a step {steps_c[-1][1]}")


@pytest.mark.cuda
def test_captured_scatter_step_within_its_bounds_of_the_eager_step(cuda):
    """'scatter' in f32 sums with atomics (``index_add_``), so two eager
    steps from one state part in their last bits and their trajectories
    drift apart. Each of five steps is taken from one state: before it, the
    eager trainer's parameters, Adam moments and step count are copied into
    the captured trainer's tensors in place (the graph's addresses stay).
    The captured step is then held to the eager one by phase 16's
    first-step bounds of chip_smoke.py, the bounds 'scatter' has against
    itself and 'mega': the loss within 1e-3, each gradient's difference
    within 0.02 of its norm + 2e-4 of the largest norm; every step after
    the first is a replay. In bf16 'scatter' sums in edge order with its
    passes counted on the host (``ops/egnn.py::host_counted_sums``): its
    steps run eagerly under that rule, and two steps from one state give
    the same bits."""
    batch = _captured_batch(cuda, "HybridModelv2", False)
    (tc, sc), (te, se) = (
        _captured_trainer(cuda, "HybridModelv2", "scatter", "hybrid", 1, 0.0,
                          capture, torch.float32)
        for capture in (None, False))
    worst = 0.0
    for step in range(5):
        with torch.no_grad():
            for pc, pe in zip(sc.model.parameters(), se.model.parameters()):
                pc.copy_(pe)
                for k, v in se.optimizer.state.get(pe, {}).items():
                    sc.optimizer.state[pc][k].copy_(v)
        sc, lc = tc.train_step(sc, batch, seed=4)
        se, le = te.train_step(se, batch, seed=4)
        torch.cuda.synchronize()
        assert abs(float(lc) - float(le)) <= 1e-3 * abs(float(le)), step
        grads = [(pc.grad, pe.grad) for pc, pe in zip(
            sc.model.parameters(), se.model.parameters())
            if pe.grad is not None]
        top = max(e.norm().item() for _, e in grads)
        for c, e in grads:
            ratio = ((c - e).norm().item()
                     / (0.02 * e.norm().item() + 2e-4 * top))
            worst = max(worst, ratio)
            assert ratio <= 1.0, (step, ratio)
    assert (tc.train_program.captures, tc.train_program.replays,
            tc.train_program.dropped) == (1, 4, 0)
    print(f"captured scatter: worst gradient {worst:.4f} of its bound")

    runs = []
    for _ in range(2):
        trainer, state = _captured_trainer(cuda, "HybridModelv2", "scatter",
                                           "hybrid", 1, 0.0, None)
        state, loss = trainer.train_step(state, batch, seed=4)
        state, loss = trainer.train_step(state, batch, seed=4)
        assert trainer.train_program.captures == 0
        assert trainer.train_program.eager_calls == {"ordered sums": 2}
        runs.append((loss, [p.detach().clone()
                            for p in state.model.parameters()]))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def _scorer_pair(cuda, model, **kw):
    from immunostruct_tpu_torch.serving import Scorer

    return [Scorer(model, device=cuda, compute_dtype=torch.bfloat16, seed=3,
                   capture=capture, **kw) for capture in (None, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,fused_stack", [(1, False), (128, False),
                                           (128, True)])
def test_captured_forward_equals_the_eager_forward(cuda, b, fused_stack):
    """The served forward of full-width HybridModelv2 ('mega'; with
    ``fused_stack``, B7 under 'auto') at B=1 and 128, E=2560, bf16: five
    requests (three of one shape; two others) through a captured Scorer and
    an eager one give the same probabilities bit for bit; the captured one
    warms, captures and replays each shape."""
    _, model = build_model("HybridModelv2", 20 * 21,
                           torch.Generator().manual_seed(1), device=cuda)
    agg = "auto" if fused_stack else "mega"
    captured, eager = _scorer_pair(cuda, model, aggregation=agg,
                                   fused_stack=fused_stack)
    for seed in (5, 6, 7):
        req = random_sample_batch(b, N, 2560, 20, seed=seed, device=cuda)
        args = (req.graph, req.seq_onehot, req.props)
        assert np.array_equal(captured(*args), eager(*args)), seed
    assert (captured.program.captures, captured.program.replays) == (1, 2)
    assert eager.program.eager_calls == {"asked": 3}


@pytest.mark.cuda
def test_captured_artifact_equals_the_eager_artifact(cuda, tmp_path):
    """A full-width 'mega' artifact (bf16, B=16, E=2560) served through a
    captured ArtifactScorer and an eager one: the same bits over three
    requests, 6 B1 launches a replayed call (the counts follow the
    replays), and the eager Scorer's bits."""
    from immunostruct_tpu_torch.serving import ArtifactScorer
    from immunostruct_tpu_torch.utils.export import (
        REQUEST_KEYS, export_inference_fn, load_exported, save_exported,
    )

    _, model = build_model("HybridModelv2", 20 * 21,
                           torch.Generator().manual_seed(1), device=cuda)
    req = random_sample_batch(16, N, 2560, 20, seed=5, device=cuda)
    path = str(tmp_path / "model.pt2")
    save_exported(export_inference_fn(
        model, (req.graph, req.seq_onehot, req.props), aggregation="mega",
        compute_dtype=torch.bfloat16, seed=3), path)
    captured, eager = (ArtifactScorer(load_exported(path, "cuda"), capture)
                       for capture in (None, False))
    scorer = _scorer_pair(cuda, model, aggregation="mega")[1]
    for seed in (5, 6, 7):
        r = random_sample_batch(16, N, 2560, 20, seed=seed, device=cuda)
        tensors = [getattr(r.graph, k) for k in REQUEST_KEYS[:8]] + [
            r.seq_onehot, r.props]
        before = _counts()
        got = captured(*tensors)
        launched = tuple(a - z for a, z in zip(_counts(), before))
        assert launched == (6,) + (0,) * 10, launched
        assert np.array_equal(got, eager(*tensors))
        assert np.array_equal(got, scorer(r.graph, r.seq_onehot, r.props))
    assert (captured.program.captures, captured.program.replays) == (1, 2)


@pytest.mark.cuda
def test_replay_makes_no_host_sync(cuda):
    """A replayed 'mega' train step (B=16, E=2560, bf16) and a replayed
    served forward, each to its device result, under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    batch = _captured_batch(cuda, "HybridModelv2", False)
    trainer, state = _captured_trainer(cuda, "HybridModelv2", "mega",
                                       "hybrid", 1, 0.0, None)
    scorer = _scorer_pair(cuda, state.model, aggregation="mega")[0]
    args = (batch.graph, batch.seq_onehot, batch.props)
    for _ in range(2):                  # warm-up and capture
        state, _ = trainer.train_step(state, batch, seed=0)
        scorer.probs(*args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, loss = trainer.train_step(state, batch, seed=0)
        probs = scorer.probs(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert trainer.train_program.replays == 2
    assert scorer.program.replays == 2
    assert torch.isfinite(loss) and torch.isfinite(probs).all()


@pytest.mark.cuda
def test_replaced_parameters_drop_the_captured_step(cuda, tmp_path):
    """A captured 'mega' step never replays on replaced tensors: after a
    resumed snapshot (new Adam moments), a new classifier (``reset_head``)
    and a new optimizer (``init_state``, as ``--reinit-on-collapse``), each
    key is dropped and warmed again, and every step equals the eager
    trainer's through the same replacements bit for bit."""
    from immunostruct_tpu_torch.models.trunk import reset_head
    from immunostruct_tpu_torch.utils.checkpoint import (
        load_resume_state, save_resume_state,
    )

    batch = _captured_batch(cuda, "HybridModelv2", False)
    pair = [_captured_trainer(cuda, "HybridModelv2", "mega", "hybrid", 1,
                              0.0, capture) for capture in (None, False)]

    def steps(k):
        for _ in range(k):
            losses = []
            for i, (trainer, state) in enumerate(pair):
                state, loss = trainer.train_step(state, batch, seed=2)
                losses.append(loss)
            assert torch.equal(*losses)
            assert all(torch.equal(a, b) for a, b in zip(
                pair[0][1].model.parameters(), pair[1][1].model.parameters()))

    program = pair[0][0].train_program
    steps(3)
    for i, (_, state) in enumerate(pair):
        save_resume_state(str(tmp_path / f"{i}.resume"), state, 0, 1.0)
    steps(1)
    for i, (_, state) in enumerate(pair):
        load_resume_state(str(tmp_path / f"{i}.resume"), state)
    steps(3)
    assert (program.dropped, program.captures) == (1, 2)
    for _, state in pair:
        reset_head(state.model, torch.Generator().manual_seed(4))
    steps(3)
    assert (program.dropped, program.captures) == (2, 3)
    pair = [(trainer, trainer.init_state(state.model))
            for trainer, state in pair]
    steps(3)
    assert (program.dropped, program.captures,
            program.eager_calls["first call"]) == (3, 4, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("name,decay", [("adam", 0.0), ("adam", 0.01),
                                        ("adamw", 0.01)])
def test_capturable_adam_within_rounding_of_the_float_rate_adam(cuda, name,
                                                                decay):
    """The card's optimizer (``OptimizerConfig.build(params, 'cuda')``:
    capturable, its rate an f32 device tensor that ``apply_lr`` fills, its
    bias corrections computed on the card in f32) against the float-rate
    Adam or AdamW (not capturable, the rate set as a float before each
    step, its bias corrections in float64 on the host), from full-width
    HybridModelv2's parameters and one set of its gradients (one eager
    'mega' step's, B=16, E=2560, bf16), over 8 steps of a halving schedule
    (2 steps an epoch).

    Parameters: within ``test_torch_port_train.py``'s Adam rule with the
    gradients the same, 1e-6 + 1e-5 |p|. Moments: where the update leaves
    them alone (no decay, or AdamW's decoupled one) bit for bit; Adam's L2
    decay puts the parted parameters into the gradient, e_k = decay * the
    parameters' bound + 2^-23 |g + decay p|, carried through Adam's
    averages as that file's JAX parity tests carry theirs, plus 2^-22 of
    the moment a step for its own rounding. Printed: the largest
    difference in the parameters against the rounding estimate sum_t
    (1e-4 d_t + 2^-22 |p_t|), d_t the float-rate update's size and 1e-4 the
    f32 bias corrections' reach (beta2 = 0.999 in f32 moves 1 - beta2 by
    1.3e-5), and how many entries part."""
    from immunostruct_tpu_torch.procedures.train import step_generator

    _, model = build_model("HybridModelv2", 20 * 21,
                           torch.Generator().manual_seed(0), device=cuda)
    trainer = Trainer(model.spec, LossConfig(20 * 21, 1.0, sequence=True),
                      binary=True,
                      optimizer=make_optimizer("adam", constant_lr(1e-3)),
                      aggregation="mega", compute_dtype=torch.bfloat16,
                      capture=False)
    trainer.loss_and_grads(model, _captured_batch(cuda, "HybridModelv2",
                                                  False),
                           step_generator(0, 0, cuda))
    named = [(n, p) for n, p in model.named_parameters()
             if p.grad is not None]
    grads = [p.grad.detach().clone() for _, p in named]
    config = make_optimizer(name, lambda e: 1e-3 * 0.5 ** e, decay,
                            steps_per_epoch=2)
    card = [torch.nn.Parameter(p.detach().clone()) for _, p in named]
    plain = [torch.nn.Parameter(p.detach().clone()) for _, p in named]
    opt = config.build(card, cuda)
    cls = torch.optim.AdamW if name == "adamw" else torch.optim.Adam
    ref = cls(plain, lr=config.lr(0), weight_decay=decay)
    group = opt.param_groups[0]
    assert group["capturable"] and group["lr"].device.type == "cuda"
    assert not ref.param_groups[0]["capturable"]
    b1, b2, eps = 0.9, 0.999, 1e-8
    n = len(card)
    tol_p = [torch.zeros_like(p) for p in plain]
    est = [torch.zeros_like(p) for p in plain]
    bound_m = [torch.zeros_like(p) for p in plain]
    bound_v = [torch.zeros_like(p) for p in plain]
    worst = dict(param=0.0, estimate=0.0, mu=0.0, nu=0.0)
    parted = dict(params=0, mu=0, nu=0)
    for step in range(8):
        config.apply_lr(opt, step)
        for g in ref.param_groups:
            g["lr"] = config.lr(step)
        for ps in (card, plain):
            for p, g in zip(ps, grads):
                p.grad = g.clone()
        before = [p.detach().clone() for p in plain]
        opt.step()
        ref.step()
        t, lr = step + 1, config.lr(step)
        parted = dict(params=0, mu=0, nu=0)
        for i in range(n):
            p, q = card[i].detach(), plain[i].detach()
            mc, vc = (opt.state[card[i]][k] for k in ("exp_avg",
                                                      "exp_avg_sq"))
            mr, vr = (ref.state[plain[i]][k] for k in ("exp_avg",
                                                       "exp_avg_sq"))
            g_hat = grads[i] + (decay * before[i]
                                if name == "adam" else 0.0)
            e = (decay * tol_p[i] + 2.0 ** -23 * g_hat.abs()
                 if name == "adam" and decay else torch.zeros_like(q))
            bound_m[i] = b1 * bound_m[i] + (1 - b1) * e \
                + 2.0 ** -22 * mr.abs()
            bound_v[i] = b2 * bound_v[i] + (1 - b2) * e * (
                2 * g_hat.abs() + e) + 2.0 ** -22 * vr
            d = lr * (mr.abs() / (1 - b1 ** t)) / (
                (vr / (1 - b2 ** t)).sqrt() + eps)
            est[i] = est[i] + 1e-4 * d + 2.0 ** -22 * q.abs()
            tol_p[i] = 1e-6 + 1e-5 * q.abs()
            diff = (p - q).abs()
            assert (diff <= tol_p[i]).all(), (named[i][0], step)
            worst["param"] = max(worst["param"],
                                 float((diff / tol_p[i]).max()))
            worst["estimate"] = max(worst["estimate"], float(
                (diff / est[i].clamp_min(1e-30)).max()))
            parted["params"] += int((p != q).sum())
            for k, (a, b, bound) in (("mu", (mc, mr, bound_m[i])),
                                     ("nu", (vc, vr, bound_v[i]))):
                parted[k] += int((a != b).sum())
                if name == "adam" and decay:
                    assert ((a - b).abs() <= bound + 1e-30).all(), (
                        named[i][0], k, step)
                    worst[k] = max(worst[k], float(
                        ((a - b).abs() / (bound + 1e-30)).max()))
                else:
                    assert torch.equal(a, b), (named[i][0], k, step)
    assert config.lr(7) == 1e-3 * 0.5 ** 3
    print(f"capturable {name} decay {decay}: " + json.dumps(dict(
        entries=sum(p.numel() for p in plain), parted=parted,
        worst_ratio=worst,
        max_abs_param_diff=max(float((a.detach() - b.detach()).abs().max())
                               for a, b in zip(card, plain)))))


@pytest.mark.cuda
def test_captured_keys_share_one_pool_and_keep_the_eager_bits(cuda):
    """Shapes mixed call by call, as a server meets them and as an epoch
    ends in a partial batch: a captured 'mega' Trainer over batches of 16,
    16 and 12 twice (two keys), and a captured Scorer over requests of
    B=1, 4, 16 in turn three times (three keys), each against its eager
    twin. Every step's loss, gradients, parameters and Adam moments, and
    every request's probabilities, are the eager bits, though each key's
    scratch may hold another key's dead outputs; every graph of a program
    draws on the program's one memory pool."""
    sizes = (_CAPTURED_B, _CAPTURED_B, 12)
    batches = [random_sample_batch(b, N, 2560, 20, seed=10 + i,
                                   device=cuda) for i, b in enumerate(sizes)]
    runs = []
    for capture in (None, False):
        trainer, state = _captured_trainer(cuda, "HybridModelv2", "mega",
                                           "hybrid", 1, 0.0, capture)
        out = []
        for batch in batches * 2:
            state, loss = trainer.train_step(state, batch, seed=6)
            out.append((loss, [None if p.grad is None else p.grad.clone()
                               for p in state.model.parameters()],
                        [p.detach().clone()
                         for p in state.model.parameters()],
                        [v.clone() for p in state.model.parameters()
                         for v in state.optimizer.state[p].values()]))
        runs.append((trainer.train_program, out))
    program, got = runs[0]
    for (lc, gc, pc, mc), (le, ge, pe, me) in zip(got, runs[1][1]):
        assert torch.equal(lc, le)
        assert all(a is None and b is None or torch.equal(a, b)
                   for a, b in zip(gc, ge))
        assert all(torch.equal(a, b) for a, b in zip(pc, pe))
        assert all(torch.equal(a, b) for a, b in zip(mc, me))
    graphs = [e.graph for e in program._entries.values()]
    # the capturing call replays too: 16 warm, capture, 12 warm, 16 twice,
    # 12 capture
    assert (len(graphs), program.captures, program.replays) == (2, 2, 4)
    assert len({g.pool() for g in graphs}) == 1
    _, model = build_model("HybridModelv2", 20 * 21,
                           torch.Generator().manual_seed(1), device=cuda)
    captured, eager = _scorer_pair(cuda, model, aggregation="mega")
    for rnd in range(3):
        for b in (1, 4, 16):
            req = random_sample_batch(b, N, 2560, 20, seed=20 + rnd,
                                      device=cuda)
            args = (req.graph, req.seq_onehot, req.props)
            assert np.array_equal(captured(*args), eager(*args)), (rnd, b)
    program = captured.program
    graphs = [e.graph for e in program._entries.values()]
    assert (len(graphs), program.captures, program.replays) == (3, 3, 6)
    assert len({g.pool() for g in graphs}) == 1
