"""The Hopper kernels behind ``edge_mega`` (immunostruct_tpu_torch/csrc/
egnn_mega_fwd.cu, B1, and egnn_tail_bwd.cu, B2) and behind ``edge_program``
(egnn_edge_fwd.cu and egnn_edge_bwd.cu, B3) against their plain PyTorch
versions, on the card.

This file imports no JAX, so it also runs on a GPU machine without JAX.
There ``tests/conftest.py`` (which imports JAX) is skipped:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q

The tests marked ``cuda`` skip on a host without a CUDA device. Tolerances:

- B1, f32 (TF32 off; the CUDA-core form): atol=1e-5, rtol=1e-4, the
  roundoff of a different summation order (the kernel sums with
  shared-memory atomics). bf16 (the tensor-core form, one CTA per (graph,
  edge chunk), the chunks' node blocks summed in chunk order), per output
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
  (CUDA cores) and its bf16 form (tensor cores, csrc/egnn_tail.cuh).

- B3 forward and backward, f32: the outputs atol=1e-5, rtol=1e-4; the
  weight gradients as B2's. The backward's bf16 form runs its nine products
  on the tensor cores with B2's near-tie recompute (csrc/egnn_hopper.cuh);
  its f32 form stays on the CUDA cores. bf16, per row of the [B, C, E]
  outputs (over graphs and edges), for def and for each weight gradient:
  mean|diff| <= 2e-5 * mean|plain|, max|diff| <= 1.6e-2 * max|plain| for
  the edge outputs, 1e-3 for the weight gradients (B2's bounds: the same
  chain); and dbc1 no farther from the plain version's than from the sum
  of d_p3 unrounded (``_assert_edge_bwd_close``).
  chip_smoke.py holds the weight gradients at B=128 to a mean of 1e-4:
  each sums 16x the edges, and another f32 order flips other bf16
  roundings along the chain of many more edges;
  ``test_edge_bwd_smoke_bound_sees_every_rounding_point`` checks that
  every backward mutant fails that bound at that shape.

The kernels and the plain versions round at the same points, so they
differ only where a summation order flips one rounding; a kernel that
leaves out any one rounding point fails the mean bound, which
``test_bf16_bound_sees_every_rounding_point`` (B1),
``test_tail_bf16_bound_sees_every_rounding_point`` (B2) and
``test_edge_bf16_bound_sees_every_rounding_point`` (B3) check by building
such kernels.

- B4 (csrc/egnn_mega_paired_fwd.cu) on mirror-paired batches: B1's bounds
  against its plain version; its residuals equal B1's bit for bit on the
  same batch.
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
  column mean|diff| <= 1e-4 * mean|plain|.
  Its sums use shared-memory atomics, as B1's do: not the same bits twice.
- Mutants: seven of B1's bf16 form (W1ab, xd, radial, m, c1, cw,
  cw*x_hat; the table says why W2/Wc1, silu(a1) and pa/pb have none),
  seven of B3's backward (xd, radial, c1, cw, d_p2, d_p3, d_a1; its table
  says why W1ab, W2, Wc1, a1s and m have none), five of B2's tensor-core
  body (radial, c1, cw, d_p2, d_a1; the table says why W2/Wc1, a1s, m and
  d_p3 have none), eleven of B4 (the mirror's sign, xd, radial, and the
  CUDA-core chain it shares with B6 and B1's f32 form: W2/Wc1/W1ab, pa/pb,
  silu(a1), m, c1, cw, cw*x_hat), two of the shared tail body through B5a
  (d_p2, d_a1), one of B5b (d_xd before the node sums), five of B6 (agg,
  hmid, h, x, the node MLP's weights); each fails its kernel's bf16 bound.

- B8 (csrc/segment.cu, behind ``segment_scatter``/``segment_gather``): the
  gather bit for bit. The scatter, f32: |diff| <= 2 * k * 2^-24 * (the sum
  of |m| over the k edges of the element), the bound of two f32 sums of the
  same terms in other orders (the plain version on the card sums with
  atomics); bf16: within one bf16 step of the larger magnitude, or of
  2^-10 below that (both sum in f32 and round once).
  ``test_segment_bf16_bound_sees_f32_accumulation`` builds a scatter that
  accumulates in the compute dtype, which fails it.

- B7 (csrc/egnn_layer_fwd.cu, behind ``fused_egnn_layer``) at B=128,
  N=288, E=2560/1408/256, F=20/64, with unmasked edges whose src or dst is
  -1 or N: h' and x' f32 atol=1e-5, rtol=1e-4; bf16 per column (over graphs
  and nodes) max|diff| within one bf16 step at the column's largest
  |plain| (B6's form: a flip at a value just above a power of two is 2^-7
  of it, over B1's 4e-3) and mean|diff| <= 1e-4 * mean|plain| (an H100 run
  read h' equal bit for bit, x' one flip: max 2.1e-3 of the column's
  largest value, mean 3.2e-7). The same bits twice (no atomics). Ten
  mutants, each without one of B7's rounding points (the bias fold, the x
  cast, radial, silu(z1), m, c1, msg_x, agg, a, x' from x's own dtype; the
  two on x run f32 coordinates under bf16 features), fail the bf16 bound.
  c1 and msg_x reach x' only, through x_agg: at unit-scale coordinates x
  carries x' and their change can stay under the mean bound, so they run
  coordinates at 1/16 scale, where x_agg carries x'.
- 'paired' forward and train step under
  ``torch.cuda.set_sync_debug_mode("error")``; 'onehot'/'onehot_remat'
  layers and ``model_apply(fused_stack=True)`` against 'scatter' in f32.
"""

import json
import re

import pytest
import torch

from immunostruct_tpu_torch.data.synthetic import random_sample_batch
from immunostruct_tpu_torch.models import build_model, model_apply
from immunostruct_tpu_torch.data.synthetic import build_batch
from immunostruct_tpu_torch.ops import _build, edge, mega, segment, stack
from immunostruct_tpu_torch.ops.egnn import (
    EGNNLayer, egnn_apply, egnn_stack, egnn_stack_apply,
)
from immunostruct_tpu_torch.procedures.train import Trainer, make_optimizer
from immunostruct_tpu_torch.utils.losses import LossConfig
from immunostruct_tpu_torch.utils.schedule import constant_lr

N = 288


def _args(b, e, f, hid, dtype, device, seed, mask_rate=0.1):
    gen = torch.Generator().manual_seed(seed)
    src = torch.randint(0, N, (b, e), generator=gen, dtype=torch.int32)
    dst = torch.randint(0, N, (b, e), generator=gen, dtype=torch.int32)
    src[:, :8] = dst[:, :8]                                  # self-loops
    mask = torch.rand(b, e, generator=gen) >= mask_rate
    ef = torch.randn(b, e, 1, generator=gen)
    h = torch.randn(b, N, f, generator=gen)
    x = torch.randn(b, N, 3, generator=gen)
    layer = EGNNLayer(f, hid, hid, generator=gen, device=device)
    weights = [w.detach().contiguous()
               for w in mega.pack_params(layer.edge_mlp, layer.coord_mlp)]
    return [src.to(device), dst.to(device), mask.to(device),
            ef.to(device, dtype), h.to(device, dtype), x.to(device, dtype),
            *weights]


def _assert_close(out, ref, dtype):
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-4)
    else:
        diff = (out - ref).abs().flatten(0, 1)
        mag = ref.abs().flatten(0, 1)
        assert (diff.amax(0) <= 4e-3 * mag.amax(0)).all()
        assert (diff.mean(0) <= 1e-4 * mag.mean(0)).all()


def _assert_residuals_close(got, ref, dtype):
    for g, r in zip(got, ref):
        assert g.dtype == dtype and g.shape == r.shape
        if dtype == torch.float32:
            torch.testing.assert_close(g, r, atol=1e-5, rtol=1e-4)
        else:
            # one bf16 step; below 2^-10 the f32 roundoff of a1's sum of
            # terms of size ~1 (FMA on the card) can exceed a step
            g, r = g.float(), r.float()
            mag = torch.maximum(torch.maximum(g.abs(), r.abs()),
                                torch.tensor(2.0 ** -10, device=g.device))
            step = torch.exp2(torch.floor(torch.log2(mag)) - 7)
            assert ((g - r).abs() <= step).all()


def _tail_args(b, e, f, dtype, device, seed, mask_rate=0.1):
    """B2's operands: residuals from B1 on seeded inputs, and the cotangent
    of a seeded g gathered at dst (zero on skipped edges)."""
    args = _args(b, e, f, 64, dtype, device, seed, mask_rate)
    src, dst, mask, ef = args[:4]
    _, a1, xd = mega.edge_mega_fwd(*args)
    valid = mega.valid_edges(src, dst, mask, N)
    g = torch.randn(b, N, 67, generator=torch.Generator().manual_seed(seed))
    d = torch.where(valid, dst, 0).long()[..., None].expand(-1, -1, 67)
    d_both = torch.gather(g.to(device, dtype), 1, d)
    d_both = torch.where(valid[..., None], d_both, 0.0)
    return (ef, *args[7:], a1, xd, d_both.transpose(1, 2).contiguous(),
            valid)


def _assert_tail_close(out, ref, dtype):
    """B2 against its plain version (module docstring)."""
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
    rows = [(d_cat.float().transpose(0, 1).flatten(1),
             ref[0].float().transpose(0, 1).flatten(1), 1.6e-2),
            (d_ef.float().flatten()[None], ref[1].float().flatten()[None],
             1.6e-2)]
    rows += [(g.flatten()[None], r.flatten()[None], 1e-3)
             for g, r in zip(out[2:], ref[2:])]
    for g, r, max_tol in rows:
        diff, mag = (g - r).abs(), r.abs()
        assert (diff.amax(1) <= max_tol * mag.amax(1)).all()
        assert (diff.mean(1) <= 2e-5 * mag.mean(1)).all()


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
    _assert_tail_close(out, mega.tail_bwd_reference(*args), dtype)
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


# B1's bf16 form (the tensor-core kernel of csrc/egnn_mega_fwd.cu and the
# projections and geometry it shares in csrc/egnn_common.cuh) with one bf16
# rounding point left out: (pattern, replacement) pairs. W2, Wc1 and
# silu(a1) have no mutant: each reaches the tensor cores as a bf16 operand
# and is used nowhere else, so its rounding is the operand's type, which no
# edit of the arithmetic removes; nor pa/pb, which reach the edges through
# a bf16 scratch whose store rounds them. m keeps one through its f32
# consumer, the node block's sum (its rounding for the product is the
# operand's). B4's table keeps the CUDA-core chain's mutants.
_MUTANTS = {
    "weights": [(r"(w1s\[i\] = )rnd<T>\((w1ab\[i\])\)", r"\1\2")],
    "xd": [(r"rnd<T>\((to_f\(xb\[s \* 3 \+ \d\]\) - to_f\(xb\[d \* 3 \+ "
            r"\d\]\))\)", r"(\1)")],
    "radial": [(r"(r = )rnd<T>\((d0 \* d0 \+ d1 \* d1 \+ d2 \* d2)\)",
                r"\1\2")],
    "m": [(r"(const float mv = )rnd<bf>\((p \* sigmoid_fast\(p\))\)",
           r"\1\2")],
    "coord_hidden": [(r"(const float c1 = )rnd<bf>\((p \* sigmoid_fast\(p\))\)",
                      r"\1\2")],
    "cw": [(r"(const float cwb = )rnd<bf>\((cw)\)", r"\1\2")],
    "cw_xhat": [(r"rnd<bf>\((cwb \* g\.xh\[t \* 3 \+ k\])\)", r"(\1)")],
}


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


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_MUTANTS))
def test_bf16_bound_sees_every_rounding_point(cuda, name, tmp_path,
                                              monkeypatch, restore_kernels):
    _mutant_kernel(("egnn_mega_fwd.cu", "egnn_common.cuh"), _MUTANTS[name],
                   tmp_path, monkeypatch)
    for e, f in ((2560, 20), (1408, 64)):
        args = _args(8, e, f, 64, torch.bfloat16, cuda, seed=e + f)
        out = mega.edge_mega(*args)
        with pytest.raises(AssertionError):
            _assert_close(out, mega.edge_mega_reference(*args),
                          torch.bfloat16)


# B2 with one bf16 rounding point left out, in the tensor-core body it
# shares with B5a and B5b (csrc/egnn_tail.cuh, bf16 only) and the chain
# steps that body shares with B3's backward (csrc/egnn_hopper.cuh). W2/Wc1, a1s and m
# have no mutant: each reaches the tensor cores as a bf16 operand and is
# used nowhere else, so its rounding is the operand's store, which no edit
# of the arithmetic removes. d_p2, d_p3 and d_a1 also feed bf16 operands;
# a mutant leaves out the rounding where the value meets an f32 consumer
# outside the products: d_p2 in db2, d_a1 in the per-edge sums that give
# d_rad (hence d_xd) and d_ef. d_p3's is dbc1 (where gbc1 adds
# `__low2float(q)`, add `d3[0]`, and `d3[1]` for `__high2float(q)`), not
# in the table: dbc1 is one of the six columns of dsmall, held as one
# row, and among its smallest, and the row's mean bound does not see that
# mutant at these inputs (it did not raise on the card); it waits for a
# bound per dsmall column. d_xd and d_ef round at their store in the
# compute dtype, which no edit of the arithmetic removes.
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
        with pytest.raises(AssertionError):
            _assert_tail_close(out, mega.tail_bwd_reference(*args),
                               torch.bfloat16)


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
    with pytest.raises(AssertionError):
        _assert_tail_close(out, mega.tail_bwd_reference(*args),
                           torch.bfloat16)


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
def test_admission_covers_the_kernels_shared_memory(cuda):
    """``mega_admits`` decides 'auto' from ``fwd_smem_bytes``, a copy of
    the f32 form's formula: for every N it admits, from 16 up, B1's form in
    either dtype needs no more shared memory a CTA than that."""
    lib = mega._fwd_lib()
    n = 16
    while mega.mega_admits(n, 64, 64, 1):
        for bf16 in (0, 1):
            assert (mega.fwd_smem_bytes(n, 64)
                    >= lib.egnn_mega_fwd_smem_bytes(n, 64, bf16))
        n += 1
    assert n > N


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

def _edge_args(b, e, f, dtype, device, seed, mask_rate=0.1, tail=0):
    """B3's operands as the 'fused' path builds them: [h ++ x] bundles
    gathered by src and dst, zeros for a masked edge (and for the last
    ``tail`` edges), and a seeded cotangent of the output."""
    src, dst, mask, ef, h, x, w1ab, w2, wc1, small = _args(
        b, e, f, 64, dtype, device, seed, mask_rate)
    if tail:
        mask[:, e - tail:] = False
    rows = torch.cat([h, x], dim=-1)

    def bundle(idx):
        got = torch.gather(rows, 1, idx.long()[..., None].expand(
            -1, -1, f + 3))
        return torch.where(mask[..., None], got, 0.0).transpose(1, 2) \
            .contiguous()

    dout = torch.randn(b, 67, e, generator=torch.Generator().manual_seed(
        seed)).to(device, dtype)
    return (bundle(src), bundle(dst), ef.transpose(1, 2).contiguous(),
            w1ab, w2, wc1, small), dout


def _rows(t):
    """[B, C, E] -> [C, B*E]: one row per channel."""
    return t.float().transpose(0, 1).flatten(1)


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
    rows = [(_rows(g), _rows(r), 1.6e-2, 2e-5) for g, r in edge_out]
    rows += [(g.flatten()[None], r.flatten()[None], 1e-3, grad_mean)
             for g, r in grads]
    for g, r, max_tol, mean_tol in rows:
        diff, mag = (g - r).abs(), r.abs()
        assert (diff.amax(1) <= max_tol * mag.amax(1)).all()
        assert (diff.mean(1) <= mean_tol * mag.mean(1)).all()


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
        k, r = out[6][:, edge.BC1], ref[6][:, edge.BC1]
        u = edge.d_p3_unrounded_sum(*args, dout)
        assert (k - r).abs().mean() <= (k - u).abs().mean()


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


# B3's forward with one bf16 rounding point left out (its output rounds at
# its store in the compute dtype, which no edit of the arithmetic removes)
_EDGE_FWD_MUTANTS = {
    "weights": [(r"(w1s\[i\] = )rnd<T>\((w1ab\[i\])\)", r"\1\2"),
                (r"(w2s\[i\] = )rnd<T>\((w2\[i\])\)", r"\1\2"),
                (r"(wc1s\[i\] = )rnd<T>\((wc1\[i\])\)", r"\1\2")],
    "xd": [(r"(d\[k\] = )rnd<T>\(", r"\1(")],
    "radial": [(r"(const float r = )rnd<T>\((d\[0\] \* d\[0\] \+ "
                r"d\[1\] \* d\[1\] \+ d\[2\] \* d\[2\])\)", r"\1\2")],
    "silu_a1": [(r"(bufA\[t \* LD \+ j\] = )rnd<T>\((a1 \* sigmoid\(a1\))\)",
                 r"\1\2")],
    "m": [(r"(bufM\[t \* LD \+ j\] = )rnd<T>\((p \* sigmoid\(p\))\)",
           r"\1\2")],
    "coord_hidden": [(r"(part \+= )rnd<T>\((p \* sigmoid\(p\))\)",
                      r"\1\2")],
    "cw": [(r"(const float cwb = )rnd<T>\((cw)\)", r"\1\2")],
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
    _mutant_kernel(source if fwd else (source, "egnn_hopper.cuh"),
                   table[name], tmp_path, monkeypatch)
    for args, dout in inputs:
        if fwd:
            out = edge.edge_program_fwd(*args)
            ref = edge.edge_program_reference(*args)
        else:
            out = edge.edge_program_bwd(*args, dout)
            ref = edge.edge_program_bwd_reference(*args, dout)
        with pytest.raises(AssertionError):
            if fwd:
                _assert_edge_close(out, ref, torch.bfloat16)
            else:
                _assert_edge_bwd_close(args, dout, out, ref, torch.bfloat16)


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
    with pytest.raises(AssertionError):
        _assert_edge_close(out, edge.edge_program_bwd_reference(*args, dout),
                           torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_EDGE_BWD_MUTANTS))
def test_edge_bwd_smoke_bound_sees_every_rounding_point(
        cuda, name, tmp_path, monkeypatch, restore_kernels):
    """At chip_smoke.py's shape (B=128, E=2560, F=20, bf16) and with its
    checks (the mean bound on the weight gradients 1e-4, five times the one
    above: 16x the edges in each f32 sum; dbc1 as above), each backward
    mutant still fails. The per-output mean ratios are printed (pytest
    -s)."""
    args, dout = _edge_args(128, 2560, 20, torch.bfloat16, cuda, seed=2582)
    ref = edge.edge_program_bwd_reference(*args, dout)
    _mutant_kernel(("egnn_edge_bwd.cu", "egnn_hopper.cuh"),
                   _EDGE_BWD_MUTANTS[name], tmp_path, monkeypatch)
    out = edge.edge_program_bwd(*args, dout)
    print(f"B3 bwd mutant {name}:", json.dumps(_mean_ratios(out, ref)))
    with pytest.raises(AssertionError):
        _assert_edge_bwd_close(args, dout, out, ref, torch.bfloat16,
                               grad_mean=1e-4)


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

def _segment_args(b, e, n, c, dtype, device, seed, mask_rate=0.1):
    """idx/mask [B, E] with indices -1 and n on masked and unmasked edges
    and a few self-loop-like repeats; m [B, E, C], h [B, N, C]."""
    gen = torch.Generator().manual_seed(seed)
    idx = torch.randint(0, n, (b, e), generator=gen, dtype=torch.int32)
    mask = torch.rand(b, e, generator=gen) >= mask_rate
    idx[:, 0:4], idx[:, 4:8] = -1, n
    mask[:, 0:8:2] = False
    idx[:, 8:12] = idx[:, 12:16]
    m = torch.randn(b, e, c, generator=gen)
    h = torch.randn(b, n, c, generator=gen)
    return idx.to(device), mask.to(device), m.to(device, dtype), \
        h.to(device, dtype)


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
        mag = torch.maximum(torch.maximum(got.abs(), want.abs()),
                            torch.tensor(2.0 ** -10, device=got.device))
        step = torch.exp2(torch.floor(torch.log2(mag)) - 7)
        assert ((got - want).abs() <= step).all()


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
    idx, mask, m, _ = _segment_args(2, 128, 2048, 8, torch.float32, cuda, 6)
    with pytest.raises(ValueError, match="shared memory"):
        segment.segment_scatter(idx, mask, m, 2048)


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
_SEGMENT_MUTANT = [(r"acc\[n \* kLD \+ lane\] \+= (tile\[\(t0 \+ j\) \* kLD "
                    r"\+ lane\]);",
                    r"acc[n * kLD + lane] = to_f<T>(from_f<T>("
                    r"acc[n * kLD + lane] + \1));")]


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
        with pytest.raises(AssertionError):
            _assert_scatter_close(out, ref, idx, mask, m)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pallas_layer_gradients_on_card(cuda, dtype, monkeypatch):
    """One EGNN layer through 'pallas' (B8's scatter forward, its gather in
    the backward) against the same layer with B8's plain versions: one
    launch of each; outputs and gradients within |diff| <= 1e-4 * max +
    1e-3 * |plain| in f32. bf16, per tensor: mean|diff| <= 2 * (the plain
    layer's own run-to-run mean|diff|) + 1e-4 * mean|plain|: the backward of
    the layer's index_select gathers adds in bf16 with atomics, so h's and
    the edge MLP's gradients move from run to run (the outputs do not)."""
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
            h2, x2 = egnn_apply(layer, hin, xin, src, dst, ef, mask,
                                "pallas")
            ((h2 * cot_h).float().sum()
             + (x2 * cot_x).float().sum()).backward()
        torch.cuda.synchronize()
        launched = (segment.segment_scatter.launches - before[0],
                    segment.segment_gather.launches - before[1])
        assert launched == ((1, 1) if kernels else (0, 0))
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

def _paired_args(b, e, f, dtype, device, seed, mask_rate=0.1):
    """B1's operands on a mirror-paired batch (edge k + E/2 the reverse of
    edge k, masks mirrored), with arcs at index -1 and N, masked and not."""
    args = _args(b, e, f, 64, dtype, "cpu", seed, mask_rate)
    gen = torch.Generator().manual_seed(seed + 1)
    half = e // 2
    s0 = torch.randint(0, N, (b, half), generator=gen, dtype=torch.int32)
    d0 = (s0 + torch.randint(1, N, (b, half), generator=gen,
                             dtype=torch.int32)) % N
    s0[:, 8:12] = -1                                        # out of range
    d0[:, 12:16] = N
    m0 = torch.rand(b, half, generator=gen) >= mask_rate
    m0[:, 8] = m0[:, 12] = False
    args[0], args[1] = torch.cat([s0, d0], 1), torch.cat([d0, s0], 1)
    args[2] = torch.cat([m0, m0], 1)
    return [t.to(device) for t in args]


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


# B4 (csrc/egnn_mega_paired_fwd.cu and the CUDA-core chain it shares with
# B6 and B1's f32 form in csrc/egnn_common.cuh: stage_edge_weights,
# node_projections, fwd_tile_chain) with one bf16 rounding point left out,
# or the mirror's sign. The chain's eight were B1's mutants until B1's bf16
# form moved to the tensor cores; B4 runs that chain in bf16 still.
_PAIRED_SOURCES = ("egnn_mega_paired_fwd.cu", "egnn_common.cuh")
_PAIRED_MUTANTS = {
    "mirror_sign": [(r"g\.xh\[m \* 3 \+ (\d)\] = -h\1;",
                     r"g.xh[m * 3 + \1] = h\1;")],
    "xd": [(r"rnd<T>\((to_f\(xb\[s \* 3 \+ \d\]\) - to_f\(xb\[d \* 3 \+ "
            r"\d\]\))\)", r"(\1)")],
    "radial": [(r"(r = )rnd<T>\((d0 \* d0 \+ d1 \* d1 \+ d2 \* d2)\)",
                r"\1\2")],
    "weights": [(r"(w2s\[i\] = )rnd<T>\((w2\[i\])\)", r"\1\2"),
                (r"(wc1s\[i\] = )rnd<T>\((wc1\[i\])\)", r"\1\2"),
                (r"(w1s\[i\] = )rnd<T>\((w1ab\[i\])\)", r"\1\2")],
    "pa_pb": [(r"(pab\[i\] = )rnd<T>\((s)\)", r"\1\2")],
    "silu_a1": [(r"(v = )rnd<T>\((silu\(a1\))\)", r"\1\2")],
    "m": [(r"(mv = )rnd<T>\((silu\(r\[i\]\[c\] \+ "
           r"sms\[kB2 \* H \+ j\]\))\)", r"\1\2")],
    "coord_hidden": [(r"(c1 = )rnd<T>\((silu\(r\[i\]\[c\] \+ "
                      r"sms\[kBC1 \* H \+ j\]\))\)", r"\1\2")],
    "cw": [(r"(cwb = )rnd<T>\((part)\)", r"\1\2")],
    "cw_xhat": [(r"rnd<T>\((cwb \* g\.xh\[t \* 3 \+ \d\])\)",
                 r"(\1)")],
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_PAIRED_MUTANTS))
def test_paired_bf16_bound_sees_every_rounding_point(cuda, name, tmp_path,
                                                     monkeypatch,
                                                     restore_kernels):
    _mutant_kernel(_PAIRED_SOURCES, _PAIRED_MUTANTS[name], tmp_path,
                   monkeypatch)
    for e, f in ((2560, 20), (1408, 64)):
        args = _paired_args(8, e, f, torch.bfloat16, cuda, seed=e + f)
        out = mega.edge_mega_paired_fwd(*args, residuals=False)[0]
        with pytest.raises(AssertionError):
            _assert_close(out, mega.edge_mega_paired_fwd_reference(*args)[0],
                          torch.bfloat16)


def _tail_g_args(b, e, f, dtype, device, seed, mask_rate=0.1):
    """B5's operands: B1's residuals on seeded inputs with indices at -1 and
    N, and a seeded node cotangent g [B, N, H+3] in the compute dtype:
    (src, dst, valid, ef, w2, wc1, small, a1, xd, g)."""
    args = _args(b, e, f, 64, dtype, "cpu", seed, mask_rate)
    args[0][:, 8:12] = -1
    args[1][:, 12:16] = N
    args = [t.to(device) for t in args]
    src, dst, mask, ef = args[:4]
    _, a1, xd = mega.edge_mega_fwd(*args)
    g = torch.randn(b, N, 67, generator=torch.Generator().manual_seed(seed))
    return (src, dst, mega.valid_edges(src, dst, mask, N), ef, *args[7:],
            a1, xd, g.to(device, dtype))


def _b2_of(src, dst, valid, ef, w2, wc1, small, a1, xd, g):
    """B2's operands from B5's: d_both = g[dst] gathered by PyTorch."""
    d_both = mega._gather_rows(g, dst, valid).transpose(1, 2).contiguous()
    return ef, w2, wc1, small, a1, xd, d_both, valid


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
    _assert_tail_close(out, mega.tail_bwd_db_reference(*db_args), dtype)
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
    diff, mag = (g - r).abs(), r.abs()
    assert (diff.amax(1) <= TAIL_MAX_EDGE * mag.amax(1)).all()
    assert (diff.mean(1) <= TAIL_MEAN * mag.mean(1)).all()


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
        if kernel == "db":
            db_args = (args[1], *args[2:])
            out = mega.tail_bwd_db(*db_args)
            with pytest.raises(AssertionError):
                _assert_tail_close(out, mega.tail_bwd_db_reference(*db_args),
                                   torch.bfloat16)
        else:
            out = mega.tail_bwd_nodes(*args)
            with pytest.raises(AssertionError):
                _assert_nodes_close(
                    out[0], mega.tail_bwd_nodes_reference(*args)[0],
                    torch.bfloat16)


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
            _assert_tail_close((fake, *out[1:]), (fake, *ref[1:]), dtype)
        else:
            _assert_tail_close(out, ref, dtype)
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


def _stack_args(b, e, dtype, device, seed, mask_rate=0.1):
    """B6's operands: HybridModelv2's conv stack (F0=20, H=64, six layers)
    with seeded weights, and seeded inputs with 10% of the edges masked and
    indices at -1 and N."""
    src, dst, mask, ef, h, x = _args(b, e, 20, 64, dtype, "cpu", seed,
                                     mask_rate)[:6]
    src[:, 8:12] = -1
    dst[:, 12:16] = N
    gen = torch.Generator().manual_seed(seed)
    layers = egnn_stack(5, 20, 64, generator=gen, device=device)
    packed = [tuple(t.detach() for t in stack.pack_layer(p)) for p in layers]
    return [t.to(device) for t in (src, dst, mask, ef, h, x)], packed


def _assert_agg_steps_close(got, ref):
    """B6's aggregate, rounded to bf16 by kernel and plain version alike:
    per column (over graphs and nodes) max|diff| <= one bf16 step at the
    column's largest |plain| and mean|diff| <= 1e-4 * mean|plain|."""
    g, r = got.float().flatten(0, 1), ref.float().flatten(0, 1)
    diff, mag = (g - r).abs(), r.abs()
    top = mag.amax(0).clamp_min(torch.finfo(torch.float32).tiny)
    assert (diff.amax(0) <= torch.exp2(torch.floor(torch.log2(top)) - 7)).all()
    assert (diff.mean(0) <= 1e-4 * mag.mean(0)).all()


def _assert_stack_layers_close(out, args, packed, dtype):
    """Each layer of B6's outputs against the plain version of that layer
    run from the kernel's own previous h and x (module docstring)."""
    h, x, hs, xs, aggs, a1s, xds = out
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
        if dtype == torch.float32:
            for g, w in zip(got[:3], want[:3]):
                torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-4)
            continue
        _assert_agg_steps_close(got[2], want[2])
        for g, w in zip(got[:2], want[:2]):
            g, w = g.float().flatten(0, 1), w.float().flatten(0, 1)
            assert ((g - w).abs().mean(0) <= 1e-4 * w.abs().mean(0)).all()


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


# B6's source with one bf16 rounding point left out
_STACK_MUTANTS = {
    "agg": [(r"(const float v = )rnd<T>\((acc\[i\])\)", r"\1\2")],
    "hmid": [(r"rnd<T>\((silu\(p\[i\]\[c\] \+ nbs\[j\]\))\)", r"\1")],
    "h": [(r"(const float v = )rnd<T>\((q\[i\]\[c\] \+ nbs\[H \+ j\])\)",
           r"\1\2")],
    "x": [(r"(const float v = )rnd<T>\((xsm\[i\] \+ "
           r"acc\[\(i / 3\) \* C \+ H \+ i % 3\])\)", r"\1\2")],
    "node_weights": [(r"(nm0s\[i\] = )rnd<T>\((nm0w\[i\])\)", r"\1\2"),
                     (r"(nm1s\[i\] = )rnd<T>\((nm1w\[i\])\)", r"\1\2")],
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_STACK_MUTANTS))
def test_stack_bf16_bound_sees_every_rounding_point(cuda, name, tmp_path,
                                                    monkeypatch,
                                                    restore_kernels):
    inputs = [_stack_args(8, e, torch.bfloat16, cuda, seed=e + 8)
              for e in (2560, 1408)]
    _mutant_kernel("egnn_stack_fwd.cu", _STACK_MUTANTS[name], tmp_path,
                   monkeypatch)
    for args, packed in inputs:
        out = stack.stack_fwd(*args, packed)
        with pytest.raises(AssertionError):
            _assert_stack_layers_close(out, args, packed, torch.bfloat16)


_VARIANT_LAUNCHES = {                   # per train step of six layers
    "hybrid": dict(B1=6, B2=6), "dboth": dict(B1=6, B5a=6),
    "inkernel": dict(B1=6, B5b=6), "paired": dict(B4=6, B2=6),
    "stack": dict(B6=1, B2=6),
}


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(_VARIANT_LAUNCHES))
def test_variant_train_step_launches_its_kernels(cuda, variant):
    """One bf16 training step of full-width HybridModelv2 at B=16 on a
    mirror-paired batch: the variant's kernels and no other, a finite loss
    and finite gradients."""
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


def _b7_args(b, e, f, dtype, device, seed, x_dtype=None, mask_rate=0.1,
             x_scale=1.0):
    """B7's operands: a seeded EGNN layer (H=64) and seeded inputs with 10%
    of the edges masked, self-loops and unmasked edges whose src or dst is
    -1 or N; the coordinates times ``x_scale``."""
    src, dst, mask, _, h, x = _args(b, e, f, 64, torch.float32, "cpu", seed,
                                    mask_rate)[:6]
    src[:, 8:10], src[:, 10:12] = -1, N
    dst[:, 12:14], dst[:, 14:16] = -1, N
    mask[:, 8:16] = True
    layer = EGNNLayer(f, 64, 64, generator=torch.Generator().manual_seed(seed),
                      device=device)
    return layer, [h.to(device, dtype),
                   (x * x_scale).to(device, x_dtype or dtype),
                   src.to(device), dst.to(device), mask.to(device)]


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
        g, w = got.float().flatten(0, 1), want.float().flatten(0, 1)
        diff, mag = (g - w).abs(), w.abs()
        top = mag.amax(0).clamp_min(torch.finfo(torch.float32).tiny)
        assert (diff.amax(0) <= torch.exp2(torch.floor(torch.log2(top))
                                           - 7)).all()
        assert (diff.mean(0) <= B7_BF16_COL_MEAN * mag.mean(0)).all()


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


# B7's source with one bf16 rounding point of pallas_egnn.py left out
_B7_MUTANTS = {
    "bias_fold": [(r"rnd<T>\((to_f\(w\.be1\[j\]\) \+ to_f\(w\.w_ef\[j\]\))\)",
                   r"(\1)")],
    "x_cast": [(r"(xc\[i\] = )rnd<T>\((to_f\(xb\[i\]\))\)", r"\1\2")],
    "radial": [(r"(rad\[tid\] = )rnd<T>\((r)\)", r"\1\2")],
    "m1": [(r"rnd<T>\((silu\(z1\))\)", r"\1")],
    "m": [(r"(const float mv = )rnd<T>\((silu\(r\[i\]\[c\] \+ "
           r"vec\[kBe2 \* H \+ j\]\))\)", r"\1\2")],
    "c1": [(r"(const float c1 = )rnd<T>\((silu\(r\[i\]\[c\] \+ "
            r"vec\[kBc1 \* H \+ j\]\))\)", r"\1\2")],
    "msg_x": [(r"rnd<T>\((__fmul_rn\(cw, xh\[t \* 3 \+ k\]\))\)", r"\1")],
    "agg": [(r"(acc\[i\] = )rnd<T>\((acc\[i\])\)", r"\1\2")],
    "a": [(r"rnd<T>\((silu\(zn\))\)", r"\1")],
    "x_own_dtype": [(r"from_f<XT>\(to_f\(xb\[i\]\) \+ accx\[i\]\)",
                     r"from_f<XT>(xc[i] + accx[i])")],
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
    run bf16 features over f32 coordinates. c1 and msg_x reach x' only
    through x_agg: those two run coordinates at 1/16 scale (module
    docstring)."""
    x_dtype = torch.float32 if name in ("x_cast", "x_own_dtype") else None
    x_scale = 1 / 16 if name in ("c1", "msg_x") else 1.0
    inputs = [_b7_args(32, e, f, torch.bfloat16, cuda, seed=e + f,
                       x_dtype=x_dtype, x_scale=x_scale)
              for e, f in ((2560, 20), (1408, 64))]
    _mutant_kernel("egnn_layer_fwd.cu", _B7_MUTANTS[name], tmp_path,
                   monkeypatch)
    fused_layer._lib.cache_clear()
    try:
        failed = 0
        for layer, args in inputs:
            with torch.no_grad():
                out = fused_layer.fused_egnn_layer(layer, *args)
                ref = fused_layer.fused_egnn_layer_reference(layer, *args)
            try:
                _assert_b7_close(out, ref, torch.bfloat16)
            except AssertionError:
                failed += 1
        assert failed == len(inputs), name
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
