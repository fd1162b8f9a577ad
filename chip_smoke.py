#!/usr/bin/env python3
"""Smoke test of the PyTorch port (immunostruct_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (none catches its own failure; any failure exits non-zero):
  1. require CUDA;
  2. print the card's name and power limit (nvidia-smi);
  3. build both Hopper kernels with nvcc (first use): csrc/egnn_mega_fwd.cu
     (B1, the EGNN edge forward) and csrc/egnn_tail_bwd.cu (B2, its
     backward);
  4. compare B1 with its plain PyTorch version on the card at the main
     path's shapes (B=128, N=288, H=64, E=2560 and 1408, F=20 and 64, 10% of
     the edges masked, self-loops), in f32 (TF32 off) and bf16, output and
     the a1/xd residuals, and time the kernel with and without its residual
     stores and the plain version;
  5. compare B2 with its plain version at the same shapes (its residuals
     from B1, a seeded cotangent), and time both;
  6. compare the EdgeMega gradients (B1 + B2 + the node-level backward) with
     autograd through the plain forward (f32) and with the plain backward
     (bf16) at B=128, E=2560, F=64;
  7. serve full-width HybridModelv2 with seeded weights in bf16 over HTTP on
     127.0.0.1 (ephemeral port), POST requests (B=128 at E=2560, B=128 at
     E=1408, B=1): probabilities finite, in (0, 1), matching the same batch
     through aggregation='scatter', the same when a request is sent again,
     6 B1 launches and no B2 launch per request;
  8. train full-width HybridModelv2 (bf16 over f32 master weights, Adam
     1e-3, the loss config of the JAX package's bench) on
     random_sample_batch(128, 288, E, 284) for E=2560 and 1408: the first
     step's loss and gradients under 'mega' against 'scatter' from the same
     weights, then 20 'mega' steps (6 B1 + 6 B2 launches each, finite loss
     that falls) and 10 'scatter' steps, with the median step time;
  9. the comparative twin step (HybridModelv2_Comparative, the contrastive
     term at 0.1, random_comparative_batch at E=2560): the first step's loss
     and gradients under 'mega' against 'scatter', in f32 and in bf16, then
     6 steps: 12 B1 + 12 B2 launches per step, finite loss, median step
     time. Its loss is not required to fall: the contrastive term dominates
     it and wanders with each step's noise (PERF.md, Findings);
  10. trace forwards and train steps with torch.profiler ('mega' and
     'scatter') and print the device-busy time, the device's idle share and
     the kernels that take the most device time;
  11. print the times beside the card's name and power limit, then the kernel
     record as one JSON line, the card line and, last, the result line
     {"ok": true, "device": {...}}.
"""

from __future__ import annotations

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
TIMED_REQUESTS = 5
TRAIN_STEPS = 20
SCATTER_STEPS = 10
COMPARATIVE_STEPS = 6


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


def check_fwd_kernel() -> list:
    from immunostruct_tpu_torch.ops.mega import (
        edge_mega_fwd, edge_mega_fwd_reference,
    )

    rows = []
    for e in EDGE_COUNTS:
        for f in (20, 64):
            for name, dtype in (("float32", torch.float32),
                                ("bfloat16", torch.bfloat16)):
                args = kernel_inputs(B, e, f, dtype, seed=e + f)
                out, a1, xd = edge_mega_fwd(*args, residuals=True)
                torch.cuda.synchronize()
                ref, a1_ref, xd_ref = edge_mega_fwd_reference(*args)
                assert out.shape == (B, N, H + 3) and out.dtype == torch.float32
                assert torch.isfinite(out).all()
                err = (out - ref).abs().max().item()
                rel = {}
                if dtype == torch.float32:
                    torch.testing.assert_close(out, ref, **F32_TOL)
                    tol = f"atol={F32_TOL['atol']} rtol={F32_TOL['rtol']}"
                else:
                    rel = bf16_errors(out, ref)
                    assert rel["col_max_rel"] <= BF16_COL_MAX, rel
                    assert rel["col_mean_rel"] <= BF16_COL_MEAN, rel
                    tol = (f"per column: max <= {BF16_COL_MAX}*max|ref|, "
                           f"mean <= {BF16_COL_MEAN}*mean|ref|")
                res_err = residual_errors((a1, xd), (a1_ref, xd_ref), dtype)
                assert res_err <= 1.0, res_err
                out_nores = edge_mega_fwd(*args, residuals=False)[0]
                torch.testing.assert_close(out_nores, out, atol=1e-5,
                                           rtol=1e-5)
                ms, plain_ms = alternate_ms(
                    lambda: edge_mega_fwd_reference(*args),
                    lambda: edge_mega_fwd(*args, residuals=False))
                res_ms = cuda_ms(lambda: edge_mega_fwd(*args, residuals=True))
                row = dict(E=e, F=f, dtype=name, max_abs_err=err,
                           max_abs_ref=ref.abs().max().item(), **rel,
                           tolerance=tol, residual_err_in_tol=res_err,
                           ms=ms, ms_with_residuals=res_ms,
                           plain_ms=plain_ms)
                print("kernel B1:", json.dumps(row), flush=True)
                rows.append(row)
                del args, out, ref, a1, xd, a1_ref, xd_ref
    return rows


def tail_inputs(e: int, f: int, dtype, seed: int):
    """B2's operands: B1's residuals on seeded inputs, and a seeded node
    cotangent gathered at dst (zero on skipped edges)."""
    from immunostruct_tpu_torch.ops.mega import edge_mega_fwd, valid_edges

    args = kernel_inputs(B, e, f, dtype, seed)
    src, dst, mask, ef = args[:4]
    _, a1, xd = edge_mega_fwd(*args, residuals=True)
    valid = valid_edges(src, dst, mask, N)
    g = torch.randn(B, N, H + 3, generator=torch.Generator().manual_seed(seed))
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


def check_tail_kernel() -> list:
    from immunostruct_tpu_torch.ops.mega import tail_bwd, tail_bwd_reference

    rows = []
    for e in EDGE_COUNTS:
        for f in (20, 64):
            for name, dtype in (("float32", torch.float32),
                                ("bfloat16", torch.bfloat16)):
                args = tail_inputs(e, f, dtype, seed=e + f + 1)
                out = tail_bwd(*args)
                torch.cuda.synchronize()
                ref = tail_bwd_reference(*args)
                stats = tail_errors(out, ref, dtype)
                again = tail_bwd(*args)
                assert all(torch.equal(g, h)
                           for g, h in zip(out[2:], again[2:])), \
                    "B2 weight gradients changed from one run to the next"
                ms, plain_ms = alternate_ms(
                    lambda: tail_bwd_reference(*args),
                    lambda: tail_bwd(*args))
                row = dict(E=e, F=f, dtype=name, **stats, ms=ms,
                           plain_ms=plain_ms)
                print("kernel B2:", json.dumps(row), flush=True)
                rows.append(row)
                del args, out, ref, again
    return rows


def check_edge_mega_grads() -> list:
    """EdgeMega's gradients (B1 + B2 + edge_half_bwd) against the plain
    path at B=128, E=2560, F=64."""
    from immunostruct_tpu_torch.ops.mega import (
        EdgeMega, edge_half_bwd, edge_mega_fwd_reference, edge_mega_reference,
        tail_bwd_reference, valid_edges,
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
                                 *args[3:], a1, xd, cot,
                                 tail=tail_bwd_reference)
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


def reset_counts():
    from immunostruct_tpu_torch.ops.mega import edge_mega, tail_bwd

    edge_mega.launches = 0
    tail_bwd.launches = 0


def read_counts() -> tuple:
    from immunostruct_tpu_torch.ops.mega import edge_mega, tail_bwd

    return edge_mega.launches, tail_bwd.launches


def check_serving(scorer, requests) -> tuple:
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
            assert launches == (layers, 0), (label, launches)
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
            assert read_counts()[0] - before[0] == layers * TIMED_REQUESTS
            assert repeat_err <= PROB_ATOL, (label, repeat_err)
            row = dict(request=label, launches_per_request=launches[0],
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
                 seed: int = 0, compute_dtype=torch.bfloat16):
    """A full-width model with seeded weights, its trainer (bf16 over f32
    master weights unless ``compute_dtype`` says otherwise, Adam at 1e-3,
    the JAX bench's loss config) and state."""
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
                      compute_dtype=compute_dtype)
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
               coeff: float = 0.0) -> tuple:
    """The first step's loss and gradients (float64, by parameter name),
    from seeded weights and the step's seeded noise."""
    from immunostruct_tpu_torch.procedures.train import step_generator

    trainer, state = make_trainer(name, aggregation, coeff,
                                  compute_dtype=compute_dtype)
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


def first_step_mega_vs_scatter(batch) -> dict:
    """HybridModelv2's first step in bf16, 'mega' against 'scatter', from
    the same weights and the same noise."""
    lm, gm = first_step(batch, "HybridModelv2", "mega", torch.bfloat16)
    ls, gs = first_step(batch, "HybridModelv2", "scatter", torch.bfloat16)
    top = largest_norm(gs)
    worst, worst_name = worst_grad(
        gm, gs, lambda n: STEP_GRAD_RTOL * gs[n].norm().item()
        + STEP_GRAD_ATOL * top)
    loss_rel = abs(lm - ls) / abs(ls)
    assert loss_rel <= STEP_LOSS_RTOL, (lm, ls)
    assert worst <= 1.0, (worst_name, worst)
    return dict(loss_mega=lm, loss_scatter=ls, loss_rel_diff=loss_rel,
                grad_worst_in_tol=worst, grad_worst_param=worst_name)


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
    """Phase 8: the train step, this slice's main path."""
    from immunostruct_tpu_torch.data.synthetic import random_sample_batch

    layers = 6
    rows = []
    main_counts = (0, 0)
    for e in EDGE_COUNTS:
        batch = random_sample_batch(B, N, e, L, seed=0, device="cuda")
        first = first_step_mega_vs_scatter(batch)
        print(f"train first step E={e}:", json.dumps(first), flush=True)
        trainer, state = make_trainer("HybridModelv2", "mega")
        reset_counts()                  # every count to 0: training starts
        losses, ms = timed_steps(trainer, state, batch, TRAIN_STEPS)
        counts = read_counts()          # read just after the 'mega' steps
        assert counts == (layers * TRAIN_STEPS, layers * TRAIN_STEPS), counts
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
    """Phase 9: the comparative twin step with the contrastive term."""
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
    assert counts == (12 * COMPARATIVE_STEPS, 12 * COMPARATIVE_STEPS), counts
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

    def kernel_ms(tag):
        return sum(t for name, (t, _) in per_name.items()
                   if tag in name) / 1e3 / traced

    row = dict(
        work=label, aggregation=agg, wall_ms_median=wall,
        device_busy_ms=busy_ms,
        device_ops_per_call=sum(c for _, c in per_name.values()) / traced,
        idle_share=max(0.0, 1.0 - busy_ms / wall),
        b1_ms=kernel_ms("egnn_mega_fwd_kernel"),
        b2_ms=kernel_ms("egnn_tail_bwd"),
        top=[[name[:90], t / 1e3 / traced, c // traced]
             for name, (t, c) in top])
    print("profile:", json.dumps(row), flush=True)
    return row


def profile_forwards(scorer, requests, traced: int = 3) -> list:
    """Per request shape and aggregation: median wall time of 10 untraced
    forwards, then ``traced`` forwards under torch.profiler."""
    from immunostruct_tpu_torch.serving import request_to_args

    rows = []
    for label, _, path in requests:
        args = request_to_args(path, scorer.device, scorer.model)
        for agg in ("mega", "scatter"):
            scorer.aggregation = agg
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
    scorer.aggregation = "mega"
    return rows


def profile_training(traced: int = 3) -> list:
    """Train steps at B=128, E=2560 under 'mega' and 'scatter': median wall
    of 8 untraced steps (after 3), then ``traced`` steps traced."""
    from immunostruct_tpu_torch.data.synthetic import random_sample_batch

    batch = random_sample_batch(B, N, EDGE_COUNTS[0], L, seed=0,
                                device="cuda")
    rows = []
    for agg in ("mega", "scatter"):
        trainer, state = make_trainer("HybridModelv2", agg)
        _, ms = timed_steps(trainer, state, batch, 11)

        def step():
            trainer.train_step(state, batch, seed=0)

        per_name = device_profile(step, traced)
        rows.append(profile_row("train step B=128 E=2560", agg, per_name,
                                traced, statistics.median(ms[3:])))
        del trainer, state
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from immunostruct_tpu_torch.ops.mega import _kernel_libs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}  (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s))", flush=True)

    t0 = time.perf_counter()
    _kernel_libs()
    build_s = time.perf_counter() - t0
    print(f"kernel build + load (both): {build_s:.1f} s", flush=True)

    fwd_rows = check_fwd_kernel()
    tail_rows = check_tail_kernel()
    check_edge_mega_grads()
    scorer = full_width_scorer()
    with tempfile.TemporaryDirectory() as tmp:
        requests = write_requests(tmp)
        served, serving_counts = check_serving(scorer, requests)
        train_rows, train_counts = check_training()
        comp_row, comp_counts = check_comparative()
        profile_forwards(scorer, requests)
        profile_training()

    def pick(rows):
        return next(r for r in rows if r["E"] == 2560 and r["F"] == 64
                    and r["dtype"] == "bfloat16")

    for r in served:
        print(f"latency [{card}]: {r['request']}: median forward "
              f"{r['median_forward_ms']:.3f} ms, median HTTP round trip "
              f"{r['median_http_wall_ms']:.3f} ms")
    for r in train_rows:
        print(f"train   [{card}]: B=128 E={r['E']} bf16: median step "
              f"{r['median_step_ms_mega']:.3f} ms 'mega' "
              f"({r['pmhc_per_s_mega']:.0f} pMHC/s), "
              f"{r['median_step_ms_scatter']:.3f} ms 'scatter' "
              f"({r['pmhc_per_s_scatter']:.0f} pMHC/s)")
    print(f"twins   [{card}]: B=128 E=2560 bf16: median step "
          f"{comp_row['median_step_ms']:.3f} ms")
    for kind, rows in (("B1", fwd_rows), ("B2", tail_rows)):
        for r in rows:
            print(f"kernel  [{card}]: {kind} E={r['E']} F={r['F']} "
                  f"{r['dtype']}: kernel {r['ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f} ms")

    launches = dict(serving=serving_counts, train=train_counts,
                    comparative=comp_counts)
    b1, b2 = pick(fwd_rows), pick(tail_rows)
    record = {"kernels": [{
        "name": "egnn_mega_fwd",
        "route": "cuda",
        "source": "immunostruct_tpu_torch/csrc/egnn_mega_fwd.cu",
        "replaces": "immunostruct_tpu/ops/pallas_mega.py:226",
        "launches": train_counts[0],
        "launches_by_path": {k: v[0] for k, v in launches.items()},
        "max_abs_err": max(r["max_abs_err"] for r in fwd_rows),
        "ms": b1["ms_with_residuals"],
        "plain_ms": b1["plain_ms"],
    }, {
        "name": "egnn_tail_bwd",
        "route": "cuda",
        "source": "immunostruct_tpu_torch/csrc/egnn_tail_bwd.cu",
        "replaces": "immunostruct_tpu/ops/pallas_mega.py:370",
        "launches": train_counts[1],
        "launches_by_path": {k: v[1] for k, v in launches.items()},
        "max_abs_err": max(r["max_abs_err"] for r in tail_rows),
        "ms": b2["ms"],
        "plain_ms": b2["plain_ms"],
    }]}
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
