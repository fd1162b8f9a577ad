#!/usr/bin/env python3
"""Smoke test of the PyTorch port (immunostruct_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (none catches its own failure; any failure exits non-zero):
  1. require CUDA;
  2. print the card's name and power limit (nvidia-smi);
  3. build the Hopper kernel csrc/egnn_mega_fwd.cu with nvcc (first use);
  4. compare the kernel with its plain PyTorch version on the card at the
     serving shapes (B=128, N=288, H=64, E=2560 and 1408, F=20 and 64,
     10% of the edges masked, self-loops), in f32 (TF32 off) and bf16, and
     time both;
  5. start the port's HTTP server on 127.0.0.1 (ephemeral port) serving
     full-width HybridModelv2 with seeded weights in bf16, POST requests
     (B=128 at E=2560, B=128 at E=1408, B=1), and check that the
     probabilities are finite, lie in (0, 1), match the same batch through
     aggregation='scatter', come back the same when the request is sent
     again, and that each request launched the kernel exactly 6 times (once
     per EGNN layer);
  6. trace 3 forwards of each request shape through 'mega' and 'scatter'
     with torch.profiler and print, per shape and path,
     the median untraced wall time, the device-busy time, the device's idle
     share and the kernels that take the most device time;
  7. print the request latencies and kernel times beside the card's name
     and power limit, then the kernel record as one JSON line and, last,
     the result line {"ok": true, "device": {...}}.
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
# bf16: the kernel and the plain version round at the same points, so they
# differ only where a different f32 summation order flips one rounding. Per
# output column (H message sums, 3 coordinate sums), over all graphs and
# nodes: max|diff| <= BF16_COL_MAX * max|plain| (one bf16 step at the
# column's largest value) and mean|diff| <= BF16_COL_MEAN * mean|plain|. A
# kernel that leaves out any one rounding point fails the mean bound.
BF16_COL_MAX = 4e-3
BF16_COL_MEAN = 1e-4
PROB_ATOL = 5e-4          # served probabilities vs the 'scatter' path, bf16
TIMED_REQUESTS = 5


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


def bf16_errors(out: torch.Tensor, ref: torch.Tensor) -> dict:
    """The worst column's max and mean of |out - ref|, each relative to the
    same statistic of |ref| in that column, over all graphs and nodes."""
    diff = (out - ref).abs().flatten(0, 1)
    mag = ref.abs().flatten(0, 1)
    tiny = torch.finfo(torch.float32).tiny
    return dict(
        col_max_rel=(diff.amax(0) / mag.amax(0).clamp_min(tiny)).max().item(),
        col_mean_rel=(diff.mean(0) / mag.mean(0).clamp_min(tiny)).max().item())


def kernel_inputs(e: int, f: int, dtype, seed: int):
    from immunostruct_tpu_torch.ops.egnn import EGNNLayer
    from immunostruct_tpu_torch.ops.mega import pack_params

    gen = torch.Generator().manual_seed(seed)
    dev = torch.device("cuda")
    src = torch.randint(0, N, (B, e), generator=gen, dtype=torch.int32)
    dst = torch.randint(0, N, (B, e), generator=gen, dtype=torch.int32)
    src[:, :8] = dst[:, :8]                                  # self-loops
    mask = torch.rand(B, e, generator=gen) >= 0.1            # 10% padded
    ef = torch.randn(B, e, 1, generator=gen)
    h = torch.randn(B, N, f, generator=gen)
    x = torch.randn(B, N, 3, generator=gen)
    layer = EGNNLayer(f, H, H, generator=gen, device=dev)
    weights = [w.detach().contiguous()
               for w in pack_params(layer.edge_mlp, layer.coord_mlp)]
    return (src.to(dev), dst.to(dev), mask.to(dev), ef.to(dev, dtype),
            h.to(dev, dtype), x.to(dev, dtype), *weights)


def check_kernel() -> list:
    from immunostruct_tpu_torch.ops.mega import edge_mega, edge_mega_reference

    rows = []
    for e in EDGE_COUNTS:
        for f in (20, 64):
            for name, dtype in (("float32", torch.float32),
                                ("bfloat16", torch.bfloat16)):
                args = kernel_inputs(e, f, dtype, seed=e + f)
                out = edge_mega(*args)
                torch.cuda.synchronize()
                ref = edge_mega_reference(*args)
                assert out.shape == (B, N, H + 3) and out.dtype == torch.float32
                assert torch.isfinite(out).all()
                err = (out - ref).abs().max().item()
                scale = ref.abs().max().item()
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
                # alternate plain, kernel, kernel, plain
                plain_ms = cuda_ms(lambda: edge_mega_reference(*args))
                ms = cuda_ms(lambda: edge_mega(*args))
                ms = (ms + cuda_ms(lambda: edge_mega(*args))) / 2
                plain_ms = (plain_ms
                            + cuda_ms(lambda: edge_mega_reference(*args))) / 2
                row = dict(E=e, F=f, dtype=name, max_abs_err=err,
                           max_abs_ref=scale, **rel, tolerance=tol, ms=ms,
                           plain_ms=plain_ms)
                print("kernel check:", json.dumps(row), flush=True)
                rows.append(row)
                del args, out, ref
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


def check_serving(scorer, requests) -> tuple:
    from immunostruct_tpu_torch.ops.mega import edge_mega
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
        edge_mega.launches = 0          # every count to 0: main path starts
        for (label, b, path), body in zip(requests, bodies):
            before = edge_mega.launches
            status, reply = post(base + "/score", body)
            launches = edge_mega.launches - before
            assert status == 200, reply
            assert launches == layers, (label, launches)
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
            before = edge_mega.launches
            for _ in range(TIMED_REQUESTS):
                t0 = time.perf_counter()
                status, reply = post(base + "/score", body)
                walls.append((time.perf_counter() - t0) * 1e3)
                assert status == 200, reply
                server_ms.append(reply["ms"])
                again = torch.tensor(reply["probs"], dtype=torch.float64)
                repeat_err = max(repeat_err,
                                 (again - probs).abs().max().item())
            assert edge_mega.launches - before == layers * TIMED_REQUESTS
            assert repeat_err <= PROB_ATOL, (label, repeat_err)
            row = dict(request=label, launches_per_request=launches,
                       max_abs_prob_err_vs_scatter=prob_err,
                       max_abs_prob_diff_repeated=repeat_err,
                       median_http_wall_ms=statistics.median(walls),
                       median_forward_ms=statistics.median(server_ms))
            print("served:", json.dumps(row), flush=True)
            rows.append(row)
        total = edge_mega.launches      # read just after the main path
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


def profile_forwards(scorer, requests, traced: int = 3) -> list:
    """Per request shape and aggregation: median wall time of 10 untraced
    forwards, then ``traced`` forwards under torch.profiler for the device's
    busy time, idle share and top kernels."""
    from torch.profiler import ProfilerActivity, profile

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
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(traced):
                    scorer(*args)
                torch.cuda.synchronize()
            per_name = {}
            for ev in prof.events():
                if ev.device_type != torch.autograd.DeviceType.CUDA:
                    continue
                us = ev.time_range.end - ev.time_range.start
                tot, cnt = per_name.get(ev.name, (0.0, 0))
                per_name[ev.name] = (tot + us, cnt + 1)
            assert per_name, "torch.profiler recorded no device activity"
            busy_ms = sum(t for t, _ in per_name.values()) / 1e3 / traced
            wall = statistics.median(walls)
            top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:4]
            b1 = sum(t for name, (t, _) in per_name.items()
                     if "egnn_mega_fwd_kernel" in name) / 1e3 / traced
            row = dict(
                request=label, aggregation=agg, wall_ms_median=wall,
                device_busy_ms=busy_ms,
                device_ops_per_forward=sum(c for _, c in per_name.values())
                / traced,
                idle_share=max(0.0, 1.0 - busy_ms / wall), b1_ms=b1,
                top=[[name[:90], t / 1e3 / traced, c // traced]
                     for name, (t, c) in top])
            print("profile:", json.dumps(row), flush=True)
            rows.append(row)
    scorer.aggregation = "mega"
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from immunostruct_tpu_torch.ops.mega import _kernel_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}  (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s))", flush=True)

    t0 = time.perf_counter()
    _kernel_lib()
    build_s = time.perf_counter() - t0
    print(f"kernel build + load: {build_s:.1f} s", flush=True)

    kernel_rows = check_kernel()
    scorer = full_width_scorer()
    with tempfile.TemporaryDirectory() as tmp:
        requests = write_requests(tmp)
        served, launches = check_serving(scorer, requests)
        profile_forwards(scorer, requests)

    main_row = next(r for r in kernel_rows if r["E"] == 2560 and r["F"] == 64
                    and r["dtype"] == "bfloat16")
    for r in served:
        print(f"latency [{card}]: {r['request']}: median forward "
              f"{r['median_forward_ms']:.3f} ms, median HTTP round trip "
              f"{r['median_http_wall_ms']:.3f} ms")
    for r in kernel_rows:
        print(f"kernel  [{card}]: E={r['E']} F={r['F']} {r['dtype']}: "
              f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms")

    record = {"kernels": [{
        "name": "egnn_mega_fwd",
        "route": "cuda",
        "source": "immunostruct_tpu_torch/csrc/egnn_mega_fwd.cu",
        "replaces": "immunostruct_tpu/ops/pallas_mega.py:226",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in kernel_rows),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
    }]}
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
