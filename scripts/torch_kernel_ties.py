"""How close the PyTorch port's bf16 tensor-core kernels come to their card
tests' bounds (tests/test_torch_port_cuda.py), read on the card as ratios
of the bounds (1.0 is at the bound), on the tests' own inputs and on
seeded ones. One section per kernel (--kernel, default all of them):

  tail      B2, B5a, B5b (csrc/egnn_tail.cuh): for each kTieUlps (the
            reach of the near-tie recompute, csrc/egnn_hopper.cuh) in
            TIE_ULPS, a build of a copy of csrc/ with that constant: the
            tail tests' bf16 statistics on their inputs, the entries of
            d_cat that differ from the plain version on the B=8, E=100,
            F=64 input, and B2's, B5a's and B5b's times at B=128, E=2560,
            F=64 (CUDA events, the builds interleaved three times over).
            Also the plain version against itself with every H x H product
            summed exactly (float64, rounded once to f32): how far its own
            summation order moves the same bounds.
  edge_bwd  B3's bf16 backward (csrc/egnn_edge_bwd.cu) on the card tests'
            shapes, at the tests' seeds and at 1..8, and at chip_smoke.py's
            B=128 with its weight-gradient bound: whether each input passes
            the checks (``_assert_edge_bwd_close``), each output's worst row
            mean ratio and dbc1's nearness ratio, for kTieUlps 32 (the
            source's), -1 (the recompute off), and for the kernel that sums
            dbc1 from d_p3 unrounded (the d_p3 mutant).
  mega_fwd  B1's bf16 form (csrc/egnn_mega_fwd.cu; no near-tie recompute)
            on the card tests' shapes (B=8 at E=2560, 1408, 100 and F=20,
            64; B=1 and 200 at E=2560 and 1000, F=64, the last graph all
            masked), at the tests' seeds and at 1..8: whether the output
            (with the residuals and without) and the residuals pass the
            bounds, the worst column's mean and max ratio, and the a1
            entries more than one bf16 step off, with their edge's nodes.
  paired_fwd
            B4's bf16 form (csrc/egnn_mega_paired_fwd.cu on B1's tensor-core
            kernel, csrc/egnn_mega.cuh; no near-tie recompute) on the card
            tests' shapes (B=128 at E=2560, 1408 and F=20, 64; B=1 and 200
            at E=2560 and 1000, F=64, the last graph all masked; B=8 with
            the second half scrambled), at the tests' seeds and at 1..8:
            whether the output (with the residuals and without) and the
            residuals pass B1's bounds, the worst column's mean and max
            ratio, the a1 entries more than one bf16 step off, and whether
            the residuals are B1's bit for bit.
  edge_fwd  B3's bf16 forward (csrc/egnn_edge_fwd.cu) on the card tests'
            shapes at their seeds and 1..8, at B=1 and 200, and at
            chip_smoke.py's B=128: whether each input passes
            ``_assert_edge_close``, the worst row's mean and max ratio and
            the output entries that differ from the plain version, for
            kTieUlps 32 (the source's) and -1 (the recompute off).
  stack_fwd B6's bf16 form (csrc/egnn_stack_fwd.cu; B1's tensor-core body
            layer by layer and the node MLP on mma.sync; no near-tie
            recompute) on the card tests' shapes and seeds and at 1..8:
            whether each input passes ``_assert_stack_layers_close``, and
            its worst ratios to the bounds over the layers (the aggregate's
            column max in bf16 steps, its column mean, h's and x's column
            means over 1e-4).
  layer_fwd B7's bf16 form (csrc/egnn_layer_fwd.cu; a graph over a cluster
            of CTAs, every product on mma.sync; no near-tie recompute) on
            the card tests' shapes and seeds and at 1..8: whether each input
            passes ``_assert_b7_close``, its worst column's max (in bf16
            steps) and mean (over 1e-4) ratios for h' and x', and the
            cluster size.
  repeat    each kernel launched 10 times on one input (B=1, 8 and 128 at
            E=2560, bf16 and f32): the entries that differ from the first
            launch's outputs, summed over the other nine. B1, B4, B6, B7, B8
            (the scatter), and the glue that B8's scatter now sums (the
            'hybrid' backward's node sums, a 'fused' and a 'pallas' layer's
            forward and backward).
  sass      per kernel library's SASS (cuobjdump): the atomic instructions
            by opcode, and the tensor-core ones (HMMA) of each tensor-core
            kernel.
  segment_times
            B8 (csrc/segment.cu behind ops/segment.py) at every shape
            chip_smoke.py times it: B=128, N=288, C=67, E=2560 and 1408,
            f32 and bf16 (chip_smoke.segment_inputs), and the operands the
            train_Cancer_wFT entry point gives it (the first call of each
            kernel, shape and dtype: B=25-128 at E=1280, bf16). Per shape
            chip_smoke.py's check_scatter_case and check_gather_case: the
            kernel against its plain version, and per call the CUDA-events
            reading (20 back-to-back calls), the device time (the calls
            queued behind a spin kernel, then timed back to back by CUDA
            events: no host time), the host time (time.perf_counter over
            1,000 calls without synchronisation) and the same three of the
            library call (index_add_, index_select), with the bound.
  segment_phases
            where B8's scatter kernel spends its time: builds of a copy of
            csrc/ whose kernel stamps the device clock (%globaltimer, ns)
            at its start, at each of its five __syncthreads and at its end,
            from thread 0 of every CTA; one build as it is, one whose sums
            add 1 in place of each message value (every load of m left
            out). Per shape the CTAs' start and end times (percentiles, µs
            from the first start), each phase's mean and largest duration
            over the CTAs (0 idx and mask, 1 the warps' ranking, 2 the
            counts and offsets, 3 their prefix sum, 4 the edge lists, 5 the
            sums), and the load the grid sees: the valid edges of each
            CTA's node range (mean and largest) and the largest in-degree.
            Uniform random indices over N=288, 10% masked (the entry's
            shapes pad the last 180 edges to node 0, masked), and the entry
            point's scatter operands, whose in-degrees are not uniform.

--baseline OTHER_CSRC_DIR adds an earlier form of the kernels (say, the
parent commit's, from ``git archive``). In the tail section, a build of
that csrc/ directory: B2's, B5a's and B5b's outputs against this build's,
bit for bit, and their times beside the others. In paired_fwd and
edge_fwd, the checkout that holds it (its ops/mega.py and ops/edge.py with
their sources): B4 (with the residuals and without, B=128 and B=1) and B3's
forward timed (CUDA events) in the order baseline, this tree, this tree,
baseline, at B=128, E=2560 and 1408, F=64 and 20, bf16; and the f32 forms'
outputs against the baseline's (B3's forward bit for bit; B4's residuals
bit for bit, its atomic sums within f32 roundoff), B3's backward's outputs
bit for bit in both dtypes. In mega_fwd, B1 timed likewise (B=128 and
B=1) and its outputs against the baseline's: its residuals bit for bit in
both dtypes, its sums (f32 atomics in the baseline) within roundoff. In
stack_fwd and layer_fwd, B6 (with the residuals and without, B=128 and
B=1) and B7 (B=128, 8 and 1, F=64 and 20) timed likewise, by CUDA events
and by device time (chip_smoke.device_ms: the calls queued behind a spin
kernel, so no host time; it includes the wrapper's own small kernels, the
weights' packing). In repeat, the
baseline's kernels read the same way beside this tree's. In segment_times, the
checkout that holds it (OTHER_CSRC_DIR/..: its ops/segment.py, with its
segment.cu), timed in the order baseline, this tree, this tree, baseline;
every row keeps its tree and round. Every build goes to a temporary
directory under the build directory, removed at the end.

    python scripts/torch_kernel_ties.py [--kernel tail edge_bwd ...]
        [--baseline OTHER_CSRC_DIR]
"""
import argparse
import contextlib
import ctypes
import functools
import importlib.util
import json
import re
import shutil
import subprocess
import sys
import tempfile
from collections import Counter
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from immunostruct_tpu_torch.ops import (  # noqa: E402
    _build, edge, fused_layer, mega, segment, stack,
)
from immunostruct_tpu_torch.ops import egnn  # noqa: E402
from immunostruct_tpu_torch.ops.egnn import EGNNLayer  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "card_tests", ROOT / "tests" / "test_torch_port_cuda.py")
tc = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tc)

TIE_ULPS = (32, -1, 64)  # the first is the source's own
SEEDS = range(1, 9)
KERNELS = ("tail", "edge_bwd", "mega_fwd", "paired_fwd", "edge_fwd",
           "stack_fwd", "layer_fwd", "repeat", "sass", "segment_times",
           "segment_phases")
# each library's tensor-core kernel, whose registers and spills are shown
MMA_KERNEL = {"egnn_tail_bwd": "tail_bwd_mma_kernel",
              "egnn_tail_bwd_db": "tail_bwd_mma_kernel",
              "egnn_tail_bwd_nodes": "tail_bwd_mma_kernel",
              "egnn_edge_bwd": "egnn_edge_bwd_mma_kernel",
              "egnn_edge_fwd": "egnn_edge_fwd_mma_kernel",
              "egnn_mega_fwd": "egnn_mega_fwd_mma_kernel",
              "egnn_mega_paired_fwd": "egnn_mega_fwd_mma_kernel",
              "egnn_stack_fwd": "egnn_stack_fwd_mma_kernel",
              "egnn_layer_fwd": "egnn_layer_fwd_mma_kernel"}
REPO_CSRC, REPO_BUILD = _build.CSRC, _build.BUILD_DIR
TAIL_FNS = {"b2": (mega.tail_bwd, mega.tail_bwd_reference),
            "db": (mega.tail_bwd_db, mega.tail_bwd_db_reference),
            "nodes": (mega.tail_bwd_nodes, mega.tail_bwd_nodes_reference)}


# ---------------------------------------------------------------- builds

def with_ulps(ulps):
    """egnn_hopper.cuh with kTieUlps = ulps."""
    text = (REPO_CSRC / "egnn_hopper.cuh").read_text()
    text, n = re.subn(r"(constexpr int kTieUlps = )-?\d+;",
                      rf"\g<1>{ulps};", text)
    assert n == 1
    return {"egnn_hopper.cuh": text}


def use(d):
    """Load the kernels from the build of ``d`` (None: the repo's)."""
    _build.CSRC = d / "csrc" if d else REPO_CSRC
    _build.BUILD_DIR = d / "build" if d else REPO_BUILD
    tc._clear_libraries()


def build_variants(variants, sources, root):
    """{name: dir}, each dir a copy of csrc/ (with the files of
    variants[name], {file: text}, in it; or, for a Path, that directory)
    and each of ``sources`` built there, one nvcc each, all at once. Prints
    the registers and spill stores of each library's tensor-core kernel,
    where it has one."""
    dirs, procs = {}, []
    nvcc = _build._nvcc()
    for name, texts in variants.items():
        d = root / name
        base = texts if isinstance(texts, Path) else REPO_CSRC
        shutil.copytree(base, d / "csrc")
        if not isinstance(texts, Path):
            for fname, text in texts.items():
                (d / "csrc" / fname).write_text(text)
        (d / "build").mkdir()
        dirs[name] = d
        use(d)
        for src in sources:
            procs.append((name, src, subprocess.Popen(
                [nvcc, *_build.NVCC_FLAGS, "-o", str(_build._lib_path(src)),
                 str(d / "csrc" / f"{src}.cu")], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    use(None)
    for name, src, p in procs:
        out, _ = p.communicate()
        assert p.returncode == 0, out[-3000:]
        if src not in MMA_KERNEL:
            continue
        mma = out.split(MMA_KERNEL[src])[-1]
        spill = re.search(r"(\d+) bytes spill stores", mma)
        regs = re.search(r"Used (\d+) registers", mma)
        print(f"build {name} {src}: {regs.group(1)} registers, "
              f"{spill.group(1)} B spill stores", flush=True)
    return dirs


def passes(check, *args):
    try:
        check(*args)
        return True
    except AssertionError:
        return False


# ---------------------------------------------------------------- tail

def tail_ratios(out, ref, node=False):
    """{output: worst mean ratio over its rows}, and the worst max ratio,
    as the tail tests' bf16 checks read them."""
    names = ["cat", "ef", "dw2", "dwc1", "dsmall"]
    if node:
        rows = [(out[0].flatten(0, 1).T, ref[0].flatten(0, 1).T, 1.6e-2)]
        out, ref = out[1:], ref[1:]
        names = ["nodes"] + names[1:]
    else:
        rows = [(out[0].float().transpose(0, 1).flatten(1),
                 ref[0].float().transpose(0, 1).flatten(1), 1.6e-2)]
    rows.append((out[1].float().flatten()[None],
                 ref[1].float().flatten()[None], 1.6e-2))
    start = 1 if node else 2
    rows += [(g.flatten()[None], r.flatten()[None], 1e-3)
             for g, r in zip(out[start:], ref[start:])]
    mean, worst_max = {}, 0.0
    for name, (g, r, tol) in zip(names, rows):
        diff, mag = (g - r).abs(), r.abs()
        mean[name] = round((diff.mean(1) / (2e-5 * mag.mean(1)).clamp_min(
            1e-30)).max().item(), 4)
        worst_max = max(worst_max, (diff.amax(1) / (tol * mag.amax(1))
                                    .clamp_min(1e-30)).max().item())
    return mean, round(worst_max, 4)


def tail_cases():
    bf, dev = torch.bfloat16, torch.device("cuda")
    out = []
    for e in (2560, 1408, 100):
        for f in (20, 64):
            out.append((f"B2 B=8 E={e} F={f}", "b2",
                        tc._tail_args(8, e, f, bf, dev, seed=e + f + 1)))
    for e in (2560, 1408):
        for f in (20, 64):
            a = tc._tail_g_args(128, e, f, bf, dev, seed=e + f + 3)
            out.append((f"B5a B=128 E={e} F={f}", "db", (a[1], *a[2:])))
            a = tc._tail_g_args(128, e, f, bf, dev, seed=e + f + 4)
            out.append((f"B5b B=128 E={e} F={f}", "nodes", a))
    for b in (1, 200):
        for e in (2560, 1000):
            a = list(tc._tail_g_args(b, e, 20, bf, dev, seed=b + e))
            if b > 1:
                a[2] = a[2].clone()
                a[2][-1] = False
            out.append((f"grid B2 B={b} E={e}", "b2", tc._b2_of(*a)))
            out.append((f"grid B5b B={b} E={e}", "nodes", tuple(a)))
    return out


def differing(out, ref):
    """(graph, edge, d_cat row, kernel, plain) where d_cat differs."""
    idx = (out[0] != ref[0]).nonzero().tolist()
    return [(b, e, k, out[0][b, k, e].item(), ref[0][b, k, e].item())
            for b, k, e in idx]


def exact_products_reference(*args):
    """tail_bwd_reference with every torch.matmul summed in float64 and
    rounded once to f32."""
    plain = torch.matmul
    torch.matmul = lambda a, b: plain(a.double(), b.double()).float()
    try:
        return mega.tail_bwd_reference(*args)
    finally:
        torch.matmul = plain


def tail(root, baseline):
    variants = {f"kTieUlps={u}": with_ulps(u) for u in TIE_ULPS}
    if baseline is not None:
        variants["baseline"] = baseline
    dirs = build_variants(variants, ("egnn_tail_bwd", "egnn_tail_bwd_db",
                                     "egnn_tail_bwd_nodes"), root)
    inputs = tail_cases()
    refs = {label: TAIL_FNS[kind][1](*args) for label, kind, args in inputs}
    small = next(a for label, _, a in inputs if label == "B2 B=8 E=100 F=64")
    witness = exact_products_reference(*small)
    print("tail:", json.dumps({
        "plain_exact_products_vs_plain B2 B=8 E=100 F=64":
            tail_ratios(witness, refs["B2 B=8 E=100 F=64"]),
        "differing": len(differing(witness, refs["B2 B=8 E=100 F=64"]))}),
        flush=True)
    for u, d in dirs.items():
        use(d)
        res = {}
        for label, kind, args in inputs:
            got = TAIL_FNS[kind][0](*args)
            torch.cuda.synchronize()
            res[label] = tail_ratios(got, refs[label], node=kind == "nodes")
            if label == "B2 B=8 E=100 F=64":
                diffs = differing(got, refs[label])
        print("tail:", json.dumps({
            "variant": u,
            "worst_mean_ratio": max(max(v[0].values()) for v in res.values()),
            "worst_max_ratio": max(v[1] for v in res.values()),
            "differing_d_cat_B=8_E=100_F=64": diffs[:12],
            "n_differing": len(diffs)}), flush=True)
        for label, v in res.items():
            print("tail:   ", u, label, max(v[0].values()), v[1], v[0],
                  flush=True)
    # the times, the builds interleaved three times over; the outputs of
    # each build against the first's
    use(None)
    g = cs.tail_g_inputs(2560, 64, torch.bfloat16, seed=7)
    ops = {"B2": (mega.tail_bwd, cs.b2_operands(*g)),
           "B5a": (mega.tail_bwd_db, (g[1], *g[2:])),
           "B5b": (mega.tail_bwd_nodes, g)}
    times = {u: {k: [] for k in ops} for u in dirs}
    same = {u: {} for u in dirs}
    first = {}
    for _ in range(3):
        for u, d in dirs.items():
            use(d)
            for k, (fn, a) in ops.items():
                out = fn(*a)
                first.setdefault(k, out)
                same[u][k] = all(torch.equal(x, y)
                                 for x, y in zip(out, first[k]))
                times[u][k].append(cs.cuda_ms(lambda: fn(*a)))
    print("tail:", json.dumps({"bf16 B=128 E=2560 F=64 ms": times,
                               f"same bits as {next(iter(dirs))}": same}),
          flush=True)
    use(None)


# ---------------------------------------------------------------- B3 bwd

EDGE_SHAPES = ((8, 100, 0), (8, 256, 56), (8, 2560, 0), (26, 1280, 0),
               (51, 1280, 0))


def edge_cases():
    """(B, E, tail, F, seed, weight-gradient mean bound): the card tests'
    shapes and seeds (``test_edge_kernels_match_plain_versions``), 1..8,
    and chip_smoke.py's B=128 with its bound (the seed of
    ``test_edge_bwd_smoke_bound_sees_every_rounding_point`` and 1..3)."""
    for b, e, tail_ in EDGE_SHAPES:
        for f in (20, 64):
            for seed in [e + f, *SEEDS]:
                yield b, e, tail_, f, seed, 2e-5
    for f in (20, 64):
        for seed in (2582, 1, 2, 3):
            yield 128, 2560, 0, f, seed, cs.EDGE_GRAD_MEAN


def d_p3_unrounded():
    """egnn_hopper.cuh with dbc1 summed from d_p3 before its rounding (the
    card tests' d_p3 mutant)."""
    text = (REPO_CSRC / "egnn_hopper.cuh").read_text()
    for pattern, repl in tc._EDGE_BWD_MUTANTS["d_p3"]:
        text, n = re.subn(pattern, repl, text)
        assert n == 1
    return {"egnn_hopper.cuh": text}


def dbc1_rounding(args, dout, got, ref):
    """mean|dbc1 - plain| / mean|dbc1 - the sum of d_p3 unrounded|
    (``_assert_edge_bwd_close`` holds it at most 1)."""
    k, r = got[6][:, edge.BC1], ref[6][:, edge.BC1]
    far = (k - edge.d_p3_unrounded_sum(*args, dout)).abs().mean().item()
    return (k - r).abs().mean().item() / max(far, 1e-30)


def edge_bwd(root):
    variants = {f"kTieUlps={u}": with_ulps(u) for u in TIE_ULPS[:2]}
    variants["d_p3_unrounded"] = d_p3_unrounded()
    dirs = build_variants(variants, ("egnn_edge_bwd",), root)
    dev = torch.device("cuda")
    fails = {u: 0 for u in dirs}
    dbc1 = {u: [] for u in dirs}
    n = 0
    for b, e, tail_, f, seed, grad_mean in edge_cases():
        args, dout = tc._edge_args(b, e, f, torch.bfloat16, dev, seed=seed,
                                   tail=tail_)
        ref = edge.edge_program_bwd_reference(*args, dout)
        row = dict(B=b, E=e, tail=tail_, F=f, seed=seed, grad_mean=grad_mean)
        for u, d in dirs.items():
            use(d)
            got = edge.edge_program_bwd(*args, dout)
            ok = passes(tc._assert_edge_bwd_close, args, dout, got, ref,
                        torch.bfloat16, grad_mean)
            fails[u] += not ok
            dbc1[u].append(dbc1_rounding(args, dout, got, ref))
            row[u] = dict(ok=ok, dbc1_rounding=round(dbc1[u][-1], 5),
                          mean_ratio={
                k: round(v / (grad_mean if k.startswith(("dw", "dsmall"))
                              else 2e-5), 4)
                for k, v in tc._mean_ratios(got, ref).items()})
        n += 1
        print("edge_bwd:", json.dumps(row), flush=True)
    print("edge_bwd summary:", json.dumps(dict(
        failing=fails, of=n,
        dbc1_rounding={u: [min(v), max(v)] for u, v in dbc1.items()})),
        flush=True)
    use(None)


# ---------------------------------------------------------------- B1

def col_ratios(out, ref):
    """The worst column's mean and max |diff| over BF16_COL_MEAN/MAX of
    the same statistic of |plain| (``_assert_close``)."""
    diff = (out - ref).abs().flatten(0, 1)
    mag = ref.abs().flatten(0, 1)
    tiny = torch.finfo(torch.float32).tiny
    return (round((diff.mean(0) / (cs.BF16_COL_MEAN * mag.mean(0))
                   .clamp_min(tiny)).max().item(), 4),
            round((diff.amax(0) / (cs.BF16_COL_MAX * mag.amax(0))
                   .clamp_min(tiny)).max().item(), 4))


def mega_cases():
    """(B, E, F, seed, the tests' seed?, the last graph all masked?):
    ``test_kernel_matches_plain_version``'s and
    ``test_kernel_at_the_grid_edges``' shapes."""
    for e in (2560, 1408, 100):
        for f in (20, 64):
            for seed in [e + f, *SEEDS]:
                yield 8, e, f, seed, seed == e + f, False
    for b in (1, 200):
        for e in (2560, 1000):
            for seed in [b + e, *SEEDS]:
                yield b, e, 64, seed, seed == b + e, b > 1


def residual_misses(got, ref):
    """(edge, a1 column, src, dst) where a residual is more than one bf16
    step from the plain version's (``_assert_residuals_close``'s rule)."""
    g, r = got.float(), ref.float()
    mag = torch.maximum(torch.maximum(g.abs(), r.abs()),
                        torch.tensor(2.0 ** -10, device=g.device))
    step = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return ((g - r).abs() > step).nonzero().tolist()


def mega_fwd():
    use(None)
    dev = torch.device("cuda")
    n, worst, worst_own = 0, [0.0, 0.0], [0.0, 0.0]
    failing = dict(output=0, residuals=0)
    for b, e, f, seed, own, masked in mega_cases():
        args = tc._args(b, e, f, 64, torch.bfloat16, dev, seed=seed)
        if masked:
            args[2] = args[2].clone()
            args[2][-1] = False
        ref, a1_ref, xd_ref = mega.edge_mega_fwd_reference(*args)
        out, a1, xd = mega.edge_mega_fwd(*args)
        bare = mega.edge_mega(*args)
        ok_out = (passes(tc._assert_close, out, ref, torch.bfloat16)
                  and passes(tc._assert_close, bare, ref, torch.bfloat16))
        ok_res = passes(tc._assert_residuals_close, (a1, xd),
                        (a1_ref, xd_ref), torch.bfloat16)
        misses = [(e_, j, int(args[0][g_, e_]), int(args[1][g_, e_]))
                  for g_, j, e_ in residual_misses(a1, a1_ref)[:6]]
        r = col_ratios(out, ref)
        r_bare = col_ratios(bare, ref)
        for i in range(2):
            worst[i] = max(worst[i], r[i], r_bare[i])
            if own:
                worst_own[i] = max(worst_own[i], r[i], r_bare[i])
        failing["output"] += not ok_out
        failing["residuals"] += not ok_res
        n += 1
        print("mega_fwd:", json.dumps(dict(
            B=b, E=e, F=f, seed=seed, tests_seed=own, ok_output=ok_out,
            ok_residuals=ok_res, a1_misses_edge_col_src_dst=misses,
            mean_ratio=r[0], max_ratio=r[1], bare_mean_ratio=r_bare[0],
            bare_max_ratio=r_bare[1])), flush=True)
    print("mega_fwd summary:", json.dumps(dict(
        failing=failing, of=n, worst_mean_ratio=worst[0],
        worst_max_ratio=worst[1], tests_seeds_worst_mean_ratio=worst_own[0],
        tests_seeds_worst_max_ratio=worst_own[1])), flush=True)


# ---------------------------------------------------------------- B4

def paired_cases():
    """(B, E, F, seed, the tests' seed?, the last graph all masked?, the
    second half scrambled?): ``test_paired_kernel_matches_plain_version``'s,
    ``test_paired_kernel_at_the_grid_edges``' and
    ``test_paired_kernel_reads_only_the_arc_half``'s shapes."""
    for e in (2560, 1408):
        for f in (20, 64):
            for seed in [e + f + 2, *SEEDS]:
                yield 128, e, f, seed, seed == e + f + 2, False, False
    for b in (1, 200):
        for e in (2560, 1000):
            for seed in [b + e + 3, *SEEDS]:
                yield b, e, 64, seed, seed == b + e + 3, b > 1, False
    for seed in [41, *SEEDS]:
        yield 8, 2560, 20, seed, seed == 41, False, True


def paired_fwd(root, baseline):
    use(None)
    dev = torch.device("cuda")
    n, worst, worst_own = 0, [0.0, 0.0], [0.0, 0.0]
    failing = dict(output=0, residuals=0, residuals_not_b1=0)
    for b, e, f, seed, own, masked, scrambled in paired_cases():
        args = tc._paired_args(b, e, f, torch.bfloat16, dev, seed=seed)
        if masked:
            args[2] = args[2].clone()
            args[2][-1] = False
        if scrambled:
            args = tc._scrambled_mirror_half(args, seed=seed + 1)
        ref, a1_ref, xd_ref = mega.edge_mega_paired_fwd_reference(*args)
        out, a1, xd = mega.edge_mega_paired_fwd(*args)
        bare = mega.edge_mega_paired_fwd(*args, residuals=False)[0]
        _, a1_b1, xd_b1 = mega.edge_mega_fwd(*mega.mirror_edges(*args[:3]),
                                             *args[3:])
        same_b1 = torch.equal(a1, a1_b1) and torch.equal(xd, xd_b1)
        ok_out = (passes(tc._assert_close, out, ref, torch.bfloat16)
                  and passes(tc._assert_close, bare, ref, torch.bfloat16))
        ok_res = passes(tc._assert_residuals_close, (a1, xd),
                        (a1_ref, xd_ref), torch.bfloat16)
        src, dst = mega.mirror_edges(*args[:3])[:2]
        misses = [(e_, j, int(src[g_, e_]), int(dst[g_, e_]))
                  for g_, j, e_ in residual_misses(a1, a1_ref)[:6]]
        r, r_bare = col_ratios(out, ref), col_ratios(bare, ref)
        for i in range(2):
            worst[i] = max(worst[i], r[i], r_bare[i])
            if own:
                worst_own[i] = max(worst_own[i], r[i], r_bare[i])
        failing["output"] += not ok_out
        failing["residuals"] += not ok_res
        failing["residuals_not_b1"] += not same_b1
        n += 1
        print("paired_fwd:", json.dumps(dict(
            B=b, E=e, F=f, seed=seed, tests_seed=own, scrambled=scrambled,
            ok_output=ok_out, ok_residuals=ok_res, residuals_equal_b1=same_b1,
            a1_misses_edge_col_src_dst=misses, mean_ratio=r[0],
            max_ratio=r[1], bare_mean_ratio=r_bare[0],
            bare_max_ratio=r_bare[1])), flush=True)
    print("paired_fwd summary:", json.dumps(dict(
        failing=failing, of=n, worst_mean_ratio=worst[0],
        worst_max_ratio=worst[1], tests_seeds_worst_mean_ratio=worst_own[0],
        tests_seeds_worst_max_ratio=worst_own[1])), flush=True)
    if baseline is not None:
        fwd_times(root, baseline, "paired_fwd")


# ---------------------------------------------------------------- B3 fwd

def edge_fwd_cases():
    """(B, E, tail, F, seed, the last graph's bundles zero?): the card
    tests' shapes and seeds (``test_edge_kernels_match_plain_versions``,
    ``test_edge_fwd_kernel_at_the_grid_edges``), 1..8, and chip_smoke.py's
    B=128 (``check_edge_kernels``' seeds and 1..3)."""
    for b, e, tail_ in EDGE_SHAPES:
        for f in (20, 64):
            for seed in [e + f, *SEEDS]:
                yield b, e, tail_, f, seed, False
    for b in (1, 200):
        for e in (2560, 1000):
            for seed in [b + e + 5, *SEEDS]:
                yield b, e, 0, 64, seed, b > 1
    for e in cs.EDGE_COUNTS:
        for f in (20, 64):
            for seed in (e + f + 2, 1, 2, 3):
                yield 128, e, 0, f, seed, False


def edge_fwd_ratios(out, ref):
    """The worst row's mean and max |diff| over the bf16 bounds of
    ``_assert_edge_close`` (2e-5 and 1.6e-2 of the same statistic of
    |plain|), and the entries that differ."""
    g, r = tc._rows(out), tc._rows(ref)
    diff, mag = (g - r).abs(), r.abs()
    tiny = torch.finfo(torch.float32).tiny
    return (round((diff.mean(1) / (2e-5 * mag.mean(1)).clamp_min(tiny))
                  .max().item(), 4),
            round((diff.amax(1) / (1.6e-2 * mag.amax(1)).clamp_min(tiny))
                  .max().item(), 4),
            int((out != ref).sum().item()))


def edge_fwd(root, baseline):
    variants = {f"kTieUlps={u}": with_ulps(u) for u in TIE_ULPS[:2]}
    dirs = build_variants(variants, ("egnn_edge_fwd",), root / "ties")
    dev = torch.device("cuda")
    fails = {u: 0 for u in dirs}
    worst = {u: [0.0, 0.0] for u in dirs}
    n = 0
    for b, e, tail_, f, seed, zeroed in edge_fwd_cases():
        args, _ = tc._edge_args(b, e, f, torch.bfloat16, dev, seed=seed,
                                tail=tail_)
        if zeroed:
            for t in args[:2]:
                t[-1] = 0
        ref = edge.edge_program_reference(*args)
        row = dict(B=b, E=e, tail=tail_, F=f, seed=seed)
        for u, d in dirs.items():
            use(d)
            got = edge.edge_program_fwd(*args)
            ok = passes(tc._assert_edge_close, got, ref, torch.bfloat16)
            fails[u] += not ok
            mean, mx, differ = edge_fwd_ratios(got, ref)
            worst[u] = [max(worst[u][0], mean), max(worst[u][1], mx)]
            row[u] = dict(ok=ok, mean_ratio=mean, max_ratio=mx,
                          differing=differ)
        n += 1
        print("edge_fwd:", json.dumps(row), flush=True)
    print("edge_fwd summary:", json.dumps(dict(
        failing=fails, of=n, worst_mean_max_ratio=worst)), flush=True)
    use(None)
    if baseline is not None:
        fwd_times(root, baseline, "edge_fwd")


# ------------------------------------------- B4 and B3 fwd beside a baseline

def baseline_module(csrc_dir: Path, name: str):
    """ops/<name>.py of the checkout that holds ``csrc_dir``, as a module of
    its own (it imports this tree's ops.edge and ops._build)."""
    path = csrc_dir.resolve().parent / "ops" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"baseline_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def fwd_times(root, baseline, section):
    """B1 (mega_fwd), B4 (paired_fwd) or B3's forward (edge_fwd) of this
    tree beside the baseline checkout's: times in the order baseline, this,
    this, baseline; B1's and B4's outputs in both dtypes, the f32 forms'
    outputs (and, for edge_fwd, B3's backward's) against the baseline's."""
    paired = section in ("paired_fwd", "mega_fwd")
    sources = (("egnn_mega_paired_fwd", "egnn_mega_fwd") if paired
               else ("egnn_edge_fwd", "egnn_edge_bwd"))
    d = build_variants({"baseline": baseline}, sources,
                       root / "baseline")["baseline"]
    other = baseline_module(baseline, "mega" if paired else "edge")
    dev = torch.device("cuda")
    if paired:
        b4 = section == "paired_fwd"
        fn = "edge_mega_paired_fwd" if b4 else "edge_mega_fwd"

        def case(b, e, f, dtype):
            if b4:
                return (cs.paired_inputs(e, f, dtype, seed=e + f + 2)
                        if b == cs.B else tc._paired_args(
                            b, e, f, dtype, dev, seed=e + f + 2))
            return tc._args(b, e, f, 64, dtype, dev, seed=e + f + 2)
        shapes = [(cs.B, e, f) for e in cs.EDGE_COUNTS for f in (64, 20)]
        shapes.append((1, 2560, 64))
        calls = {"with residuals": lambda m, a: getattr(m, fn)(*a),
                 "without residuals": lambda m, a: getattr(m, fn)(
                     *a, residuals=False)}
    else:
        def case(b, e, f, dtype):
            return cs.edge_inputs(e, f, dtype, seed=e + f + 2)
        shapes = [(cs.B, e, f) for e in cs.EDGE_COUNTS for f in (64, 20)]
        calls = {"forward": lambda m, a: m.edge_program_fwd(*a[0])}
    trees = [("baseline", d, other), ("this", None, mega if paired else edge)]
    times = {}
    for b, e, f in shapes:
        a = case(b, e, f, torch.bfloat16)
        for name, call in calls.items():
            key = f"B={b} E={e} F={f} bf16 {name}"
            times[key] = {"baseline": [], "this": [], "baseline device": [],
                          "this device": []}
            for label, dd, module in (trees[0], trees[1], trees[1],
                                      trees[0]):
                use(dd)
                times[key][label].append(cs.cuda_ms(lambda: call(module, a)))
                times[key][f"{label} device"].append(
                    cs.device_ms(lambda: call(module, a)))
        print(f"{section} times:", json.dumps({
            k: v for k, v in times.items() if k.startswith(f"B={b} E={e} "
                                                           f"F={f} ")}),
              flush=True)
        del a
    # the f32 forms (and B3's backward in both dtypes) against the baseline
    same = {}
    for dtype in (torch.float32, torch.bfloat16):
        a = case(cs.B, 2560, 20, dtype)
        got = {}
        for label, dd, module in trees:
            use(dd)
            if paired:
                got[label] = getattr(module, fn)(*a)
            elif not paired:
                got[label] = ((module.edge_program_fwd(*a[0]),)
                              if dtype == torch.float32 else ()) + tuple(
                    module.edge_program_bwd(*a[0], a[1]))
        if not got:
            continue
        key = str(dtype).split(".")[1]
        if paired:
            (o, a1, xd), (ob, a1b, xdb) = got["this"], got["baseline"]
            same[key] = dict(residuals_equal=torch.equal(a1, a1b)
                             and torch.equal(xd, xdb),
                             out_max_abs_diff=(o - ob).abs().max().item(),
                             out_max_abs=ob.abs().max().item())
        else:
            names = ((("fwd",) if dtype == torch.float32 else ())
                     + ("dhsx", "dhdx", "def", "dw1ab", "dw2", "dwc1",
                        "dsmall"))
            same[key] = {nm: torch.equal(x, y) for nm, x, y in
                         zip(names, got["this"], got["baseline"])}
    use(None)
    print(f"{section} against the baseline:", json.dumps(same), flush=True)


# ---------------------------------------------------------------- B6

def stack_cases():
    """(B, E, seed, the tests' seed?, the last graph all masked?): the card
    tests' B6 shapes (``test_stack_kernel_matches_plain_version``, its grid
    edges, its mutants' and its repeat inputs) and B=128 at 1..8."""
    for e in (2560, 1408):
        for seed in [e + 6, *SEEDS]:
            yield 128, e, seed, seed == e + 6, False
        yield 8, e, e + 8, True, False
    for b in (1, 200):
        for e in (2560, 1000):
            yield b, e, b + e + 46, True, True
    for b in (1, 8, 128):
        yield b, 2560, b + 41, True, False


def col_steps_mean(got, want):
    """(the worst column's max |diff| in bf16 steps at its largest |plain|,
    its mean |diff| over 1e-4 * mean|plain|), over graphs and nodes."""
    g, w = got.float().flatten(0, 1), want.float().flatten(0, 1)
    diff, mag = (g - w).abs(), w.abs()
    tiny = torch.finfo(torch.float32).tiny
    top = mag.amax(0).clamp_min(tiny)
    steps = diff.amax(0) / torch.exp2(torch.floor(torch.log2(top)) - 7)
    mean = diff.mean(0) / (1e-4 * mag.mean(0)).clamp_min(tiny)
    return round(steps.max().item(), 4), round(mean.max().item(), 4)


def stack_ratios(out, args, packed):
    """B6's worst ratios to its bf16 bounds over the layers, each layer
    against the plain version run from the kernel's own previous h, x."""
    h, x, hs, xs, aggs, a1s, xds = out
    src, dst, mask, ef, h0, x0 = args
    worst = dict(agg_max_steps=0.0, agg_mean=0.0, h_mean=0.0, x_mean=0.0)
    for layer, weights in enumerate(packed):
        h_in = h0 if layer == 0 else hs[:, layer - 1]
        x_in = x0 if layer == 0 else xs[:, layer - 1]
        ref = stack.stack_fwd_reference(src, dst, mask, ef, h_in, x_in,
                                        [weights])
        steps, mean = col_steps_mean(aggs[:, layer], ref[4][:, 0])
        worst["agg_max_steps"] = max(worst["agg_max_steps"], steps)
        worst["agg_mean"] = max(worst["agg_mean"], mean)
        for key, t, r in (("h_mean", hs, ref[2]), ("x_mean", xs, ref[3])):
            worst[key] = max(worst[key], col_steps_mean(t[:, layer],
                                                        r[:, 0])[1])
    return worst


def stack_fwd(root, baseline):
    use(None)
    dev = torch.device("cuda")
    n, failing, worst = 0, 0, {}
    for b, e, seed, own, masked in stack_cases():
        args, packed = tc._stack_args(b, e, torch.bfloat16, dev, seed=seed)
        if masked:
            args[2][-1] = False
        out = stack.stack_fwd(*args, packed)
        ok = passes(tc._assert_stack_layers_close, out, args, packed,
                    torch.bfloat16)
        r = stack_ratios(out, args, packed)
        worst = {k: max(worst.get(k, 0.0), v) for k, v in r.items()}
        failing += not ok
        n += 1
        print("stack_fwd:", json.dumps(dict(B=b, E=e, seed=seed,
                                            tests_seed=own, ok=ok, **r)),
              flush=True)
    print("stack_fwd summary:", json.dumps(dict(failing=failing, of=n,
                                                worst=worst)), flush=True)
    if baseline is None:
        return
    d = build_variants({"baseline": baseline}, ("egnn_stack_fwd",),
                       root / "baseline")["baseline"]
    other = baseline_module(baseline, "stack")
    trees = [("baseline", d, other), ("this", None, stack)]
    times = {}
    for b in (cs.B, 1):
        for e in cs.EDGE_COUNTS if b == cs.B else (2560,):
            args, packed = cs.stack_inputs(e, torch.bfloat16, seed=e + 6,
                                           b=b)
            for label_r, res in (("with residuals", True),
                                 ("without residuals", False)):
                key = f"B={b} E={e} bf16 {label_r}"
                times[key] = {"baseline": [], "this": [],
                              "baseline device": [], "this device": []}
                for label, dd, module in (trees[0], trees[1], trees[1],
                                          trees[0]):
                    use(dd)

                    def call():
                        module.stack_fwd(*args, packed, residuals=res)
                    times[key][label].append(cs.cuda_ms(call))
                    times[key][f"{label} device"].append(cs.device_ms(call))
            print("stack_fwd times:", json.dumps({
                k: v for k, v in times.items()
                if k.startswith(f"B={b} E={e} ")}), flush=True)
            del args, packed
    use(None)


# ---------------------------------------------------------------- B7

def layer_cases():
    """(B, E, F, seed, x dtype, the tests' seed?, the last graph all
    masked?, coordinate scale): the card tests' B7 shapes
    (``test_fused_layer_kernel_matches_plain_version``, its grid edges, its
    repeat and mutant inputs) and B=128 at 1..8."""
    for e in (2560, 1408, 256):
        for f in (20, 64):
            for seed in [e + f + 7, *SEEDS]:
                yield 128, e, f, seed, None, seed == e + f + 7, False, 1.0
    for b in (1, 200):
        for e in (2560, 1024):
            for x_dtype in (None, torch.float32):
                yield b, e, 64, b + e + 47, x_dtype, True, True, 1.0
    for b in (1, 8, 128):
        yield b, 2560, 64, b + 42, None, True, False, 1.0
    for e, f in ((2560, 20), (1408, 64)):
        for x_dtype, scale in ((None, 1.0), (torch.float32, 1.0),
                               (None, 1 / 16)):
            yield 32, e, f, e + f, x_dtype, True, False, scale


def layer_fwd(root, baseline):
    use(None)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n, failing, worst = 0, 0, [0.0, 0.0]
    for b, e, f, seed, x_dtype, own, masked, scale in layer_cases():
        layer, args = tc._b7_args(b, e, f, torch.bfloat16, dev, seed=seed,
                                  x_dtype=x_dtype, x_scale=scale)
        if masked:
            args[4][-1] = False
        with torch.no_grad():
            out = fused_layer.fused_egnn_layer(layer, *args)
            ref = fused_layer.fused_egnn_layer_reference(layer, *args)
        ok = passes(tc._assert_b7_close, out, ref, torch.bfloat16)
        r = {name: col_steps_mean(g, w)
             for name, g, w in zip(("h", "x"), out, ref)}
        for name in r:
            worst = [max(worst[0], r[name][0]), max(worst[1], r[name][1])]
        failing += not ok
        n += 1
        print("layer_fwd:", json.dumps(dict(
            B=b, E=e, F=f, seed=seed, tests_seed=own,
            x=str(x_dtype or "bf16"), x_scale=scale, ok=ok,
            cluster=fused_layer.layer_cluster_size(e, b, sms),
            h_max_steps_mean=r["h"], x_max_steps_mean=r["x"])), flush=True)
    print("layer_fwd summary:", json.dumps(dict(
        failing=failing, of=n, worst_max_steps=worst[0],
        worst_mean_ratio=worst[1])), flush=True)
    if baseline is None:
        return
    d = build_variants({"baseline": baseline}, ("egnn_layer_fwd",),
                       root / "baseline")["baseline"]
    other = baseline_module(baseline, "fused_layer")
    trees = [("baseline", d, other), ("this", None, fused_layer)]
    times = {}
    for b, e, f in [(cs.B, e, f) for e in cs.EDGE_COUNTS for f in (64, 20)
                    ] + [(8, 2560, 64), (1, 2560, 64)]:
        layer, args = cs.b7_inputs(b, e, f, torch.bfloat16, seed=e + f + 7)
        key = f"B={b} E={e} F={f} bf16"
        times[key] = {"baseline": [], "this": [], "baseline device": [],
                      "this device": []}
        with torch.no_grad():
            for label, dd, module in (trees[0], trees[1], trees[1],
                                      trees[0]):
                use(dd)

                def call():
                    module.fused_egnn_layer(layer, *args)
                times[key][label].append(cs.cuda_ms(call))
                times[key][f"{label} device"].append(cs.device_ms(call))
        print("layer_fwd times:", json.dumps({key: times[key]}), flush=True)
        del layer, args
    use(None)


# ---------------------------------------------------------------- repeat

def differ(runs):
    """Entries of runs[1:] that differ from runs[0]'s, summed."""
    total = 0
    for run in runs[1:]:
        for a, z in zip(runs[0], run):
            if a is not None:
                total += int((a != z).sum().item())
    return total


def repeat_calls(module_mega, module_stack, module_layer, module_egnn, b,
                 dtype):
    """{kernel: a call on one seeded input} at B=b, E=2560."""
    dev = torch.device("cuda")
    a1 = tc._args(b, 2560, 20, 64, dtype, dev, seed=b + 40)
    a4 = tc._paired_args(b, 2560, 20, dtype, dev, seed=b + 40)
    a6, packed = tc._stack_args(b, 2560, dtype, dev, seed=b + 41)
    layer, a7 = tc._b7_args(b, 2560, 64, dtype, dev, seed=b + 42)
    idx, mask, m, _ = tc._segment_args(b, 2560, N_SEG, 67, dtype, dev,
                                       seed=b + 43)
    calls = {
        "B1": lambda: module_mega.edge_mega_fwd(*a1),
        "B4": lambda: module_mega.edge_mega_paired_fwd(*a4),
        "B6": lambda: module_stack.stack_fwd(*a6, packed),
        "B8_scatter": lambda: (segment.segment_scatter(idx, mask, m, N_SEG),),
    }

    def b7():
        with torch.no_grad():
            return module_layer.fused_egnn_layer(layer, *a7)
    calls["B7"] = b7
    if dtype == torch.bfloat16:
        src, dst, msk = a1[:3]
        _, r1, rx = module_mega.edge_mega_fwd(*a1)
        valid = mega.valid_edges(src, dst, msk, N_SEG)
        g = torch.randn(b, N_SEG, 67, generator=torch.Generator()
                        .manual_seed(b)).to(dev)
        calls["hybrid backward"] = lambda: module_mega.edge_half_bwd(
            src, dst, valid, *a1[3:], r1, rx, g, "hybrid")
        gen = torch.Generator().manual_seed(b + 44)
        lay = EGNNLayer(20, 64, 64, generator=gen, device=dev)
        cot = torch.randn(b, N_SEG, 64, generator=gen).to(dev, dtype)
        for agg in ("fused", "pallas"):
            def run(agg=agg):
                lay.zero_grad()
                hin = a1[4].detach().clone().requires_grad_(True)
                h2, x2 = module_egnn.egnn_apply(lay, hin, a1[5], src, dst,
                                                a1[3], msk, agg)
                ((h2 * cot).float().sum() + x2.float().sum()).backward()
                return [h2.detach(), x2.detach(), hin.grad] + [
                    p.grad.clone() for p in lay.parameters()]
            calls[f"'{agg}' layer"] = run
    return calls


N_SEG = 288


def repeat(root, baseline):
    trees = [("this", None, (mega, stack, fused_layer, egnn))]
    if baseline is not None:
        d = build_variants({"baseline": baseline},
                           ("egnn_mega_fwd", "egnn_mega_paired_fwd",
                            "egnn_stack_fwd", "egnn_layer_fwd"),
                           root / "baseline")["baseline"]
        trees.insert(0, ("baseline", d, tuple(
            baseline_module(baseline, m)
            for m in ("mega", "stack", "fused_layer", "egnn"))))
    for label, dd, modules in trees:
        for dtype in (torch.bfloat16, torch.float32):
            for b in (1, 8, 128):
                use(dd)
                calls = repeat_calls(*modules, b, dtype)
                row = {}
                for kernel, call in calls.items():
                    runs = [call() for _ in range(10)]
                    torch.cuda.synchronize()
                    row[kernel] = differ(runs)
                    del runs
                print("repeat:", json.dumps(dict(
                    tree=label, B=b, E=2560, dtype=str(dtype).split(".")[1],
                    launches=10, entries_that_differ=row)), flush=True)
                del calls
    use(None)


# ---------------------------------------------------------------- SASS

def sass():
    use(None)
    _build.build()
    for lib in sorted(_build.BUILD_DIR.glob("lib*.so")):
        dump = subprocess.run(["cuobjdump", "-sass", str(lib)],
                              capture_output=True, text=True).stdout
        ops = Counter(re.findall(r"\b(ATOMS\.[A-Z0-9.]+|ATOM\.[A-Z0-9.]+|"
                                 r"RED\.[A-Z0-9.]+|ATOMG\.[A-Z0-9.]+)", dump))
        # per function: its HMMA instructions beside its atomics
        funcs = {}
        for name, body in re.findall(r"Function : (\S+)\n(.*?)(?=Function :|\Z)",
                                     dump, flags=re.S):
            hmma = Counter(re.findall(r"\b(HMMA\.[A-Z0-9.]+)", body))
            atoms = Counter(re.findall(r"\b(ATOMS\.[A-Z0-9.]+|"
                                       r"ATOMG?\.[A-Z0-9.]+|RED\.[A-Z0-9.]+)",
                                       body))
            if hmma or atoms:
                funcs[name[:90]] = dict(hmma=hmma, atomics=atoms)
        print("sass:", json.dumps(dict(library=lib.name, atomics=ops,
                                       functions=funcs)), flush=True)


# ---------------------------------------------------------------- B8

SEGMENT_N, SEGMENT_C = 288, 67
# (B, E, dtype, real edges: the rest padded to node 0, masked)
PHASE_SHAPES = ((128, 2560, torch.bfloat16, None),
                (128, 2560, torch.float32, None),
                (128, 1408, torch.bfloat16, None),
                (128, 1280, torch.bfloat16, 1100),
                (77, 1280, torch.bfloat16, 1100),
                (25, 1280, torch.bfloat16, 1100))
MAX_CTAS = 1 << 16
STAMP = ("__device__ unsigned long long g_stamp[{}][8];\n"
         "__device__ __forceinline__ void stamp(int i) {{\n"
         "  unsigned long long t;\n"
         "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
         "  if (threadIdx.x == 0) g_stamp[blockIdx.x][i] = t;\n"
         "}}\n").format(MAX_CTAS)


@functools.lru_cache(maxsize=None)
def entry_operands():
    """{(kernel, shape, dtype): operands} that the train_Cancer_wFT entry
    point gives B8 (chip_smoke.check_cancer_entry_point), once."""
    use(None)
    with tempfile.TemporaryDirectory() as tmp:
        clinical = cs.ClinicalCorpus(str(Path(tmp) / "clinical"))
        clinical.start()
        try:
            row, operands = cs.check_cancer_entry_point(tmp,
                                                        clinical.paths())
        finally:
            clinical.stop()
    print("entry point:", json.dumps(dict(
        wall_s=row["wall_s"], b8_shapes=row["b8_shapes"])), flush=True)
    return operands


def segment_module(csrc_dir: Path):
    """ops/segment.py of the checkout that holds ``csrc_dir``, as a module
    of its own (it imports this tree's ops.edge)."""
    path = csrc_dir.resolve().parent / "ops" / "segment.py"
    spec = importlib.util.spec_from_file_location("baseline_segment", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@contextlib.contextmanager
def segment_as(module):
    """Within the block, ``immunostruct_tpu_torch.ops.segment`` (which
    chip_smoke.py's B8 checks import) is ``module``."""
    name = "immunostruct_tpu_torch.ops.segment"
    saved = sys.modules[name]
    sys.modules[name] = module
    try:
        yield
    finally:
        sys.modules[name] = saved


def segment_round():
    """chip_smoke.py's B8 rows at the bench shapes and the entry point's."""
    rows = []
    for e in cs.EDGE_COUNTS:
        for dtype in (torch.float32, torch.bfloat16):
            idx, mask, m, h = cs.segment_inputs(e, dtype, seed=e + 3)
            rows.append(cs.check_scatter_case(idx, mask, m, cs.N, "bench"))
            rows.append(cs.check_gather_case(idx, mask, h, "bench"))
    operands = entry_operands()
    for key in sorted(operands, key=str):
        check = (cs.check_scatter_case if key[0] == "scatter"
                 else cs.check_gather_case)
        rows.append(check(*operands[key], "entry point"))
    return rows


def segment_times(root, baseline):
    entry_operands()
    trees = [("this", None, segment)]
    if baseline is not None:
        d = build_variants({"baseline": baseline}, ("segment",), root)
        use(d["baseline"])
        other = ("baseline", d["baseline"], segment_module(baseline))
        other[2]._lib()  # its library, from its own segment.cu
        trees = [other, trees[0], trees[0], other]
    rows = []
    for rnd, (label, d, module) in enumerate(trees):
        use(d)
        with segment_as(module):
            for r in segment_round():
                rows.append(dict(r, tree=label, round=rnd))
                print("segment_times:", json.dumps(rows[-1]), flush=True)
    use(None)
    keys = ("ms", "device_ms", "host_us", "library_ms", "library_device_ms",
            "library_host_us", "bound_ms")
    shapes = {}
    for r in rows:
        shape = (r["kernel"], r["shapes"], r["B"], r["E"], r["dtype"])
        shapes.setdefault(shape, {}).setdefault(r["tree"], []).append(
            {k: r[k] for k in keys})
    for shape, by_tree in shapes.items():
        print("segment_times summary:", json.dumps(dict(
            kernel=shape[0], shapes=shape[1], B=shape[2], E=shape[3],
            dtype=shape[4], **by_tree)), flush=True)


def stamped(text: str, without_loads: bool) -> str:
    """segment.cu with the scatter kernel's stamps (segment_phases)."""
    text = text.replace("namespace {\n", "namespace {\n" + STAMP, 1)
    text = text.replace(
        'extern "C" {\n',
        'extern "C" {\nint segment_stamps(void* host) {\n'
        '  return cudaMemcpyFromSymbol(host, g_stamp, sizeof(g_stamp));\n}\n'
        'int segment_stamps_clear() {\n  void* p;\n'
        '  cudaGetSymbolAddress(&p, g_stamp);\n'
        '  return cudaMemset(p, 0, sizeof(g_stamp));\n}\n', 1)
    k0 = text.index("segment_scatter_kernel(const int*")
    k1 = text.index("\n}\n", k0)
    body = text[k0:k1]
    body = body.replace("  extern __shared__ int smem[];",
                        "  stamp(0);\n  extern __shared__ int smem[];", 1)
    parts = body.split("  __syncthreads();\n")
    assert len(parts) == 6, len(parts)
    body = parts[0] + "".join(f"  __syncthreads();\n  stamp({i});\n" + p
                              for i, p in enumerate(parts[1:], start=1))
    body += "\n  __syncthreads();\n  stamp(6);"
    if without_loads:
        load = "val[u][v] = row != nullptr && c < C ? to_f(row[c]) : 0.0f;"
        assert load in body
        body = body.replace(
            load, "val[u][v] = row != nullptr && c < C ? 1.0f : 0.0f;")
    return text[:k0] + body + text[k1:]


def phase_inputs(b, e, dtype, real):
    gen = torch.Generator().manual_seed(b + e)
    idx = torch.randint(0, SEGMENT_N, (b, e), generator=gen,
                        dtype=torch.int32)
    mask = torch.rand(b, e, generator=gen) >= 0.1
    if real:
        idx[:, real:], mask[:, real:] = 0, False
    m = torch.randn(b, e, SEGMENT_C, generator=gen).to(dtype)
    return idx.cuda(), mask.cuda(), m.cuda()


def grid_load(lib, idx, mask, bf16):
    """(valid edges of each CTA's node range: mean, largest; the largest
    in-degree) on the grid the wrapper picks."""
    b, e = idx.shape
    n = SEGMENT_N
    sms, _ = segment._device(lib, idx.device.index)
    ctas = lib.segment_scatter_ctas_per_sm(e, 8, int(bf16))
    r = segment.scatter_range_nodes(n, b, max(1, ctas) * sms)
    valid = mask & (idx >= 0) & (idx < n)
    degree = torch.zeros(b, n, dtype=torch.int64, device=idx.device)
    degree.scatter_add_(1, torch.where(valid, idx, 0).long(), valid.long())
    per_cta = torch.nn.functional.pad(degree, (0, -n % r)).reshape(b, -1, r)
    per_cta = per_cta.sum(-1).float()
    return (round(per_cta.mean().item(), 1), int(per_cta.max().item()),
            int(degree.max().item()))


def percentiles(x):
    return [round(float(v), 3) for v in np.percentile(x, [0, 50, 90, 100])]


def segment_phases(root):
    text = (REPO_CSRC / "segment.cu").read_text()
    forms = {form: {"segment.cu": stamped(text, form != "kernel")}
             for form in ("kernel", "without_loads")}
    dirs = build_variants(forms, ("segment",), root)
    cases = [("uniform", *phase_inputs(*shape)) for shape in PHASE_SHAPES]
    operands = entry_operands()
    cases += [("entry", *operands[key][:3])
              for key in sorted(operands, key=str) if key[0] == "scatter"]
    n = SEGMENT_N
    for form, d in dirs.items():
        use(d)
        lib = segment._lib()
        lib.segment_stamps.argtypes = [ctypes.c_void_p]
        for label, idx, mask, m in cases:
            b, e = idx.shape
            for _ in range(3):
                segment.segment_scatter(idx, mask, m, n)
            torch.cuda.synchronize()
            assert lib.segment_stamps_clear() == 0
            out = segment.segment_scatter(idx, mask, m, n)
            torch.cuda.synchronize()
            want = segment.segment_scatter_reference(idx.cpu(), mask.cpu(),
                                                     m.cpu(), n)
            assert form != "kernel" or torch.equal(out.cpu(), want)
            stamps = np.zeros((MAX_CTAS, 8), dtype=np.uint64)
            assert lib.segment_stamps(stamps.ctypes.data) == 0
            ctas = int((stamps[:, 6] > 0).sum())
            t = stamps[:ctas, :7].astype(np.int64)
            rel = (t - t[:, 0].min()) / 1e3
            phases = np.diff(t, axis=1) / 1e3
            load = grid_load(lib, idx, mask, m.dtype == torch.bfloat16)
            print("segment_phases:", json.dumps(dict(
                form=form, operands=label, B=b, E=e,
                dtype=str(m.dtype).split(".")[1], ctas=ctas,
                edges_per_cta_mean_max=load[:2], largest_in_degree=load[2],
                start_us=percentiles(rel[:, 0]), end_us=percentiles(rel[:, 6]),
                phase_mean_us=[round(float(v), 3) for v in phases.mean(0)],
                phase_max_us=[round(float(v), 3) for v in phases.max(0)])),
                flush=True)
    use(None)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", nargs="+", choices=KERNELS,
                    default=list(KERNELS))
    ap.add_argument("--baseline", type=Path, default=None)
    opts = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    use(None)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    root = Path(tempfile.mkdtemp(dir=_build.BUILD_DIR))
    try:
        for kernel in opts.kernel:
            if kernel == "tail":
                tail(root / "tail", opts.baseline)
            elif kernel == "edge_bwd":
                edge_bwd(root / "edge_bwd")
            elif kernel == "mega_fwd":
                mega_fwd()
                if opts.baseline is not None:
                    fwd_times(root / "mega_fwd", opts.baseline, "mega_fwd")
            elif kernel == "paired_fwd":
                paired_fwd(root / "paired_fwd", opts.baseline)
            elif kernel == "edge_fwd":
                edge_fwd(root / "edge_fwd", opts.baseline)
            elif kernel == "stack_fwd":
                stack_fwd(root / "stack_fwd", opts.baseline)
            elif kernel == "layer_fwd":
                layer_fwd(root / "layer_fwd", opts.baseline)
            elif kernel == "repeat":
                repeat(root / "repeat", opts.baseline)
            elif kernel == "sass":
                sass()
            elif kernel == "segment_times":
                segment_times(root / "segment_times", opts.baseline)
            else:
                segment_phases(root / "segment_phases")
    finally:
        shutil.rmtree(root)
    print(cs.card_line())


if __name__ == "__main__":
    main()
