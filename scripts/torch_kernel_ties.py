"""How close the PyTorch port's hand-written kernels come to their plain
PyTorch versions in bf16, read on the card on every input of their card
tests (tests/test_torch_port_cuda.py) at each test's own seed and at 1..8
(immunostruct_tpu_torch/ops/kernel_checks.py: ``cases``), each input judged
by the checks and the rule defined there (``judge``): every unit within its
bound where the plain version run on the CPU on the same operands meets it,
within the bound plus twice the CPU's own statistic where it does not. A
line per input (whether it meets the rule and the bound, its worst ratio to
what the rule allows and to the bound, the CPU's worst ratio to the bound,
the units restated, the units past the bound and the failing ones) and per
kernel. One section per kernel (--kernel, default all of them):

  sweep     every kernel of --families (default all eleven); where B1's or
            B4's residuals pass their bound, each such a1 entry with
            pa[src] and pb[dst] as the plain version sums them on the card
            and on the CPU, as the kernel sums them (f32 in feature order)
            and in float64, and a1 from each; then each kernel again with
            the CPU run only on the inputs past the bound (chip_smoke.py's
            phase 14b), timed.
  tail      B2, B5a, B5b (csrc/egnn_tail.cuh) for each kTieUlps (the reach
            of the near-tie recompute, csrc/egnn_hopper.cuh) in TIE_ULPS, a
            build of a copy of csrc/ with that constant, and B2's, B5a's and
            B5b's times at B=128, E=2560, F=64 (CUDA events, the builds
            interleaved three times over).
  edge_bwd  B3's bf16 backward (csrc/egnn_edge_bwd.cu) for kTieUlps 32 (the
            source's), -1 (the recompute off), and for the kernel that sums
            dbc1 from d_p3 unrounded (the d_p3 mutant).
  mega_fwd  B1's bf16 form (csrc/egnn_mega_fwd.cu), with sweep's a1 flips.
  paired_fwd
            B4's bf16 form (csrc/egnn_mega_paired_fwd.cu on B1's tensor-core
            kernel, csrc/egnn_mega.cuh), with sweep's a1 flips; its
            residuals are also held to B1's bit for bit.
  edge_fwd  B3's bf16 forward (csrc/egnn_edge_fwd.cu) for kTieUlps 32 (the
            source's) and -1 (the recompute off).
  stack_fwd B6's bf16 form (csrc/egnn_stack_fwd.cu), each layer against the
            plain version of that layer run from the kernel's own previous
            h and x.
  layer_fwd B7's bf16 form (csrc/egnn_layer_fwd.cu).
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
from immunostruct_tpu_torch.ops import kernel_checks as kc  # noqa: E402
from immunostruct_tpu_torch.ops.egnn import EGNNLayer  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "card_tests", ROOT / "tests" / "test_torch_port_cuda.py")
tc = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tc)

TIE_ULPS = (32, -1, 64)  # the first is the source's own
KERNELS = ("sweep", "b3_flips", "tail", "edge_bwd", "mega_fwd", "paired_fwd", "edge_fwd",
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


# ---------------------------------------------------------------- sweep

def _sweep_row(r):
    keep = ("input", "own", "ok", "within_bound", "worst", "worst_vs_bound",
            "cpu_worst", "restated", "over_bound", "failing", "cpu_s")
    return {k: (round(r[k], 4) if isinstance(r[k], float) else r[k])
            for k in keep}


def variant_sweep(kernels, dirs, flips=False):
    """Each kernel of ``kernels`` on every input of kc.cases under each
    build of ``dirs`` ({name: a build_variants directory, or None for this
    tree's}), the CPU's plain version on each input (kc.sweep, yardstick
    "all"): a line per input and per kernel; with ``flips``, where B1's or
    B4's residuals pass their bound, what flipped (a1_flips)."""
    dev = torch.device("cuda")
    cpu_cache = {}                      # the CPU's outputs, one per input
    for name, d in dirs.items():
        use(d)
        for kernel in kernels:
            def report(r, kernel=kernel):
                print(f"{kernel} [{name}]:", json.dumps(_sweep_row(r)),
                      flush=True)
                if (flips and kernel in ("B1", "B4")
                        and any(u[0].startswith(("a1", "xd"))
                                for u in r["over_bound"])):
                    a1_flips(kernel, r["input"], dev)
            _, line = kc.sweep(kernel, yardstick="all", report=report,
                               cpu_cache=cpu_cache)
            print(f"{kernel} [{name}] summary:", json.dumps(line), flush=True)
    use(None)


def sweep(families, timed_failing=True):
    """Every kernel of ``families`` on every input of kc.cases
    (variant_sweep), and with ``timed_failing`` each again with the CPU
    only on the inputs past the bound (chip_smoke.py's phase 14b), timed."""
    use(None)
    _build.build()                      # one nvcc per source, at once
    variant_sweep(families, {"this tree": None}, flips=True)
    if timed_failing:
        for kernel in families:
            _, line = kc.sweep(kernel, yardstick="failing")
            print("sweep failing-yardstick:", json.dumps(line), flush=True)


def _case(kernel, label):
    return next(c for c in kc.cases(kernel) if c.label == label)


def _seq_fma(h, w):
    """h [..., F] @ w [F, H] as one f32 fma a feature in f order from +0
    (B1's projections, csrc/egnn_mega.cuh proj_block), in float64 rounded
    to f32 after every step."""
    acc = torch.zeros(*h.shape[:-1], w.shape[1], dtype=torch.float32,
                      device=h.device)
    for f in range(h.shape[-1]):
        acc = (h[..., f, None].double() * w[f].double()
               + acc.double()).float()
    return acc


def a1_flips(kernel, label, dev, top=4):
    """For an input whose a1 residual is past its bound: the elements past
    it, with pa[src] and pb[dst] (the plain version's torch.matmul on the
    card and on the CPU, the kernel's sequential f32 sum, the float64
    sum) and a1 (kernel, plain on the card, plain on the CPU)."""
    case = _case(kernel, label)
    s = case.shape
    if kernel == "B1":
        args = kc.mega_args(s["b"], s["e"], s["f"], kc.HID, torch.bfloat16,
                            dev, case.seed)
    else:
        args = kc.paired_args(s["b"], s["e"], s["f"], torch.bfloat16, dev,
                              case.seed)
    if s.get("masked"):
        args[2] = args[2].clone()
        args[2][-1] = False
    if s.get("scrambled"):
        args = kc.scrambled_mirror_half(args, seed=case.seed + 1)
    fwd = (mega.edge_mega_fwd if kernel == "B1"
           else mega.edge_mega_paired_fwd)
    plain = (mega.edge_mega_fwd_reference if kernel == "B1"
             else mega.edge_mega_paired_fwd_reference)
    _, a1, _ = fwd(*args)
    _, a1_ref, _ = plain(*args)
    _, a1_cpu, _ = plain(*(t.cpu() for t in args))
    src, dst = (args[:2] if kernel == "B1"
                else mega.mirror_edges(*args[:3])[:2])
    f = s["f"]
    w1 = args[6].to(torch.bfloat16).float()
    hf = args[4].float()

    def both(fn, hh, ww):           # pa | pb [B, N, 2H]
        return torch.cat([fn(hh, ww[:f]), fn(hh, ww[f:])], -1)
    proj = {"card": both(torch.matmul, hf, w1),
            "cpu": both(torch.matmul, hf.cpu(), w1.cpu()).to(dev),
            "seq": both(_seq_fma, hf, w1),
            "f64": both(torch.matmul, hf.double(), w1.double())}
    g, r = a1.float(), a1_ref.float()
    mag = torch.maximum(torch.maximum(g.abs(), r.abs()),
                        torch.tensor(2.0 ** -10, device=g.device))
    steps = (g - r).abs() / kc.step_of(mag)
    idx = (steps > 1).nonzero().tolist()[:top]
    for b_, j, e_ in idx:
        sn, dn = int(src[b_, e_]), int(dst[b_, e_])
        row = dict(input=label, graph=b_, col=j, edge=e_, src=sn, dst=dn,
                   steps=round(steps[b_, j, e_].item(), 3),
                   a1=dict(kernel=g[b_, j, e_].item(), card=r[b_, j, e_].item(),
                           cpu=a1_cpu[b_, j, e_].float().item()))
        for part, node, col in (("pa", sn, j), ("pb", dn, kc.HID + j)):
            vals = {k: v[b_, node, col].item() for k, v in proj.items()}
            row[part] = dict(f32=vals, bf16={
                k: torch.tensor(v).to(torch.bfloat16).item()
                for k, v in vals.items()})
        print("sweep a1 flip:", json.dumps(row), flush=True)



# ---------------------------------------------------------------- tail

TAIL_SOURCES = ("egnn_tail_bwd", "egnn_tail_bwd_db", "egnn_tail_bwd_nodes")


def tail(root, baseline):
    variants = {f"kTieUlps={u}": with_ulps(u) for u in TIE_ULPS}
    if baseline is not None:
        variants["baseline"] = baseline
    dirs = build_variants(variants, TAIL_SOURCES, root)
    variant_sweep(("B2", "B5a", "B5b"), dirs)
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

def d_p3_unrounded():
    """egnn_hopper.cuh with dbc1 summed from d_p3 before its rounding (the
    card tests' d_p3 mutant)."""
    text = (REPO_CSRC / "egnn_hopper.cuh").read_text()
    for pattern, repl in tc._EDGE_BWD_MUTANTS["d_p3"]:
        text, n = re.subn(pattern, repl, text)
        assert n == 1
    return {"egnn_hopper.cuh": text}


def edge_bwd(root):
    variants = {f"kTieUlps={u}": with_ulps(u) for u in TIE_ULPS[:2]}
    variants["d_p3_unrounded"] = d_p3_unrounded()
    variant_sweep(("B3 bwd",), build_variants(variants, ("egnn_edge_bwd",),
                                              root))


# ------------------------------------------------- B3 bwd: what flips

def tie_ulps(v):
    """f32 units in the last place from the nearest bf16 rounding
    boundary."""
    low = v.contiguous().view(torch.int32) & 0xFFFF
    return (low - 0x8000).abs()


def flipped_edges(got, ref):
    """[B, E] count of B3 backward outputs (dhsx, dhdx, def) that differ."""
    return sum((g != r).sum(1) for g, r in zip(got[:3], ref[:3]))



def _edge_chain(hs, hd, eff, db, w1b, w2b, wc1b, sm, dt, flip=None):
    """One edge of B3's backward as edge_program_bwd_reference computes it
    (hs, hd [F+3], eff [1], db [H+3] f32), with the rounding at ``flip``
    ((point, column)) taken to the other bf16 neighbour: (dhsx, dhdx, def)
    in the compute dtype, and each rounding point's value before it
    rounds."""
    f = hs.shape[0] - 3
    hid = w2b.shape[1]
    pre = {}

    def rnd(name, v):
        pre[name] = v
        r = v.to(dt).float()
        if flip is not None and flip[0] == name:
            j = flip[1]
            up = r[j] < v[j]
            here = r[j].to(dt)
            nxt = torch.nextafter(here, torch.full_like(
                here, float("inf") if up else float("-inf"))).float()
            r = r.clone()
            r[j] = nxt
        return r
    xd = rnd("xd", hs[f:] - hd[f:])
    rad = rnd("rad", (xd * xd).sum(-1, keepdim=True))
    safe = torch.where(rad > 0, rad, torch.ones_like(rad))
    inv_s = 1.0 / (torch.sqrt(safe) + 1e-30)
    hsd = torch.cat([hs[:f], hd[:f]])
    a1 = (hsd @ w1b + sm[:, edge.W1R] * rad + sm[:, edge.W1E] * eff
          + sm[:, edge.B1])
    s1 = torch.sigmoid(a1)
    a1s = rnd("a1s", a1 * s1)
    p2 = a1s @ w2b + sm[:, edge.B2]
    s2 = torch.sigmoid(p2)
    m = rnd("m", p2 * s2)
    p3 = m @ wc1b + sm[:, edge.BC1]
    s3 = torch.sigmoid(p3)
    c1 = rnd("c1", p3 * s3)
    cw_b = rnd("cw", (c1 * sm[:, edge.WC2]).sum(-1, keepdim=True))
    x_hat = xd * inv_s
    d_m_in, d_msgx = db[:hid], db[hid:]
    d_cw = (d_msgx * x_hat).sum(-1, keepdim=True)
    d_xhat = d_msgx * cw_b
    d_p3 = rnd("d_p3", sm[:, edge.WC2] * d_cw * edge.silu_grad(p3, s3))
    d_m = d_m_in + d_p3 @ wc1b.T
    d_p2 = rnd("d_p2", d_m * edge.silu_grad(p2, s2))
    d_a1 = rnd("d_a1", (d_p2 @ w2b.T) * edge.silu_grad(a1, s1))
    d_hsd = d_a1 @ w1b.T
    d_rad_chain = (sm[:, edge.W1R] * d_a1).sum(-1, keepdim=True)
    sum_dxh_xd = (d_xhat * xd).sum(-1, keepdim=True)
    d_safe = sum_dxh_xd * (-0.5) * inv_s * inv_s / torch.sqrt(safe)
    d_rad = d_rad_chain + torch.where(rad > 0, d_safe, 0.0)
    d_xd = d_xhat * inv_s + 2.0 * xd * d_rad
    d_ef = (sm[:, edge.W1E] * d_a1).sum(-1, keepdim=True)
    out = (torch.cat([d_hsd[:f], d_xd]).to(dt),
           torch.cat([d_hsd[f:], -d_xd]).to(dt), d_ef.to(dt))
    return out, pre


def which_flip(args, dout, got, b_, e_, reach=4096):
    """The rounding of edge (b_, e_)'s chain that, taken the other way,
    brings the plain version's outputs nearest the kernel's (of those, the
    one whose value lies nearest its bf16 boundary): (point, column,
    entries that still differ, entries that differ unflipped, its value's
    distance from the boundary in f32 units)."""
    hsx, hdx, ef, w1ab, w2, wc1, small = args
    dt = hsx.dtype

    def r(t):
        return t.to(dt).float()
    w1b, w2b, wc1b, sm = r(w1ab), r(w2), r(wc1), small.float()
    inputs = (hsx[b_, :, e_].float(), hdx[b_, :, e_].float(),
              ef[b_, :, e_].float(), dout[b_, :, e_].to(dt).float(),
              w1b, w2b, wc1b, sm, dt)
    want = [got[0][b_, :, e_], got[1][b_, :, e_], got[2][b_, :, e_]]

    def misses(out):
        return int(sum((o != w).sum() for o, w in zip(out, want)))
    base, pre = _edge_chain(*inputs)
    before = misses(base)
    found = []                          # (entries left, distance, point, col)
    for name, v in pre.items():
        if name == "xd":                # one exact subtraction: no order
            continue
        dist = tie_ulps(v)
        for j in (dist <= reach).nonzero().flatten().tolist():
            n = misses(_edge_chain(*inputs, flip=(name, j))[0])
            found.append((n, int(dist[j]), name, j))
    if not found:
        return None, None, before, before, None
    # a flip needs a value near a boundary: of the replays that come
    # nearest the kernel's, the one nearest its boundary (another one's
    # flip can follow from it downstream)
    n, dist, name, j = min(found)
    return name, j, n, before, dist


def b3_flips(labels, top=12, dev=torch.device("cuda")):
    """For each B3 bwd input: the edges whose outputs differ from the card
    plain version's in 3 or more entries (a flipped rounding in the chain;
    1-2 entries: a flipped store, counted by output), for the kernel and for
    the plain version run on the CPU; at the kernel's chain-flipped edges that the CPU does
    not flip, which rounding the kernel took the other way (which_flip:
    the plain chain replayed with each rounding within 4096 f32 units of a
    bf16 boundary taken the other way; the one that leaves the fewest
    entries differing from the kernel's)."""
    for label in labels:
        case = _case("B3 bwd", label)
        s = case.shape
        args, dout = kc.edge_args(s["b"], s["e"], s["f"], torch.bfloat16,
                                  dev, case.seed, tail=s["tail"])
        got = edge.edge_program_bwd(*args, dout)
        ref = edge.edge_program_bwd_reference(*args, dout)
        cpu = kc.on(dev, edge.edge_program_bwd_reference(
            *kc.on("cpu", args), dout.cpu()))
        nk, nc = flipped_edges(got, ref), flipped_edges(cpu, ref)
        only = ((nk >= 3) & (nc < 3)).nonzero().tolist()
        points = Counter()
        rows = []
        for b_, e_ in only:
            point, col, left, before, dist = which_flip(args, dout, got, b_,
                                                        e_)
            points[point] += 1
            if len(rows) < top:
                rows.append(dict(edge=[b_, e_], entries=before, point=point,
                                 column=col, entries_left=left, ulps=dist))
        f = s["f"]
        store = Counter()
        for b_, e_ in ((nk > 0) & (nk < 3)).nonzero().tolist():
            for t_ in (0, 1):
                rows_ = (got[t_][b_, :, e_] != ref[t_][b_, :, e_]).nonzero()
                for (r_,) in rows_.tolist():
                    store["d_xd" if r_ >= f else "d_hsd"] += 1
            store["d_ef"] += int(got[2][b_, 0, e_] != ref[2][b_, 0, e_])
        print("b3 flips:", json.dumps(dict(kernel_store_entries=dict(store),
            input=label, kernel_chain_flips=int((nk >= 3).sum()),
            kernel_store_flips=int(((nk > 0) & (nk < 3)).sum()),
            cpu_chain_flips=int((nc >= 3).sum()),
            cpu_store_flips=int(((nc > 0) & (nc < 3)).sum()),
            kernel_only=len(only), flipped_point=dict(points))), flush=True)
        for r in rows:
            print("b3 flip:", json.dumps(r), flush=True)



# ------------------------------------------------- B1, B4, B3 fwd

def mega_fwd():
    variant_sweep(("B1",), {"this tree": None}, flips=True)


def paired_fwd(root, baseline):
    variant_sweep(("B4",), {"this tree": None}, flips=True)
    if baseline is not None:
        fwd_times(root, baseline, "paired_fwd")


def edge_fwd(root, baseline):
    variants = {f"kTieUlps={u}": with_ulps(u) for u in TIE_ULPS[:2]}
    variant_sweep(("B3 fwd",), build_variants(variants, ("egnn_edge_fwd",),
                                              root / "ties"))
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
                        if b == cs.B else kc.paired_args(
                            b, e, f, dtype, dev, seed=e + f + 2))
            return kc.mega_args(b, e, f, 64, dtype, dev, seed=e + f + 2)
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

def stack_fwd(root, baseline):
    variant_sweep(("B6",), {"this tree": None})
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

def layer_fwd(root, baseline):
    variant_sweep(("B7",), {"this tree": None})
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
    a1 = kc.mega_args(b, 2560, 20, 64, dtype, dev, seed=b + 40)
    a4 = kc.paired_args(b, 2560, 20, dtype, dev, seed=b + 40)
    a6, packed = kc.stack_args(b, 2560, dtype, dev, seed=b + 41)
    layer, a7 = kc.b7_args(b, 2560, 64, dtype, dev, seed=b + 42)
    idx, mask, m, _ = kc.segment_args(b, 2560, N_SEG, 67, dtype, dev,
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
    ap.add_argument("--inputs", nargs="+", default=None,
                    help="b3_flips: the B3 bwd inputs (kc.cases labels)")
    ap.add_argument("--families", nargs="+", choices=kc.KERNELS,
                    default=list(kc.KERNELS),
                    help="the kernels the sweep section reads")
    opts = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    use(None)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    root = Path(tempfile.mkdtemp(dir=_build.BUILD_DIR))
    try:
        for kernel in opts.kernel:
            if kernel == "sweep":
                sweep(opts.families)
            elif kernel == "b3_flips":
                use(None)
                b3_flips(opts.inputs or [c.label for c in kc.cases("B3 bwd")])
            elif kernel == "tail":
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
