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
  edge_recompute
            B1's body as it is and in each form of BODY_VARIANTS (without
            the edge chain's near-tie recompute, with parts of it): B6 and
            B1 (--families) at B=1, E=2560 on their sweep inputs and
            --seeds more, judged by the rule; chip_smoke.py's B=1 row of B6
            against the plain version as it is and unordered, and per layer
            kernel - card plain, kernel - CPU and CPU - card plain.
  ties      how often B1's body recomputes an a1s, m or c1 near a tie (a
            probe build that counts them, csrc/egnn_mega.cuh
            EDGE_TIE_PROBE), in B1, B4 and B6 at B=128 and B=1.
  times     every kernel (B1, B4, B6 at B=128 and B=1 with and without the
            residuals; B2, B3 fwd and bwd, B5a, B5b, B7, B8 at B=128), the
            plain versions of B1, B4 and B6 on the card, B1's and B6's
            forward on the CPU and the 'mega' train step, each tree in a
            process of its own (a checkout's ops modules register the same
            torch.library ops): the checkout of --baseline, this tree, and
            this tree with B1's body varied (--variants), in that order and
            back; per call each tree's ms and a digest of its outputs.
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

--baseline OTHER_CSRC_DIR (the times section) is the csrc/ directory of
another checkout (say, the parent commit's, from ``git archive``), whose
own ops modules and chip_smoke.py time its kernels and its train step;
where a call's digest is the baseline's, its outputs are the same bits.
Every build goes to a temporary directory under the build directory,
removed at the end.

    python scripts/torch_kernel_ties.py [--kernel times ties ...]
        [--baseline OTHER_CSRC_DIR] [--variants ...]
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
KERNELS = ("sweep", "b3_flips", "edge_recompute", "ties", "times",
           "tail", "edge_bwd", "mega_fwd", "paired_fwd", "edge_fwd",
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
    variants[name], {file: text}, in it; for a Path, that directory; for a
    (Path, {file: text}) pair, that directory with those files in it) and
    each of ``sources`` built there, one nvcc each, all at once. Prints
    the registers and spill stores of each library's tensor-core kernel,
    where it has one."""
    dirs, procs = {}, []
    nvcc = _build._nvcc()
    for name, texts in variants.items():
        d = root / name
        base = texts if isinstance(texts, Path) else REPO_CSRC
        if isinstance(texts, tuple):    # (a csrc/ directory, {file: text})
            base, texts = texts
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
    """The sweep's input of that label, or one at another seed: "B6 b=1
    e=2560 seed=129" (integer shape fields, True for a flag)."""
    for c in kc.cases(kernel):
        if c.label == label:
            return c
    fields = dict(f.split("=") for f in label[len(kernel) + 1:].split())
    seed = int(fields.pop("seed"))
    shape = {k: v == "True" if v in ("True", "False") else int(v)
             for k, v in fields.items()}
    return kc.Case(kernel, label, seed, False, shape)


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
            "seq": both(mega.projection_in_order, hf, w1),
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


def tail(root):
    variants = {f"kTieUlps={u}": with_ulps(u) for u in TIE_ULPS}
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


def paired_fwd():
    variant_sweep(("B4",), {"this tree": None}, flips=True)


def edge_fwd(root):
    variants = {f"kTieUlps={u}": with_ulps(u) for u in TIE_ULPS[:2]}
    variant_sweep(("B3 fwd",), build_variants(variants, ("egnn_edge_fwd",),
                                              root / "ties"))


# ---------------------------------------------------------------- B6

def stack_fwd():
    variant_sweep(("B6",), {"this tree": None})


# ------------------------------------- B1's body: the edge chain's recompute

def body_variant(patterns, csrc=REPO_CSRC):
    """{file: text}: csrc/egnn_mega.cuh with each (pattern, replacement)
    applied (each matching at least once)."""
    text = (csrc / "egnn_mega.cuh").read_text()
    for pattern, repl in patterns:
        text, n = re.subn(pattern, repl, text)
        assert n >= 1, pattern
    return {"egnn_mega.cuh": text}


# Forms of B1's body (csrc/egnn_mega.cuh; B4 and B6 run it too) that
# --kernel times and edge_recompute build beside this tree's: without the
# edge chain's near-tie recompute and with a1 and cw fused as they were (the
# card tests' _NO_EDGE_RECOMPUTE: the body before it, bit for bit); a1 and
# cw op by op with no recompute; with the m and c1 recompute but not the
# a1s one; and with the a1s recompute alone.
BODY_VARIANTS = {
    "no recompute, fused sums": tc._NO_EDGE_RECOMPUTE,
    "no recompute": [(r"near_tie\(", r"0 && near_tie(")],
    "no a1s recompute": [(r"if \(near_tie\(v\[c\]\)\)",
                          r"if (0 && near_tie(v[c]))")],
    "a1s recompute alone": [(r"near_tie\((mv|cv)\)", r"0 && near_tie(\1)")],
}


def layer_readings(got, ref):
    """got, ref: (h, x, agg) of one B6 layer: {check: [the worst unit's
    ratio to its bound, the unit]} by kernel_checks' B6 checks (agg in
    steps and per-column mean, h and x per-column mean)."""
    def cols(t):
        return t.float().flatten(0, 1).T
    checks = kc.col_steps_checks("agg", got[2], ref[2], None)
    for name, g, r in zip(("h", "x"), got[:2], ref[:2]):
        checks += kc.rows_checks(name, cols(g), cols(r), None,
                                 kc.NODE_COL_MEAN, None)
    out = {}
    for ch in checks:
        q = ch.got / ch.bound.clamp_min(kc.TINY)
        i = int(q.argmax())
        out[ch.name] = [round(q[i].item(), 4), i]
    return out


def layer_refs(out, args, packed, device):
    """Per layer, B6's plain version of that layer run on ``device`` from
    the kernel's own previous h and x: (h, x, agg, a1) on the card."""
    src, dst, mask, ef = args[:4]
    refs = []
    for layer, weights in enumerate(packed):
        ins = (src, dst, mask, ef, *kc._layer_inputs(out, args, layer))
        ref = stack.stack_fwd_reference(*kc.on(device, ins),
                                        [kc.on(device, weights)])
        hs, xs, aggs, a1s = (t[:, 0].to(src.device) for t in ref[2:6])
        refs.append((hs, xs, aggs, a1s))
    return refs


def b6_readings(name, out, args, packed):
    """chip_smoke.py's B6 row at B=1 under the build ``name``: per layer the
    kernel against the plain version on the card (in the kernels' order and
    as it was before, unordered_plain) and on the CPU, the CPU's against
    both card forms, and the a1 residual entries (valid edges) where the
    kernel's differ from the CPU's."""
    dev = args[0].device
    cpu = layer_refs(out, args, packed, "cpu")
    card = layer_refs(out, args, packed, dev)
    with tc.unordered_plain():
        old = layer_refs(out, args, packed, dev)
    valid = mega.valid_edges(*args[:3], kc.N)[:, None, :]
    for layer in range(len(packed)):
        kernel = [t[:, layer] for t in out[2:6]]
        forms = {"kernel": kernel, "card": card[layer], "old card": old[layer],
                 "cpu": cpu[layer]}
        reads = {f"{a}_vs_{b}".replace(" ", "_"): layer_readings(
            forms[a][:3], forms[b][:3]) for a, b in (
            ("kernel", "card"), ("kernel", "old card"), ("kernel", "cpu"),
            ("cpu", "card"), ("cpu", "old card"))}
        a1_diff = (kernel[3] != cpu[layer][3]) & valid
        print("b6 readings:", json.dumps(dict(
            build=name, layer=layer, **reads,
            a1_entries_otherwise_than_cpu=int(a1_diff.sum()))), flush=True)


def edge_recompute(root, seeds, kernels=("B6", "B1")):
    """B1's body with and without its edge chain's near-tie recompute: B6
    (B=1, E=2560) and B1 (B=1, E=2560, F=64) on their sweep inputs and on
    ``seeds`` more, judged by the rule (the CPU on the inputs past the
    bound), a line per build and kernel with the failing inputs, for this
    tree and every form of BODY_VARIANTS (the first: the body before the
    recompute). Then chip_smoke.py's B6 row at B=1 under each build: the
    rule against the plain version as it is and unordered (the card tests'
    unordered_plain), and the readings of b6_readings."""
    dirs = build_variants({name: body_variant(patterns)
                           for name, patterns in BODY_VARIANTS.items()},
                          ("egnn_stack_fwd", "egnn_mega_fwd"), root)
    dev = torch.device("cuda")
    extra = {"B6": [kc.Case("B6", f"B6 b=1 e=2560 seed={s}", s, False,
                            dict(b=1, e=2560)) for s in seeds],
             "B1": [kc.Case("B1", f"B1 b=1 e=2560 f=64 seed={s}", s, False,
                            dict(b=1, e=2560, f=64)) for s in seeds]}
    (smoke,) = [c for c in kc.cases("B6") if c.shape.get("smoke")]
    args, packed = kc.stack_args(1, 2560, torch.bfloat16, dev, smoke.seed)
    for name, build in (("this tree", None), *dirs.items()):
        use(build)
        for kernel in kernels:
            rows = [kc.run_case(c, dev, "failing")
                    for c in kc.cases(kernel) + extra[kernel]]
            print("edge recompute:", json.dumps(dict(
                build=name, kernel=kernel, inputs=len(rows),
                failing=[(r["input"], r["failing"][:2]) for r in rows
                         if not r["ok"]],
                worst=round(max(r["worst"] for r in rows), 4))), flush=True)
        out = stack.stack_fwd(*args, packed)
        for plain, ctx in (("as it is", contextlib.nullcontext),
                           ("unordered", tc.unordered_plain)):
            with ctx():
                v = kc.judge(kc.stack_checks(out, args, packed, cpu=True))
            print("edge recompute smoke row:", json.dumps(dict(
                build=name, plain=plain, ok=v["ok"],
                worst=round(v["worst"], 4), failing=v["failing"][:3],
                over_bound=v["over_bound"][:3])), flush=True)
        b6_readings(name, out, args, packed)
    use(None)


# A probe of B1's body: it defines EDGE_TIE_PROBE (csrc/egnn_mega.cuh) to
# count, per kind (a1s, m, c1), the recomputes, the warps' loop trips (a
# warp runs the loop as often as its lane with the most ties), the warp
# tiles with a recompute and the warp tiles (m and c1 only: an a1s is
# counted where it is recomputed, in a lane of its own).
TIE_PROBE = r"""
__device__ unsigned long long g_edge_ties[3][4];
__device__ __forceinline__ void edge_tie_probe(int kind, unsigned ties) {
  if (kind == 0) {
    atomicAdd(&g_edge_ties[0][0], 1ull);
    return;
  }
  const unsigned n = __popc(ties);
  const unsigned sum = __reduce_add_sync(0xffffffffu, n);
  const unsigned most = __reduce_max_sync(0xffffffffu, n);
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&g_edge_ties[kind][0], (unsigned long long)sum);
    atomicAdd(&g_edge_ties[kind][1], (unsigned long long)most);
    atomicAdd(&g_edge_ties[kind][2], most ? 1ull : 0ull);
    atomicAdd(&g_edge_ties[kind][3], 1ull);
  }
}
#define EDGE_TIE_PROBE(kind, ties) edge_tie_probe(kind, ties)
"""
TIE_READER = r"""
extern "C" int edge_ties(void* host) {
  return cudaMemcpyFromSymbol(host, g_edge_ties, sizeof(g_edge_ties));
}
extern "C" int edge_ties_clear() {
  void* p;
  if (cudaGetSymbolAddress(&p, g_edge_ties) != cudaSuccess) return 1;
  return cudaMemset(p, 0, sizeof(g_edge_ties));
}
"""
BODY_SOURCES = ("egnn_mega_fwd", "egnn_mega_paired_fwd", "egnn_stack_fwd")


def ties(root):
    """How often B1's body recomputes near a tie (TIE_PROBE), in B1, B4
    and B6 at B=128 and B=1, E=2560, bf16, on --kernel times' inputs: per
    kind the recomputes, their share of the values checked (a warp tile
    checks 16 x 64 of each kind), the warps' loop trips a warp tile and
    the share of warp tiles with a recompute; and whether the probe's
    outputs are this tree's bit for bit."""
    texts = {f"{s}.cu": TIE_PROBE + (REPO_CSRC / f"{s}.cu").read_text()
             + TIE_READER for s in BODY_SOURCES}
    probe = build_variants({"probe": texts}, BODY_SOURCES, root)["probe"]
    dev, bf = torch.device("cuda"), torch.bfloat16
    calls = {}
    for b in (cs.B, 1):
        a1 = kc.mega_args(b, 2560, 64, 64, bf, dev, seed=2624)
        a4 = kc.paired_args(b, 2560, 64, bf, dev, seed=2626)
        a6, packed = kc.stack_args(b, 2560, bf, dev, seed=2566)
        calls[f"B1 B={b}"] = (lambda a=a1: mega.edge_mega_fwd(*a),
                              lambda: mega._fwd_lib())
        calls[f"B4 B={b}"] = (lambda a=a4: mega.edge_mega_paired_fwd(*a),
                              lambda: mega._paired_lib())
        calls[f"B6 B={b}"] = (lambda a=a6, p=packed: stack.stack_fwd(*a, p),
                              lambda: stack._lib())
    for name, (fn, lib_of) in calls.items():
        use(None)
        want = fn()
        use(probe)
        lib = lib_of()
        lib.edge_ties.argtypes = [ctypes.c_void_p]
        assert lib.edge_ties_clear() == 0
        got = fn()
        torch.cuda.synchronize()
        counts = np.zeros((3, 4), dtype=np.uint64)
        assert lib.edge_ties(counts.ctypes.data) == 0
        tiles = int(counts[1, 3])
        kinds = {}
        for k, kind in enumerate(("a1s", "m", "c1")):
            row = dict(recomputes=int(counts[k, 0]),
                       share=int(counts[k, 0]) / max(1, tiles * 16 * 64))
            if k:
                row.update(trips_a_tile=int(counts[k, 1]) / max(1, tiles),
                           tiles_with_one=int(counts[k, 2]) / max(1, tiles))
            kinds[kind] = row
        print("ties:", json.dumps(dict(
            call=name, warp_tiles=tiles, **kinds,
            same_bits=all(torch.equal(x, y) for x, y in zip(got, want)))),
            flush=True)
    use(None)


# Every kernel, three plain versions, B1's and B6's forward on the CPU and
# the 'mega' train step, timed in a fresh process for each tree (argv[1]:
# the checkout's root; argv[2], where given: a build directory of this
# tree's with B1's body varied, whose csrc/ and build/ it loads): a
# checkout's ops modules register the same torch.library ops, so two cannot
# share a process. Inputs from kernel_checks and chip_smoke.py, E=2560,
# bf16; CUDA events over 20 launches after 3, the median of 5 such windows
# (the plain versions 5 launches, 3 windows); the CPU forms by the host's
# clock, the median of 3 calls; the train step as chip_smoke.py's phase 16
# times it (the median of 20 steps after the first 3). One JSON line:
# {call: [ms, a digest of its outputs]}.
_TIMES = r"""
import hashlib, json, statistics, sys, time
from pathlib import Path
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
from immunostruct_tpu_torch.data.synthetic import random_sample_batch
from immunostruct_tpu_torch.ops import (_build, edge, fused_layer, mega,
                                        segment, stack)
from immunostruct_tpu_torch.ops import kernel_checks as kc
assert mega.__file__.startswith(sys.argv[1]), mega.__file__
variant = len(sys.argv) > 2
if variant:
    _build.CSRC = Path(sys.argv[2]) / "csrc"
    _build.BUILD_DIR = Path(sys.argv[2]) / "build"
_build.build()
torch.backends.cuda.matmul.allow_tf32 = False
bf, dev = torch.bfloat16, "cuda"
def digest(out):
    h = hashlib.sha256()
    for t in out if isinstance(out, (tuple, list)) else (out,):
        if isinstance(t, torch.Tensor):
            h.update(t.detach().contiguous().cpu().view(torch.uint8)
                     .numpy().tobytes())
        else:
            h.update(repr(t).encode())
    return h.hexdigest()[:12]
def ms(fn, iters=20, windows=5):
    for _ in range(3):
        fn()
    out = []
    for _ in range(windows):
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        z.record()
        z.synchronize()
        out.append(a.elapsed_time(z) / iters)
    return [statistics.median(out), digest(fn())]
def host_ms(fn):
    out = []
    for _ in range(3):
        t0 = time.perf_counter()
        got = fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return [statistics.median(out), digest(got)]
rows = {}
for b in (cs.B, 1):
    a1 = kc.mega_args(b, 2560, 64, 64, bf, dev, seed=2624)
    rows[f"B1 B={b}"] = ms(lambda: mega.edge_mega_fwd(*a1))
    rows[f"B1 B={b} without residuals"] = ms(
        lambda: mega.edge_mega_fwd(*a1, residuals=False))
    a4 = kc.paired_args(b, 2560, 64, bf, dev, seed=2626)
    rows[f"B4 B={b}"] = ms(lambda: mega.edge_mega_paired_fwd(*a4))
    rows[f"B4 B={b} without residuals"] = ms(
        lambda: mega.edge_mega_paired_fwd(*a4, residuals=False))
    a6, packed = kc.stack_args(b, 2560, bf, dev, seed=2566)
    rows[f"B6 B={b}"] = ms(lambda: stack.stack_fwd(*a6, packed))
    rows[f"B6 B={b} without residuals"] = ms(
        lambda: stack.stack_fwd(*a6, packed, residuals=False))
    if b == cs.B:
        slow = dict(iters=5, windows=3)
        rows["B1 plain B=128"] = ms(
            lambda: mega.edge_mega_fwd_reference(*a1), **slow)
        rows["B4 plain B=128"] = ms(
            lambda: mega.edge_mega_paired_fwd_reference(*a4), **slow)
        rows["B6 plain B=128"] = ms(
            lambda: stack.stack_fwd_reference(*a6, packed), **slow)
e3 = cs.edge_inputs(2560, 64, bf, seed=2626)
rows["B3 fwd B=128"] = ms(lambda: edge.edge_program_fwd(*e3[0]))
rows["B3 bwd B=128"] = ms(lambda: edge.edge_program_bwd(*e3[0], e3[1]))
g = cs.tail_g_inputs(2560, 64, bf, seed=7)
b2 = cs.b2_operands(*g)
rows["B2 B=128"] = ms(lambda: mega.tail_bwd(*b2))
rows["B5a B=128"] = ms(lambda: mega.tail_bwd_db(g[1], *g[2:]))
rows["B5b B=128"] = ms(lambda: mega.tail_bwd_nodes(*g))
layer, a7 = kc.b7_args(cs.B, 2560, 64, bf, dev, seed=2631)
with torch.no_grad():
    rows["B7 B=128"] = ms(lambda: fused_layer.fused_egnn_layer(layer, *a7))
idx, mask, m, h = kc.segment_args(cs.B, 2560, cs.N, 67, bf, dev, seed=2633)
rows["B8 scatter B=128"] = ms(lambda: segment.segment_scatter(idx, mask, m,
                                                              cs.N))
rows["B8 gather B=128"] = ms(lambda: segment.segment_gather(idx, mask, h))
if not variant:
    for b in (cs.B, 8):
        c1 = kc.on("cpu", kc.mega_args(b, 2560, 64, 64, bf, dev, seed=2624))
        rows[f"B1 on the CPU B={b}"] = host_ms(lambda: mega.edge_mega_fwd(*c1))
    c6, p6 = kc.on("cpu", kc.stack_args(8, 2560, bf, dev, seed=2566))
    rows["B6 on the CPU B=8"] = host_ms(lambda: stack.stack_fwd(*c6, p6))
trainer, state = cs.make_trainer("HybridModelv2", "mega")
batch = random_sample_batch(cs.B, cs.N, 2560, cs.L, seed=0, device=dev)
losses, step_ms = cs.timed_steps(trainer, state, batch, cs.TRAIN_STEPS)
rows["'mega' train step B=128"] = [statistics.median(step_ms[3:]),
                                   digest(losses)]
print(json.dumps(rows))
"""


def times(root, baseline, variants):
    """_TIMES for the checkout holding ``baseline`` (its csrc/ directory),
    this tree and this tree with each form of BODY_VARIANTS named in
    ``variants``, each tree in a process of its own, in that order and then
    back: a line per call with each tree's [ms, digest] readings (the same
    digest, the same bits)."""
    dirs = build_variants({v: body_variant(BODY_VARIANTS[v])
                           for v in variants}, BODY_SOURCES, root)
    trees = [("this", ROOT, None)] + [(v, ROOT, d) for v, d in dirs.items()]
    if baseline is not None:
        trees.insert(0, ("baseline", baseline.resolve().parents[1], None))
    got = {name: [] for name, _, _ in trees}
    for name, tree, d in trees + trees[::-1]:
        run = subprocess.run([sys.executable, "-c", _TIMES, str(tree)]
                             + ([str(d)] if d else []),
                             capture_output=True, text=True)
        assert run.returncode == 0, (name, run.stderr[-3000:])
        got[name].append(json.loads(run.stdout.strip().splitlines()[-1]))
    for key in got["this"][0]:
        print("times:", json.dumps({"call": key, **{
            name: [r.get(key) for r in rows] for name, rows in got.items()}}),
            flush=True)


# ---------------------------------------------------------------- B7

def layer_fwd():
    variant_sweep(("B7",), {"this tree": None})


# ---------------------------------------------------------------- repeat

def differ(runs):
    """Entries of runs[1:] that differ from runs[0]'s, summed."""
    total = 0
    for run in runs[1:]:
        for a, z in zip(runs[0], run):
            if a is not None:
                total += int((a != z).sum().item())
    return total


def repeat_calls(b, dtype):
    """{kernel: a call on one seeded input} at B=b, E=2560."""
    dev = torch.device("cuda")
    a1 = kc.mega_args(b, 2560, 20, 64, dtype, dev, seed=b + 40)
    a4 = kc.paired_args(b, 2560, 20, dtype, dev, seed=b + 40)
    a6, packed = kc.stack_args(b, 2560, dtype, dev, seed=b + 41)
    layer, a7 = kc.b7_args(b, 2560, 64, dtype, dev, seed=b + 42)
    idx, mask, m, _ = kc.segment_args(b, 2560, N_SEG, 67, dtype, dev,
                                       seed=b + 43)
    calls = {
        "B1": lambda: mega.edge_mega_fwd(*a1),
        "B4": lambda: mega.edge_mega_paired_fwd(*a4),
        "B6": lambda: stack.stack_fwd(*a6, packed),
        "B8_scatter": lambda: (segment.segment_scatter(idx, mask, m, N_SEG),),
    }

    def b7():
        with torch.no_grad():
            return fused_layer.fused_egnn_layer(layer, *a7)
    calls["B7"] = b7
    if dtype == torch.bfloat16:
        src, dst, msk = a1[:3]
        _, r1, rx = mega.edge_mega_fwd(*a1)
        valid = mega.valid_edges(src, dst, msk, N_SEG)
        g = torch.randn(b, N_SEG, 67, generator=torch.Generator()
                        .manual_seed(b)).to(dev)
        calls["hybrid backward"] = lambda: mega.edge_half_bwd(
            src, dst, valid, *a1[3:], r1, rx, g, "hybrid")
        gen = torch.Generator().manual_seed(b + 44)
        lay = EGNNLayer(20, 64, 64, generator=gen, device=dev)
        cot = torch.randn(b, N_SEG, 64, generator=gen).to(dev, dtype)
        for agg in ("fused", "pallas"):
            def run(agg=agg):
                lay.zero_grad()
                hin = a1[4].detach().clone().requires_grad_(True)
                h2, x2 = egnn.egnn_apply(lay, hin, a1[5], src, dst,
                                                a1[3], msk, agg)
                ((h2 * cot).float().sum() + x2.float().sum()).backward()
                return [h2.detach(), x2.detach(), hin.grad] + [
                    p.grad.clone() for p in lay.parameters()]
            calls[f"'{agg}' layer"] = run
    return calls


N_SEG = 288


def repeat():
    for dtype in (torch.bfloat16, torch.float32):
        for b in (1, 8, 128):
            calls = repeat_calls(b, dtype)
            row = {}
            for kernel, call in calls.items():
                runs = [call() for _ in range(10)]
                torch.cuda.synchronize()
                row[kernel] = differ(runs)
                del runs
            print("repeat:", json.dumps(dict(
                B=b, E=2560, dtype=str(dtype).split(".")[1], launches=10,
                entries_that_differ=row)), flush=True)
            del calls


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


def segment_times():
    entry_operands()
    for r in segment_round():
        print("segment_times:", json.dumps(r), flush=True)


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
    ap.add_argument("--baseline", type=Path, default=None,
                    help="times: another checkout's csrc/ directory")
    ap.add_argument("--variants", nargs="*", choices=list(BODY_VARIANTS),
                    default=[], help="times: forms of B1's body to build")
    ap.add_argument("--inputs", nargs="+", default=None,
                    help="b3_flips: the B3 bwd inputs (kc.cases labels)")
    ap.add_argument("--seeds", type=int, default=200,
                    help="edge_recompute: extra seeds from 100 on")
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
            use(None)
            if kernel == "sweep":
                sweep(opts.families)
            elif kernel == "b3_flips":
                b3_flips(opts.inputs or [c.label for c in kc.cases("B3 bwd")])
            elif kernel == "edge_recompute":
                edge_recompute(root / "edge_recompute",
                               range(100, 100 + opts.seeds),
                               [k for k in ("B6", "B1")
                                if k in opts.families])
            elif kernel == "ties":
                ties(root / "ties")
            elif kernel == "times":
                times(root / "times", opts.baseline, opts.variants)
            elif kernel == "tail":
                tail(root / "tail")
            elif kernel == "edge_bwd":
                edge_bwd(root / "edge_bwd")
            elif kernel == "mega_fwd":
                mega_fwd()
            elif kernel == "paired_fwd":
                paired_fwd()
            elif kernel == "edge_fwd":
                edge_fwd(root / "edge_fwd")
            elif kernel == "stack_fwd":
                stack_fwd()
            elif kernel == "layer_fwd":
                layer_fwd()
            elif kernel == "repeat":
                repeat()
            elif kernel == "sass":
                sass()
            elif kernel == "segment_times":
                segment_times()
            else:
                segment_phases(root / "segment_phases")
    finally:
        shutil.rmtree(root)
    print(cs.card_line())


if __name__ == "__main__":
    main()
