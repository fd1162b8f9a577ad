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
  sass      the atomic instructions in each kernel library's SASS
            (cuobjdump), by opcode.

--baseline OTHER_CSRC_DIR adds a build of another csrc/ directory (an
earlier form of the kernels, say, from ``git archive``) to the tail
section: B2's, B5a's and B5b's outputs against this build's, bit for bit,
and their times beside the others.

    python scripts/torch_kernel_ties.py [--kernel tail edge_bwd ...]
        [--baseline OTHER_CSRC_DIR]
"""
import argparse
import importlib.util
import json
import re
import shutil
import subprocess
import sys
import tempfile
from collections import Counter
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from immunostruct_tpu_torch.ops import _build, edge, mega  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "card_tests", ROOT / "tests" / "test_torch_port_cuda.py")
tc = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tc)

TIE_ULPS = (32, -1, 64)  # the first is the source's own
SEEDS = range(1, 9)
KERNELS = ("tail", "edge_bwd", "mega_fwd", "sass")
# each library's tensor-core kernel, whose registers and spills are shown
MMA_KERNEL = {"egnn_tail_bwd": "tail_bwd_mma_kernel",
              "egnn_tail_bwd_db": "tail_bwd_mma_kernel",
              "egnn_tail_bwd_nodes": "tail_bwd_mma_kernel",
              "egnn_edge_bwd": "egnn_edge_bwd_mma_kernel",
              "egnn_mega_fwd": "egnn_mega_fwd_mma_kernel"}
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
    the registers and spill stores of each library's tensor-core kernel."""
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


# ---------------------------------------------------------------- SASS

def sass():
    use(None)
    _build.build()
    for lib in sorted(_build.BUILD_DIR.glob("lib*.so")):
        dump = subprocess.run(["cuobjdump", "-sass", str(lib)],
                              capture_output=True, text=True).stdout
        ops = Counter(re.findall(r"\b(ATOMS\.[A-Z0-9.]+|ATOM\.[A-Z0-9.]+|"
                                 r"RED\.[A-Z0-9.]+|ATOMG\.[A-Z0-9.]+)", dump))
        print("sass:", json.dumps(dict(library=lib.name, atomics=ops)),
              flush=True)


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
            else:
                sass()
    finally:
        shutil.rmtree(root)
    print(cs.card_line())


if __name__ == "__main__":
    main()
