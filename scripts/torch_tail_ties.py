"""The near-tie recompute of the PyTorch port's tensor-core tail backward
(B2, B5a, B5b in immunostruct_tpu_torch/csrc/egnn_tail.cuh), read on the
card: for kTieUlps in VARIANTS, each built from a copy of csrc/ with that
constant, the bf16 card tests' statistics as ratios of their bounds (1.0 is
at the bound) on the tail tests' inputs, the entries of d_cat that differ
from the plain version on the B=8, E=100, F=64 input, and B2's and B5b's
times at B=128, E=2560, F=64 (CUDA events). It also reads the plain
version against itself with every H x H product summed exactly (float64,
rounded once to f32): how far the plain version's own summation order
moves the same bounds. --baseline adds a variant built with another
egnn_tail.cuh (an earlier form of the body, say), timed beside the others.

    python scripts/torch_tail_ties.py [--baseline OLD_egnn_tail.cuh]
"""
import argparse
import importlib.util
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from immunostruct_tpu_torch.ops import _build, mega  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "card_tests", ROOT / "tests" / "test_torch_port_cuda.py")
tc = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tc)

VARIANTS = (32, -1, 64)  # the first is the source's own
SOURCES = ("egnn_tail_bwd", "egnn_tail_bwd_db", "egnn_tail_bwd_nodes")
FNS = {"b2": (mega.tail_bwd, mega.tail_bwd_reference),
       "db": (mega.tail_bwd_db, mega.tail_bwd_db_reference),
       "nodes": (mega.tail_bwd_nodes, mega.tail_bwd_nodes_reference)}


def build_variant(name, text, root):
    d = root / name
    (d / "csrc").mkdir(parents=True)
    for f in [*_build.CSRC.glob("*.cu"), *_build.CSRC.glob("*.cuh")]:
        shutil.copy(f, d / "csrc" / f.name)
    (d / "csrc" / "egnn_tail.cuh").write_text(text)
    (d / "build").mkdir()
    return d


def with_ulps(ulps):
    text = (_build.CSRC / "egnn_tail.cuh").read_text()
    text, n = re.subn(r"(constexpr int kTieUlps = )-?\d+;",
                      rf"\g<1>{ulps};", text)
    assert n == 1
    return text


def use(d):
    _build.CSRC = d / "csrc"
    _build.BUILD_DIR = d / "build"
    _build.load_library.cache_clear()
    for lib in (mega._tail_lib, mega._tail_db_lib, mega._tail_nodes_lib):
        lib.cache_clear()


def ratios(out, ref, node=False):
    """{output: worst mean ratio over its rows}, and the worst max ratio,
    as the card tests' bf16 checks read them."""
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


def cases():
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, default=None)
    opts = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    root = Path(tempfile.mkdtemp(dir=_build.BUILD_DIR))
    texts = {f"kTieUlps={u}": with_ulps(u) for u in VARIANTS}
    if opts.baseline is not None:
        texts["baseline"] = opts.baseline.read_text()
    dirs = {n: build_variant(n, text, root) for n, text in texts.items()}
    nvcc, procs = _build._nvcc(), []
    for u, d in dirs.items():
        use(d)
        for src in SOURCES:
            procs.append((u, src, subprocess.Popen(
                [nvcc, *_build.NVCC_FLAGS, "-o", str(_build._lib_path(src)),
                 str(d / "csrc" / f"{src}.cu")], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    for u, src, p in procs:
        out, _ = p.communicate()
        assert p.returncode == 0, out[-3000:]
        mma = out.split("tail_bwd_mma_kernel")[-1]
        spill = re.search(r"(\d+) bytes spill stores", mma)
        regs = re.search(r"Used (\d+) registers", mma)
        print(f"{u} {src}: {regs.group(1)} registers, "
              f"{spill.group(1)} B spill stores", flush=True)
    inputs = cases()
    refs = {label: FNS[kind][1](*args) for label, kind, args in inputs}
    small = next(a for label, _, a in inputs if label == "B2 B=8 E=100 F=64")
    witness = exact_products_reference(*small)
    print(json.dumps({"plain_exact_products_vs_plain B2 B=8 E=100 F=64":
                      ratios(witness, refs["B2 B=8 E=100 F=64"]),
                      "differing": len(differing(
                          witness, refs["B2 B=8 E=100 F=64"]))}), flush=True)
    t_in = cs.tail_g_inputs(2560, 64, torch.bfloat16, seed=7)
    t_b2 = cs.b2_operands(*t_in)
    for u, d in dirs.items():
        use(d)
        res = {}
        for label, kind, args in inputs:
            got = FNS[kind][0](*args)
            torch.cuda.synchronize()
            res[label] = ratios(got, refs[label], node=kind == "nodes")
            if label == "B2 B=8 E=100 F=64":
                diffs = differing(got, refs[label])
        print(json.dumps({
            "variant": u,
            "worst_mean_ratio": max(max(v[0].values()) for v in res.values()),
            "worst_max_ratio": max(v[1] for v in res.values()),
            "differing_d_cat_B=8_E=100_F=64": diffs[:12],
            "n_differing": len(diffs)}), flush=True)
        for label, v in res.items():
            print("   ", u, label, max(v[0].values()), v[1], v[0], flush=True)
    # the times, the variants interleaved three times over
    times = {u: {"b2_ms": [], "b5b_ms": []} for u in dirs}
    for _ in range(3):
        for u, d in dirs.items():
            use(d)
            times[u]["b2_ms"].append(cs.cuda_ms(lambda: mega.tail_bwd(*t_b2)))
            times[u]["b5b_ms"].append(
                cs.cuda_ms(lambda: mega.tail_bwd_nodes(*t_in)))
    print(json.dumps({"bf16 B=128 E=2560 F=64": times}), flush=True)
    shutil.rmtree(root)
    print(cs.card_line())


if __name__ == "__main__":
    main()
