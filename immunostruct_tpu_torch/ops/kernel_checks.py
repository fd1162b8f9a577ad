"""The bf16 checks of the port's hand-written kernels against their plain
PyTorch versions, the seeded inputs they run on, and the rule that reads
them. The card tests (tests/test_torch_port_cuda.py), the readings script
(scripts/torch_kernel_ties.py) and chip_smoke.py call these definitions.

Each kernel and its plain version round at the same points, so in bf16 they
differ only where another f32 order flips a rounding. A check is a
statistic of |kernel - plain| in each of its units (a row, column, tensor or
element, as the check is) held to a bound in that unit. The rule reads every
unit u against the plain version run on the CPU on the same operands (its
f32 sums in another order: the reference's own spread, measured on that
input in the same run):

    stat_u(kernel - plain) <= bound_u                       (1)

where the CPU's plain version meets the bound in u, and

    stat_u(kernel - plain) <= bound_u + 2 * stat_u(cpu - plain)   (2)

where it does not. A unit held by (2) is "restated"; no bound is looser in a
unit where the CPU's plain version meets it. Without a CPU reading every
unit is held by (1), the bound as the card tests have always held it; since
(2) is never tighter than (1), a kernel that meets (1) everywhere meets the
rule, and ``yardstick="failing"`` runs the CPU only on inputs that fail (1).

The sweep: ``cases(kernel)`` lists each card test's bf16 input shapes at the
test's own seed and at ``SEEDS`` (1..8); ``sweep(kernel)`` runs the kernel,
its plain version on the card and, per ``yardstick``, on the CPU, and
judges every input by the rule.
"""
import copy
import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from immunostruct_tpu_torch.ops import edge, fused_layer, mega, segment, stack
from immunostruct_tpu_torch.ops.egnn import EGNNLayer, egnn_stack

N = 288
HID = 64
SEEDS = tuple(range(1, 9))
BF = torch.bfloat16
# the bounds (tests/test_torch_port_cuda.py's docstring says why each)
COL_MAX, COL_MEAN = 4e-3, 1e-4          # B1, B4: per output column
EDGE_MEAN, EDGE_MAX = 2e-5, 1.6e-2      # B2-B5, B3: per row of the edge outputs
GRAD_MAX = 1e-3                         # their weight gradients (mean: EDGE_MEAN)
NODE_COL_MEAN = 1e-4                    # B6, B7: per column of h, x, agg
STEP_FLOOR = 2.0 ** -10                 # the elementwise rule's floor
TINY = torch.finfo(torch.float32).tiny
SMOKE_B1_SEED = 2560 + 6   # chip_smoke.py's B6 row at B=1, E=2560
KERNELS = ("B1", "B4", "B3 fwd", "B3 bwd", "B2", "B5a", "B5b", "B6", "B7",
           "B8 scatter", "B8 gather")


# --------------------------------------------------------------- inputs

def mega_args(b, e, f, hid, dtype, device, seed, mask_rate=0.1):
    """B1's operands: seeded indices with self-loops and 10% masked edges,
    ef, h, x and a seeded layer's packed weights."""
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


def tail_args(b, e, f, dtype, device, seed, mask_rate=0.1):
    """B2's operands: residuals from B1 on seeded inputs, and the cotangent
    of a seeded g gathered at dst (zero on skipped edges)."""
    args = mega_args(b, e, f, HID, dtype, device, seed, mask_rate)
    src, dst, mask, ef = args[:4]
    _, a1, xd = mega.edge_mega_fwd(*args)
    valid = mega.valid_edges(src, dst, mask, N)
    g = torch.randn(b, N, 67, generator=torch.Generator().manual_seed(seed))
    d = torch.where(valid, dst, 0).long()[..., None].expand(-1, -1, 67)
    d_both = torch.gather(g.to(device, dtype), 1, d)
    d_both = torch.where(valid[..., None], d_both, 0.0)
    return (ef, *args[7:], a1, xd, d_both.transpose(1, 2).contiguous(),
            valid)


def tail_g_args(b, e, f, dtype, device, seed, mask_rate=0.1):
    """B5's operands: B1's residuals on seeded inputs with indices at -1 and
    N, and a seeded node cotangent g [B, N, H+3] in the compute dtype:
    (src, dst, valid, ef, w2, wc1, small, a1, xd, g)."""
    args = mega_args(b, e, f, HID, dtype, "cpu", seed, mask_rate)
    args[0][:, 8:12] = -1
    args[1][:, 12:16] = N
    args = [t.to(device) for t in args]
    src, dst, mask, ef = args[:4]
    _, a1, xd = mega.edge_mega_fwd(*args)
    g = torch.randn(b, N, 67, generator=torch.Generator().manual_seed(seed))
    return (src, dst, mega.valid_edges(src, dst, mask, N), ef, *args[7:],
            a1, xd, g.to(device, dtype))


def b2_of(src, dst, valid, ef, w2, wc1, small, a1, xd, g):
    """B2's operands from B5's: d_both = g[dst] gathered by PyTorch."""
    d_both = mega._gather_rows(g, dst, valid).transpose(1, 2).contiguous()
    return ef, w2, wc1, small, a1, xd, d_both, valid


def edge_args(b, e, f, dtype, device, seed, mask_rate=0.1, tail=0):
    """B3's operands as the 'fused' path builds them: [h ++ x] bundles
    gathered by src and dst, zeros for a masked edge (and for the last
    ``tail`` edges), and a seeded cotangent of the output."""
    src, dst, mask, ef, h, x, w1ab, w2, wc1, small = mega_args(
        b, e, f, HID, dtype, device, seed, mask_rate)
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


def paired_args(b, e, f, dtype, device, seed, mask_rate=0.1):
    """B1's operands on a mirror-paired batch (edge k + E/2 the reverse of
    edge k, masks mirrored), with arcs at index -1 and N, masked and not."""
    args = mega_args(b, e, f, HID, dtype, "cpu", seed, mask_rate)
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


def scrambled_mirror_half(args, seed):
    """A paired batch whose second half's indices and mask are replaced by
    seeded ones in [0, N): what B4 never reads (it computes on the mirror
    the arc half implies, ``mega.mirror_edges``)."""
    args = list(args)
    b, e = args[0].shape
    half = e // 2
    gen = torch.Generator().manual_seed(seed)
    for i in (0, 1):
        args[i] = args[i].clone()
        args[i][:, half:] = torch.randint(0, N, (b, half), generator=gen,
                                          dtype=torch.int32).to(args[i].device)
    args[2] = args[2].clone()
    args[2][:, half:] = (torch.rand(b, half, generator=gen) >= 0.5).to(
        args[2].device)
    return args


def stack_args(b, e, dtype, device, seed, mask_rate=0.1):
    """B6's operands: HybridModelv2's conv stack (F0=20, H=64, six layers)
    with seeded weights, and seeded inputs with 10% of the edges masked and
    indices at -1 and N."""
    src, dst, mask, ef, h, x = mega_args(b, e, 20, HID, dtype, "cpu", seed,
                                         mask_rate)[:6]
    src[:, 8:12] = -1
    dst[:, 12:16] = N
    gen = torch.Generator().manual_seed(seed)
    layers = egnn_stack(5, 20, HID, generator=gen, device=device)
    packed = [tuple(t.detach() for t in stack.pack_layer(p)) for p in layers]
    return [t.to(device) for t in (src, dst, mask, ef, h, x)], packed


def b7_args(b, e, f, dtype, device, seed, x_dtype=None, mask_rate=0.1,
            x_scale=1.0):
    """B7's operands: a seeded EGNN layer (H=64) and seeded inputs with 10%
    of the edges masked, self-loops and unmasked edges whose src or dst is
    -1 or N; the coordinates times ``x_scale``."""
    src, dst, mask, _, h, x = mega_args(b, e, f, HID, torch.float32, "cpu",
                                        seed, mask_rate)[:6]
    src[:, 8:10], src[:, 10:12] = -1, N
    dst[:, 12:14], dst[:, 14:16] = -1, N
    mask[:, 8:16] = True
    layer = EGNNLayer(f, HID, HID,
                      generator=torch.Generator().manual_seed(seed),
                      device=device)
    return layer, [h.to(device, dtype),
                   (x * x_scale).to(device, x_dtype or dtype),
                   src.to(device), dst.to(device), mask.to(device)]


def segment_args(b, e, n, c, dtype, device, seed, mask_rate=0.1):
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


def corpus_layout(idx, mask, real):
    """The corpus's padding: edges from ``real`` on node 0, masked."""
    idx, mask = idx.clone(), mask.clone()
    idx[:, real:], mask[:, real:] = 0, False
    return idx, mask


# --------------------------------------------------------------- checks

@dataclass
class Check:
    """One check: per unit, the kernel's statistic ``got`` against
    ``bound``, and the CPU plain version's statistic ``cpu`` against
    ``cpu_bound`` (the bound as the CPU's own values set it; ``bound`` where
    it does not depend on the values checked). ``cpu`` None: no reading."""
    name: str
    got: torch.Tensor
    bound: torch.Tensor
    cpu: Optional[torch.Tensor] = None
    cpu_bound: Optional[torch.Tensor] = None
    shape: tuple = ()           # the units' shape (failing units name it)
    restatable: bool = True     # False: an exact check, never restated


def _units(t):
    return t.reshape(-1).float()


def _check(name, stat, g, r, c, bound_of, shape=None):
    """A check of ``stat`` (a unit-wise statistic of a difference) with the
    bound ``bound_of(values)`` (values: the kernel's or the CPU's)."""
    got = stat((g - r).abs())
    cpu = None if c is None else stat((c - r).abs())
    return Check(name, _units(got), _units(bound_of(g)),
                 None if c is None else _units(cpu),
                 None if c is None else _units(bound_of(c)),
                 tuple(got.shape) if shape is None else shape)


def rows_checks(name, g, r, c, mean_tol, max_tol):
    """Rows [R, M] (float): per row mean|diff| <= mean_tol * mean|plain| and,
    unless max_tol is None, max|diff| <= max_tol * max|plain|."""
    mag_mean, mag_max = r.abs().mean(1), r.abs().amax(1)
    out = [_check(f"{name} mean", lambda d: d.mean(1), g, r, c,
                  lambda _: mean_tol * mag_mean)]
    if max_tol is not None:
        out.append(_check(f"{name} max", lambda d: d.amax(1), g, r, c,
                          lambda _: max_tol * mag_max))
    return out


def step_of(mag):
    """One bf16 step at |value| ``mag``."""
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def col_steps_checks(name, g, r, c, mean_tol=NODE_COL_MEAN):
    """Columns of [B, N, C] (B6's aggregate, B7's h' and x'): per column
    max|diff| <= one bf16 step at the column's largest |plain|, mean|diff|
    <= mean_tol * mean|plain|."""
    g, r = g.float().flatten(0, 1).T, r.float().flatten(0, 1).T
    c = None if c is None else c.float().flatten(0, 1).T
    top = step_of(r.abs().amax(1).clamp_min(TINY))
    return [_check(f"{name} max", lambda d: d.amax(1), g, r, c,
                   lambda _: top),
            *rows_checks(name, g, r, c, mean_tol, None)]


def elem_steps_check(name, g, r, c, floor=STEP_FLOOR):
    """Every element within one bf16 step at max(|value|, |plain|), or at
    ``floor`` below that (B1's residual rule, B8's bf16 scatter). Each
    element is a unit: its |diff| in those steps, at most 1, restated only
    where the CPU's plain version is itself more than a step off in that
    element."""
    r = r.float()
    floor = torch.tensor(floor, device=r.device)

    def steps(v):
        v = v.float()
        step = step_of(torch.maximum(torch.maximum(v.abs(), r.abs()), floor))
        return ((v - r).abs() / step).reshape(-1)
    got = steps(g)
    one = torch.ones(1, device=r.device).expand_as(got)
    return Check(f"{name} steps", got, one,
                 None if c is None else steps(c),
                 None if c is None else one, tuple(r.shape))


def nearness_check(name, k, r, u, c):
    """dbc1: mean|kernel - plain| <= mean|kernel - the sum of d_p3
    unrounded| (a kernel that leaves d_p3's rounding out sits at u)."""
    def mean_dist(a, b):
        return (a - b).abs().mean().reshape(1)
    return Check(name, mean_dist(k, r), mean_dist(k, u),
                 None if c is None else mean_dist(c, r),
                 None if c is None else mean_dist(c, u), (1,))


def exact_check(name, g, want):
    """Bit for bit: the largest |diff| must be 0; never restated."""
    d = (g.float() - want.float()).abs().amax().reshape(1)
    return Check(name, d, torch.zeros_like(d), shape=(1,), restatable=False)


def mega_checks(name, out, ref, cpu=None):
    """B1's (B4's) aggregate [B, N, H+3] f32 per column: max <= COL_MAX *
    max|plain|, mean <= COL_MEAN * mean|plain|."""
    def cols(t):
        return None if t is None else t.flatten(0, 1).T
    return rows_checks(name, cols(out), cols(ref), cols(cpu), COL_MEAN,
                       COL_MAX)


def residual_checks(got, ref, cpu=None, names=("a1", "xd")):
    cpu = cpu or (None,) * len(got)
    return [elem_steps_check(n, g, r, c)
            for n, g, r, c in zip(names, got, ref, cpu)]


def edge_rows(t):
    """[B, C, E] -> [C, B*E]: one row per channel."""
    return None if t is None else t.float().transpose(0, 1).flatten(1)


def _one_row(t):
    return None if t is None else t.float().flatten()[None]


EDGE_NAMES = ("dhsx", "dhdx", "def", "dw1ab", "dw2", "dwc1", "dsmall")
TAIL_NAMES = ("d_cat", "d_ef", "dw2", "dwc1", "dsmall")


def edge_checks(out, ref, cpu=None, grad_mean=EDGE_MEAN, names=None):
    """B3 (forward: its output alone; backward: its seven outputs): per row
    of the [B, C, E] outputs mean <= EDGE_MEAN, max <= EDGE_MAX; each
    weight gradient one row, mean <= grad_mean, max <= GRAD_MAX."""
    out = out if isinstance(out, tuple) else (out,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    cpu = (cpu if isinstance(cpu, tuple) else (cpu,)) if cpu is not None \
        else (None,) * len(out)
    names = names or (("out",) if len(out) == 1 else EDGE_NAMES)
    checks = []
    for name, g, r, c in zip(names, out, ref, cpu):
        if g is None:
            continue
        if g.dim() == 3:
            checks += rows_checks(name, edge_rows(g), edge_rows(r),
                                  edge_rows(c), EDGE_MEAN, EDGE_MAX)
        else:
            checks += rows_checks(name, _one_row(g), _one_row(r),
                                  _one_row(c), grad_mean, GRAD_MAX)
    return checks


def tail_checks(out, ref, cpu=None):
    """B2, B5a (d_cat, d_ef, dw2, dwc1, dsmall), and B5b's last four with
    d_cat None: B3's bounds on the same rows."""
    return edge_checks(tuple(out), tuple(ref),
                       None if cpu is None else tuple(cpu),
                       names=TAIL_NAMES)


def nodes_checks(got, ref, cpu=None):
    """B5b's node sums d_nodes [B, N, 2(H+3)] f32 per column: the d_cat
    bounds (EDGE_MEAN, EDGE_MAX)."""
    def cols(t):
        return None if t is None else t.flatten(0, 1).T
    return rows_checks("d_nodes", cols(got), cols(ref), cols(cpu), EDGE_MEAN,
                       EDGE_MAX)


def dbc1_check(args, dout, out, ref, cpu=None):
    """B3's backward: dbc1 (dsmall's bc1 column, the sum of the rounded d_p3
    over the edges) nearer the plain version's than the same sum of d_p3
    unrounded (``edge.d_p3_unrounded_sum``): the bound on dsmall's row does
    not see that rounding."""
    return nearness_check(
        "dbc1", out[6][:, edge.BC1], ref[6][:, edge.BC1],
        edge.d_p3_unrounded_sum(*args, dout),
        None if cpu is None else cpu[6][:, edge.BC1])


def edge_bwd_checks(args, dout, out, ref, cpu=None, grad_mean=EDGE_MEAN):
    """B3's backward: ``edge_checks`` and ``dbc1_check``."""
    return edge_checks(out, ref, cpu, grad_mean) + [
        dbc1_check(args, dout, out, ref, cpu)]


def tail_all_checks(out, ref, b2_args=None, cpu=None, nodes=False):
    """B2 and B5a (``nodes``: B5b, d_nodes first) against their plain
    versions; given B2's operands ``b2_args``, also dbc1 as B3's
    (``mega.tail_d_p3_unrounded_sum``)."""
    cpu = cpu or (None,) * len(out)
    if nodes:
        checks = (nodes_checks(out[0], ref[0], cpu[0])
                  + tail_checks((None, *out[1:]), (None, *ref[1:]),
                                (None, *cpu[1:])))
    else:
        checks = tail_checks(out, ref, cpu)
    if b2_args is not None:
        checks.append(nearness_check(
            "dbc1", out[4][:, mega.BC1], ref[4][:, mega.BC1],
            mega.tail_d_p3_unrounded_sum(*b2_args),
            None if cpu[4] is None else cpu[4][:, mega.BC1]))
    return checks


def b7_checks(out, ref, cpu=None):
    """B7's h' and x' per column (``col_steps_checks``)."""
    cpu = cpu or (None, None)
    return (col_steps_checks("h", out[0], ref[0], cpu[0])
            + col_steps_checks("x", out[1], ref[1], cpu[1]))


# --------------------------------------------------------------- the rule

def judge(checks) -> dict:
    """The rule (module docstring) over every unit of ``checks``: ``ok``
    (every unit within it), ``within_bound`` (every unit within its bound,
    the CPU aside), the worst unit's ratio to what the rule allows it and
    to its bound, the CPU's worst ratio to its bound, the units restated,
    the units past their bound (check, unit index, the kernel's ratio to
    the bound, the CPU's, restated?) and the failing units (check, unit
    index, ratio to what the rule allows)."""
    ok = within = True
    worst = worst_bound = 0.0
    cpu_worst, restated, failing, over_bound = None, 0, [], []
    for ch in checks:
        allowed, over, q = ch.bound, None, None
        if ch.cpu is not None and ch.restatable:
            over = ch.cpu > ch.cpu_bound
            allowed = torch.where(over, ch.bound + 2 * ch.cpu, ch.bound)
            q = ch.cpu / ch.cpu_bound.clamp_min(TINY)
            cpu_worst = max(cpu_worst or 0.0, q.max().item())
        ratio = _ratio(ch.got, allowed)
        to_bound = _ratio(ch.got, ch.bound)
        worst = max(worst, ratio.max().item())
        worst_bound = max(worst_bound, to_bound.max().item())
        past = ch.got > ch.bound
        if bool(past.any()):
            within = False
            if over is not None:
                restated += int((over & past).sum())
            for i in past.nonzero().flatten()[:4].tolist():
                over_bound.append((ch.name, _unit(ch, i),
                                   round(to_bound[i].item(), 4),
                                   None if q is None else round(q[i].item(), 4),
                                   over is not None and bool(over[i])))
        bad = ch.got > allowed
        if bool(bad.any()):
            ok = False
            for i in bad.nonzero().flatten()[:4].tolist():
                failing.append((ch.name, _unit(ch, i),
                                round(ratio[i].item(), 4)))
    return dict(ok=ok, within_bound=within, worst=worst,
                worst_vs_bound=worst_bound, cpu_worst=cpu_worst,
                restated=restated, over_bound=over_bound, failing=failing)


def _ratio(got, allowed):
    return torch.where(got > 0, got / allowed.clamp_min(TINY),
                       torch.zeros_like(got))


def _unit(ch, i):
    return ([int(u) for u in torch.unravel_index(torch.tensor(i), ch.shape)]
            if ch.shape else [i])


def assert_rule(checks, what: str = "") -> dict:
    """Raises AssertionError naming the failing units."""
    v = judge(checks)
    assert v["ok"], f"{what} fails the rule: {v['failing']}"
    return v


# --------------------------------------------------------------- the sweep

@dataclass
class Case:
    kernel: str
    label: str
    seed: int
    own: bool                           # the card test's own seed
    shape: dict


def _seeds(own):
    return [own, *(s for s in SEEDS if s != own)]


EDGE_SHAPES = ((8, 100, 0), (8, 256, 56), (8, 2560, 0), (26, 1280, 0),
               (51, 1280, 0))
# B8: test_segment_kernels_match_plain_versions' shapes, the grids'
# (test_segment_kernels_on_their_grids) and the corpus layout's
SEGMENT_SHAPES = ((4, 256, 24, 16), (4, 1000, 40, 67), (128, 2560, N, 67),
                  (128, 1408, N, 67))
SEGMENT_GRIDS = ((1, 2560, N, 67), (25, 1280, N, 67), (200, 2560, N, 67),
                 (25, 128, N, 3), (8, 1283, N, 67), (25, 1280, N, 1),
                 (25, 1280, N, 128), (8, 128, 1, 67), (2, 128, 2048, 8))


def _shapes(kernel):
    """(shape, the test's own seed) of each card test input of ``kernel``."""
    if kernel == "B1":      # test_kernel_matches_plain_version, grid edges
        return ([(dict(b=8, e=e, f=f), e + f) for e in (2560, 1408, 100)
                 for f in (20, 64)]
                + [(dict(b=b, e=e, f=64, masked=b > 1), b + e)
                   for b in (1, 200) for e in (2560, 1000)])
    if kernel == "B4":      # matches, grid edges, reads only the arc half
        return ([(dict(b=128, e=e, f=f), e + f + 2) for e in (2560, 1408)
                 for f in (20, 64)]
                + [(dict(b=b, e=e, f=64, masked=b > 1), b + e + 3)
                   for b in (1, 200) for e in (2560, 1000)]
                + [(dict(b=8, e=2560, f=20, scrambled=True), 41)])
    if kernel in ("B3 fwd", "B3 bwd"):
        out = [(dict(b=b, e=e, tail=t, f=f), e + f)
               for b, e, t in EDGE_SHAPES for f in (20, 64)]
        if kernel == "B3 fwd":  # grid edges; chip_smoke.py's B=128
            out += [(dict(b=b, e=e, tail=0, f=64, zeroed=b > 1), b + e + 5)
                    for b in (1, 200) for e in (2560, 1000)]
            return out + [(dict(b=128, e=e, tail=0, f=f), e + f + 2)
                          for e in (2560, 1408) for f in (20, 64)]
        return out + [(dict(b=128, e=2560, tail=0, f=f), 2582)
                      for f in (20, 64)]
    if kernel == "B2":      # matches; grid edges
        return ([(dict(b=8, e=e, f=f), e + f + 1) for e in (2560, 1408, 100)
                 for f in (20, 64)]
                + [(dict(b=b, e=e, f=20, masked=b > 1, grid=True), b + e)
                   for b in (1, 200) for e in (2560, 1000)])
    if kernel in ("B5a", "B5b"):
        k = 3 if kernel == "B5a" else 4
        return ([(dict(b=128, e=e, f=f), e + f + k) for e in (2560, 1408)
                 for f in (20, 64)]
                + [(dict(b=b, e=e, f=20, masked=b > 1), b + e)
                   for b in (1, 200) for e in (2560, 1000)])
    if kernel == "B6":      # matches, mutants' inputs, grid edges, repeat;
        # chip_smoke.py's B=1 row (its seed e + 6), which failed the rule
        # before B1's body recomputed its near-tie roundings and the plain
        # version summed in the kernels' order
        return ([(dict(b=128, e=e), e + 6) for e in (2560, 1408)]
                + [(dict(b=8, e=e), e + 8) for e in (2560, 1408)]
                + [(dict(b=1, e=2560), 42)]
                + [(dict(b=b, e=e, masked=True, seeds=False), b + e + 46)
                   for b in (1, 200) for e in (2560, 1000)]
                + [(dict(b=b, e=2560, seeds=False), b + 41) for b in (8, 128)]
                + [(dict(b=1, e=2560, smoke=True, seeds=False), SMOKE_B1_SEED)])
    if kernel == "B7":      # matches; grid edges; repeat; mutants' inputs
        return ([(dict(b=128, e=e, f=f), e + f + 7) for e in (2560, 1408, 256)
                 for f in (20, 64)]
                + [(dict(b=b, e=e, f=64, x32=x32, masked=True, seeds=False),
                    b + e + 47) for b in (1, 200) for e in (2560, 1024)
                   for x32 in (False, True)]
                + [(dict(b=b, e=2560, f=64, seeds=False), b + 42)
                   for b in (1, 8, 128)]
                + [(dict(b=32, e=e, f=f, x32=x32, scale=s, seeds=False), e + f)
                   for e, f in ((2560, 20), (1408, 64))
                   for x32, s in ((False, 1.0), (True, 1.0), (False, 1 / 16))])
    if kernel in ("B8 scatter", "B8 gather"):
        return ([(dict(b=b, e=e, n=n, c=c), e + c)
                 for b, e, n, c in SEGMENT_SHAPES]
                + [(dict(b=b, e=e, n=n, c=c, grid=True), b + e + c)
                   for b, e, n, c in SEGMENT_GRIDS]
                + [(dict(b=128, e=2560, n=N, c=67, corpus=1408), 9)])
    raise ValueError(f"unknown kernel {kernel!r}; one of {KERNELS}")


def cases(kernel):
    """Every card test input of ``kernel`` in bf16: each at the test's own
    seed and at SEEDS (shapes marked ``seeds=False``, the mutants' and the
    repeat tests' extra inputs, at their own seed alone)."""
    out = []
    for shape, own in _shapes(kernel):
        seeds = _seeds(own) if shape.pop("seeds", True) else [own]
        label = " ".join(f"{k}={v}" for k, v in shape.items())
        out += [Case(kernel, f"{kernel} {label} seed={s}", s, s == own,
                     dict(shape)) for s in seeds]
    return out


def on(device, x):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, (list, tuple)):
        return type(x)(on(device, t) for t in x)
    return x


def _cpu_layer(layer):
    return copy.deepcopy(layer).cpu()


def _layer_inputs(out, args, layer):
    h0, x0 = args[4:6]
    hs, xs = out[2:4]
    return ((h0, x0) if layer == 0
            else (hs[:, layer - 1], xs[:, layer - 1]))


def stack_cpu_refs(out, args, packed):
    """B6's plain version of each layer run on the CPU from the kernel's
    own previous h and x: per layer (hs, xs, aggs, a1s, xds) on the card."""
    src, dst, mask, ef = args[:4]
    refs = []
    for layer, weights in enumerate(packed):
        ref = stack.stack_fwd_reference(
            *on("cpu", (src, dst, mask, ef, *_layer_inputs(out, args, layer))),
            [on("cpu", weights)])
        refs.append([t[:, 0].to(src.device) for t in ref[2:]])
    return refs


def stack_checks(out, args, packed, cpu=None):
    """B6, each layer against the plain version of that layer run from the
    kernel's own previous h and x; ``cpu``: ``stack_cpu_refs``' readings
    (True: take them here)."""
    h, x, hs, xs, aggs, a1s, xds = out
    src, dst, mask, ef = args[:4]
    if cpu is True:
        cpu = stack_cpu_refs(out, args, packed)
    checks = [exact_check("h = hs[-1]", h, hs[:, -1]),
              exact_check("x = xs[-1]", x, xs[:, -1])]
    for layer, weights in enumerate(packed):
        ref = stack.stack_fwd_reference(src, dst, mask, ef,
                                        *_layer_inputs(out, args, layer),
                                        [weights])
        want = [t[:, 0] for t in ref[2:]]
        c = [None] * 5 if cpu is None else cpu[layer]
        got = [t[:, layer] for t in (hs, xs, aggs, a1s, xds)]
        tag = f"layer {layer} "
        checks += residual_checks(got[3:], want[3:], c[3:],
                                  (tag + "a1", tag + "xd"))
        checks += col_steps_checks(tag + "agg", got[2], want[2], c[2])
        for name, g, w, ci in zip(("h", "x"), got[:2], want[:2], c[:2]):
            cols = [None if t is None else t.float().flatten(0, 1).T
                    for t in (g, w, ci)]
            checks += rows_checks(tag + name, *cols, NODE_COL_MEAN, None)
    return checks


def run_case(case: Case, device, yardstick: str = "all",
             cpu_cache: Optional[dict] = None) -> dict:
    """One input of ``case.kernel``: the kernel, its plain version on
    ``device`` and (per ``yardstick``: "all", "failing" or "none") on the
    CPU, judged by the rule. ``cpu_cache`` ({label: the CPU's outputs})
    keeps the CPU's outputs for another build of the kernels."""
    s = case.shape
    b, e = s["b"], s["e"]
    k = case.kernel
    exact = []
    if k in ("B1", "B4"):
        if k == "B1":
            args = mega_args(b, e, s["f"], HID, BF, device, case.seed)
        else:
            args = paired_args(b, e, s["f"], BF, device, case.seed)
        if s.get("masked"):
            args[2] = args[2].clone()
            args[2][-1] = False
        if s.get("scrambled"):
            args = scrambled_mirror_half(args, seed=case.seed + 1)
        if k == "B1":
            plain = mega.edge_mega_fwd_reference
            out, a1, xd = mega.edge_mega_fwd(*args)
            bare = mega.edge_mega(*args)
        else:
            plain = mega.edge_mega_paired_fwd_reference
            out, a1, xd = mega.edge_mega_paired_fwd(*args)
            bare = mega.edge_mega_paired_fwd(*args, residuals=False)[0]
            _, a1_b1, xd_b1 = mega.edge_mega_fwd(
                *mega.mirror_edges(*args[:3]), *args[3:])
            exact = [exact_check("a1 = B1's", a1, a1_b1),
                     exact_check("xd = B1's", xd, xd_b1)]
        ref = plain(*args)

        def checks(c):
            c = c or (None, None, None)
            return (mega_checks("out", out, ref[0], c[0])
                    + mega_checks("bare", bare, ref[0], c[0])
                    + residual_checks((a1, xd), ref[1:], c[1:]) + exact)
        cpu = lambda: plain(*on("cpu", args))      # noqa: E731
    elif k == "B3 fwd":
        args, _ = edge_args(b, e, s["f"], BF, device, case.seed,
                            tail=s["tail"])
        if s.get("zeroed"):
            for t in args[:2]:
                t[-1] = 0
        out = edge.edge_program_fwd(*args)
        ref = edge.edge_program_reference(*args)

        def checks(c):
            return edge_checks(out, ref, c)
        cpu = lambda: edge.edge_program_reference(*on("cpu", args))  # noqa
    elif k == "B3 bwd":
        args, dout = edge_args(b, e, s["f"], BF, device, case.seed,
                               tail=s["tail"])
        out = edge.edge_program_bwd(*args, dout)
        ref = edge.edge_program_bwd_reference(*args, dout)

        def checks(c):
            return edge_bwd_checks(args, dout, out, ref, c)
        cpu = lambda: edge.edge_program_bwd_reference(  # noqa: E731
            *on("cpu", args), dout.cpu())
    elif k in ("B2", "B5a", "B5b"):
        if k == "B2" and not s.get("grid"):
            b2 = tail_args(b, e, s["f"], BF, device, case.seed)
            g = None
        else:
            g = list(tail_g_args(b, e, s["f"], BF, device, case.seed))
            if s.get("masked"):
                g[2] = g[2].clone()
                g[2][-1] = False
            b2 = b2_of(*g)
        fn, plain, operands = {
            "B2": (mega.tail_bwd, mega.tail_bwd_reference, b2),
            "B5a": (mega.tail_bwd_db, mega.tail_bwd_db_reference,
                    None if g is None else (g[1], *g[2:])),
            "B5b": (mega.tail_bwd_nodes, mega.tail_bwd_nodes_reference,
                    None if g is None else tuple(g))}[k]
        out = fn(*operands)
        ref = plain(*operands)
        if k == "B5a":
            exact = [exact_check(f"{n} = B2's", x, y) for n, x, y in
                     zip(TAIL_NAMES, out, mega.tail_bwd(*b2))]

        def checks(c):
            return tail_all_checks(out, ref, b2, c, nodes=k == "B5b") + exact
        cpu = lambda: plain(*on("cpu", operands))     # noqa: E731
    elif k == "B6":
        args, packed = stack_args(b, e, BF, device, case.seed)
        if s.get("masked"):
            args[2][-1] = False
        out = stack.stack_fwd(*args, packed)

        def checks(c):
            return stack_checks(out, args, packed, c)
        cpu = lambda: stack_cpu_refs(out, args, packed)  # noqa: E731
    elif k == "B7":
        layer, args = b7_args(b, e, s["f"], BF, device, case.seed,
                              x_dtype=torch.float32 if s.get("x32") else None,
                              x_scale=s.get("scale", 1.0))
        if s.get("masked"):
            args[4][-1] = False
        with torch.no_grad():
            out = fused_layer.fused_egnn_layer(layer, *args)
            ref = fused_layer.fused_egnn_layer_reference(layer, *args)

        def checks(c):
            return b7_checks(out, ref, c)

        def cpu():
            with torch.no_grad():
                return fused_layer.fused_egnn_layer_reference(
                    _cpu_layer(layer), *on("cpu", args))
    elif k in ("B8 scatter", "B8 gather"):
        n = s["n"]
        idx, mask, m, h = segment_args(b, e, n, s["c"], BF, device,
                                       case.seed)
        if s.get("grid"):
            mask[0] = False
            idx[-1:], mask[-1:] = corpus_layout(idx[-1:], mask[-1:],
                                                e - 2 * e // 5)
        if s.get("corpus"):
            idx, mask = corpus_layout(idx, mask, s["corpus"])
        if k == "B8 gather":
            out = segment.segment_gather(idx, mask, h)
            ref = segment.segment_gather_reference(idx, mask, h)

            def checks(c):
                return [exact_check("gather", out, ref)] + (
                    [] if c is None else [exact_check("gather = CPU's", out,
                                                      c)])
            cpu = lambda: segment.segment_gather_reference(  # noqa: E731
                *on("cpu", (idx, mask, h)))
        else:
            out = segment.segment_scatter(idx, mask, m, n)
            ref = segment.segment_scatter_reference(idx, mask, m, n)
            want = segment.segment_scatter_reference(
                *on("cpu", (idx, mask, m)), n).to(device)

            def checks(c):
                # bit for bit the CPU plain version (both sum in edge
                # order); within a step of the card's plain version, whose
                # atomics sum in another order (its spread: the CPU's)
                return [exact_check("scatter = CPU's", out, want),
                        elem_steps_check("scatter", out, ref, c)]
            cpu = lambda: want                          # noqa: E731
    else:
        raise ValueError(f"unknown kernel {k!r}")
    verdict = judge(checks(None))
    cpu_ran = yardstick == "all" or (yardstick == "failing"
                                     and not verdict["ok"])
    cpu_s = None
    if cpu_ran:
        t0 = time.perf_counter()
        if k == "B6":           # from the kernel's own h and x: no cache
            c = on(device, cpu())
        elif cpu_cache is not None and case.label in cpu_cache:
            c = cpu_cache[case.label]
        else:
            c = on(device, cpu())
            if cpu_cache is not None:
                cpu_cache[case.label] = c
        cpu_s = time.perf_counter() - t0
        verdict = judge(checks(c))
    return dict(kernel=k, input=case.label, seed=case.seed, own=case.own,
                cpu_ran=cpu_ran, cpu_s=cpu_s, **verdict)


def sweep(kernel, device="cuda", yardstick="all",
          report: Optional[Callable] = None,
          cpu_cache: Optional[dict] = None) -> tuple:
    """Every input of ``cases(kernel)`` judged by the rule: (the per-input
    results, the kernel's line: inputs, failing, over_bound (failing the
    bound alone), restated (inputs within the rule but past the bound),
    worst (ratio to what the rule allows), cpu_noise_worst (the CPU's
    worst ratio to the bound, over the inputs it ran on), cpu_runs)."""
    rows, t0 = [], time.perf_counter()
    for case in cases(kernel):
        r = run_case(case, torch.device(device), yardstick, cpu_cache)
        rows.append(r)
        if report is not None:
            report(r)
    cpu = [r["cpu_worst"] for r in rows if r["cpu_worst"] is not None]
    line = dict(sweep=kernel, inputs=len(rows),
                failing=sum(not r["ok"] for r in rows),
                over_bound=sum(not r["within_bound"] for r in rows),
                restated=sum(r["ok"] and not r["within_bound"] for r in rows),
                worst=max(r["worst"] for r in rows),
                worst_vs_bound=max(r["worst_vs_bound"] for r in rows),
                cpu_noise_worst=max(cpu) if cpu else None,
                cpu_runs=sum(r["cpu_ran"] for r in rows),
                cpu_s=sum(r["cpu_s"] or 0.0 for r in rows),
                wall_s=time.perf_counter() - t0,
                failing_inputs=[(r["input"], r["failing"]) for r in rows
                                if not r["ok"]])
    return rows, line
