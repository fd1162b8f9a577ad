"""The kernels' bf16 checks and the rule that reads them
(immunostruct_tpu_torch/ops/kernel_checks.py), on the CPU.

- The rule: a unit past its bound fails where the plain version run on the
  CPU meets the bound there; where the CPU does not, the unit is held to the
  bound plus twice the CPU's own statistic, and past that it fails; an
  exact check is never restated; with no CPU reading the rule is the bound.
- Without a CPU reading every check reads as the card tests' bounds always
  read (the formulas they replaced, on seeded perturbations).
- Every kernel's sweep runs on the CPU at a small shape (there the wrappers
  run the plain versions, so each input meets the rule at ratio 0), and
  ``cases`` holds every card test's own seed and 1..8, and chip_smoke.py's
  B6 row at B=1 as it draws it.
- A fault planted in B1's output (one column off by 1%) fails the rule
  through ``run_case``.
"""
import numpy as np
import pytest
import torch

from immunostruct_tpu_torch.ops import kernel_checks as kc
from immunostruct_tpu_torch.ops import mega
from tests.torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


def _check(got, bound, cpu=None, restatable=True):
    t = lambda v: torch.tensor([float(v)])          # noqa: E731
    return kc.Check("c", t(got), t(bound), None if cpu is None else t(cpu),
                    None if cpu is None else t(bound), (1,), restatable)


@pytest.mark.parametrize("got,cpu,ok,restated", [
    (0.5, 0.2, True, 0),        # within the bound
    (1.5, 0.5, False, 0),       # past it where the CPU meets it
    (1.5, 1.2, True, 1),        # restated: bound + 2 * 1.2
    (3.5, 1.2, False, 1),       # past the restated bound
    (1.5, None, False, 0),      # no CPU reading: the bound
    (1.0, None, True, 0),       # at the bound
])
def test_rule_reads_each_unit(got, cpu, ok, restated):
    v = kc.judge([_check(got, 1.0, cpu)])
    assert v["ok"] is ok and v["restated"] == restated
    assert v["within_bound"] is (got <= 1.0)


def test_rule_never_restates_an_exact_check():
    v = kc.judge([_check(1e-3, 0.0, cpu=5.0, restatable=False)])
    assert not v["ok"] and v["restated"] == 0


def test_rule_names_the_failing_unit():
    ch = kc.Check("col mean", torch.tensor([0.1, 3.0, 0.2]),
                  torch.ones(3), shape=(3,))
    v = kc.judge([ch])
    assert v["failing"] == [("col mean", [1], 3.0)]
    with pytest.raises(AssertionError, match="col mean"):
        kc.assert_rule([ch])


def test_step_rule_restates_only_the_elements_the_cpu_misses():
    """The one-step rule per element: where the CPU's plain version is 16
    steps off in one element, a kernel as far off there passes, and a
    kernel 2 steps off in an element where the CPU is exact fails."""
    r = torch.full((2, 3), 1.0)
    step = 2.0 ** -7
    cpu = r.clone()
    cpu[0, 1] += 16 * step
    g = cpu.clone()
    assert kc.judge([kc.elem_steps_check("a1", g, r, cpu)])["ok"]
    g[1, 2] += 2 * step
    v = kc.judge([kc.elem_steps_check("a1", g, r, cpu)])
    assert not v["ok"] and v["restated"] == 1
    assert v["failing"] == [("a1 steps", [1, 2], 2.0)]


def _seeded(shape, seed, scale):
    gen = torch.Generator().manual_seed(seed)
    ref = torch.randn(*shape, generator=gen)
    return ref + scale * torch.randn(*shape, generator=gen) * ref.abs(), ref


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("scale", [1e-5, 1e-4, 3e-3])
def test_checks_without_a_cpu_reading_are_the_old_bounds(seed, scale):
    """The formulas the card tests held before the rule (B1's columns,
    B3's rows, the one-step residual rule, B6/B7's columns) against the
    shared checks' verdict with no CPU reading."""
    out, ref = _seeded((3, 40, 7), seed, scale)
    d, m = (out - ref).abs().flatten(0, 1), ref.abs().flatten(0, 1)
    old = bool((d.amax(0) <= 4e-3 * m.amax(0)).all()
               and (d.mean(0) <= 1e-4 * m.mean(0)).all())
    assert kc.judge(kc.mega_checks("out", out, ref))["ok"] is old
    rows_o, rows_r = out.transpose(0, 1).flatten(1), ref.transpose(0, 1) \
        .flatten(1)
    d, m = (rows_o - rows_r).abs(), rows_r.abs()
    old = bool((d.amax(1) <= 1.6e-2 * m.amax(1)).all()
               and (d.mean(1) <= 2e-5 * m.mean(1)).all())
    assert kc.judge(kc.edge_checks(out, ref))["ok"] is old
    g, r = out.to(torch.bfloat16).float(), ref.to(torch.bfloat16).float()
    mag = torch.maximum(torch.maximum(g.abs(), r.abs()),
                        torch.tensor(2.0 ** -10))
    old = bool(((g - r).abs() <= torch.exp2(torch.floor(torch.log2(mag))
                                            - 7)).all())
    assert kc.judge([kc.elem_steps_check("a1", g, r, None)])["ok"] is old
    gf, rf = g.flatten(0, 1), r.flatten(0, 1)
    top = rf.abs().amax(0).clamp_min(torch.finfo(torch.float32).tiny)
    old = bool(((gf - rf).abs().amax(0)
                <= torch.exp2(torch.floor(torch.log2(top)) - 7)).all()
               and ((gf - rf).abs().mean(0) <= 1e-4 * rf.abs().mean(0)).all())
    assert kc.judge(kc.col_steps_checks("h", g, r, None))["ok"] is old


SMALL = {
    "B1": dict(b=2, e=128, f=20, masked=True),
    "B4": dict(b=2, e=128, f=20, scrambled=True),
    "B3 fwd": dict(b=2, e=128, tail=8, f=20, zeroed=True),
    "B3 bwd": dict(b=2, e=128, tail=0, f=20),
    "B2": dict(b=2, e=128, f=20),
    "B5a": dict(b=2, e=128, f=20, masked=True),
    "B5b": dict(b=2, e=128, f=20),
    "B6": dict(b=2, e=128),
    "B7": dict(b=2, e=128, f=20, x32=True),
    "B8 scatter": dict(b=2, e=128, n=24, c=8, grid=True),
    "B8 gather": dict(b=2, e=128, n=24, c=8, corpus=96),
}


@pytest.mark.parametrize("kernel", kc.KERNELS)
def test_every_kernel_meets_the_rule_on_the_cpu(kernel):
    """On the CPU each wrapper runs its plain version: every check of the
    kernel's sweep runs (the CPU yardstick too) and reads 0."""
    case = kc.Case(kernel, f"{kernel} small", 3, True, dict(SMALL[kernel]))
    r = kc.run_case(case, CPU, "all")
    assert r["ok"] and r["within_bound"] and r["cpu_ran"]
    assert r["worst"] == 0.0 and r["restated"] == 0


@pytest.mark.parametrize("kernel,inputs", [
    ("B1", 90), ("B4", 81), ("B3 fwd", 162), ("B3 bwd", 108), ("B2", 90),
    ("B5a", 72), ("B5b", 72), ("B6", 52), ("B7", 71), ("B8 scatter", 126),
    ("B8 gather", 126)])
def test_cases_hold_each_tests_seed_and_seeds_one_to_eight(kernel, inputs):
    cases = kc.cases(kernel)
    assert len(cases) == inputs
    assert len({c.label for c in cases}) == inputs
    by_shape = {}
    for c in cases:
        by_shape.setdefault(c.label.rsplit(" seed=", 1)[0], []).append(c)
    for shape, cs in by_shape.items():     # a shape may serve two tests
        own = [c.seed for c in cs if c.own]
        assert own, shape
        assert len(cs) == len(own) or set(kc.SEEDS) <= {c.seed for c in cs}, \
            shape


def test_cases_hold_chip_smokes_b6_row_at_b1():
    """chip_smoke.py's B6 row at B=1 (E=2560, seed E + 6) is a named case of
    B6's sweep, and stack_args draws it bit for bit as chip_smoke.py drew it
    before it took its inputs from stack_args (indices, mask, ef, h0, x0,
    then the six layers from a generator of the same seed)."""
    from immunostruct_tpu_torch.ops.egnn import egnn_stack
    from immunostruct_tpu_torch.ops.stack import pack_layer

    (case,) = [c for c in kc.cases("B6") if c.shape.get("smoke")]
    assert case.seed == kc.SMOKE_B1_SEED == 2566 and case.own
    assert (case.shape["b"], case.shape["e"]) == (1, 2560)
    assert case.label == "B6 b=1 e=2560 smoke=True seed=2566"
    args, packed = kc.stack_args(1, 2560, torch.bfloat16, CPU, case.seed)
    gen = torch.Generator().manual_seed(case.seed)
    src = torch.randint(0, kc.N, (1, 2560), generator=gen, dtype=torch.int32)
    dst = torch.randint(0, kc.N, (1, 2560), generator=gen, dtype=torch.int32)
    src[:, :8] = dst[:, :8]
    mask = torch.rand(1, 2560, generator=gen) >= 0.1
    ef = torch.randn(1, 2560, 1, generator=gen)
    h0 = torch.randn(1, kc.N, 20, generator=gen)
    x0 = torch.randn(1, kc.N, 3, generator=gen)
    src[:, 8:12] = -1
    dst[:, 12:16] = kc.N
    want = [src, dst, mask, *(t.to(torch.bfloat16) for t in (ef, h0, x0))]
    assert all(torch.equal(a, w) for a, w in zip(args, want))
    layers = egnn_stack(5, 20, kc.HID, generator=torch.Generator()
                        .manual_seed(case.seed))
    assert all(torch.equal(a, w) for p, layer in zip(packed, layers)
               for a, w in zip(p, pack_layer(layer)))


def test_a_fault_in_b1_fails_the_rule(monkeypatch):
    """B1's output with one column 1% off (what a kernel that drops a
    rounding point does to many entries): the rule fails it and names the
    column; the CPU's plain version (the yardstick) meets the bound."""
    real = mega.edge_mega_fwd

    def bent(*args, **kw):
        out, a1, xd = real(*args, **kw)
        out = out.clone()
        out[..., 5] *= 1.01
        return out, a1, xd
    monkeypatch.setattr(mega, "edge_mega_fwd", bent)
    case = kc.Case("B1", "B1 small", 3, True, dict(b=2, e=128, f=20))
    r = kc.run_case(case, CPU, "all")
    assert not r["ok"] and r["restated"] == 0
    assert ("out mean", [5], pytest.approx(r["failing"][0][2])) \
        == r["failing"][0]
    assert np.isclose(r["cpu_worst"], 0.0)
