"""The port's bf16 training step against the JAX package's, on the CPU.

The same JAX ``build_model`` weights (``jax.random.key(3)``, carried across
with ``save_checkpoint`` / ``load_jax_checkpoint``) and the same seeded
numpy batch (``test_torch_port_train.py``'s ``_arrays``: padded edges,
self-loops, B=8, N=16, E=128; the mirror-paired E=256 batch of
``test_torch_port_variants.py`` for ``mega_variant='paired'``) go through
both packages with ``compute_dtype`` bf16 and ``dropout_rate=0.0``. The VAE
noise is JAX's own draw, in bf16 as JAX draws it there
(``normal(k_eps, dtype=bfloat16)``), replayed into the port as ``eps``.
Models: StructureModel and HybridModelv2 at two EGNN layers of 16 (every
aggregation the CPU runs: 'scatter', 'onehot', 'onehot_remat', 'mega' with
each ``mega_variant``, 'fused', 'pallas'), and StructureModel at its full
width (six layers of 64) under 'scatter', 'mega' and 'fused'.

The JAX side is compiled by XLA without excess precision
(``xla_allow_excess_precision`` off, as ``test_torch_port_edge.py``'s
``_rounding``): every cast to bf16 in its program rounds. With XLA's
default, a fusion may carry a bf16 value in f32 past its cast (the Pallas
kernels in interpret mode are one such program), so its bits depend on
XLA's fusion choices, not on the program; its op-by-op eager run rounds at
every cast, as this does.

What is compared, in order, and the first value that parts is named with
how far it parts:
(a) the forward: each EGNN layer's aggregate [h_agg ++ x_agg] and its h and
    x (recorded where both packages call ``_node_update``; 'stack' runs the
    layers inside B6 on both sides and 'onehot_remat' inside a checkpoint,
    out of the recorder's reach in JAX's trace, so they record none), the
    embedding (the pooled graph vector, ++ z), the logits and the loss;
(b) every parameter's gradient;
(c) the losses of three Adam steps (lr 1e-3) and the parameters after them.

Bounds:
- forward values: at most ``FWD_FRACTION`` of a value's entries differ and
  mean|port - JAX| <= ``FWD_MEAN`` * mean|JAX| (measured: every value bit
  for bit JAX's, in every case);
- the loss: rel ``LOSS_RTOL`` (measured: 0 in every case but HybridModelv2
  under 'onehot'/'onehot_remat', 1.4e-7, where the MSE and KLD sums of the
  VAE loss take another f32 order);
- gradients, per tensor: mean|port - JAX| <= ``GRAD_MEAN`` * mean|JAX|,
  plus ``GRAD_FLOOR`` * G (G the step's largest |JAX gradient|) for the
  attention key biases (``KEY_BIASES``); and over the tensors the median
  of mean|port - JAX| / mean|JAX| <= ``GRAD_MEDIAN``. Measured: the
  median 0 at two layers of 16 and 1.5e-5 at full width, every tensor
  but the key biases <= 1.6e-3 (the parent's port: medians 2.2e-6 to
  2.0e-2, its worst tensor 1.9e-2 to 0.99). At two layers of 16 every
  tensor outside the attention's query and key path is equal to JAX's bit
  for bit; there the softmax's cotangent
  reaches q and k through products summed in f32 in another order
  (XLA's dot against torch's), which now and then rounds one entry to the
  next bf16 step; on the key bias, whose true gradient is 0 (a softmax does
  not change when one number is added to every score), both sides give
  rounding noise. At full width such a step also reaches the layers below
  through h's cotangent;
- the three steps (JAX's ``_train_step`` compiled as above): the first
  step's loss is the loss above; each loss rel ``STEP_LOSS_RTOL``; per
  tensor but the key biases (``KEY_BIASES``), over the entries whose
  first JAX gradient is above the floor ``GRAD_FLOOR`` * G, mean|port -
  JAX| <= ``PARAM_MEAN`` * lr * steps (measured: <= 0.042), and no entry
  apart by more than 2 * lr * steps (measured: <= 1.8e-3 of 6e-3). Adam moves each
  entry by about lr whatever its gradient's size, so an entry whose
  gradient is rounding noise (the key biases, some query entries) moves
  by lr in the direction of its noise on each side: that moves the later
  losses (measured: up to 6.6e-5, the parent's port alike) and those
  entries (up to 1e-3), not the rest.

The parent's port (autograd through torch's silu, f32 sums in 'scatter')
fails these bounds: see CHANGES.md. What the port now does to round where
JAX does: ``ops/nnp.py::silu`` (JAX's four bf16 roundings of silu on the
CPU and its backward), ``ops/egnn.py``'s ``_Geometry`` and ``_CoordMessage``
(JAX's transpose of the radial, x_hat and msg_x chain) and, under
'scatter', ``_Fanout`` and ``sum_rows_in_order`` (bf16 sums in edge order,
each add rounded, and h's cotangent added in JAX's order).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from immunostruct_tpu.models import build_model as jax_build_model
from immunostruct_tpu.models.trunk import model_apply as jax_model_apply
from immunostruct_tpu.ops import egnn as jax_egnn
from immunostruct_tpu.ops import pallas_mega as pm
from immunostruct_tpu.ops.experimental import pallas_stack as pstk
from immunostruct_tpu.procedures.train import Trainer as JaxTrainer
from immunostruct_tpu.procedures.train import make_optimizer as jax_make_opt
from immunostruct_tpu.utils.checkpoint import save_checkpoint
from immunostruct_tpu.utils.losses import LossConfig as JaxLossConfig
from immunostruct_tpu.utils.schedule import constant_lr as jax_constant_lr
from immunostruct_tpu_torch.models import build_model
from immunostruct_tpu_torch.models.trunk import model_apply
from immunostruct_tpu_torch.ops import egnn as port_egnn
from immunostruct_tpu_torch.procedures.train import Trainer, make_optimizer
from immunostruct_tpu_torch.structs import SampleBatch
from immunostruct_tpu_torch.utils.checkpoint import (
    jax_keystr, jax_params, load_jax_checkpoint,
)
from immunostruct_tpu_torch.utils.losses import LossConfig
from immunostruct_tpu_torch.utils.schedule import constant_lr
from tests.test_torch_port_train import L, LATENT, _arrays, _flat, _jax_batch
from tests.test_torch_port_variants import FLAGS, _paired_arrays, jax_flag

LR = 1e-3
STEPS = 3
FWD_FRACTION = 0.01
FWD_MEAN = 1e-4
LOSS_RTOL = 1e-5
GRAD_MEAN = 3e-3
GRAD_FLOOR = 1e-6
GRAD_MEDIAN = 1e-4
STEP_LOSS_RTOL = 2e-4
PARAM_MEAN = 0.1
# the attention key biases: a softmax does not change when one number is
# added to every score, so their true gradient is 0 and both sides give
# rounding noise there
KEY_BIASES = ("['w_k']['b']", "['key']['b']")
SMALL = dict(gcn_layers=2, gat_hidden_channels=16, dropout_rate=0.0)
VAE = dict(vae_hidden_dim=32, vae_latent_dim=LATENT)
BF16 = jnp.bfloat16


def _exact(jitted, *args):
    """``jitted`` (a ``jax.jit`` function) compiled for ``args`` by XLA
    without excess precision."""
    return jitted.lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def _np(v):
    if torch.is_tensor(v):
        return v.detach().float().numpy()
    return np.asarray(jnp.asarray(v).astype(jnp.float32))


@contextlib.contextmanager
def _jax_variant(aggregation, variant):
    """The JAX global behind a 'mega' variant, set for the block."""
    if aggregation != "mega" or variant == "hybrid":
        yield
    elif variant == "stack":
        with jax_flag(pstk, "STACK_ENABLE"):
            yield
    else:
        with jax_flag(pm, FLAGS[variant]):
            yield


@contextlib.contextmanager
def _layer_records(layers: bool = True):
    """Each package's ``_node_update`` recording (agg, h', x') per layer:
    JAX's while its forward is traced, the port's while ``on`` is set;
    neither with ``layers`` False."""
    rec = {"jax": [], "port": [], "on": False}
    jax_node, port_node = jax_egnn._node_update, port_egnn._node_update

    def jax_record(params, h, x, h_agg, x_agg):
        hn, xn = jax_node(params, h, x, h_agg, x_agg)
        if layers:
            rec["jax"].append((jnp.concatenate(
                [h_agg, x_agg.astype(h_agg.dtype)], -1), hn, xn))
        return hn, xn

    def port_record(p, h, x, h_agg, x_agg):
        hn, xn = port_node(p, h, x, h_agg, x_agg)
        if layers and rec["on"]:
            rec["port"].append((torch.cat([h_agg, x_agg.to(h_agg.dtype)],
                                          -1).detach(), hn.detach(),
                                xn.detach()))
        return hn, xn

    jax_egnn._node_update, port_egnn._node_update = jax_record, port_record
    try:
        yield rec
    finally:
        jax_egnn._node_update, port_egnn._node_update = jax_node, port_node


def _parting(name, want, got):
    """(fraction of entries differing, mean|got - want| / mean|want|)."""
    w, g = _np(want), _np(got)
    diff = np.abs(g - w)
    return name, float((diff > 0).mean()), float(
        diff.mean() / max(np.abs(w).mean(), 1e-30))


def _first_parting(readings, fraction, mean):
    """The first reading past (fraction, mean), as a message, or None."""
    for name, frac, ratio in readings:
        if frac > fraction or ratio > mean:
            return (f"{name} is the first to part: {frac:.4f} of its entries "
                    f"differ, mean|port - JAX| = {ratio:.3g} mean|JAX| "
                    f"(bounds {fraction}, {mean})")
    return None


def _setup(name, tmp_path, aggregation, variant, width):
    """(JAX trainer, its state, the port's trainer, its state, the batch
    as numpy arrays) from the same weights."""
    seq = name != "StructureModel"
    kw = dict(dropout_rate=0.0) if width == "full" else dict(SMALL)
    if seq:
        kw.update(VAE)
    vae_dim = L * 21
    spec, params = jax_build_model(name, vae_dim, jax.random.key(3), **kw)
    jtrainer = JaxTrainer(
        spec, JaxLossConfig(vae_dim, pos_weight=1.0, sequence=seq),
        binary=True, optimizer=jax_make_opt("adam", jax_constant_lr(LR)),
        aggregation=aggregation, compute_dtype=BF16, donate=False)
    jstate = jtrainer.init_state(params, jax.random.key(5))
    path = str(tmp_path / "init.ckpt")
    save_checkpoint(path, jstate.params)
    _, model = build_model(name, vae_dim, torch.Generator().manual_seed(0),
                           **kw)
    trainer = Trainer(
        model.spec, LossConfig(vae_dim, pos_weight=1.0, sequence=seq),
        binary=True, optimizer=make_optimizer("adam", constant_lr(LR)),
        aggregation=aggregation, compute_dtype=torch.bfloat16,
        mega_variant=variant)
    state = trainer.init_state(model)
    load_jax_checkpoint(path, state.model, verbose=False)
    arrays = (_paired_arrays(8, seed=0) if variant == "paired"
              else _arrays(8, seed=0))
    return jtrainer, jstate, trainer, state, arrays


def _eps(rng, b, spec):
    """The VAE noise ``model_apply(rng)`` draws under bf16: normal(k_eps)
    in bf16, (k_item, _) = split(rng), (k_eps, _) = split(k_item)."""
    if not spec.use_sequence:
        return None
    k_item = jax.random.split(rng)[0]
    draw = jax.random.normal(jax.random.split(k_item)[0], (b, LATENT),
                             dtype=BF16)
    return torch.from_numpy(_np(draw)).to(torch.bfloat16)


def _step_readings(name, tmp_path, aggregation, variant="hybrid",
                   width="small"):
    """Everything the file compares, in order: (forward readings, loss
    pair, gradient readings with G, step losses, parameter readings)."""
    jt, js, pt, ps, a = _setup(name, tmp_path, aggregation, variant, width)
    jbatch = _jax_batch(a)
    batch = SampleBatch.from_numpy(a, "cpu")
    key = jax.random.key(7)
    rng = jax.random.fold_in(key, 0)
    b = a["target"].shape[0]
    layers = aggregation != "onehot_remat"
    with _jax_variant(aggregation, variant), _layer_records(layers) as rec:
        def loss_aux(params):
            out = jax_model_apply(params, jt.spec, jbatch.graph,
                                  jbatch.seq_onehot, jbatch.props, rng,
                                  aggregation=aggregation,
                                  compute_dtype=BF16)
            loss = jt.loss_fn(out.recon, jbatch.seq_onehot, out.mu,
                              out.logvar, out.logits, jbatch.target,
                              node_logits=out.node_logits, residue=None)
            return loss, (rec["jax"], out.embedding, out.logits)

        value_and_grad = jax.jit(jax.value_and_grad(loss_aux, has_aux=True))
        (jloss, (jlayers, jemb, jlogits)), jgrads = _exact(
            value_and_grad, js.params)(js.params)
        jstep = _exact(jt._train_step, js, jbatch, key)

    with _layer_records(layers) as rec:
        rec["on"] = True
        out = model_apply(ps.model, batch.graph, batch.seq_onehot,
                          batch.props, aggregation=aggregation,
                          compute_dtype=torch.bfloat16,
                          eps=_eps(rng, b, jt.spec), mega_variant=variant)
        rec["on"] = False
        loss = pt.loss_fn(out.recon, batch.seq_onehot, out.mu, out.logvar,
                          out.logits, batch.target,
                          node_logits=out.node_logits, residue=None)
        loss.backward()
        players = rec["port"]
    assert len(players) == len(jlayers)
    fwd = []
    for i, (want, got) in enumerate(zip(jlayers, players)):
        for part, w, g in zip(("aggregate", "h", "x"), want, got):
            fwd.append(_parting(f"layer {i} {part}", w, g))
    fwd.append(_parting("embedding", jemb, out.embedding))
    fwd.append(_parting("logits", jlogits, out.logits))
    fwd.append(_parting("loss", jloss, loss))

    first = _flat(jgrads)
    got = {jax_keystr(n): p.grad for n, p in ps.model.named_parameters()}
    assert got.keys() == first.keys()
    top = max(float(np.abs(w).max()) for w in first.values())
    grads = [_parting(k, w, got[k]) + (float(np.abs(w).mean()),)
             for k, w in first.items()]
    for p in ps.model.parameters():
        p.grad = None

    steps = []
    for step in range(STEPS):
        js, jl = jstep(js, jbatch, key)
        ps, pl = pt.train_step(
            ps, batch, 0, eps=_eps(jax.random.fold_in(key, step), b,
                                   jt.spec))
        steps.append((float(jl), float(pl)))
    want, got = _flat(js.params), jax_params(ps.model)
    params = []
    for k, w in want.items():
        diff = np.abs(got[k] - w)
        above = np.abs(first[k]) > GRAD_FLOOR * top
        params.append((k, float(diff[above].mean()) / (LR * STEPS)
                       if above.any() else 0.0, float(diff.max())))
    return dict(forward=fwd, loss=(float(jloss), float(loss.detach())),
                grads=grads, top=top, steps=steps, params=params)


def _check(r):
    """The file's bounds on ``_step_readings``; the readings printed."""
    print("forward:", [x for x in r["forward"] if x[1] > 0])
    first = _first_parting(r["forward"][:-1], FWD_FRACTION, FWD_MEAN)
    assert first is None, first
    jl, pl = r["loss"]
    assert abs(pl - jl) <= LOSS_RTOL * abs(jl), (
        f"loss {pl!r} against JAX's {jl!r}, rel {abs(pl - jl) / abs(jl):.3g}")
    ratios = [ratio for _, _, ratio, _ in r["grads"]]
    worst = sorted(r["grads"], key=lambda g: -g[2])[:4]
    print("gradients: median", np.median(ratios), "worst", worst)
    for name, frac, ratio, mean in r["grads"]:
        floor = GRAD_FLOOR * r["top"] if name.endswith(KEY_BIASES) else 0.0
        assert ratio * mean <= GRAD_MEAN * mean + floor, (
            f"gradient {name} parts first past the per-tensor bound: "
            f"mean|port - JAX| = {ratio:.3g} mean|JAX|, {frac:.3f} of its "
            f"entries differ")
    assert np.median(ratios) <= GRAD_MEDIAN, (
        f"gradients: median over tensors {np.median(ratios):.3g} mean|JAX|")
    print("steps:", r["steps"])
    for step, (jl, pl) in enumerate(r["steps"]):
        assert abs(pl - jl) <= STEP_LOSS_RTOL * abs(jl), (
            f"step {step}: loss {pl!r} against JAX's {jl!r}")
    moved = sorted(r["params"], key=lambda p: -p[1])[:3]
    print("parameters furthest apart after the steps:", moved)
    for name, mean, top in r["params"]:
        if name.endswith(KEY_BIASES):
            mean = 0.0          # a true gradient of 0: noise on both sides
        assert mean <= PARAM_MEAN and top <= 2 * LR * STEPS, (
            f"parameter {name} after {STEPS} steps: mean |port - JAX| "
            f"{mean:.3g} lr a step over its entries above the floor, "
            f"{top:.3g} at most")


AGGREGATIONS = [("scatter", "hybrid"), ("onehot", "hybrid"),
                ("onehot_remat", "hybrid"), ("mega", "hybrid"),
                ("mega", "dboth"), ("mega", "inkernel"), ("mega", "paired"),
                ("mega", "stack"), ("fused", "hybrid"), ("pallas", "hybrid")]


@pytest.mark.parametrize("aggregation,variant", AGGREGATIONS)
@pytest.mark.parametrize("name", ["StructureModel", "HybridModelv2"])
def test_bf16_step_matches_jax(tmp_path, name, aggregation, variant):
    _check(_step_readings(name, tmp_path, aggregation, variant))


@pytest.mark.parametrize("aggregation", ["scatter", "mega", "fused"])
def test_bf16_step_matches_jax_at_full_width(tmp_path, aggregation):
    _check(_step_readings("StructureModel", tmp_path, aggregation,
                          width="full"))
