"""The PyTorch port's training step (immunostruct_tpu_torch/procedures/
train.py) against the JAX package's ``Trainer``, on the CPU.

The same JAX ``build_model`` parameters (saved with ``save_checkpoint``,
loaded with ``load_jax_checkpoint``) and the same seeded numpy batch (with
padded edges and self-loops) go through both trainers: HybridModelv2 and
HybridModelv2_Comparative at gcn_layers=2, gat_hidden_channels=16,
vae_hidden_dim=32, vae_latent_dim=8, f32, ``dropout_rate=0.0``, Adam at
1e-3. Each step's VAE noise is the one JAX draws from ``fold_in(key,
step)`` (and ``fold_in(., i)`` per microbatch), replayed into the port as
``eps``. The JAX mega kernels run in interpret mode. The contrastive term
under accumulation (``allow_microbatch_contrastive``) runs on microbatches
of 2 and of 4. The twin steps (``test_torch_port_train_twin.py``) and the
contrastive term on microbatches (``test_torch_port_train_microbatch.py``)
sit in files of their own, on this file's helpers and bounds, so that the
suite's workers share them.

Tolerances:
- loss: rtol=1e-5 (measured: equal to 1e-7);
- gradients: |port - JAX| <= 1e-5 * (the step's largest gradient) + 1e-4 *
  |JAX| (measured <= 3e-8 absolute at a largest gradient of 2.4). The
  attention key biases have a true gradient of zero (a softmax does not
  change when one number is added to every key); both sides give rounding
  noise there, ~1e-9, inside the absolute term;
- parameters after Adam steps: atol=1e-6 + rtol=1e-5, plus, per entry,
  lr * steps * min(1, 2 * max over steps of noise / |gradient|), with
  noise = 1e-7 * (the step's largest gradient) + 1e-5 * |gradient| (the
  measured gradient differences: <= 2e-8 of the largest, 3e-6 of the
  entry). Adam divides each gradient by its own size, so where a gradient
  is near its rounding noise the step's direction is noise too: the key
  biases (gradient ~1e-9) may move apart by lr a step (measured 4.5e-4
  after 3 steps), entries with gradients ~1e-6 of the largest (the
  comparative model's attention and last node MLP) by a few percent of lr
  (measured 1.8e-4), every other entry by <= 1.3e-7.
"""

import dataclasses
import functools
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from immunostruct_tpu.models import build_model as jax_build_model
from immunostruct_tpu.procedures.train import Trainer as JaxTrainer
from immunostruct_tpu.procedures.train import make_optimizer as jax_make_opt
from immunostruct_tpu.data.synthetic import (
    random_comparative_batch as jax_random_comparative_batch,
)
from immunostruct_tpu.structs import ComparativeBatch as JaxComparativeBatch
from immunostruct_tpu.structs import GraphBatch as JaxGraphBatch
from immunostruct_tpu.structs import SampleBatch as JaxSampleBatch
from immunostruct_tpu.utils.checkpoint import save_checkpoint
from immunostruct_tpu.utils.losses import LossConfig as JaxLossConfig
from immunostruct_tpu.utils.schedule import constant_lr as jax_constant_lr
from immunostruct_tpu_torch.data.synthetic import (
    random_comparative_batch, random_sample_arrays,
)
from immunostruct_tpu_torch.models import build_model
from immunostruct_tpu_torch.parallel.dryrun import twin_excess
from immunostruct_tpu_torch.procedures import train as train_module
from immunostruct_tpu_torch.procedures.train import (
    Trainer, make_optimizer, step_generator,
)
from immunostruct_tpu_torch.structs import (
    ComparativeBatch, SampleBatch, map_tensors,
)
from immunostruct_tpu_torch.utils.checkpoint import (
    jax_keystr, jax_params, load_jax_checkpoint,
)
from immunostruct_tpu_torch.utils.losses import LossConfig
from immunostruct_tpu_torch.utils.schedule import constant_lr
from tests.torch_threads import one_torch_thread  # noqa: F401

N, E, L = 16, 128, 6
LATENT = 8
SMALL = dict(gcn_layers=2, gat_hidden_channels=16, vae_hidden_dim=32,
             vae_latent_dim=LATENT, dropout_rate=0.0)
LR = 1e-3
STEPS = 3
GRAPH = ("node_feat", "coords", "edge_src", "edge_dst", "edge_feat",
         "edge_mask", "node_mask", "num_nodes")


def _arrays(b, seed):
    a = random_sample_arrays(b, N, E, L, seed=seed)
    rng = np.random.default_rng(seed + 100)
    a["edge_mask"] = rng.random((b, E)) >= 0.2               # padded edges
    a["edge_src"][:, :4] = a["edge_dst"][:, :4]              # self-loops
    a["edge_feat"] = rng.standard_normal((b, E, 1)).astype(np.float32)
    a["target"] = (np.arange(b) % 2 == 0).astype(np.float32)  # two classes
    return a


def _jax_batch(a):
    return JaxSampleBatch(
        graph=JaxGraphBatch(**{k: jnp.asarray(a[k]) for k in GRAPH}),
        seq_onehot=jnp.asarray(a["seq_onehot"]),
        props=jnp.asarray(a["props"]), target=jnp.asarray(a["target"]),
        aux_residue=None)


def _normal(key, shape):
    return torch.from_numpy(np.array(jax.random.normal(key, shape)))


def _item_eps(key, b):
    """The eps forward_item draws from ``key``: normal(split(key)[0])."""
    return _normal(jax.random.split(key)[0], (b, LATENT))


def _plain_eps(rng, b):
    """model_apply(rng): (k_item, k_cls) = split(rng)."""
    return _item_eps(jax.random.split(rng)[0], b)


def _twin_eps(rng, b, stack_twins):
    """model_apply_comparative(rng): one 2B draw, or one per twin."""
    if stack_twins:
        return _item_eps(jax.random.split(rng)[0], 2 * b)
    k_c, k_w, _ = jax.random.split(rng, 3)
    return _item_eps(k_c, b), _item_eps(k_w, b)


def _flat(tree):
    flat, _ = jax.tree.flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


def _setup(name, tmp_path, aggregation, coeff=0.0, accum=1,
           stack_twins=False, optimizer=("adam", 0.0), microbatch=False):
    """The JAX trainer and state, and the port's from the same weights;
    ``optimizer`` is (name, weight decay); ``microbatch``: both trainers'
    ``allow_microbatch_contrastive``."""
    vae_dim = L * 21
    spec, params = jax_build_model(name, vae_dim, jax.random.key(3), **SMALL)
    jtrainer = JaxTrainer(
        spec, JaxLossConfig(vae_dim, pos_weight=1.0, sequence=True),
        binary=True,
        optimizer=jax_make_opt(optimizer[0], jax_constant_lr(LR),
                               optimizer[1]),
        coeff_contrastive=coeff, aggregation=aggregation, donate=False,
        grad_accum_steps=accum, stack_twins=stack_twins,
        allow_microbatch_contrastive=microbatch)
    jstate = jtrainer.init_state(params, jax.random.key(5))
    path = str(tmp_path / "init.ckpt")
    save_checkpoint(path, jstate.params)
    _, model = build_model(name, vae_dim, torch.Generator().manual_seed(0),
                           **SMALL)
    trainer = Trainer(
        model.spec, LossConfig(vae_dim, pos_weight=1.0, sequence=True),
        binary=True,
        optimizer=make_optimizer(optimizer[0], constant_lr(LR), optimizer[1]),
        coeff_contrastive=coeff, aggregation=aggregation,
        grad_accum_steps=accum, stack_twins=stack_twins,
        allow_microbatch_contrastive=microbatch)
    state = trainer.init_state(model)
    load_jax_checkpoint(path, state.model, verbose=False)
    return jtrainer, jstate, trainer, state


def _assert_grads_match(model, jgrads):
    want = _flat(jgrads)
    names = {jax_keystr(n): p for n, p in model.named_parameters()}
    assert names.keys() == want.keys()
    gmax = max(np.abs(w).max() for w in want.values())
    for key, w in want.items():
        g = names[key].grad.numpy()
        assert (np.abs(g - w) <= 1e-5 * gmax + 1e-4 * np.abs(w)).all(), key


def _grads_of(model):
    return {jax_keystr(n): p.grad.numpy().copy()
            for n, p in model.named_parameters()}


def _assert_params_match(model, jparams, step_grads):
    """Parameters after len(step_grads) Adam steps (module docstring)."""
    got, want = jax_params(model), _flat(jparams)
    assert got.keys() == want.keys()
    steps = len(step_grads)
    gmax = [max(np.abs(g).max() for g in grads.values())
            for grads in step_grads]
    for key, w in want.items():
        ratio = np.zeros_like(w)
        for grads, top in zip(step_grads, gmax):
            g = np.abs(grads[key])
            noise = 1e-7 * top + 1e-5 * g
            ratio = np.maximum(ratio, np.where(g > 0, noise / np.where(
                g > 0, g, 1.0), np.inf))
        tol = (1e-6 + 1e-5 * np.abs(w)
               + LR * steps * np.minimum(1.0, 2.0 * ratio))
        assert (np.abs(got[key] - w) <= tol).all(), key


# JAX's side of a step, computed once for the cases that share it:
# (the cases' ``share`` key, what was computed, a digest of its inputs) ->
# its outputs
_JAX_SHARED = {}


def _digest(*trees) -> str:
    """sha1 over every leaf of ``trees`` (a key by its key data): its
    dtype, shape and bytes."""
    h = hashlib.sha1()
    for leaf in jax.tree.leaves(trees):
        if jnp.issubdtype(leaf.dtype, jax.dtypes.prng_key):
            leaf = jax.random.key_data(leaf)
        a = np.asarray(leaf)
        h.update(f"{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _shared(share, what, fn, *args):
    """``fn(*args)``, JAX's side of a step. Cases that pass the same
    ``share`` (not None) build the same JAX trainer and batch under the
    same JAX globals, so a call on the same inputs gives the same outputs:
    the first such case computes it and the others read it."""
    if share is None:
        return fn(*args)
    key = (share, what, _digest(*args))
    if key not in _JAX_SHARED:
        _JAX_SHARED[key] = fn(*args)
    return _JAX_SHARED[key]


def _twin_steps(jtrainer, jstate, trainer, state, jbatch, batch, eps_of,
                share=None):
    """STEPS Adam steps of the port, each held against one JAX step taken
    from the port's own state before it (``_jax_state_at``: its
    parameters, Adam moments and step), so that a step is judged alone and
    not the ill-conditioned trajectory the steps before it led to. Per
    step: both losses; the port's gradient against JAX's at that state by
    the file's gradient rule (``same_point``); the gradient and the
    parameters after the step by ``dryrun.twin_excess`` (``rule``: nu from
    JAX's step; an entry whose JAX gradient is nonzero and below nu is
    dropped from the parameters' bound, the rule of Adam's first step);
    the parameters by ``_reach_excess`` (``reach``). ``share``: see
    ``_shared``."""
    key = jax.random.key(7)
    steps = []
    for step in range(STEPS):
        rng = jax.random.fold_in(key, step)
        start = _jax_state_at(jstate, state)
        _, jgrads = _shared(share, "loss_and_grads", jtrainer._loss_and_grads,
                            start.params, jbatch, rng)
        jnext, jl = _shared(share, "train_step", jtrainer._train_step, start,
                            jbatch, key)
        state, pl = trainer.train_step(state, batch, 0, eps=eps_of(rng))
        grads = _grads_of(state.model)
        ref = dict(grads=_tensors(_flat(jgrads)),
                   params=_tensors(_flat(jnext.params)))
        got = dict(grads=_tensors(grads),
                   params=_tensors(jax_params(state.model)))
        steps.append(dict(loss=float(pl), jax_loss=float(jl),
                          same_point=_grad_excess(grads, _flat(jgrads)),
                          rule=twin_excess(got, ref),
                          reach=_reach_excess(
                              _shared(share, "reach", functools.partial(
                                  _reach, jtrainer.optimizer), start, jgrads),
                              got["params"], ref["params"])))
    return steps


def _reach_excess(reach, got, want, atol=2e-6, rtol=2e-5):
    """The parameters after one step from a state against JAX's step: the
    worst |port - JAX| over atol + rtol |JAX| + ``reach`` (``_reach``);
    <= 1 within it."""
    return max(float(((got[k] - w).abs() / (atol + rtol * w.abs()
                                            + torch.from_numpy(reach[k])))
                     .max()) for k, w in want.items())


def _reach(optimizer, start, jgrads):
    """The reach, per entry, of JAX's own Adam step from ``start`` over
    gradients within the file's gradient rule of JAX's (g + t (1e-5 max|g|
    + 1e-4 |g|), t on nine points of [-1, 1]): what that step makes of a
    gradient the rule admits. Adam divides each entry by its own
    gradient's size, so an entry whose gradient is near the rule's floor
    may move by up to lr where one far above it may not move at all."""
    gmax = max(float(jnp.abs(g).max()) for g in jax.tree.leaves(jgrads))

    def update(t):
        g = jax.tree.map(lambda x: x + t * (1e-5 * gmax + 1e-4 * jnp.abs(x)),
                         jgrads)
        return _flat(optimizer.update(g, start.opt_state, start.params)[0])
    base = update(0.0)
    reach = {k: np.zeros_like(v) for k, v in base.items()}
    for t in np.linspace(-1.0, 1.0, 9):
        for k, u in update(t).items():
            reach[k] = np.maximum(reach[k], np.abs(u - base[k]))
    return reach


def _jax_state_at(jstate, state):
    """JAX's train state (optax Adam) at the port's parameters, Adam
    moments (torch's exp_avg and exp_avg_sq, zero before a first step) and
    step."""
    names = {jax_keystr(n): p for n, p in state.model.named_parameters()}
    moments = state.optimizer.state

    def tree(of):
        return jax.tree_util.tree_map_with_path(
            lambda p, _: jnp.asarray(of(names[jax.tree_util.keystr(p)])),
            jstate.params)

    def moment(name):
        return lambda p: (moments[p][name].numpy() if p in moments
                          else np.zeros(p.shape, np.float32))
    adam, schedule = jstate.opt_state
    count = jnp.asarray(state.step, adam.count.dtype)
    return dataclasses.replace(
        jstate, params=tree(lambda p: p.detach().numpy()),
        opt_state=(adam._replace(count=count, mu=tree(moment("exp_avg")),
                                 nu=tree(moment("exp_avg_sq"))),
                   schedule._replace(count=count)),
        step=jnp.asarray(state.step, jstate.step.dtype))


def _grad_excess(got, want):
    """The worst |port - JAX| over the file's gradient rule (1e-5 * the
    step's largest |gradient| + 1e-4 * |JAX|); <= 1 within it."""
    gmax = max(np.abs(w).max() for w in want.values())
    return max(float((np.abs(got[k] - w) / (1e-5 * gmax + 1e-4 * np.abs(w)))
                     .max()) for k, w in want.items())


def _tensors(arrays):
    return {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()}


def _run_steps(jtrainer, jstate, trainer, state, jbatch, batch, eps_of,
               params="file", share=None):
    """Step 0's loss and gradients against jax.value_and_grad, then STEPS
    Adam steps on both sides (each step's loss); parameters compared after
    them by the file's rule (``params="file"``), or (``"twin"``,
    ``_twin_steps``) each step from the port's own state against JAX's
    step from that state: its gradients by the file's gradient rule and by
    ``dryrun.twin_excess``'s, its parameters by ``_reach_excess`` and,
    after the first step, by ``twin_excess``'s. ``share``: see
    ``_shared``."""
    key = jax.random.key(7)
    jloss, jgrads = _shared(share, "loss_and_grads", jtrainer._loss_and_grads,
                            jstate.params, jbatch, jax.random.fold_in(key, 0))
    loss = trainer.loss_and_grads(state.model, batch,
                                  step_generator(0, 0, "cpu"),
                                  eps_of(jax.random.fold_in(key, 0)))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _assert_grads_match(state.model, jgrads)
    if params == "twin":
        for step, r in enumerate(_twin_steps(jtrainer, jstate, trainer,
                                             state, jbatch, batch, eps_of,
                                             share)):
            print(f"twin step {step}:", r)
            np.testing.assert_allclose(r["loss"], r["jax_loss"], rtol=1e-5)
            assert r["same_point"] <= 1, (step, r)
            assert r["rule"]["grads"] <= 1, (step, r)
            assert r["reach"] <= 1, (step, r)
            if step == 0:
                assert r["rule"]["params"] <= 1, r
        return
    step_grads = []
    for step in range(STEPS):
        jstate, jl = jtrainer._train_step(jstate, jbatch, key)
        state, pl = trainer.train_step(
            state, batch, 0, eps=eps_of(jax.random.fold_in(key, step)))
        np.testing.assert_allclose(float(pl), float(jl), rtol=1e-5)
        step_grads.append(_grads_of(state.model))
    assert state.step == STEPS
    _assert_params_match(state.model, jstate.params, step_grads)


@pytest.mark.parametrize("aggregation", ["scatter", "mega", "pallas"])
def test_train_step_matches_jax(tmp_path, aggregation):
    a = _arrays(3, seed=0)
    jt, js, pt, ps = _setup("HybridModelv2", tmp_path, aggregation)
    _run_steps(jt, js, pt, ps, _jax_batch(a), SampleBatch.from_numpy(a, "cpu"),
               lambda rng: _plain_eps(rng, 3))


def test_grad_accumulation_matches_jax(tmp_path):
    """grad_accum_steps=2 on a batch of 4: two microbatches of 2, each with
    its own noise (fold_in(rng, i)), gradients summed and halved."""
    a = _arrays(4, seed=1)
    jt, js, pt, ps = _setup("HybridModelv2", tmp_path, "scatter", accum=2)

    def eps_of(rng):
        return [_plain_eps(jax.random.fold_in(rng, i), 2) for i in range(2)]

    _run_steps(jt, js, pt, ps, _jax_batch(a), SampleBatch.from_numpy(a, "cpu"),
               eps_of)


def test_grad_accumulation_remainder_batch_takes_one_step(tmp_path):
    """A batch that grad_accum_steps does not divide (3 with k=2) falls
    back to one unsplit step: the same loss and gradients as k=1."""
    a = _arrays(3, seed=2)
    batch = SampleBatch.from_numpy(a, "cpu")
    eps = _plain_eps(jax.random.key(1), 3)
    runs = []
    for accum in (2, 1):
        *_, trainer, state = _setup("HybridModelv2", tmp_path, "scatter",
                                    accum=accum)
        loss = trainer.loss_and_grads(state.model, batch, None, eps)
        runs.append((loss, [p.grad.clone()
                            for p in state.model.parameters()]))
    (l2, g2), (l1, g1) = runs
    torch.testing.assert_close(l2, l1, atol=0.0, rtol=0.0)
    for x, y in zip(g2, g1):
        torch.testing.assert_close(x, y, atol=0.0, rtol=0.0)


def _comparative_batches(b, seed):
    cancer, wt = _arrays(b, seed), _arrays(b, seed + 1)
    wt["target"] = cancer["target"]
    jbatch = JaxComparativeBatch(cancer=_jax_batch(cancer),
                                 wt=_jax_batch(wt))
    batch = ComparativeBatch(cancer=SampleBatch.from_numpy(cancer, "cpu"),
                             wt=SampleBatch.from_numpy(wt, "cpu"))
    return jbatch, batch


def test_contrastive_gate_is_zero_for_a_one_class_batch(tmp_path):
    """All targets 1: the contrastive term is 0, so the loss equals the
    twin loss alone and the projector gets zero gradients."""
    _, batch = _comparative_batches(4, seed=4)
    batch.cancer.target = torch.ones(4)
    batch.wt.target = torch.ones(4)
    eps = (_item_eps(jax.random.key(0), 4), _item_eps(jax.random.key(1), 4))
    losses = []
    for coeff in (0.1, 0.0):
        *_, trainer, state = _setup("HybridModelv2_Comparative", tmp_path,
                                    "scatter", coeff=coeff)
        loss, _ = trainer._batch_loss_aux(state.model, batch, None, False,
                                          eps)
        loss.backward()
        losses.append(loss.detach())
        if coeff:
            for p in state.model.contrastive_projector.parameters():
                assert torch.count_nonzero(p.grad) == 0
    torch.testing.assert_close(losses[0], losses[1], atol=0.0, rtol=0.0)


def test_microbatch_contrastive_takes_each_microbatch_statistics(tmp_path):
    """With the opt-in, a step at k=2 is the mean of the two microbatches'
    own steps: the loss and the gradients of each half of the batch taken
    alone (k=1), drawn one after the other from one generator, summed and
    halved, bit for bit. A microbatch of one class contributes no
    contrastive term (its gate), as in JAX."""
    _, batch = _comparative_batches(4, seed=10)
    for twin in (batch.cancer, batch.wt):       # halves [1, 0] and [1, 1]
        twin.target = torch.tensor([1.0, 0.0, 1.0, 1.0])
    *_, acc, acc_state = _setup("HybridModelv2_Comparative", tmp_path,
                                "scatter", coeff=0.1, accum=2,
                                microbatch=True)
    *_, one, one_state = _setup("HybridModelv2_Comparative", tmp_path,
                                "scatter", coeff=0.1)
    loss = acc.loss_and_grads(acc_state.model, batch,
                              step_generator(0, 0, "cpu"))
    gen, total, terms = step_generator(0, 0, "cpu"), 0.0, []
    real = train_module.paired_contrastive_loss

    def spy(*args, **kw):
        terms.append(real(*args, **kw).detach())
        return real(*args, **kw)

    train_module.paired_contrastive_loss = spy
    try:
        for i in range(2):
            half = map_tensors(lambda t, i=i: t[2 * i:2 * i + 2], batch)
            part, _ = one._batch_loss_aux(one_state.model, half, gen, False)
            part.backward()
            total = total + part.detach()
    finally:
        train_module.paired_contrastive_loss = real
    assert terms[0] > 0 and terms[1] == 0     # the gate shuts on [1, 1]
    assert torch.equal(loss, total * 0.5)
    for (name, p), q in zip(acc_state.model.named_parameters(),
                            one_state.model.parameters()):
        assert torch.equal(p.grad, q.grad * 0.5), name


def test_contrastive_with_accumulation_raises():
    """Without the opt-in the port raises where JAX raises, and names the
    opt-in as JAX does."""
    _, model = build_model("HybridModelv2_Comparative", L * 21,
                           torch.Generator().manual_seed(0), **SMALL)
    with pytest.raises(ValueError, match="microbatch") as port:
        Trainer(model.spec, LossConfig(L * 21, 1.0), binary=True,
                optimizer=make_optimizer("adam", constant_lr(LR)),
                coeff_contrastive=0.1, grad_accum_steps=2)
    spec, _ = jax_build_model("HybridModelv2_Comparative", L * 21,
                              jax.random.key(0), **SMALL)
    with pytest.raises(ValueError) as jax_error:
        JaxTrainer(spec, JaxLossConfig(L * 21, 1.0), binary=True,
                   optimizer=jax_make_opt("adam", jax_constant_lr(LR)),
                   coeff_contrastive=0.1, grad_accum_steps=2)
    assert str(port.value) == str(jax_error.value)
    assert "allow_microbatch_contrastive=True" in str(port.value)


def test_dropout_in_train_mode_follows_seed_and_step():
    """dropout_rate=0.1: the same (seed, step) gives the same loss, another
    step another loss; a deterministic forward differs from both."""
    _, model = build_model("HybridModelv2", L * 21,
                           torch.Generator().manual_seed(0),
                           **{**SMALL, "dropout_rate": 0.1})
    trainer = Trainer(model.spec, LossConfig(L * 21, 1.0), binary=True,
                      optimizer=make_optimizer("adam", constant_lr(LR)),
                      aggregation="scatter")
    batch = SampleBatch.from_numpy(_arrays(4, seed=5), "cpu")
    eps = torch.zeros(4, LATENT)

    def loss(seed, step, deterministic=False):
        with torch.no_grad():
            return trainer._batch_loss_aux(
                model, batch, step_generator(seed, step, "cpu"),
                deterministic, eps)[0]

    torch.testing.assert_close(loss(0, 0), loss(0, 0), atol=0.0, rtol=0.0)
    assert not torch.equal(loss(0, 0), loss(0, 1))
    assert not torch.equal(loss(0, 0), loss(1, 0))
    assert not torch.equal(loss(0, 0), loss(0, 0, deterministic=True))


def test_train_step_is_repeatable_from_seed_and_step(tmp_path):
    """Two trainers from the same weights, driven with the same seed, take
    the same steps (noise drawn, not replayed)."""
    batch = SampleBatch.from_numpy(_arrays(3, seed=6), "cpu")
    runs = []
    for _ in range(2):
        *_, trainer, state = _setup("HybridModelv2", tmp_path, "mega")
        losses = [float(trainer.train_step(state, batch, 11)[1])
                  for _ in range(2)]
        runs.append((losses, jax_params(state.model)))
    assert runs[0][0] == runs[1][0]
    for key, value in runs[0][1].items():
        np.testing.assert_array_equal(value, runs[1][1][key], err_msg=key)


def test_random_comparative_batch_bit_identical_to_jax():
    want = jax_random_comparative_batch(2, 12, 40, 5, seed=9)
    got = random_comparative_batch(2, 12, 40, 5, seed=9)
    for half in ("cancer", "wt"):
        g, w = getattr(got, half), getattr(want, half)
        for k in GRAPH:
            np.testing.assert_array_equal(getattr(g.graph, k).numpy(),
                                          np.asarray(getattr(w.graph, k)))
        for k in ("seq_onehot", "props", "target"):
            np.testing.assert_array_equal(getattr(g, k).numpy(),
                                          np.asarray(getattr(w, k)))
