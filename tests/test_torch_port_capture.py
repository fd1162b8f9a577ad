"""Captured programs (immunostruct_tpu_torch/utils/capture.py) on the CPU:
the parts that capture rests on.

A CUDA graph cannot be captured here. What a replay runs is the call's work
on the key's static inputs, with the program's one generator re-seeded and
the outputs copied out; ``Program.rehearse`` runs exactly that, eagerly (it
is the card's warm-up call). These tests hold it to today's eager calls bit
for bit: the train step over 6 steps that cross an epoch of the learning-rate
schedule and a trailing partial batch, with and without k=2 accumulation,
and the twin step with its contrastive term, the rate a tensor filled before
each step (an f64 tensor here, an f32 device tensor on the card); the eval
step, batch inference and
the served forward. Three steps of that form meet the JAX ``Trainer`` within
``tests/test_torch_port_train.py``'s parity bounds, parameters and Adam
moments. They also check the keys, the rules that run a call eagerly (and
that capture asked for on the CPU raises), and that a program whose state
tensors were replaced (a resumed optimizer, a new head, a re-initialized
run) is dropped, through a ``Program`` whose graph is its rehearsal.

The card tests (``tests/test_torch_port_cuda.py``, ``-k captured``) hold the
real graphs to the eager path.
"""

import functools
import os

import jax
import numpy as np
import pytest
import torch

from immunostruct_tpu_torch.data.synthetic import (
    random_comparative_batch, random_sample_batch,
)
from immunostruct_tpu_torch.models import build_model
from immunostruct_tpu_torch.models.trunk import reset_head
from immunostruct_tpu_torch.procedures import infer
from immunostruct_tpu_torch.procedures.train import (
    Trainer, derived_seed, make_optimizer,
)
from immunostruct_tpu_torch.serving import ArtifactScorer, Scorer
from immunostruct_tpu_torch.structs import ComparativeBatch
from immunostruct_tpu_torch.utils import capture
from immunostruct_tpu_torch.utils.capture import Program, tree_map
from immunostruct_tpu_torch.utils.checkpoint import (
    jax_keystr, load_resume_state, save_resume_state,
)
from immunostruct_tpu_torch.utils.losses import LossConfig
from tests import test_torch_port_train as t
from tests.torch_threads import one_torch_thread  # noqa: F401

N, E, L = 16, 128, 6
SMALL = dict(gcn_layers=2, gat_hidden_channels=16, vae_hidden_dim=32,
             vae_latent_dim=8, dropout_rate=0.1)
SIZES = (4, 4, 3)       # an epoch: two full batches and a trailing one
STEPS = 6               # two epochs


def _halving(epoch):
    return 1e-3 * 0.5 ** epoch


def _model(name, seed=0):
    return build_model(name, L * 21, torch.Generator().manual_seed(seed),
                       **SMALL)[1]


def _trainer(name, accum=1, coeff=0.0, capture_flag=None):
    return Trainer(
        _model(name).spec, LossConfig(L * 21, pos_weight=1.0, sequence=True),
        binary=True,
        optimizer=make_optimizer("adam", _halving,
                                 steps_per_epoch=len(SIZES)),
        coeff_contrastive=coeff, aggregation="mega", grad_accum_steps=accum,
        allow_microbatch_contrastive=coeff > 0 and accum > 1,
        capture=capture_flag)


def _batches(name):
    twin = name.endswith("Comparative")
    make = random_comparative_batch if twin else random_sample_batch
    out = []
    for i, b in enumerate(SIZES * 2):
        batch = make(b, N, E, L, seed=40 + i)
        if twin:                    # two classes, so the gate is open
            batch.cancer.target = (torch.arange(b) % 2).float()
            batch.wt.target = batch.cancer.target
        out.append(batch)
    return out


def _state(trainer, name):
    """A model from seed 0 and its state, with the trainer's optimizer."""
    return trainer.init_state(_model(name), torch.Generator().manual_seed(9))


def _moments(state):
    return [v for p in state.model.parameters()
            for v in state.optimizer.state[p].values()]


def _assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if x is None or y is None:
            assert x is None and y is None
        else:
            assert torch.equal(x, y)


def _rehearsed_step(trainer, program, state, batch, seed, eps=None):
    """The step as a replay runs it: the rate filled into the tensor, the
    work on the key's static inputs, the generator re-seeded."""
    trainer.optimizer.apply_lr(state.optimizer, state.step)
    loss = program.rehearse(
        functools.partial(trainer._train_work, state), (batch, eps),
        static=trainer._static("train", state.model, batch),
        seed=derived_seed(seed, state.step))
    state.step += 1
    return loss


CASES = [("HybridModelv2", 1, 0.0), ("HybridModelv2", 2, 0.0),
         ("HybridModelv2_Comparative", 1, 0.1),
         ("HybridModelv2_Comparative", 2, 0.1)]


@pytest.mark.parametrize("name,decay", [("adam", 0.0), ("adam", 0.01),
                                        ("adamw", 0.01)])
def test_tensor_rate_gives_the_float_rate_bits(name, decay):
    """The CPU's optimizer (``OptimizerConfig.build``: an f64 tensor rate
    that ``apply_lr`` fills) against the same Adam or AdamW with a float
    rate set before each step, from one state and one set of gradients over
    8 steps of the halving schedule: parameters and moments bit for bit.
    (The card's capturable form: ``tests/test_torch_port_cuda.py``,
    ``-k capturable_adam``.)"""
    config = make_optimizer(name, _halving, decay, steps_per_epoch=2)
    rng = np.random.default_rng(0)
    shapes = [(64, 32), (32,), (7, 3, 5)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [torch.from_numpy(1e-3 * rng.standard_normal(s).astype(
        np.float32)) for s in shapes]
    built = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    plain = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt = config.build(built, "cpu")
    cls = torch.optim.AdamW if name == "adamw" else torch.optim.Adam
    ref = cls(plain, lr=config.lr(0), weight_decay=decay)
    assert opt.param_groups[0]["lr"].dtype == torch.float64
    for step in range(8):
        config.apply_lr(opt, step)
        for group in ref.param_groups:
            group["lr"] = config.lr(step)
        for ps in (built, plain):
            for p, g in zip(ps, grads):
                p.grad = g.clone()
        opt.step()
        ref.step()
        _assert_same(built, plain)
        _assert_same([v for p in built for v in opt.state[p].values()],
                     [v for p in plain for v in ref.state[p].values()])
    assert config.lr(7) == 1e-3 * 0.5 ** 3


@pytest.mark.parametrize("name,accum,coeff", CASES)
def test_rehearsed_train_step_equals_the_eager_step(name, accum, coeff):
    """Six steps (two epochs of the halving schedule, batches of 4, 4 and
    3: k=2 takes the 3 unsplit), dropout on, noise drawn: the loss, every
    gradient, parameter and Adam moment of the rehearsed step equal the
    eager ``train_step``'s bit for bit after every step; the loss is a copy
    (not the static output), and the two batch shapes make two keys."""
    trainer = _trainer(name, accum, coeff)
    eager = _state(trainer, name)
    rehearsed = _state(trainer, name)
    program = Program("train step", grads=True)
    for batch in _batches(name):
        eager, want = trainer.train_step(eager, batch, 7)
        got = _rehearsed_step(trainer, program, rehearsed, batch, 7)
        assert torch.equal(got, want)
        params = [list(s.model.parameters()) for s in (eager, rehearsed)]
        _assert_same(*params)
        _assert_same(*([p.grad for p in ps] for ps in params))
        _assert_same(_moments(eager), _moments(rehearsed))
    assert trainer.optimizer.lr(STEPS - 1) == 0.5e-3
    assert rehearsed.optimizer.param_groups[0]["lr"].item() == 0.5e-3
    assert len(program.keys) == 2
    assert trainer.train_program.eager_calls == {"cpu": STEPS}


@pytest.mark.parametrize("name", ["HybridModelv2",
                                  "HybridModelv2_Comparative"])
def test_rehearsed_eval_and_inference_equal_the_eager_calls(name):
    """The eval step, batch inference (``collect_probs``; the twin forward
    for a comparative model) and, for the plain model, the served forward
    (``Scorer``): each rehearsed equals the eager call bit for bit."""
    trainer = _trainer(name)
    model = _model(name)
    batches = _batches(name)[:len(SIZES)]
    program = Program("eval step")
    for i, batch in enumerate(batches):
        want = trainer.eval_step(model, batch, 3, index=i)
        got = program.rehearse(
            functools.partial(trainer._eval_work, model), (batch, None),
            static=trainer._static("eval", model, batch),
            seed=derived_seed(3, i))
        _assert_same(capture.tree_tensors(got), capture.tree_tensors(want))

    class Pipe:
        def epoch(self, _):
            return iter(batches)

    class Config:
        aggregation, compute_dtype = "mega", "float32"

    probs, targets = infer.collect_probs(Config, model, Pipe(), 5)
    forward = functools.partial(infer.forward_logits, model,
                                aggregation="mega",
                                compute_dtype=torch.float32)
    program = Program("batch inference")
    got = []
    with torch.inference_mode():
        for i, batch in enumerate(batches):
            logits = program.rehearse(forward, batch,
                                      seed=derived_seed(5, i))
            got.append(torch.sigmoid(logits.reshape(-1).float()))
    np.testing.assert_array_equal(torch.cat(got).numpy(), probs)
    side = [b.cancer if isinstance(b, ComparativeBatch) else b
            for b in batches]
    np.testing.assert_array_equal(
        torch.cat([b.target for b in side]).numpy(), targets)
    if name == "HybridModelv2":
        scorer = Scorer(model, device="cpu", compute_dtype=torch.float32,
                        aggregation="mega", seed=2)
        req = batches[0]
        args = (req.graph, req.seq_onehot, req.props)
        with torch.inference_mode():
            rehearsed = scorer.program.rehearse(scorer._forward, args,
                                                seed=2)
        np.testing.assert_array_equal(rehearsed.numpy(), scorer(*args))
        assert scorer.program.eager_calls == {"cpu": 1}


def test_rehearsed_steps_meet_jax_train_parity(tmp_path):
    """Three rehearsed steps from JAX's weights (``load_jax_checkpoint``),
    each step's noise replayed from JAX's draws, against the JAX
    ``Trainer``'s steps: the losses (rtol 1e-5), the parameters by
    ``test_torch_port_train.py``'s Adam rule, and the Adam moments within
    that file's gradient rule (1e-5 * the step's largest |gradient| + 1e-4
    * |JAX's gradient|) carried through Adam's averages:
    |mu - mu_JAX| <= sum_k (1 - b1) b1^(n-1-k) e_k and |nu - nu_JAX| <=
    sum_k (1 - b2) b2^(n-1-k) e_k (2 |g_k| + e_k), g_k and e_k JAX's
    gradient of step k and its rule."""
    a = t._arrays(3, seed=0)
    jtrainer, jstate, trainer, state = t._setup("HybridModelv2", tmp_path,
                                                "mega")
    jbatch = t._jax_batch(a)
    batch = t.SampleBatch.from_numpy(a, "cpu")
    program = Program("train step", grads=True)
    key = jax.random.key(7)
    step_grads, jax_grads = [], []
    for step in range(t.STEPS):
        rng = jax.random.fold_in(key, step)
        _, jgrads = jtrainer._loss_and_grads(jstate.params, jbatch, rng)
        jax_grads.append(t._flat(jgrads))
        jstate, jl = jtrainer._train_step(jstate, jbatch, key)
        loss = _rehearsed_step(trainer, program, state, batch, 0,
                               eps=t._plain_eps(rng, 3))
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
        step_grads.append(t._grads_of(state.model))
    t._assert_params_match(state.model, jstate.params, step_grads)
    adam = jstate.opt_state[0]
    mu, nu = t._flat(adam.mu), t._flat(adam.nu)
    b1, b2 = 0.9, 0.999
    n = len(jax_grads)
    for name, p in state.model.named_parameters():
        k = jax_keystr(name)
        bound_mu, bound_nu = 0.0, 0.0
        for i, grads in enumerate(jax_grads):
            g = np.abs(grads[k])
            e = 1e-5 * max(np.abs(v).max() for v in grads.values()) + 1e-4 * g
            bound_mu = bound_mu + (1 - b1) * b1 ** (n - 1 - i) * e
            bound_nu = (bound_nu
                        + (1 - b2) * b2 ** (n - 1 - i) * e * (2 * g + e))
        moments = state.optimizer.state[p]
        assert (np.abs(moments["exp_avg"].numpy() - mu[k])
                <= bound_mu + 1e-12).all(), k
        assert (np.abs(moments["exp_avg_sq"].numpy() - nu[k])
                <= bound_nu + 1e-18).all(), k


def test_keys_follow_shapes_dtypes_and_static_arguments():
    """Two shapes give two keys, another dtype a third, a static argument
    a fourth; a trainer's static arguments name its aggregation (as
    ``gcn_aggregation`` resolves it), variant, dtype, accumulation,
    contrastive switch and twin stacking."""
    program = Program("double")

    def double(x, _):
        return 2 * x

    for x, static in ((torch.ones(2), ()), (torch.ones(2), ()),
                      (torch.ones(3), ()), (torch.ones(3, dtype=torch.float64),
                                            ()), (torch.ones(3), ("other",))):
        out = program.rehearse(double, x, static=static, seed=0)
        torch.testing.assert_close(out, 2 * x)
    assert len(program.keys) == 4
    model = _model("HybridModelv2")
    batch = random_sample_batch(2, N, E, L, seed=1)
    trainer = _trainer("HybridModelv2")
    base = trainer._static("train", model, batch)
    assert base[:2] == ("train", "mega")
    for field, value in (("mega_variant", "paired"),
                         ("compute_dtype", torch.bfloat16),
                         ("grad_accum_steps", 2), ("coeff_contrastive", 0.1),
                         ("stack_twins", True), ("aggregation", "scatter")):
        other = _trainer("HybridModelv2")
        setattr(other, field, value)
        assert other._static("train", model, batch) != base, field
    assert trainer._static("eval", model, batch) != base


def test_capture_asked_for_on_the_cpu_raises():
    """``capture=True`` on CPU tensors raises (the Trainer's steps, the
    Scorer, a Program under a caller's eager rule); None runs eagerly and
    counts "cpu", False counts "asked"."""
    batch = random_sample_batch(2, N, E, L, seed=1)
    trainer = _trainer("HybridModelv2", capture_flag=True)
    state = _state(trainer, "HybridModelv2")
    with pytest.raises(ValueError, match="capture needs a CUDA device"):
        trainer.train_step(state, batch, 0)
    with pytest.raises(ValueError, match="capture needs a CUDA device"):
        trainer.eval_step(state.model, batch, 0)
    scorer = Scorer(state.model, device="cpu", aggregation="mega",
                    capture=True)
    with pytest.raises(ValueError, match="capture needs a CUDA device"):
        scorer(batch.graph, batch.seq_onehot, batch.props)
    with pytest.raises(ValueError, match="capture needs a CUDA device"):
        artifact = type("Artifact", (), {"device": "cpu",
                                         "module": torch.nn.Linear(1, 1)})
        ArtifactScorer(artifact(), capture=True)(torch.ones(1))
    program = Program("p", capture=True)
    with pytest.raises(ValueError, match="under data-parallel"):
        program.eager_reason(torch.device("cuda"), "data-parallel")
    off = _trainer("HybridModelv2", capture_flag=False)
    state = _state(off, "HybridModelv2")
    off.train_step(state, batch, 0)
    off.eval_step(state.model, batch, 0)
    assert off.train_program.eager_calls == {"asked": 1}
    assert off.eval_program.eager_calls == {"asked": 1}
    auto = Program("p")
    assert auto.eager_reason(torch.device("cpu")) == "cpu"
    assert auto.eager_reason(torch.device("cuda")) is None
    assert auto.eager_reason(torch.device("cuda"), "data-parallel") == \
        "data-parallel"


class _Rehearsed(Program):
    """A Program whose graph is its rehearsal, so that the CPU runs
    ``__call__``'s keys, its state marks, its drops and its counts: the
    capture keeps the work, a replay runs it on the static inputs."""

    def eager_reason(self, device, eager=None):
        return eager

    def _warm_up(self, fn, key, inputs, seed, state):
        out = self.rehearse(fn, inputs, static=key[0], seed=seed)
        self._entries[key].marks = capture._marks(state())
        return out

    def _capture(self, fn, key, entry, state):
        entry.graph = fn
        self.captures += 1

    def _replay(self, entry, inputs, seed, state):
        self._load(entry, inputs)
        self._generator.manual_seed(seed)
        self.replays += 1
        return tree_map(torch.clone, entry.graph(entry.inputs,
                                                 self._generator))


def test_replaced_state_drops_the_program(tmp_path):
    """Through ``_Rehearsed``: warm-up, capture, replays; then each
    replacement of state tensors drops the key and starts it again from its
    warm-up: a resumed optimizer (``load_resume_state``; its rate stays the
    tensor the graph reads), a new classifier (``reset_head``) and a new
    optimizer (``init_state``, as ``--reinit-on-collapse`` and each stage of
    ``train_model`` make one). A resume that only copies into the same
    tensors (the model's ``load_state_dict``) keeps it. Every step equals
    the eager trainer's bit for bit."""
    name = "HybridModelv2"
    trainer = _trainer(name)
    trainer.train_program = program = _Rehearsed("train step", grads=True)
    eager_trainer = _trainer(name)
    state, eager = _state(trainer, name), _state(eager_trainer, name)
    batch = random_sample_batch(4, N, E, L, seed=3)

    def steps(k):
        nonlocal state, eager
        for _ in range(k):
            state, got = trainer.train_step(state, batch, 1)
            eager, want = eager_trainer.train_step(eager, batch, 1)
            assert torch.equal(got, want)
            _assert_same(list(state.model.parameters()),
                         list(eager.model.parameters()))

    steps(3)
    assert (program.eager_calls["first call"], program.captures,
            program.replays, program.dropped) == (1, 1, 2, 0)
    path = str(tmp_path / "snap.resume")
    save_resume_state(path, state, 0, 1.0)
    save_resume_state(str(tmp_path / "eager.resume"), eager, 0, 1.0)
    state.model.load_state_dict(state.model.state_dict())   # in place
    steps(1)
    assert program.dropped == 0 and program.replays == 3
    rate = state.optimizer.param_groups[0]["lr"]
    load_resume_state(path, state)
    load_resume_state(str(tmp_path / "eager.resume"), eager)
    assert state.optimizer.param_groups[0]["lr"] is rate
    steps(3)
    assert (program.dropped, program.captures, program.replays) == (1, 2, 5)
    for s in (state, eager):
        reset_head(s.model, torch.Generator().manual_seed(4))
    steps(2)
    assert (program.dropped, program.captures, program.replays) == (2, 3, 6)
    state = trainer.init_state(state.model)
    eager = eager_trainer.init_state(eager.model)
    steps(3)
    assert (program.dropped, program.captures, program.replays,
            program.eager_calls["first call"]) == (3, 4, 8, 4)


def test_capture_module_imports_no_jax_and_no_model_code():
    """``utils/capture.py`` reads only torch and the ops package's launch
    counters (the wrappers' modules are imported when a graph is
    captured)."""
    src = open(os.path.join(os.path.dirname(capture.__file__),
                            "capture.py")).read()
    assert "import jax" not in src and "immunostruct_tpu." not in src
    assert "from immunostruct_tpu_torch.models" not in src
