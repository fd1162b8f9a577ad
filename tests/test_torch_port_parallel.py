"""Data parallelism in the port (immunostruct_tpu_torch/parallel/{mesh,
trainer}.py and the hooks in procedures/train.py, cli/common.py), on the
CPU: gloo ranks spawned once a group size for the module
(tests/torch_parallel_ranks.py, JAX-free).

- the sharded step (``make_sharded_trainer``) at world 2 and 4 against the
  port's one-process step on the global batch, with the step's noise on
  (dropout 0.1 and the VAE draws): loss within rel 1e-5, parameters after
  each of two steps within rtol 2e-5, atol 2e-6 (JAX's test_parallel.py
  bounds; the attention key biases, whose true gradient is zero, within
  Adam's lr a step, see KEY_BIASES); the comparative step with
  contrastive 0.1, the SSL model and a step with gradient accumulation
  (k=2) likewise, and the twin step with k=2 and
  ``allow_microbatch_contrastive`` (each rank's microbatch its share of
  the global one);
- the twin step's control at the published widths (N=32, E=128, B=16):
  the one-process step on its rows reversed parts from itself by hundreds
  of JAX's bounds, at entries whose gradient is rounding noise; it and two
  ranks (noise pinned and dropout off, and both on) meet
  ``dryrun.twin_excess``'s rule, and two ranks with a fault planted in the
  gather of the contrastive term's embeddings fail it;
- the port's sharded step from the JAX package's weights against JAX's
  ``make_sharded_trainer`` step on a 2-device sub-mesh, with JAX's noise
  replayed: loss within rtol 1e-5, gradients and parameters to the
  port-against-JAX step tolerance of test_torch_port_train.py;
- ``shard_map_train_step`` with the ring against psum: loss within rel
  1e-5, parameters within rtol 1e-4, atol 1e-6 (JAX's);
- a sharded ``fit`` (two epochs with checkpoint, resume snapshot and
  collapse guard) equal to the one-process fit, rank 0 alone writing; a
  guard that fires stops every rank at the same epoch;
- a batch the world does not divide raises, naming both numbers, before
  the first step too;
- ``shard_indices_for_process``: the three cases of JAX's
  test_multihost.py, against JAX's function;
- ``--data-parallel`` at world 1 (a group of one) in train_IEDB_wFT,
  train_Cancer_wFT (also with ``--grad-accum-steps 2
  --allow-microbatch-contrastive``) and train_curriculum: the checkpoint
  bits of the run without it; ``train_IEDB_wFT --data-parallel`` at world
  2 within tolerance of them, rank 0 alone writing files, and with
  ``--wandb-username`` and a stand-in wandb module rank 0 alone opening
  the run and logging every JSONL line.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from immunostruct_tpu.parallel.mesh import (
    shard_batch as jax_shard_batch,
    shard_indices_for_process as jax_shard_indices,
)
from immunostruct_tpu.parallel.trainer import (
    make_sharded_trainer as jax_make_sharded_trainer,
)
from immunostruct_tpu_torch.cli import train_IEDB_wFT
from immunostruct_tpu_torch.data.synthetic import (
    synthetic_comparative_corpus, synthetic_corpus,
)
from immunostruct_tpu_torch.parallel import dryrun as D
from immunostruct_tpu_torch.parallel.dryrun import StepCase, spawn
from immunostruct_tpu_torch.parallel.mesh import (
    shard_indices_for_process, shard_rows, world,
)
from immunostruct_tpu_torch.parallel.trainer import check_shardable
from tests import torch_parallel_ranks as ranks
from tests.test_torch_port_train import (
    LR, SMALL, L, _arrays, _assert_params_match, _jax_batch, _plain_eps,
    _setup,
)

CASE = StepCase(name="HybridModelv2", b=8, nodes=16, edges=64, seq_len=8,
                overrides=tuple(dict(gcn_layers=2, gat_hidden_channels=16,
                                     vae_hidden_dim=32,
                                     vae_latent_dim=8).items()))
CASES = {
    "plain": CASE,
    "comparative": dataclasses.replace(
        CASE, name="HybridModelv2_Comparative", coeff=0.1),
    "ssl": dataclasses.replace(CASE, name="HybridModelv2_SSL", ssl=True),
}
# the twin step's control at the published widths (H=64, projector
# 104->128->128, VAE 284*21->512->32), at N=32, E=128 and a global B=16:
# dropout 0 and the VAE noise pinned (twin_fixed), and the twin step with
# its noise on (twin)
CONTROL_CASE = StepCase(name="HybridModelv2_Comparative", b=16, nodes=32,
                        edges=128, seq_len=284, coeff=0.1)
CONTROL = {
    "twin_fixed": dataclasses.replace(
        CONTROL_CASE, overrides=(("dropout_rate", 0.0),), pinned=True),
    "twin": CONTROL_CASE,
}

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this file's small models (the spawned ranks
    take one each too): under the suite's workers, more threads a process
    only contend for the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("corpus"))
    return synthetic_corpus(root, num_samples=20, hla_len=20, seed=11,
                            planted_signal=True)


@pytest.fixture(scope="module")
def world4():
    return spawn(ranks.dp_cases, 4, CASES)


def _cli_args(corpus, save_dir, *flags):
    graph_dir, props, hla = corpus
    return ["--model", "HybridModelv2", "--full-sequence", "--sequence-loss",
            "--aggregation", "scatter", "--compute-dtype", "float32",
            "--batch-size", "4", "--num-epochs", "2", "--device", "cpu",
            "--seed", "2", "--model-save-dir", save_dir,
            "--graph-dir-IEDB", graph_dir, "--property-path-IEDB", props,
            "--hla-path", hla, *flags]


@pytest.fixture(scope="module")
def world2(corpus, tmp_path_factory):
    """One group of two for every world-2 check."""
    tmp = tmp_path_factory.mktemp("world2")
    jt, js, _, _ = _setup("HybridModelv2", tmp, "scatter")
    from immunostruct_tpu.utils.checkpoint import save_checkpoint
    save_checkpoint(str(tmp / "jax.ckpt"), js.params)
    a = _arrays(4, seed=3)
    key = jax.random.key(7)
    out = {"jax": (jt, js, a, key)}
    eps = _plain_eps(jax.random.fold_in(key, 0), 4).numpy()
    fits = [str(tmp / "fit_dp"), str(tmp / "fit_ref")]
    for d in fits:
        os.makedirs(d)
    entry = str(tmp / "entry_dp2")
    runs = spawn(ranks.world2, 2, CASES, corpus,
                 (str(tmp / "jax.ckpt"), a, eps, SMALL, L, LR), fits,
                 _cli_args(corpus, entry, "--data-parallel",
                           "--wandb-username", "someone"), CONTROL)
    out.update(runs=runs, fits=fits, entry=entry)
    return out


# the attention key biases: a softmax does not change when one number is
# added to every key, so their true gradient is zero and what both sides
# compute there is rounding noise, which Adam scales to a step of up to lr
# (test_torch_port_train.py); over several steps they may part by lr a step
KEY_BIASES = D.KEY_BIASES + ("['key']['b']", "['w_k']['b']")


def _assert_params_close(got, want, lr, steps, rtol=1e-4, atol=1e-5):
    for k, w in want.items():
        w = np.asarray(w)
        tol = (dict(rtol=0.0, atol=lr * steps) if k.endswith(KEY_BIASES)
               else dict(rtol=rtol, atol=atol))
        np.testing.assert_allclose(np.asarray(got[k]), w, err_msg=k, **tol)


def _assert_step_matches(runs, name):
    """Losses within rel 1e-5, parameters after the steps within JAX's
    rtol 2e-5, atol 2e-6 (the key biases within lr a step)."""
    ref = runs[0][name + "/ref"]
    for r in runs:
        got = r[name]
        for loss, want in zip(got["losses"], ref["losses"]):
            assert loss == pytest.approx(want, rel=1e-5)
        _assert_params_close(got["params"], ref["params"], 1e-3,
                             len(ref["losses"]), rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("n", [2, 4])
def test_sharded_step_matches_one_process(world2, world4, n, name):
    runs = ([r["cases"] for r in world2["runs"]] if n == 2 else world4)
    assert runs[0][name]["rows"] == CASE.b // n
    _assert_step_matches(runs, name)
    # the step ran the plain version on the CPU: no kernel launched
    assert not any(runs[0][name]["launches"].values())


def test_no_rank_loads_jax(world2, world4):
    assert not any(r["jax"] for r in world4)
    for r in world2["runs"]:
        assert not (r["cases"]["jax"] or r["fit"]["jax"]
                    or r["entry"]["jax"])


def test_sharded_step_with_accumulation_matches_one_process(world2):
    ref = world2["runs"][0]["accum"]["ref"]
    for r in world2["runs"]:
        got = r["accum"]
        assert got["loss"] == pytest.approx(ref["loss"], rel=1e-5)
        _assert_params_close(got["params"], ref["params"], 1e-3, 1,
                             rtol=2e-5, atol=2e-6)


def test_sharded_twin_step_with_microbatch_contrastive_matches_one_process(
        world2):
    """The twin step (contrastive 0.1, noise on) with grad_accum_steps=2
    and the opt-in: a rank's k-th microbatch is its share of the global
    k-th, whose contrastive statistics every rank takes (the gathered
    embeddings), so the step is the one-process step's."""
    ref = world2["runs"][0]["accum_twin"]["ref"]
    for r in world2["runs"]:
        got = r["accum_twin"]
        assert got["loss"] == pytest.approx(ref["loss"], rel=1e-5)
        _assert_params_close(got["params"], ref["params"], 1e-3, 1,
                             rtol=2e-5, atol=2e-6)


def test_twin_control_stays_within_the_noise_rule(world2):
    """The twin step at the published widths, one Adam step. The
    one-process step parts from itself, when the batch's rows are
    reversed, by far more than JAX's bounds (parameters: rtol 2e-5, atol
    2e-6; gradients: the dry run's rtol 2e-4, atol 2e-4 * max|g|): the
    step is ill-conditioned in the order of its sums. Under
    ``dryrun.twin_excess``'s rule (an absolute gradient term of 1e-5 of
    the step's largest gradient; parameters past JAX's bound only where
    the reference gradient is nonzero and below that, entries it drops and
    counts) the reversed step reads within 1, and so do two gloo ranks,
    with the noise pinned and dropout off and with both on."""
    runs = [r["control"] for r in world2["runs"]]
    ref = runs[0]["twin_fixed/ref"]
    rev = runs[0]["twin_fixed/reversed"]
    assert rev["losses"][0] == pytest.approx(ref["losses"][0], rel=1e-6)
    assert D.worst_excess(rev["params"], ref["params"], 2e-5, 2e-6) > 10
    assert D.worst_grad_excess(rev["grads"], ref["grads"]) > 10
    floor = D.twin_excess(rev, ref)
    assert floor["grads"] <= 1.0 and floor["params"] <= 1.0, floor
    assert 0 < floor["dropped"] < floor["entries"] // 2, floor
    for name in CONTROL:
        want = runs[0][name + "/ref"]
        for r in runs:
            got = r[name]
            assert got["losses"][0] == pytest.approx(want["losses"][0],
                                                     rel=2e-5)
            rule = D.twin_excess(got, want)
            assert rule["grads"] <= 1.0 and rule["params"] <= 1.0, (name,
                                                                   rule)


@pytest.mark.parametrize("fault", list(ranks.GATHER_FAULTS))
def test_twin_rule_fails_a_fault_in_the_gather(world2, fault):
    """The same control step with a fault planted in the gather of the
    contrastive term's embeddings (the adjoint without the sum over the
    ranks; the last rank's rows scaled by 1.001) parts from the
    one-process step by far more than ``dryrun.twin_excess``'s rule, in
    its gradients and in its parameters, on every rank."""
    want = world2["runs"][0]["control"]["twin_fixed/ref"]
    for r in world2["runs"]:
        rule = D.twin_excess(r["faults"][fault], want)
        assert rule["grads"] > 10 and rule["params"] > 10, rule


def test_wandb_run_opens_on_rank_0_alone(world2):
    """train_IEDB_wFT --data-parallel --wandb-username at world 2 with a
    stand-in wandb module in each rank: rank 0 calls init once, logs every
    line of the JSONL file it writes, then finish; rank 1 calls nothing."""
    calls = [r["entry"]["wandb"] for r in world2["runs"]]
    assert calls[1] == []
    names = [c[0] for c in calls[0]]
    assert names[0] == "init" and names[-1] == "finish"
    assert names.count("init") == names.count("finish") == 1
    init = calls[0][0][2]
    assert (init["project"], init["entity"]) == ("ImmunoPred-IEDB-MIT",
                                                 "someone")
    logged = [{k: float(v) if hasattr(v, "__float__") else v
               for k, v in c[1][0].items()} for c in calls[0][1:-1]]
    jsonl = [f for f in os.listdir(world2["entry"])
             if f.endswith(".metrics.jsonl")]
    with open(os.path.join(world2["entry"], jsonl[0])) as fh:
        lines = [json.loads(line) for line in fh]
    assert len(lines) == len(logged) > 0
    np.testing.assert_equal(logged, lines)


def test_sharded_step_matches_jax_sharded_trainer(world2):
    """JAX's GSPMD step over 2 devices and the port's over 2 ranks, from
    the same weights with the same noise."""
    from immunostruct_tpu.procedures.train import make_optimizer
    from immunostruct_tpu.utils.losses import LossConfig
    from immunostruct_tpu.utils.schedule import constant_lr

    jt, js, a, key = world2["jax"]
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    sharded = jax_make_sharded_trainer(
        jt.spec, LossConfig(L * 21, pos_weight=1.0, sequence=True),
        binary=True, optimizer=make_optimizer("adam", constant_lr(LR)),
        mesh=mesh, aggregation="scatter", donate=False)
    state = sharded.init_state(js.params)
    jbatch = _jax_batch(a)
    state, jloss = sharded._train_step(state, jax_shard_batch(jbatch, mesh),
                                       key)
    _, jgrads = jt._loss_and_grads(js.params, jbatch,
                                   jax.random.fold_in(key, 0))
    flat, _ = jax.tree.flatten_with_path(jgrads)
    jg = {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}
    gmax = max(np.abs(v).max() for v in jg.values())
    for r in world2["runs"]:
        got = r["jax"]
        assert got["loss"] == pytest.approx(float(jloss), rel=1e-5)
        for k, w in jg.items():
            assert (np.abs(got["grads"][k] - w)
                    <= 1e-5 * gmax + 1e-4 * np.abs(w)).all(), k
        _assert_params_match_arrays(got["params"], state.params, [jg])


def _assert_params_match_arrays(got, jparams, step_grads):
    """test_torch_port_train.py's parameter tolerance on arrays."""
    from tests import test_torch_port_train as t

    real = t.jax_params
    t.jax_params = lambda _: got
    try:
        _assert_params_match(None, jparams, step_grads)
    finally:
        t.jax_params = real


def test_shard_map_ring_matches_psum(world2):
    for r in world2["runs"]:
        psum, ring = r["ring"]["psum"], r["ring"]["ring"]
        assert ring["loss"] == pytest.approx(psum["loss"], rel=1e-5)
        for k, want in psum["params"].items():
            np.testing.assert_allclose(ring["params"][k].numpy(),
                                       want.numpy(), rtol=1e-4, atol=1e-6)


def test_sharded_fit_matches_one_process_and_rank0_writes(world2):
    runs = world2["runs"]
    ref = runs[0]["fit"]["ref"]
    for r in runs:
        dp = r["fit"]["dp"]
        np.testing.assert_allclose(dp["history"]["train_loss"],
                                   ref["history"]["train_loss"], rtol=1e-5)
        np.testing.assert_allclose(dp["history"]["val_loss"],
                                   ref["history"]["val_loss"], rtol=1e-5)
        np.testing.assert_allclose(dp["history"]["val_auc"],
                                   ref["history"]["val_auc"], rtol=1e-6)
        assert dp["history"]["train_samples"] == \
            ref["history"]["train_samples"]
        assert dp["fired"] == ref["fired"]
        steps = 2 * len(ref["history"]["train_loss"])   # 12 rows, batch 4
        _assert_params_close(dp["params"], ref["params"], 1e-2, steps + 1)
    # rank 0 wrote the checkpoint and both snapshots, rank 1 nothing
    assert runs[0]["fit"]["dp"]["writes"] == ref["writes"]
    assert "ckpt" in ref["writes"] and ref["writes"].count("resume") == 2
    assert runs[1]["fit"]["dp"]["writes"] == []
    names = sorted(os.listdir(world2["fits"][0]))
    assert names == sorted(os.listdir(world2["fits"][1]))
    assert not any(n.endswith(".resume") for n in names)


def test_collapse_guard_decides_alike_on_every_rank(world2):
    decisions = [r["fit"]["collapse"] for r in world2["runs"]]
    assert decisions[0] != "no collapse" and decisions[0][0] == 0
    assert all(d == decisions[0] for d in decisions)


def test_non_divisible_batch_raises(world2):
    for r in world2["runs"]:
        assert "a batch of 3 rows does not divide over 2 ranks" in r["odd"]
    with pytest.raises(ValueError, match="6 rows does not divide over 4"):
        shard_rows(6, 0, 4)
    with pytest.raises(ValueError, match="microbatch of 3 rows"):
        shard_rows(6, 0, 2, microbatches=2)
    np.testing.assert_array_equal(shard_rows(8, 1, 2, microbatches=2),
                                  [2, 3, 6, 7])


def test_check_shardable_fails_before_the_first_step():
    class Pipe:
        indices, batch_size, pad_final_batch = np.arange(10), 4, False

    class Trainer:
        grad_accum_steps, data_axis = 1, "data"

        class mesh:
            @staticmethod
            def size(axis):
                return 4

    # 10 rows in batches of 4: the trailing batch of 2
    with pytest.raises(ValueError, match="train_pipe: a batch of 2 rows"):
        check_shardable(Trainer, train_pipe=Pipe)
    Pipe.pad_final_batch = True              # 4, 4, 4: each divides
    check_shardable(Trainer, train_pipe=Pipe)
    Pipe.batch_size = 6                      # 6, 6: neither does
    with pytest.raises(ValueError, match="val_pipe: a batch of 6 rows"):
        check_shardable(Trainer, val_pipe=Pipe)


def test_check_shardable_checks_each_microbatch():
    """Under accumulation (the contrastive term's opt-in among its users) a
    rank keeps its share of each global microbatch, so a microbatch the
    data axis does not divide fails before the first step: 12 rows in
    batches of 6, k=2, over 2 ranks (microbatches of 3)."""
    class Pipe:
        indices, batch_size, pad_final_batch = np.arange(12), 6, False

    class Trainer:
        grad_accum_steps, data_axis = 2, "data"

        class mesh:
            @staticmethod
            def size(axis):
                return 2

    with pytest.raises(ValueError, match="a microbatch of 3 rows"):
        check_shardable(Trainer, train_pipe=Pipe)
    Pipe.batch_size = 4                       # microbatches of 2
    check_shardable(Trainer, train_pipe=Pipe)


def test_reversed_rows_and_twin_excess():
    """The control's tools: a batch's rows reversed alike in every tensor
    (both twins and the target); ``twin_excess`` on made-up steps: the
    absolute gradient term, a parameter entry dropped where the reference
    gradient is nonzero and below it, and held where that gradient is
    exactly zero or above it."""
    batch = D.case_batch(CONTROL_CASE, "cpu")
    got = D.reversed_rows(batch)
    for t_got, t_want in ((got.cancer.props, batch.cancer.props),
                          (got.wt.seq_onehot, batch.wt.seq_onehot),
                          (got.cancer.target, batch.cancer.target),
                          (got.wt.graph.edge_src, batch.wt.graph.edge_src)):
        assert torch.equal(t_got, t_want.flip(0))
    g = torch.tensor([1.0, 1e-6, 0.0, 1e-4], dtype=torch.float64)
    w = torch.ones(4, dtype=torch.float64)
    ref = {"grads": {"a": g}, "params": {"a": w}}

    def rule(dg, dw):
        return D.twin_excess({"grads": {"a": g + dg}, "params": {"a": w + dw}},
                             ref)

    out = rule(torch.zeros(4), torch.tensor([0.0, 1e-3, 0.0, 0.0]))
    assert (out["params"], out["dropped"], out["entries"]) == (0.0, 1, 4)
    assert out["nu"] == pytest.approx(1e-5)
    for i in (0, 2, 3):          # held: |g| at or above nu, or exactly 0
        dw = torch.zeros(4, dtype=torch.float64)
        dw[i] = 2.2e-5           # (atol + rtol |w|) * 1.0
        assert rule(torch.zeros(4), dw)["params"] == pytest.approx(1.0)
    dg = torch.tensor([0.0, 0.0, 1e-5 + 2e-4, 0.0], dtype=torch.float64)
    out = rule(dg, torch.zeros(4))
    assert out["grads"] == pytest.approx(1.0) and out["grads_at"] == "a"


@pytest.mark.parametrize("case", ["disjoint", "remainder", "tiny"])
def test_shard_indices_for_process_matches_jax(case):
    idx = {"disjoint": np.random.default_rng(0).permutation(64),
           "remainder": np.arange(10), "tiny": np.arange(3)}[case]
    parts = [shard_indices_for_process(idx, pi, 4) for pi in range(4)]
    for pi, part in enumerate(parts):
        np.testing.assert_array_equal(part, jax_shard_indices(idx, pi, 4))
    if case == "tiny":
        np.testing.assert_array_equal(parts[1], idx)
    else:
        flat = np.concatenate(parts)
        assert len(set(flat.tolist())) == len(flat) == len(idx) // 4 * 4
    # without arguments: this process alone
    np.testing.assert_array_equal(shard_indices_for_process(idx), idx)


def _checkpoints(save_dir):
    return {f: dict(np.load(os.path.join(save_dir, f)))
            for f in sorted(os.listdir(save_dir)) if f.endswith(".ckpt")}


@pytest.fixture(scope="module")
def comparative(corpus, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("comparative"))
    return synthetic_comparative_corpus(root, num_samples=20, hla_len=20,
                                        seed=12, shared_hla_path=corpus[2])


def _entry_args(entry, corpus, comparative, save_dir, *flags):
    if entry == "IEDB":
        return _cli_args(corpus, save_dir, *flags)
    (g, p, h), (dc, dw, pc, pw, _) = corpus, comparative
    argv = ["--model", "HybridModelv2_Comparative", "--full-sequence",
            "--sequence-loss", "--aggregation", "scatter",
            "--compute-dtype", "float32", "--batch-size", "4",
            "--num-epochs", "1", "--device", "cpu", "--seed", "1",
            "--min-finetuning-batches", "2", "--model-save-dir", save_dir,
            "--graph-dir-IEDB", g, "--property-path-IEDB", p,
            "--hla-path", h, "--graph-dir-cancer", dc,
            "--graph-dir-wildtype", dw, "--property-path-cancer", pc,
            "--property-path-wildtype", pw, *flags]
    if entry == "Cancer":
        return argv + ["--coeff-contrastive", "0.1", "--skip-clinical"]
    if entry == "Cancer_accumulated":
        return argv + ["--coeff-contrastive", "0.1", "--skip-clinical",
                       "--grad-accum-steps", "2",
                       "--allow-microbatch-contrastive"]
    return argv + ["--stages", "PropIEDB,ImmunoCancer", "--comparative"]


@pytest.mark.parametrize("entry", ["IEDB", "Cancer", "curriculum",
                                   "Cancer_accumulated"])
def test_entry_point_data_parallel_world1_same_bits(corpus, comparative,
                                                    tmp_path, entry):
    """train_IEDB_wFT, train_Cancer_wFT (contrastive 0.1; also with
    --grad-accum-steps 2 --allow-microbatch-contrastive) and
    train_curriculum with --data-parallel in a group of one (gloo on the
    CPU): the checkpoints of the run without it, bit for bit, and the
    same stats."""
    from immunostruct_tpu_torch.cli import train_Cancer_wFT, train_curriculum

    main = {"IEDB": train_IEDB_wFT, "Cancer": train_Cancer_wFT,
            "curriculum": train_curriculum,
            "Cancer_accumulated": train_Cancer_wFT}[entry].main
    runs = {}
    for tag, flags in (("plain", ()), ("dp", ("--data-parallel",))):
        save_dir = str(tmp_path / tag)
        runs[tag] = (main(_entry_args(entry, corpus, comparative, save_dir,
                                      *flags)),
                     _checkpoints(save_dir))
        assert world() == (0, 1) and not torch.distributed.is_initialized()
    (stats_p, ck_p), (stats_d, ck_d) = runs["plain"], runs["dp"]
    assert ck_p.keys() == ck_d.keys() and len(ck_p) == 2
    for f in ck_p:
        assert ck_p[f].keys() == ck_d[f].keys()
        for k in ck_p[f]:
            assert np.array_equal(ck_p[f][k], ck_d[f][k]), (f, k)
    np.testing.assert_equal(stats_p, stats_d)       # nan == nan here


def test_train_IEDB_wFT_data_parallel_world2(world2, corpus, tmp_path):
    """Two ranks: the same files as one process, rank 0 writing them, and
    checkpoints within tolerance of the one-process run's."""
    save_dir = str(tmp_path / "plain")
    stats = train_IEDB_wFT.main(_cli_args(corpus, save_dir))
    want = _checkpoints(save_dir)
    r0, r1 = world2["runs"][0]["entry"], world2["runs"][1]["entry"]
    assert r0["files"] == r1["files"] == sorted(os.listdir(save_dir))
    got = r0["ckpt"]
    assert got.keys() == want.keys()
    for f in want:
        # two stages of two epochs, four steps an epoch
        _assert_params_close(got[f], want[f], 1e-3, 16)
    train, _ = stats
    assert r0["train"].keys() == r1["train"].keys() == train.keys()
    np.testing.assert_equal(r0["test"], r1["test"])
