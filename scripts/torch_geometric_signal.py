"""Geometric learnability of the PyTorch port (immunostruct_tpu_torch), the
counterpart of scripts/geometric_signal.py.

Trains StructureModel on a corpus whose label is a function of the
coordinates alone (the peptide tail compacted; sequence and properties
carry nothing: data/synthetic.py ``geometric_signal``), through each
aggregation path of the EGNN stack, and SequenceFpModel on the same corpus
as the negative control. On the card every path but 'scatter' trains
through its hand-written kernels (bf16, pads 8/128, batch 32, 512 samples,
14 epochs, Adam at 1e-3, the finetune stage); the launch counters say
which kernels each run launched. ``--cpu`` takes the JAX package's CPU
settings (f32, 'scatter', pads 4/16).

A path passes when, over its seeds (0-15 by default), the median test
AUROC is above 0.8 and the median train AUROC above 0.85 (the JAX repo's
bounds), every run's losses are finite, the median run's last train loss
is below its first, it learned (test AUROC above 0.8) at no fewer than
LEARNED_SLACK seeds fewer than 'scatter' did, and (on the card) it
launched the kernels it exists for (PATH_KERNELS) and none that belongs to
another path alone; the control passes when its median test AUROC is
within 0.22 of 0.5 and its losses are finite. Every path, 'scatter'
included, is held to all of it. This recipe (Adam at 1e-3, no clipping, an
EGNN without normalisation) diverges at some seeds on every path, in the
JAX package as in the port, so the bounds are held on many seeds (sixteen
here, chip_smoke.py's phase 32 eight), not on three (PERF.md §6). In bf16
'scatter' sums at a node in edge order, each add rounded, as JAX's does; in
f32 on the card it runs under ``torch.use_deterministic_algorithms``, so
that its sums take a fixed order (a sort) rather than atomics: either way a
seed gives one trajectory, as every kernel path does. The 'auto' runs also score the test
split through the served forward with ``fused_stack=True`` (B7): no
further from the 'mega' forward and from the plain 'scatter' forward than
'mega' is from 'scatter', give or take PROB_ATOL; at FIRST_SEEDS also
within PROB_ATOL of 'mega' and its AUROC within AUROC_ATOL.

  python scripts/torch_geometric_signal.py                # the card, every path, seeds 0-15
  python scripts/torch_geometric_signal.py --cpu          # 'scatter' on the CPU
  python scripts/torch_geometric_signal.py --paths auto fused --seeds 0
  python scripts/torch_geometric_signal.py --paths auto scatter --seeds 1 \
      --init tests/data/geomsig_init_key0.npz  # from the JAX package's start
  python scripts/torch_geometric_signal.py --compute-dtype float32 --paths scatter --seeds 0 1

The last line of the output is one JSON object; the exit code is 1 when a
bound is missed.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from typing import Optional

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

# path -> (aggregation, mega_variant)
PATHS = {
    "scatter": ("scatter", "hybrid"),
    "auto": ("auto", "hybrid"),
    "dboth": ("mega", "dboth"),
    "inkernel": ("mega", "inkernel"),
    "stack": ("mega", "stack"),
    "fused": ("fused", "hybrid"),
    "pallas": ("pallas", "hybrid"),
}
# the kernels (ops/__init__.py::launch_counters' keys) each path exists
# for; B4 ('paired') has no training pipeline, B7 is forward only
PATH_KERNELS = {
    "scatter": (),
    "auto": ("B1", "B2", "B8_scatter"),
    "dboth": ("B1", "B5a"),
    "inkernel": ("B1", "B5b"),
    "stack": ("B6", "B2"),
    "fused": ("B3_fwd", "B3_bwd", "B8_scatter", "B8_gather"),
    "pallas": ("B8_scatter", "B8_gather"),
}
# scripts/geometric_signal.py:98-99, tests/test_learnability.py:101-102
TEST_AUROC_MIN = 0.8
TRAIN_AUROC_MIN = 0.85
CONTROL_HALF_WIDTH = 0.22
# the served forward's bound against another path (PERF.md §2)
PROB_ATOL = 5e-4
AUROC_ATOL = 0.01
# the first three seeds: there B7 is also held to PROB_ATOL of 'mega' and
# to AUROC_ATOL; the models of other seeds grow features large enough that
# a sum taken in another order moves a probability past 5e-4, on the
# reference paths too ('mega' - 'scatter' up to 0.011, PERF.md §6)
FIRST_SEEDS = (0, 1, 2)
SEEDS = tuple(range(16))
# a path may learn at this many fewer seeds than 'scatter': about two
# standard deviations of the count over 8 to 16 draws at the plain path's
# rate (13 of 16, PERF.md §6)
LEARNED_SLACK = 2
CORPUS_SEED = 17
# the JAX package's own start (scripts/geometric_signal.py:52-55): its
# StructureModel at jax.random.key(0), trained with split and shuffle seed
# 1 (immunostruct_tpu/config.py:70), as its TPU run did
INIT_KEY0 = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests", "data", "geomsig_init_key0.npz")
JAX_START_SEED = 1


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def corpus(root: str, samples: int) -> tuple:
    """The geometric corpus (seed 17) under ``root``, written once."""
    from immunostruct_tpu_torch.data.synthetic import synthetic_corpus

    where = os.path.join(root, f"corpus_{samples}")
    done = os.path.join(where, "written")
    paths = (os.path.join(where, "graph_pyg_IEDB"),
             os.path.join(where, "props_IEDB.tsv"),
             os.path.join(where, "HLA_seqs.csv"))
    if not os.path.exists(done):
        got = synthetic_corpus(where, num_samples=samples, seed=CORPUS_SEED,
                               geometric_signal=True)
        assert tuple(got) == paths, got
        open(done, "w").close()
    return paths


def fit(config, model, train_pipe, val_pipe, loss_cfg, *,
        learning_rate: float, mega_variant: str):
    """``procedures/train.py::train_model`` for one finetune stage, its
    Trainer built with ``mega_variant``. Returns (model, history)."""
    from immunostruct_tpu_torch.procedures.train import (
        CollapseGuard, Trainer, make_optimizer, train_model,
    )
    from immunostruct_tpu_torch.utils.schedule import constant_lr

    if mega_variant == "hybrid":
        return train_model(config, model, train_pipe, val_pipe, loss_cfg,
                           binary=True, learning_rate=learning_rate,
                           stage="finetune", verbose=False)
    # train_model's trainer (procedures/train.py:623-667) for a finetune
    # stage: no data parallelism, no resume, the guard without re-init
    optimizer = make_optimizer("adam", constant_lr(learning_rate), 0.0,
                               steps_per_epoch=max(len(train_pipe), 1))
    trainer = Trainer(
        model.spec, loss_cfg, binary=True, optimizer=optimizer,
        aggregation=config.aggregation,
        compute_dtype=getattr(torch, config.compute_dtype),
        grad_accum_steps=config.grad_accum_steps,
        stack_twins=bool(config.stack_twins),
        allow_microbatch_contrastive=config.allow_microbatch_contrastive,
        mega_variant=mega_variant)
    guard = (CollapseGuard(raise_on_fire=False, reinit_available=False)
             if config.collapse_detection else None)
    state = trainer.init_state(model,
                               torch.Generator().manual_seed(config.seed))
    state, history = trainer.fit(
        state, train_pipe, val_pipe, config.num_epochs, config.seed,
        ckpt_path=config.model_save_path_finetune, verbose=False,
        collapse_guard=guard)
    return state.model, history


def served_b7(config, model, test_pipe) -> dict:
    """The test split through the served forward with ``fused_stack=True``
    (B7), through the same model's 'mega' forward and through its plain
    'scatter' forward, in the run's dtype: the largest probability
    difference of B7 from 'mega' and of each from 'scatter', B7's and
    'mega''s AUROCs, B7's launches and every kernel's launches over the
    whole comparison."""
    from immunostruct_tpu_torch.ops import read_launch_counts
    from immunostruct_tpu_torch.procedures.metrics import roc_auc_score
    from immunostruct_tpu_torch.serving import Scorer

    dtype = getattr(torch, config.compute_dtype)
    forwards = {"b7": dict(aggregation="auto", fused_stack=True),
                "mega": dict(aggregation="mega"),
                "scatter": dict(aggregation="scatter")}
    scorers = {k: Scorer(model, device=config.device, seed=config.seed,
                         compute_dtype=dtype, **kw)
               for k, kw in forwards.items()}
    probs = {k: [] for k in forwards}
    targets, launches_b7 = [], 0
    counts0 = read_launch_counts()
    for batch in test_pipe.epoch(0):
        for name, scorer in scorers.items():
            before = read_launch_counts()["B7"]
            probs[name].append(scorer(batch.graph, batch.seq_onehot,
                                      batch.props))
            if name == "b7":
                launches_b7 += read_launch_counts()["B7"] - before
        targets.append(batch.target.reshape(-1).float().cpu().numpy())
    counts1 = read_launch_counts()
    y = np.concatenate(targets)
    p = {k: np.concatenate(v).astype(np.float64) for k, v in probs.items()}

    def largest(a, b):
        return float(np.max(np.abs(p[a] - p[b])))

    return {"max_abs_prob_diff": largest("b7", "mega"),
            "max_abs_prob_diff_scatter": largest("b7", "scatter"),
            "max_abs_prob_diff_mega_scatter": largest("mega", "scatter"),
            "test_auroc_b7": float(roc_auc_score(y, p["b7"])),
            "test_auroc_mega": float(roc_auc_score(y, p["mega"])),
            "launches_b7": launches_b7,
            "launches": {k: counts1[k] - counts0[k] for k in counts0}}


@contextlib.contextmanager
def fixed_order_sums(on: bool):
    """With ``on``, ``torch.use_deterministic_algorithms(True)`` while the
    block runs (and the cuBLAS workspace setting it asks for, where none is
    set): 'scatter''s ``index_add_`` in f32 then sums each node in a fixed
    order rather than by atomics, so a seed gives one trajectory on the
    card. In bf16 'scatter' sums in edge order already
    (``ops/segment.py::sum_rows_in_order``), so ``run_one`` leaves it off.
    The previous state is restored."""
    if not on:
        yield
        return
    was = torch.are_deterministic_algorithms_enabled()
    unset = "CUBLAS_WORKSPACE_CONFIG" not in os.environ
    if unset:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)
        if unset:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]


def run_one(root: str, model_name: str, *, samples: int, epochs: int,
            seed: int, device: str, aggregation: str,
            mega_variant: str = "hybrid", compute_dtype: str,
            init: Optional[str] = None, overrides: Optional[dict] = None
            ) -> dict:
    """Train ``model_name`` on the geometric corpus (scripts/geometric_
    signal.py::run_one): the split, the weights and the shuffles from
    ``seed``, the corpus from seed 17. ``init``: the initial weights from a
    checkpoint npz of the JAX package (``save_checkpoint``, e.g. JAX's
    ``build_model`` at ``jax.random.key(0)``, its own start: INIT_KEY0) in
    place of the ``torch.Generator`` draw; the split and the shuffles still
    come from ``seed``. ``overrides``: fields of the model's spec (its
    widths, ``dropout_rate``) in place of the registry's. Returns JAX's keys, the per-epoch losses, the wall seconds and
    each kernel's launches over training and over inference (the 'auto'
    runs on the card also ``served_b7``: B7 takes E a multiple of 128, the
    card's pad)."""
    from immunostruct_tpu_torch.config import Config
    from immunostruct_tpu_torch.data.dataset import (
        ImmunoDataset, seeded_split,
    )
    from immunostruct_tpu_torch.data.pipeline import BatchPipeline
    from immunostruct_tpu_torch.models import build_model
    from immunostruct_tpu_torch.ops import read_launch_counts
    from immunostruct_tpu_torch.procedures.infer import inference
    from immunostruct_tpu_torch.utils.checkpoint import load_jax_checkpoint
    from immunostruct_tpu_torch.utils.losses import (
        LossConfig, pos_weight_from_counts,
    )

    on_card = torch.device(device).type == "cuda"
    tag = (f"{model_name}_{aggregation}_{mega_variant}_{seed}_"
           f"{compute_dtype}_{os.path.basename(init or 'seed')}")
    config = Config(device=device, batch_size=32, num_epochs=epochs,
                    pad_nodes_multiple=8 if on_card else 4,
                    pad_edges_multiple=128 if on_card else 16,
                    compute_dtype=compute_dtype, aggregation=aggregation,
                    model=model_name, sequence_loss=False,
                    full_sequence=False, seed=seed,
                    model_save_dir=os.path.join(root, f"ckpt_{tag}"))
    config.derive_paths()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):     # its table sizes
        ds = ImmunoDataset.load(config, *corpus(root, samples))
    tr, va, te = seeded_split(len(ds), (0.7, 0.1, 0.2), seed)
    vae_dim = ds.seq_pep.shape[1] * 21
    _, model = build_model(model_name, vae_dim,
                           torch.Generator().manual_seed(seed),
                           device=device, **(overrides or {}))
    if init is not None:
        load_jax_checkpoint(init, model, verbose=False)
    loss_cfg = LossConfig(vae_dim, pos_weight_from_counts(ds.class_weights),
                          sequence=False)

    def pipe(idx, split):
        return BatchPipeline(ds, idx, split=split, binary=True, full=False,
                             config=config)

    counts0 = read_launch_counts()
    t1 = time.perf_counter()
    with fixed_order_sums(on_card and aggregation == "scatter"
                          and compute_dtype == "float32"):
        model, hist = fit(config, model, pipe(tr, "train"), pipe(va, "val"),
                          loss_cfg, learning_rate=1e-3,
                          mega_variant=mega_variant)
    counts1 = read_launch_counts()
    t2 = time.perf_counter()
    train_stats = inference(config, model, pipe(tr, "train"), verbose=False)
    test_stats = inference(config, model, pipe(te, "test"),
                           optimal_threshold=train_stats["optimal_threshold"],
                           verbose=False)
    counts2 = read_launch_counts()
    t3 = time.perf_counter()
    out = {
        "model": model_name,
        "label_rate": float(np.mean(ds.immuno)),
        "train_auroc": float(train_stats["roc_auc"]),
        "test_auroc": float(test_stats["roc_auc"]),
        "final_train_loss": float(hist["train_loss"][-1]),
        "aggregation": aggregation,
        "compute_dtype": compute_dtype,
        "mega_variant": mega_variant, "seed": seed, "device": device,
        "init": None if init is None else os.path.basename(init),
        "train_losses": [float(v) for v in hist["train_loss"]],
        "val_losses": [float(v) for v in hist["val_loss"]],
        "train_s": t2 - t1, "inference_s": t3 - t2, "wall_s": t3 - t0,
        "launches_train": {k: counts1[k] - counts0[k] for k in counts0},
        "launches_inference": {k: counts2[k] - counts1[k] for k in counts0},
    }
    out["launches"] = {k: out["launches_train"][k]
                       + out["launches_inference"][k] for k in counts0}
    if on_card and aggregation == "auto" and model.spec.use_structure:
        out["served_b7"] = served_b7(config, model, pipe(te, "test"))
    return out


def path_of(run: dict) -> str:
    """The PATHS key of a StructureModel run."""
    return next(p for p, (agg, v) in PATHS.items()
                if (agg, v) == (run["aggregation"], run["mega_variant"]))


def exclusive_kernels(path: str) -> set:
    """The kernels of ``path`` that no other path exists for."""
    others = {k for p, ks in PATH_KERNELS.items() if p != path for k in ks}
    return set(PATH_KERNELS[path]) - others


def judge(runs: list, control: list, *, kernels: bool) -> dict:
    """Apply the bounds to StructureModel's ``runs`` (by path, the median
    over their seeds) and to the SequenceFpModel ``control``; with
    ``kernels`` (the card), also each run's launches. Returns {"paths":
    {path: row}, "control": row, "failures": [text]}. A row also counts
    the seeds whose test AUROC is above TEST_AUROC_MIN (``learned``) and
    gives the medians' margins over the bounds."""
    failures = []
    by_path = {}
    for run in runs:
        by_path.setdefault(path_of(run), []).append(run)
    scatter = {r["seed"]: r["test_auroc"] for r in by_path.get("scatter", ())}
    rows = {}
    for path, group in by_path.items():
        row = {
            "seeds": [r["seed"] for r in group],
            "test_auroc": [r["test_auroc"] for r in group],
            "train_auroc": [r["train_auroc"] for r in group],
            "median_test_auroc": statistics.median(
                r["test_auroc"] for r in group),
            "median_train_auroc": statistics.median(
                r["train_auroc"] for r in group),
            "learned": sum(r["test_auroc"] > TEST_AUROC_MIN for r in group),
            "test_gap_to_scatter": [
                r["test_auroc"] - scatter[r["seed"]] for r in group
                if r["seed"] in scatter],
            "launches": [{k: v for k, v in r["launches"].items() if v}
                         for r in group],
        }
        row["margin_test"] = row["median_test_auroc"] - TEST_AUROC_MIN
        row["margin_train"] = row["median_train_auroc"] - TRAIN_AUROC_MIN
        row["fell"] = sum(r["train_losses"][-1] < r["train_losses"][0]
                          for r in group)
        rows[path] = row
        if not row["margin_test"] > 0:
            failures.append(f"{path}: median test AUROC "
                            f"{row['median_test_auroc']} <= {TEST_AUROC_MIN}")
        if not row["margin_train"] > 0:
            failures.append(f"{path}: median train AUROC "
                            f"{row['median_train_auroc']} <= "
                            f"{TRAIN_AUROC_MIN}")
        if not statistics.median(r["train_losses"][-1] - r["train_losses"][0]
                                 for r in group) < 0:
            failures.append(f"{path}: the last train loss below the first "
                            f"in {row['fell']} of {len(group)} runs")
        for r in group:
            failures += [f"{path} seed {r['seed']}: {f}" for f in
                         finite_faults(r)
                         + (kernel_faults(path, r) if kernels else [])]
            failures += b7_faults(path, r, kernels)
    if "scatter" in rows:
        plain = rows["scatter"]
        for path, row in rows.items():
            if (set(row["seeds"]) == set(plain["seeds"])
                    and row["learned"] < plain["learned"] - LEARNED_SLACK):
                failures.append(
                    f"{path}: learned at {row['learned']} of "
                    f"{len(row['seeds'])} seeds, 'scatter' at "
                    f"{plain['learned']}")
    control_row = None
    if control:
        median = statistics.median(r["test_auroc"] for r in control)
        control_row = {"seeds": [r["seed"] for r in control],
                       "test_auroc": [r["test_auroc"] for r in control],
                       "median_test_auroc": median}
        if not abs(median - 0.5) < CONTROL_HALF_WIDTH:
            failures.append(f"control: median test AUROC {median} not "
                            f"within {CONTROL_HALF_WIDTH} of 0.5")
        for r in control:
            # at chance, its train loss need not fall: finite is asked
            failures += [f"control seed {r['seed']}: {f}"
                         for f in finite_faults(r)]
            if kernels and any(r["launches"].values()):
                failures.append(f"control seed {r['seed']}: launched "
                                f"{r['launches']}")
    return {"paths": rows, "control": control_row, "failures": failures}


def finite_faults(run: dict) -> list:
    losses = run["train_losses"] + run["val_losses"]
    if all(math.isfinite(v) for v in losses):
        return []
    return [f"a loss not finite: {losses}"]


def b7_faults(path: str, run: dict, kernels: bool) -> list:
    """The served B7 forward of an 'auto' run (or of a trained model):
    from the 'mega' forward and from the plain 'scatter' one no further
    than 'mega' is from 'scatter', give or take PROB_ATOL; at FIRST_SEEDS
    also within PROB_ATOL of 'mega', the AUROCs within AUROC_ATOL."""
    b7 = run.get("served_b7")
    if b7 is None:
        return []
    where = f"{path} seed {run['seed']}"
    faults = []
    spread = b7["max_abs_prob_diff_mega_scatter"]
    for key, other in (("max_abs_prob_diff", "'mega'"),
                       ("max_abs_prob_diff_scatter", "'scatter'")):
        if not b7[key] <= spread + PROB_ATOL:
            faults.append(f"{where}: B7's probabilities {b7[key]} from "
                          f"{other}, over 'mega' - 'scatter' {spread} + "
                          f"{PROB_ATOL}")
    if run["seed"] in FIRST_SEEDS:
        if not b7["max_abs_prob_diff"] <= PROB_ATOL:
            faults.append(f"{where}: B7's probabilities "
                          f"{b7['max_abs_prob_diff']} from 'mega', over "
                          f"{PROB_ATOL}")
        gap = abs(b7["test_auroc_b7"] - b7["test_auroc_mega"])
        if not gap <= AUROC_ATOL:
            faults.append(f"{where}: B7's AUROC {gap} from 'mega', over "
                          f"{AUROC_ATOL}")
    if kernels and not b7["launches_b7"] > 0:
        faults.append(f"{where}: no B7 launch")
    return faults


def kernel_faults(path: str, run: dict) -> list:
    """A listed kernel that training did not launch; a kernel of another
    path alone, or one of no path (B4, B7), launched at all."""
    faults = [f"{k} not launched in training"
              for k in PATH_KERNELS[path] if not run["launches_train"][k] > 0]
    foreign = {k for p in PATH_KERNELS if p != path
               for k in exclusive_kernels(p)}
    foreign |= {"B4", "B7"}
    if path == "scatter":
        foreign = set(run["launches"])
    faults += [f"{k} launched {run['launches'][k]} times" for k in
               sorted(foreign) if run["launches"][k]]
    return faults


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--samples", type=int, default=512)
    ap.add_argument("--epochs", type=int, default=14)
    ap.add_argument("--seeds", type=int, nargs="+", default=list(SEEDS))
    ap.add_argument("--paths", nargs="+", choices=sorted(PATHS),
                    default=list(PATHS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cpu", action="store_true",
                    help="f32, 'scatter', pads 4/16 (the JAX CPU settings)")
    ap.add_argument("--compute-dtype", choices=("bfloat16", "float32"),
                    help="the runs' dtype (default: bfloat16 on the card, "
                    "float32 on the CPU)")
    ap.add_argument("--init", metavar="PATH",
                    help="every StructureModel run starts from this JAX "
                    "package checkpoint npz in place of its seed's draw "
                    "(tests/data/geomsig_init_key0.npz with --seeds 1: "
                    "the JAX package's own start)")
    args = ap.parse_args(argv)

    device = "cpu" if args.cpu else args.device
    on_card = torch.device(device).type == "cuda"
    if on_card and not torch.cuda.is_available():
        print("torch finds no CUDA device", file=sys.stderr)
        return 2
    paths = ["scatter"] if args.cpu else args.paths
    dtype = args.compute_dtype or ("bfloat16" if on_card else "float32")
    card = card_line() if on_card else None
    if card:
        print(f"card: {card}", flush=True)
    kw = dict(samples=args.samples, epochs=args.epochs, device=device,
              compute_dtype=dtype)
    runs, control = [], []
    with tempfile.TemporaryDirectory(prefix="geomsig_") as root:
        for seed in args.seeds:
            for path in paths:
                agg, variant = PATHS[path]
                runs.append(run_one(root, "StructureModel", seed=seed,
                                    aggregation=agg, mega_variant=variant,
                                    init=args.init, **kw))
                print(json.dumps({"path": path, **runs[-1]}), flush=True)
            control.append(run_one(root, "SequenceFpModel", seed=seed,
                                   aggregation="scatter" if args.cpu
                                   else "auto", **kw))
            print(json.dumps({"path": "control", **control[-1]}), flush=True)
    verdict = judge(runs, control, kernels=on_card)
    for text in verdict["failures"]:
        print(f"FAILED: {text}", file=sys.stderr)
    print(json.dumps({"device": torch.cuda.get_device_name(0) if on_card
                      else "cpu", "card": card, "samples": args.samples,
                      "epochs": args.epochs, "compute_dtype": dtype,
                      "init": args.init, **verdict,
                      "geometric_signal_recovered_by_structure_only":
                          not verdict["failures"]}))
    return 1 if verdict["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
