"""Race the kernel variants of aggregation 'mega' on one batch, in one
process (counterpart of ``scripts/race_kernel_variants.py``, with
``scripts/race_mega.py``'s ``make_trainer`` and ``warm_process``).

Each variant trains its own full-width HybridModelv2 (seeded weights, bf16
over f32 master weights, Adam at 1e-3, BCE + the VAE's loss) on the batch
``data/synthetic.py::build_batch`` makes (N=288, the sequence length 284).
The protocol: a warm-up, each variant's first step, a burn-in, then
interleaved timing windows, each ending in a value fetch
(``float(loss)`` after ``torch.cuda.synchronize()``).

Variants (the JAX script's names):
  diff16    'mega' with mega_variant 'hybrid' (B1 forward, B2 backward), the
            production form
  dboth     'mega' / 'dboth'    (B5a in the backward)
  inkernel  'mega' / 'inkernel' (B5b in the backward)
  paired    'mega' / 'paired'   (B4 forward; needs --paired-batch)
  stack     'mega' / 'stack'    (B6, the whole stack forward)
  fused     aggregation 'fused' (B3), the control
The JAX script's other names (base, cast, stacked, split, concat, innerN,
tinnerN, comboNM, skipprobe) set one-hot, sub-tiling and Mosaic switches
of the TPU kernels, which the Hopper kernels do not have: they raise. So
does a variant that fails: nothing is skipped.

Prints one JSON line: {variant: {windows_ms, p50_ms, best_ms, loss0,
windows_loss, min_loss, launches_per_step}}: ``loss0`` is the first step's
loss, ``windows_loss`` each window's median step loss, ``min_loss`` the
least over the timed steps (training on one fixed batch, every variant's
loss spikes now and then and recovers), ``launches_per_step`` each kernel
wrapper's launches over the timed windows, per step.

Usage: python -m immunostruct_tpu_torch.cli.race_kernel_variants
       [--variants diff16,dboth,inkernel,stack,paired,fused] [--edges 2560]
       [--batch 128] [--windows 3] [--steps 50] [--burnin 25]
       [--paired-batch] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time

import torch

NODES, SEQ_LEN = 288, 284
# variant -> (aggregation, mega_variant)
VARIANTS = {
    "diff16": ("mega", "hybrid"),
    "dboth": ("mega", "dboth"),
    "inkernel": ("mega", "inkernel"),
    "paired": ("mega", "paired"),
    "stack": ("mega", "stack"),
    "fused": ("fused", "hybrid"),
}
_TPU_FORMS = re.compile(r"base|cast|stacked|split|concat|skipprobe|"
                        r"inner\d+|tinner\d+|combo\d+x\d+|combo\d\d")


def counters() -> dict:
    """The kernel wrappers whose ``launches`` a race reads, by kernel."""
    from immunostruct_tpu_torch.ops.edge import edge_program, edge_program_bwd
    from immunostruct_tpu_torch.ops.mega import (
        edge_mega, edge_mega_paired_fwd, tail_bwd, tail_bwd_db,
        tail_bwd_nodes,
    )
    from immunostruct_tpu_torch.ops.segment import (
        segment_gather, segment_scatter,
    )
    from immunostruct_tpu_torch.ops.stack import stack_fwd

    return {"B1": edge_mega, "B2": tail_bwd, "B3_fwd": edge_program,
            "B3_bwd": edge_program_bwd, "B4": edge_mega_paired_fwd,
            "B5a": tail_bwd_db, "B5b": tail_bwd_nodes, "B6": stack_fwd,
            "B8_scatter": segment_scatter, "B8_gather": segment_gather}


def read_counts() -> dict:
    return {k: fn.launches for k, fn in counters().items()}


def check_variants(names, paired_batch: bool) -> None:
    for v in names:
        if v in VARIANTS:
            continue
        if _TPU_FORMS.fullmatch(v):
            raise ValueError(
                f"variant '{v}' is a TPU lowering form of the JAX kernels "
                "(one-hot builds, sub-tiling, Mosaic switches); the Hopper "
                "kernels have no such switch (ROADMAP.md, TPU kernels). "
                f"Race {tuple(VARIANTS)}")
        raise ValueError(f"unknown variant '{v}'; choose from "
                         f"{tuple(VARIANTS)}")
    if "paired" in names and not paired_batch:
        raise ValueError("the 'paired' variant requires --paired-batch (B4 "
                         "reads the mirror-paired layout)")


def make_trainer(aggregation: str, mega_variant: str, vae_dim: int, device):
    """The race's model (seeded weights), trainer and state."""
    from immunostruct_tpu_torch.models import build_model
    from immunostruct_tpu_torch.procedures.train import (
        Trainer, make_optimizer,
    )
    from immunostruct_tpu_torch.utils.losses import LossConfig
    from immunostruct_tpu_torch.utils.schedule import constant_lr

    _, model = build_model("HybridModelv2", vae_dim,
                           torch.Generator().manual_seed(0), device=device)
    trainer = Trainer(model.spec, LossConfig(vae_dim, 1.0, sequence=True),
                      binary=True,
                      optimizer=make_optimizer("adam", constant_lr(1e-3)),
                      aggregation=aggregation, compute_dtype=torch.bfloat16,
                      mega_variant=mega_variant)
    return trainer, trainer.init_state(model)


def fetch(loss) -> float:
    """The loss's value, after the device has finished (the window's
    barrier)."""
    if loss.device.type == "cuda":
        torch.cuda.synchronize(loss.device)
    return float(loss)


def warm_process(device) -> None:
    """Throwaway work that takes the process's first-use costs (context,
    library handles, the allocator's first blocks) before any timing."""
    n = 1024 if device.type == "cuda" else 64
    x = torch.ones(n, n, dtype=torch.bfloat16, device=device)
    for _ in range(40):
        x = torch.tanh(x @ x)
    fetch(x.float().sum())


def race(variants, edges: int = 2560, batch: int = 128, windows: int = 3,
         steps: int = 50, burnin: int = 25, paired_batch: bool = False,
         device: str = "cuda", log=sys.stderr) -> dict:
    """Run the race; returns the JSON line's object."""
    from immunostruct_tpu_torch.data.synthetic import build_batch

    names = list(variants)
    check_variants(names, paired_batch)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch finds no CUDA device")
    vae_dim = SEQ_LEN * 21
    data = build_batch(batch, NODES, edges, SEQ_LEN, paired=paired_batch,
                       device=device)
    print(f"device={device} edges={edges} batch={batch} "
          f"paired_batch={paired_batch}", file=log)
    warm_process(device)
    print("process warmed", file=log)

    runs = {}
    for v in names:
        aggregation, mega_variant = VARIANTS[v]
        t0 = time.perf_counter()
        trainer, state = make_trainer(aggregation, mega_variant, vae_dim,
                                      device)
        state, loss = trainer.train_step(state, data, seed=0)
        l0 = fetch(loss)
        print(f"{v}: built + first step in {time.perf_counter() - t0:.1f}s "
              f"loss={l0:.4f}", file=log)
        runs[v] = {"trainer": trainer, "state": state, "loss0": l0,
                   "windows_ms": [], "windows_loss": [],
                   "min_loss": float("inf"), "launches": {}}

    for r in runs.values():
        loss = None
        for _ in range(burnin):
            r["state"], loss = r["trainer"].train_step(r["state"], data,
                                                       seed=0)
        if loss is not None:
            fetch(loss)

    for w in range(windows):
        for v, r in runs.items():
            before = read_counts()
            losses = []
            t0 = time.perf_counter()
            for _ in range(steps):
                r["state"], loss = r["trainer"].train_step(r["state"], data,
                                                           seed=0)
                losses.append(loss)
            fetch(loss)
            ms = (time.perf_counter() - t0) / steps * 1e3
            # read after the window's barrier: no synchronisation inside it
            window = torch.stack(losses).float().cpu()
            r["windows_loss"].append(round(float(window.median()), 6))
            r["min_loss"] = min(r["min_loss"], float(window.min()))
            for k, n in read_counts().items():
                r["launches"][k] = r["launches"].get(k, 0) + n - before[k]
            r["windows_ms"].append(round(ms, 3))
            print(f"window {w} {v}: {ms:.2f} ms/step", file=log)

    out = {}
    for v, r in runs.items():
        ws = sorted(r["windows_ms"])
        timed = windows * steps
        out[v] = {"windows_ms": r["windows_ms"], "p50_ms": ws[len(ws) // 2],
                  "best_ms": ws[0], "loss0": round(r["loss0"], 6),
                  "windows_loss": r["windows_loss"],
                  "min_loss": round(r["min_loss"], 6),
                  "launches_per_step": {k: n / timed
                                        for k, n in r["launches"].items()
                                        if n}}
    return out


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--edges", type=int, default=2560)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--burnin", type=int, default=25)
    ap.add_argument("--paired-batch", action="store_true",
                    help="lay the synthetic edges out mirror-paired "
                         "(required for the 'paired' variant; valid for "
                         "all variants)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "versions")
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    if min(args.windows, args.steps) < 1 or args.burnin < 0:
        raise ValueError("--windows and --steps take at least 1, --burnin "
                         "at least 0")
    out = race(args.variants.split(","), edges=args.edges, batch=args.batch,
               windows=args.windows, steps=args.steps, burnin=args.burnin,
               paired_batch=args.paired_batch, device=args.device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
