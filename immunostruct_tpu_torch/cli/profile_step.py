"""Profile the flagship train step: device time per label (counterpart of
``immunostruct_tpu/cli/profile_step.py``).

    python -m immunostruct_tpu_torch.cli.profile_step [--model HybridModelv2]
        [--batch 128] [--nodes 288] [--edges 2560] [--aggregation auto]
        [--steps 10] [--logdir DIR] [--device cuda]

Prints ms per step by label (``utils/attribution.py``): ``[kernel:B1]`` ...
for the hand-written kernels, the ``file:line`` of the port's code that
launched the rest, ``[aten::op]`` where none did. ``--inference`` profiles
the deterministic forward (``model_apply``, then a sigmoid) instead of
``Trainer.train_step``, ``--comparative`` the twin step, ``--occupancy``
adds the device's busy and idle time a step and the largest gaps between
its ops. On CUDA the compute dtype defaults to bfloat16, on the CPU to
float32 (there the CPU ops stand in for the device lane). The trace is
written under ``<logdir>/_attribution_run`` for Perfetto or TensorBoard.
"""

from __future__ import annotations

import argparse
import os
import tempfile


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="HybridModelv2")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--nodes", type=int, default=288)
    ap.add_argument("--edges", type=int, default=2560)
    ap.add_argument("--seq-len", type=int, default=284)
    ap.add_argument("--aggregation", default="auto")
    ap.add_argument("--compute-dtype", default=None,
                    help="default: bfloat16 on CUDA, float32 on the CPU")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--logdir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "immuno_profile"))
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' (default) fails without one")
    ap.add_argument("--comparative", action="store_true",
                    help="profile the twin step (cancer/WT ComparativeBatch "
                         "through model_apply_comparative; appends "
                         "_Comparative to --model if needed)")
    ap.add_argument("--coeff-contrastive", default=0.0, type=float,
                    help="include the paired contrastive term in the "
                         "profiled comparative step")
    ap.add_argument("--inference", action="store_true",
                    help="profile the deterministic forward (the serving "
                         "path: model_apply + sigmoid) instead of the train "
                         "step; --inference --batch 1 attributes the "
                         "single-sample latency")
    ap.add_argument("--occupancy", action="store_true",
                    help="also print the device's busy and idle time a step "
                         "and the largest gaps between its ops")
    args = ap.parse_args(argv)

    import torch

    from immunostruct_tpu_torch.cli.common import resolve_device
    from immunostruct_tpu_torch.data.synthetic import (
        random_comparative_batch, random_sample_batch,
    )
    from immunostruct_tpu_torch.models import build_model, model_apply
    from immunostruct_tpu_torch.procedures.train import (
        Trainer, make_optimizer,
    )
    from immunostruct_tpu_torch.utils.attribution import (
        load_trace_timeline, occupancy, profile_fn,
    )
    from immunostruct_tpu_torch.utils.losses import LossConfig
    from immunostruct_tpu_torch.utils.schedule import constant_lr

    b, n, e = args.batch, args.nodes, args.edges
    comparative = args.comparative or "Comparative" in args.model
    if args.inference and comparative:
        ap.error("--inference profiles the single deterministic forward; "
                 "it cannot be combined with --comparative or a "
                 "*_Comparative model")
    if comparative and "Comparative" not in args.model:
        args.model += "_Comparative"
    device = resolve_device(args.device)
    batch = (random_comparative_batch(b, n, e, args.seq_len, seed=0,
                                      device=device)
             if comparative else
             random_sample_batch(b, n, e, args.seq_len, seed=0,
                                 device=device))
    dtype = (getattr(torch, args.compute_dtype) if args.compute_dtype
             else torch.bfloat16 if device.type == "cuda" else torch.float32)
    vae_dim = args.seq_len * 21
    _, model = build_model(args.model, vae_dim,
                           torch.Generator().manual_seed(0), device=device)

    if args.inference:
        # no Trainer here: the serving path holds no Adam moments. carry =
        # (previous probabilities, model): chaining them into the props
        # keeps the repeated calls data-dependent
        def fwd(carry):
            prev, m = carry
            with torch.no_grad():
                props = batch.props + 1e-12 * prev.mean()
                out = model_apply(m, batch.graph, batch.seq_onehot, props,
                                  generator=torch.Generator(device=device),
                                  deterministic=True,
                                  aggregation=args.aggregation,
                                  compute_dtype=dtype)
                probs = torch.sigmoid(out.logits.reshape(-1))
            return (probs, m), probs

        rows = profile_fn(fwd, ((torch.zeros((b,), device=device), model),),
                          args.logdir, steps=args.steps, warmup=args.warmup,
                          thread_state=True)
    else:
        trainer = Trainer(
            model.spec, LossConfig(vae_dim, pos_weight=1.0, sequence=True),
            binary=True, optimizer=make_optimizer("adam", constant_lr(1e-3)),
            coeff_contrastive=args.coeff_contrastive,
            aggregation=args.aggregation, compute_dtype=dtype)
        state = trainer.init_state(model)

        def step(s):
            return trainer.train_step(s, batch, seed=1)

        rows = profile_fn(step, (state,), args.logdir, steps=args.steps,
                          warmup=args.warmup, thread_state=True)
    total = sum(ms for ms, _ in rows)
    print(f"# model={args.model} aggregation={args.aggregation} "
          f"device={device} B={b} N={n} E={e} dtype={dtype} "
          f"mode={'inference' if args.inference else 'train'} "
          f"device_total={total:.3f} ms/step")
    for ms, label in rows[:args.top]:
        print(f"{ms:9.3f} ms/step  {label}")

    result = {"rows": rows, "device_total_ms": total}
    if args.occupancy:
        tl = load_trace_timeline(os.path.join(args.logdir, "_attribution_run"))
        occ = occupancy(tl, args.steps)
        print(f"# occupancy: span={occ['span_ms']:.3f} ms/step "
              f"busy={occ['busy_ms']:.3f} idle={occ['idle_ms']:.3f} "
              f"({occ['idle_frac']:.1%} idle)")
        for gap_ms, after, before in occ["gaps"]:
            print(f"  gap {gap_ms:7.3f} ms  after {after[:60]}  ->  "
                  f"{before[:60]}")
        result["occupancy"] = occ
    return result


if __name__ == "__main__":
    main()
