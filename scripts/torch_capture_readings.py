"""Readings of the captured programs (immunostruct_tpu_torch/utils/capture.py)
on the card, at full width (HybridModelv2, N=288, E=2560, bf16, 'mega',
seeded weights). Sections (--parts, default both):

  mixed   a served stream whose request shapes change call by call: B = 1,
          2, 4, ..., 128 in turn, the round four times (32 requests), as a
          server meets clients that send different batch sizes. Each round
          through a captured Scorer whose graphs share the program's one
          memory pool (as ``Program`` does), through one whose graphs each
          take a pool of their own (the form before: the program's pool
          cleared before each capture), and through an eager Scorer, one
          after the other in a fresh allocator state. Per request: its
          wall (to the probabilities on the host), what the program did
          (warm-up, capture, replay), the card's reserved memory after it,
          what stays reserved once the cache is emptied (``held``: live
          tensors and the graphs' pools) and the allocated memory, each
          over the form's start; per form what is held after each round
          and the median wall of the last round. The captured forms'
          results are held to the eager one's bit for bit.
  host    the host's steps of one replayed B=1 request, each timed on the
          host's clock over 200 calls with nothing waited for in between:
          the Scorer's own work ahead of its program (the aggregation
          resolved), the key (the inputs' signature), the state marks (every
          parameter's and buffer's address), the copy into the static
          inputs, the generator's seed, the replay's launch, the launch
          counters, the copy out; then the wait for the result on the host
          (``.cpu()``) and the whole call as ``Scorer.__call__`` makes it.

One JSON line per section, after the card's name and power limit:

  python scripts/torch_capture_readings.py [--parts mixed host]
"""

from __future__ import annotations

import argparse
import functools
import gc
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from immunostruct_tpu_torch.data import synthetic  # noqa: E402
from immunostruct_tpu_torch.models import build_model  # noqa: E402
from immunostruct_tpu_torch.models.trunk import gcn_aggregation  # noqa: E402
from immunostruct_tpu_torch.ops import _build, launch_counters  # noqa: E402
from immunostruct_tpu_torch.serving import Scorer  # noqa: E402
from immunostruct_tpu_torch.utils import capture  # noqa: E402

N, E, L = 288, 2560, 284
SIZES = (1, 2, 4, 8, 16, 32, 64, 128)
ROUNDS = 4
HOST_CALLS = 200


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


class OwnPools(capture.Program):
    """The form before one pool a program: each graph in a pool of its
    own (``capture_begin(pool=None)`` once a graph of the program lives)."""

    def _capture(self, *args):
        self._pool = None
        super()._capture(*args)


def _model():
    return build_model("HybridModelv2", L * 21,
                       torch.Generator().manual_seed(0), device="cuda")[1]


def _scorer(model, capture_flag):
    return Scorer(model, device="cuda", compute_dtype=torch.bfloat16,
                  aggregation="mega", seed=0, capture=capture_flag)


def mixed(model) -> dict:
    requests = {b: synthetic.random_sample_batch(b, N, E, L, seed=b,
                                                 device="cuda")
                for b in SIZES}
    forms, results = {}, {}
    for form in ("one pool", "a pool a graph", "eager"):
        scorer = _scorer(model, False if form == "eager" else None)
        if form == "a pool a graph":
            scorer.program = OwnPools("served forward")
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_reserved()
        allocated = torch.cuda.memory_allocated()
        rows, out = [], []
        for rnd in range(ROUNDS):
            for b in SIZES:
                req = requests[b]
                program = scorer.program
                done = (program.captures, program.replays)
                t0 = time.perf_counter()
                out.append(scorer(req.graph, req.seq_onehot, req.props))
                wall = (time.perf_counter() - t0) * 1e3
                did = ("eager" if form == "eager" else
                       "capture" if program.captures > done[0] else
                       "replay" if program.replays > done[1] else "warm-up")
                reserved = torch.cuda.memory_reserved()
                torch.cuda.empty_cache()
                rows.append(dict(round=rnd, B=b, did=did, wall_ms=wall,
                                 reserved_bytes=reserved - base,
                                 held_bytes=torch.cuda.memory_reserved()
                                 - base,
                                 allocated_bytes=torch.cuda.memory_allocated()
                                 - allocated))
        results[form] = out
        last = [r["wall_ms"] for r in rows if r["round"] == ROUNDS - 1]
        forms[form] = dict(
            requests=rows, keys=len(scorer.program.keys),
            held_at_end_bytes=rows[-1]["held_bytes"],
            held_after_each_round_bytes=[
                rows[(r + 1) * len(SIZES) - 1]["held_bytes"]
                for r in range(ROUNDS)],
            peak_reserved_bytes=max(r["reserved_bytes"] for r in rows),
            last_round_wall_ms=dict(zip(SIZES, last)),
            last_round_median_ms=statistics.median(last),
            pools=len({e.graph.pool() for e in
                       scorer.program._entries.values()
                       if e.graph is not None}))
        del scorer, program
    for form in ("one pool", "a pool a graph"):
        for got, want in zip(results[form], results["eager"]):
            assert np.array_equal(got, want), form
    return forms


def host(model) -> dict:
    scorer = _scorer(model, None)
    req = synthetic.random_sample_batch(1, N, E, L, seed=1, device="cuda")
    args = (req.graph, req.seq_onehot, req.props)
    for _ in range(3):                       # warm-up, capture, a replay
        scorer(*args)
    program = scorer.program
    (key, entry), = program._entries.items()
    state = functools.partial(capture.module_tensors, model)
    counters = launch_counters()
    steps = {k: [] for k in ("aggregation", "signature", "marks", "copy in",
                             "seed", "replay launch", "counters", "copy out",
                             "wait on the host", "whole call")}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        steps[name].append((time.perf_counter() - t0) * 1e6)
        return out

    with torch.inference_mode():
        for _ in range(HOST_CALLS):
            timed("aggregation",
                  lambda: gcn_aggregation(model, req.graph, "mega"))
            timed("signature", lambda: (key[0], capture._signature(args)))
            timed("marks", lambda: capture._marks(state()))
            timed("copy in", lambda: program._load(entry, args))
            timed("seed", lambda: program._generator.manual_seed(0))
            timed("replay launch", entry.graph.replay)

            def count():
                for f, n in entry.launches:
                    f.launches += n
            timed("counters", count)
            probs = timed("copy out",
                          lambda: capture.tree_map(torch.clone,
                                                   entry.outputs))
            timed("wait on the host", lambda: probs.cpu().numpy())
        for _ in range(HOST_CALLS):
            timed("whole call", lambda: scorer(*args))
    out = {k: dict(median_us=statistics.median(v),
                   p90_us=float(np.percentile(v, 90))) for k, v in
           steps.items()}
    out["state tensors"] = len(state())
    out["launch counters"] = {k: f.launches for k, f in counters.items()
                              if f.launches}
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parts", nargs="+", default=["mixed", "host"],
                    choices=["mixed", "host"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    card = card_line()
    print("card:", card, flush=True)
    _build.build()
    model = _model()
    for part in args.parts:
        row = dict(part=part, card=card,
                   **(mixed(model) if part == "mixed" else host(model)))
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
