"""Tracing and step timing (counterpart of
``immunostruct_tpu/utils/profiling.py``).

- ``trace(logdir)``: a context manager around ``torch.profiler`` that
  writes a Chrome trace under ``logdir`` on exit (the host's ops and, on a
  card, its kernels, copies and fills), which Perfetto and TensorBoard's
  profiler plugin read; it yields the profile for
  ``utils/attribution.py``.
- ``StepTimer``: per-step wall-clock statistics with a warm-up skip, for
  throughput without the profiler's cost.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str, with_stack: bool = False):
    """Profile the block (the CPU, and CUDA when there is a device) and
    write its trace to ``logdir``; ``with_stack`` records the Python stack
    of each op (host time: the window's wall is then not a wall)."""
    from torch.profiler import (
        ProfilerActivity, profile, tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities, with_stack=with_stack,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()


class StepTimer:
    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._times: list[float] = []
        self._count = 0
        self._last = None

    def start(self):
        self._last = time.perf_counter()

    def stop(self):
        dt = time.perf_counter() - self._last
        self._count += 1
        if self._count > self.warmup:
            self._times.append(dt)
        return dt

    @contextlib.contextmanager
    def step(self):
        self.start()
        yield
        self.stop()

    def stats(self) -> dict:
        if not self._times:
            return {"steps": 0}
        t = np.asarray(self._times)
        return {
            "steps": len(t),
            "mean_s": float(t.mean()),
            "p50_s": float(np.percentile(t, 50)),
            "p95_s": float(np.percentile(t, 95)),
            "steps_per_sec": float(1.0 / t.mean()),
        }
