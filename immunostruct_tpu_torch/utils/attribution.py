"""Device-time attribution: a torch.profiler trace -> ms per step by label
(counterpart of ``immunostruct_tpu/utils/attribution.py``).

The JAX package joins a device trace to the source-line metadata of the
compiled HLO. PyTorch compiles nothing, so here each device event (a
kernel, a memcpy or a memset) gets a label, the first of:

  (a) ``[kernel:B1]`` ... ``[kernel:B8 gather]`` for a kernel of
      ``csrc/``, by its name (``CSRC_KERNELS``). The helper kernels that
      several of them launch (the bf16 projection ahead of B1/B4's edge
      kernel, the chunk and block reductions after a kernel) take the label
      of the csrc kernel they serve: the next one launched for a
      projection, the previous one for a reduction (``CSRC_HELPERS``);
  (b) ``file:line`` of the innermost ``immunostruct_tpu_torch/`` frame of
      the Python stack that launched it (``with_stack=True``; the line is
      the function's first, as torch's Python tracer records it);
  (c) ``[aten::op]``, the ATen op that launched it, otherwise (a backward
      kernel runs on autograd's thread, below no Python frame of the
      port).

The kernels launched through ctypes (B2, B3's backward, B4-B7) have no
``aten::`` op above them: their launch is found through the CUDA runtime
call that carries the kernel's correlation id. ``with_stack`` costs host
time, so the wall time of a profiled window is not the step's wall time;
the device's own times are unaffected. On the CPU the CPU ops stand in for
the device lane (the top-level ops: an op inside another is not counted
twice), which is what the tests run.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import re
import shutil
from typing import Callable, List, Optional, Sequence, Tuple

import torch

# (label, substrings that must all be in the kernel's name): the first row
# that matches names a csrc kernel. B4's bf16 form is B1's kernel with the
# ArcTiles tile policy, so its rows come first.
CSRC_KERNELS = (
    ("B4", ("egnn_mega_paired_fwd_kernel",)),
    ("B4", ("egnn_mega_fwd_mma_kernel", "ArcTiles")),
    ("B1", ("egnn_mega_fwd_kernel",)),
    ("B1", ("egnn_mega_fwd_mma_kernel", "EdgeTiles")),
    ("B2", ("tail_bwd", ", 0>(")),
    ("B5a", ("tail_bwd", ", 1>(")),
    ("B5b", ("tail_bwd", ", 2>(")),
    ("B3 fwd", ("egnn_edge_fwd",)),
    ("B3 bwd", ("egnn_edge_bwd",)),
    ("B8 scatter", ("segment_scatter_kernel",)),
    ("B8 gather", ("segment_gather_kernel",)),
    ("B6", ("egnn_stack_fwd",)),
    ("B7", ("egnn_layer_fwd",)),
)
# helper kernels of csrc/: (name, +1 to take the label of the next csrc
# kernel launched, -1 of the previous one)
CSRC_HELPERS = (
    ("egnn_mega_proj_kernel", +1),
    ("reduce_node_chunks", -1),
    ("reduce_blocks", -1),
)

_PY_FRAME = re.compile(r"^(.*\.py)\((\d+)\): ")
_PORT = "immunostruct_tpu_torch/"
# the profiling harness's own frames name no launch
_HARNESS = ("immunostruct_tpu_torch/utils/attribution.py",
            "immunostruct_tpu_torch/utils/profiling.py")

# (start_us, end_us, name, label by stack or op); see device_events
Event = Tuple[float, float, str, str]


def csrc_kernel(name: str) -> Optional[str]:
    """'B1', 'B3 fwd', ... for a csrc kernel's name; None otherwise."""
    for label, tags in CSRC_KERNELS:
        if all(t in name for t in tags):
            return label
    return None


def _helper_step(name: str) -> int:
    for tag, step in CSRC_HELPERS:
        if tag in name:
            return step
    return 0


def label_events(events: Sequence[Event]) -> List[str]:
    """The label of each event (in time order, one stream): rule (a) by
    name, its helpers by their neighbour, else the event's own label."""
    own = [csrc_kernel(name) for _, _, name, _ in events]
    labels = []
    for i, (_, _, name, fallback) in enumerate(events):
        label = own[i]
        step = _helper_step(name) if label is None else 0
        j = i + step
        # past other helpers to the nearest kernel in that direction
        while step and 0 <= j < len(events) and _helper_step(events[j][2]):
            j += step
        if step and 0 <= j < len(events):
            label = own[j]
        labels.append(f"[kernel:{label}]" if label else fallback)
    return labels


def attribute(events: Sequence[Event], steps: int
              ) -> List[Tuple[float, str]]:
    """[(ms_per_step, label)], sorted descending, over ``steps`` steps."""
    events = sorted(events)
    totals: dict = {}
    for (s, e, _, _), label in zip(events, label_events(events)):
        totals[label] = totals.get(label, 0.0) + (e - s)
    rows = [(us / steps / 1000.0, label) for label, us in totals.items()]
    rows.sort(reverse=True)
    return rows


# -- from a trace written by utils/profiling.py::trace ------------------------

def _trace_events(logdir: str) -> list:
    """The complete ('X') events of the Chrome traces under ``logdir``."""
    out = []
    for f in sorted(glob.glob(os.path.join(logdir, "**", "*.json"),
                              recursive=True)):
        with open(f) as fh:
            out += [ev for ev in json.load(fh).get("traceEvents", [])
                    if ev.get("ph") == "X"]
    return out


def _span(ev) -> Tuple[float, float]:
    ts = float(ev.get("ts", 0.0))
    return ts, ts + float(ev.get("dur", 0.0))


def _port_frame(name: str) -> Optional[str]:
    """``file:line`` of a Python frame of the port (not the harness)."""
    m = _PY_FRAME.match(name)
    if not m or _PORT not in m.group(1):
        return None
    path = m.group(1)
    path = path[path.rindex(_PORT):]
    return None if path in _HARNESS else f"{path}:{m.group(2)}"


def _stack_labels(frames: list, queries: list) -> dict:
    """For each query (tid, t, key), the label of rules (b)/(c) from the
    Python frames and ATen ops open on thread ``tid`` at time ``t``:
    {key: label or None}. ``frames`` are
    (tid, start, end, name, is_op); on one thread they nest, so one sweep
    with a stack finds the open ones."""
    by_tid: dict = {}
    for f in frames:
        by_tid.setdefault(f[0], []).append(f[1:])
    asked: dict = {}
    for tid, t, key in queries:
        asked.setdefault(tid, []).append((t, key))
    out = {}
    for tid, qs in asked.items():
        spans = sorted(by_tid.get(tid, []), key=lambda f: (f[0], -f[1]))
        stack, i = [], 0
        for t, key in sorted(qs, key=lambda q: q[0]):
            while i < len(spans) and spans[i][0] <= t:
                while stack and stack[-1][1] <= spans[i][0]:
                    stack.pop()
                stack.append(spans[i])
                i += 1
            while stack and stack[-1][1] < t:
                stack.pop()
            open_ = [f for f in stack if f[1] >= t]
            label = next((lab for lab in (_port_frame(f[2]) for f in
                                          reversed(open_)) if lab), None)
            op = next((f[2] for f in reversed(open_) if f[3]), None)
            out[key] = label or (f"[{op}]" if op else None)
    return out


def _top_level(ops: list) -> list:
    """The ops that no other op on their thread encloses."""
    out, end = [], {}
    for ev in sorted(ops, key=lambda ev: (_span(ev)[0], -_span(ev)[1])):
        s, e = _span(ev)
        if s >= end.get(ev.get("tid"), float("-inf")):
            out.append(ev)
            end[ev.get("tid")] = e
    return out


def device_events(logdir: str) -> List[Event]:
    """The device lane of the traces under ``logdir`` as ``Event``s: every
    kernel, memcpy and memset, with the label of rules (b) and (c) from
    the Python frames and ATen ops open on the launching thread when the
    CUDA runtime or driver call with the event's correlation id ran. A
    trace without device events (the CPU) gives its top-level CPU ops."""
    evs = _trace_events(logdir)
    frames = [(ev.get("tid"), *_span(ev), ev["name"], ev.get("cat") == "cpu_op")
              for ev in evs if ev.get("cat") in ("python_function", "cpu_op")]
    device = [ev for ev in evs
              if ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not device:
        ops = _top_level([ev for ev in evs if ev.get("cat") == "cpu_op"])
        above = _stack_labels(frames, [(ev.get("tid"), _span(ev)[0], i)
                                       for i, ev in enumerate(ops)])
        return [(*_span(ev), ev["name"],
                 above[i] if above[i] and not above[i].startswith("[")
                 else f"[{ev['name']}]") for i, ev in enumerate(ops)]
    launches = {ev["args"]["correlation"]: ev for ev in evs
                if ev.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in ev.get("args", {})}
    queries = []
    for i, ev in enumerate(device):
        launch = launches.get(ev.get("args", {}).get("correlation"))
        if launch is not None:
            queries.append((launch.get("tid"), _span(launch)[0], i))
    labels = _stack_labels(frames, queries)
    return [(*_span(ev), ev["name"],
             labels.get(i) or f"[{ev['name'][:60]}]")
            for i, ev in enumerate(device)]


def _first_tensor(x) -> Optional[torch.Tensor]:
    """The first tensor in ``x``: a tensor, or one inside a tuple, list or
    dataclass (a train state's model and optimizer hold none)."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, (tuple, list)):
        items = x
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        items = [getattr(x, f.name) for f in dataclasses.fields(x)]
    else:
        return None
    for item in items:
        t = _first_tensor(item)
        if t is not None:
            return t
    return None


def _fetch(out) -> None:
    """A value fetch of ``out``'s first tensor: the barrier that ends a
    window (the host waits for the device's work)."""
    t = _first_tensor(out)
    if t is not None:
        t.reshape(-1)[:1].cpu()


def profile_fn(fn: Callable, args: tuple, logdir: str, steps: int = 10,
               warmup: int = 3, thread_state: bool = False,
               with_stack: bool = True) -> List[Tuple[float, str]]:
    """``steps`` calls of ``fn(*args)`` traced in one profiler window (one
    window, not one a call: torch.profiler stops recording after some tens
    of short profiles in one process), after ``warmup`` untraced calls,
    each stretch ending in a value fetch; the device time attributed per
    step. ``thread_state=True`` feeds ``out[0]`` back as ``args[0]``. The
    trace is written under ``<logdir>/_attribution_run`` (emptied first)."""
    from immunostruct_tpu_torch.utils.profiling import trace

    def call(a, out):
        if thread_state and out is not None:
            a = (out[0],) + tuple(a[1:])
        return a, fn(*a)

    logdir = os.path.join(logdir, "_attribution_run")
    shutil.rmtree(logdir, ignore_errors=True)
    out, a = None, tuple(args)
    for _ in range(warmup):
        a, out = call(a, out)
    if out is not None:
        _fetch(out)
    with trace(logdir, with_stack=with_stack):
        for _ in range(steps):
            a, out = call(a, out)
        _fetch(out)
    return attribute(device_events(logdir), steps)


def load_trace_timeline(logdir: str) -> List[Tuple[float, float, str]]:
    """The device lane of the traces under ``logdir`` (kernels, memcpy,
    memset; the CPU ops where there are none), [(start_us, end_us, name)]
    sorted by start."""
    return sorted((s, e, name) for s, e, name, _ in device_events(logdir))


def occupancy(timeline: List[Tuple[float, float, str]], steps: int,
              top_gaps: int = 12) -> dict:
    """Serialization analysis of a device timeline: {span_ms, busy_ms,
    idle_ms, idle_frac, gaps} per step, ``gaps`` the largest idle windows
    between device ops [(ms, after_op, before_op)]: each a candidate for
    overlap, or the host's dispatch showing."""
    if not timeline:
        return {"span_ms": 0.0, "busy_ms": 0.0, "idle_ms": 0.0,
                "idle_frac": 0.0, "gaps": []}
    span = timeline[-1][1] - timeline[0][0]
    busy = 0.0
    gaps: List[Tuple[float, str, str]] = []
    cur_s, cur_e, cur_name = timeline[0]
    for s, e, name in timeline[1:]:
        if s > cur_e:          # an idle bubble between device ops
            gaps.append((s - cur_e, cur_name, name))
            busy += cur_e - cur_s
            cur_s, cur_e, cur_name = s, e, name
        else:                  # overlapping/abutting: extend the busy run
            if e > cur_e:
                cur_e, cur_name = e, name
    busy += cur_e - cur_s
    gaps.sort(reverse=True)
    # an inter-step gap (the host's loop) comes once a step; it stays in
    # the list, where its op names show it
    return {
        "span_ms": span / steps / 1000.0,
        "busy_ms": busy / steps / 1000.0,
        "idle_ms": (span - busy) / steps / 1000.0,
        "idle_frac": (span - busy) / span if span else 0.0,
        "gaps": [(d / 1000.0, a, b) for d, a, b in gaps[:top_gaps]],
    }
