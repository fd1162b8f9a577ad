"""Captured programs: one CUDA graph per key, the counterpart of the cache
of traces behind ``jax.jit``.

The JAX package runs each of its programs as one compiled XLA program,
traced once for each key: the shapes and dtypes of its inputs and its
static arguments. The train and eval steps (``procedures/train.py``),
batch inference (``procedures/infer.py``) and the served forward
(``serving.py``) do the same here through a ``Program``: on the card, a
key's launches are captured once into a ``torch.cuda.CUDAGraph`` and then
replayed as one.

A call, ``program(fn, inputs, static=..., seed=..., state=...)``:

- ``fn(inputs, generator)`` is the work, written as eager PyTorch. It runs
  eagerly on the key's first call (the warm-up, on a side stream: it also
  builds the kernels and the optimizer's moments), is captured on the
  second, and is not called again for that key.
- ``inputs`` is a tree (tensors, tuples, lists, dataclasses, None) whose
  tensors are copied into the key's static inputs before each replay; its
  shapes, dtypes and devices join ``static`` in the key.
- ``seed`` seeds the program's one generator before each replay (and
  before the warm-up), so that a replay draws the eager call's dropout
  masks and VAE noise bit for bit: the generator is registered with every
  graph, and CUDA's Philox generator reads the seed and offset from the
  device at replay.
- ``state()`` gives the tensors that the work reads or writes in place
  (parameters, buffers, optimizer moments, a device ``lr``). A graph holds
  their addresses, so a key whose state tensors have moved (a resumed
  optimizer, a new classifier head, a re-initialized run) is dropped and
  starts again from its warm-up (``dropped``); replaying it would write
  into freed memory.
- The outputs are copied out of the graph's memory before they are
  returned: no caller holds a tensor that the next replay overwrites.
- With ``grads=True`` the work leaves gradients in the ``.grad`` of the
  state's tensors (the train step). A replay puts back the gradient
  tensors its graph writes.
- The kernel wrappers count their launches in Python, which a replay does
  not run: the capture's increments are taken back, and each replay adds
  them again, so the counts are the launches the card ran
  (``chip_smoke.py`` holds them to the kernels a profiler trace of the
  replays names).
- All graphs of a program share one memory pool: they replay one at a
  time, and each replay's outputs are copied out at once, so a key's
  scratch may hold another key's dead outputs. The pool's scratch then
  grows to about the largest key's, not the sum of the keys'; each key's
  static inputs, outputs (and gradients) come on top. So a program's
  memory still grows with every key it keeps, and a key is kept for good:
  capture pays where shapes repeat (a trainer's batches; a server whose
  clients send a few shapes).

Eager runs only by rule, each counted in ``eager_calls`` by reason: "cpu"
(the inputs lie on the CPU), the caller's reason (``eager=``, e.g.
"data-parallel"), "asked" (``Program(capture=False)``, the eager path kept
for comparison) and "first call" (the warm-up). ``Program(capture=True)``
raises on CPU inputs and with a caller's reason; a capture that fails
raises, naming the key.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Optional

import torch

from immunostruct_tpu_torch.ops import launch_counters


def _signature(tree):
    """The tree's structure with each tensor as (shape, dtype, device)."""
    if tree is None:
        return None
    if torch.is_tensor(tree):
        return (tuple(tree.shape), tree.dtype, tree.device)
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__, tuple(_signature(t) for t in tree))
    if dataclasses.is_dataclass(tree):
        return (type(tree).__name__,
                tuple(_signature(getattr(tree, f.name))
                      for f in dataclasses.fields(tree)))
    return ("value", tree)


def tree_tensors(tree) -> list:
    """The tensors of a tree, in ``_signature``'s order."""
    out = []

    def walk(t):
        if torch.is_tensor(t):
            out.append(t)
        elif isinstance(t, (tuple, list)):
            for u in t:
                walk(u)
        elif dataclasses.is_dataclass(t):
            for f in dataclasses.fields(t):
                walk(getattr(t, f.name))

    walk(tree)
    return out


def tree_map(fn, tree):
    """``tree`` rebuilt with ``fn`` applied to each of its tensors."""
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t) for t in tree)
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{f.name: tree_map(fn, getattr(tree, f.name))
                             for f in dataclasses.fields(tree)})
    return tree


def _marks(tensors) -> tuple:
    return tuple((t.data_ptr(), t.shape) for t in tensors)


def module_tensors(module, optimizer=None) -> list:
    """The tensors a step or forward of ``module`` reads or writes in
    place: its parameters and buffers, and ``optimizer``'s moments and
    tensor learning rates."""
    out = list(module.parameters()) + list(module.buffers())
    if optimizer is not None:
        for group in optimizer.param_groups:
            if torch.is_tensor(group["lr"]):
                out.append(group["lr"])
            for p in group["params"]:
                out.extend(v for v in optimizer.state.get(p, {}).values()
                           if torch.is_tensor(v))
    return out


@dataclasses.dataclass
class _Entry:
    """One key: its static inputs, and once captured its graph, outputs,
    gradient tensors and launch increments."""

    inputs: object
    marks: tuple = ()
    graph: Optional[torch.cuda.CUDAGraph] = None
    outputs: object = None
    grads: tuple = ()
    launches: tuple = ()
    capture_s: float = 0.0


class Program:
    """One captured program per key (module docstring). ``capture``: None
    captures on the card and runs eagerly on the CPU; True captures and
    raises where it cannot; False runs every call eagerly. ``grads``: the
    work leaves gradients in the state tensors' ``.grad``."""

    def __init__(self, name: str, capture: Optional[bool] = None, *,
                 grads: bool = False):
        self.name = name
        self.capture = capture
        self.grads = grads
        self._entries: dict = {}
        self._generator: Optional[torch.Generator] = None
        self._stream = None
        self._pool = None       # the graphs' one memory pool
        self.captures = 0
        self.replays = 0
        self.dropped = 0
        self.eager_calls = collections.Counter()

    # -- the rules ----------------------------------------------------------
    def eager_reason(self, device: torch.device,
                     eager: Optional[str] = None) -> Optional[str]:
        """Why a call on ``device`` runs eagerly, or None when it goes
        through a graph; raises where ``capture=True`` cannot be kept."""
        if self.capture is False:
            return "asked"
        if device.type != "cuda":
            if self.capture:
                raise ValueError(f"{self.name}: capture needs a CUDA device; "
                                 f"the inputs lie on {device}")
            return "cpu"
        if eager is not None and self.capture:
            raise ValueError(f"{self.name}: capture was asked for, but the "
                             f"call runs eagerly under {eager}")
        return eager

    @property
    def keys(self) -> list:
        return list(self._entries)

    def capture_seconds(self) -> float:
        return sum(e.capture_s for e in self._entries.values())

    # -- a call -------------------------------------------------------------
    def __call__(self, fn: Callable, inputs, *, static=(), seed: int,
                 state: Callable = tuple, eager: Optional[str] = None):
        device = tree_tensors(inputs)[0].device
        reason = self.eager_reason(device, eager)
        if reason is not None:
            self.eager_calls[reason] += 1
            return fn(inputs, torch.Generator(device=device).manual_seed(seed))
        key = (static, _signature(inputs))
        entry = self._entries.get(key)
        if entry is not None and entry.marks != _marks(state()):
            del self._entries[key]
            self.dropped += 1
            entry = None
        if entry is None:
            self.eager_calls["first call"] += 1
            return self._warm_up(fn, key, inputs, seed, state)
        if entry.graph is None:
            self._capture(fn, key, entry, state)
        return self._replay(entry, inputs, seed, state)

    def rehearse(self, fn: Callable, inputs, *, static=(), seed: int):
        """Run the call as its replay would, eagerly: the inputs copied into
        the key's static inputs, the program's generator seeded with
        ``seed``, ``fn`` on those, the outputs copied out. The card's
        warm-up is this call; the CPU tests hold it to the eager call."""
        key = (static, _signature(inputs))
        entry = self._entries.get(key)
        if entry is None:
            entry = self._entries[key] = _Entry(
                inputs=tree_map(torch.clone, inputs))
        else:
            self._load(entry, inputs)
        generator = self._generator_on(tree_tensors(inputs)[0].device)
        generator.manual_seed(seed)
        return tree_map(torch.clone, fn(entry.inputs, generator))

    # -- the card -----------------------------------------------------------
    def _generator_on(self, device) -> torch.Generator:
        if self._generator is None or self._generator.device != device:
            self._generator = torch.Generator(device=device)
        return self._generator

    def _side_stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream()
        self._stream.wait_stream(torch.cuda.current_stream())
        return self._stream

    def _warm_up(self, fn, key, inputs, seed, state):
        with torch.cuda.stream(self._side_stream()):
            out = self.rehearse(fn, inputs, static=key[0], seed=seed)
        current = torch.cuda.current_stream()
        current.wait_stream(self._stream)
        for t in tree_tensors(out):     # made on the side stream, used here
            t.record_stream(current)
        self._entries[key].marks = _marks(state())
        return out

    def _capture(self, fn, key, entry: _Entry, state) -> None:
        counters = launch_counters()
        before = {k: f.launches for k, f in counters.items()}
        if not any(e.graph is not None for e in self._entries.values()):
            # a pool that no live graph holds may already be on its way back
            # to the allocator: take a new one
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self._generator)
        t0 = time.perf_counter()
        # while a capture is under way the allocator cannot hand cached
        # memory back to the card, so an allocation that needs it fails:
        # return first what cached blocks and dead graphs' pools hold
        torch.cuda.empty_cache()
        try:
            with torch.cuda.stream(self._side_stream()):
                # thread_local: the data pipeline's prefetch thread pins
                # and copies host memory while a step is captured
                graph.capture_begin(pool=self._pool,
                                    capture_error_mode="thread_local")
                try:
                    outputs = fn(entry.inputs, self._generator)
                except BaseException:
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        pass    # the capture is void; fn's error is the one
                    raise
                graph.capture_end()
        except Exception as e:
            raise RuntimeError(f"{self.name}: capturing the key {key} "
                               f"failed: {type(e).__name__}: {e}") from e
        finally:
            recorded = {k: f.launches - before[k] for k, f in counters.items()}
            for k, f in counters.items():
                f.launches = before[k]      # none ran; each replay adds them
        torch.cuda.current_stream().wait_stream(self._stream)
        entry.capture_s = time.perf_counter() - t0
        entry.graph, entry.outputs = graph, outputs
        entry.launches = tuple((counters[k], n) for k, n in recorded.items()
                               if n)
        if self.grads:
            entry.grads = tuple(t.grad for t in state())
        self.captures += 1

    def _load(self, entry: _Entry, inputs) -> None:
        for dst, src in zip(tree_tensors(entry.inputs),
                            tree_tensors(inputs)):
            if dst is not src:
                dst.copy_(src)

    def _replay(self, entry: _Entry, inputs, seed: int, state):
        self._load(entry, inputs)
        self._generator.manual_seed(seed)
        entry.graph.replay()
        if self.grads:
            for t, g in zip(state(), entry.grads):
                t.grad = g
        for f, n in entry.launches:
            f.launches += n
        self.replays += 1
        return tree_map(torch.clone, entry.outputs)
