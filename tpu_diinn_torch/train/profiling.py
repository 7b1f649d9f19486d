"""Profiling and debugging hooks.

Counterpart of ``tpu_diinn/train/profiling.py``:

- ``trace(log_dir)``: a ``torch.profiler`` window over the CPU and the
  card, written into ``log_dir`` as a Chrome trace
  (``<host>_<pid>.<ns>.pt.trace.json``, TensorBoard's layout);
- ``StepProfiler``: the trainer's ``trainer.profile_dir`` window, which
  opens once 2 steps have run past the first one and covers
  ``profile_steps`` steps, as the JAX trainer's ``maybe_profile``;
- ``span(name)``: a named range of the program on the profiler's own
  timeline while a ``torch.profiler`` window that records the host is
  open (this module's, or a caller's), and nothing otherwise;
- ``enable_debug_nans``: autograd's anomaly mode, with ``check_finite``
  on each step's loss and gradient norm, so that a non-finite value
  raises as under ``jax_debug_nans``;
- ``synced_time``: mean seconds per call, with ``torch.cuda.synchronize``
  as the barrier on the card.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Callable

import torch
from torch.autograd import profiler as _autograd_profiler

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler is
    running, else one shared null context: no profiler, no record, and
    one global read a call. Host-only, so harmless under CUDA graph
    capture. Only a profiler that records the host (``ProfilerActivity.
    CPU``, as ``trace`` does) keeps the range: one of CUDA activity alone
    registers no callback for ``record_function`` and keeps none.

    The port's spans, each opened where its work happens:
    ``train_step <n>`` (the whole step, n the 1-based global step),
    ``step.forward``, ``step.backward``, ``step.update`` (zero_grad, the
    gradient norm, Adam and the schedule) and ``to_device``
    (``train/loop.py``); ``predict`` (``train/task.py``); ``encoder`` (a
    pass of the encoder), ``lr_conv`` (the LR convs), ``decoder``,
    ``decoder.prepare`` (the fused route's host preparation: synthesis
    grid, packed weights, index vectors, weight casts and slabs) and
    ``decoder.window`` (one window of ``ImplicitDecoder.windows``)
    (``nn/diinn.py``); ``decoder.backward`` and
    ``decoder.backward.prepare`` (its buffers and slabs)
    (``kernels/decoder_fused.py``); in LIIF (``nn/liif.py``) ``encoder``,
    ``decoder``, ``lr_conv`` (``imnet_feat``), ``decoder.prepare`` (the
    corner index maps, the cell and their uploads) and ``decoder.window``
    (one column chunk)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch.profiler.record_function(name)


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _activities() -> list:
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block; the trace is written into ``log_dir`` when it
    ends. The card is synchronised on entry and exit, so the trace holds
    exactly the block's kernels."""
    from torch.profiler import profile, tensorboard_trace_handler
    prof = profile(activities=_activities(),
                   on_trace_ready=tensorboard_trace_handler(str(log_dir)))
    _sync()
    prof.start()
    try:
        yield prof
    finally:
        _sync()
        prof.stop()


class StepProfiler:
    """The trainer's trace window: call ``after_step(step)`` with the
    global step after every training step and ``close()`` at the end. The
    window (a ``trace``) opens after step ``first_step + 2`` (two warm-up
    steps) and closes after ``profile_steps`` more; each step inside it
    carries the step's own spans (``span``), ``train_step <step>`` (1-based
    global step) the outermost."""

    def __init__(self, log_dir: str, profile_steps: int, first_step: int):
        self.log_dir = log_dir
        self.profile_steps = profile_steps
        self.first_step = first_step
        self.stop_at = -1
        self._window = None

    def after_step(self, step: int) -> None:
        if (self._window is None and self.stop_at < 0
                and step >= self.first_step + 2):
            self._window = contextlib.ExitStack()
            self._window.enter_context(trace(self.log_dir))
            self.stop_at = step + self.profile_steps
        elif self._window is not None and step >= self.stop_at:
            self.close()

    def close(self) -> None:
        if self._window is not None:
            self._window.close()
            self._window = None


def enable_debug_nans(on: bool = True):
    """Autograd's anomaly mode on or off (a backward function that returns
    a NaN raises, naming the forward operation). Usable as a context
    manager, which restores the previous mode on exit."""
    return torch.autograd.set_detect_anomaly(on)


def check_finite(step: int, **values) -> None:
    """Raise ``FloatingPointError`` if a scalar (a number or a 0-d tensor)
    is not finite; the trainer checks each step's loss and gradient norm
    under ``trainer.debug_nans``."""
    for name, v in values.items():
        x = float(v.detach() if isinstance(v, torch.Tensor) else v)
        if not math.isfinite(x):
            raise FloatingPointError(f"step {step}: {name} is {x} "
                                     f"(trainer.debug_nans)")


def synced_time(fn: Callable, *args, iters: int = 10,
                warmup: int = 2) -> float:
    """Mean seconds per call of ``fn(*args)`` over ``iters`` calls after
    ``warmup`` calls; the card (where one is in use) is synchronised
    before the clock starts and before it stops."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _sync()
    return (time.perf_counter() - t0) / iters

