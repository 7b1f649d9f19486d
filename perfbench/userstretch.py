"""A traced stretch that records the program's spans besides CUDA.

``trace.Stretch`` records CUDA activity alone, so its traces hold no
program span (``spans.py``). ``UserStretch`` profiles the same stretch
with the host recorded too, restricted to user ranges
(``RecordScope.USER_SCOPE``: ``record_function``, and so the program's
``span``), so that no host operator is recorded and the stretch costs
little more than a CUDA-only one: the host's events are the CUDA runtime
calls and the spans. Where the profiler offers no scope restriction (the
private hook it goes through is not there), every host operation is
recorded, and the spans with them.
"""

from __future__ import annotations

import contextlib
import time

import torch

from perfbench.trace import Stretch


@contextlib.contextmanager
def _user_scope_only():
    """While the profiler starts, its callbacks are registered for user
    ranges alone."""
    from torch.autograd import profiler as ap
    enable = getattr(ap, "_enable_profiler", None)
    scope = getattr(torch._C._profiler, "RecordScope", None)
    if enable is None or scope is None:
        yield
        return

    def user_only(config, activities, scopes=None):
        return enable(config, activities, {scope.USER_SCOPE})
    ap._enable_profiler = user_only
    try:
        yield
    finally:
        ap._enable_profiler = enable


class UserStretch(Stretch):
    """``trace.Stretch`` with the host's user ranges recorded."""

    def begin(self, i: int) -> None:
        if not self.enabled or i != self.start:
            return
        from torch.profiler import ProfilerActivity, profile
        self.sync()
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        with _user_scope_only():
            self._prof.__enter__()
        self._t0 = time.perf_counter()
