"""The traced stretch of a window and what the per-layer readers take
from it.

With ``--trace 1`` a driver runs its window as usual and profiles one
stretch of it: ``Stretch`` synchronises the card and starts
``torch.profiler`` at the stretch's first iteration, and at its last
synchronises and stops. The profiler records the CUDA activity alone
(kernels, copies, sets, and the host's CUDA API calls): recording every
host operation as well made a traced training step four times as long as
an untraced one, against under twice with CUDA alone. Nothing is written
to disk: the events are read from memory into a ``Trace``.

- The traced window is the span of the stretch's device operations, from
  the first one's start to the last one's end; busy time is the union of
  their intervals, and the idle share the rest of the window.
- Kernel groups ("layers") come from ``layers/*.json``, found by file
  name: the group is the name before the first dot, so a later change
  adds a pattern for a new kernel as a file of its own
  (``layers/decoder.<kernel>.json``). Each file holds ``priority`` and
  ``match``, a list of rules ``{"any": [...], "none": [...]}`` of
  case-insensitive substrings; a kernel belongs to the group of the
  lowest priority whose rule it matches (any of ``any``, none of
  ``none``).
- The breakdown lists the device operations that took most time, and the
  longest idle gaps, each named by the innermost CUDA call the host was
  in at the gap's start ("host, no CUDA call" where it was in none: its
  own Python and PyTorch work).
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch

LAYERS_DIR = Path(__file__).resolve().parent / "layers"
NO_CALL = "host, no CUDA call"

Interval = Tuple[str, float, float]     # (name, start us, end us)


def load_layers(directory: Path = LAYERS_DIR) -> List[Tuple[int, str, list]]:
    """(priority, group, rules) of every pattern file, lowest first."""
    out = []
    for f in sorted(directory.glob("*.json")):
        spec = json.loads(f.read_text())
        out.append((int(spec["priority"]), f.name.split(".")[0],
                    spec["match"]))
    return sorted(out, key=lambda t: (t[0], t[1]))


def _matches(name: str, rules: list) -> bool:
    key = name.lower()
    return any(any(p.lower() in key for p in r["any"])
               and not any(p.lower() in key for p in r.get("none", ()))
               for r in rules)


def group_of(name: str, layers) -> Optional[str]:
    for _, group, rules in layers:
        if _matches(name, rules):
            return group
    return None


def _union_length(intervals: List[Tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


@dataclasses.dataclass
class Trace:
    """One profiled stretch: the span, the device's intervals inside it
    (clipped to it) and the host's operations."""
    span: Tuple[float, float]
    device: List[Interval]
    host: List[Interval]
    iterations: int
    layers: list

    @property
    def window_s(self) -> float:
        return (self.span[1] - self.span[0]) * 1e-6

    @property
    def busy_s(self) -> float:
        return _union_length([(s, e) for _, s, e in self.device]) * 1e-6

    def group_seconds(self, group: str) -> Optional[float]:
        """Device seconds of the kernels of ``group``, None where none ran."""
        ivs = [(s, e) for n, s, e in self.device
               if group_of(n, self.layers) == group]
        return _union_length(ivs) * 1e-6 if ivs else None

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for name, s, e in self.device:
            by[name] = by.get(name, 0.0) + (e - s) * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        gaps, end = [], self.span[0]
        for _, s, e in sorted(self.device, key=lambda t: t[1]):
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        if self.span[1] > end:
            gaps.append((end, self.span[1]))
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self._host_at(g0), (g1 - g0) * 1e-6]
                for g0, g1 in gaps[:n]]

    def _host_at(self, t: float) -> str:
        """The innermost host operation running at ``t``."""
        best = None
        for name, s, e in self.host:
            if s <= t < e and (best is None or e - s < best[2] - best[1]):
                best = (name, s, e)
        return best[0] if best else NO_CALL


def _events(prof) -> Tuple[list, list]:
    device, host = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for ev in prof.events():
        iv = (ev.name, float(ev.time_range.start), float(ev.time_range.end))
        (device if ev.device_type == cuda else host).append(iv)
    # a host span (``record_function``) can echo on the device's timeline
    # under its own name: it is no device operation
    named = {n for n, _, _ in host}
    return [d for d in device if d[0] not in named], host


def build_trace(prof, iterations: int, host_s: float, layers=None) -> Trace:
    """The stretch's ``Trace``; ``host_s``, the stretch's seconds by the
    host's clock, is the window where no device operation ran (a run on
    the CPU)."""
    device, host = _events(prof)
    if device:
        span = (min(s for _, s, _ in device), max(e for _, _, e in device))
    else:
        span = (0.0, host_s * 1e6)
    return Trace(span=span, device=device, host=host, iterations=iterations,
                 layers=load_layers() if layers is None else layers)


class Stretch:
    """Profiles iterations [start, start + count) of a window loop when
    ``enabled``; ``sync`` waits for the device. Call ``begin(i)`` before
    and ``end(i)`` after iteration ``i``; ``trace`` holds the result."""

    def __init__(self, enabled: bool, start: int, count: int,
                 sync: Callable[[], None]):
        self.enabled, self.start, self.count = enabled, start, count
        self.sync = sync
        self.trace: Optional[Trace] = None
        self._prof = None
        self._t0 = 0.0

    @property
    def active(self) -> bool:
        """Whether the window must go on to finish the stretch."""
        return self.enabled and self.trace is None

    def begin(self, i: int) -> None:
        if not self.enabled or i != self.start:
            return
        from torch.profiler import ProfilerActivity, profile
        self.sync()
        self._prof = profile(activities=[
            ProfilerActivity.CUDA if torch.cuda.is_available()
            else ProfilerActivity.CPU])
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def end(self, i: int) -> None:
        if self._prof is None or i != self.start + self.count - 1:
            return
        self.sync()
        host_s = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)
        self.trace = build_trace(self._prof, self.count, host_s)
        self._prof = None
