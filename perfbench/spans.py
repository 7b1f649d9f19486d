"""The program's own spans in a traced stretch, and the device's idle
time put down to them.

The port opens named ranges (``tpu_diinn_torch/train/profiling.py::
span``) while a profiler runs. A profiler that records the host
(``ProfilerActivity.CPU``) keeps them in ``Trace.host``, on the clock of
the CUDA calls and the kernels, and ``trace._events`` drops their echoes
on the device's timeline with the other host names. The traced stretch
(``trace.Stretch``) records CUDA activity alone, and then torch registers
no callback for ``record_function``: its traces hold no program span, so
everything here reads None on them. A stretch that also records the host,
restricted to user ranges (``RecordScope.USER_SCOPE``) to keep its cost
down, would give every function here something to read.

- Program spans: the host intervals named in ``LAYER_OF``, and
  ``train_step <n>`` by prefix. Every other host event (a CUDA runtime
  call, torch's ``Optimizer.*``, an operator) is none.
- Idle intervals: those of ``Trace.idle_gaps``, all of them: the traced
  window less the union of the device's intervals.
- Attribution: each idle interval is cut at every program span's start
  and end; each piece goes to the innermost program span open over it
  (the shortest, across threads, as ``Trace._host_at`` names a gap), and
  through it to its layer. A piece under no program span, or under a
  span that only holds others (``None`` in ``LAYER_OF``), is "other".

Every function returns None where the trace holds no program span (a
program without spans, or a stretch of CUDA activity alone) or no device
operation (a run on the CPU), as ``readers.py``'s do where a trace is
missing.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

from perfbench.trace import _union_length

STEP = "train_step "
OTHER = "other"
LAYERS = ("feed", "encoder", "decoder", "update")
LAYER_OF: Dict[str, Optional[str]] = {
    "step.forward": None,
    "step.backward": None,
    "predict": None,
    "step.update": "update",
    "to_device": "feed",
    "encoder": "encoder",
    "lr_conv": "encoder",
    "decoder": "decoder",
    "decoder.prepare": "decoder",
    "decoder.window": "decoder",
    "decoder.backward": "decoder",
    "decoder.backward.prepare": "decoder",
}

Interval = Tuple[str, float, float]


def program_spans(trace) -> List[Interval]:
    return [iv for iv in trace.host
            if iv[0] in LAYER_OF or iv[0].startswith(STEP)]


def _spans(trace) -> Optional[List[Interval]]:
    """The program spans of a trace in which the device ran, else None."""
    if trace is None or trace.busy_s <= 0:
        return None
    return program_spans(trace) or None


def layer_of(name: str) -> str:
    return LAYER_OF.get(name) or OTHER


def idle_intervals(trace) -> List[Tuple[float, float]]:
    """Every interval of the traced window in which the device ran
    nothing, in time order (``Trace.idle_gaps``' gaps, unranked)."""
    gaps, end = [], trace.span[0]
    for _, s, e in sorted(trace.device, key=lambda t: t[1]):
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if trace.span[1] > end:
        gaps.append((end, trace.span[1]))
    return gaps


def idle_by_layer(trace) -> Optional[Dict[str, float]]:
    """Idle seconds of the traced window by layer (``LAYERS`` and
    ``OTHER``; they sum to the window less the busy time)."""
    spans = _spans(trace)
    if spans is None:
        return None
    out = dict.fromkeys(LAYERS + (OTHER,), 0.0)
    gaps = idle_intervals(trace)
    points = sorted({t for g in gaps for t in g}
                    | {t for _, s, e in spans for t in (s, e)})
    by_start = sorted(spans, key=lambda iv: iv[1])
    open_, nxt, g = set(), 0, 0
    for a, b in zip(points, points[1:]):
        while nxt < len(by_start) and by_start[nxt][1] <= a:
            open_.add(by_start[nxt])
            nxt += 1
        open_ = {iv for iv in open_ if iv[2] > a}
        while g < len(gaps) and gaps[g][1] <= a:
            g += 1
        if g == len(gaps) or not gaps[g][0] <= a:
            continue        # the piece [a, b) lies between two gaps
        inner = min(open_, key=lambda iv: iv[2] - iv[1], default=None)
        out[OTHER if inner is None else layer_of(inner[0])] += (b - a) * 1e-6
    return out


def idle_share(run, layer: str) -> Optional[float]:
    """% of the traced window in which the device ran nothing and the
    host was in ``layer``'s spans."""
    t = run.trace
    split = idle_by_layer(t)
    if split is None or t.window_s <= 0:
        return None
    return 100.0 * split[layer] / t.window_s


def host_ms(run, names: Iterable[str]) -> Optional[float]:
    """ms per traced iteration of the union of the spans named ``names``
    (0 where the program opened spans but none of these)."""
    t = run.trace
    spans = _spans(t)
    if spans is None:
        return None
    wanted = set(names)
    return _union_length([(s, e) for n, s, e in spans
                          if n in wanted]) * 1e-3 / t.iterations
