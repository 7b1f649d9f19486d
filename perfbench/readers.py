"""What the metric readers (``metrics/<name>.py``) share: each takes a
driver's ``Record`` (``drivers/common.py``) and returns a number, or None
where the run has nothing for it to read (no trace, no kernel of the
group). A share of a peak or of a roofline is never 0 for want of data:
it is then None."""

from __future__ import annotations

import statistics
from typing import Optional


def rate(run) -> Optional[float]:
    """Pixels of every completed iteration, per window second."""
    if not run.items or run.window_s <= 0:
        return None
    return sum(it["pixels"] for it in run.items) / run.window_s


def latency_ms(run, percentile: int) -> Optional[float]:
    """The ``percentile``-th percentile of the iterations' latencies, ms
    (``statistics.quantiles``' inclusive method over every request)."""
    lat = [it["latency_s"] for it in run.items if "latency_s" in it]
    if len(lat) < 2:
        return lat[0] * 1e3 if lat else None
    return statistics.quantiles(lat, n=100, method="inclusive")[
        percentile - 1] * 1e3


def idle_share(run) -> Optional[float]:
    """% of the traced span in which no kernel or copy ran."""
    t = run.trace
    if t is None or t.busy_s <= 0:
        return None
    return 100.0 * (t.window_s - t.busy_s) / t.window_s


def mfu(run) -> Optional[float]:
    """% of the precision's peak: the traced iterations' model FLOPs over
    the traced span."""
    t = run.trace
    if t is None or t.busy_s <= 0 or not run.peak_flops:
        return None
    return 100.0 * run.stretch_flops / t.window_s / run.peak_flops


def roofline(run, group: str, least_s: Optional[float]) -> Optional[float]:
    """% of the least time of the traced calls of ``group`` over the
    device time of its kernels."""
    t = run.trace
    busy = None if t is None else t.group_seconds(group)
    if not busy or not least_s:
        return None
    return 100.0 * least_s / busy


def group_ms(run, group: str) -> Optional[float]:
    """Device ms of ``group``'s kernels per traced iteration."""
    t = run.trace
    busy = None if t is None else t.group_seconds(group)
    return None if busy is None else busy * 1e3 / t.iterations
