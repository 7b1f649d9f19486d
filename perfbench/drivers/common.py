"""What every driver shares: the run's context, its record, the program's
configuration and the comparison helpers."""

from __future__ import annotations

import copy
import dataclasses
import statistics
import sys
import time
from typing import Callable, Dict, List, Optional

import torch

from perfbench.trace import Trace


@dataclasses.dataclass
class Context:
    """One run of one cell."""
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float                       # perf_counter at run.py's start
    log: Callable[[str], None] = lambda msg: print(msg, file=sys.stderr,
                                                   flush=True)
    # a test's hook that breaks the program after it is built
    plant: Optional[Callable[[object], None]] = None

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def mark(self, what: str) -> None:
        """Logs the seconds since the start, a split of the set-up."""
        self.log(f"[perfbench] {time.perf_counter() - self.t_start:.3f} s "
                 f"{what}")


@dataclasses.dataclass
class Record:
    """What a driver hands the harness, and the metric readers read: the
    set-up and window it timed, the traced stretch and its model work, and
    the numbers compared."""
    setup_s: float
    window_s: float
    items: List[dict]                    # per completed iteration
    attempted: int
    failed: int
    memory_peak_bytes: int
    checks: Dict[str, float]
    trace: Optional[Trace] = None
    stretch_flops: Optional[float] = None
    stretch_decoder_least_s: Optional[float] = None
    peak_flops: Optional[float] = None


def program_tree(ctx: Context, **model) -> dict:
    """The program's configuration tree: the configuration file's
    ``program`` section with the traffic's compute dtype and ``model``."""
    tree = copy.deepcopy(ctx.config["program"])
    tree.setdefault("model", {}).update(dtype=ctx.traffic["dtype"], **model)
    return tree


def device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def peak_memory(device: torch.device) -> int:
    return (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)


def free(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def reference_mode() -> None:
    """The reference computes in float32 with TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def leaf_gap(program: Dict[str, float], reference: Dict[str, float],
             leaves: Optional[List[str]] = None) -> tuple:
    """(worst gap, its leaf) of two per-leaf norms: |program - reference|
    over the larger of the reference's norm of that leaf and of the median
    leaf."""
    names = list(reference) if leaves is None else leaves
    median = statistics.median(reference[k] for k in reference)
    worst = (0.0, None)
    for k in names:
        gap = abs(program[k] - reference[k]) / max(reference[k], median)
        if gap > worst[0] or worst[1] is None:
            worst = (gap, k)
    return worst


def window_loop(ctx: Context, stretch, body: Callable[[int], None]) -> tuple:
    """Runs ``body(i)`` for i = 0, 1, ... while the window's seconds last
    (and until the traced stretch ends), then waits for the device.
    Returns (iterations, window seconds)."""
    i = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds or stretch.active:
        stretch.begin(i)
        body(i)
        stretch.end(i)
        i += 1
    ctx.sync()
    return i, time.perf_counter() - t0
