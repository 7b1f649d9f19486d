"""One run of one cell of ``BENCHMARK.json``.

Everything that belongs to one configuration, traffic mix, cell or metric
is a file of its own, found by the name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the model's sizes for the reference, and
  the program's configuration (``program``);
- ``traffic/<traffic>.json``: the mix's parameters; its ``kind`` names
  the general driver that reads it (``drivers/<kind>.py``);
- ``limits/<cell>.json``: the limit of each number compared, with the
  readings it was set from, and the cell's ``controls`` (the precisions
  below the traffic's that ``control.py`` puts in the program's place);
- ``metrics/<metric>.py``: the metric's reader, ``read(run)`` of the
  driver's ``Record``, which returns a number or None where it finds
  nothing;
- ``layers/<group>[.<part>].json``: kernel-name patterns of the groups
  the per-layer readers take from a trace (``trace.py``).

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics, read from a profiled stretch of the same window. The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared with its limit;
the same numbers end standard error.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import List

import torch

from perfbench.drivers.common import Context, Record, device_name

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_diinn")


class NotFound(LookupError):
    pass


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise NotFound(f"unknown {what} {name!r}: not in BENCHMARK.json")


def load_named(kind: str, name: str) -> dict:
    """``<kind>/<name>.json`` under the benchmark's folder."""
    path = BENCH / kind / f"{name}.json"
    if not path.is_file():
        raise NotFound(f"no {kind} file for {name!r}: {path} is missing")
    return json.loads(path.read_text())


def load_reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    if not path.is_file():
        raise NotFound(f"no reader for metric {metric!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_driver(kind: str):
    if not (BENCH / "drivers" / f"{kind}.py").is_file():
        raise NotFound(f"no driver for traffic kind {kind!r}")
    return importlib.import_module(f"perfbench.drivers.{kind}").run


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    controls: List[str] = dataclasses.field(default_factory=list)


def load_cell(bench: dict, name: str) -> Cell:
    w = find(bench["workloads"], name, "workload")
    find(bench["configs"], w["config"], "configuration")
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    layer = []
    for m in bench["per_layer"]:
        if "workloads" not in m:
            raise NotFound(f"per-layer metric {m['name']!r} lists no "
                           f"workloads")
        if name in m["workloads"]:
            layer.append(m)
    limits = load_named("limits", name)
    return Cell(name=name, chips=int(w["chips"]),
                config=load_named("configs", w["config"]),
                traffic=load_named("traffic", w["traffic"]),
                limits=limits["limits"], end_to_end=e2e, per_layer=layer,
                controls=limits["controls"])


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def judge(checks: dict, limits: dict) -> dict:
    """Each number that the cell's limits name, beside its limit (a driver
    may read more than a cell compares)."""
    missing = set(limits) - set(checks)
    if missing:
        raise NotFound(f"the run read no {sorted(missing)}")
    return {k: {"value": checks[k], "limit": v["limit"]}
            for k, v in limits.items()}


def result(cell: Cell, rec: Record, trace: bool, device: torch.device
           ) -> dict:
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = judge(rec.checks, cell.limits)
    correct = rec.failed == 0 and all(c["value"] <= c["limit"]
                                      for c in checks.values())
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": device_name(device), "count": cell.chips,
           "memory_peak_bytes": rec.memory_peak_bytes}
    out = {"correct": correct, "attempted": rec.attempted,
           "failed": rec.failed, "metrics": metrics, "device": dev}
    if trace and rec.trace is not None:
        dev["busy_s"] = rec.trace.busy_s
        dev["window_s"] = rec.trace.window_s
        out["breakdown"] = {"device_ops": rec.trace.top_ops(),
                            "idle_gaps": rec.trace.idle_gaps()}
    out["checks"] = checks
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float, plant=None) -> dict:
    ctx = Context(config=cell.config, traffic=cell.traffic, seed=seed,
                  seconds=seconds, trace=trace, device=device,
                  t_start=t_start, plant=plant)
    rec = load_driver(cell.traffic["kind"])(ctx)
    return result(cell, rec, trace, device)


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="perfbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if args.seed < 0:
        p.error("--seed must be a whole number >= 0")
    return args


def main(argv, t_start: float) -> int:
    args = parse(argv)
    cell = load_cell(load_benchmark(), args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"[perfbench] {args.workload} needs {cell.chips} CUDA "
              f"device(s); found {found}", file=sys.stderr)
        return 2
    from tpu_diinn_torch.cli.benchmarks import resolve_device
    device = resolve_device("cuda:0")
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                   t_start)
    bad = forbidden_modules()
    if bad:
        print(f"[perfbench] modules loaded that the port must not load: "
              f"{bad}", file=sys.stderr)
        return 3
    print(f"[perfbench] correct = {out['correct']}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"[perfbench] check {name} = {c['value']!r} (limit "
              f"{c['limit']!r})", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0
