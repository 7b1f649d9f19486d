"""On the card: a short run of each cell through the command of
``BENCHMARK.json`` ends with a result line that is correct, and a
checkout that holds only the benchmark (no program) gives no result.
Run there as ``python3 -m pytest -m cuda perfbench/tests`` from the
checkout's root."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device on this host")


def run(cwd: Path, cell: str, trace: int) -> subprocess.CompletedProcess:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return subprocess.run(
        bench["command"] + ["--workload", cell, "--seed", "2147483659",
                            "--seconds", "2", "--trace", str(trace)],
        cwd=cwd, capture_output=True, text=True, timeout=1500)


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", ["diinn-edsr.upscale", "diinn-rdn.train",
                                  "diinn-edsr.train"])
def test_a_short_run_is_correct(cell, trace):
    need_card()
    p = run(ROOT, cell, trace)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu" and out["metrics"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["diinn-rdn.train", "diinn-edsr.upscale",
                                  "diinn-rdn.upscale", "diinn-edsr.train"])
def test_the_control_and_the_faults_fail_the_limits(cell):
    """At the cell's own size, on three seeds: the program within every
    limit; each of the cell's controls and each fault beyond one."""
    need_card()
    import time
    from perfbench import control, harness
    from perfbench.drivers.common import Context
    from tpu_diinn_torch.cli.benchmarks import resolve_device
    c = harness.load_cell(harness.load_benchmark(), cell)
    device = resolve_device("cuda:0")
    for seed in (2147483701, 2147483702, 2147483703):
        ctx = Context(c.config, c.traffic, seed, 0.0, False, device,
                      time.perf_counter())
        for kind, numbers in control.readings(ctx, c.controls, True):
            over = [k for k, v in c.limits.items()
                    if numbers[k] > v["limit"]]
            assert bool(over) == (kind != "program"), (seed, kind, numbers)


@pytest.mark.cuda
def test_the_benchmark_alone_gives_no_result(tmp_path):
    need_card()
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = run(tmp_path, "diinn-edsr.upscale", 0)
    assert p.returncode != 0
    assert not p.stdout.strip()
    print(p.stderr[-500:], file=sys.stderr)
